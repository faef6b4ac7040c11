#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``operator_tpu_torch``).

    python3 chip_smoke.py [--out results.json] [--seed N]
        [--phases device,kernels,train,serve,wave,guided,graphs,analysis,checkpoint,
                  tokenizers,operator,remote,fleet,deployed,deploy,fabric,prefix,contiguous,
                  mesh,parity,families]

Runs on one CUDA card, from the root of a checkout; exits non-zero, and
prints no result, when no card is present or the package is missing.
Phases, in order — any failure stops the run:

1. device: the card's name and power limit (``nvidia-smi``), the build
   of every kernel of the port from the checkout's sources (one ``nvcc``
   per source, all started together), and each library's count of
   tensor-core instructions (``cuobjdump -sass``: ``HMMA`` for mma.sync,
   ``HGMMA`` for wgmma) — the bf16 ragged (K1), paged decode (K2/K3) and
   prefill (K4) kernels run on the tensor cores, so their libraries must
   have some;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (tinyllama-1.1b: QH=32, KH=4, D=64, page 64,
   32 rows), bf16 and f32, tolerances stated below.  The ragged kernel
   (K1) over every geometry the scheduler produces, chunk 64, valid rows
   only; the paged decode kernel (K2/K3) at mixed lengths with full
   pages, length-1 rows, a window and released (all-zero table) rows,
   every row; the flash-prefill kernel (K4) at T in {64, 512, 2048}, B in
   {1, 8}, ragged lengths and a window, every row (bf16 tolerance about
   twice their largest measured error, not K1's looser one); the
   best-window similarity kernel (K5) at the semantic path's three
   geometries (4,096 windows x 19 patterns, x 1,024 patterns, and one
   query x 2,048 incidents; D = 384) and at any D (4,096 x 19 at D = 385,
   rows off 16-byte vectors, and at D = 1,536, 6 KB rows in f32), scores
   and the plain score at the chosen window, and exact first indices
   where window rows repeat; and the K5 wrapper's host time per call,
   part by part.
   Times each kernel, its plain version and one PyTorch library call
   computing the same function (``scaled_dot_product_attention`` over
   the gathered KV, or with the causal+length mask; ``torch.matmul`` +
   ``max`` for K5; timed here only, never called by the port), beside
   the least time the card could take (``bound``); K1 at the serve
   phase's three waves (decode, mixed, prefill), the mixed one its record;
   and K1 again at llama-3-8b's heads (QH=32, KH=8, D=128, the group of 4
   the deployed phase launches) over the three waves and the decode,
   window and off-grid geometries, held in bf16 and f32, and timed at the
   three waves beside its bound and the SDPA call; K1 at the families
   phase's heads, D = 128 and groups of 7 (28/4, qwen2.5-7b), 3 (24/8,
   llama-3.2-3b) and 6 (12/2, qwen2.5-1.5b), whose 64-row tiles cut a
   token's heads, over the three waves, the verify rows and the off-grid
   lengths, held and timed the same way; and under mistral-7b's
   4,096-token window over its 8,192 positions (QH=32, KH=8, D=128, 128
   pages of 64; tile 0 in 16 splits of 512): K1 on 32 rows of kv_len
   4,097-8,192 (decode rows; decode, verify rows and two chunks), bf16
   and f32, with whole splits before a row's window, timed with every row
   at 8,192 beside every row at 4,096 without the window (the same live
   keys); the paged decode kernel on 32 such rows and the prefill kernel
   at T = 8,192, B = 1, under the window, held on every row and timed.
   These outputs average thousands of random V rows (about 0.03), so
   each of their query rows is also held to ``ROW_TOL`` (its largest
   error over its largest plain output), which a split dropped or
   counted twice fails (``scripts/torch_k1_merge_mutation.py``);
3. train: training on the port's mesh layer (``parallel/``) over a real
   one-rank nccl group and a 1x1x1 ``DeviceMesh`` on the card.  (a) A full
   fine-tune of tinyllama-1.1b at full width (22 layers, hidden 2,048,
   bf16 params from ``--seed``): five ``make_train_step`` steps on one
   fixed batch of 8 x 512 tokens; the loss must drop.  (b) LoRA over
   llama-3-8b at full width (32 layers, an int8 base from
   ``init_params_quantized``): ``make_lora_train_step`` with rank-16
   adapters on wq/wk/wv/wo, five steps on 4 x 512 tokens; the loss must
   drop and the base must be bit for bit what it was; one more step with
   the int8 product as a plain expression gives the peak memory that
   ``models/quant.py:_Int8MatMul`` saves.  (c) (a)'s state
   saved and loaded (``save_train_state``/``load_train_state``) under
   the checkout's ``build/``: every leaf equal, and the next step's loss
   equal.  (d) ``tiny-test`` in f32, five steps on the card against the
   same five on the CPU: losses within 1e-3 relative.  Each of (a) and
   (b) gives ms per step (the median of steps 2-5), tokens per second
   and ``torch.cuda.max_memory_allocated``; no hand-written kernel may
   launch (the JAX training path runs no Pallas kernel).  With
   ``profile`` in ``--phases``, one more step of (a) and of (b) runs
   under ``torch.profiler``.  It runs before the serving phases, while
   the card's memory is free (after them, on an 80 GB H100, about 32 GiB
   are);
4. serve: the continuous path at full width — tinyllama-1.1b, 22
   layers, int8 weights from a seed, 32 slots, page 64, chunk 64,
   pipeline depth 2, speculative decoding on, the block-hash prefix cache
   on (the default) — through the port's HTTP server on localhost, with
   concurrent ``/v1/completions`` requests of mixed prompt lengths, greedy
   and sampled: the timed COLD drive.  Every kernel's launch count is set
   to 0 just before and read just after: the ragged kernel must have
   launched exactly once per layer per step, the others never, and the
   pages must balance in four terms (free + rows + the cache's pages +
   the shared-prefix hold).  Then one more request, untimed, of 786 prompt
   tokens: each of the 22 K1 calls of its first decode or verify step is
   held to the plain version on its own inputs (valid rows), and that
   step's tile 0 must have keys in at least three of its splits, so the
   split-KV merge is held too; and the same prompt again, held on its
   FIRST prefill step, a cache hit (12 of 13 pages cached: 18 queries at
   kv_len 786).  Then the WARM drive, the same ten requests again: it
   must save exactly the prompt tokens of every cached full block (4,032)
   and its step records must carry them.  Then, through ``engine.submit``,
   a deadline that fits fewer tokens than asked (finish "deadline"), one
   already passed (``DeadlineExceeded``), and a burst over a queue limit
   of 4 with an ``OverloadPolicy`` on the scheduler and the generator
   (sheds counted, every request settled); ``spill_cache()`` must leave
   no cached page on the card.  Then a second engine with a 256 MB host
   pool and 48 KV pages: a cold drive, a pressure drive (the same bodies,
   first byte changed) whose admissions must evict the cached blocks to
   the pinned pool while steps are in flight, ``spill_cache()`` and one
   short request, and a warm drive that restores the first chain from
   the pool: the pages balance, a restored page must hold exactly the
   bytes gathered at its eviction, and no commit window's drain may wait
   half a step (the copies run on a side stream);
5. wave: the wave path (``SCHED_MODE=wave``, ``DECODE_BLOCK=4``,
   ``PIPELINE_DEPTH=2``, ``OPERATOR_TPU_FLASH_PREFILL=1``) at the same
   width through the HTTP server with the same requests, driven twice,
   once with each decode-kernel selector (``OPERATOR_TPU_PAGED_KERNEL``
   ``v1``, the default, then ``v2``), each engine built anew and the
   counts set to 0 before each drive: the prefill kernel must have
   launched 22 times per prefill wave, the decode kernel 22 x 4 times per
   decode block, the ragged and similarity kernels never; every request
   finishes and every page comes back free.  Then one more request,
   untimed: each of its prefill wave's 22 K4 calls is held to the plain
   version on its own inputs (every row; ``prefill_drive_limit``); and
   one more, of 786 prompt tokens: each of the 22 K2/K3 calls of its
   first decode step is held to the plain version (every row, WAVE_TOL),
   and its long row must have keys in at least three of the kernel's
   splits, so the split-KV merge is held too.  On the ``v1`` engine the
   ten requests go once more with the step sleeping past a tightened
   stall budget after four steps: the supervisor must restart once and
   requeue every request in flight, the decode and prefill kernels launch
   again after the restart, and every page and slot comes back free;
6. guided: guided decoding and multi-LoRA on the wave engine at
   tinyllama-1.1b's full width (int8, 32 slots, page 64, flash prefill
   on), built by ``build_serving_engine`` with the default
   ``SCHED_MODE`` (continuous) and ``LORA_DIR`` naming ``incident`` and
   ``verbose`` (rank 16, wq/wk/wv/wo, alpha 16, a and b from ``--seed``,
   b nonzero), ``zero`` (all zeros) and a truncated file, all written by
   the port's ``save_lora``: the truncated file is skipped with its
   warning and the adapters fall back to the wave engine (block 4, depth
   2).  The host builds of a choice, a regex and a root-cause JSON
   schema's automata (ms, table MiB at the 32,000 vocab).  (a) Thirteen
   ``/v1/completions`` through the HTTP server, queued together: base,
   ``model: incident`` and ``model: verbose`` on three prompts each, the
   zero adapter, a ``guided_choice`` with ``incident``, a
   ``guided_regex`` and a ``guided_json`` root cause (a summary of up
   to 32 characters, 192 tokens, sampled; the rest 32 tokens, half
   greedy).  The greedy adapter rows
   must differ from the base row and the zero adapter's equal it; the
   guided rows must be in their languages and their tokens, replayed
   through their transition tables, never leave them; a replay of the
   batch from the same sampler state gives the same greedy answers;
   ``/v1/models`` lists the adapters, an unknown ``model`` is a 404 and
   ``response_format: json_object`` a 400; K4 launches 22 times per
   prefill wave, K2/K3 22 x 4 per decode block, K1 and K5 never, and the
   pages come back.  (b) For one prefill wave and one decode step of
   base, incident and verbose rows, each of the 22 x 4 adapted
   projections is held, row by row, to the f32 formula ``x @ W + (x @
   A[idx] @ B[idx]) * alpha / r`` (``LORA_ATOL`` + ``LORA_RTOL`` times
   the two terms' magnitudes).  The stream ms per decode block at 32
   rows: plain rows without the LoRA pass, plain rows on the adapter
   stack, every row adapted, every row guided, and a quarter of each
   kind.  (c) The port's ``Operator`` over
   ``FakeKubeApi`` (an encoder checkpoint of MiniLM width from a seed)
   with two ``tpu-native`` AIProviders on this engine: one asking for
   ``lora_adapter: incident`` and the root-cause ``guided_json``, one
   plain; five failing pods each.  Every stored explanation of the first
   must parse to the schema, the providers' identity digests differ (and
   the first's without its ``additionalConfig``), K5 launches once per
   ``analyze()`` and recall ``query()``, the wave kernels as the drive's
   waves and blocks say, K1 never;
7. graphs: the serving programs as captured CUDA graphs, at full width.
   Every other phase already serves through them (a held kernel's check
   runs its untimed request with the programs eager, ``eager_programs``).
   (a) tinyllama-1.1b (the serve phase's ten requests) and llama-3-8b
   (the deployed drive's ten prompts), each built by
   ``build_serving_engine`` with ``WARMUP_GRID=serving`` and
   ``AOT_CACHE_PATH``, the grid run by ``engine.precompile``: its dict,
   the captures and their seconds and the graph pool's bytes; then held
   drives (half greedy, no row stopping early, the prefix cache spilled
   before each) with the graphs and with the un-captured step
   (``Scheduler._mixed_fn``, ``make_mixed_step``'s function), in turns:
   no capture and no ``nvcc`` build after precompile, greedy answers
   equal, K1 exact, stream ms per step, tokens/s and the device's busy
   share (a traced drive of the first four requests at 16 tokens, whose
   device trace bounds K1's count: CUPTI loses some records of the
   replays, so no more than counted, and no replay with more than one per
   layer).  Under replay the
   counts are the wrappers' own: a launch under capture counts by a
   device add captured beside it (``ops/_build.py:LaunchCounter``).  (c) The guided phase's wave engine (LORA_DIR,
   32 slots, flash prefill) with ``WARMUP_GRID=full``: plain, adapted,
   guided and mixed held drives with graphs and eager, greedy answers
   equal, K2/K3 and K4 exact under replay (the mixed graph drive traced,
   its trace bounding the counts as in (a)).  (b) A second process on the
   same AOT caches boots both tinyllama engines again: no ``nvcc``, every
   capture a hit (as many as the records), nothing stored, no capture
   after precompile; cold and warm bring-up seconds.  Then (c)'s block
   drives at 32 rows (16 tokens) with graphs and eager (no LoRA pass, on
   the stack, adapted, guided), and (d) a one-shot device error mid-drive: one
   supervised restart, all eight requests requeued, no graph captured
   again.  (e) The analysis phase's long drive with the encoder's graph
   and eager: wall, encoder stream ms, every score within SIM_TOL.
   Last, the launch counters' own cost: a graph of a decode block's 88
   counted launches' device adds, device ms per replay;
8. analysis: the semantic analysis path at the full width of
   all-MiniLM-L6-v2 (f32 weights from a seed, byte-level token ids,
   buckets of 32 texts x 256 tokens) through ``PatternEngine.analyze``
   with a ``SemanticMatcher`` on the card: a crash-loop log of 33,000
   lines (4,096 windows after the newest-windows cut) and a short one,
   then ``IncidentIndex.query`` over 2,048 incidents.  The counts are
   set to 0 before each drive: K5 must launch exactly once per analysis
   and once per query, K1-K4 never.  Each K5 call of the drives is held
   to the plain version on its own inputs;
9. checkpoint: a tinyllama-1.1b checkpoint at full width (bf16, the
   serve phase's seeded weights) written by the port's ``save_params``
   as HF-layout shards with an index, with the committed
   SentencePiece-style ``tokenizer.json`` (``tests/torch_tokenizers/``),
   loaded back through ``build_tpu_native_provider`` (``CHECKPOINT_DIR``,
   int8 weights quantized as they land, the continuous scheduler): the
   tokenizer must be the checkpoint's ``HFTokenizer``, not the byte
   fallback, and the int8 tree byte for byte the seeded tree's
   ``quantize_params``.  Ten ``AnalysisRequest``s of the fixture logs
   (regex analysis, pod, logs; half greedy, 32 tokens each) go through
   ``TPUNativeProvider.generate`` at once, counts set to 0 before: K1
   exactly once per layer per step, the others never; one more request's
   22 K1 calls are held to the plain version; the same drive on an engine
   built in memory from the seeded tree must give the greedy requests'
   responses exactly (admission held until all ten are queued, in both,
   so both take the same steps).  Then an all-MiniLM-L6-v2-width f32
   encoder checkpoint (HF BERT names, ``config.json``, a 30,522-entry
   ``vocab.txt`` built from the fixtures and the built-in patterns):
   ``build_embedder`` must return a ``NeuralEmbedder`` (not the lexical
   fallback) whose weights are the seeded tree's, and
   ``PatternEngine.analyze`` of the 33,000-line log launches K5 once,
   held to the plain version, with the events of an in-memory encoder of
   the same weights and WordPiece tokenizer.  Checkpoint bytes, write and
   load seconds, GB/s, device memory after the load, the drive's wall,
   tokens/s and K1 launches, and the analysis wall, encoder span and K5
   launches are printed with the card's name and power limit;
8b. tokenizers: the tokenizer families the port reads beyond BPE, on the
   checkpoint phase's two checkpoints (their weights linked, not
   written again).  (a) The tinyllama-1.1b weights with the committed
   Unigram fixture's tokenizer files (``tests/torch_tokenizers/
   xlmr_unigram``: XLM-RoBERTa's layout, ``Precompiled`` charsmap, byte
   fallback) through ``build_serving_engine``: the engine's tokenizer
   must be an ``HFTokenizer`` over a Unigram model, its special ids and
   ``vocab_size`` and the ids of the fixture's prompts those of
   ``AutoTokenizer`` (``expected_ids.json``); the prompts are served
   (greedy, 8 tokens), the ids the engine read for each equal BOS and
   the expected ones, and K1 launches exactly once per layer per step
   with the counts set to 0 before.  (b) The MiniLM-width encoder weights
   with a ``tokenizer.json`` in the WordPiece fixture's layout over the
   same 30,522-entry vocab and no ``vocab.txt``: ``build_embedder`` must
   return a ``NeuralEmbedder``, whose ids equal the ``vocab.txt``
   checkpoint's on every fixture line and whose ``PatternEngine.analyze``
   launches K5 once with scores and indices equal to the ``vocab.txt``
   checkpoint's, exactly (the same tokens, the same weights); and the
   WordPiece fixture's own vocabulary, from its ``tokenizer.json`` and
   from a ``vocab.txt``, must give ``AutoTokenizer``'s ids
   (``expected_ids.json``) on its prompts, among them texts where
   Python's Unicode data and the library's differ (Devanagari and
   Bengali vowel signs, an ideograph of U+2B8xx, Unicode 16.0 capitals
   and digits, U+11938), their host encode time printed.  (c) The
   tinyllama-1.1b weights again, with the Script-aware fixture
   (``tests/torch_tokenizers/xlmr_scripts``: the Unigram fixture behind
   ``UnicodeScripts``, a ``Split`` on Script classes and ``Metaspace``),
   checked and served as (a) over its multilingual prompts.  (d) The
   tinyllama-1.1b weights again, with the log fixture
   (``tests/torch_tokenizers/onig_logs``: a BPE model behind a ``Split``
   expression only the port's own Oniguruma matcher runs — a recursive
   call, the absent operator, ``\\y``, an unbounded look-behind, a back
   reference under ``(?i)``), checked and served as (a) over its log-line
   prompts; on the prompt ``expected_ids.json`` marks as the one where
   the library gives up, the tokenizer must raise ``RetryLimitError``
   (its seconds printed).  Each family's host encode time per prompt is
   printed with the card, split by the engine its expressions take
   (Python's ``re`` or the matcher);
10. operator: the port's ``Operator`` (its default device, cuda) over the
   in-memory ``FakeKubeApi``, with the checkpoint phase's two checkpoints
   (kept for it, deleted after it): ``providerId: tpu-native`` through
   two AIProviders on the one engine (greedy, and the default
   temperature), each named by a Podmortem selecting ``app=payment`` pods
   of its variant, and ``ENCODER_CHECKPOINT_DIR`` for the semantic matcher
   and incident recall.  Ten pods in CrashLoopBackOff, one fixture log
   each, half per AIProvider, are poked with the reference demo's
   MODIFIED patch, the engine's admission held until all ten requests are
   queued; then a new pod with the log of a pod that stored an
   explanation (a recall hit), and pods with that log's numbers changed,
   then the next candidate's, until one changes the fingerprint (near or
   miss).  Every pod must carry its annotations, a ``recentFailures``
   entry whose status follows the provider's answer (``Analyzed``, or
   ``PatternOnly`` when seeded weights decode to blanks) and its two
   Events, the SLO ledger must settle each analysis once as completed, K1
   must launch 22 times per step of the drive and never for the hit, K5
   once per semantic ``analyze()`` and once per recall ``query()`` over a
   non-empty index, and ``/metrics`` must show the hit.  One more
   request's 22 K1 calls and one ``analyze()``'s K5 call are held to the
   plain versions, and a direct ``TPUNativeProvider`` drive of the same
   captured requests on an engine of the same weights (admission held
   too) must give the greedy pods' stored explanations.  Per pod: the
   wall from the poke to the stored status, its stage split from the
   span tree (collect, analyze, recall, generate, store) and the host
   time outside the engine; the drive's tokens/s against the checkpoint
   phase's provider drive, and the recall hit's wall;
11. remote: the serving front as a service and the operator's remote
   path, on the checkpoint phase's two checkpoints (kept for it too): two
   ``CompletionServer``s, replicas A and B, on an event loop of their own
   over one engine on the card, with the encoder as the embedder and the
   ``tpu-native`` provider as the analysis backend.  (a) The ten fixture
   prompts as chat requests, half greedy, 32 tokens, streamed, then the
   same ten plain, each drive held until all ten are queued in order, on
   an empty prefix cache from the same sampler state: each greedy
   stream's deltas must join to its plain text.  (b) A stream of 256
   tokens whose socket closes after its first chunk: its row must leave
   the scheduler within pipeline depth + 2 steps and the pages balance,
   ``/healthz`` ``inflight`` 0.  (c) Three ``AnalysisRequest``s through
   ``/api/v1/analysis/analyze``, then through ``TPUNativeProvider``
   directly, both held: equal greedy ``AIResponse``s.  (d) The port's
   ``Operator`` with ``providerId: openai-compatible`` naming both
   replicas: the operator phase's ten pods, each analysis held at the
   provider until all ten have their affinity owner; the replica owning
   enough pods is stopped between two held batches of five, so its pods
   fail there, requeue once and land on the other while its breaker
   opens; every pod stores its answer, ``GET /fleet`` lists both
   replicas, and the greedy answers equal a held replay of the captured
   engine requests from each batch's sampler state.  (e)
   ``/v1/embeddings`` of eight fixture lines equals ``embedder.embed``
   bit for bit.  (f) ``/metrics`` parses as Prometheus text and under
   OpenMetrics, and ``POST /profile?seconds=1`` during a short drive
   writes a trace naming K1's kernel.  In every drive K1 launches once
   per layer per step, K5 once per semantic ``analyze()`` and recall
   ``query()`` on the operator side; time to the first chunk, chunks per
   stream, the steps from the close to the release, tokens/s, the
   per-pod stage split and the HTTP overhead per request (the provider's
   dispatch span less the replica's own request span) are printed;
12. fleet: the operator's HA and elastic fleet, on the checkpoint phase's
   two checkpoints (kept for it too).  (a) Two ``Operator``s, ``op-a`` and
   ``op-b``, with ``LEADER_ELECTION`` and a 3 s lease over one
   ``FakeKubeApi``, one claims ledger and one ``tpu-native`` engine: ten
   failing pods (greedy; half at 32 tokens, half at 192), admission held
   until all ten are queued; once the leader has stored an analysis and
   still decodes, it is partitioned from its Lease and its tasks are
   cancelled without ``release()``.  The standby must take the lease and
   resume the leader's non-terminal claims (its admission held until all
   are queued); the cancelled rows leave the engine and the pages
   balance; every pod ends with one ``recentFailures`` entry from one
   successful status write; the greedy answers equal a held replay of
   each leader's batch.  (b) One ``Operator`` with ``DISCOVERY_ENABLED``
   and ``AUTOSCALE_ENABLED`` (1 to 2 replicas, target pressure 4, ticks
   and ``/healthz`` polls every 0.25 s, 2 s idle window) over a serving
   Deployment at one replica, ``providerId: openai-compatible`` with no
   ``apiUrl`` (the dynamic router).  A kubelet in this script follows
   ``spec.replicas``: it builds replica B (an engine from the checkpoint,
   a ``CompletionServer`` on an ephemeral port, one Endpoints subset) and
   later drops its subset, stops it and closes its engine.  Ten pods held
   on replica A until B has been prewarmed and joined, twelve more (every
   fixture log) held on both; the autoscaler must scale 1 -> 2 on fleet pressure and back to 1
   when idle, B must leave the ring and its engine's memory be freed, and
   the greedy answers equal held replays on the engines that served them.
   (c) A PatternLibrary CR naming a local git repository (skipped, with a
   line saying so, where ``git`` is not installed): the synced pattern
   must name the next analysis's event and K5 run at the new pattern
   count.  (d) ``python -m operator_tpu_torch.operator`` (``_run_real``)
   as a process of its own against a stub apiserver
   (``operator/kubefacade.py``, ``KUBECONFIG``): a pod stored over HTTP,
   SIGTERM exits 0 and the Lease is released; the process writes its
   kernel counts at exit.  K1 must launch once per layer per step of
   every drive, K5 once per semantic ``analyze()`` and recall ``query()``;
   kill to takeover, scale-up reaction, replica start, join to the first
   routed request, scale-down and process start to stored status are
   printed;
13. deployed: the deployed model, llama-3-8b at full width (32 layers,
   hidden 4,096, 32 query heads over 8 KV heads of 128, vocab 128,256,
   rope theta 500,000; int8 weights from a seed), with the committed
   byte-level tokenizer (``tests/torch_tokenizers/llama3_bl`` through
   ``load_tokenizer``), built by ``build_serving_engine`` with the
   reference's defaults: the continuous scheduler, the prefix cache,
   pipeline depth 2, speculation and the supervisor.  (a) Ten
   ``AnalysisRequest``s of the fixture logs through
   ``TPUNativeProvider.generate`` (32 tokens, half greedy, admission held
   until all ten are queued, on an empty prefix cache): K1 launches 32
   times per step, K2-K5 never, the pages balance; one step's 32 K1 calls
   are held to the plain version, its tile 0 with keys in three or more
   splits; tokens/s, ms per step, device memory after the load and the
   tokenizer's encode time per request are printed.  (b) The same drive
   with the step sleeping 5 s past a 3 s stall budget after 20 steps: one
   restart, every request requeued, no give-up and no leak, one
   ``engine-stall`` black-box record; every request settles, the greedy
   answers equal (a)'s, K1 launches 32 times per step, and the device
   memory is back within 64 MiB of its level before the stall.  (c) A
   one-shot device error at the ``engine.step`` seam is absorbed by a
   requeue; a persistent one fails its request after ``max_requeues``
   and, the window's three resets spent, ``load_report().gave_up`` is
   set.  (d) On a fresh engine, the JAX smoke's storm (``ArrivalSpec``
   "storm", 240/min for 5 s, seed 0) through ``build_storm_stack`` with
   one ``EngineReplica``, a stall after 40 steps: one restart, every
   arrival settles, no torn ledger line; the schedule's fingerprint, the
   attainment and the goodput are printed;
14. deploy: the port as it is deployed — ``Dockerfile.torch`` and
   ``deploy/overlays/h100`` rendered in Python
   (``operator_tpu_torch/utils/manifests.py``), each pod's container run
   as the kubelet runs it: the rendered ``command`` (``python`` is this
   interpreter) and ``env`` over the image's ``ENV``, in a copy of the
   image's tree (its ``COPY`` lines), with PATH holding no ``nvcc``; only
   the build directory, the volumes' paths and the Service URL of
   ``KV_FABRIC_PEERS`` (this pod, the one endpoint) are remapped, each
   remap printed, and a ``sitecustomize`` on PYTHONPATH writes the
   kernels' launches at exit.  (a) The image's pre-build (``python -m
   operator_tpu_torch.ops``, no card visible) into a fresh directory,
   beside (b): its seconds, and a library for every kernel source.  (b) A
   seeded llama-3-8b checkpoint (bf16, HF layout, ``save_params``, about
   16 GB; free disk checked first) with the committed Llama-3 tokenizer,
   where the pods' ``CHECKPOINT_DIR`` points.  (c) The serving pod: start
   → listening → ``/healthz`` 200 → a first completion, then ten
   ``/api/v1/analysis/analyze`` requests at once and SIGTERM once the
   engine holds all ten: each answered 200, exit 0 within the grace
   period less the preStop sleep.  (d) The operator pod against a stub
   apiserver (``KubeFacade``): ``/healthz/live`` and ``/healthz/ready``
   within their probes' windows, a failing pod's analysis stored (its
   first, loading the model warm from the page cache), SIGTERM: exit 0
   within the grace less the preStop sleep, the Lease released.  Each
   pod's peak host RSS (the largest of ``VmHWM``, the sampled ``VmRSS``
   and the reaped process's ``ru_maxrss``) against its rendered memory
   limit, and its card memory; K1 launched in both pods, no wave kernel
   (the overlay mounts no encoder, so the analysis matches lexically and
   launches no K5).  It fails if a cold start takes over half its startup
   probe's window, or if the pre-built directory's listing or mtimes
   changed (a pod built a kernel).  The checkpoint is deleted at the end;
15. fabric: the fleet KV fabric at llama-3-8b's full width, a prefill
   replica P (``REPLICA_ROLE=prefill``) and a decode replica D
   (``REPLICA_ROLE=decode``, ``KV_FABRIC_PEERS`` naming P) on the card,
   each built by ``build_serving_engine`` with the deployed phase's
   defaults and ``KV_FABRIC=1``, the mirror on and a 2 GB host pool (one
   set of int8 weights shared), each behind its own ``CompletionServer``,
   ``InvariantAuditor.barrier_hook`` on both schedulers.  (a) P serves the
   deployed phase's ten analysis prompts (32 tokens, half greedy, held)
   and mirrors their blocks; D serves them cold with the fabric off, then,
   its cache emptied and its index fed by one ``PeerPoller.poll_once()``
   of P's ``/healthz`` (the 128 most recently used blocks), with the
   fabric: the fetches, adoptions, restores and saved tokens must be
   those the advertised blocks give, each adopted block P's device page
   byte for byte, one step's 32 K1 calls over restored pages held to the
   plain version, and D's greedy answers P's when P, its cache pruned to
   the same blocks, restores them from its own pool; fetch ms per block
   (HTTP, decode: sha256 and copy, adopt), GB/s, D's prefill steps and
   time to first token against the cold drive are printed.  (c) On the
   first four prompts, each drive held against D's cold drive of them: a
   flipped payload byte (counted corrupt, never adopted, the index
   entries decaying); P's server killed once D's first block has decoded
   (its listener closed, every open connection reset: the fetches in
   flight fail, the rest are refused, every failure is counted, no
   attempt outlives its budget, and the greedy answers equal P's
   like-for-like restore of whatever blocks landed); P back on its port
   with its pool emptied under its advertised inventory (404s, evicted at
   once); and P's server stopped and its port black-holed (every attempt
   within its 0.25 s budget, the holder decaying).  (b) Ten greedy
   requests through ``disaggregated_dispatch`` over an ``EngineRouter``
   of P and D, the health board (D's index) refreshed after each prefill
   leg: ten handoffs, each prefill leg one token on P, each decode leg on
   D fetching every block of its prompt; the first four answers equal a
   replay of those four; the replay's wall against the same four on P
   alone and the decode legs a 5 s poll would have left on a stale index
   are printed.  (d) The auditor records no
   violation.  K1 launches 32 times per step of each engine, K2-K5
   never, and the pages balance after every drive;
16. prefix: the long-prompt path of the wave engine at tinyllama-1.1b's
   full width (int8, 32 slots, page 64, block 4, depth 2, flash prefill
   on).  (a) The int8 gate: ``parity_report`` of the seeded bf16 tree
   against ``quantize_params`` of it over the JAX test's two prompts and
   ten tokens; ``max_logit_diff`` must be under 0.5.  (b) An engine from
   ``build_serving_engine`` with ``PREFIX_CACHE`` on primes the default
   template's preamble (896 tokens, 14 pages); the operator drive's ten
   default-template prompts (over the budget, so the preamble is kept as
   their head) go through the HTTP server, admission held, primed and
   with the preamble cleared, after a warm-up drive of each, in turns
   (unprimed, primed, primed, unprimed): one prefixed wave (no K4: its
   suffix attention is the dense path, as in the JAX program) against
   one plain wave (22 K4), K2/K3 22 x 4 per block, the pool balancing
   with the prefix held; the prefill ms of each.  The same with each
   request's log cut to its last four lines and no pattern analysis
   (1,432 to 1,774 tokens, within the budget).  The build's 22 K4
   calls are held to the plain version, and the 22 K2/K3 calls of a
   decode step whose rows share the prefix pages.  (c) Two requests with
   a custom ``promptTemplate`` through ``TPUNativeProvider``: registered
   once, the second's wave prefixed.  (e) A one-shot device error under
   the supervisor: one restart, every prefix re-primed, the next wave
   prefixed.  (f) A second engine with ``PREFILL_CHUNK=256`` runs the
   ``serving`` grid: prefixed, chunk and finish keys captured; then (d):
   four live decode rows, a 16 x 2,048 wave as a chunked job (eight
   chunks, decode blocks between them, its reserved slots kept from a
   wave admitted meanwhile), each row's first-token logits within 0.25 of
   the one-shot K4 wave's on the same tokens; a prefixed wave after it,
   and nothing captured after the grid.  Then the 16 x 2,048 wave's
   prefill ms alone on the card, chunked and one-shot, in turns;
17. contiguous: the wave engine's contiguous KV cache
   (``KV_CACHE_MODE=contiguous``, a ``32 x 2,048`` cache) at
   tinyllama-1.1b's full width (int8, 32 slots, block 4, depth 2, flash
   prefill on, ``PREFIX_CACHE`` off), built by ``build_serving_engine``
   with ``SCHED_MODE`` at its default (continuous: the fallback to the
   wave engine and its warning are checked) and ``LORA_DIR`` (the guided
   phase's adapters).  (b) ``WARMUP_GRID=serving``: the grid's dict, its
   captures, seconds and pool bytes.  (a) The wave phase's ten requests
   through the HTTP server, admission held: K4 22 times per prefill wave,
   K1, K2/K3 and K5 never (the contiguous decode attends in dense
   PyTorch, as the JAX program does), every slot free; one more request's
   22 K4 calls held to the plain version; the same ten on a paged wave
   engine of the same weights, its decode's attention run by the plain
   version (which rounds the probabilities to bf16 as the dense decode
   does), must give the same greedy answers (against K2/K3, which keep
   them in f32, the equal rows are recorded).  (b)
   The stream ms per 32-row decode block, contiguous and paged (K2/K3),
   in turns; nothing captured or built after the grid.  (d) Base,
   ``incident`` and ``zero`` on one prompt and a ``guided_choice`` with
   ``incident``, admitted together: the zero adapter's answer is the
   base's, incident's differs, the choice stays in its automaton.  (e) A
   one-shot device error: one supervised restart whose reset zeroes the
   cache and the offsets in place, and the next wave replays its graphs.
   (c) On the worker: four live decode rows and a 16 x 2,048 wave with
   ``PREFILL_CHUNK=256`` (eight chunks, decode blocks between them), each
   row's first-token logits within 0.25 of the one-shot K4 wave's;
18. mesh: sharded serving (``SERVING_MESH``) on the wave engine, the
   deployed replica's knobs (llama-3-8b in int8 from a seed, 32 slots,
   ``SCHED_MODE`` at its default, continuous, which must fall back to the
   wave engine with the reference's warning naming the mesh, block 4,
   depth 2, flash prefill on).  (a) ``SERVING_MESH=dp=1,tp=1`` (and
   ``auto``, which must plan 1x1x1) at full width on a one-rank nccl
   group: every program a CUDA graph with its collectives inside; the
   ten wave-phase requests through the HTTP server: K4 32 times per
   prefill wave, K2/K3 32 x 4 per decode block, K1 and K5 never; one
   wave's 32 K4 calls and one decode step's 32 K2/K3 calls held to the
   plain versions at D = 128 (every row); ten short greedy prompts equal
   to the same wave engine built without ``SERVING_MESH``; tokens/s,
   stream ms per block and memory.  (b) ``dp=1,tp=4``: four rank
   processes (``--mesh-rank``, torchrun's environment) sharing the card
   over gloo, programs eager by the engine's stated mode, llama-3-8b at
   every width but ``MESH_B_LAYERS`` layers: each rank holds a quarter
   of the layer matrices (memory per rank) and launches K2/K3 and K4 at
   QH 8, KH 2, D 128 (per-rank counts held as in (a)); the next-token
   logits of four rows within ``MESH_LOGIT_TOL`` of one rank's at that
   depth, and the ten greedy answers equal wherever the one-rank model's
   top-two margin exceeds it.  (c) ``dp=2,tp=2`` on four ranks at
   tinyllama-1.1b width, loaded from a bf16 HF checkpoint (written here)
   through the sharded loader in int8, 16 slots per data rank: every
   prefill bucket a multiple of 2, the answers held to a one-rank
   engine's as in (b), per-rank launches;
19. parity: small f32 ``tiny-test`` engines on the card (kernels) and on
   the CPU (plain versions) must give the same greedy tokens — the
   continuous engine, and the wave engine with the decode selector at
   ``v1`` and ``v2`` and flash prefill on and off, and with a shared
   prefix (a prefixed wave) and chunked prefill (chunk 16), and over the
   contiguous cache with flash prefill on and off; the
   continuous engine
   with the prefix cache and an 8 MB host pool over two waves of prompts
   sharing a prefix, a ``spill_cache()`` between them (and the warm wave
   the cold one's on the card); and a ``PatternEngine``
   with a tiny f32 ``NeuralEmbedder`` must find the same events on the
   card as on the CPU over the 12 fixture logs (scores within 1e-4); and
   the continuous engine (speculation on, depth 2) over three f32
   variants of ``tiny-test`` carrying the other families' features — a
   24-token window, q/k/v biases with groups of 7, tied embeddings with
   llama3 RoPE scaling and groups of 3 — on prompts of three windows:
   greedy tokens equal, K1 once per layer per step on the card;
20. families: the model families beyond Llama through the continuous
   main path as deployed (``build_serving_engine`` with ``SERVE_ENV``:
   int8, 32 slots, page 64, chunk 64, depth 2, speculation, the prefix
   cache, every step a CUDA graph from the ``serving`` warmup grid), each
   at full width and serving its whole context (``SERVING_MAX_SEQ`` at
   the model's ``max_seq_len``), behind
   the port's HTTP server: (a) mistral-7b at full depth (32 layers, a
   4,096-token window over 8,192 positions): a priming request caches a
   shared head of 4,401 tokens, then ten requests of 4,500-7,000 prompt
   tokens that reuse its 4,352 (more than the window) and 32 new tokens
   each, so every row's kv_len passes the window; then one more request,
   with its programs eager, whose first decode step has its 32 K1 calls
   each held to the plain version (tile 0 in 16 splits, at least three
   wholly before the window); (b) qwen2.5-7b cut to 4 layers (seeded
   q/k/v biases, groups of 7, a 152,064-token vocabulary) and (c)
   llama-3.2-3b cut to 4 layers (groups of 3, tied embeddings, llama3
   scaling by 32), each over the serve phase's ten requests; (d)
   qwen2.5-1.5b at full depth (28 layers, biases, tied embeddings, groups
   of 6) loaded int8 through ``CHECKPOINT_DIR`` from a seeded bf16
   checkpoint written under ``build/`` (3.1 GB; the byte tokenizer), its
   tree the seeded tree's ``quantize_params`` byte for byte, and an
   in-memory engine of the same tree.  Each drive is held until its ten
   requests are queued, after a ``spill_cache()``, twice (the in-memory
   engine once): K1 once per layer per step and no other kernel, pages
   balanced in four terms, the greedy answers of the second drive (and
   of (d)'s in-memory engine) the first's, nothing captured and no
   ``nvcc`` build after the warmup grid.  Records tokens/s, stream ms a
   step, the card's GiB, build and capture seconds; the card released
   between engines.  Then (e) mistral-7b at full depth on the wave engine
   (``SCHED_MODE=wave``, flash prefill on, programs captured at first
   use): (a)'s first four bodies twice, K4 once per layer per prefill
   wave and K2/K3 once per layer per step of each block, the greedy
   answers equal; one more request's first decode step has its 32 K2/K3
   calls held to the plain version past the window.

``--phases device,kernels,serve,profile`` (or ``...,wave,profile``, the
``v1`` drive, ``...,analysis,profile``, the long analysis, or
``...,train,profile``, a step of (a) and of (b)) also drives
that phase's work again under ``torch.profiler`` and prints the device
time by kernel and the device's busy share (not part of the default
run).

After the phases, one JSON line gives each phase's seconds (``phase_s``)
and, after each, the threads left, their names, the share of a host CPU
they burn while the script sleeps and the card's free memory
(``left_behind``).
The line before the last is one JSON object with a record per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import importlib
import json
import logging
import os
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

#: bf16: the plain version rounds the softmax probabilities to bf16 before
#: P.V and rounds again at the end; the kernel keeps them in f32 and rounds
#: once — a few bf16 ulps of outputs of magnitude up to ~3
TOL = {"bfloat16": 6e-2, "float32": 1e-4}
#: the decode (K2/K3) and prefill (K4) kernels, for the same reasons: in
#: bf16 about twice the largest error measured on these cases (0.0078
#: decode, 0.0156 prefill — a bf16 ulp at magnitude 2)
WAVE_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12  # dense tensor-core bf16 peak
F32_FLOPS = 67e12  # float32 on the CUDA cores (K5 does its products there)
#: time_ms's spin before each timed call: 200,000 SM cycles, about 0.1 ms
#: at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 200_000
#: K5: the kernel and the plain version sum the same f32 products in
#: different orders (bf16 inputs are widened exactly)
SIM_TOL = 1e-5

#: the serve and wave phases' requests: prompt lengths in characters and
#: the completion budget
PROMPT_CHARS = [16, 40, 100, 220, 400, 700, 1000, 1500, 64, 300]
MAX_TOKENS = 32
#: the held requests' prompt (LOG_LINE * 5) in tokens: 785 bytes + BOS
HIT_PROMPT_TOKENS = 786

LOG_LINE = (
    "2026-10-16T12:00:01Z kubelet[812]: Back-off restarting failed container "
    "app in pod web-7d9f8c (exit code 137, reason OOMKilled, memory limit "
    "512Mi exceeded)\n"
)


def fail(message: str) -> "SystemExit":
    return SystemExit(f"chip_smoke: FAIL: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def tensor_core_instructions(build) -> dict:
    """Each built library's count of tensor-core instructions in its SASS
    (``HMMA``: mma.sync; ``HGMMA``: wgmma), read by ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    counts = {}
    for name in build.source_names():
        sass = subprocess.run(
            [tool, "-sass", str(build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True,
        ).stdout
        counts[name] = len(re.findall(r"\bHG?MMA\b", sass))
    return counts


def prefill_drive_limit(dtype: str, want_abs):
    """The per-element limit for the wave drive's own K4 calls: WAVE_TOL
    plus one bf16 ulp of the output (2^-7 |plain|), never above K1's 6e-2.
    Those calls reach |out| = 4.16, where one ulp is 0.03125, and the
    kernel rounds P to bf16 before normalising while the plain version
    rounds it after, so the two can land one ulp apart (0.03125 measured
    on an H100); small outputs keep the 3e-2 of the kernels phase."""
    if dtype != "bfloat16":
        return WAVE_TOL[dtype]
    return (WAVE_TOL[dtype] + want_abs * 2.0 ** -7).clamp(max=TOL[dtype])


class HeldToPlain:
    """Stands in for a kernel's dispatch function: the first ``calls``
    calls that ``select`` accepts are each held to the plain version on
    their own inputs right after the launch (the plain version launches
    none of the port's kernels, so the counts are untouched), rows chosen
    by ``valid``, each element within ``limit(dtype, |plain|)``; ``note``
    adds what a call covered to its record."""

    def __init__(self, fn, plain, calls: int, limit, select=None, valid=None, note=None):
        self.fn, self.plain, self.calls, self.limit = fn, plain, calls, limit
        self.select, self.valid, self.note = select, valid, note
        self.held: list = []

    def __call__(self, *args, **kwargs):
        import torch

        got = self.fn(*args, **kwargs)
        if len(self.held) < self.calls and (self.select is None or self.select(*args)):
            want = self.plain(*args, **kwargs)
            got_v, want_v = got.float(), want.float()
            if self.valid is not None:
                rows = self.valid(*args)
                got_v, want_v = got_v[rows], want_v[rows]
            dtype = str(got.dtype).replace("torch.", "")
            err = (got_v - want_v).abs()
            self.held.append({
                "max_abs_err": err.max().item(),
                "excess": (err - self.limit(dtype, want_v.abs())).max().item(),
                "max_abs_plain": want_v.abs().max().item(),
                "finite": bool(torch.isfinite(got_v).all().item()),
                "dtype": dtype,
                **(self.note(*args, **kwargs) if self.note else {}),
            })
        return got


@contextlib.contextmanager
def eager_programs():
    """While held, every serving program (``serving/graphs.py``) runs its
    function eagerly: a held kernel's Python dispatch, which a hold
    replaces, runs in an eager call and at a capture, never in a replay.
    The held requests are untimed; their launches are real and counted."""
    from operator_tpu_torch.serving.graphs import GraphProgram

    call = GraphProgram.__call__
    GraphProgram.__call__ = lambda self, *args, key=None, variant=None: self.fn(*args)
    try:
        yield
    finally:
        GraphProgram.__call__ = call


def held_drive_calls(url: str, module, name: str, held: HeldToPlain, prompt: str) -> dict:
    """One more request, untimed, with ``module.name`` replaced by
    ``held`` (the programs eager meanwhile); fails unless all of its calls
    were held and each agrees (every element within its limit: ``excess``
    <= 0).  The record keeps the largest of each number over the calls."""
    setattr(module, name, held)
    try:
        with eager_programs():
            _post(url, {"prompt": prompt, "max_tokens": 8, "temperature": 0.0})
    finally:
        setattr(module, name, held.fn)
    return held_record(name, held)


def held_record(name: str, held: HeldToPlain) -> dict:
    """Fails unless all of ``held``'s calls were held and each agrees
    (every element within its limit: ``excess`` <= 0).  The record keeps
    the largest of each number over the calls."""
    calls = held.held
    record = {"calls": len(calls), "dtypes": sorted({c["dtype"] for c in calls})}
    for key in (calls[0] if calls else {}):
        if key not in ("finite", "dtype"):
            record[key] = max(c[key] for c in calls)
    print(json.dumps({"drive_calls": {name: record}}), flush=True)
    bad = [c for c in calls if not c["finite"] or not c["excess"] <= 0]
    if len(calls) != held.calls or bad:
        raise fail(f"{name}: {len(calls)} of {held.calls} drive calls held, outside tolerance: {bad}")
    return record


def k1_split_note(q, k_pages, v_pages, page_table, kv_len, q_count, sliding_window=None) -> dict:
    """How many of tile 0's splits hold keys of a live row in this K1
    call, by the kernel's span rule (``csrc/ragged_attention.cu``
    ``tile_span``) and the wrapper's plan (1 when the plan does not
    split), and the most splits wholly before a live row's window."""
    from operator_tpu_torch.ops import ragged_attention as ra

    plan = ra.launch_plan(q, k_pages, page_table)
    group = q.shape[2] // k_pages.shape[2]
    most = 0
    before = 0  # the most splits wholly before a live row's window
    for seq, count in zip(kv_len.tolist(), q_count.tolist()):
        if count <= 0:
            continue
        if plan.n_splits == 1:
            most = max(most, 1)
            continue
        end = min(seq, seq - count + min((ra.TILE_ROWS - 1) // group, count - 1) + 1)
        begin = 0
        if sliding_window:
            begin = max(seq - count - sliding_window + 1, 0)
            begin -= begin % ra.STAGE_KEYS
        most = max(most, -(-end // plan.split_keys) - begin // plan.split_keys)
        before = max(before, begin // plan.split_keys)
    return {"n_splits": plan.n_splits, "split_keys": plan.split_keys,
            "splits_with_keys": most, "splits_before_window": before}


def k2_split_note(q, k_pages, v_pages, page_table, lengths, sliding_window=None) -> dict:
    """How many of the decode kernel's splits hold keys of the longest
    row in this K2/K3 call, by the kernel's span rule
    (``csrc/paged_attention.cu``) and the wrapper's plan; 1 when the plan
    does not split."""
    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    from operator_tpu_torch.ops import ragged_attention as ra

    plan = pa.launch_plan(q, k_pages, page_table)
    most = 0
    for seq in lengths.tolist():
        end = min(seq, page_table.shape[1] * k_pages.shape[1])
        lo = max(seq - sliding_window, 0) if sliding_window else 0
        begin = lo - lo % ra.STAGE_KEYS
        if plan.n_splits == 1 or end <= begin:
            most = max(most, 1)
            continue
        most = max(most, (end - 1) // plan.split_keys - begin // plan.split_keys + 1)
    return {"n_splits": plan.n_splits, "splits_with_keys": most}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` with a cold L2: each call is preceded by
    a write of twice the card's 50 MB L2 (outside the timed events), as
    the serving step finds a layer's pages after 21 other layers, and by
    a spin of the card (``torch.cuda._sleep``, about 0.1 ms) that lets the
    host enqueue the call before the start event runs, so a call shorter
    than its host-side work is timed without the host's gap.  All calls
    are enqueued before the one synchronise."""
    import torch

    flush = torch.empty(100 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

B, C, QH, KH, D, PAGE, PPS = 32, 64, 32, 4, 64, 64, 32
MAX_SEQ = PAGE * PPS
#: K1's heads at the two full widths the port serves: tinyllama-1.1b (the
#: serve phase) and llama-3-8b (the deployed phase: D = 128, group of 4)
HEADS = {"tinyllama-1.1b": (QH, KH, D), "llama-3-8b": (32, 8, 128)}


def geometry(name: str, rng):
    """(c, kv_len, q_count, window) for one scheduler geometry."""
    import numpy as np

    c, window = C, None
    kv_len = rng.integers(64, MAX_SEQ + 1, size=B)
    if name == "prefill":  # whole prompts and mid-prompt chunks
        q_count = np.minimum(kv_len, C)
        q_count[: B // 2] = kv_len[: B // 2] = rng.integers(1, C + 1, size=B // 2)
    elif name == "decode":
        c = 1
        kv_len = rng.integers(1, MAX_SEQ + 1, size=B)
        q_count = np.ones(B, np.int64)
    elif name == "mixed":  # 24 decode rows, 4 chunks, 4 idle slots
        q_count = np.ones(B, np.int64)
        q_count[24:28] = C
        q_count[28:] = 0
        kv_len[28:] = 0
    elif name == "verify":  # committed token + k prompt-lookup drafts
        q_count = 1 + rng.integers(1, 5, size=B)
    elif name == "idle_rows":  # live rows left out of the step
        q_count = np.where(np.arange(B) % 2 == 0, 1, 0)
    elif name == "window":
        q_count = np.ones(B, np.int64)
        q_count[::4] = C
        window = 200
    elif name == "ragged":  # kv_len never a multiple of the page size
        kv_len = PAGE * rng.integers(1, PPS, size=B) + rng.integers(1, PAGE, size=B)
        q_count = np.where(np.arange(B) % 3 == 0, np.minimum(kv_len, 37), 1)
    # the waves of the serve phase's step: at most t_budget = 64 query
    # tokens in all, decode rows first, then one prefill chunk
    elif name == "wave_decode":  # every slot decodes
        q_count = np.ones(B, np.int64)
    elif name == "wave_mixed":  # 24 decode rows, a 40-token chunk, idle slots
        q_count = np.zeros(B, np.int64)
        q_count[:24] = 1
        q_count[24] = 40
        kv_len[25:] = 0
    elif name == "wave_prefill":  # one 64-token chunk of a long prompt
        q_count = np.zeros(B, np.int64)
        q_count[0] = C
        kv_len[1:] = 0
        kv_len[0] = rng.integers(C, 1536 + 1)
    elif name == "wave_hit":  # a prefix-cache hit's first chunk: the held
        # warm request of the serve phase, 786 prompt tokens of which 12
        # pages were cached, so 18 queries at the end of 786 keys
        q_count = np.zeros(B, np.int64)
        q_count[0] = HIT_PROMPT_TOKENS - cached_tokens(HIT_PROMPT_TOKENS)
        kv_len[1:] = 0
        kv_len[0] = HIT_PROMPT_TOKENS
    else:
        raise ValueError(name)
    return c, kv_len.astype(np.int32), q_count.astype(np.int32), window


def kernel_case(name: str, dtype, seed: int, heads: tuple = (QH, KH, D)):
    import numpy as np
    import torch

    qh, kh, d = heads
    rng = np.random.default_rng(seed)
    c, kv_len, q_count, window = geometry(name, rng)
    num_pages = B * PPS + 1
    table = (1 + rng.permutation(num_pages - 1)[: B * PPS]).reshape(B, PPS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (num_pages, PAGE, kh, d)
    k_pages = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v_pages = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((B, c, qh, d), generator=gen, device="cuda").to(dtype)
    args = (
        q, k_pages, v_pages,
        torch.as_tensor(table, dtype=torch.int32, device="cuda"),
        torch.as_tensor(kv_len, device="cuda"),
        torch.as_tensor(q_count, device="cuda"),
    )
    return args, window, kv_len, q_count


def bound(kv_len, q_count, window, itemsize, heads: tuple = (QH, KH, D), pps: int = PPS):
    """Least time for the function on these inputs: live KV (each row's
    in-window keys), the valid q rows and out rows, the indices; and the
    QK^T + PV operations at the bf16 tensor-core peak."""
    qh, kh, d = heads
    live_kv = 0
    flops = 0
    for length, count in zip(kv_len.tolist(), q_count.tolist()):
        if count <= 0:
            continue
        live_kv += min(length, window or length)
        for i in range(count):
            q_pos = length - count + i
            keys = min(q_pos + 1, window or (q_pos + 1))
            flops += 4 * keys * qh * d
    nbytes = live_kv * kh * d * 2 * itemsize + 2 * int(sum(q_count)) * qh * d * itemsize
    nbytes += (len(kv_len) * pps + 2 * len(kv_len)) * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def sdpa(q, k, v, mask):
    """One ``scaled_dot_product_attention`` call over [B, H, T, D] tensors
    with a boolean mask; GQA by ``enable_gqa`` or, on a torch without it,
    by expanding the KV heads first (outside the timing)."""
    import torch.nn.functional as F

    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:
        group = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def library_call(args, window):
    """One PyTorch call computing the same function:
    scaled_dot_product_attention over the pre-gathered KV with the
    ragged causal mask (built outside the timing)."""
    import torch

    q, k_pages, v_pages, table, kv_len, q_count = args
    b, c = q.shape[0], q.shape[1]
    kh, d = k_pages.shape[2], k_pages.shape[3]
    max_seq = table.shape[1] * k_pages.shape[1]
    k = k_pages[table.long()].reshape(b, max_seq, kh, d).transpose(1, 2).contiguous()
    v = v_pages[table.long()].reshape(b, max_seq, kh, d).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()  # [B, QH, C, D]
    kv_pos = torch.arange(max_seq, device="cuda")[None, None, :]
    q_pos = ((kv_len - q_count).long()[:, None] + torch.arange(c, device="cuda"))[:, :, None]
    mask = (kv_pos <= q_pos) & (kv_pos < kv_len.long()[:, None, None])
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    return sdpa(qd, k, v, mask[:, None])


def phase_kernels(results: dict) -> dict:
    geometries = [
        "prefill", "decode", "mixed", "verify", "idle_rows", "window", "ragged",
        "wave_decode", "wave_mixed", "wave_prefill", "wave_hit",
    ]
    checks = []
    worst = k1_check(checks, lambda name, dtype, index: kernel_case(name, dtype, index),
                     geometries)
    # the serve phase's waves in bf16 (and a prefix-cache hit's first
    # chunk); the mixed one is the record
    timings = k1_time("", lambda name, dtype: kernel_case(name, dtype, 100),
                      ("wave_decode", "wave_mixed", "wave_prefill", "wave_hit"), (QH, KH, D))
    deployed, deployed_worst = k1_deployed_geometry(checks)
    families, families_worst = k1_family_geometry(checks)
    long_window, long_worst = k1_long_window(checks)
    record = {
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "operator_tpu_torch/ops/csrc/ragged_attention.cu",
        "replaces": "operator_tpu/ops/ragged_attention.py:114",
        "launches": None,  # filled by the serve phase
        "max_abs_err": worst,
        **timings["wave_mixed"],
        "geometries": timings,  # the serve phase's waves and the hit chunk
        # llama-3-8b's heads (D = 128, group of 4) at the same waves
        "geometries_llama_3_8b": deployed,
        "max_abs_err_llama_3_8b": deployed_worst,
        # the families phase's heads (groups of 7, 3 and 6) at the same waves
        "geometries_families": families,
        "max_abs_err_families": families_worst,
        # mistral-7b's window over its 8,192 positions
        "geometries_mistral_7b": long_window,
        "max_abs_err_mistral_7b": long_worst,
    }
    results["kernel_checks"] = checks
    results["kernel_timings"] = timings
    results["kernel_timings_llama_3_8b"] = deployed
    results["kernel_timings_families"] = families
    results["kernel_timings_mistral_7b"] = long_window
    return record


#: TOL and WAVE_TOL are stated for outputs of magnitude up to ~3.  Under
#: mistral-7b's window a query row averages up to 4,096 randn V rows, so
#: its outputs are about sqrt(e / 4096) ~ 0.026 (the largest about 0.1),
#: and a split dropped or counted twice moves them by about 0.01-0.05:
#: those cases are also held query row by query row (its heads and D), its
#: largest error over its largest |plain| within ROW_TOL.  bf16: 2.5 ulps
#: of the row's largest output (an ulp is at most 2^-7 of it), as TOL is
#: 2.5-5 ulps at magnitude 2-3; f32: TOL over magnitude 3
ROW_TOL = {"bfloat16": 2e-2, "float32": 1e-4 / 3}


def row_scaled_err(got, want) -> float:
    """The largest, over query rows (every dim but the last two: heads
    and D), of a row's max |got - want| over its max |want|."""
    diff = (got - want).abs().flatten(-2).amax(-1)
    return (diff / want.abs().flatten(-2).amax(-1).clamp_min(1e-30)).max().item()


def hold(checks: list, record: dict, got, want, tol: float,
         row_tol: "float | None" = None) -> float:
    """Hold ``got`` to ``want``, the plain version's on the same inputs:
    finite, every element within ``tol`` and, given ``row_tol``, every
    query row's largest error within ``row_tol`` of its largest |want|.
    Adds the numbers to ``record``, appends and prints it; fails outside
    the tolerance.  Returns the max abs error."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    record.update(max_abs_err=err, tol=tol, finite=bool(torch.isfinite(got).all().item()))
    ok = record["finite"] and err <= tol
    if row_tol is not None:
        record.update(max_row_rel_err=row_scaled_err(got, want), row_rel_tol=row_tol)
        ok = ok and record["max_row_rel_err"] <= row_tol
    checks.append(record)
    print(json.dumps({"kernel_check": record}), flush=True)
    if not ok:
        raise fail(f"kernel check outside its tolerance: {record}")
    return err


def k1_check(checks: list, make, names, *, label: str = "", info: "dict | None" = None,
             note=None, scaled: bool = False) -> float:
    """K1 held to its plain version (``hold`` at TOL, and with ``scaled``
    at ROW_TOL too; valid rows) on ``make(name, dtype, index)`` for each
    of ``names``, in bf16 and f32; ``info`` and ``note(*args,
    sliding_window=)`` join each record.
    Returns the largest bf16 error."""
    import torch

    from operator_tpu_torch.ops import ragged_attention as ra

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for index, name in enumerate(names):
            args, window, _, _ = make(name, dtype, index)
            record = {"geometry": f"{label}/{name}" if label else name, "dtype": dname,
                      **(info or {}), **(note(*args, sliding_window=window) if note else {})}
            got = ra.ragged_attention_cuda(*args, sliding_window=window)
            torch.cuda.synchronize()
            want = ra.ragged_attention_reference(*args, sliding_window=window)
            valid = torch.arange(args[0].shape[1], device="cuda")[None, :] < args[5][:, None]
            err = hold(checks, record, got[valid], want[valid], TOL[dname],
                       ROW_TOL[dname] if scaled else None)
            if dname == "bfloat16":
                worst = max(worst, err)
            del args, got, want
            torch.cuda.empty_cache()
    return worst


def k1_time(label: str, make, names, heads: tuple, pps: int = PPS,
            iters: tuple = (50, 5, 20), plain_warmup: int = 2,
            info: "dict | None" = None) -> dict:
    """K1 timed in bf16 on ``make(name, bfloat16)`` for each of ``names``
    beside the plain version (``iters``: the kernel's, the plain
    version's and the SDPA call's calls), its bound and the SDPA call."""
    import torch

    from operator_tpu_torch.ops import ragged_attention as ra

    timings = {}
    for name in names:
        args, window, kv_len, q_count = make(name, torch.bfloat16)
        bound_ms, bound_by = bound(kv_len, q_count, window, 2, heads, pps)
        timings[name] = {
            "ms": time_ms(lambda: ra.ragged_attention_cuda(*args, sliding_window=window),
                          iters[0]),
            "plain_ms": time_ms(
                lambda: ra.ragged_attention_reference(*args, sliding_window=window), iters[1],
                warmup=plain_warmup),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(library_call(args, window), iters[2]),
            **(info or {}),
        }
        del args
        torch.cuda.empty_cache()
        print(json.dumps({"kernel_timing": {
            "geometry": f"{label}/{name}" if label else name, **timings[name],
            "bound_us": bound_ms * 1e3,
        }}), flush=True)
    return timings


def k1_heads_geometry(checks: list, label: str, heads: tuple, seed: int,
                      names: tuple = ("wave_decode", "wave_mixed", "wave_prefill", "decode",
                                      "window", "ragged")) -> tuple:
    """K1 at another model's heads (page 64) over ``names``, bf16 and f32:
    held to the plain version (valid rows), then timed in bf16 over the
    serve phase's three waves (decode, mixed, prefill) beside its bound
    and the SDPA call.  Returns (timings by wave, the largest bf16 error)."""
    worst = k1_check(checks, lambda name, dtype, index: kernel_case(name, dtype, seed + index,
                                                                    heads),
                     names, label=label, info={"heads": heads})
    timings = k1_time(label, lambda name, dtype: kernel_case(name, dtype, seed + 100, heads),
                      ("wave_decode", "wave_mixed", "wave_prefill"), heads,
                      info={"heads": heads})
    return timings, worst


def k1_deployed_geometry(checks: list) -> tuple:
    """K1 at llama-3-8b's heads (QH = 32, KH = 8, D = 128): the deployed
    model's group of 4."""
    return k1_heads_geometry(checks, "llama-3-8b", HEADS["llama-3-8b"], 200)


#: K1's heads at the families phase's models, D = 128 each: a 64-row tile
#: cuts a token's heads at groups of 7 (qwen2.5-7b), 3 (llama-3.2-3b) and
#: 6 (qwen2.5-1.5b); the verify rows and the off-grid lengths beside the
#: serve phase's three waves
FAMILY_HEADS = {"qwen2.5-7b": (28, 4, 128), "llama-3.2-3b": (24, 8, 128),
                "qwen2.5-1.5b": (12, 2, 128)}
FAMILY_GEOMETRIES = ("wave_decode", "wave_mixed", "wave_prefill", "verify", "ragged")
#: mistral-7b: its heads, its window, and its context of 128 pages of 64
#: (8,192 positions: tile 0 in 16 splits of 512)
MISTRAL_HEADS, MISTRAL_WINDOW, LONG_PPS = (32, 8, 128), 4096, 128


def k1_family_geometry(checks: list) -> tuple:
    """K1 at each of ``FAMILY_HEADS``: (timings by heads, largest bf16 error)."""
    timings, worst = {}, 0.0
    for index, (label, heads) in enumerate(FAMILY_HEADS.items()):
        timings[label], err = k1_heads_geometry(checks, label, heads, 400 + 10 * index,
                                                FAMILY_GEOMETRIES)
        worst = max(worst, err)
    return timings, worst


def long_window_case(name: str, dtype, seed: int):
    """K1's inputs at mistral-7b's heads over its 8,192 positions, window
    4,096: every live row's kv_len in 4,097-8,192 (``long_window_decode``:
    32 decode rows; ``long_window_mixed``: decode and verify rows, a
    40-token and a 64-token chunk, idle slots; ``long_window_8192``: every
    row decoding at 8,192), or ``long_4096``: every row decoding at 4,096
    with no window, the same live keys a row."""
    import numpy as np
    import torch

    qh, kh, d = MISTRAL_HEADS
    rng = np.random.default_rng(seed)
    span = LONG_PPS * PAGE
    c, window = 1, MISTRAL_WINDOW
    q_count = np.ones(B, np.int64)
    kv_len = rng.integers(MISTRAL_WINDOW + 1, span + 1, size=B)
    if name == "long_window_decode":
        kv_len[:4] = [MISTRAL_WINDOW + 1, span, MISTRAL_WINDOW + PAGE, 6000]
    elif name == "long_window_mixed":
        c = C
        q_count[16:24] = 1 + rng.integers(1, 5, size=8)
        q_count[24], q_count[25] = 40, C
        q_count[28:] = 0
        kv_len[28:] = 0
    elif name == "long_window_8192":
        kv_len[:] = span
    elif name == "long_4096":
        kv_len[:] = MISTRAL_WINDOW
        window = None
    else:
        raise ValueError(name)
    num_pages = B * LONG_PPS + 1
    table = (1 + rng.permutation(num_pages - 1)[: B * LONG_PPS]).reshape(B, LONG_PPS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (num_pages, PAGE, kh, d)
    args = (
        torch.randn((B, c, qh, d), generator=gen, device="cuda").to(dtype),
        torch.randn(shape, generator=gen, device="cuda").to(dtype),
        torch.randn(shape, generator=gen, device="cuda").to(dtype),
        torch.as_tensor(table, dtype=torch.int32, device="cuda"),
        torch.as_tensor(kv_len.astype(np.int32), device="cuda"),
        torch.as_tensor(q_count.astype(np.int32), device="cuda"),
    )
    return args, window, kv_len.astype(np.int32), q_count.astype(np.int32)


def k1_long_window(checks: list) -> tuple:
    """K1 under mistral-7b's window over its whole context: the decode and
    mixed cases held to the plain version (valid rows) in bf16 and f32,
    each query row's error also within ROW_TOL of its outputs, the bf16
    plan 16 splits of 512 with whole splits before a row's window; then
    timed in bf16, every row at kv_len 8,192 under the window beside every
    row at 4,096 without one (the same live keys: the kernel walks only
    those, so about 1x).  Returns (timings, largest bf16 error)."""
    start = len(checks)
    worst = k1_check(checks, lambda name, dtype, index: long_window_case(name, dtype, 500 + index),
                     ("long_window_decode", "long_window_mixed"), label="mistral-7b",
                     info={"heads": MISTRAL_HEADS, "window": MISTRAL_WINDOW},
                     note=k1_split_note, scaled=True)
    for record in checks[start:]:
        if record["dtype"] == "bfloat16" and (
                (record["n_splits"], record["split_keys"]) != (16, 512)
                or record["splits_before_window"] < 1):
            raise fail(f"{record['geometry']}: tile 0's plan {record}, want 16 splits of 512 "
                       f"and whole splits before the window")
    names = ("long_window_8192", "long_4096", "long_window_mixed")
    timings = k1_time("mistral-7b", lambda name, dtype: long_window_case(name, dtype, 600),
                      names, MISTRAL_HEADS, LONG_PPS, iters=(50, 3, 10), plain_warmup=1,
                      info={"heads": MISTRAL_HEADS})
    for name in names:
        timings[name]["window"] = None if name == "long_4096" else MISTRAL_WINDOW
    timings["window_8192_over_4096"] = (timings["long_window_8192"]["ms"]
                                        / timings["long_4096"]["ms"])
    print(json.dumps({"k1_window_8192_over_4096": timings["window_8192_over_4096"]}),
          flush=True)
    return timings, worst


#: the serve and wave phases' prompts in tokens (byte tokenizer: chars + BOS)
PROMPT_TOKENS = [n + 1 for n in PROMPT_CHARS]


def cached_tokens(prompt_tokens: int, page: int = PAGE) -> int:
    """Prompt tokens a warm request reuses from the prefix cache: every
    full block but the one the match leaves so one token prefills
    (``(len - 1) // page`` blocks)."""
    return (prompt_tokens - 1) // page * page


def decode_case(name: str, dtype, seed: int, heads: tuple = (QH, KH, D)):
    """(args, window, lengths) of the paged decode kernel at tinyllama's
    shapes: 32 rows, page 64, 32 pages per row (``heads``: another
    model's or a tp rank's (QH, KH, D))."""
    qh, kh, d = heads
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    window = None
    released: list = []
    lengths = rng.integers(1, MAX_SEQ + 1, size=B)
    lengths[:6] = [1, 64, 128, 2048, 63, 65]  # length 1, full pages, page edges
    if name == "decode_window":
        window = 200
    elif name == "decode_released":  # finished slots: zero table, length 1
        released = list(range(0, B, 3))
        lengths[released] = 1
    elif name == "decode_wave":
        # the wave path's decode rows: the serve phase's ten requests half
        # way through their 32 tokens, the other 22 slots never admitted
        lengths[:] = 1
        released = list(range(len(PROMPT_TOKENS), B))
        lengths[: len(PROMPT_TOKENS)] = [n + 16 for n in PROMPT_TOKENS]
    num_pages = B * PPS + 1
    table = (1 + rng.permutation(num_pages - 1)[: B * PPS]).reshape(B, PPS)
    table[released] = 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (num_pages, PAGE, kh, d)
    args = (
        torch.randn((B, qh, d), generator=gen, device="cuda").to(dtype),
        torch.randn(shape, generator=gen, device="cuda").to(dtype),
        torch.randn(shape, generator=gen, device="cuda").to(dtype),
        torch.as_tensor(table, dtype=torch.int32, device="cuda"),
        torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
    )
    return args, window, lengths


def decode_bound(lengths, window, itemsize, heads: tuple = (QH, KH, D)):
    """Least time of one decode call: each row's live K and V read once,
    q read, out written, the ids of the pages holding live keys and the
    lengths read; 4 * keys * QH * D operations at the bf16 tensor-core
    peak."""
    QH, KH, D = heads  # noqa: N806 - the module's names, another geometry's values
    keys = live_pages = 0
    for n in map(int, lengths):
        first = max(n - window, 0) if window else 0
        keys += n - first
        live_pages += (n - 1) // PAGE - first // PAGE + 1
    nbytes = keys * KH * D * 2 * itemsize + 2 * B * QH * D * itemsize + (live_pages + B) * 4
    flops = 4 * keys * QH * D
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def decode_library_call(args, window):
    """SDPA over the gathered KV with the length (and window) mask."""
    import torch

    q, k_pages, v_pages, table, lengths = args
    kh, d = k_pages.shape[2:]
    max_seq = table.shape[1] * k_pages.shape[1]
    k = k_pages[table.long()].reshape(B, max_seq, kh, d).transpose(1, 2).contiguous()
    v = v_pages[table.long()].reshape(B, max_seq, kh, d).transpose(1, 2).contiguous()
    pos = torch.arange(max_seq, device="cuda")[None, :]
    mask = pos < lengths.long()[:, None]
    if window is not None:
        mask = mask & (pos >= lengths.long()[:, None] - window)
    return sdpa(q[:, :, None, :].contiguous(), k, v, mask[:, None, None, :])


def prefill_case(name: str, dtype, seed: int, heads: tuple = (QH, KH, D)):
    """(args, window, lengths) of the flash-prefill kernel at tinyllama's
    head layout (``heads``: another model's or a tp rank's)."""
    qh, kh, d = heads
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    window = None
    if name == "prefill_t64_b1":
        t, lengths = 64, [64]
    elif name == "prefill_t512_b8":
        t, lengths = 512, [512, 1, 300, 77, 511, 256, 130, 64]
    elif name == "prefill_t2048_b1":
        t, lengths = 2048, [1501]
    elif name == "prefill_t2048_b8":
        t, lengths = 2048, [2048, 1, 1501, 700, 65, 1024, 2000, 333]
    elif name == "prefill_window":
        t, lengths, window = 512, [512, 40, 300, 9, 511, 256, 130, 64], 128
    elif name == "prefill_wave":
        # the wave path's first prefill bucket: the serve phase's ten
        # prompts, padded to 16 rows with copies of row 0, t = 2048
        t = 2048
        lengths = PROMPT_TOKENS + [PROMPT_TOKENS[0]] * 6
    else:
        raise ValueError(name)
    b = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = (
        torch.randn((b, t, qh, d), generator=gen, device="cuda").to(dtype),
        torch.randn((b, t, kh, d), generator=gen, device="cuda").to(dtype),
        torch.randn((b, t, kh, d), generator=gen, device="cuda").to(dtype),
        torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
    )
    return args, window, np.asarray(lengths)


def prefill_bound(lengths, t, window, itemsize, heads: tuple = (QH, KH, D)):
    """Least time of one prefill call: q read and out written over all T
    positions (padded query rows are part of the output), K and V read at
    the positions some query row attends to — the first ``length`` of
    each row, and V at all T where the window leaves a padded query with
    no key (the plain version averages V there); 4 * QH * D operations
    for every (query, key) pair the mask admits, padded query rows
    included, and 2 * QH * D * T for each query row with no key, at the
    bf16 tensor-core peak."""
    import numpy as np

    QH, KH, D = heads  # noqa: N806 - the module's names, another geometry's values
    q_pos = np.arange(t)
    kv_rows = flops = 0
    for length in lengths.tolist():
        hi = np.minimum(q_pos + 1, length)  # keys <= q and < length
        lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros_like(q_pos)
        keys = np.clip(hi - lo, 0, None)
        empty = int((keys == 0).sum())
        kv_rows += length + (t if empty else length)  # K rows + V rows
        flops += 4 * QH * D * int(keys.sum()) + 2 * QH * D * t * empty
    nbytes = (len(lengths) * t * 2 * QH + kv_rows * KH) * D * itemsize + len(lengths) * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def prefill_library_call(args, window):
    """SDPA with the causal + length (+ window) mask, built outside the
    timing (SDPA takes is_causal or a mask, not both)."""
    import torch

    q, k, v, lengths = args
    t = q.shape[1]
    pos = torch.arange(t, device="cuda")
    mask = (pos[None, :] <= pos[:, None])[None] & (
        pos[None, None, :] < lengths.long()[:, None, None]
    )
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)[None]
    return sdpa(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), mask[:, None],
    )


#: the wave kernels' head layouts (QH, KH, D): tinyllama-1.1b's (the wave
#: phase), llama-3-8b's (the deployed model) and one tp rank's share of
#: llama-3-8b's under the deployed plan's tp = 4 (the mesh phase)
WAVE_HEADS = {
    "tinyllama-1.1b": (QH, KH, D),
    "llama-3-8b": (32, 8, 128),
    "llama-3-8b/tp4": (8, 2, 128),
}


def phase_wave_kernels(results: dict) -> list:
    """The paged decode kernel (K2/K3) and the flash-prefill kernel (K4)
    against their plain versions, every row, at each of ``WAVE_HEADS``;
    then their times."""
    import torch

    from operator_tpu_torch.ops import flash_prefill as fp
    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")

    checks = []
    worst = {"decode": 0.0, "prefill": 0.0}
    cases = [("decode", name) for name in (
        "decode_mixed", "decode_window", "decode_released", "decode_wave",
    )] + [("prefill", name) for name in (
        "prefill_t64_b1", "prefill_t512_b8", "prefill_t2048_b1", "prefill_t2048_b8",
        "prefill_window",
    )]
    for heads_name, heads in WAVE_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            for seed, (kind, name) in enumerate(cases):
                if kind == "decode":
                    args, window, _ = decode_case(name, dtype, seed, heads)
                    got = pa.paged_attention_cuda(*args, sliding_window=window)
                    torch.cuda.synchronize()
                    want = pa.paged_attention_reference(*args, sliding_window=window)
                else:
                    args, window, _ = prefill_case(name, dtype, seed, heads)
                    got = fp.flash_prefill_cuda(*args, sliding_window=window)
                    torch.cuda.synchronize()
                    want = fp.flash_prefill_reference(*args, sliding_window=window)
                err = (got.float() - want.float()).abs().max().item()
                finite = bool(torch.isfinite(got.float()).all().item())
                del got, want, args
                torch.cuda.empty_cache()
                tol = WAVE_TOL[dname]
                checks.append({"kernel": kind, "geometry": name, "heads": heads_name,
                               "dtype": dname, "max_abs_err": err, "tol": tol,
                               "finite": finite})
                print(json.dumps({"kernel_check": checks[-1]}), flush=True)
                if not finite or not err <= tol:
                    raise fail(f"{kind} kernel {name}/{heads_name}/{dname}: "
                               f"max_abs_err={err} (tol {tol})")
                if dname == "bfloat16":
                    worst[kind] = max(worst[kind], err)
    timings = {}
    timed_cases = [(kind, name, "tinyllama-1.1b") for kind, name in (
        ("decode", "decode_wave"), ("decode", "decode_mixed"),
        ("prefill", "prefill_wave"), ("prefill", "prefill_t2048_b8"))]
    timed_cases += [(kind, name, heads) for heads in ("llama-3-8b", "llama-3-8b/tp4")
                    for kind, name in (("decode", "decode_wave"), ("prefill", "prefill_wave"))]
    for kind, name, heads_name in timed_cases:
        heads = WAVE_HEADS[heads_name]
        if kind == "decode":
            args, window, lengths = decode_case(name, torch.bfloat16, 100, heads)
            bound_ms, bound_by = decode_bound(lengths, window, 2, heads)
            kernel = lambda: pa.paged_attention_cuda(*args, sliding_window=window)  # noqa: E731
            plain = lambda: pa.paged_attention_reference(*args, sliding_window=window)  # noqa: E731
            library = decode_library_call(args, window)
            iters = (50, 5, 20)
        else:
            args, window, lengths = prefill_case(name, torch.bfloat16, 100, heads)
            bound_ms, bound_by = prefill_bound(lengths, args[0].shape[1], window, 2, heads)
            kernel = lambda: fp.flash_prefill_cuda(*args, sliding_window=window)  # noqa: E731
            plain = lambda: fp.flash_prefill_reference(*args, sliding_window=window)  # noqa: E731
            library = prefill_library_call(args, window)
            iters = (5, 2, 5)
        key = name if heads_name == "tinyllama-1.1b" else f"{name}@{heads_name}"
        timings[key] = {
            "heads": heads_name,
            "ms": time_ms(kernel, iters[0]),
            "plain_ms": time_ms(plain, iters[1], warmup=1),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(library, iters[2]),
        }
        del args, library
        torch.cuda.empty_cache()
        print(json.dumps({"kernel_timing": {
            "geometry": key, **timings[key], "bound_us": bound_ms * 1e3,
        }}), flush=True)
    long_checks, long_timings = wave_long_window()
    checks += long_checks
    timings.update(long_timings)
    for check in long_checks:
        if check["dtype"] == "bfloat16":
            worst[check["kernel"]] = max(worst[check["kernel"]], check["max_abs_err"])
    results["wave_kernel_checks"] = checks
    results["wave_kernel_timings"] = timings
    # both selector values launch this one kernel, so its check and times
    # stand in both records; each record's launches come from the wave
    # drive under its own selector value
    deployed = ("llama-3-8b", "llama-3-8b/tp4")
    decode = {
        "route": "cuda",
        "source": "operator_tpu_torch/ops/csrc/paged_attention.cu",
        "launches": None,  # filled by the wave phase
        "max_abs_err": worst["decode"],
        **timings["decode_wave"],
        "geometries": {name: timings[name] for name in (
            "decode_wave", "decode_mixed", *(f"decode_wave@{h}" for h in deployed),
            "decode_long_window@mistral-7b")},
    }
    return [
        {"name": "paged_decode_attention_v2", **decode,
         "replaces": "operator_tpu/ops/paged_attention.py:252"},
        {"name": "paged_decode_attention_v1", **decode,
         "replaces": "operator_tpu/ops/paged_attention.py:191"},
        {"name": "flash_prefill_attention", "route": "cuda",
         "source": "operator_tpu_torch/ops/csrc/flash_prefill.cu",
         "replaces": "operator_tpu/ops/flash_prefill.py:78",
         "launches": None, "max_abs_err": worst["prefill"],
         **timings["prefill_wave"],
         "geometries": {name: timings[name] for name in (
             "prefill_wave", "prefill_t2048_b8", *(f"prefill_wave@{h}" for h in deployed),
             "prefill_t8192_window@mistral-7b")}},
    ]


def wave_long_window() -> tuple:
    """The decode kernel (K2/K3) over mistral-7b's 8,192 positions (32
    rows of 4,097-8,192 keys, 128 pages of 64) and the prefill kernel (K4)
    at T = 8,192, B = 1, both under its 4,096-token window: each held to
    its plain version on every row in bf16 and f32, then timed in bf16
    beside its bound and the SDPA call; each query row's error (a decode
    row, a prefill token) also within ROW_TOL of its outputs.  Returns
    (checks, timings)."""
    import numpy as np
    import torch

    from operator_tpu_torch.ops import flash_prefill as fp
    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")

    qh, kh, d = MISTRAL_HEADS
    window = MISTRAL_WINDOW

    def decode_args(dtype, seed):
        rng = np.random.default_rng(seed)
        lengths = rng.integers(window + 1, LONG_PPS * PAGE + 1, size=B)
        lengths[:3] = [window + 1, LONG_PPS * PAGE, 6000]
        num_pages = B * LONG_PPS + 1
        table = (1 + rng.permutation(num_pages - 1)[: B * LONG_PPS]).reshape(B, LONG_PPS)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        shape = (num_pages, PAGE, kh, d)
        return (
            torch.randn((B, qh, d), generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.as_tensor(table, dtype=torch.int32, device="cuda"),
            torch.as_tensor(lengths.astype(np.int32), device="cuda"),
        ), lengths

    def prefill_args(dtype, seed):
        t = LONG_PPS * PAGE
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return (
            torch.randn((1, t, qh, d), generator=gen, device="cuda").to(dtype),
            torch.randn((1, t, kh, d), generator=gen, device="cuda").to(dtype),
            torch.randn((1, t, kh, d), generator=gen, device="cuda").to(dtype),
            torch.as_tensor([t], dtype=torch.int32, device="cuda"),
        ), np.asarray([t])

    kinds = {
        "decode": ("decode_long_window@mistral-7b", decode_args, pa.paged_attention_cuda,
                   pa.paged_attention_reference),
        "prefill": ("prefill_t8192_window@mistral-7b", prefill_args, fp.flash_prefill_cuda,
                    fp.flash_prefill_reference),
    }
    checks, timings = [], {}
    for kind, (key, make, kernel, plain) in kinds.items():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            args, _ = make(dtype, 700)
            got = kernel(*args, sliding_window=window)
            torch.cuda.synchronize()
            want = plain(*args, sliding_window=window)
            hold(checks, {"kernel": kind, "geometry": key, "heads": "mistral-7b",
                          "dtype": dname, "window": window},
                 got, want, WAVE_TOL[dname], ROW_TOL[dname])
            del got, want, args
            torch.cuda.empty_cache()
        args, lengths = make(torch.bfloat16, 800)
        if kind == "decode":
            bound_ms, bound_by = decode_bound(lengths, window, 2, MISTRAL_HEADS)
            library = decode_library_call(args, window)
            iters = (50, 3, 10)
        else:
            bound_ms, bound_by = prefill_bound(lengths, lengths[0], window, 2, MISTRAL_HEADS)
            library = prefill_library_call(args, window)
            iters = (5, 2, 3)
        timings[key] = {
            "heads": "mistral-7b", "window": window,
            "ms": time_ms(lambda: kernel(*args, sliding_window=window), iters[0]),
            "plain_ms": time_ms(lambda: plain(*args, sliding_window=window), iters[1], warmup=1),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(library, iters[2]),
        }
        del args, library
        torch.cuda.empty_cache()
        print(json.dumps({"kernel_timing": {
            "geometry": key, **timings[key], "bound_us": bound_ms * 1e3,
        }}), flush=True)
    return checks, timings


#: K5's geometries on the semantic path: name -> (windows, patterns, D)
SIM_GEOMETRIES = {
    "analysis": (4096, 19, 384),  # max_windows x the built-in library
    "library": (4096, 1024, 384),  # the same log against a large library
    "recall": (1, 2048, 384),  # one query x IncidentStore.max_entries
    # any D, as the JAX kernel: rows off 16-byte vectors, and rows of 6 KB
    # (an encoder wider than 1,024 in f32: the streaming layout)
    "odd_d": (4096, 19, 385),
    "wide_d": (4096, 19, 1536),
}


def similarity_case(name: str, dtype, seed: int, duplicated: bool = False):
    """(windows, patterns) of unit rows on the card.  ``duplicated``: each
    pattern is a copy of one window row in the first half, and that row
    appears again right after it, one tile on and near the end, so the
    first copy is the only right index (returned as the third item)."""
    import numpy as np
    import torch

    w, p, d = SIM_GEOMETRIES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    windows = torch.nn.functional.normalize(
        torch.randn((w, d), generator=gen, device="cuda"), dim=-1).to(dtype)
    patterns = torch.nn.functional.normalize(
        torch.randn((p, d), generator=gen, device="cuda"), dim=-1).to(dtype)
    firsts = None
    if duplicated:
        rng = np.random.default_rng(seed)
        firsts = rng.choice(w // 2, size=min(p, w // 2), replace=False)
        taken = set(firsts.tolist())
        for j, first in enumerate(firsts.tolist()):
            for later in (first + 1, first + 65, w - 1 - j):
                if later < w and later not in taken:
                    windows[later] = windows[first]
            patterns[j] = windows[first]
    return windows, patterns, firsts


def similarity_bound(w: int, p: int, d: int, itemsize: int):
    """Least time of one best-window call: both matrices read once, the
    scores and indices written once; 2 * W * P * D float32 operations on
    the CUDA cores."""
    nbytes = (w + p) * d * itemsize + p * 8
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * w * p * d / F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_similarity(windows, patterns, scores, idx) -> float:
    """K5's result against the plain version on the same inputs: the
    largest error of the scores and of the plain score at the chosen
    window (cuBLAS may order near-equal windows differently)."""
    import torch

    from operator_tpu_torch.ops import similarity as sim

    want, _ = sim.best_window_scores_reference(windows, patterns)
    matrix = sim.similarity_matrix(windows, patterns)
    chosen = matrix[idx.long(), torch.arange(patterns.shape[0], device=matrix.device)]
    return max((scores - want).abs().max().item(), (chosen - want).abs().max().item())


def phase_similarity_kernels(results: dict, phases: set) -> dict:
    """K5 against its plain version at the three geometries in bf16 and
    f32, exact first indices on repeated rows; then its f32 times (and,
    with ``profile``, ten calls per geometry under ``torch.profiler``)."""
    import torch

    from operator_tpu_torch.ops import similarity as sim

    checks = []
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for seed, name in enumerate(SIM_GEOMETRIES):
            for duplicated in (False, True):
                if duplicated and name == "recall":
                    continue  # one window: nothing to repeat
                windows, patterns, firsts = similarity_case(name, dtype, seed, duplicated)
                scores, idx = sim.best_window_scores_cuda(windows, patterns)
                torch.cuda.synchronize()
                err = check_similarity(windows, patterns, scores, idx)
                exact = True
                if duplicated:
                    got = idx[: len(firsts)].cpu().numpy()
                    exact = bool((got == firsts).all())
                checks.append({"kernel": "similarity", "geometry": name, "dtype": dname,
                               "repeated_rows": duplicated, "max_abs_err": err,
                               "tol": SIM_TOL, "first_index_exact": exact})
                print(json.dumps({"kernel_check": checks[-1]}), flush=True)
                if not err <= SIM_TOL or not exact:
                    raise fail(f"similarity kernel {name}/{dname} repeated={duplicated}: "
                               f"max_abs_err={err} (tol {SIM_TOL}), first index exact={exact}")
                worst = max(worst, err)
    timings = {}
    for name, (w, p, d) in SIM_GEOMETRIES.items():
        windows, patterns, _ = similarity_case(name, torch.float32, 100)
        bound_ms, bound_by = similarity_bound(w, p, d, 4)
        timings[name] = {
            "ms": time_ms(lambda: sim.best_window_scores_cuda(windows, patterns), 50),
            "plain_ms": time_ms(lambda: sim.best_window_scores_reference(windows, patterns), 20),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(lambda: torch.matmul(windows, patterns.T).max(0), 20),
        }
        print(json.dumps({"kernel_timing": {
            "kernel": "similarity", "geometry": name, **timings[name], "bound_us": bound_ms * 1e3,
        }}), flush=True)
    results["similarity_kernel_checks"] = checks
    results["similarity_kernel_timings"] = timings
    results["similarity_host_us"] = {
        name: similarity_host_us(*similarity_case(name, torch.float32, 100)[:2])
        for name in ("analysis", "recall")
    }
    print(json.dumps({"similarity_host_us": results["similarity_host_us"]}), flush=True)
    if "profile" in phases:  # the kernels' own device time, without time_ms's events
        results["similarity_kernel_profile"] = {}
        for name in SIM_GEOMETRIES:
            windows, patterns, _ = similarity_case(name, torch.float32, 100)
            results["similarity_kernel_profile"][name] = profile_call(
                lambda: [sim.best_window_scores_cuda(windows, patterns) for _ in range(10)])
    return {
        "name": "best_window_similarity",
        "route": "cuda",
        "source": "operator_tpu_torch/ops/csrc/similarity.cu",
        "replaces": "operator_tpu/ops/similarity.py:85",
        "launches": None,  # filled by the analysis phase
        "max_abs_err": worst,
        **timings["analysis"],
        "geometries": timings,
    }


def similarity_host_us(windows, patterns, iters: int = 400) -> dict:
    """The K5 wrapper's host time per call in microseconds, part by part:
    each part run ``iters`` times back to back on the host clock (the card
    is not waited for; a synchronise ends each part, outside its time).
    ``checks`` is the whole call less the parts timed."""
    import torch

    from operator_tpu_torch.ops import similarity as sim

    (w, d), p = windows.shape, patterns.shape[0]
    device = windows.device
    fn = sim._kernel_fn()
    plan = sim.launch_plan(w, p, d, 4, sim._sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    scores = torch.empty(p, dtype=torch.float32, device=device)
    best = torch.empty(p, dtype=torch.int32, device=device)
    part_s = torch.empty((plan.shares, p), dtype=torch.float32, device=device)
    part_i = torch.empty((plan.shares, p), dtype=torch.int32, device=device)
    counters = sim.ticket_counters(device, stream, plan.p_tiles)
    scratch = plan.shares > 1
    ptrs = (part_s.data_ptr(), part_i.data_ptr(), counters.data_ptr()) if scratch else (None,) * 3

    def outputs():
        torch.empty(p, dtype=torch.float32, device=device)
        torch.empty(p, dtype=torch.int32, device=device)

    def scratches():
        if scratch:
            torch.empty((plan.shares, p), dtype=torch.float32, device=device)
            torch.empty((plan.shares, p), dtype=torch.int32, device=device)
            sim.ticket_counters(device, stream, plan.p_tiles)

    parts = {
        "call": lambda: sim.best_window_scores_cuda(windows, patterns),
        "plan": lambda: sim.launch_plan(w, p, d, 4, sim._sm_count(device)),
        "stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "outputs": outputs,
        "scratch": scratches,
        "launch": lambda: fn(windows.data_ptr(), patterns.data_ptr(), scores.data_ptr(),
                             best.data_ptr(), *ptrs, w, p, d, plan.config, plan.share_w,
                             plan.shares, 0, stream),
    }
    out = {}
    for name, part in parts.items():
        for _ in range(20):
            part()
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(iters):
            part()
        out[name] = (time.perf_counter() - started) / iters * 1e6
        torch.cuda.synchronize()
    out["checks"] = out["call"] - sum(v for k, v in out.items() if k != "call")
    out["shares"] = plan.shares
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path through the HTTP server
# ---------------------------------------------------------------------------

SERVE_ENV = {
    "OPERATOR_TPU_MODEL": "tinyllama-1.1b",
    "ALLOW_RANDOM_WEIGHTS": "true",
    "SERVING_DTYPE": "int8",
    "MAX_BATCH_SIZE": "32",
    "KV_PAGE_SIZE": "64",
    "SCHED_CHUNK": "64",
    "SCHED_PIPELINE_DEPTH": "2",
    "SPEC_DECODE": "true",
}


class HttpLoop:
    """The port's ``CompletionServer``s (asyncio ``start``/``stop``) on an
    event loop of their own thread, while the drives talk to them over
    urllib from this one."""

    def __init__(self, *servers) -> None:
        self.servers = list(servers)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="http", daemon=True)
        self.thread.start()
        for server in self.servers:
            self.run(server.start())

    def run(self, coro, timeout: float = 600.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self) -> None:
        """Stop every server still listening, cancel what else runs on the
        loop (an engine's peer poller), then stop the loop."""
        async def cancel_rest():
            rest = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for task in rest:
                task.cancel()
            await asyncio.gather(*rest, return_exceptions=True)

        try:
            for server in self.servers:
                if server.bound_port is not None:
                    self.run(server.stop(), timeout=120)
            self.run(cancel_rest(), timeout=60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()


def healthz(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
        return json.loads(resp.read())


def _post(url: str, body: dict, timeout: float = 600.0) -> dict:
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(request, timeout=timeout) as resp:
        return json.loads(resp.read())


def request_bodies() -> list:
    prompts = [(LOG_LINE * (n // len(LOG_LINE) + 1))[:n] for n in PROMPT_CHARS]
    return [
        {"prompt": p, "max_tokens": MAX_TOKENS,
         "temperature": 0.0 if i % 2 == 0 else 0.7, "top_p": 0.95}
        for i, p in enumerate(prompts)
    ]


def drive_requests(url: str, bodies: list, truncated: bool = False) -> tuple:
    """Send every body at once from its own thread; returns (completion
    tokens, wall seconds).  Fails unless every request finished with a
    sane usage record (``truncated``: prompts over the budget, whose
    prompt tokens are the budget's)."""
    replies: list = [None] * len(bodies)
    errors: list = []

    def send(i: int) -> None:
        try:
            replies[i] = _post(url, bodies[i])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {exc!r}")

    started = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(900)
    wall = time.perf_counter() - started
    if errors or any(t.is_alive() for t in threads):
        raise fail(f"requests failed: {errors}")
    return checked_completion(bodies, replies, truncated), wall


def held_requests(engine, url: str, bodies: list) -> tuple:
    """Every body at once over HTTP, the engine's admission held until all
    are queued in list order (``held_sends``), so two drives of the same
    bodies take the same steps; returns (completion tokens, wall seconds
    from the release, the replies), checked as ``drive_requests`` checks
    them."""
    timing: dict = {}
    replies = held_sends(engine, [lambda body=body: _post(url, body) for body in bodies],
                         timing=timing)[0]
    wall = time.perf_counter() - timing["released"]
    return checked_completion(bodies, replies), wall, replies


def checked_completion(bodies: list, replies: list, truncated: bool = False) -> int:
    """The replies' completion tokens, failing unless each finished with a
    sane usage record."""
    completion = 0
    for body, reply in zip(bodies, replies):
        choice = reply["choices"][0]
        usage = reply["usage"]
        if choice["finish_reason"] not in ("length", "stop"):
            raise fail(f"unexpected finish_reason {choice['finish_reason']}")
        if not truncated and usage["prompt_tokens"] != len(body["prompt"].encode()) + 1:
            raise fail(f"prompt_tokens {usage['prompt_tokens']} for {len(body['prompt'])} chars")
        if not 0 <= usage["completion_tokens"] <= MAX_TOKENS:
            raise fail(f"completion_tokens {usage['completion_tokens']}")
        completion += usage["completion_tokens"]
    if completion == 0:
        raise fail("no request generated any token")
    return completion


def balanced(sched, where: str) -> dict:
    """The scheduler's page accounting, failing unless it balances in
    four terms: free + rows' grants + the prefix cache's pages + the
    shared-prefix hold == every page but the trash page."""
    acc = sched.page_accounting()
    if acc["available"] + acc["row_pages"] + acc["store_pages"] + acc["prefix_pages"] != acc["total"]:
        raise fail(f"page accounting does not balance {where}: {acc}")
    return acc


def wait_idle(sched) -> None:
    deadline = time.time() + 30
    while sched.num_active and time.time() < deadline:
        time.sleep(0.05)


def timed_drive(url: str, sched, config, kernel_modules: dict, where: str,
                bodies: "list | None" = None, engine=None) -> dict:
    """The ten requests once, every kernel count set to 0 just before and
    read just after: K1 exactly once per layer per step, the others never;
    the scheduler holds no row after it and its pages balance.  Returns
    the drive's record, the prefix cache's economy over it included; with
    ``engine``, the requests are held until all are queued
    (``held_requests``) and the record keeps each reply's text."""
    g = sched.generator
    bodies = bodies or request_bodies()
    counter = g.metrics.counter
    kv_names = ("kv_hit", "kv_miss", "kv_prefill_tokens_saved", "kv_evict",
                "kv_offload", "kv_restore")
    kv0 = {name: counter(name) for name in kv_names}
    ring = g.step_clock.ring
    seq0 = ring.records(1)[0].seq if len(ring) else -1
    for module in kernel_modules.values():
        module.launches = 0
    steps0, dev0 = sched.steps, len(sched.device_ms)
    replies = None
    if engine is None:
        completion, wall = drive_requests(url, bodies)
    else:
        completion, wall, replies = held_requests(engine, url, bodies)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    steps = sched.steps - steps0
    device_ms = sched.device_ms[dev0:]
    wait_idle(sched)
    accounting = balanced(sched, f"after the {where} drive")
    if accounting["row_pages"]:
        raise fail(f"rows hold pages after the {where} drive: {accounting}")
    if launches["ragged_paged_attention"] != config.num_layers * steps or steps == 0:
        raise fail(
            f"{where} drive: ragged kernel launched {launches['ragged_paged_attention']} "
            f"times over {steps} steps of {config.num_layers} layers"
        )
    others = {k: n for k, n in launches.items() if k != "ragged_paged_attention"}
    if any(others.values()):
        raise fail(f"other kernels launched on the continuous path: {others}")
    records = [r for r in ring.records() if r.seq > seq0]
    return {
        "completion_tokens": completion, "wall_s": wall,
        "tokens_per_s": completion / wall, "steps": steps,
        "device_ms_per_step": sum(device_ms) / len(device_ms) if device_ms else None,
        "launches": launches, "page_accounting": accounting,
        "kv_economy": {name[3:]: counter(name) - kv0[name] for name in kv_names},
        "cached_tokens": sum(r.cached_tokens or 0 for r in records),
        "step_records": len(records),
        **({"answers": [r["choices"][0]["text"] for r in replies]} if replies else {}),
    }


def phase_serve(results: dict, kernel_modules: dict, phases: set) -> dict:
    import torch

    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.serving.sched import mixed as mixed_module

    t0 = time.perf_counter()
    engine, model_id = build_serving_engine("cuda", SERVE_ENV, seed=0)
    config = engine.generator.config
    if (config.num_layers, config.hidden_size, config.num_heads) != (22, 2048, 32):
        raise fail(f"not tinyllama-1.1b at full width: {config}")
    sched = engine.scheduler
    if sched._kvstore is None or sched._kvstore.host_pool is not None:
        raise fail("the default continuous engine has no prefix cache, or a host pool")
    engine.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
    http = HttpLoop(server)
    url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
    try:
        # one short request first so the timed drive is not a cold start
        _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
        # the cold drive: the prefix cache holds nothing of these prompts;
        # a request admitted after another finished its prefill can hit
        cold = timed_drive(url, sched, config, kernel_modules, "cold")
        launches = cold["launches"]
        stats = sched.stats()
        if "profile" in phases:
            sched.spill_cache()  # profile a cold drive, as before the cache
            results["profile"] = profile_drive(url, request_bodies())
        # a prompt over two splits long; the held step is the first whose
        # live rows reach past the prompt: a decode or verify step
        prompt = LOG_LINE * 5
        prompt_tokens = len(prompt.encode()) + 1
        if prompt_tokens != HIT_PROMPT_TOKENS:
            raise fail(f"the held prompt has {prompt_tokens} tokens")
        held = held_drive_calls(url, mixed_module, "ragged_paged_attention", HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
            config.num_layers, lambda dtype, _: TOL[dtype],
            select=lambda q, k, v, table, kv_len, q_count: (
                (kv_len * (q_count > 0)).max().item() > prompt_tokens),
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=k1_split_note,
        ), prompt)
        if held["splits_with_keys"] < 3:
            raise fail(f"the held K1 step's tile 0 had keys in {held['splits_with_keys']} splits, want >= 3")
        # the same prompt again, held on its FIRST prefill step: a cache
        # hit, 12 of its 13 pages store-owned, so 18 queries at kv_len 786
        hit_q = prompt_tokens - cached_tokens(prompt_tokens)
        saved0 = engine.generator.metrics.counter("kv_prefill_tokens_saved")
        held_hit = held_drive_calls(url, mixed_module, "ragged_paged_attention", HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
            config.num_layers, lambda dtype, _: TOL[dtype],
            select=lambda q, k, v, table, kv_len, q_count: bool(
                ((kv_len == prompt_tokens) & (q_count == hit_q)).any().item()),
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=lambda q, k, v, table, kv_len, q_count, sliding_window=None: {
                **k1_split_note(q, k, v, table, kv_len, q_count, sliding_window),
                "q_count": int(q_count.max().item()), "kv_len": int(kv_len.max().item()),
            },
        ), prompt)
        hit_saved = engine.generator.metrics.counter("kv_prefill_tokens_saved") - saved0
        if hit_saved != cached_tokens(prompt_tokens) or held_hit["q_count"] != hit_q:
            raise fail(f"the held hit request reused {hit_saved} tokens, first chunk "
                       f"{held_hit['q_count']} queries; want {cached_tokens(prompt_tokens)}, {hit_q}")
        # the warm drive: the same ten bodies; every full block but the
        # last of each prompt is cached
        warm = timed_drive(url, sched, config, kernel_modules, "warm")
        want_saved = sum(cached_tokens(n) for n in PROMPT_TOKENS)
        if warm["kv_economy"]["prefill_tokens_saved"] != want_saved:
            raise fail(f"warm drive saved {warm['kv_economy']['prefill_tokens_saved']} "
                       f"prefill tokens, the prompts give {want_saved}")
        if warm["cached_tokens"] != want_saved:
            raise fail(f"warm drive's step records carry {warm['cached_tokens']} cached "
                       f"tokens, want {want_saved}")
        admission = deadline_and_overload(engine, sched)
        spilled = sched.spill_cache()
        after_spill = balanced(sched, "after spill_cache()")
        if after_spill["store_pages"] != 0:
            raise fail(f"store pages left after spill_cache(): {after_spill}")
        summary = engine.generator.step_clock.summary()
        serve = {
            "model": model_id, "layers": config.num_layers, "weights": "int8",
            "slots": engine.generator.max_slots, "requests": len(PROMPT_CHARS),
            "prompt_chars": PROMPT_CHARS, "max_tokens": MAX_TOKENS,
            **{k: v for k, v in cold.items() if k not in ("kv_economy", "cached_tokens")},
            "cold_kv_economy": cold["kv_economy"], "cold_cached_tokens": cold["cached_tokens"],
            "warm": warm, "warm_saved_expected": want_saved,
            "setup_s": setup_s,
            "spec_decode": stats["spec_decode"],
            "decode_tokens_per_host_sync": stats["decode_tokens_per_host_sync"],
            "kv_economy": sched.stats()["kv_economy"],
            "spilled_blocks": spilled, "page_accounting_after_spill": after_spill,
            "admission": admission,
            "step_clock": {"peak_tflops": engine.generator.step_clock.peak_tflops,
                           "flops_per_token": engine.generator.step_clock.flops_per_token,
                           "summary": summary},
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "held_calls": held, "held_hit_calls": held_hit,
            # the replica's load report as the router reads it
            "healthz_load": healthz(server.bound_port)["load"],
        }
        print(json.dumps({"serve": serve}), flush=True)
        results["serve"] = serve
        return launches
    finally:
        http.stop()
        engine.close()


def deadline_and_overload(engine, sched) -> dict:
    """The deadline policy and the overload ladder on the full-width
    engine, through ``engine.submit`` (HTTP carries no deadline): a
    request whose budget fits fewer tokens than it asks finishes
    "deadline"; one whose deadline has passed fails with
    ``DeadlineExceeded``; with an ``OverloadPolicy`` and a queue limit on
    the scheduler and the generator (as the reference's pipeline wires
    them), a burst over the limit sheds and every request settles."""
    from operator_tpu_torch.router.value import OverloadPolicy, ValueModel
    from operator_tpu_torch.serving.types import DeadlineExceeded, SamplingParams, ShedLowValue

    g = engine.generator
    per_token = g.decode_token_estimate_s()
    if per_token <= 0:
        raise fail("no measured decode step time after the drives")
    clamped = engine.submit(LOG_LINE, SamplingParams(
        max_tokens=MAX_TOKENS, temperature=0.0, stop_on_eos=False,
        deadline=g._clock() + 6.5 * per_token,
    )).result(timeout=300)
    if clamped.finish_reason != "deadline" or not 1 <= clamped.completion_tokens < MAX_TOKENS:
        raise fail(f"a deadline fitting ~6 tokens gave {clamped.completion_tokens} tokens, "
                   f"finish {clamped.finish_reason!r}")
    try:
        engine.submit(LOG_LINE, SamplingParams(max_tokens=8, deadline=g._clock() - 1.0))
    except DeadlineExceeded:
        pass
    else:
        raise fail("an expired deadline was accepted")
    policy = OverloadPolicy(
        ValueModel({"interactive": 2.0, "standard": 30.0, "batch": 120.0}),
        shed_pressure=8.0, metrics=g.metrics,
    )
    sched.queue_limit, sched.overload_policy, g.overload_policy = 4, policy, policy
    counter = g.metrics.counter
    before = {name: counter(name) for name in ("sched_queue_evicted", "admission_shed")}
    classes = ["batch", "standard", "interactive", None]
    try:
        futures = [
            engine.submit(f"{LOG_LINE[:60]} burst {i}", SamplingParams(
                max_tokens=8, temperature=0.0, slo_class=classes[i % 4],
            ))
            for i in range(24)
        ]
        settled = {"ok": 0, "shed": 0, "degraded": 0}
        for future in futures:
            try:
                result = future.result(timeout=300)
            except ShedLowValue:
                settled["shed"] += 1
            else:
                settled["degraded" if result.finish_reason == "degraded" else "ok"] += 1
    finally:
        sched.queue_limit, sched.overload_policy, g.overload_policy = 0, None, None
    wait_idle(sched)
    sheds = {name: counter(name) - before[name] for name in before}
    if settled["shed"] == 0 or sum(sheds.values()) != settled["shed"]:
        raise fail(f"the burst over the queue limit: {settled}, counted sheds {sheds}")
    balanced(sched, "after the overload burst")
    out = {
        "decode_token_estimate_ms": per_token * 1e3,
        "deadline_tokens": clamped.completion_tokens,
        "burst": settled, "sheds": sheds, "decisions": len(policy.log.lines()),
    }
    print(json.dumps({"admission": out}), flush=True)
    return out


POOL_ENV = {**SERVE_ENV, "KV_HOST_POOL_MB": "256", "KV_PAGES": "49"}


def phase_serve_pool(results: dict, kernel_modules: dict) -> None:
    """The prefix cache's host-RAM tier at full width: a second engine
    with a 256 MB pinned pool and 48 KV pages.  The cold drive caches the
    ten prompts' block chain; a pressure drive of the same ten bodies with
    their first byte changed (a chain of its own) must evict those blocks
    at admission while steps are in flight, so their pages are gathered,
    copied to the pool on the side stream and put into it in commit
    windows; ``spill_cache()`` and one short request move the rest; the
    warm drive restores the first chain from the pool.  Fails unless
    blocks were offloaded in flight and restored, the pages balance, a
    restored page holds exactly the bytes gathered at its eviction, and
    no commit window's drain waited as long as half a step (a copy queued
    behind the in-flight step would)."""
    import torch

    from operator_tpu_torch.ops import kv_transfer
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine

    engine, model_id = build_serving_engine("cuda", POOL_ENV, seed=0)
    sched, g = engine.scheduler, engine.generator
    config = g.config
    pool = sched._kvstore.host_pool
    if pool is None or pool.capacity_bytes != 256 << 20:
        raise fail("KV_HOST_POOL_MB=256 did not give the store a 256 MB pool")
    drains: list = []  # (host ms waiting + putting, [gather->copy-done device ms], pages)
    restores: list = []  # (start, end) events around each restored page
    checked: dict = {}  # the block whose bytes are held: hash, gathered, equal
    fetch_host_ms: list = []  # host time of each fetch_page call (pinning included)
    original_drain, original_restore = sched._drain_offload, kv_transfer.restore_page
    original_fetch = kv_transfer.fetch_page
    original_evict, original_restore_block = sched._evict_blocks, sched._restore_block

    def timed_drain() -> None:
        fetches = [f for _, _, _, f in sched._pending_offload]
        t0 = time.perf_counter()
        original_drain()
        host_ms = (time.perf_counter() - t0) * 1e3
        drains.append((host_ms, [f.ready.elapsed_time(f.done) for f in fetches], len(fetches)))

    def timed_restore(paged, page, k, v):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original_restore(paged, page, k, v)
        end.record()
        restores.append((start, end))
        return out

    def timed_fetch(k_dev, v_dev):
        t0 = time.perf_counter()
        out = original_fetch(k_dev, v_dev)
        fetch_host_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def kept_evict(count: int) -> None:
        before = len(sched._pending_offload)
        original_evict(count)
        if "hash" not in checked and len(sched._pending_offload) > before:
            h, k_dev, v_dev, _ = sched._pending_offload[before]
            checked.update(hash=h, gathered=(k_dev.clone(), v_dev.clone()))

    def held_restore_block(blk) -> None:
        original_restore_block(blk)
        if blk.hash == checked.get("hash") and "equal" not in checked:
            checked["equal"] = (
                torch.equal(g.paged_cache.k_pages[:, blk.page], checked["gathered"][0])
                and torch.equal(g.paged_cache.v_pages[:, blk.page], checked["gathered"][1])
            )

    sched._drain_offload, sched._evict_blocks = timed_drain, kept_evict
    sched._restore_block = held_restore_block
    kv_transfer.restore_page, kv_transfer.fetch_page = timed_restore, timed_fetch
    engine.warmup()
    server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
    http = HttpLoop(server)
    url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
    try:
        _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
        cold = timed_drive(url, sched, config, kernel_modules, "pool cold")
        shifted = [{**body, "prompt": "#" + body["prompt"][1:]} for body in request_bodies()]
        pressure = timed_drive(url, sched, config, kernel_modules, "pool pressure", shifted)
        in_flight = list(drains)
        if not in_flight or pressure["kv_economy"]["offload"] == 0:
            raise fail(f"the pressure drive evicted nothing to the pool: {pressure['kv_economy']}")
        spilled = sched.spill_cache()
        _post(url, {"prompt": "drain the offloads", "max_tokens": 2, "temperature": 0.0})
        if not pool.has(checked["hash"]):
            raise fail("the checked block did not reach the host pool")
        restores.clear()
        warm = timed_drive(url, sched, config, kernel_modules, "pool warm")
        if warm["kv_economy"]["restore"] == 0 or "equal" not in checked:
            raise fail(f"the warm drive restored nothing from the pool: {warm['kv_economy']}")
        if not checked["equal"]:
            raise fail("a restored page's bytes differ from the bytes gathered at its eviction")
        step_ms = sorted(sched.device_ms)[len(sched.device_ms) // 2]
        waited = max(ms for ms, _, _ in in_flight)
        spans = [span for _, ss, _ in in_flight for span in ss]
        record = {
            "pool_mb": 256, "kv_pages": g.allocator.num_pages, "spilled_blocks": spilled,
            "cold": cold, "pressure": pressure, "warm": warm,
            "kv_economy": sched.stats()["kv_economy"],
            "pool_blocks": len(pool), "pool_bytes": pool.bytes_used,
            "drains_in_flight": len(in_flight),
            "drain_host_ms_in_flight": [ms for ms, _, _ in in_flight],
            "drain_pages_in_flight": [n for _, _, n in in_flight],
            "drain_host_ms_max": waited,
            "copy_span_ms_in_flight": [min(spans), max(spans)] if spans else None,
            "fetch_host_ms": [min(fetch_host_ms), max(fetch_host_ms), sum(fetch_host_ms)],
            "step_stream_ms_median": step_ms,
            "drain_waited_behind_a_step": waited >= step_ms / 2,
            "restore_ms_per_page": [s.elapsed_time(e) for s, e in restores],
            "restored_bytes_equal": checked["equal"],
        }
        print(json.dumps({"serve_pool": record}), flush=True)
        if record["drain_waited_behind_a_step"]:
            raise fail(f"a commit window's drain waited {waited} ms, a step is {step_ms} ms")
        results["serve_pool"] = record
    finally:
        http.stop()
        engine.close()
        sched._drain_offload, sched._evict_blocks = original_drain, original_evict
        sched._restore_block = original_restore_block
        kv_transfer.restore_page, kv_transfer.fetch_page = original_restore, original_fetch


WAVE_ENV = {
    **{k: v for k, v in SERVE_ENV.items() if not k.startswith(("SCHED_", "SPEC_"))},
    "SCHED_MODE": "wave",
    "DECODE_BLOCK": "4",
    "PIPELINE_DEPTH": "2",
    # the default template's shared prefix is the prefix phase's: the
    # wave phase's prompts share no template
    "PREFIX_CACHE": "false",
}


def phase_wave(results: dict, kernel_modules: dict, phases: set, selector: str) -> dict:
    """The wave path at full width through the HTTP server: flash prefill
    on, the decode-kernel selector at ``selector``, a new engine.  Returns
    the kernels' launch counts over this drive."""
    import torch

    from operator_tpu_torch.ops import flash_prefill as fp
    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine

    saved = {k: os.environ.get(k) for k in ("OPERATOR_TPU_FLASH_PREFILL", "OPERATOR_TPU_PAGED_KERNEL")}
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    os.environ["OPERATOR_TPU_PAGED_KERNEL"] = selector
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, model_id = build_serving_engine(
        "cuda", {**WAVE_ENV, "OPERATOR_TPU_PAGED_KERNEL": selector}, seed=0
    )
    g = engine.generator
    config = g.config
    try:
        if (config.num_layers, config.hidden_size, config.num_heads) != (22, 2048, 32):
            raise fail(f"not tinyllama-1.1b at full width: {config}")
        if engine.scheduler is not None or (g.decode_block, g.pipeline_depth) != (4, 2):
            raise fail("SCHED_MODE=wave did not build the wave engine (block 4, depth 2)")
        engine.warmup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
        http = HttpLoop(server)
        url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
        try:
            _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
            bodies = request_bodies()
            drive = wave_drive(g, kernel_modules, "wave",
                               lambda: (*drive_requests(url, bodies), None))
            launches, layers = drive["launches"], config.num_layers
            if "profile" in phases and selector == "v1":
                results["wave_profile"] = profile_drive(url, bodies)
            held = held_drive_calls(url, fp, "flash_prefill_attention", HeldToPlain(
                fp.flash_prefill_attention, fp.flash_prefill_reference, layers,
                prefill_drive_limit,
            ), LOG_LINE * 3)
            # a prompt over two splits long, held on its first decode step
            # (the first call whose longest row reaches past the prompt)
            prompt = LOG_LINE * 5
            prompt_tokens = len(prompt.encode()) + 1
            held_decode = held_drive_calls(url, pa, "paged_attention", HeldToPlain(
                pa.paged_attention, pa.paged_attention_reference, layers,
                lambda dtype, _: WAVE_TOL[dtype],
                select=lambda q, k, v, table, lengths: lengths.max().item() > prompt_tokens,
                note=k2_split_note,
            ), prompt)
            if held_decode["splits_with_keys"] < 3:
                raise fail(f"the held K2/K3 step's long row had keys in "
                           f"{held_decode['splits_with_keys']} splits, want >= 3")
            stall = wave_stall(engine, url, bodies, kernel_modules) if selector == "v1" else None
            load = healthz(server.bound_port)["load"]
        finally:
            http.stop()
        wave = {
            "model": model_id, "layers": layers, "weights": "int8",
            "slots": g.max_slots, "decode_block": g.decode_block,
            "pipeline_depth": g.pipeline_depth, "flash_prefill": True,
            "paged_kernel": selector, "requests": len(bodies),
            "prompt_chars": PROMPT_CHARS, "max_tokens": MAX_TOKENS,
            **{k: v for k, v in drive.items() if k != "answers"}, "setup_s": setup_s,
            "held_calls": held, "held_decode_calls": held_decode,
            "supervised_stall": stall,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "healthz_load": load,
        }
        print(json.dumps({"wave": wave}), flush=True)
        results["wave" if selector == "v1" else f"wave_{selector}"] = wave
        return launches
    finally:
        engine.close()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def wave_drive(g, kernel_modules: dict, where: str, drive) -> dict:
    """One counted drive of the wave engine ``g``: every count set to 0,
    ``drive()`` (-> completion tokens, wall seconds, the replies or None),
    the engine waited idle; then K4 once per layer per prefill wave, K2/K3
    once per layer per step of each block and no other kernel, and every
    page and slot free.  Returns the drive's record (``answers``: the
    replies' texts)."""
    for module in kernel_modules.values():
        module.launches = 0
    waves0, blocks0, ms0 = g.prefill_waves, g.blocks_dispatched, len(g.block_ms)
    completion, wall, replies = drive()
    wait_wave_idle(g)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    waves, blocks = g.prefill_waves - waves0, g.blocks_dispatched - blocks0
    block_ms = g.block_ms[ms0:]
    layers = g.config.num_layers
    want = {name: 0 for name in kernel_modules}
    want["flash_prefill_attention"] = layers * waves
    want["paged_decode_attention"] = layers * g.decode_block * blocks
    if waves == 0 or blocks == 0 or launches != want:
        raise fail(f"{where}: wave launches {launches} over {waves} prefill waves and "
                   f"{blocks} decode blocks; want {want}")
    free_pages = g.allocator.available
    if free_pages != g.allocator.num_pages - 1 or len(g.free_slots()) != g.max_slots:
        raise fail(f"{where}: pages or slots held after the drive: {free_pages} of "
                   f"{g.allocator.num_pages - 1} pages free, {len(g.free_slots())} of "
                   f"{g.max_slots} slots")
    return {
        "completion_tokens": completion, "wall_s": wall, "tokens_per_s": completion / wall,
        "prefill_waves": waves, "decode_blocks": blocks, "launches": launches,
        "stream_ms_per_block": sum(block_ms) / len(block_ms) if block_ms else None,
        "pages_free": free_pages,
        "answers": None if replies is None else [r["choices"][0]["text"] for r in replies]}


def wave_stall(engine, url: str, bodies: list, kernel_modules: dict) -> dict:
    """The wave loop supervised: the ten requests again with the engine's
    step sleeping past a tightened budget after four steps.  One restart,
    every request in flight requeued, the decode and prefill kernels
    launching again after it, every page and slot free at the end."""
    g = engine.generator
    for module in kernel_modules.values():
        module.launches = 0
    _, record = supervised_stall(engine, kernel_modules, lambda: drive_requests(url, bodies), 4,
                                 "wave", arrivals_continue=True)
    deadline = time.time() + 30
    while (g.num_active or g._inflight_blocks) and time.time() < deadline:
        time.sleep(0.05)
    after = {name: m.launches - record["launches_at_stall"][name]
             for name, m in kernel_modules.items()}
    record["launches_after_stall"] = after
    record["pages_free"] = g.allocator.available
    print(json.dumps({"wave_stall": record}), flush=True)
    if g.allocator.available != g.allocator.num_pages - 1 or len(g.free_slots()) != g.max_slots:
        raise fail(f"pages or slots held after the wave stall: {g.allocator.available} pages, "
                   f"{len(g.free_slots())} slots free")
    if not after["paged_decode_attention"] or not after["flash_prefill_attention"]:
        raise fail(f"the wave kernels did not launch after the restart: {after}")
    return record


def profile_drive(url: str, bodies: list) -> dict:
    """Drive the same requests again under ``torch.profiler`` (see
    :func:`profile_call`)."""
    def drive() -> None:
        threads = [threading.Thread(target=_post, args=(url, body)) for body in bodies]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(900)

    return profile_call(drive)


def device_times(events) -> list:
    """(name, device ms, count) of the profiler's device-side events
    (kernels, copies, memsets), largest first.  A host-side operator
    (``aten::mm``) also carries the device time of the kernels it
    launched, so only device-side events are counted: summing both
    would count each kernel twice."""
    from torch.autograd import DeviceType

    def device_us(event) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, name):
                return float(getattr(event, name))
        return 0.0

    rows = [(e.key, device_us(e) / 1e3, e.count) for e in events
            if e.device_type != DeviceType.CPU and device_us(e) > 0]
    return sorted(rows, key=lambda item: -item[1])


def profile_call(drive) -> dict:
    """Run ``drive()`` under ``torch.profiler``: device time by kernel,
    the device's busy share of the wall, and the host time of the
    heaviest operators.  Opt-in (``--phases ...,profile``): tracing slows
    the host, so no other number is taken in this drive."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3

    events = prof.key_averages()
    kernels = device_times(events)
    device_ms = sum(ms for _, ms, _ in kernels)
    host = sorted(
        ((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events),
        key=lambda item: -item[1],
    )
    out = {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "top_device": [{"name": k[:90], "ms": ms, "count": n} for k, ms, n in kernels[:15]],
        "top_host": [{"name": k[:90], "ms": ms, "count": n} for k, ms, n in host[:12]],
    }
    print(json.dumps({"profile": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# the guided phase: guided decoding and multi-LoRA on the wave engine
# ---------------------------------------------------------------------------

#: the guided phase's engine: the serve phase's settings with LORA_DIR,
#: SCHED_MODE left at its default (continuous): adapters fall back to the
#: wave engine (block 4, depth 2 by default)
GUIDED_SHAPE = (22, 2048, 32)  # tinyllama-1.1b: layers, hidden, query heads
GUIDED_CHOICES = ["CrashLoopBackOff", "OOMKilled", "ImagePullBackOff", "Error"]
GUIDED_REGEX = r"exit code [0-9]{1,3}"
#: the root cause a Podmortem user asks for (guided_json).  The summary
#: is capped at 32 characters: at 64 its DFA has 620 states, 19.8M table
#: entries at the 32,000 vocab, above the 16M cap both packages enforce
#: (the phase records that refusal)
ROOT_CAUSE_MAX_SUMMARY = 32
ROOT_CAUSE_SCHEMA = {
    "type": "object",
    "properties": {
        "reason": {"enum": GUIDED_CHOICES},
        "confidence": {"type": "integer"},
        "summary": {"type": "string", "maxLength": ROOT_CAUSE_MAX_SUMMARY},
    },
    "required": ["reason", "confidence", "summary"],
}
#: a root cause takes up to ~120 byte tokens (the summary 34); the JSON
#: rows are sampled (temperature 1.0), so the unbounded integer ends with
#: probability 1/11 a step rather than at a greedy argmax's whim
GUIDED_JSON_TOKENS = 192
LORA_RANK, LORA_ALPHA = 16, 16.0
#: b ~ N(0, 0.02): with a ~ N(0, 1/16) at hidden 2,048 the rank-16 delta
#: is about as large as the base projection's output (std ~1), so an
#: adapter moves greedy tokens without swamping the base model
LORA_B_STD = 0.02
#: an adapted bf16 projection (int8 ``mm``, its bf16 scale, the two
#: rank-16 products and the add, each rounded to bf16) against the f32
#: formula x @ (q * s) + (x @ A[idx] @ B[idx]) * alpha / r: |err| <=
#: LORA_ATOL + LORA_RTOL * (|x @ W| + |delta|), both terms in f32 — about
#: four bf16 roundings (2^-9 relative each) at the magnitude of the terms
#: (which the sum may cancel: the base product is rounded before the add)
LORA_ATOL, LORA_RTOL = 2e-2, 2e-2
#: the block-time drives: 32 rows, 64 tokens each, EOS not stopping them,
#: so every block of a drive carries all 32 rows
GUIDED_TIMED_TOKENS = 64


def write_lora_dir(path: str, config, seed: int, device: str = "cuda") -> dict:
    """``incident`` and ``verbose`` (rank 16, the default targets, a and b
    seeded, b nonzero), ``zero`` (all zeros) and ``truncated`` (the first
    half of incident's file), written by the port's ``save_lora``.  Returns
    each file's bytes."""
    import torch

    from operator_tpu_torch.parallel.lora import init_lora, save_lora, zero_lora

    os.makedirs(path, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name in ("incident", "verbose"):
        adapter = init_lora(config, gen, rank=LORA_RANK, device=device)
        for factors in adapter.values():
            factors["b"] = (torch.randn(factors["b"].shape, generator=gen, device=device)
                            * LORA_B_STD).to(torch.bfloat16)
        save_lora(adapter, os.path.join(path, f"{name}.safetensors"))
    save_lora(zero_lora(config, rank=LORA_RANK, device=device),
              os.path.join(path, "zero.safetensors"))
    with open(os.path.join(path, "incident.safetensors"), "rb") as fh:
        whole = fh.read()
    with open(os.path.join(path, "truncated.safetensors"), "wb") as fh:
        fh.write(whole[: len(whole) // 2])
    return {name: os.path.getsize(os.path.join(path, name))
            for name in sorted(os.listdir(path))}


class LogTap(logging.Handler):
    """Keeps the messages a logger emits while attached."""

    def __init__(self) -> None:
        super().__init__(logging.WARNING)
        self.messages: list = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def root_cause_ok(text: str) -> bool:
    """``text`` parses as JSON and satisfies ROOT_CAUSE_SCHEMA."""
    try:
        doc = json.loads(text)
    except ValueError:
        return False
    return (isinstance(doc, dict) and set(doc) == {"reason", "confidence", "summary"}
            and doc["reason"] in GUIDED_CHOICES
            and isinstance(doc["confidence"], int) and not isinstance(doc["confidence"], bool)
            and isinstance(doc["summary"], str)
            and len(doc["summary"]) <= ROOT_CAUSE_MAX_SUMMARY)


class LoraHeld:
    """Wraps ``models/llama.py:_proj``: for the first prefill pass and the
    first decode step that carry adapters, holds every adapted projection
    (22 layers x 4 targets each) to the f32 formula, row by row."""

    def __init__(self, fn, calls: int) -> None:
        self.fn, self.calls = fn, calls
        self.held: dict = {"prefill": [], "decode": []}

    def __call__(self, h_in, weights, name, lora=None):
        import torch

        y = self.fn(h_in, weights, name, lora)
        if lora is None or name not in lora[0]:
            return y
        kind = "decode" if h_in.shape[1] == 1 else "prefill"
        if len(self.held[kind]) >= self.calls:
            return y
        factors, alpha, idx = lora
        w = weights[name]
        w32 = w["q"].float() * w["s"].float()[None] if isinstance(w, dict) else w.float()
        x = h_in.float()
        a, b = factors[name]["a"].float(), factors[name]["b"].float()
        base = x @ w32
        delta = torch.bmm(torch.bmm(x, a[idx]), b[idx]) * (alpha / a.shape[-1])
        want = base + delta
        err = (y.float() - want).abs()
        excess = err - (LORA_ATOL + LORA_RTOL * (base.abs() + delta.abs()))
        self.held[kind].append({
            "name": name,
            "rows": idx.tolist(),
            "max_abs_err_by_row": err.amax(dim=(1, 2)).tolist(),
            "excess": excess.max().item(),
            "max_abs_f32": want.abs().max().item(),
            "max_abs_delta": delta.abs().max().item(),
            "finite": bool(torch.isfinite(y).all().item()),
        })
        return y


def guided_bodies(prompts: list) -> list:
    """(a)'s thirteen requests: base, incident and verbose on three
    prompts (the first greedy, the others sampled), the zero adapter on
    the first (greedy), a choice with ``incident``, a regex (both greedy)
    and a root cause (sampled)."""
    bodies = []
    for model in (None, "incident", "verbose"):
        for i in range(3):
            body = {"prompt": prompts[i], "max_tokens": MAX_TOKENS,
                    "temperature": 0.0 if i == 0 else 0.7, "top_p": 0.95}
            if model:
                body["model"] = model
            bodies.append(body)
    greedy = {"max_tokens": MAX_TOKENS, "temperature": 0.0}
    bodies.append({"prompt": prompts[0], "model": "zero", **greedy})
    bodies.append({"prompt": prompts[3], "model": "incident",
                   "guided_choice": GUIDED_CHOICES, **greedy})
    bodies.append({"prompt": prompts[4], "guided_regex": GUIDED_REGEX, **greedy})
    bodies.append({"prompt": prompts[5], "guided_json": ROOT_CAUSE_SCHEMA,
                   "max_tokens": GUIDED_JSON_TOKENS, "temperature": 1.0})
    return bodies


def post_status(url: str, body: dict) -> tuple:
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def guided_drive(engine, url: str, bodies: list) -> tuple:
    """Every body over HTTP at once, queued in order and admitted
    together (``held_sends``); each request's engine result is captured
    at ``submit``.  Returns (replies, results in body order, wall s)."""
    submit = engine.submit
    futures: list = []

    def recorded(prompt, params=None, **kw):
        future = submit(prompt, params, **kw)
        futures.append(future)
        return future

    engine.submit = recorded
    try:
        started = time.perf_counter()
        replies, _ = held_sends(engine, [
            (lambda b=body: _post(url, b)) for body in bodies])
        wall = time.perf_counter() - started
    finally:
        engine.submit = submit
    return replies, [f.result() for f in futures], wall


def replay_in_automaton(generator, spec: tuple, result) -> dict:
    """The row's tokens through its automaton's transition table from the
    start state: no step may leave it, and a row that stopped must end in
    an accepting state (EOS allowed)."""
    generator._ensure_automaton(spec)
    table = generator._guided_cache[spec].transition
    state, left = 0, None
    for step, token in enumerate(result.token_ids):
        state = int(table[state, token])
        if state < 0:
            left = step
            break
    eos = generator.tokenizer.eos_id
    accepting = state >= 0 and table[state, eos] >= 0
    return {"tokens": len(result.token_ids), "left_at": left,
            "accepting": bool(accepting), "finish_reason": result.finish_reason}


def timed_blocks(engine, config: str, sends: list) -> dict:
    """One held drive of 32 requests on the engine; the stream ms of each
    of its decode blocks (every block carries all 32 rows)."""
    g = engine.generator
    ms0, blocks0 = len(g.block_ms), g.blocks_dispatched
    held_sends(engine, sends)
    deadline = time.time() + 30
    while (g.num_active or g._inflight_blocks) and time.time() < deadline:
        time.sleep(0.01)
    block_ms = sorted(g.block_ms[ms0:])
    if not block_ms:
        raise fail(f"guided timing ({config}): no decode block was timed")
    return {"blocks": g.blocks_dispatched - blocks0, "median_ms": block_ms[len(block_ms) // 2],
            "mean_ms": sum(block_ms) / len(block_ms), "min_ms": block_ms[0],
            "max_ms": block_ms[-1]}


def phase_guided(results: dict, kernel_modules: dict, seed: int) -> dict:
    """Guided decoding and multi-LoRA on the wave engine at
    tinyllama-1.1b's full width (see the module doc).  Returns the
    kernels' launch counts over (a)'s and (c)'s drives."""
    import torch

    from operator_tpu_torch.models import llama
    from operator_tpu_torch.models.configs import get_config
    from operator_tpu_torch.parallel.lora import DEFAULT_TARGETS
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.json_schema import lower_guided_json
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.serving.types import SamplingParams, _bucket

    phase_t0 = time.perf_counter()
    saved = os.environ.get("OPERATOR_TPU_FLASH_PREFILL")
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_guided")
    shutil.rmtree(workdir, ignore_errors=True)
    lora_dir = os.path.join(workdir, "lora")
    out: dict = {"card": card_line(), "seed": seed}
    tap = LogTap()
    provider_log = logging.getLogger("operator_tpu_torch.serving.provider")
    engine = None
    try:
        out["lora_files"] = write_lora_dir(lora_dir, get_config("tinyllama-1.1b"), seed)
        t0 = time.perf_counter()
        provider_log.addHandler(tap)
        try:
            engine, model_id = build_serving_engine(
                "cuda", {**SERVE_ENV, "LORA_DIR": lora_dir, "PREFIX_CACHE": "false"},
                seed=seed)
        finally:
            provider_log.removeHandler(tap)
        g = engine.generator
        config = g.config
        if (config.num_layers, config.hidden_size, config.num_heads) != GUIDED_SHAPE:
            raise fail(f"guided: not tinyllama-1.1b at full width: {config}")
        if engine.scheduler is not None or (g.decode_block, g.pipeline_depth) != (4, 2):
            raise fail("guided: LORA_DIR under SCHED_MODE=continuous did not fall back "
                       "to the wave engine (block 4, depth 2)")
        if g.adapter_names != ["incident", "verbose", "zero"]:
            raise fail(f"guided: adapters {g.adapter_names}, want incident, verbose, zero")
        warned = [m for m in tap.messages if "truncated.safetensors unusable" in m]
        fell_back = [m for m in tap.messages if "falling back to the wave engine" in m]
        if not warned or not fell_back:
            raise fail(f"guided: warnings {tap.messages}")
        engine.warmup()
        torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t0

        # automaton builds on the host (a fresh cache) and their tables
        json_regex = lower_guided_json(ROOT_CAUSE_SCHEMA)
        specs = {"choice": ("choice", tuple(GUIDED_CHOICES)),
                 "regex": ("regex", GUIDED_REGEX), "json": ("regex", json_regex)}
        builds = {}
        for kind, spec in specs.items():
            t0 = time.perf_counter()
            g._ensure_automaton(spec)
            automaton = g._guided_cache[spec]
            builds[kind] = {"build_ms": (time.perf_counter() - t0) * 1e3,
                            "states": automaton.num_states,
                            "table_mib": automaton.transition.nbytes / 2**20}
        # the same schema with a 64-character summary: over the table cap
        wide = {**ROOT_CAUSE_SCHEMA, "properties": {
            **ROOT_CAUSE_SCHEMA["properties"], "summary": {"type": "string", "maxLength": 64}}}
        try:
            g._ensure_automaton(("regex", lower_guided_json(wide)))
        except ValueError as exc:
            builds["json_summary_64"] = {"refused": str(exc)}
        else:
            raise fail("guided: a 64-character summary's automaton was not refused")
        states = max(b.get("states", 0) for b in builds.values())
        a_pad = _bucket(len(specs) + 1, 2, 64)
        s_pad = _bucket(states, 8, g.MAX_GUIDED_STATES)
        out["automata"] = {"vocab": config.vocab_size, "specs": builds,
                           "stacked_mib": a_pad * s_pad * config.vocab_size * 4 / 2**20,
                           "stacked_shape": [a_pad, s_pad, config.vocab_size]}

        server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
        http = HttpLoop(server)
        base = f"http://127.0.0.1:{server.bound_port}"
        url = f"{base}/v1/completions"
        try:
            _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
            prompts = [b["prompt"] for b in request_bodies()]
            bodies = guided_bodies(prompts)

            # (a) the HTTP drive, held so its replay takes the same steps
            for module in kernel_modules.values():
                module.launches = 0
            waves0, blocks0 = g.prefill_waves, g.blocks_dispatched
            rng = g._rng.get_state()
            replies, res, wall = guided_drive(engine, url, bodies)
            launches_a = {name: m.launches for name, m in kernel_modules.items()}
            waves, blocks = g.prefill_waves - waves0, g.blocks_dispatched - blocks0
            deadline = time.time() + 30
            while (g.num_active or g._inflight_blocks) and time.time() < deadline:
                time.sleep(0.05)
            if g.allocator.available != g.allocator.num_pages - 1 or \
                    len(g.free_slots()) != g.max_slots:
                raise fail(f"guided: pages or slots held after (a): {g.allocator.available} "
                           f"of {g.allocator.num_pages - 1} pages, {len(g.free_slots())} slots")
            layers = config.num_layers
            want = {"flash_prefill_attention": layers * waves,
                    "paged_decode_attention": layers * g.decode_block * blocks,
                    "ragged_paged_attention": 0, "best_window_similarity": 0}
            if waves == 0 or blocks == 0 or launches_a != want:
                raise fail(f"guided (a): launches {launches_a} over {waves} prefill waves "
                           f"and {blocks} blocks; want {want}")
            texts = [r["choices"][0]["text"] for r in replies]
            completion = sum(r["usage"]["completion_tokens"] for r in replies)
            by_prompt = {(b.get("model"), b["prompt"]): r.token_ids
                         for b, r in zip(bodies, res) if b["temperature"] == 0.0}
            base0 = by_prompt[(None, prompts[0])]
            vacuous = [m for m in ("incident", "verbose") if by_prompt[(m, prompts[0])] == base0]
            if vacuous:
                raise fail(f"guided (a): greedy rows of {vacuous} equal the base row")
            if by_prompt[("zero", prompts[0])] != base0 or texts[9] != texts[0]:
                raise fail("guided (a): the zero adapter's greedy answer is not the base's")
            choice, regex, doc = texts[10], texts[11], texts[12]
            if choice not in GUIDED_CHOICES or not re.fullmatch(GUIDED_REGEX, regex) \
                    or not root_cause_ok(doc):
                raise fail(f"guided (a): choice {choice!r}, regex {regex!r}, json {doc!r}")
            replays = {kind: replay_in_automaton(g, spec, r) for kind, spec, r in (
                ("choice", specs["choice"], res[10]), ("regex", specs["regex"], res[11]),
                ("json", specs["json"], res[12]))}
            if any(r["left_at"] is not None or (r["finish_reason"] == "stop"
                                                and not r["accepting"])
                   for r in replays.values()):
                raise fail(f"guided (a): a row left its automaton: {replays}")
            # the same batch again from the same sampler state: the greedy
            # answers must be the drive's
            g._rng.set_state(rng)
            _, again, _ = guided_drive(engine, url, bodies)
            unequal = [i for i, (b, r0, r1) in enumerate(zip(bodies, res, again))
                       if b["temperature"] == 0.0 and r0.token_ids != r1.token_ids]
            if unequal:
                raise fail(f"guided (a): greedy answers differ from the replay at {unequal}")
            with urllib.request.urlopen(f"{base}/v1/models", timeout=60) as resp:
                models = json.loads(resp.read())
            listed = [m["id"] for m in models["data"]]
            if listed[:4] != [model_id, "incident", "verbose", "zero"]:
                raise fail(f"guided: /v1/models lists {listed}")
            unknown = post_status(url, {"prompt": "x", "model": "no-such-adapter"})
            json_object = post_status(url, {"prompt": "x",
                                            "response_format": {"type": "json_object"}})
            if unknown[0] != 404 or json_object[0] != 400:
                raise fail(f"guided: unknown model {unknown}, json_object {json_object}")
            out["a"] = {
                "requests": len(bodies), "completion_tokens": completion, "wall_s": wall,
                "tokens_per_s": completion / wall, "prefill_waves": waves,
                "decode_blocks": blocks, "launches": launches_a,
                "texts": {"choice": choice, "regex": regex, "json": doc},
                "replays": replays, "greedy_equal_replay": True,
                "models": listed, "unknown_model": unknown[0],
                "json_object": json_object[0],
                "pages_free": g.allocator.available,
            }
            wave = results.get("wave") or {}
            if wave.get("tokens_per_s"):
                out["a"]["tokens_per_s_vs_wave"] = out["a"]["tokens_per_s"] / wave["tokens_per_s"]
            print(json.dumps({"guided_a": out["a"], "card": out["card"]}), flush=True)

            # (b) the LoRA numerics on the card: one prefill wave and one
            # decode step of base, incident and verbose rows
            held = LoraHeld(llama._proj, layers * len(DEFAULT_TARGETS))
            llama._proj = held
            try:
                with eager_programs():
                    held_sends(engine, [(lambda m=m: _post(url, {
                        "prompt": prompts[2], "max_tokens": 4, "temperature": 0.0,
                        **({"model": m} if m else {})})) for m in (None, "incident", "verbose")])
            finally:
                llama._proj = held.fn
            record_b = {}
            for kind, calls in held.held.items():
                bad = [c for c in calls if not c["finite"] or not c["excess"] <= 0]
                if len(calls) != held.calls or bad:
                    raise fail(f"guided (b): {len(calls)} of {held.calls} {kind} projections "
                               f"held, outside tolerance: {bad[:3]}")
                rows = sorted({i for c in calls for i in c["rows"]})
                record_b[kind] = {
                    "projections": len(calls), "adapter_rows": rows,
                    "max_abs_err": max(max(c["max_abs_err_by_row"]) for c in calls),
                    "max_abs_f32": max(c["max_abs_f32"] for c in calls),
                    "max_abs_delta": max(c["max_abs_delta"] for c in calls),
                    "max_excess": max(c["excess"] for c in calls),
                }
                if not {1, 2} <= set(rows):
                    raise fail(f"guided (b): the held {kind} carried adapters {rows}")
            out["b"] = {"tolerance": {"atol": LORA_ATOL, "rtol": LORA_RTOL}, **record_b}
            print(json.dumps({"guided_b": out["b"], "card": out["card"]}), flush=True)

            # block times at 32 rows: plain without the LoRA pass (the
            # stack set aside), plain on the stack (adapter 0), every row
            # adapted, every row guided, and a quarter of each kind
            short = [(LOG_LINE * 2)[:48 + i] for i in range(g.max_slots)]

            def sends(kinds: list) -> list:
                def one(i: int, kind: str):
                    extra = {"plain": {}, "adapter": {"adapter": "incident"},
                             "guided": {"guided_regex": json_regex},
                             "both": {"adapter": "verbose", "guided_regex": json_regex}}[kind]
                    params = SamplingParams(max_tokens=GUIDED_TIMED_TOKENS, temperature=0.7,
                                            stop_on_eos=False, **extra)
                    return lambda: engine.submit(short[i], params).result(timeout=300)
                return [one(i, kind) for i, kind in enumerate(kinds)]

            n = g.max_slots
            times = {}
            stack = g.lora
            g.lora = None
            try:
                times["plain_no_lora_pass"] = timed_blocks(engine, "plain", sends(["plain"] * n))
            finally:
                g.lora = stack
            times["plain"] = timed_blocks(engine, "plain", sends(["plain"] * n))
            times["adapter"] = timed_blocks(engine, "adapter", sends(["adapter"] * n))
            times["guided"] = timed_blocks(engine, "guided", sends(["guided"] * n))
            times["mixed"] = timed_blocks(engine, "mixed", sends(
                ["plain", "adapter", "guided", "both"] * (n // 4)))
            ref = times["plain_no_lora_pass"]["median_ms"]
            out["block_ms"] = {"rows": n, "tokens": GUIDED_TIMED_TOKENS, **times,
                               "ratio_to_plain_no_lora_pass": {
                                   k: v["median_ms"] / ref for k, v in times.items()},
                               "guided_over_plain": times["guided"]["median_ms"]
                               / times["plain"]["median_ms"]}
            print(json.dumps({"guided_block_ms": out["block_ms"], "card": out["card"]}),
                  flush=True)
        finally:
            http.stop()

        # (c) the operator drive on the same engine
        launches_c = guided_operator(out, engine, model_id, kernel_modules, workdir, json_regex)
        out["phase_s"] = time.perf_counter() - phase_t0
        print(json.dumps({"guided": {k: out[k] for k in (
            "setup_s", "automata", "phase_s", "lora_files")}, "card": out["card"]}), flush=True)
        results["guided"] = out
        return {name: launches_a[name] + launches_c[name] for name in kernel_modules}
    finally:
        if engine is not None:
            engine.close()
        shutil.rmtree(workdir, ignore_errors=True)
        if saved is None:
            os.environ.pop("OPERATOR_TPU_FLASH_PREFILL", None)
        else:
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = saved


#: (c)'s pods per AIProvider
GUIDED_OPERATOR_PODS = 5


def guided_operator(out: dict, engine, model_id: str, kernel_modules: dict,
                    workdir: str, json_regex: str) -> dict:
    """(c): the port's ``Operator`` over ``FakeKubeApi`` with two
    ``tpu-native`` AIProviders on the guided engine, one asking for the
    incident adapter and a root-cause schema, one plain; five failing pods
    each.  Every stored explanation of the first parses to the schema, the
    providers' identity digests differ, K5 launches once per semantic
    ``analyze()`` (and per recall ``query()`` over a non-empty index), and
    the wave kernels as the drive's waves and blocks say.  Returns the
    kernels' launch counts over the drive."""
    import torch

    from operator_tpu_torch.models.encoder import MINILM_L6, init_encoder_params
    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.operator.storage import ANNOTATION_ANALYSIS
    from operator_tpu_torch.schema.crds import Podmortem
    from operator_tpu_torch.serving.provider import TPUNativeProvider
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    enc_dir = os.path.join(workdir, "encoder")
    write_encoder_checkpoint(init_encoder_params(
        MINILM_L6, torch.Generator(device="cuda").manual_seed(0), torch.float32,
        device="cuda"), enc_dir)
    env = {"MODEL_ID": model_id, "ENCODER_CHECKPOINT_DIR": enc_dir,
           "PATTERN_CACHE_DIRECTORY": os.path.join(workdir, "no-pattern-cache"),
           "HEALTH_PORT": "0", "HEALTH_HOST": "127.0.0.1"}
    config = OperatorConfig.from_env(env)
    operator = Operator(FakeKubeApi(), config=config, metrics=MetricsRegistry())
    provider = TPUNativeProvider(engine, model_id=model_id, register_template_prefixes=False)
    operator.providers.register("tpu-native", provider)
    api, semantic, index = operator.api, operator.engine.semantic, operator.memory.index
    if semantic is None:
        raise fail("guided (c): the operator did not mount the encoder checkpoint")
    g = engine.generator
    k5_calls = {"analyze": 0, "query": 0}
    match, query, generate = semantic.match, index.query, provider.generate
    exchanged: list = []

    def counted_match(lines):
        k5_calls["analyze"] += bool(lines) and semantic.num_patterns > 0
        return match(lines)

    def counted_query(text, k=3):
        k5_calls["query"] += len(index) > 0 and bool(text.strip())
        return query(text, k)

    async def captured(request):
        pair = [request, None]
        exchanged.append(pair)
        pair[1] = await generate(request)
        return pair[1]

    guided_spec = {"providerId": "tpu-native", "modelId": model_id,
                   "maxTokens": GUIDED_JSON_TOKENS, "temperature": 1.0}
    extra = {"lora_adapter": "incident", "guided_json": json.dumps(ROOT_CAUSE_SCHEMA)}
    providers = {
        "guided": {**guided_spec, "additionalConfig": extra},
        "plain": {"providerId": "tpu-native", "modelId": model_id,
                  "maxTokens": MAX_TOKENS, "temperature": 0.0},
        # the guided spec without its additionalConfig: named by no
        # Podmortem, resolved only for its identity digest
        "guided-bare": guided_spec,
    }
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))
    pods = [(f"payment-{i}", ("guided", "plain")[i % 2],
             "\n".join(fixture_lines(names[i % len(names)])))
            for i in range(2 * GUIDED_OPERATOR_PODS)]

    async def drive() -> dict:
        for name, spec in providers.items():
            await api.create("AIProvider", {"metadata": {"name": name, "namespace": "ops"},
                                            "spec": spec})
        for variant in ("guided", "plain"):
            await api.create("Podmortem", {
                "metadata": {"name": f"watch-{variant}", "namespace": "ops"},
                "spec": {"podSelector": {"matchLabels": {"app": "payment"},
                                         "matchExpressions": [{"key": "variant",
                                                               "operator": "In",
                                                               "values": [variant]}]},
                         "aiProviderRef": {"name": variant, "namespace": "ops"},
                         "aiAnalysisEnabled": True}})
        await operator.start()
        await asyncio.sleep(0.05)
        for module in kernel_modules.values():
            module.launches = 0
        waves0, blocks0 = g.prefill_waves, g.blocks_dispatched
        started = time.perf_counter()
        for i, (name, variant, log) in enumerate(pods):
            api.set_pod_log("prod", name, log, previous=True)
            await api.create("Pod", operator_pod(name, variant, f"2026-07-28T11:{i:02d}:00Z"))
            await api.patch("Pod", name, "prod", {"metadata": {"labels": {"poked": "1"}}})
        await asyncio.sleep(0.05)
        await operator.watcher.drain()
        wall = time.perf_counter() - started
        deadline = time.time() + 30
        while (g.num_active or g._inflight_blocks) and time.time() < deadline:
            await asyncio.sleep(0.05)
        launches = {name: m.launches for name, m in kernel_modules.items()}
        digests = {}
        for ref in ("guided", "plain", "guided-bare"):
            podmortem = Podmortem.parse({
                "metadata": {"name": f"probe-{ref}", "namespace": "ops"},
                "spec": {"aiProviderRef": {"name": ref, "namespace": "ops"}}})
            _, digests[ref] = await operator.pipeline._resolve_provider_identity(podmortem)
        pods_now = {p["metadata"]["name"]: p for p in await api.list("Pod", "prod")}
        failures = {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                    for f in (cr.get("status") or {}).get("recentFailures") or []}
        await operator.stop()
        return {"wall_s": wall, "launches": launches, "digests": digests,
                "pods": pods_now, "failures": failures,
                "waves": g.prefill_waves - waves0, "blocks": g.blocks_dispatched - blocks0}

    semantic.match, index.query, provider.generate = counted_match, counted_query, captured
    try:
        run = asyncio.run(drive())
    finally:
        semantic.match, index.query, provider.generate = match, query, generate
    stored, bad, unstored = {}, [], []
    for name, variant, _ in pods:
        annotation = (run["pods"][name]["metadata"].get("annotations") or {}).get(
            ANNOTATION_ANALYSIS)
        if annotation is None or name not in run["failures"]:
            unstored.append(name)
            continue
        if variant == "guided":
            stored[name] = annotation
            if not root_cause_ok(annotation):
                bad.append((name, annotation))
    responses = {r.failure_data.pod.metadata.name: a for r, a in exchanged}
    errors = {n: a.error for n, a in responses.items() if a.error}
    if unstored or bad or errors or not stored:
        raise fail(f"guided (c): unstored {unstored}, not the schema {bad}, errors {errors}")
    digests = run["digests"]
    if len(set(digests.values())) != 3:
        raise fail(f"guided (c): provider identity digests {digests}")
    launches, layers = run["launches"], g.config.num_layers
    k5_want = k5_calls["analyze"] + k5_calls["query"]
    want = {"ragged_paged_attention": 0, "best_window_similarity": k5_want,
            "flash_prefill_attention": layers * run["waves"],
            "paged_decode_attention": layers * g.decode_block * run["blocks"]}
    if launches != want or k5_calls["analyze"] != len(pods):
        raise fail(f"guided (c): launches {launches}, want {want}; K5 calls {k5_calls}")
    completion = sum(a.completion_tokens for a in responses.values())
    out["c"] = {"pods": len(pods), "wall_s": run["wall_s"], "launches": launches,
                "k5_calls": k5_calls, "digests": digests, "explanations": stored,
                "completion_tokens": completion,
                "tokens_per_s": completion / run["wall_s"],
                "provider_calls": len(responses)}
    print(json.dumps({"guided_c": out["c"], "card": out["card"]}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the semantic analysis path (MiniLM encoder + K5)
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
#: the long drive's log: enough lines for max_windows = 4,096 windows of 16
#: lines at stride 8 (32,776 lines), with the OOM signature at the tail
LONG_LOG_LINES = 33_000
RECALL_INCIDENTS = 2048
RECALL_QUERIES = [
    "java.lang.OutOfMemoryError: Java heap space",
    "Back-off restarting failed container app in pod web-7d9f8c",
    "dial tcp 10.0.0.12:5432: connect: connection refused",
    "x509: certificate has expired or is not yet valid",
]


def fixture_lines(name: str) -> list:
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        return fh.read().splitlines()


def crash_loop_log() -> str:
    """Every fixture log's lines, repeated, then ``oom_java.log`` whole."""
    body = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
            for line in fixture_lines(name)]
    tail = fixture_lines("oom_java.log")
    lines = [body[i % len(body)] for i in range(LONG_LOG_LINES - len(tail))] + tail
    return "\n".join(lines)


def byte_ids(text: str) -> list:
    """Token ids of the drives: the text's bytes (the real WordPiece
    tokenizer comes with the checkpoint loader)."""
    return list(text.encode())


class StreamSpans:
    """Records the stream span (CUDA events) of each call of ``fn``, and
    the call's arguments and result."""

    def __init__(self, fn):
        self.fn = fn
        self.calls: list = []

    def __call__(self, *args):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.calls.append((start, end, args, out))
        return out

    def spans_ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end, _, _ in self.calls]


class TimedEmbedder:
    """An embedder that records the stream span of each ``embed``."""

    def __init__(self, inner):
        self.inner = inner
        self.dim = inner.dim
        self.embed = StreamSpans(inner.embed)


def phase_analysis(results: dict, kernel_modules: dict, phases: set) -> dict:
    """``PatternEngine.analyze`` with the MiniLM encoder and K5 on the card
    (a long and a short log), then ``IncidentIndex.query``.  Returns the
    kernels' launch counts summed over the drives.  With ``profile`` in
    ``phases``, the long drive runs again under ``torch.profiler``."""
    import numpy as np
    import torch

    from operator_tpu_torch.memory import Incident, IncidentIndex
    from operator_tpu_torch.memory import index as index_module
    from operator_tpu_torch.models.encoder import MINILM_L6, init_encoder_params
    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher
    from operator_tpu_torch.schema.analysis import PodFailureData

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_encoder_params(MINILM_L6, torch.Generator(device="cuda").manual_seed(0),
                                 torch.float32, device="cuda")
    embedder = NeuralEmbedder(params, MINILM_L6, byte_ids, device="cuda")
    if (embedder.max_tokens, embedder.batch_size, embedder.dim) != (256, 32, 384):
        raise fail("not MiniLM-L6 at full width with buckets of 32 x 256")
    matcher = SemanticMatcher(embedder, device="cuda")
    engine = PatternEngine(semantic=matcher)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timed = TimedEmbedder(embedder)
    matcher.embedder = timed
    k5 = StreamSpans(semantic_module.best_window_scores)
    semantic_module.best_window_scores = k5
    index_module.best_window_scores = k5
    total = {name: 0 for name in kernel_modules}
    out: dict = {"model": MINILM_L6.name, "weights": "float32", "setup_s": setup_s,
                 "patterns": matcher.num_patterns}

    def counted(drive):
        for module in kernel_modules.values():
            module.launches = 0
        result = drive()
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for name, n in launches.items():
            total[name] += n
        return result, launches

    try:
        engine.analyze(PodFailureData(logs="\n".join(fixture_lines("oom_java.log"))))  # warm up
        for drive_name, logs in (("long", crash_loop_log()), ("short", "\n".join(
                fixture_lines("oom_java.log")))):
            embeds0, k50 = len(timed.embed.calls), len(k5.calls)
            started = time.perf_counter()
            result, launches = counted(lambda: engine.analyze(PodFailureData(logs=logs)))
            wall_ms = (time.perf_counter() - started) * 1e3
            lines = len(logs.splitlines())
            windows = min(matcher.max_windows, max(1, -(-(lines - matcher.window_lines) // matcher.stride) + 1))
            want = {name: 0 for name in kernel_modules}
            want["best_window_similarity"] = 1
            if launches != want:
                raise fail(f"analysis {drive_name}: launches {launches}, want {want}")
            [(_, _, (w_emb, p_emb), (scores, idx))] = k5.calls[k50:]
            err = check_similarity(w_emb, p_emb, scores, idx)
            events = [(e.source, e.matched_pattern.id, e.score) for e in result.events]
            ids = {pid for _, pid, _ in events}
            sane = all(np.isfinite(score) and (src != "semantic" or abs(score) <= 1.0 + SIM_TOL)
                       for src, _, score in events)
            if w_emb.shape != (windows, 384) or not err <= SIM_TOL or not sane:
                raise fail(f"analysis {drive_name}: windows {tuple(w_emb.shape)} (want {windows}), "
                           f"K5 error {err}, events {events}")
            if "java-heap-oom" not in ids:  # the OOM signature at the tail
                raise fail(f"analysis {drive_name}: the tail's OOM was not found: {events}")
            embed_spans = timed.embed.spans_ms()[embeds0:]
            record = {
                "log_lines": lines, "windows": windows, "buckets": -(-windows // 32),
                "wall_ms": wall_ms, "encoder_stream_ms": sum(embed_spans),
                "k5_stream_ms": k5.spans_ms()[k50], "k5_max_abs_err": err,
                "launches": launches, "events": len(events),
                "semantic_events": sum(1 for src, _, _ in events if src == "semantic"),
                "top_events": events[:5],
            }
            print(json.dumps({"analysis": {drive_name: record}}), flush=True)
            out[drive_name] = record
            if "profile" in phases and drive_name == "long":
                out["profile"] = profile_call(
                    lambda: engine.analyze(PodFailureData(logs=logs)))

        # incident recall: 2,048 incidents built from fixture lines
        lines = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
                 for line in fixture_lines(name)]
        incidents = [
            Incident(fingerprint=f"incident-{i:04d}", template=f"{lines[i % len(lines)]} #{i}",
                     pattern_ids=[f"p{i % 19}"], exit_code=i % 256)
            for i in range(RECALL_INCIDENTS)
        ]
        index = IncidentIndex(embedder, device="cuda")
        started = time.perf_counter()
        index.rebuild(incidents)
        torch.cuda.synchronize()
        rebuild_ms = (time.perf_counter() - started) * 1e3
        queries = RECALL_QUERIES + [IncidentIndex._incident_text(incidents[7])]
        k50 = len(k5.calls)
        started = time.perf_counter()
        answers, launches = counted(lambda: [index.query(text, k=3) for text in queries])
        query_ms = (time.perf_counter() - started) * 1e3 / len(queries)
        want = {name: 0 for name in kernel_modules}
        want["best_window_similarity"] = len(queries)
        if launches != want or any(len(a) != 3 for a in answers):
            raise fail(f"recall: launches {launches} (want {want}), answers {answers}")
        worst = max(check_similarity(*args, *res) for _, _, args, res in k5.calls[k50:])
        if not worst <= SIM_TOL or not answers[-1][0][1] >= 1.0 - SIM_TOL:
            raise fail(f"recall: K5 error {worst}, self-query {answers[-1]}")
        recall = {
            "incidents": RECALL_INCIDENTS, "queries": len(queries),
            "rebuild_ms": rebuild_ms, "query_wall_ms": query_ms,
            "k5_stream_ms": k5.spans_ms()[k50:], "k5_max_abs_err": worst,
            "launches": launches, "self_query_top": answers[-1][0],
        }
        print(json.dumps({"analysis": {"recall": recall}}), flush=True)
        out["recall"] = recall
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        results["analysis"] = out
        return total
    finally:
        semantic_module.best_window_scores = k5.fn
        index_module.best_window_scores = k5.fn


# ---------------------------------------------------------------------------
# phase 6: serve a checkpoint from disk (loader, tokenizers, provider)
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the committed SentencePiece-style tokenizer (1,405 ids) the LLM
#: checkpoint is written with
TOKENIZER_FIXTURE = os.path.join(ROOT, "tests", "torch_tokenizers", "llama_sp")
#: the provider drive: one request per fixture log, half greedy
CHECKPOINT_REQUESTS = 10
CHECKPOINT_ENV = {k: v for k, v in SERVE_ENV.items() if k != "ALLOW_RANDOM_WEIGHTS"}
#: all-MiniLM-L6-v2's HF config, the fields the loader reads
MINILM_CONFIG_JSON = {
    "model_type": "bert", "vocab_size": 30522, "hidden_size": 384,
    "intermediate_size": 1536, "num_hidden_layers": 6, "num_attention_heads": 12,
    "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
}


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def trees_equal(a, b) -> bool:
    """Byte-for-byte equality of two param trees."""
    import torch

    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(trees_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def provider_requests() -> list:
    """One ``AnalysisRequest`` per fixture log (the first ten by name):
    the regex analysis, the pod and its logs; even ones greedy."""
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.schema.analysis import (
        AIProviderConfig,
        AnalysisRequest,
        PodFailureData,
    )

    engine = PatternEngine()
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[:CHECKPOINT_REQUESTS]
    requests = []
    for i, name in enumerate(names):
        failure = PodFailureData.parse({
            "logs": "\n".join(fixture_lines(name)),
            "pod": {"metadata": {"name": name[:-4].replace("_", "-"), "namespace": "prod"}},
        })
        requests.append(AnalysisRequest(
            analysis_result=engine.analyze(failure), failure_data=failure,
            provider_config=AIProviderConfig(
                provider_id="tpu-native", max_tokens=MAX_TOKENS,
                temperature=0.0 if i % 2 == 0 else 0.7),
        ))
    return requests


def wordpiece_vocab(size: int = 30522) -> list:
    """A MiniLM-sized ``vocab.txt``, built deterministically from the
    fixture logs and the built-in patterns' embedding texts: the specials,
    every character, its ``##`` piece, the words by frequency (ties by
    spelling), then ``[unusedN]`` filler."""
    from operator_tpu_torch.patterns.loader import load_builtin_library
    from operator_tpu_torch.patterns.semantic import embedding_text

    texts = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
             for line in fixture_lines(name)]
    texts += [embedding_text(p) for p in load_builtin_library().patterns]
    lowered = [t.lower() for t in texts]
    chars = sorted({c for t in lowered for c in t if not c.isspace()})
    counts: dict = {}
    for text in lowered:
        for word in re.findall(r"[a-z0-9]+", text):
            counts[word] = counts.get(word, 0) + 1
    words = sorted(counts, key=lambda w: (-counts[w], w))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars + ["##" + c for c in chars]
    vocab = list(dict.fromkeys(vocab + words))
    return vocab + [f"[unused{i}]" for i in range(size - len(vocab))]


def gated_drive(provider, requests: list) -> list:
    """Every request through ``provider.generate`` at once, the engine's
    admission held until all are queued, so two engines driven this way
    take the same steps (a prefill chunk's split over K1's tiles, and so
    its rounding, follows the step's mix)."""
    import asyncio

    engine = provider.engine
    gate = threading.Lock()
    admit = engine._admit_submissions

    def gated(block: bool) -> None:
        with gate:
            admit(block)

    async def drive():
        with gate:
            # the worker's idle wait for a submission (50 ms) runs out, so
            # it reads the gated admission before the first one arrives
            # (else it takes the first requests ungated, and the rest wait
            # on a gate that waits for them)
            await asyncio.sleep(0.2)
            base = engine._submissions.qsize()
            tasks = [asyncio.ensure_future(provider.generate(r)) for r in requests]
            by = time.monotonic() + 120
            while (engine._submissions.qsize() < base + len(requests)
                   and not any(t.done() for t in tasks)):
                if time.monotonic() > by:
                    raise fail(f"gated drive: {engine._submissions.qsize() - base} of "
                               f"{len(requests)} requests queued in 120 s")
                await asyncio.sleep(0)
        return await asyncio.gather(*tasks)

    engine._admit_submissions = gated
    try:
        return asyncio.run(drive())
    finally:
        engine._admit_submissions = admit


def write_encoder_checkpoint(params, path: str) -> None:
    """The encoder tree under HF BERT names (projections back to
    ``[out, in]``), one f32 ``model.safetensors``, with ``config.json``,
    ``vocab.txt`` and a lower-casing ``tokenizer_config.json``."""
    from operator_tpu_torch.models import encoder
    from operator_tpu_torch.models.loader import write_safetensors

    tensors = {hf: params[ours].cpu() for hf, ours in encoder._BERT_TOP_MAP.items()}
    for sub, (ours, transpose) in encoder._BERT_LAYER_MAP.items():
        stacked = params["layers"][ours]
        stacked = (stacked.transpose(-1, -2) if transpose else stacked).contiguous().cpu()
        for i in range(stacked.shape[0]):
            tensors[f"encoder.layer.{i}.{sub}"] = stacked[i]
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(MINILM_CONFIG_JSON, fh)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(wordpiece_vocab()) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump({"do_lower_case": True, "tokenizer_class": "BertTokenizer"}, fh)


def phase_checkpoint(results: dict, kernel_modules: dict, keep: bool = False) -> tuple:
    """A tinyllama-1.1b checkpoint written at full width from the serve
    phase's seeded weights, loaded back with int8 weights through
    ``build_tpu_native_provider`` and driven with ten analysis requests;
    then a MiniLM-width encoder checkpoint through ``build_embedder`` and
    ``PatternEngine.analyze``.  Returns the kernels' launch counts summed
    over the provider drive and the long analysis, and the checkpoints'
    directories (``workdir``, ``llm``, ``encoder``); with ``keep`` the
    caller deletes ``workdir``, else it is gone already."""
    import asyncio
    import tempfile

    import torch

    from operator_tpu_torch.models.configs import get_config
    from operator_tpu_torch.models.encoder import MINILM_L6, init_encoder_params
    from operator_tpu_torch.models.llama import init_params
    from operator_tpu_torch.models.loader import save_params
    from operator_tpu_torch.models.quant import quantize_params
    from operator_tpu_torch.models.tokenizer import HFTokenizer
    from operator_tpu_torch.models.wordpiece import WordPieceTokenizer
    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher, build_embedder
    from operator_tpu_torch.schema.analysis import PodFailureData
    from operator_tpu_torch.serving import provider as provider_module
    from operator_tpu_torch.serving.sched import mixed as mixed_module

    config = get_config(SERVE_ENV["OPERATOR_TPU_MODEL"])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="checkpoint-", dir=os.path.join(ROOT, "build"))
    total = {name: 0 for name in kernel_modules}
    out: dict = {"card": card_line(), "model": config.name, "layers": config.num_layers}

    def counted(drive):
        for module in kernel_modules.values():
            module.launches = 0
        result = drive()
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for name, n in launches.items():
            total[name] += n
        return result, launches

    try:
        # 1. the LLM checkpoint: the serve phase's seeded tree, in bf16
        ckpt = os.path.join(workdir, "tinyllama")
        seeded = init_params(config, torch.Generator(device="cuda").manual_seed(0),
                             torch.bfloat16, device="cuda")
        if (config.num_layers, config.hidden_size, config.num_heads, config.num_kv_heads,
                config.vocab_size) != (22, 2048, 32, 4, 32000):
            raise fail(f"not tinyllama-1.1b at full width: {config}")
        torch.cuda.synchronize()
        started = time.perf_counter()
        files = save_params(seeded, ckpt, config, shard_bytes=1 << 30)
        write_s = time.perf_counter() - started
        for name in ("tokenizer.json", "tokenizer_config.json"):
            shutil.copy(os.path.join(TOKENIZER_FIXTURE, name), os.path.join(ckpt, name))
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
        want = quantize_params(seeded, config)
        del seeded
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        # 2. load and serve: the weight stream's handle is kept for its time
        handles = []
        stream = provider_module.load_params_async

        def recorded(*args, **kwargs):
            handles.append(stream(*args, **kwargs))
            return handles[-1]

        provider_module.load_params_async = recorded
        torch.cuda.reset_peak_memory_stats()
        memory0 = torch.cuda.memory_allocated()
        started = time.perf_counter()
        try:
            provider = provider_module.build_tpu_native_provider(
                "cuda", {**CHECKPOINT_ENV, "CHECKPOINT_DIR": ckpt})
        finally:
            provider_module.load_params_async = stream
        torch.cuda.synchronize()
        build_s = time.perf_counter() - started
        load_s = handles[0].seconds
        engine = provider.engine
        g = engine.generator
        out["checkpoint"] = {
            "files": len(files), "bytes": ckpt_bytes, "write_s": write_s,
            "write_gb_per_s": ckpt_bytes / write_s / 1e9, "load_s": load_s,
            "load_gb_per_s": ckpt_bytes / load_s / 1e9, "provider_build_s": build_s,
            "weights_gib": tree_bytes(g.params) / 2**30,
            "memory_after_load_gib": (torch.cuda.memory_allocated() - memory0) / 2**30,
            "peak_memory_during_load_gib": (torch.cuda.max_memory_allocated() - memory0) / 2**30,
        }
        print(json.dumps({"checkpoint": out["checkpoint"], "card": out["card"]}), flush=True)
        if not isinstance(g.tokenizer, HFTokenizer):
            raise fail(f"the checkpoint's tokenizer fell back to {type(g.tokenizer).__name__}")
        if not trees_equal(g.params, want):
            raise fail("the loaded int8 tree is not the seeded tree's quantize_params, byte for byte")
        del want

        # 3. the provider drive: ten requests at once, K1 counted
        sched = engine.scheduler
        requests = provider_requests()
        engine.warmup()
        asyncio.run(provider.generate(requests[0]))  # not a cold start
        steps0, dev0 = sched.steps, len(sched.device_ms)
        started = time.perf_counter()
        responses, launches = counted(lambda: gated_drive(provider, requests))
        wall = time.perf_counter() - started
        steps = sched.steps - steps0
        wait_idle(sched)
        stream_ms = sched.device_ms[dev0:]
        accounting = balanced(sched, "after the provider drive")
        bad = [r.to_dict() for r in responses if r.error or not r.completion_tokens]
        if bad:
            raise fail(f"provider responses without an explanation: {bad}")
        if launches["ragged_paged_attention"] != config.num_layers * steps or steps == 0:
            raise fail(f"provider drive: ragged kernel launched {launches} over {steps} steps")
        if any(n for k, n in launches.items() if k != "ragged_paged_attention"):
            raise fail(f"other kernels launched on the provider drive: {launches}")
        completion = sum(r.completion_tokens for r in responses)
        # K1 held to its plain version on one more request's first 22 calls
        held = HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
            config.num_layers, lambda dtype, _: TOL[dtype],
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=k1_split_note,
        )
        mixed_module.ragged_paged_attention = held
        try:
            with eager_programs():
                asyncio.run(provider.generate(requests[1]))
        finally:
            mixed_module.ragged_paged_attention = held.fn
        bad_held = [c for c in held.held if not c["finite"] or not c["excess"] <= 0]
        if len(held.held) != config.num_layers or bad_held:
            raise fail(f"provider drive: {len(held.held)} K1 calls held, outside tolerance: {bad_held}")
        tokenizer = g.tokenizer
        engine.close()

        # the same drive on an engine built in memory from the same seeded
        # tree (the serve phase's), with the checkpoint's tokenizer: the
        # greedy half must give the same tokens
        reference, model_id = provider_module.build_serving_engine("cuda", SERVE_ENV, seed=0)
        reference.generator.tokenizer = tokenizer
        in_memory = provider_module.TPUNativeProvider(reference, model_id=model_id)
        try:
            reference.warmup()
            asyncio.run(in_memory.generate(requests[0]))
            want_responses = gated_drive(in_memory, requests)
        finally:
            reference.close()
        greedy = [i for i, r in enumerate(requests) if r.provider_config.temperature == 0.0]
        mismatched = [i for i in greedy
                      if responses[i].to_dict() != want_responses[i].to_dict()]
        if mismatched:
            raise fail(f"greedy requests {mismatched} differ from the in-memory engine's: "
                       f"{[responses[i].to_dict() for i in mismatched]} != "
                       f"{[want_responses[i].to_dict() for i in mismatched]}")
        out["provider"] = {
            "requests": len(requests), "greedy": len(greedy), "max_tokens": MAX_TOKENS,
            "prompt_tokens": [r.prompt_tokens for r in responses],
            "completion_tokens": completion, "wall_s": wall, "tokens_per_s": completion / wall,
            "steps": steps, "launches": launches, "page_accounting": accounting,
            "stream_ms_per_step": sum(stream_ms) / len(stream_ms) if stream_ms else None,
            "held_k1_calls": len(held.held),
            "held_k1_max_abs_err": max(c["max_abs_err"] for c in held.held),
            "held_k1_splits_with_keys": max(c["splits_with_keys"] for c in held.held),
            "greedy_equal_in_memory": True,
            "sampled_equal_in_memory": all(
                a.to_dict() == b.to_dict() for a, b in zip(responses, want_responses)),
        }
        print(json.dumps({"checkpoint_provider": out["provider"], "card": out["card"]}), flush=True)
        torch.cuda.empty_cache()

        # 4. the encoder checkpoint at all-MiniLM-L6-v2's width
        enc_dir = os.path.join(workdir, "minilm")
        enc_params = init_encoder_params(MINILM_L6, torch.Generator(device="cuda").manual_seed(0),
                                         torch.float32, device="cuda")
        write_encoder_checkpoint(enc_params, enc_dir)
        started = time.perf_counter()
        loaded = build_embedder(enc_dir, device="cuda")
        torch.cuda.synchronize()
        embedder_build_s = time.perf_counter() - started
        if not isinstance(loaded, NeuralEmbedder):
            raise fail(f"build_embedder fell back to {type(loaded).__name__}")
        if loaded.dim != 384 or not trees_equal(loaded.params, enc_params):
            raise fail("the loaded encoder is not the seeded MiniLM-width tree")
        wordpiece = WordPieceTokenizer.from_dir(enc_dir)
        in_memory = NeuralEmbedder(enc_params, MINILM_L6, wordpiece.encode, device="cuda")
        logs = crash_loop_log()
        runs = {}
        for name, emb in (("loaded", loaded), ("in_memory", in_memory)):
            matcher = SemanticMatcher(emb, device="cuda")
            engine_ = PatternEngine(semantic=matcher)
            engine_.analyze(PodFailureData(logs="\n".join(fixture_lines("oom_java.log"))))
            timed = TimedEmbedder(emb)
            matcher.embedder = timed
            k5 = StreamSpans(semantic_module.best_window_scores)
            semantic_module.best_window_scores = k5
            try:
                started = time.perf_counter()
                result, launches_a = counted(lambda: engine_.analyze(PodFailureData(logs=logs)))
                wall_ms = (time.perf_counter() - started) * 1e3
            finally:
                semantic_module.best_window_scores = k5.fn
            [(_, _, (w_emb, p_emb), (scores, idx))] = k5.calls
            runs[name] = {
                "events": [(e.source, e.matched_pattern.id, e.context.line_number, e.score)
                           for e in result.events],
                "launches": launches_a, "wall_ms": wall_ms,
                "encoder_stream_ms": sum(timed.embed.spans_ms()),
                "k5_stream_ms": k5.spans_ms()[0],
                "k5_max_abs_err": check_similarity(w_emb, p_emb, scores, idx),
                "windows": int(w_emb.shape[0]),
            }
        want_launch = {name: 0 for name in kernel_modules}
        want_launch["best_window_similarity"] = 1
        got = runs["loaded"]
        if got["launches"] != want_launch or not got["k5_max_abs_err"] <= SIM_TOL:
            raise fail(f"checkpoint analysis: launches {got['launches']}, K5 error {got['k5_max_abs_err']}")
        if got["events"] != runs["in_memory"]["events"]:
            raise fail(f"the loaded encoder's events {got['events']} differ from the "
                       f"in-memory encoder's {runs['in_memory']['events']}")
        # the in-memory run's counts are a comparison, not the path's
        for name, n in runs["in_memory"]["launches"].items():
            total[name] -= n
        out["analysis"] = {
            "embedder_build_s": embedder_build_s, "log_lines": LONG_LOG_LINES,
            "vocab": len(wordpiece.vocab), **{k: v for k, v in got.items() if k != "events"},
            "events": len(got["events"]),
            "semantic_events": sum(1 for src, *_ in got["events"] if src == "semantic"),
            "top_events": got["events"][:5],
            "in_memory_wall_ms": runs["in_memory"]["wall_ms"],
        }
        print(json.dumps({"checkpoint_analysis": out["analysis"], "card": out["card"]}), flush=True)
        results["checkpoint"] = out
        return total, {"workdir": workdir, "llm": ckpt, "encoder": enc_dir}
    except BaseException:
        keep = False
        raise
    finally:
        if not keep:
            shutil.rmtree(workdir, ignore_errors=True)


#: the tokenizer families' committed fixtures: the files of each and
#: ``AutoTokenizer``'s ids for a fixed list of prompts (``expected_ids.json``)
UNIGRAM_FIXTURE = os.path.join(ROOT, "tests", "torch_tokenizers", "xlmr_unigram")
LOGS_FIXTURE = os.path.join(ROOT, "tests", "torch_tokenizers", "onig_logs")
SCRIPTS_FIXTURE = os.path.join(ROOT, "tests", "torch_tokenizers", "xlmr_scripts")
WORDPIECE_FIXTURE = os.path.join(ROOT, "tests", "torch_tokenizers", "minilm_wordpiece")
#: the files a checkpoint's tokenizer is read from
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json",
                   "vocab.txt", "tokenizer.model")
#: encodes of each text behind a host time per prompt
ENCODE_REPEATS = 20
#: the tokenizers phase's device and the engine's environment (a CPU
#: rehearsal sets a tiny model and ``cpu``)
TOKENIZERS_DEVICE = "cuda"
TOKENIZERS_ENV = CHECKPOINT_ENV


def linked_checkpoint(source: str, directory: str, files: dict) -> str:
    """``directory`` with ``source``'s weights and configs linked (not
    written again) and its tokenizer given by ``files`` (name -> text)."""
    os.makedirs(directory)
    for name in os.listdir(source):
        if name not in TOKENIZER_FILES:
            os.symlink(os.path.join(source, name), os.path.join(directory, name))
    for name, text in files.items():
        with open(os.path.join(directory, name), "w", encoding="utf-8") as fh:
            fh.write(text)
    return directory


def fixture_file(fixture: str, name: str) -> str:
    with open(os.path.join(fixture, name), encoding="utf-8") as fh:
        return fh.read()


def wordpiece_tokenizer_json(vocab: list) -> str:
    """The WordPiece fixture's ``tokenizer.json`` (all-MiniLM-L6-v2's
    layout) over ``vocab``: its specials and template at their ids there."""
    spec = json.loads(fixture_file(WORDPIECE_FIXTURE, "tokenizer.json"))
    ids = {token: i for i, token in enumerate(vocab)}
    spec["model"]["vocab"] = ids
    spec["added_tokens"] = [{**t, "id": ids[t["content"]]} for t in spec["added_tokens"]]
    for name, entry in spec["post_processor"]["special_tokens"].items():
        entry["ids"] = [ids[name]]
    return json.dumps(spec, ensure_ascii=False)


def encode_us(encode, texts: list) -> float:
    """Host microseconds per text of ``encode``, over ``ENCODE_REPEATS``
    passes."""
    started = time.perf_counter()
    for _ in range(ENCODE_REPEATS):
        for text in texts:
            encode(text)
    return (time.perf_counter() - started) * 1e6 / (ENCODE_REPEATS * len(texts))


def phase_tokenizers(results: dict, kernel_modules: dict, dirs: dict) -> dict:
    """The checkpoint phase's weights behind the Unigram and WordPiece
    ``tokenizer.json`` families (module docstring, 8b).  Returns the
    kernels' launch counts over the serve drives (a) and (c) and the
    ``tokenizer.json`` encoder's analysis (b)."""
    import gc

    import torch

    total = {name: 0 for name in kernel_modules}

    def counted(drive):
        for module in kernel_modules.values():
            module.launches = 0
        result = drive()
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for name, n in launches.items():
            total[name] += n
        return result, launches

    out = results["tokenizers"] = {"card": card_line()}
    out["unigram"] = tokenizers_served(dirs, counted, UNIGRAM_FIXTURE, "a", "Unigram")
    print(json.dumps({"tokenizers_unigram": out["unigram"], "card": out["card"]}), flush=True)
    out["scripts"] = tokenizers_served(dirs, counted, SCRIPTS_FIXTURE, "c", "Unigram")
    print(json.dumps({"tokenizers_scripts": out["scripts"], "card": out["card"]}), flush=True)
    out["logs"] = tokenizers_served(dirs, counted, LOGS_FIXTURE, "d", "BPE")
    print(json.dumps({"tokenizers_logs": out["logs"], "card": out["card"]}), flush=True)
    by_engine: dict = {}
    for name in ("unigram", "scripts", "logs"):
        for engine_name in out[name]["expression_engines"]:
            by_engine.setdefault(engine_name, {})[name] = out[name]["encode_us_per_prompt"]
    print(json.dumps({"tokenizers_encode_us_by_engine": by_engine, "card": out["card"]}),
          flush=True)
    out["wordpiece"], comparison = tokenizers_wordpiece(dirs, counted, list(kernel_modules))
    # the vocab.txt checkpoint's run is the comparison, not the path
    for name, n in comparison.items():
        total[name] -= n
    print(json.dumps({"tokenizers_wordpiece": out["wordpiece"], "card": out["card"]}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return total


def fixture_expressions(fixture: str) -> list:
    """Every ``Regex`` pattern of the fixture's ``tokenizer.json``."""
    found: list = []

    def walk(spec):
        if isinstance(spec, dict):
            pattern = spec.get("pattern")
            if isinstance(pattern, dict) and "Regex" in pattern:
                found.append(pattern["Regex"])
            for value in spec.values():
                walk(value)
        elif isinstance(spec, list):
            for value in spec:
                walk(value)

    walk(json.loads(fixture_file(fixture, "tokenizer.json")))
    return found


def tokenizers_served(dirs: dict, counted, fixture: str, part: str, model: str) -> dict:
    """(a), (c) and (d): tinyllama-1.1b with a fixture's tokenizer
    (``fixture``, its model a ``model``), served; ``part`` names the drive
    in messages.  Where ``expected_ids.json`` marks a prompt on which the
    library gives up, the tokenizer must raise ``RetryLimitError`` on it."""
    import torch

    from operator_tpu_torch.models.configs import get_config
    from operator_tpu_torch.models.tokenization.onig import compile_expression
    from operator_tpu_torch.models.tokenization.onig_match import RetryLimitError
    from operator_tpu_torch.models.tokenizer import HFTokenizer
    from operator_tpu_torch.serving import provider as provider_module
    from operator_tpu_torch.serving.types import SamplingParams

    config = get_config(TOKENIZERS_ENV["OPERATOR_TPU_MODEL"])
    expected = json.loads(fixture_file(fixture, "expected_ids.json"))
    directory = os.path.join(dirs["workdir"], f"tinyllama-{os.path.basename(fixture)}")
    llm = linked_checkpoint(dirs["llm"], directory, {
        name: fixture_file(fixture, name)
        for name in ("tokenizer.json", "tokenizer_config.json")})
    started = time.perf_counter()
    engine, _ = provider_module.build_serving_engine(
        TOKENIZERS_DEVICE, {**TOKENIZERS_ENV, "CHECKPOINT_DIR": llm})
    try:
        g, sched = engine.generator, engine.scheduler
        tok = g.tokenizer
        if type(tok) is not HFTokenizer or type(tok._model).__name__ != model:
            raise fail(f"tokenizers ({part}): the engine's tokenizer is {type(tok).__name__} "
                       f"({type(getattr(tok, '_model', None)).__name__}), not the {model} "
                       "family")
        specials = {"bos_id": tok.bos_id, "eos_id": tok.eos_id, "vocab_size": tok.vocab_size}
        if specials != {k: expected[k] for k in specials}:
            raise fail(f"tokenizers ({part}): special ids {specials} are not AutoTokenizer's")
        got = [tok.encode(p, add_bos=False) for p in expected["prompts"]]
        if got != expected["ids"]:
            bad = [p for p, a, b in zip(expected["prompts"], got, expected["ids"]) if a != b]
            raise fail(f"tokenizers ({part}): ids differ from AutoTokenizer's on {bad}")
        encode_time = encode_us(tok.encode, expected["prompts"])
        gives_up_s = None
        if "gives_up" in expected:
            gives_up_started = time.perf_counter()
            try:
                tok.encode(expected["gives_up"])
            except RetryLimitError:
                gives_up_s = time.perf_counter() - gives_up_started
            else:
                raise fail(f"tokenizers ({part}): the prompt the library gives up on was "
                           "encoded, not given up")
        engine.warmup()
        # the ids the engine reads for each served prompt
        seen: dict = {}
        encode = tok.encode

        def recorded(text, **kwargs):
            seen[text] = encode(text, **kwargs)
            return seen[text]

        prompts = [p for p in expected["prompts"] if p]
        tok.encode = recorded
        try:
            steps0 = sched.steps
            served, launches = counted(lambda: engine.generate_batch(
                prompts, SamplingParams(max_tokens=8, temperature=0.0)))
            steps = sched.steps - steps0
        finally:
            del tok.encode
        wait_idle(sched)
        want = {p: [tok.bos_id, *ids] for p, ids in zip(expected["prompts"], expected["ids"]) if p}
        if {p: seen.get(p) for p in want} != want:
            raise fail(f"tokenizers ({part}): the served ids differ from expected_ids.json on "
                       f"{[p for p in want if seen.get(p) != want[p]]}")
        if [r.prompt_tokens for r in served] != [len(want[p]) for p in prompts]:
            raise fail(f"tokenizers ({part}): prompt tokens {[r.prompt_tokens for r in served]}")
        if any(r.completion_tokens < 1 for r in served):
            raise fail(f"tokenizers ({part}): a request without a token: {served}")
        if steps == 0 or launches["ragged_paged_attention"] != config.num_layers * steps:
            raise fail(f"tokenizers ({part}): ragged kernel launched {launches} over {steps} "
                       "steps")
        if any(n for k, n in launches.items() if k != "ragged_paged_attention"):
            raise fail(f"tokenizers ({part}): other kernels launched: {launches}")
        return {
            "fixture": os.path.relpath(fixture, ROOT), "model": config.name,
            "layers": config.num_layers, "vocab_size": tok.vocab_size, "prompts": len(prompts),
            "prompt_tokens": [r.prompt_tokens for r in served],
            "completion_tokens": sum(r.completion_tokens for r in served), "steps": steps,
            "launches": launches, "encode_us_per_prompt": encode_time,
            "expression_engines": sorted({compile_expression(p).engine
                                          for p in fixture_expressions(fixture)}),
            "gives_up_s": gives_up_s, "wall_s": time.perf_counter() - started,
        }
    finally:
        engine.close()
        if TOKENIZERS_DEVICE == "cuda":
            torch.cuda.empty_cache()


def wordpiece_fixture_ids(workdir: str) -> dict:
    """The WordPiece fixture's prompts (the texts where Python's Unicode
    data and the library's differ among them) through the encoder's
    tokenizer as ``NeuralEmbedder.from_checkpoint`` reads it, from the
    fixture's ``tokenizer.json`` and from a ``vocab.txt`` of its vocabulary:
    both must give ``expected_ids.json``'s ``AutoTokenizer`` ids."""
    from operator_tpu_torch.models.tokenizer import HFTokenizer
    from operator_tpu_torch.models.wordpiece import WordPieceTokenizer

    expected = json.loads(fixture_file(WORDPIECE_FIXTURE, "expected_ids.json"))
    vocab = json.loads(fixture_file(WORDPIECE_FIXTURE, "tokenizer.json"))["model"]["vocab"]
    directory = os.path.join(workdir, "minilm-fixture-vocab")
    os.makedirs(directory)
    with open(os.path.join(directory, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
        fh.write(fixture_file(WORDPIECE_FIXTURE, "tokenizer_config.json"))
    wordpiece = WordPieceTokenizer.from_dir(directory)
    encoders = {"tokenizer_json": HFTokenizer(WORDPIECE_FIXTURE).encode_with_special_tokens,
                "vocab_txt": lambda text: wordpiece.encode(text, add_special_tokens=True)}
    prompts, want = expected["prompts"], expected["ids_with_special_tokens"]
    for name, encode in encoders.items():
        got = [encode(p) for p in prompts]
        if got != want:
            bad = [p for p, a, b in zip(prompts, got, want) if a != b]
            raise fail(f"tokenizers (b): the {name} encoder's ids differ from expected_ids.json "
                       f"on {bad[:3]}")
    unicode_prompts = [p for p in prompts if not p.isascii()]
    return {"prompts": len(prompts), "ids_equal_expected": True,
            "non_ascii_prompts": len(unicode_prompts),
            "non_ascii_encode_us_per_prompt": {name: encode_us(encode, unicode_prompts)
                                             for name, encode in encoders.items()}}


def tokenizers_wordpiece(dirs: dict, counted, kernels: list) -> tuple:
    """(b): the encoder with ``tokenizer.json`` and no ``vocab.txt``
    against the ``vocab.txt`` checkpoint of the same weights, and the
    fixture's own vocabulary held to ``AutoTokenizer``'s ids
    (:func:`wordpiece_fixture_ids`); returns the record and the comparison
    run's launch counts."""
    import torch

    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher, build_embedder
    from operator_tpu_torch.schema.analysis import PodFailureData

    started = time.perf_counter()
    fixture_ids = wordpiece_fixture_ids(dirs["workdir"])
    vocab = wordpiece_vocab()
    enc_json = linked_checkpoint(dirs["encoder"], os.path.join(dirs["workdir"], "minilm-json"), {
        "tokenizer.json": wordpiece_tokenizer_json(vocab),
        "tokenizer_config.json": fixture_file(WORDPIECE_FIXTURE, "tokenizer_config.json")})
    embedders = {"tokenizer_json": build_embedder(enc_json, device=TOKENIZERS_DEVICE),
                 "vocab_txt": build_embedder(dirs["encoder"], device=TOKENIZERS_DEVICE)}
    for name, embedder in embedders.items():
        if not isinstance(embedder, NeuralEmbedder):
            raise fail(f"tokenizers (b): build_embedder fell back to {type(embedder).__name__} "
                       f"on the {name} checkpoint")
    texts = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
             for line in fixture_lines(name)]
    ids = {name: [e.tokenize(t) for t in texts] for name, e in embedders.items()}
    if ids["tokenizer_json"] != ids["vocab_txt"]:
        bad = [t for t, a, b in zip(texts, ids["tokenizer_json"], ids["vocab_txt"]) if a != b]
        raise fail(f"tokenizers (b): tokenizer.json ids differ from vocab.txt's on {bad[:3]}")
    encode_times = {name: encode_us(e.tokenize, texts) for name, e in embedders.items()}
    log = "\n".join(texts)
    runs = {}
    for name, embedder in embedders.items():
        engine_ = PatternEngine(semantic=SemanticMatcher(embedder, device=TOKENIZERS_DEVICE))
        engine_.analyze(PodFailureData(logs="\n".join(fixture_lines("oom_java.log"))))
        k5 = StreamSpans(semantic_module.best_window_scores)
        semantic_module.best_window_scores = k5
        try:
            result, launches = counted(lambda: engine_.analyze(PodFailureData(logs=log)))
        finally:
            semantic_module.best_window_scores = k5.fn
        [(_, _, (w_emb, p_emb), (scores, idx))] = k5.calls
        runs[name] = {"launches": launches, "scores": scores, "idx": idx,
                      "k5_max_abs_err": check_similarity(w_emb, p_emb, scores, idx),
                      "events": [(e.source, e.matched_pattern.id, e.context.line_number, e.score)
                                 for e in result.events], "windows": int(w_emb.shape[0])}
    got, ref = runs["tokenizer_json"], runs["vocab_txt"]
    want_launch = {name: 0 for name in kernels}
    want_launch["best_window_similarity"] = 1
    if got["launches"] != want_launch or not got["k5_max_abs_err"] <= SIM_TOL:
        raise fail(f"tokenizers (b): launches {got['launches']}, K5 error {got['k5_max_abs_err']}")
    if not (torch.equal(got["scores"], ref["scores"]) and torch.equal(got["idx"], ref["idx"])):
        raise fail("tokenizers (b): K5's scores or indices differ from the vocab.txt checkpoint's")
    if got["events"] != ref["events"]:
        raise fail(f"tokenizers (b): events {got['events']} != {ref['events']}")
    return {
        "fixture": os.path.relpath(WORDPIECE_FIXTURE, ROOT), "vocab": len(vocab),
        "texts": len(texts), "windows": got["windows"], "launches": got["launches"],
        "k5_max_abs_err": got["k5_max_abs_err"], "scores_equal_vocab_txt": True,
        "events": len(got["events"]), "encode_us_per_prompt": encode_times["tokenizer_json"],
        "vocab_txt_encode_us_per_prompt": encode_times["vocab_txt"],
        "fixture_ids": fixture_ids, "wall_s": time.perf_counter() - started,
    }, ref["launches"]

# ---------------------------------------------------------------------------
# phase 7: the operator control plane over the fake apiserver
# ---------------------------------------------------------------------------

#: the operator phase's pods: one per fixture log (the first ten by name),
#: even ones on the greedy AIProvider
OPERATOR_PODS = 10
#: how long the drive may take to queue its ten requests
OPERATOR_QUEUE_S = 120.0
#: the logs the recurrences may repeat, in order: each one's evidence
#: carries numbers the fingerprint keeps (memory figures, addresses,
#: versions), so changing them changes its identity.  The first whose pod
#: stored a generated explanation is taken (random weights can decode to
#: an empty one, which is never reused)
OPERATOR_RECURRENT_LOGS = ("eviction.log", "go_panic.log", "image_pull_backoff.log",
                           "init_container_config.log", "oom_java.log")


def operator_pod(name: str, variant: str, finished_at: str) -> dict:
    """A pod of ``app=payment`` in CrashLoopBackOff after exit code 1."""
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "prod",
                     "labels": {"app": "payment", "variant": variant}},
        "status": {"phase": "Running", "containerStatuses": [{
            "name": "app", "restartCount": 3,
            "state": {"waiting": {"reason": "CrashLoopBackOff"}},
            "lastState": {"terminated": {"exitCode": 1, "finishedAt": finished_at}},
        }]},
    }


def operator_resources(model_name: str) -> list:
    """Two AIProviders on the one ``tpu-native`` engine, greedy and at the
    default temperature (0.3), and a Podmortem for each selecting
    ``app=payment`` pods of its variant (a Podmortem names one
    AIProvider)."""
    out = []
    for variant, temperature in (("greedy", 0.0), ("sampled", None)):
        spec = {"providerId": "tpu-native", "modelId": model_name, "maxTokens": MAX_TOKENS}
        if temperature is not None:
            spec["temperature"] = temperature
        out.append(("AIProvider", {"metadata": {"name": variant, "namespace": "ops"}, "spec": spec}))
        out.append(("Podmortem", {
            "metadata": {"name": f"watch-payment-{variant}", "namespace": "ops"},
            "spec": {"podSelector": {"matchLabels": {"app": "payment"}, "matchExpressions": [
                         {"key": "variant", "operator": "In", "values": [variant]}]},
                     "aiProviderRef": {"name": variant, "namespace": "ops"},
                     "aiAnalysisEnabled": True}}))
    return out


def phase_operator(results: dict, kernel_modules: dict, dirs: dict) -> dict:
    """The port's ``Operator`` on the card over ``FakeKubeApi``, with the
    checkpoint phase's tinyllama-1.1b checkpoint through ``providerId:
    tpu-native`` and its MiniLM-width encoder as ``ENCODER_CHECKPOINT_DIR``.
    Ten failing pods (the fixture logs; half on the greedy AIProvider;
    admission held until all ten are queued), then the recurrences: an
    earlier pod's log (a recall hit) and changed logs until one is near or
    miss.  Returns the kernels' launch counts over the drive and the
    recurrences."""
    import asyncio

    import torch

    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.operator.storage import ANNOTATION_ANALYSIS
    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder
    from operator_tpu_torch.schema.analysis import PodFailureData
    from operator_tpu_torch.serving import provider as provider_module
    from operator_tpu_torch.serving.sched import mixed as mixed_module
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    env = {**CHECKPOINT_ENV, "MODEL_ID": CHECKPOINT_ENV["OPERATOR_TPU_MODEL"],
           "CHECKPOINT_DIR": dirs["llm"], "ENCODER_CHECKPOINT_DIR": dirs["encoder"],
           "PATTERN_CACHE_DIRECTORY": os.path.join(dirs["workdir"], "no-pattern-cache"),
           "HEALTH_PORT": "0", "HEALTH_HOST": "127.0.0.1"}
    config = OperatorConfig.from_env(env)
    out: dict = {"card": card_line(), "pods": OPERATOR_PODS}
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[:OPERATOR_PODS]
    pods = [(f"payment-{i}", ("greedy", "sampled")[i % 2], "\n".join(fixture_lines(name)))
            for i, name in enumerate(names)]

    # the operator's default device is cuda: no device argument
    operator = Operator(FakeKubeApi(), config=config, metrics=MetricsRegistry())
    api, semantic, index = operator.api, operator.engine.semantic, operator.memory.index
    if semantic is None or not isinstance(semantic.embedder, NeuralEmbedder):
        raise fail("the operator did not mount the encoder checkpoint")
    provider = operator.providers.resolve("tpu-native")
    engine = provider.engine
    sched, model = engine.scheduler, engine.generator.config
    # what the drives ask of K5: semantic analyses, and recall queries over
    # a non-empty index (each one launch)
    k5_calls = {"analyze": 0, "query": 0}
    match, query, generate = semantic.match, index.query, provider.generate

    def counted_match(lines):
        k5_calls["analyze"] += bool(lines) and semantic.num_patterns > 0
        return match(lines)

    def counted_query(text, k=3):
        k5_calls["query"] += len(index) > 0 and bool(text.strip())
        return query(text, k)

    # the requests the pipeline hands the provider, in call order, and
    # their responses
    exchanged: list = []

    async def captured(request):
        pair = [request, None]
        exchanged.append(pair)
        pair[1] = await generate(request)
        return pair[1]

    gate = threading.Lock()
    admit = engine._admit_submissions

    def gated(block: bool) -> None:
        with gate:
            admit(block)

    # what the drive queued: each prompt's absolute deadline and the
    # engine's clock at its submit (admission is earliest deadline first)
    submitted: dict = {}
    submit = engine.submit

    def recorded(prompt, params=None, **kw):
        submitted[prompt] = (params.deadline if params else None, engine.generator._clock())
        return submit(prompt, params, **kw)

    def counts() -> dict:
        """The counts since the last call; then every count is 0."""
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for module in kernel_modules.values():
            module.launches = 0
        return launches

    async def poke(name: str, variant: str, log: str, finished_at: str) -> int:
        api.set_pod_log("prod", name, log, previous=True)
        await asyncio.wait_for(api.create("Pod", operator_pod(name, variant, finished_at)),
                               timeout=config.kube_call_timeout_s)
        poked = time.monotonic_ns()
        # the watcher reacts to MODIFIED (as run_demo pokes its pod)
        await asyncio.wait_for(
            api.patch("Pod", name, "prod", {"metadata": {"labels": {"poked": "1"}}}),
            timeout=config.kube_call_timeout_s)
        return poked

    async def drive() -> dict:
        for kind, obj in operator_resources(model.name):
            await asyncio.wait_for(api.create(kind, obj), timeout=config.kube_call_timeout_s)
        await operator.start()
        await asyncio.sleep(0.05)  # the watches register, the caches prime
        # not a cold start: the engine's programs and the template's head
        engine.warmup()
        await generate(provider_requests()[0])
        wait_idle(sched)
        poked: dict = {}
        counts()
        steps0, dev0 = sched.steps, len(sched.device_ms)
        # the sampler's state as the drive's first step will find it
        drive_rng.append(engine.generator._rng.get_state())
        engine._admit_submissions, engine.submit = gated, recorded
        gate.acquire()
        try:
            # the worker's idle wait for a submission (50 ms) runs out, so
            # it reads the gated admission before the first one arrives
            await asyncio.sleep(0.2)
            started = time.monotonic_ns()
            for i, (name, variant, log) in enumerate(pods):
                poked[name] = await poke(name, variant, log, f"2026-07-28T09:{i:02d}:00Z")
            queued_by = time.monotonic() + OPERATOR_QUEUE_S
            while engine._submissions.qsize() < OPERATOR_PODS:
                if time.monotonic() > queued_by:
                    handed = [r.failure_data.pod.metadata.name for r, _ in exchanged]
                    events = [(e["regarding"]["name"], e["reason"], e.get("note"))
                              for e in await api.list("Event")]
                    raise fail(f"operator drive: {engine._submissions.qsize()} of "
                               f"{OPERATOR_PODS} requests queued in {OPERATOR_QUEUE_S} s "
                               f"(handed to the provider: {handed}; events {events})")
                await asyncio.sleep(0.001)
        finally:
            gate.release()
        await asyncio.sleep(0.01)
        await operator.watcher.drain()
        wall_s = (time.monotonic_ns() - started) / 1e9
        wait_idle(sched)
        engine._admit_submissions, engine.submit = admit, submit
        steps, launches = sched.steps - steps0, counts()
        stream_ms = sched.device_ms[dev0:]
        # the recurrences, each on its pod's AIProvider: a new pod with a
        # drive pod's log (a hit), then that log with its numbers changed,
        # and the next candidate's, until one changes the fingerprint (the
        # normalised evidence keeps a number only where it is part of a
        # token, and the strongest evidence may carry none)
        stored = {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                  for f in (cr.get("status") or {}).get("recentFailures") or []}
        candidates = [pods[names.index(n)] for n in OPERATOR_RECURRENT_LOGS
                      if stored[pods[names.index(n)][0]]["analysisStatus"] == "Analyzed"]
        if not candidates:
            raise fail(f"operator: no candidate for the recurrences stored an explanation: {stored}")
        recurrence: dict = {}

        async def recur(name: str, variant: str, log: str) -> dict:
            poked[name] = await poke(name, variant, log,
                                     f"2026-07-28T10:{len(recurrence):02d}:00Z")
            await asyncio.sleep(0.05)
            await operator.watcher.drain()
            wait_idle(sched)
            recurrence[name] = counts()
            recurrences.append((name, variant, log))
            failures = {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                        for f in (cr.get("status") or {}).get("recentFailures") or []}
            return failures[name].get("recurrence") or {}

        first, variant, log = candidates[0]
        await recur("payment-hit", variant, log)
        for i, (first, variant, log) in enumerate(candidates):
            changed = re.sub(r"\d+", lambda m: str(int(m.group()) + 7), log)
            got = await recur(f"payment-changed-{i}", variant, changed)
            if got.get("fingerprint") != stored[first]["recurrence"]["fingerprint"]:
                break
        url = f"http://127.0.0.1:{operator.health_server.bound_port}"
        scraped = {path: await asyncio.to_thread(
            lambda p=path: urllib.request.urlopen(url + p, timeout=30).read().decode())
            for path in ("/metrics", "/readyz")}
        pods_now = {p["metadata"]["name"]: p for p in await api.list("Pod", "prod")}
        failures = {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                    for f in (cr.get("status") or {}).get("recentFailures") or []}
        events = await api.list("Event")
        await operator.stop()
        return {"poked": poked, "wall_s": wall_s, "steps": steps, "launches": launches,
                "stream_ms_per_step": sum(stream_ms) / len(stream_ms) if stream_ms else None,
                "recurrence": recurrence, "scraped": scraped, "pods": pods_now,
                "failures": failures, "events": events}

    semantic.match, index.query, provider.generate = counted_match, counted_query, captured
    #: (pod, variant, log) of each recurrence, in poke order
    recurrences: list = []
    drive_rng: list = []
    try:
        run = asyncio.run(drive())
    finally:
        semantic.match, index.query, provider.generate = match, query, generate
        engine._admit_submissions, engine.submit = admit, submit
    analysed = [name for name, _, _ in pods + recurrences]
    failures, pod_events = run["failures"], {}
    for e in run["events"]:
        regarding = e.get("regarding") or {}
        if regarding.get("kind") == "Pod":
            pod_events.setdefault(regarding.get("name"), set()).add(e.get("reason"))
    responses = {r.failure_data.pod.metadata.name: a for r, a in exchanged}
    counters = operator.metrics.snapshot()["counters"]
    reused = {name for name in analysed
              if (failures.get(name, {}).get("recurrence") or {}).get("reusedAnalysis")}
    # the stored status follows the answer: "Analyzed" with a generated
    # explanation or a reused one, "PatternOnly" when the tokens decode to
    # nothing but blanks.  A pod without its own provider call and no
    # reuse was served by the pipeline's response cache (the same evidence
    # lines as an earlier pod's)
    want_status = {name: ("Analyzed" if responses[name].explanation else "PatternOnly")
                   if name in responses else ("Analyzed",) if name in reused
                   else ("Analyzed", "PatternOnly") for name in analysed}
    bad_answers = [(name, a.to_dict()) for name, a in responses.items()
                   if a.error or not a.completion_tokens]
    missing = [name for name in analysed
               if not (run["pods"][name]["metadata"].get("annotations") or {}).get(ANNOTATION_ANALYSIS)
               or failures.get(name, {}).get("analysisStatus") not in want_status[name]
               or pod_events.get(name) != {"PodFailureDetected", "PodmortemAnalysisComplete"}]
    cache_served = [n for n in analysed if n not in responses and n not in reused]
    if (missing or bad_answers or reused & set(responses)
            or len(cache_served) != counters.get("ai_cache_hits", 0)):
        raise fail(f"operator: pods without their annotations, status entry or events: "
                   f"{[(n, failures.get(n), pod_events.get(n)) for n in missing]}; "
                   f"provider answers without tokens: {bad_answers}; reused {reused}, "
                   f"served from the response cache {cache_served}, counters {counters}")
    ledger = operator.pipeline.slo_ledger
    records = ledger.records
    if (len(records) != len(analysed) or len({r.trace_id for r in records}) != len(records)
            or ledger.pending or any(r.outcome != "completed" for r in records)):
        raise fail(f"operator: the SLO ledger {ledger.snapshot()} over {len(analysed)} analyses")
    hit, near = (failures[name].get("recurrence") or {} for name in ("payment-hit", recurrences[-1][0]))
    if (not hit.get("reusedAnalysis") or near.get("reusedAnalysis")
            or near.get("fingerprint") == hit.get("fingerprint")
            or counters.get("recall_hit") != len(reused)):
        raise fail(f"operator: recall hit {hit}, changed logs "
                   f"{[failures[n].get('recurrence') for n, _, _ in recurrences[1:]]}, "
                   f"counters {counters}")
    launches, steps = run["launches"], run["steps"]
    if launches["ragged_paged_attention"] != model.num_layers * steps or steps == 0:
        raise fail(f"operator drive: K1 launched {launches} over {steps} steps")
    if run["recurrence"]["payment-hit"]["ragged_paged_attention"]:
        raise fail(f"operator: the recall hit launched K1: {run['recurrence']}")
    every = [launches, *run["recurrence"].values()]
    k5 = sum(c["best_window_similarity"] for c in every)
    if k5 != k5_calls["analyze"] + k5_calls["query"] or k5_calls["analyze"] != len(analysed):
        raise fail(f"operator: K5 launched {k5} times for {k5_calls}")
    if any(c["paged_decode_attention"] or c["flash_prefill_attention"] for c in every):
        raise fail(f"operator: wave kernels launched: {every}")
    if f"podmortem_recall_hit_total {len(reused)}" not in run["scraped"]["/metrics"]:
        raise fail("operator: /metrics lacks the recall hit")

    # per pod: poke to stored status, and the stage split from its trace
    traces = {r.trace_id: r.trace["spans"] for r in operator.recorder.traces()}
    per_pod: dict = {}
    for record in records:
        spans = traces[record.trace_id]
        root = next(sp for sp in spans if "parentId" not in sp)
        name = root["attributes"]["pod"].split("/")[-1]
        store = next(sp for sp in spans if sp["name"] == "store"
                     and sp.get("parentId") == root["spanId"])
        stages = record.stages
        per_pod[name] = {
            "poke_to_stored_ms": (store["endNs"] - run["poked"][name]) / 1e6,
            "analysis_ms": record.latency_s * 1e3,
            "stages_ms": {"collect": stages.get("collect"), "analyze": stages.get("parse"),
                          "recall": stages.get("recall"), "generate": stages.get("explain"),
                          "store": stages.get("store")},
            "host_outside_engine_ms": record.latency_s * 1e3 - stages.get("explain", 0.0),
        }
    drive_pods = [name for name, _, _ in pods]
    completion = sum(responses[name].completion_tokens for name in drive_pods)
    out.update({
        "steps": steps, "launches": launches, "recurrence_launches": run["recurrence"],
        "k5_calls": k5_calls, "recall": {"hit": hit, "changed_log": near},
        "drive_wall_s": run["wall_s"], "completion_tokens": completion,
        "prompt_tokens": [responses[n].prompt_tokens for n in drive_pods],
        "stream_ms_per_step": run["stream_ms_per_step"],
        "recurrent_log": names[[log for _, _, log in pods].index(recurrences[0][2])],
        "changed_logs": {n: failures[n].get("recurrence") for n, _, _ in recurrences[1:]},
        "served_from_response_cache": cache_served,
        "blank_explanations": sorted(n for n in drive_pods if not responses[n].explanation),
        "tokens_per_s": completion / run["wall_s"],
        "poke_to_stored_ms": {n: per_pod[n]["poke_to_stored_ms"] for n in analysed},
        "stages_ms": {n: per_pod[n]["stages_ms"] for n in analysed},
        "host_outside_engine_ms": {n: per_pod[n]["host_outside_engine_ms"] for n in analysed},
        "recall_hit_wall_ms": per_pod["payment-hit"]["poke_to_stored_ms"],
        "changed_log_wall_ms": per_pod[recurrences[-1][0]]["poke_to_stored_ms"],
        "readyz": run["scraped"]["/readyz"],
    })
    print(json.dumps({"operator": {k: v for k, v in out.items() if k not in (
        "poke_to_stored_ms", "stages_ms", "host_outside_engine_ms")}}), flush=True)
    print(json.dumps({"operator_per_pod": per_pod, "card": out["card"]}), flush=True)

    # one more request's 22 K1 calls and one analyze()'s K5 call, held
    held = HeldToPlain(
        mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
        model.num_layers, lambda dtype, _: TOL[dtype],
        valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
        note=k1_split_note,
    )
    k5_held = StreamSpans(semantic_module.best_window_scores)
    mixed_module.ragged_paged_attention = held
    semantic_module.best_window_scores = k5_held
    try:
        with eager_programs():
            asyncio.run(generate(exchanged[0][0]))
            operator.engine.analyze(PodFailureData(logs=pods[1][2]))
    finally:
        mixed_module.ragged_paged_attention = held.fn
        semantic_module.best_window_scores = k5_held.fn
    counts()  # the comparisons' launches are not the path's
    bad = [c for c in held.held if not c["finite"] or not c["excess"] <= 0]
    [(_, _, (w_emb, p_emb), (scores, idx))] = k5_held.calls
    k5_err = check_similarity(w_emb, p_emb, scores, idx)
    if len(held.held) != model.num_layers or bad or not k5_err <= SIM_TOL:
        raise fail(f"operator: {len(held.held)} K1 calls held, outside tolerance: {bad}; "
                   f"K5 error {k5_err}")
    out["held"] = {"k1_calls": len(held.held),
                   "k1_max_abs_err": max(c["max_abs_err"] for c in held.held),
                   "k5_max_abs_err": k5_err}
    engine.close()

    # the greedy pods' stored explanations against a direct provider drive
    # of the same captured requests, on an engine of the same weights.
    # The two drives must take the same steps (K1's rounding follows a
    # row's place in the step): the direct engine's sampler starts where
    # the operator's did, and each request keeps its operator deadline,
    # moved by one constant, so earliest-deadline-first admission orders
    # the rows as it did there (the pipeline hands the provider the budget
    # left after each pod's own collect and match, not a common one)
    direct = provider_module.build_tpu_native_provider(
        "cuda", {**CHECKPOINT_ENV, "CHECKPOINT_DIR": dirs["llm"]})
    direct_submit = direct.engine.submit
    moved: dict = {}

    def replayed(prompt, params=None, **kw):
        deadline, at = submitted[prompt]
        shift = moved.setdefault("s", direct.engine.generator._clock() - at)
        if deadline is not None:
            params = dataclasses.replace(params, deadline=deadline + shift)
        return direct_submit(prompt, params, **kw)

    try:
        direct.engine.warmup()
        asyncio.run(direct.generate(provider_requests()[0]))
        wait_idle(direct.engine.scheduler)
        drive_requests = [r for r, _ in exchanged[:OPERATOR_PODS]]
        direct.engine.generator._rng.set_state(drive_rng[0])
        direct.engine.submit = replayed
        want = gated_drive(direct, drive_requests)
    finally:
        direct.engine.submit = direct_submit
        direct.engine.close()
    greedy = [(r.failure_data.pod.metadata.name, w) for r, w in zip(drive_requests, want)
              if r.provider_config.temperature == 0.0]
    unequal = [(name, responses[name].to_dict(), w.to_dict()) for name, w in greedy
               if (responses[name].explanation, responses[name].completion_tokens,
                   responses[name].prompt_tokens)
               != (w.explanation, w.completion_tokens, w.prompt_tokens)]
    if len(greedy) != OPERATOR_PODS // 2 or unequal:
        raise fail(f"operator: greedy explanations differ from the direct drive's: {unequal}")
    out["greedy_equal_direct"] = len(greedy)
    out["sampled_equal_direct"] = all(
        responses[r.failure_data.pod.metadata.name].explanation == w.explanation
        for r, w in zip(drive_requests, want))
    provider_drive = (results.get("checkpoint") or {}).get("provider") or {}
    if provider_drive.get("tokens_per_s"):
        out["tokens_per_s_vs_provider_drive"] = out["tokens_per_s"] / provider_drive["tokens_per_s"]
    print(json.dumps({"operator_checks": {k: out.get(k) for k in (
        "held", "greedy_equal_direct", "sampled_equal_direct", "tokens_per_s",
        "tokens_per_s_vs_provider_drive")}, "card": out["card"]}), flush=True)
    results["operator"] = out
    return {name: sum(c[name] for c in every) for name in kernel_modules}


# ---------------------------------------------------------------------------
# phase 8: the serving front as a service, and the operator's remote path
# ---------------------------------------------------------------------------

#: the remote phase's two replicas, each a CompletionServer over one engine
REMOTE_REPLICAS = ("replica-a", "replica-b")
#: pods per batch of the remote operator drive (the ten are two batches)
REMOTE_BATCH = 5
#: the cancelled stream's budget: far past the steps its release may take
CANCEL_MAX_TOKENS = 256


def held_sends(engine, sends: list, timeout_s: float = 120.0,
               timing: "dict | None" = None) -> tuple:
    """Run every ``send()`` on its own thread, each queued at the engine in
    list order, the engine's admission held until all are queued — so two
    drives of the same requests take the same steps.  The hold is on the
    loop's intake: the scheduler's admission, or the wave loop's take
    into its waiting line.  ``timing`` receives ``released``, when the
    hold lifts.  Returns (results in list order, the sampler's state the
    first step will find)."""
    gate = threading.Lock()
    intake = "_admit_submissions" if engine.scheduler is not None else "_take_submissions"
    admit = getattr(engine, intake)
    results: list = [None] * len(sends)
    errors: list = []

    def gated(block: bool):
        with gate:
            return admit(block)

    def call(i: int) -> None:
        try:
            results[i] = sends[i]()
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(f"send {i}: {exc!r}")

    setattr(engine, intake, gated)
    threads = []
    try:
        with gate:
            # the worker's idle wait for a submission (50 ms) runs out, so
            # it reads the gated admission before the first one arrives
            time.sleep(0.2)
            base = engine._submissions.qsize()
            for i in range(len(sends)):
                thread = threading.Thread(target=call, args=(i,), daemon=True)
                thread.start()
                threads.append(thread)
                by = time.monotonic() + timeout_s
                while engine._submissions.qsize() < base + i + 1 and not errors:
                    if time.monotonic() > by:
                        raise fail(f"held drive: request {i} not queued in {timeout_s} s")
                    time.sleep(0.0005)
            rng = engine.generator._rng.get_state()
        if timing is not None:
            timing["released"] = time.perf_counter()
        for thread in threads:
            thread.join(900)
    finally:
        setattr(engine, intake, admit)
    if errors or any(t.is_alive() for t in threads):
        raise fail(f"held drive: {errors or 'a request did not finish'}")
    return results, rng


def sse_request(port: int, path: str, body: dict, *, close_after_first: bool = False,
                timeout: float = 600.0) -> dict:
    """POST ``body`` with ``stream: true``; read the Server-Sent Events:
    the chunks' texts, time to the first chunk and the wall.  With
    ``close_after_first`` the socket is closed after the first chunk."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    started = time.perf_counter()
    try:
        conn.request("POST", path, json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or "text/event-stream" not in (resp.getheader("Content-Type") or ""):
            raise fail(f"stream {path}: status {resp.status}: {resp.read()[:300]!r}")
        out = {"texts": [], "finish": None, "first_chunk_s": None}
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if data == b"[DONE]":
                break
            event = json.loads(data)
            if "error" in event:
                raise fail(f"stream {path}: in-stream error {event}")
            choice = event["choices"][0]
            delta = choice.get("delta", {}).get("content") if "delta" in choice else choice.get("text")
            if out["first_chunk_s"] is None:
                out["first_chunk_s"] = time.perf_counter() - started
            if choice.get("finish_reason"):
                out["finish"] = choice["finish_reason"]
            if delta:
                out["texts"].append(delta)
            if close_after_first:
                break
        out["wall_s"] = time.perf_counter() - started
        return out
    finally:
        conn.close()


def parse_prometheus(text: str, openmetrics: bool) -> int:
    """Every sample line is ``name{labels} value [timestamp]`` (an
    OpenMetrics exemplar after `` # `` stripped); OpenMetrics ends with
    ``# EOF``.  Returns the number of samples."""
    samples = 0
    lines = text.rstrip("\n").splitlines()
    if openmetrics and lines[-1] != "# EOF":
        raise fail("the OpenMetrics exposition does not end with # EOF")
    for line in lines:
        if not line or line.startswith("#"):
            continue
        if openmetrics:
            line = line.split(" # ", 1)[0]
        match = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)( \S+)?", line)
        if match is None:
            raise fail(f"not a Prometheus sample line: {line!r}")
        float(match.group(3))
        samples += 1
    return samples


def http_get(port: int, path: str, headers: "dict | None" = None) -> tuple:
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    with urllib.request.urlopen(request, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def remote_resources(model_name: str, api_url: str) -> list:
    """The operator phase's two AIProviders and Podmortems, with
    ``providerId: openai-compatible`` naming both replicas."""
    out = []
    for kind, obj in operator_resources(model_name):
        if kind == "AIProvider":
            obj = {**obj, "spec": {**obj["spec"], "providerId": "openai-compatible",
                                   "apiUrl": api_url, "maxRetries": 3,
                                   "timeoutSeconds": 300}}
        out.append((kind, obj))
    return out


def phase_remote(results: dict, kernel_modules: dict, dirs: dict) -> dict:
    """The serving front as a service and the operator's remote path, on
    the checkpoint phase's two checkpoints.  Two ``CompletionServer``s
    (replicas A and B) over one engine on the card: (a) ten streamed and
    ten plain chat completions, held; (b) a stream closed after its first
    chunk; (c) three ``AnalysisRequest``s through the analyze route
    against the provider; (d) the port's ``Operator`` with ``providerId:
    openai-compatible`` over both replicas, B stopped between two batches
    of five pods; (e) ``/v1/embeddings``; (f) ``/metrics`` and a
    ``/profile`` capture.  Returns the launch counts over the drives."""
    import asyncio

    import numpy as np

    from operator_tpu_torch.obs import FlightRecorder, Tracer
    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.operator.providers import replica_set
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, build_embedder
    from operator_tpu_torch.router import EngineRouter
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.prompts import build_prompt
    from operator_tpu_torch.serving.provider import TPUNativeProvider, build_serving_engine
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    out: dict = {"card": card_line()}
    env = {**CHECKPOINT_ENV, "CHECKPOINT_DIR": dirs["llm"]}
    engine, model_id = build_serving_engine("cuda", env)
    sched, g, layers = engine.scheduler, engine.generator, engine.generator.config.num_layers
    embedder = build_embedder(dirs["encoder"], fallback=False, device="cuda")
    if not isinstance(embedder, NeuralEmbedder):
        raise fail("remote: the encoder checkpoint did not load as a NeuralEmbedder")
    provider = TPUNativeProvider(engine, model_id=model_id)
    server_recorder = FlightRecorder(capacity=256)
    profile_dir = os.path.join(dirs["workdir"], "profile")
    servers = [CompletionServer(
        engine, model_id=model_id, host="127.0.0.1", port=0, embedder=embedder,
        analysis_backend=provider, tracer=Tracer(recorder=server_recorder),
        replica_id=rid, profile_enabled=True, profile_dir=profile_dir,
    ) for rid in REMOTE_REPLICAS]
    engine.warmup()
    http = HttpLoop(*servers)
    ports = [s.bound_port for s in servers]
    #: the launches of the drives' checked windows (not the comparisons')
    launches_total = {name: 0 for name in kernel_modules}

    def counts(path: bool = False) -> dict:
        """The counts since the last call, added to the path's total when
        ``path``; then every count is 0."""
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for module in kernel_modules.values():
            module.launches = 0
        for name, n in launches.items():
            launches_total[name] += n if path else 0
        return launches

    def k1_per_step(where: str, steps0: int, k5: "int | None" = 0) -> dict:
        """The counts since ``steps0``: K1 once per layer per step, K5 as
        given (``None``: the caller counts it), the wave kernels never."""
        steps, launches = sched.steps - steps0, counts(path=True)
        want = {"ragged_paged_attention": layers * steps,
                "best_window_similarity": launches["best_window_similarity"] if k5 is None else k5,
                "paged_decode_attention": 0, "flash_prefill_attention": 0}
        if launches != want or steps == 0:
            raise fail(f"remote {where}: launches {launches} over {steps} steps; want {want}")
        return {"steps": steps, "launches": launches}

    try:
        requests = provider_requests()
        prompts = [build_prompt(r) for r in requests]
        # (a) ten chat completions streamed, then the same ten plain: both
        # held, each on an empty prefix cache from the same sampler state
        chat = [{"messages": [{"role": "user", "content": p}], "max_tokens": MAX_TOKENS,
                 "temperature": r.provider_config.temperature, "top_p": 0.95}
                for p, r in zip(prompts, requests)]
        wait_idle(sched)
        sched.spill_cache()
        rng0 = g._rng.get_state()
        counts()
        steps0 = sched.steps
        started = time.perf_counter()
        streamed, _ = held_sends(engine, [
            lambda b=b, i=i: sse_request(ports[i % 2], "/v1/chat/completions", b)
            for i, b in enumerate(chat)])
        stream_wall = time.perf_counter() - started
        stream_launches = k1_per_step("streamed drive", steps0)
        wait_idle(sched)
        sched.spill_cache()
        g._rng.set_state(rng0)
        steps0 = sched.steps
        started = time.perf_counter()
        plain, _ = held_sends(engine, [
            lambda b=b, i=i: _post(f"http://127.0.0.1:{ports[i % 2]}/v1/chat/completions", b)
            for i, b in enumerate(chat)])
        plain_wall = time.perf_counter() - started
        plain_launches = k1_per_step("plain drive", steps0)
        greedy = [i for i, b in enumerate(chat) if b["temperature"] == 0.0]
        unequal = [(i, "".join(streamed[i]["texts"]), plain[i]["choices"][0]["message"]["content"])
                   for i in greedy
                   if "".join(streamed[i]["texts"]) != plain[i]["choices"][0]["message"]["content"]]
        if unequal or not greedy:
            raise fail(f"remote: streamed greedy text differs from the plain text: {unequal}")
        completion = sum(p["usage"]["completion_tokens"] for p in plain)
        out["streaming"] = {
            "requests": len(chat), "greedy_equal": len(greedy),
            "sampled_equal": all("".join(streamed[i]["texts"])
                                 == plain[i]["choices"][0]["message"]["content"]
                                 for i in range(len(chat))),
            "first_chunk_s": [s["first_chunk_s"] for s in streamed],
            "chunks": [len(s["texts"]) for s in streamed],
            "completion_tokens": [p["usage"]["completion_tokens"] for p in plain],
            "stream_wall_s": stream_wall, "plain_wall_s": plain_wall,
            "stream_tokens_per_s": completion / stream_wall,
            "plain_tokens_per_s": completion / plain_wall,
            "stream_steps": stream_launches["steps"], "plain_steps": plain_launches["steps"],
        }
        print(json.dumps({"remote_streaming": out["streaming"], "card": out["card"]}), flush=True)

        # (b) a long stream closed after its first chunk: its row and pages
        # return within pipeline depth + 2 steps of the close
        wait_idle(sched)
        steps0 = sched.steps
        first = sse_request(ports[0], "/v1/chat/completions",
                            {**chat[0], "max_tokens": CANCEL_MAX_TOKENS}, close_after_first=True)
        closed_at = sched.steps
        by = time.monotonic() + 60
        while sched.total_work and time.monotonic() < by:
            time.sleep(0.0005)
        released_at = sched.steps
        cancel_launches = k1_per_step("cancelled stream", steps0)
        accounting = balanced(sched, "after the cancelled stream")
        load = healthz(ports[0])["load"]
        if (sched.total_work or accounting["row_pages"] or load["inflight"] != 0
                or released_at - closed_at > sched.depth + 2):
            raise fail(f"remote: the closed stream was not released: work {sched.total_work}, "
                       f"steps close -> release {released_at - closed_at}, {accounting}, "
                       f"inflight {load['inflight']}")
        out["cancel"] = {"first_chunk_s": first["first_chunk_s"],
                         "steps_close_to_release": released_at - closed_at,
                         "steps_in_all": cancel_launches["steps"],
                         "page_accounting": accounting}
        print(json.dumps({"remote_cancel": out["cancel"], "card": out["card"]}), flush=True)

        # (c) the reference contract: three AnalysisRequests through the
        # analyze route, then the provider directly, both held
        three = requests[:3]
        wait_idle(sched)
        sched.spill_cache()
        rng0 = g._rng.get_state()
        steps0 = sched.steps
        routed, _ = held_sends(engine, [
            lambda r=r: _post(f"http://127.0.0.1:{ports[1]}/api/v1/analysis/analyze",
                              r.to_dict()) for r in three])
        analyze_launches = k1_per_step("analyze route", steps0)
        wait_idle(sched)
        sched.spill_cache()
        g._rng.set_state(rng0)
        direct, _ = held_sends(engine, [
            lambda r=r: asyncio.run(provider.generate(r)).to_dict() for r in three])
        counts()
        greedy = [i for i, r in enumerate(three) if r.provider_config.temperature == 0.0]
        unequal = [(i, routed[i], direct[i]) for i in greedy if routed[i] != direct[i]]
        if unequal or not greedy or any(r.get("error") for r in routed):
            raise fail(f"remote: the analyze route differs from the provider: {unequal or routed}")
        out["analyze"] = {"requests": len(three), "greedy_equal": len(greedy),
                          "steps": analyze_launches["steps"],
                          "completion_tokens": [r["completionTokens"] for r in routed]}
        print(json.dumps({"remote_analyze": out["analyze"], "card": out["card"]}), flush=True)

        out["operator"] = remote_operator(
            dirs, engine, model_id, servers, http, ports, counts, k1_per_step, out["card"])
        # the replica still listening serves (e) and (f)
        [live] = [s.bound_port for s in servers if s.bound_port is not None]

        # (e) /v1/embeddings: the encoder on the card, bit for bit
        lines = fixture_lines(sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[0])[:8]
        counts()
        embedded = _post(f"http://127.0.0.1:{live}/v1/embeddings", {"input": lines})
        got = np.asarray([d["embedding"] for d in embedded["data"]], np.float32)
        want = embedder.embed(lines)
        launches = counts()
        if got.shape != want.shape or not np.array_equal(got, want) or any(launches.values()):
            raise fail(f"remote: /v1/embeddings differs from embedder.embed "
                       f"(max {float(np.abs(got - want).max()) if got.shape == want.shape else got.shape}), "
                       f"launches {launches}")
        out["embeddings"] = {"lines": len(lines), "dim": int(want.shape[1]), "bit_equal": True}

        # (f) /metrics as Prometheus text and under OpenMetrics, and a
        # one-second /profile capture during a short drive that names K1
        _, ctype, text = http_get(live, "/metrics")
        _, om_ctype, om_text = http_get(live, "/metrics", {
            "Accept": "application/openmetrics-text; version=1.0.0"})
        if "text/plain" not in ctype or "openmetrics-text" not in om_ctype:
            raise fail(f"remote: /metrics content types {ctype!r}, {om_ctype!r}")
        samples = (parse_prometheus(text.decode(), False),
                   parse_prometheus(om_text.decode(), True))
        wait_idle(sched)
        steps0 = sched.steps
        captured: dict = {}
        capture = threading.Thread(target=lambda: captured.update(
            _post(f"http://127.0.0.1:{live}/profile?seconds=1", {})), daemon=True)
        capture.start()
        time.sleep(0.2)

        def short_drive(i: int) -> None:
            # requests until the capture ends: the profiler's start may
            # take longer than a few short requests do
            while capture.is_alive():
                _post(f"http://127.0.0.1:{live}/v1/completions",
                      {"prompt": LOG_LINE[:200 + 50 * i], "max_tokens": 16,
                       "temperature": 0.0})

        short = [threading.Thread(target=short_drive, args=(i,)) for i in range(4)]
        for thread in short:
            thread.start()
        for thread in short + [capture]:
            thread.join(300)
        wait_idle(sched)
        profile_launches = k1_per_step("profiled drive", steps0)
        trace = os.path.join(captured.get("artifact", ""), "trace.json")
        if not os.path.exists(trace):
            raise fail(f"remote: /profile wrote no trace: {captured}")
        with open(trace, encoding="utf-8") as fh:
            names = {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}
        k1_names = sorted(n for n in names if "ragged_attention" in n)
        if not k1_names:
            raise fail("remote: the /profile trace names no K1 kernel")
        out["metrics"] = {"samples": samples[0], "openmetrics_samples": samples[1]}
        out["profile"] = {"seconds": captured["seconds"], "k1_kernels": k1_names,
                          "steps": profile_launches["steps"]}
    finally:
        http.stop()
        engine.close()
    out["launches"] = launches_total
    print(json.dumps({"remote": {k: out[k] for k in (
        "embeddings", "metrics", "profile", "launches")}, "card": out["card"]}), flush=True)
    results["remote"] = out
    return launches_total


def remote_operator(dirs: dict, engine, model_id: str, servers: list, http, ports: list,
                    counts, k1_per_step, card: str) -> dict:
    """(d) of the remote phase: the port's ``Operator`` over ``FakeKubeApi``
    with ``providerId: openai-compatible`` naming both replicas and the
    encoder checkpoint as ``ENCODER_CHECKPOINT_DIR``.  The operator
    phase's ten pods are poked at once; each analysis is held at the
    provider until all ten have their fingerprints, so the drive knows
    every pod's affinity owner.  The replica that owns enough pods is
    stopped between two batches of five: the first batch holds pods of
    both owners, the second at least ``router_replica_failure_threshold``
    of the stopped replica's, which fail there, requeue once and land on
    the other replica while its breaker opens.  Each batch's engine
    admission is held until its five requests are queued; the drive's
    greedy explanations must equal a held replay of the captured engine
    requests on the same engine, from each batch's sampler state."""
    import asyncio

    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.operator.providers import replica_set
    from operator_tpu_torch.router import EngineRouter
    from operator_tpu_torch.serving.prompts import build_prompt
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    sched, g = engine.scheduler, engine.generator
    api_url = ",".join(f"http://127.0.0.1:{p}" for p in ports)
    env = {"ENCODER_CHECKPOINT_DIR": dirs["encoder"],
           "PATTERN_CACHE_DIRECTORY": os.path.join(dirs["workdir"], "no-pattern-cache"),
           "HEALTH_PORT": "0", "HEALTH_HOST": "127.0.0.1", "INCIDENTS_API_TOKEN": "remote",
           # the drive polls /healthz itself, after the failover
           "ROUTER_HEALTH_POLL_S": "0"}
    config = OperatorConfig.from_env(env)
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[:OPERATOR_PODS]
    pods = [(f"payment-{i}", ("greedy", "sampled")[i % 2], "\n".join(fixture_lines(name)))
            for i, name in enumerate(names)]
    operator = Operator(FakeKubeApi(), config=config, metrics=MetricsRegistry())
    api, semantic, index = operator.api, operator.engine.semantic, operator.memory.index
    backend = operator._http_backend
    k5_calls = {"analyze": 0, "query": 0}
    match, query, generate = semantic.match, index.query, backend.generate

    def counted_match(lines):
        k5_calls["analyze"] += bool(lines) and semantic.num_patterns > 0
        return match(lines)

    def counted_query(text, k=3):
        k5_calls["query"] += len(index) > 0 and bool(text.strip())
        return query(text, k)

    # each pod's analysis waits at the provider until its batch is let go
    owners: dict = {}
    release: dict = {}
    held_ns: dict = {}
    responses: dict = {}

    async def held_generate(request):
        pod = request.failure_data.pod.metadata.name
        router = backend.router_for(replica_set(request.provider_config.api_url))
        key = EngineRouter.affinity_key(prefix=build_prompt(request),
                                        fingerprint=request.fingerprint)
        owners[pod] = router.route(key).affinity_owner
        release.setdefault(pod, asyncio.Event())
        arrived = time.monotonic_ns()
        await release[pod].wait()
        held_ns[pod] = time.monotonic_ns() - arrived
        responses[pod] = await generate(request)
        return responses[pod]

    # the engine side: every submission, in queue order, per batch
    captured: list = []
    submit = engine.submit

    def recorded(prompt, params=None, **kw):
        future = submit(prompt, params, **kw)
        captured.append((prompt, params, kw, future))
        return future

    async def wait_for(predicate, what: str, timeout_s: float = 300.0) -> None:
        by = time.monotonic() + timeout_s
        while not predicate():
            if time.monotonic() > by:
                raise fail(f"remote operator: {what} not within {timeout_s} s")
            await asyncio.sleep(0.002)

    async def stored(names_: list) -> dict:
        return {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                for f in (cr.get("status") or {}).get("recentFailures") or []
                if f["podName"] in names_}

    async def drive() -> dict:
        for kind, obj in remote_resources(model_id, api_url):
            await asyncio.wait_for(api.create(kind, obj), timeout=config.kube_call_timeout_s)
        await operator.start()
        await asyncio.sleep(0.05)
        poked: dict = {}
        counts()
        started = time.monotonic_ns()
        for i, (name, variant, log) in enumerate(pods):
            api.set_pod_log("prod", name, log, previous=True)
            await asyncio.wait_for(api.create("Pod", operator_pod(
                name, variant, f"2026-07-28T09:{i:02d}:00Z")), timeout=config.kube_call_timeout_s)
            poked[name] = time.monotonic_ns()
            await asyncio.wait_for(
                api.patch("Pod", name, "prod", {"metadata": {"labels": {"poked": "1"}}}),
                timeout=config.kube_call_timeout_s)
        await wait_for(lambda: len(owners) == len(pods), "ten analyses at the provider")
        # the analyses' K5 launches; K1 none, every answer is held
        analyses = counts(path=True)
        by_owner: dict = {}
        for name, _, _ in pods:
            by_owner.setdefault(owners[name], []).append(name)
        threshold = config.router_replica_failure_threshold
        # the replica to stop: one owning at least threshold + 1 pods while
        # the other owns one (B, if that will do)
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        order = [urls[1], urls[0]]
        stop_url = next((u for u in order if len(by_owner.get(u, [])) >= threshold + 1
                         and len(pods) - len(by_owner.get(u, [])) >= 1), None)
        if stop_url is None:
            raise fail(f"remote operator: every pod is owned by one replica: {owners}")
        keep_url = urls[1 - urls.index(stop_url)]
        doomed = by_owner[stop_url]
        # the second batch is filled from the kept replica's pods, so the
        # doomed pod held back stays in the first batch beside them
        second = doomed[:min(len(doomed) - 1, REMOTE_BATCH)]
        second += [n for n, _, _ in pods if n not in doomed][:REMOTE_BATCH - len(second)]
        first = [n for n, _, _ in pods if n not in second]
        batches = []
        for batch_no, batch in enumerate((first, second)):
            if batch_no == 1:
                # the replica goes away between the batches
                stopped = servers[urls.index(stop_url)]
                await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    stopped.stop(), http.loop))
            wait_idle(sched)
            sched.spill_cache()
            counts()
            steps0 = sched.steps
            gate = threading.Lock()
            admit = engine._admit_submissions

            def gated(block: bool, admit=admit, gate=gate) -> None:
                with gate:
                    admit(block)

            engine._admit_submissions = gated
            gate.acquire()
            try:
                await asyncio.sleep(0.2)
                before = len(captured)
                released = time.monotonic_ns()
                for name in batch:
                    release.setdefault(name, asyncio.Event()).set()
                await wait_for(lambda: engine._submissions.qsize() >= len(batch),
                               f"batch {batch_no + 1}'s requests queued")
                rng = g._rng.get_state()
            finally:
                gate.release()
                engine._admit_submissions = admit
            await wait_for(lambda: all(n in responses for n in batch),
                           f"batch {batch_no + 1}'s answers")
            wait_idle(sched)
            done = time.monotonic_ns()
            batches.append({"pods": batch, "captured": (before, before + len(batch)),
                            "rng": rng, "released_ns": released, "done_ns": done,
                            **k1_per_step(f"operator batch {batch_no + 1}", steps0,
                                          k5=None)})
        await operator.watcher.drain()
        wall_s = (time.monotonic_ns() - started) / 1e9
        polled = await backend.poll_replica_health(timeout_s=30.0)
        url = f"http://127.0.0.1:{operator.health_server.bound_port}"

        def fleet_get():
            request = urllib.request.Request(url + "/fleet",
                                             headers={"Authorization": "Bearer remote"})
            with urllib.request.urlopen(request, timeout=30) as resp:
                return json.loads(resp.read())

        fleet = await asyncio.to_thread(fleet_get)
        failures = await stored([n for n, _, _ in pods])
        events = await api.list("Event")
        await operator.stop()
        return {"poked": poked, "wall_s": wall_s, "batches": batches, "stop_url": stop_url,
                "analyses": analyses,
                "keep_url": keep_url, "polled": polled, "fleet": fleet,
                "failures": failures, "events": events}

    semantic.match, index.query, backend.generate = counted_match, counted_query, held_generate
    engine.submit = recorded
    try:
        run = asyncio.run(drive())
    finally:
        semantic.match, index.query, backend.generate = match, query, generate
        engine.submit = submit
    stop_url, keep_url = run["stop_url"], run["keep_url"]
    names_all = [n for n, _, _ in pods]
    failures = run["failures"]
    pod_events: dict = {}
    for e in run["events"]:
        regarding = e.get("regarding") or {}
        if regarding.get("kind") == "Pod":
            pod_events.setdefault(regarding.get("name"), set()).add(e.get("reason"))
    bad = [(n, failures.get(n), responses.get(n) and responses[n].to_dict())
           for n in names_all
           if n not in failures or not responses.get(n) or responses[n].error
           or not responses[n].completion_tokens
           or failures[n]["analysisStatus"] != (
               "Analyzed" if responses[n].explanation else "PatternOnly")
           or (responses[n].explanation and failures[n].get("explanation")
               != responses[n].explanation)
           or pod_events.get(n) != {"PodFailureDetected", "PodmortemAnalysisComplete"}]
    if bad:
        raise fail(f"remote operator: pods without a stored answer: {bad}")
    first, second = run["batches"][0]["pods"], run["batches"][1]["pods"]
    served = {n: responses[n].replica_id for n in names_all}
    requeues = {n: responses[n].requeues for n in names_all}
    first_replicas = {served[n] for n in first}
    failed_over = [n for n in second if owners[n] == stop_url and requeues[n] >= 1]
    stopped_health = run["fleet"]["replicas"].get(stop_url, {})
    backend_router = backend.router_for(replica_set(",".join(
        f"http://127.0.0.1:{p}" for p in ports)))
    breaker = backend_router.health.breakers.for_key(stop_url).state
    stop_errors = backend_router.health.for_replica(stop_url).total_errors
    threshold = config.router_replica_failure_threshold
    if (len(first_replicas) != 2 or any(served[n] != owners[n] for n in first)
            or any(served[n] != keep_url for n in second) or not failed_over
            or breaker != "open" or stop_errors < threshold
            or sorted(run["fleet"]["replicas"]) != sorted([stop_url, keep_url])
            or stopped_health.get("ready") is not False):
        raise fail(f"remote operator: first batch on {first_replicas}, served {served}, "
                   f"owners {owners}, requeues {requeues}, stopped {stop_url} breaker "
                   f"{breaker} after {stop_errors} errors, fleet {run['fleet']}")
    # K1 per step was held per batch; K5 is the operator's: one per
    # semantic analyze() and one per recall query over a non-empty index
    every = [run["analyses"], *(b["launches"] for b in run["batches"])]
    k5 = sum(c["best_window_similarity"] for c in every)
    if (k5 != k5_calls["analyze"] + k5_calls["query"] or k5_calls["analyze"] != len(pods)
            or any(c["paged_decode_attention"] or c["flash_prefill_attention"] for c in every)
            or run["analyses"]["ragged_paged_attention"]):
        raise fail(f"remote operator: launches {every} for {k5_calls}")

    # the greedy explanations against a held replay of the captured engine
    # requests, batch by batch, on the same engine from the same state
    replay: list = []
    for batch in run["batches"]:
        lo, hi = batch["captured"]
        wait_idle(sched)
        sched.spill_cache()
        g._rng.set_state(batch["rng"])
        results_, _ = held_sends(engine, [
            lambda c=c: submit(c[0], c[1], **c[2]).result(timeout=600)
            for c in captured[lo:hi]])
        replay.extend(results_)
    counts()
    drive_results = [c[3].result() for c in captured]
    greedy = [i for i, c in enumerate(captured) if c[1].temperature == 0.0]
    unequal = [(i, drive_results[i].text, replay[i].text) for i in greedy
               if drive_results[i].token_ids != replay[i].token_ids]
    if len(captured) != len(pods) or unequal or not greedy:
        raise fail(f"remote operator: {len(captured)} engine requests; greedy ones differ "
                   f"from the replay: {unequal}")

    # per pod: the stage split, the provider's gate wait taken out of the
    # explain stage, and the HTTP overhead: the successful dispatch span
    # less the serving replica's own request span for the same trace
    server_spans = {}
    for server in servers:
        for record in server.tracer.recorder.traces():
            root = next(sp for sp in record.trace["spans"] if sp["name"].startswith("http "))
            server_spans[record.trace_id] = (root["endNs"] - root["startNs"]) / 1e6
    per_pod: dict = {}
    traces = {r.trace_id: r.trace["spans"] for r in operator.recorder.traces()}
    for record in operator.pipeline.slo_ledger.records:
        spans = traces[record.trace_id]
        root = next(sp for sp in spans if "parentId" not in sp)
        name = root["attributes"]["pod"].split("/")[-1]
        dispatch = [sp for sp in spans if sp["name"] == "router.dispatch"]
        ok = [sp for sp in dispatch if sp["status"] == "ok"][-1]
        stages = record.stages
        store = next(sp for sp in spans if sp["name"] == "store"
                     and sp.get("parentId") == root["spanId"])
        per_pod[name] = {
            "poke_to_stored_ms": (store["endNs"] - run["poked"][name]) / 1e6,
            "held_at_provider_ms": held_ns[name] / 1e6,
            "stages_ms": {"collect": stages.get("collect"), "analyze": stages.get("parse"),
                          "recall": stages.get("recall"),
                          "generate_less_hold": stages.get("explain", 0.0) - held_ns[name] / 1e6,
                          "store": stages.get("store")},
            "dispatch_attempts": len(dispatch),
            "http_overhead_ms": ((ok["endNs"] - ok["startNs"]) / 1e6
                                 - server_spans[record.trace_id]),
        }
    completion = sum(responses[n].completion_tokens for n in names_all)
    active_s = sum((b["done_ns"] - b["released_ns"]) / 1e9 for b in run["batches"])
    out = {
        "pods": len(pods), "owners": owners, "stopped": stop_url, "served": served,
        "requeues": requeues, "failed_over": failed_over, "breaker": breaker,
        "stopped_replica_errors": stop_errors, "fleet_replicas": sorted(run["fleet"]["replicas"]),
        "batches": [{"pods": b["pods"], "steps": b["steps"], "launches": b["launches"],
                     "wall_s": (b["done_ns"] - b["released_ns"]) / 1e9}
                    for b in run["batches"]],
        "k5_calls": k5_calls, "completion_tokens": completion,
        "first_poke_to_drain_s": run["wall_s"],
        "tokens_per_s": completion / run["wall_s"],
        "tokens_per_s_released": completion / active_s,
        "greedy_equal_replay": len(greedy),
        "sampled_equal_replay": all(drive_results[i].token_ids == replay[i].token_ids
                                    for i in range(len(captured))),
        "http_overhead_ms": sorted(p["http_overhead_ms"] for p in per_pod.values()),
        "launches": {"analyses": run["analyses"]},
    }
    print(json.dumps({"remote_operator": out, "card": card}), flush=True)
    print(json.dumps({"remote_operator_per_pod": per_pod, "card": card}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the operator's HA and elastic fleet
# ---------------------------------------------------------------------------

#: the HA drive's lease: a standby takes over 3 s after the leader's last
#: renewal (production runs 15 s / 5 s / 2 s)
FLEET_LEASE_ENV = {"LEASE_DURATION_S": "3", "LEASE_RENEW_PERIOD_S": "0.5",
                   "LEASE_RETRY_PERIOD_S": "0.25"}
#: the HA drive's two AIProviders, both greedy: the short answers are
#: stored while the long ones are still decoding when the leader dies
FLEET_TOKENS = {"short": 32, "long": 192}
#: the elastic drive: ten held analyses put a pressure of 10 (queued +
#: active) on the one replica, past this target
FLEET_TARGET_PRESSURE = 4
FLEET_TICK_S = 0.25
FLEET_IDLE_S = 2.0
#: the synced library's one pattern: it matches ``oom_java.log``
FLEET_SYNCED_PATTERN = "fleet-synced-heap"
#: a phase's waits for the control plane (lease expiry, the autoscaler's
#: ticks, an engine's build) are bounded by this
FLEET_WAIT_S = 120.0


def fleet_resources(model_name: str, provider_id: str, variants: dict,
                    **extra) -> list:
    """One AIProvider per variant (``maxTokens`` as given, greedy, no
    response cache) and a Podmortem selecting ``app=payment`` pods of that
    variant."""
    out = []
    for variant, max_tokens in variants.items():
        spec = {"providerId": provider_id, "modelId": model_name, "maxTokens": max_tokens,
                "temperature": 0.0, "cachingEnabled": False, **extra}
        out.append(("AIProvider", {"metadata": {"name": variant, "namespace": "ops"},
                                   "spec": spec}))
        out.append(("Podmortem", {
            "metadata": {"name": f"watch-payment-{variant}", "namespace": "ops"},
            "spec": {"podSelector": {"matchLabels": {"app": "payment"}, "matchExpressions": [
                         {"key": "variant", "operator": "In", "values": [variant]}]},
                     "aiProviderRef": {"name": variant, "namespace": "ops"},
                     "aiAnalysisEnabled": True}}))
    return out


class PartitionableApi:
    """One replica's view of a shared ``FakeKubeApi``: every call passes
    through, but Lease calls fail while ``partitioned`` (a partition
    between this replica and its Lease), and each successful Podmortem
    status write of an analysis (``recentFailures``) is recorded with its
    time."""

    def __init__(self, api) -> None:
        self._api = api
        self.partitioned = False
        self.status_writes: list = []

    def __getattr__(self, name):
        return getattr(self._api, name)

    def _guard(self, kind: str) -> None:
        from operator_tpu_torch.operator.kubeapi import ApiError

        if self.partitioned and kind == "Lease":
            raise ApiError("partitioned from the apiserver", 503)

    async def get(self, kind, name, namespace):
        self._guard(kind)
        return await self._api.get(kind, name, namespace)

    async def create(self, kind, obj):
        self._guard(kind)
        return await self._api.create(kind, obj)

    async def patch(self, kind, name, namespace, patch, **kw):
        self._guard(kind)
        return await self._api.patch(kind, name, namespace, patch, **kw)

    async def patch_status(self, kind, name, namespace, status, **kw):
        out = await self._api.patch_status(kind, name, namespace, status, **kw)
        if kind == "Podmortem" and status.get("recentFailures"):
            self.status_writes.append((time.monotonic(), name, status))
        return out


class EngineTap:
    """Records every submission to one engine (prompt, params, the
    engine's clock, the future) and holds its admission on demand
    (``hold``/``release``; after ``hold`` give the idle worker 0.2 s to
    read the gated admission, as the other held drives do)."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.submit = engine.submit
        self.admit = engine._admit_submissions
        self.captured: list = []
        self.first_submit_ns: "int | None" = None
        self.gate = threading.Lock()
        engine.submit = self._recorded

    def _recorded(self, prompt, params=None, **kw):
        if self.first_submit_ns is None:
            self.first_submit_ns = time.monotonic_ns()
        future = self.submit(prompt, params, **kw)
        self.captured.append((prompt, params, kw, self.engine.generator._clock(), future))
        return future

    def _gated(self, block: bool) -> None:
        with self.gate:
            self.admit(block)

    def hold(self) -> None:
        # the lock first: the worker only meets the gate once it is shut
        self.gate.acquire()
        self.engine._admit_submissions = self._gated

    def release(self) -> None:
        self.engine._admit_submissions = self.admit
        self.gate.release()

    def close(self) -> None:
        """Give the engine its own submit and admission back, and let go
        of it (the captured requests stay)."""
        if self.engine is not None:
            self.engine.submit = self.submit
            self.engine._admit_submissions = self.admit
        self.engine = self.submit = self.admit = None

    def replay(self, lo: int, hi: int, rng) -> list:
        """The captured requests ``lo:hi`` again on the same engine, held
        until all are queued, from an empty prefix cache and the sampler
        state ``rng``, each deadline moved by one constant (earliest-
        deadline-first admission orders the rows as in the drive)."""
        sched = self.engine.scheduler
        wait_idle(sched)
        sched.spill_cache()
        self.engine.generator._rng.set_state(rng)
        shift = self.engine.generator._clock() - self.captured[lo][3]
        sends = []
        for prompt, params, kw, _, _ in self.captured[lo:hi]:
            if params is not None and params.deadline is not None:
                params = dataclasses.replace(params, deadline=params.deadline + shift)
            sends.append(lambda p=prompt, s=params, k=kw: self.submit(p, s, **k).result(600))
        results, _ = held_sends(self.engine, sends)
        return results


async def fleet_wait(predicate, what: str, timeout_s: float = FLEET_WAIT_S,
                     poll_s: float = 0.002, explain=None) -> float:
    """Wait until ``predicate()``; returns the monotonic time it held.
    On a timeout the failure carries ``explain()``, the state to read."""
    import asyncio

    by = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > by:
            state = explain() if explain is not None else ""
            raise fail(f"fleet: {what} not within {timeout_s} s {state}")
        await asyncio.sleep(poll_s)
    return time.monotonic()


def fleet_ledger(path: str) -> tuple:
    """(key -> claim of the non-terminal claims, the pods whose claim is
    done), read from the claims journal (``operator/claims.py``: claim,
    stage, done, release)."""
    claims: dict = {}
    done: set = set()
    if not os.path.exists(path):
        return claims, done
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            try:
                record = json.loads(line)
            except ValueError:
                continue  # a torn tail line
            op = record.get("op")
            if op == "claim":
                claims[record["claim"]["key"]] = record["claim"]
            elif op in ("done", "release"):
                claim = claims.pop(record.get("key"), None)
                if op == "done" and claim is not None:
                    done.add(claim["pod_name"])
    return claims, done


def fleet_counter(kernel_modules: dict):
    """``counts()``: every kernel's launches since the last call, added to
    ``counts.total`` unless ``path`` is false (a comparison's launches, or
    a build's); then every count is 0.  Every count starts at 0."""
    total = {name: 0 for name in kernel_modules}
    for module in kernel_modules.values():
        module.launches = 0

    def counts(path: bool = True) -> dict:
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for module in kernel_modules.values():
            module.launches = 0
        if path:
            for name, n in launches.items():
                total[name] += n
        return launches

    counts.total = total
    return counts


def counted_k5(operator, k5_calls: dict) -> None:
    """Count what the operator asks of K5: each semantic ``analyze()`` with
    lines and patterns, each recall ``query()`` over a non-empty index."""
    semantic = operator.engine.semantic
    index = operator.memory.index if operator.memory is not None else None
    match = semantic.match

    def counted_match(lines):
        k5_calls["analyze"] += bool(lines) and semantic.num_patterns > 0
        return match(lines)

    semantic.match = counted_match
    if index is not None:
        query = index.query

        def counted_query(text, k=3):
            k5_calls["query"] += len(index) > 0 and bool(text.strip())
            return query(text, k)

        index.query = counted_query


def fleet_pods(prefix: str, variants: tuple, count: int = OPERATOR_PODS) -> list:
    """(name, variant, log) of ``count`` pods, one per fixture log (the
    first ``count`` by name), variants taken in turn."""
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[:count]
    return [(f"{prefix}-{i}", variants[i % len(variants)], "\n".join(fixture_lines(name)))
            for i, name in enumerate(names)]


async def fleet_poke(api, name: str, variant: str, log: str, finished_at: str,
                     timeout_s: float) -> None:
    """A failing pod, poked with the MODIFIED patch the watcher reacts to."""
    import asyncio

    api.set_pod_log("prod", name, log, previous=True)
    await asyncio.wait_for(api.create("Pod", operator_pod(name, variant, finished_at)),
                           timeout=timeout_s)
    await asyncio.wait_for(
        api.patch("Pod", name, "prod", {"metadata": {"labels": {"poked": "1"}}}),
        timeout=timeout_s)


async def fleet_stored(api) -> dict:
    """podName -> its recentFailures entries, over every Podmortem."""
    out: dict = {}
    for cr in await api.list("Podmortem", "ops"):
        for entry in (cr.get("status") or {}).get("recentFailures") or []:
            out.setdefault(entry["podName"], []).append(entry)
    return out


def fleet_takeover(dirs: dict, counts, layers: int, card: str) -> dict:
    """(a) Two ``Operator``s (``op-a``, ``op-b``) with leader election over
    one ``FakeKubeApi``, one claims ledger and one ``tpu-native`` engine.
    Ten pods fail, the admission held until all ten are queued; once the
    leader has stored an analysis and still has rows on the engine, it is
    partitioned from its Lease and its tasks are cancelled without
    ``release()``.  The standby takes the lease, resumes the leader's
    non-terminal claims (its engine admission held until all are queued)
    and stores them."""
    import asyncio

    from operator_tpu_torch.operator import FakeKubeApi, Operator, default_registry
    from operator_tpu_torch.operator.lease import parse_micro
    from operator_tpu_torch.operator.storage import ANNOTATION_ANALYZED_FAILURE
    from operator_tpu_torch.serving.provider import build_tpu_native_provider
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    env = {**CHECKPOINT_ENV, "MODEL_ID": CHECKPOINT_ENV["OPERATOR_TPU_MODEL"],
           "CHECKPOINT_DIR": dirs["llm"], "ENCODER_CHECKPOINT_DIR": dirs["encoder"],
           "PATTERN_CACHE_DIRECTORY": os.path.join(dirs["workdir"], "no-pattern-cache"),
           "CLAIMS_PATH": os.path.join(dirs["workdir"], "fleet-claims.jsonl"),
           "HEALTH_PORT": "-1", "ROUTER_HEALTH_POLL_S": "0", "LEADER_ELECTION": "true",
           **FLEET_LEASE_ENV}
    provider = build_tpu_native_provider("cuda", env)
    engine = provider.engine
    sched = engine.scheduler
    shared = FakeKubeApi()
    shared.namespace = "ops"
    ops, apis = {}, {}
    for name in ("op-a", "op-b"):
        registry = default_registry()
        registry.register("tpu-native", provider)
        apis[name] = PartitionableApi(shared)
        ops[name] = Operator(apis[name], config=OperatorConfig.from_env({**env, "POD_NAME": name}),
                             providers=registry, metrics=MetricsRegistry())
    a, b = ops["op-a"], ops["op-b"]
    timeout = a.config.kube_call_timeout_s
    k5_calls = {"analyze": 0, "query": 0}
    for operator in ops.values():
        counted_k5(operator, k5_calls)
    pods = fleet_pods("payment", tuple(FLEET_TOKENS))
    # each pod's final answer (the standby's, for a resumed pod)
    answers: dict = {}
    generate = provider.generate

    async def answered(request):
        response = await generate(request)
        answers[request.failure_data.pod.metadata.name] = response
        return response

    provider.generate = answered
    engine.warmup()
    asyncio.run(generate(provider_requests()[0]))
    wait_idle(sched)
    tap = EngineTap(engine)

    async def drive() -> dict:
        for kind, obj in fleet_resources(engine.generator.config.name, "tpu-native", FLEET_TOKENS):
            await asyncio.wait_for(shared.create(kind, obj), timeout=timeout)
        await a.start()
        await fleet_wait(lambda: a.elector.is_leader and bool(a._control_tasks), "op-a leading")
        await b.start()
        await asyncio.sleep(0.5)  # a live leader renews: the standby waits
        if b.elector.is_leader:
            raise fail("fleet takeover: the standby took a live leader's lease")
        if not await a.cr_cache.wait_ready(FLEET_WAIT_S):
            raise fail("fleet takeover: op-a's Podmortem cache never primed")
        sched.spill_cache()
        counts(path=False)
        steps0 = sched.steps
        tap.hold()
        try:
            await asyncio.sleep(0.2)  # the idle worker reads the gated admission
            started = time.monotonic_ns()
            for i, (name, variant, log) in enumerate(pods):
                await fleet_poke(shared, name, variant, log, f"2026-07-28T09:{i:02d}:00Z", timeout)
            await fleet_wait(lambda: engine._submissions.qsize() >= len(pods),
                             "the leader's ten requests queued")
            rng_a = engine.generator._rng.get_state()
        finally:
            tap.release()
        # the leader dies once it has stored an answer, each stored pod's
        # claim is done on disk (else the standby redoes a pod stored
        # without the durable marker: a blank answer), and it still decodes
        def stored_and_done() -> bool:
            writes = apis["op-a"].status_writes
            if len(writes) == len(pods):
                return True
            stored = {w[2]["recentFailures"][0]["podName"] for w in writes}
            return (bool(stored) and sched.num_active > 0
                    and stored <= fleet_ledger(env["CLAIMS_PATH"])[1])

        await fleet_wait(stored_and_done, "the leader's first stored analysis", poll_s=0.002)
        if len(apis["op-a"].status_writes) == len(pods):
            raise fail("fleet takeover: the leader stored every pod before the kill")
        killed_wall, killed = time.time(), time.monotonic()
        apis["op-a"].partitioned = True
        a.pipeline.claims.abandon()
        dead = [*a._tasks, *a._control_tasks]
        for task in dead:
            task.cancel()
        a.watcher.cancel_inflight()
        await asyncio.gather(*dead, return_exceptions=True)
        await a.watcher.drain()
        captured_a = len(tap.captured)
        cancelled = sum(c[4].cancelled() for c in tap.captured)
        # the cancelled generations leave the engine: rows and pages back
        await fleet_wait(lambda: sched.num_active == 0 and sched.queue_depth == 0
                         and not engine._pending, "the deposed leader's rows released")
        released = balanced(sched, "after the leader's kill")
        # what the standby must redo: the ledger's non-terminal claims
        # whose pod lacks the durable marker (a stored answer with text)
        pending, _ = fleet_ledger(env["CLAIMS_PATH"])
        resumable = 0
        for claim in pending.values():
            pod = await shared.get("Pod", claim["pod_name"], claim["pod_namespace"])
            marker = (pod["metadata"].get("annotations") or {}).get(ANNOTATION_ANALYZED_FAILURE)
            resumable += marker != claim["failure_time"]

        def state() -> str:
            counters = {k: v for k, v in b.metrics.snapshot()["counters"].items()
                        if not k.startswith(("slo_", "router_"))}
            events = sorted((e.get("reason"), (e.get("note") or "")[:80])
                            for e in shared._bucket("Event").values()
                            if e.get("reason") != "PodFailureDetected")
            return (f"(captured {len(tap.captured)} of {captured_a} + {resumable}, queued "
                    f"{engine._submissions.qsize()}, active {sched.num_active}, standby "
                    f"leading {b.elector.is_leader}, control {len(b._control_tasks)}, "
                    f"writes {len(apis['op-b'].status_writes)}, counters {counters}, "
                    f"events {events})")

        tap.hold()
        try:
            await asyncio.sleep(0.2)
            sched.spill_cache()
            await fleet_wait(lambda: b.elector.is_leader, "the standby's takeover",
                             explain=state)
            await fleet_wait(lambda: len(tap.captured) >= captured_a + resumable,
                             "the standby's resumed requests queued", explain=state)
            rng_b = engine.generator._rng.get_state()
        finally:
            tap.release()
        await fleet_wait(lambda: len(apis["op-b"].status_writes) >= resumable,
                         "the standby's stored analyses", explain=state)
        await fleet_wait(lambda: bool(b._control_tasks), "the standby's control loops")
        await b.watcher.drain()
        wait_idle(sched)
        wall_s = (time.monotonic_ns() - started) / 1e9
        steps, launches = sched.steps - steps0, counts()
        lease = (await shared.get("Lease", b.config.lease_name, "ops"))["spec"]
        stored = await fleet_stored(shared)
        await b.stop()
        released_lease = (await shared.get("Lease", b.config.lease_name, "ops"))["spec"]
        return {"rng": (rng_a, rng_b), "captured_a": captured_a, "cancelled": cancelled,
                "killed_wall": killed_wall, "killed": killed, "resumable": resumable,
                "released": released,
                "steps": steps, "launches": launches, "wall_s": wall_s, "lease": lease,
                "released_lease": released_lease, "stored": stored}

    try:
        run = asyncio.run(drive())
    finally:
        provider.generate = generate
    # every pod: one recentFailures entry and one successful status write
    stored, writes = run["stored"], [w for api in apis.values() for w in api.status_writes]
    names = [name for name, _, _ in pods]
    entries = {name: len(stored.get(name, [])) for name in names}
    if any(n != 1 for n in entries.values()) or len(writes) != len(pods):
        raise fail(f"fleet takeover: entries per pod {entries}, {len(writes)} status writes")
    resumed = b.metrics.counter("claims_resumed")
    if (resumed != run["resumable"] or run["lease"]["holderIdentity"] != "op-b"
            or run["released_lease"]["holderIdentity"] != ""):
        raise fail(f"fleet takeover: {resumed} claims resumed of {run['resumable']}, lease "
                   f"{run['lease']} then {run['released_lease']}")
    launches, steps = run["launches"], run["steps"]
    k5 = k5_calls["analyze"] + k5_calls["query"]
    if (launches["ragged_paged_attention"] != layers * steps or not steps
            or launches["best_window_similarity"] != k5
            or launches["paged_decode_attention"] or launches["flash_prefill_attention"]):
        raise fail(f"fleet takeover: launches {launches} over {steps} steps, K5 calls {k5_calls}")
    # the greedy answers against a held replay of each leader's batch
    counts(path=False)
    rng_a, rng_b = run["rng"]
    replay_a = tap.replay(0, run["captured_a"], rng_a)
    replay_b = (tap.replay(run["captured_a"], len(tap.captured), rng_b)
                if len(tap.captured) > run["captured_a"] else [])
    tap.close()
    counts(path=False)  # the replays' launches are not the path's
    by_prompt = {}
    for (prompt, _, _, _, future), again in zip(tap.captured, replay_a + replay_b):
        if not future.cancelled() and future.exception() is None:
            by_prompt[prompt] = (future.result().token_ids, again.token_ids)
    unequal = [p[:60] for p, (got, want) in by_prompt.items() if got != want]
    a_writer = {w[2]["recentFailures"][0]["podName"] for w in apis["op-a"].status_writes}
    if unequal or len(by_prompt) < len(pods):
        raise fail(f"fleet takeover: {len(unequal)} greedy answers differ from the replay "
                   f"({len(by_prompt)} compared): {unequal}")
    completion = sum(answers[n].completion_tokens for n in names)
    first_resumed = min(t for t, _, _ in apis["op-b"].status_writes)
    out = {
        "card": card, "pods": len(pods), "stored_by_leader": sorted(a_writer),
        "claims_resumed": resumed, "cancelled_generations": run["cancelled"],
        "pages_after_kill": run["released"],
        "kill_to_lease_s": parse_micro(run["lease"]["acquireTime"]) - run["killed_wall"],
        "kill_to_first_resumed_stored_s": first_resumed - run["killed"],
        "steps": steps, "launches": launches, "k5_calls": k5_calls,
        "completion_tokens": completion, "first_poke_to_drain_s": run["wall_s"],
        "tokens_per_s": completion / run["wall_s"], "greedy_equal_replay": len(by_prompt),
    }
    print(json.dumps({"fleet_takeover": out}), flush=True)
    engine.close()
    return out


def fleet_elastic(dirs: dict, counts, layers: int, card: str) -> dict:
    """(b) One ``Operator`` with endpoint discovery and the autoscaler over
    a serving Deployment at one replica.  A small kubelet follows the
    Deployment's ``spec.replicas``: for a new replica it builds an engine
    from the checkpoint on the card, serves it with a ``CompletionServer``
    on an ephemeral port and adds one Endpoints subset; for a removed one
    it drops the subset, then stops the server and closes the engine.  Ten
    pods fail against replica A, their requests held there until B has
    joined; twelve more go to both, held per replica until all are
    queued; the idle fleet then scales back to one."""
    import asyncio
    import gc

    import torch

    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    engine_env = {**CHECKPOINT_ENV, "CHECKPOINT_DIR": dirs["llm"]}
    config = OperatorConfig.from_env({
        "ENCODER_CHECKPOINT_DIR": dirs["encoder"],
        "PATTERN_CACHE_DIRECTORY": os.path.join(dirs["workdir"], "no-pattern-cache"),
        "HEALTH_PORT": "0", "HEALTH_HOST": "127.0.0.1", "INCIDENTS_API_TOKEN": "fleet",
        "DISCOVERY_ENABLED": "true", "DISCOVERY_SERVICE": "podmortem-serving",
        "AUTOSCALE_ENABLED": "true", "AUTOSCALE_DEPLOYMENT": "podmortem-serving",
        "AUTOSCALE_MIN_REPLICAS": "1", "AUTOSCALE_MAX_REPLICAS": "2",
        "AUTOSCALE_INTERVAL_S": str(FLEET_TICK_S),
        "AUTOSCALE_TARGET_PRESSURE": str(FLEET_TARGET_PRESSURE),
        "ROUTER_HEALTH_POLL_S": str(FLEET_TICK_S), "SCALE_TO_ZERO_IDLE_S": str(FLEET_IDLE_S),
        # the held batches queue ten at a replica: above the overload
        # ladder's default shed line (8), which would drop the last ones
        # to pattern-only answers whenever a poll lands mid-batch
        "SHED_PRESSURE": "64",
        "WATCH_RESTART_DELAY_S": "0.1"})
    api = FakeKubeApi()
    api.namespace = "ops"
    timeout = config.kube_call_timeout_s
    model_id = CHECKPOINT_ENV["OPERATOR_TPU_MODEL"]
    http = HttpLoop()
    replicas: dict = {}  # name -> engine, server, port, the build's numbers
    taps: dict = {}  # name -> EngineTap (kept after the replica is gone)
    timeline: dict = {}
    k1 = "ragged_paged_attention"

    def start_replica(name: str) -> dict:
        """An engine from the checkpoint on the card, warmed and served on
        an ephemeral port; returns once ``/healthz`` answers.  The warmup's
        K1 launches are the build's, not the path's (the other replica's
        admission is held meanwhile, so none of them is a step's)."""
        t0 = time.monotonic()
        counts()
        allocated = torch.cuda.memory_allocated()
        engine, _ = build_serving_engine("cuda", engine_env)
        engine.warmup()
        built_bytes = torch.cuda.memory_allocated() - allocated
        warmup = counts(path=False)
        for kernel, n in warmup.items():
            counts.total[kernel] += 0 if kernel == k1 else n
        server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0,
                                  replica_id=name)
        http.run(server.start())
        status = healthz(server.bound_port).get("status")
        taps[name] = EngineTap(engine)
        replicas[name] = {"engine": engine, "server": server, "port": server.bound_port,
                          "url": f"http://127.0.0.1:{server.bound_port}",
                          "steps0": engine.scheduler.steps, "start_s": time.monotonic() - t0,
                          "warmup_launches": warmup, "healthz": status,
                          "built_bytes": built_bytes}
        return replicas[name]

    def stop_replica(name: str) -> dict:
        replica = replicas[name]
        before = torch.cuda.memory_allocated()
        taps[name].close()
        http.run(replica.pop("server").stop(), timeout=120)
        engine = replica.pop("engine")
        engine.close()
        replica["steps"] = engine.scheduler.steps - replica["steps0"]
        del engine
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return {"allocated_before": before, "allocated_after": torch.cuda.memory_allocated()}

    def subset(port: int) -> dict:
        return {"addresses": [{"ip": "127.0.0.1"}], "ports": [{"name": "http", "port": port}]}

    async def set_subsets(names: list) -> None:
        await asyncio.wait_for(api.patch("Endpoints", "podmortem-serving", "ops", {
            "subsets": [subset(replicas[n]["port"]) for n in names]}), timeout=timeout)

    async def kubelet() -> None:
        """Follow the Deployment's spec.replicas: one subset per replica."""
        _, cursor = await api.list_rv("Deployment", "ops")
        async for event in api.watch("Deployment", "ops", resource_version=cursor):
            want = int((event.object.get("spec") or {}).get("replicas") or 0)
            live = sorted(n for n, r in replicas.items() if "engine" in r)
            if want > len(live) and "replica-b" not in replicas:
                timeline["patched_up"] = time.monotonic()
                await asyncio.to_thread(start_replica, "replica-b")
                timeline["b_ready"] = time.monotonic()
                await set_subsets(["replica-a", "replica-b"])
            elif want < len(live) and "replica-b" in live:
                timeline["patched_down"] = time.monotonic()
                await set_subsets(["replica-a"])
                timeline["b_memory"] = await asyncio.to_thread(stop_replica, "replica-b")
                timeline["b_stopped"] = time.monotonic()

    # a Podmortem's status keeps its newest ten entries: one Podmortem for
    # the first batch, two for the later one.  The later pods take every
    # fixture log, so their twelve fingerprints (the router's affinity
    # keys) spread over both replicas' ring arcs (all twelve on one arc
    # is under 1 % likely at an even split); their logs repeat the first
    # ones', and cachingEnabled: false keeps the recall hits from reusing
    # the first answers
    pods = fleet_pods("payment", ("first",))
    later = fleet_pods("payment-later", ("later", "later-b"),
                       count=len([n for n in os.listdir(FIXTURES) if n.endswith(".log")]))
    stored_names: list = []
    try:
        a = start_replica("replica-a")
        operator = Operator(api, config=config, metrics=MetricsRegistry())
        k5_calls = {"analyze": 0, "query": 0}
        counted_k5(operator, k5_calls)
        backend = operator._http_backend
        decisions: list = []
        tick = operator.autoscaler.tick

        async def recorded_tick():
            """Every verdict but a hold; a repeat of the last one only
            counts."""
            decision = await tick()
            if decision.action == "hold":
                return decision
            if decisions and tuple(decisions[-1][1:3]) == (decision.desired, decision.action):
                decisions[-1][4] += 1
            else:
                decisions.append([time.monotonic(), decision.desired, decision.action,
                                  decision.reason, 1])
            return decision

        operator.autoscaler.tick = recorded_tick
        prewarmed: list = []
        prewarm = operator.discovery.prewarm

        async def recorded_prewarm(replica):
            ok = await prewarm(replica)
            prewarmed.append((replica.id, ok))
            return ok

        operator.discovery.prewarm = recorded_prewarm
        store = operator.storage.store_to_podmortem_status

        async def recorded_store(podmortem, pod, *args, **kw):
            out = await store(podmortem, pod, *args, **kw)
            stored_names.append(pod.metadata.name)
            return out

        operator.storage.store_to_podmortem_status = recorded_store
        # the first time the fleet rollup's pressure reaches the target
        crossed: dict = {}

        async def watch_pressure() -> None:
            while True:
                pressure = (backend.fleet_view().get("fleet") or {}).get("pressure")
                if pressure is not None and pressure >= FLEET_TARGET_PRESSURE:
                    crossed.setdefault("at", time.monotonic())
                await asyncio.sleep(0.005)

        async def fleet_get() -> dict:
            url = f"http://127.0.0.1:{operator.health_server.bound_port}/fleet"

            def get():
                request = urllib.request.Request(url, headers={"Authorization": "Bearer fleet"})
                with urllib.request.urlopen(request, timeout=30) as resp:
                    return json.loads(resp.read())

            return await asyncio.to_thread(get)

        async def batch(pods_: list, names: list, what: str, *, until=None) -> list:
            """Poke the pods, each named replica's admission held until all
            their requests are queued (and ``until()`` holds); returns
            (replica, lo, hi, sampler state) per replica."""
            lows = {n: len(taps[n].captured) for n in names}
            for n in names:
                taps[n].hold()
            try:
                await asyncio.sleep(0.2)  # the idle workers read the gated admission
                timeline.setdefault(f"{what} poked", time.monotonic())
                for i, (name, variant, log) in enumerate(pods_):
                    await fleet_poke(api, name, variant, log, f"2026-07-28T11:{i:02d}:00Z",
                                     timeout)
                await fleet_wait(lambda: sum(len(taps[n].captured) - lows[n] for n in names)
                                 >= len(pods_), f"{what}'s requests queued")
                if until is not None:
                    await until()
                return [(n, lows[n], len(taps[n].captured),
                         replicas[n]["engine"].generator._rng.get_state()) for n in names]
            finally:
                for n in names:
                    taps[n].release()

        async def b_joined() -> None:
            await fleet_wait(lambda: "replica-b" in replicas and replicas["replica-b"]["url"]
                             in operator.discovery.members(), "replica B's join")
            timeline["b_joined"] = time.monotonic()

        async def drive() -> dict:
            await asyncio.wait_for(api.create("Deployment", {
                "metadata": {"name": "podmortem-serving", "namespace": "ops"},
                "spec": {"replicas": 1}}), timeout=timeout)
            await asyncio.wait_for(api.create("Endpoints", {
                "metadata": {"name": "podmortem-serving", "namespace": "ops"},
                "subsets": [subset(a["port"])]}), timeout=timeout)
            for kind, obj in fleet_resources(model_id, "openai-compatible",
                                             {"first": MAX_TOKENS, "later": MAX_TOKENS,
                                              "later-b": MAX_TOKENS},
                                             maxRetries=3, timeoutSeconds=300):
                await asyncio.wait_for(api.create(kind, obj), timeout=timeout)
            side = [asyncio.create_task(kubelet()), asyncio.create_task(watch_pressure())]
            try:
                await operator.start()
                await fleet_wait(lambda: operator.discovery.members() == [a["url"]],
                                 "replica A's join")
                a["engine"].scheduler.spill_cache()
                counts(path=False)
                started = time.monotonic_ns()
                first = await batch(pods, ["replica-a"], "the first batch", until=b_joined)
                await fleet_wait(lambda: len(stored_names) >= len(pods), "the first batch stored")
                b = replicas["replica-b"]
                for replica in (a, b):
                    wait_idle(replica["engine"].scheduler)
                    replica["engine"].scheduler.spill_cache()
                second = await batch(later, ["replica-a", "replica-b"], "the second batch")
                await fleet_wait(lambda: len(stored_names) >= len(pods) + len(later),
                                 "the second batch stored")
                await operator.watcher.drain()
                wall_s = (time.monotonic_ns() - started) / 1e9
                for replica in (a, b):
                    wait_idle(replica["engine"].scheduler)
                counts()
                steps = {n: r["engine"].scheduler.steps - r["steps0"] for n, r in replicas.items()}
                scaled_up = await fleet_get()
                # the held replays, on the engine that served each request
                replays = [(n, lo, await asyncio.to_thread(taps[n].replay, lo, hi, rng))
                           for n, lo, hi, rng in first + second if hi > lo]
                counts(path=False)
                idle_from = time.monotonic()
                await fleet_wait(lambda: "b_stopped" in timeline, "the scale-down")
                await fleet_wait(lambda: operator.discovery.members() == [a["url"]],
                                 "replica B's leave")
                scaled_down = await fleet_get()
                stored = await fleet_stored(api)
                await operator.stop()
            finally:
                for task in side:
                    task.cancel()
                await asyncio.gather(*side, return_exceptions=True)
            return {"first": first, "second": second, "wall_s": wall_s, "steps": steps,
                    "replays": replays, "idle_from": idle_from, "fleet_up": scaled_up,
                    "fleet_down": scaled_down, "stored": stored}

        run = asyncio.run(drive())
    finally:
        for name, replica in list(replicas.items()):
            if "engine" in replica:
                taps[name].close()
                replica["engine"].close()
        http.stop()
    names = [n for n, _, _ in pods + later]
    missing = [n for n in names if len(run["stored"].get(n, [])) != 1]
    ups = [d for d in decisions if d[2] == "up"]
    downs = [d for d in decisions if d[2] == "down"]
    b = replicas["replica-b"]
    if missing or not ups or "fleet_pressure" not in ups[0][3] or not downs or not crossed:
        raise fail(f"fleet elastic: pods without one entry {missing}, decisions {decisions}, "
                   f"pressure crossing {crossed}")
    if [ok for rid, ok in prewarmed if rid == b["url"]] != [True]:
        raise fail(f"fleet elastic: replica B was not prewarmed once before its join: {prewarmed}")
    later_per_replica = {n: hi - lo for n, lo, hi, _ in run["second"]}
    routing = {k: v for k, v in operator.metrics.snapshot()["counters"].items()
               if k.startswith(("router_", "ring_"))}
    if 0 in later_per_replica.values():
        raise fail(f"fleet elastic: the later pods all went to one replica: {later_per_replica}; "
                   f"router counters {routing}")
    # B's stop must give back (nearly) what its build took: the fleet is
    # idle then, while the build shared the card with the first batch's
    # analyses
    memory = timeline["b_memory"]
    freed = memory["allocated_before"] - memory["allocated_after"]
    if b["built_bytes"] <= 0 or freed < 0.9 * b["built_bytes"]:
        raise fail(f"fleet elastic: replica B's memory not freed: its build took "
                   f"{b['built_bytes']} bytes, its stop gave back {freed} ({memory})")
    launches, steps = counts.total, sum(run["steps"].values())
    k5 = k5_calls["analyze"] + k5_calls["query"]
    if (launches[k1] != layers * steps or not steps or launches["best_window_similarity"] != k5
            or launches["paged_decode_attention"] or launches["flash_prefill_attention"]):
        raise fail(f"fleet elastic: launches {launches} over {run['steps']} steps, "
                   f"K5 calls {k5_calls}")
    # the greedy answers against the held replays, engine by engine
    unequal, compared = [], 0
    for name, lo, results_ in run["replays"]:
        for (prompt, _, _, _, future), again in zip(taps[name].captured[lo:], results_):
            compared += 1
            if future.result().token_ids != again.token_ids:
                unequal.append((name, prompt[:60]))
    if unequal or compared != len(names):
        raise fail(f"fleet elastic: {len(unequal)} of {compared} greedy answers differ from "
                   f"the replay: {unequal}")
    out = {
        "card": card, "pods": len(names), "target_pressure": FLEET_TARGET_PRESSURE,
        "decisions": [{"at_s": t - crossed["at"], "desired": d, "action": act, "reason": why,
                       "ticks": n} for t, d, act, why, n in decisions],
        "scale_up_reaction_s": timeline["patched_up"] - crossed["at"],
        "replica_start_s": b["start_s"],
        # the later batch is poked once the first is stored: the first
        # routed request's wait after the join is the drive's schedule;
        # from the poke it is the operator's own path to the new replica
        "join_to_first_routed_s": taps["replica-b"].first_submit_ns / 1e9 - timeline["b_joined"],
        "later_poke_to_first_routed_on_b_s": (taps["replica-b"].first_submit_ns / 1e9
                                              - timeline["the second batch poked"]),
        "idle_to_scale_down_patch_s": timeline["patched_down"] - run["idle_from"],
        "scale_down_patch_to_stopped_s": timeline["b_stopped"] - timeline["patched_down"],
        "later_per_replica": later_per_replica, "replica_b_built_bytes": b["built_bytes"],
        "replica_b_freed_bytes": freed, "replica_b_memory": memory,
        "fleet_scaled_up": {k: run["fleet_up"].get(k) for k in (
            "fleetSize", "desiredReplicas", "lastScaleReason")},
        "fleet_scaled_down": {k: run["fleet_down"].get(k) for k in (
            "fleetSize", "desiredReplicas", "lastScaleReason")},
        "steps": run["steps"], "launches": dict(launches),
        "b_warmup_launches": b["warmup_launches"], "k5_calls": k5_calls,
        "first_poke_to_drain_s": run["wall_s"], "greedy_equal_replay": compared,
    }
    print(json.dumps({"fleet_elastic": out}), flush=True)
    return out


def fleet_pattern_sync(dirs: dict, counts, layers: int, card: str) -> dict:
    """(c) A PatternLibrary CR naming a local git repository that holds one
    library whose pattern matches ``oom_java.log``: the reconciler clones
    it at ``start()``, the engine reloads and the semantic matcher
    re-embeds on the card; the next analysis names the synced pattern and
    K5 runs at the new pattern count."""
    import asyncio

    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    git = shutil.which("git")
    if git is None:
        note = "skipped: git is not installed on this machine (a host tool, not the device)"
        print(json.dumps({"fleet_pattern_sync": note, "card": card}), flush=True)
        return {"skipped": note}
    remote = os.path.join(dirs["workdir"], "patterns-remote")
    os.makedirs(remote, exist_ok=True)
    with open(os.path.join(remote, "fleet.yaml"), "w") as fh:
        json.dump({"metadata": {"libraryId": "fleet-team"}, "patterns": [{
            "id": FLEET_SYNCED_PATTERN, "name": "Synced: Java heap exhausted",
            "severity": "CRITICAL",
            "primaryPattern": {"regex": "java\\.lang\\.OutOfMemoryError", "confidence": 0.99},
        }]}, fh)  # JSON is YAML
    git_env = {"GIT_AUTHOR_NAME": "fleet", "GIT_AUTHOR_EMAIL": "fleet@localhost",
               "GIT_COMMITTER_NAME": "fleet", "GIT_COMMITTER_EMAIL": "fleet@localhost",
               "HOME": dirs["workdir"], "PATH": os.environ.get("PATH", "")}
    for args in (["init", "-q", "-b", "main"], ["add", "-A"], ["commit", "-q", "-m", "fleet"]):
        subprocess.run([git, *args], cwd=remote, env=git_env, check=True, capture_output=True,
                       timeout=60)
    config = OperatorConfig.from_env({
        "ENCODER_CHECKPOINT_DIR": dirs["encoder"], "HEALTH_PORT": "-1",
        "PATTERN_CACHE_DIRECTORY": os.path.join(dirs["workdir"], "pattern-cache"),
        "MEMORY_ENABLED": "false"})
    operator = Operator(FakeKubeApi(), config=config, metrics=MetricsRegistry())
    api, semantic = operator.api, operator.engine.semantic
    timeout = config.kube_call_timeout_s
    patterns_before = semantic.num_patterns
    analyses: list = []
    analyze = operator.engine.analyze

    def recorded_analyze(data):
        result = analyze(data)
        analyses.append(result)
        return result

    operator.engine.analyze = recorded_analyze
    k5 = StreamSpans(semantic_module.best_window_scores)

    async def drive() -> dict:
        for kind, obj in fleet_resources("template", "template", {"synced": 32}):
            await asyncio.wait_for(api.create(kind, obj), timeout=timeout)
        await asyncio.wait_for(api.create("PatternLibrary", {
            "metadata": {"name": "team-patterns", "namespace": "ops"},
            "spec": {"repositories": [{"name": "local", "url": remote, "branch": "main"}],
                     "refreshInterval": "1h"}}), timeout=timeout)
        started = time.monotonic()
        await operator.start()
        await fleet_wait(lambda: semantic.num_patterns > patterns_before,
                         "the synced library's re-embedding")
        synced_s = time.monotonic() - started
        status = (await api.get("PatternLibrary", "team-patterns", "ops")).get("status") or {}
        counts(path=False)
        semantic_module.best_window_scores = k5
        try:
            await fleet_poke(api, "payment-synced", "synced", "\n".join(fixture_lines(
                "oom_java.log")), "2026-07-28T12:00:00Z", timeout)
            await fleet_wait(lambda: analyses, "the analysis after the sync")
            await operator.watcher.drain()
        finally:
            semantic_module.best_window_scores = k5.fn
        launches = counts()
        stored = await fleet_stored(api)
        await operator.stop()
        return {"status": status, "synced_s": synced_s, "launches": launches, "stored": stored}

    run = asyncio.run(drive())
    status, launches = run["status"], run["launches"]
    events = [e.matched_pattern.id for e in analyses[-1].events]
    repos = [(r.get("name"), r.get("status")) for r in status.get("syncedRepositories") or []]
    k5_patterns = [args[1].shape[0] for _, _, args, _ in k5.calls]
    if (FLEET_SYNCED_PATTERN not in events or repos != [("local", "Synced")]
            or status.get("phase") != "Ready" or k5_patterns != [patterns_before + 1]
            or launches["best_window_similarity"] != 1 or launches["ragged_paged_attention"]
            or len(run["stored"].get("payment-synced", [])) != 1):
        raise fail(f"fleet pattern sync: events {events}, status {status}, K5 over "
                   f"{k5_patterns} patterns (before {patterns_before}), launches {launches}")
    out = {"card": card, "patterns_before": patterns_before, "patterns_after": k5_patterns[0],
           "events": events, "status": {k: status.get(k) for k in (
               "phase", "message", "availableLibraries", "syncedRepositories")},
           "start_to_reembedded_s": run["synced_s"], "launches": launches,
           "stored": run["stored"]["payment-synced"][0].get("explanation")}
    print(json.dumps({"fleet_pattern_sync": out}), flush=True)
    return out


#: ``python -m operator_tpu_torch.operator`` as the deployed entry point
#: runs it, plus an exit hook that writes the process's kernel launch
#: counts and its engine's steps to ``FLEET_COUNTS_PATH``
FLEET_LAUNCHER = """
import atexit, importlib, json, os, runpy
from operator_tpu_torch.ops import flash_prefill, ragged_attention, similarity
paged_attention = importlib.import_module("operator_tpu_torch.ops.paged_attention")
from operator_tpu_torch.serving import provider
built = []
build = provider.build_tpu_native_provider
def recorded(*args, **kwargs):
    built.append(build(*args, **kwargs))
    return built[-1]
provider.build_tpu_native_provider = recorded
def dump():
    modules = {"ragged_paged_attention": ragged_attention,
               "paged_decode_attention": paged_attention,
               "flash_prefill_attention": flash_prefill, "best_window_similarity": similarity}
    with open(os.environ["FLEET_COUNTS_PATH"], "w") as fh:
        json.dump({"launches": {n: m.launches for n, m in modules.items()},
                   "steps": [b.engine.scheduler.steps for b in built]}, fh)
atexit.register(dump)
runpy.run_module("operator_tpu_torch.operator", run_name="__main__", alter_sys=True)
"""


def fleet_cli(dirs: dict, counts, layers: int, card: str) -> dict:
    """(d) ``python -m operator_tpu_torch.operator`` (no ``--demo``:
    ``_run_real``) in a process of its own, with ``KUBECONFIG`` naming a
    stub apiserver served here (``kubefacade.KubeFacade``: a
    ``FakeKubeApi`` behind the paths ``HttpKubeApi`` builds), leader
    election on and ``providerId: tpu-native`` on the checkpoints: one
    failing pod is stored through HTTP, SIGTERM exits 0 and the Lease is
    released."""
    import signal

    from operator_tpu_torch.operator.kubefacade import KubeFacade

    facade = KubeFacade(namespace="ops").start()
    api = facade.api
    workdir = dirs["workdir"]
    counts_path = os.path.join(workdir, "fleet-cli-counts.json")
    log_path = os.path.join(workdir, "fleet-cli.log")
    env = {k: v for k, v in os.environ.items() if k != "KUBERNETES_SERVICE_HOST"}
    env.update(CHECKPOINT_ENV)
    env.update({
        "KUBECONFIG": facade.write_kubeconfig(os.path.join(workdir, "kubeconfig")),
        "CHECKPOINT_DIR": dirs["llm"], "ENCODER_CHECKPOINT_DIR": dirs["encoder"],
        "MODEL_ID": CHECKPOINT_ENV["OPERATOR_TPU_MODEL"], "LEADER_ELECTION": "true",
        "POD_NAME": "op-cli", "HEALTH_PORT": "-1",
        "PATTERN_CACHE_DIRECTORY": os.path.join(workdir, "no-pattern-cache"),
        "CLAIMS_PATH": os.path.join(workdir, "fleet-cli-claims.jsonl"),
        "FLEET_COUNTS_PATH": counts_path, "PYTHONPATH": ROOT})
    proc = None
    try:
        async def seed() -> None:
            for kind, obj in fleet_resources(CHECKPOINT_ENV["OPERATOR_TPU_MODEL"], "tpu-native",
                                             {"cli": MAX_TOKENS}):
                await api.create(kind, obj)

        facade.call(seed())
        started = time.monotonic()
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, "-c", FLEET_LAUNCHER], cwd=ROOT, env=env,
                                    stdout=log, stderr=subprocess.STDOUT)
        api.set_pod_log("prod", "payment-cli", "\n".join(fixture_lines("oom_java.log")),
                        previous=True)
        facade.call(api.create("Pod", operator_pod("payment-cli", "cli", "2026-07-28T13:00:00Z")))
        stored_s, entry = None, None
        by = time.monotonic() + 600
        poked = 0
        while time.monotonic() < by and proc.poll() is None:
            status = facade.call(api.get("Podmortem", "watch-payment-cli", "ops")).get("status")
            entries = (status or {}).get("recentFailures") or []
            if entries:
                stored_s, entry = time.monotonic() - started, entries[0]
                break
            if time.monotonic() - started > 5 * (poked + 1):
                # the MODIFIED the watcher reacts to, in case the pod came
                # before the watch (a claimed failure is not claimed twice)
                poked += 1
                facade.call(api.patch("Pod", "payment-cli", "prod", {
                    "metadata": {"labels": {"poked": str(poked)}}}))
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        term = time.monotonic()
        rc = proc.wait(120)
        exit_s = time.monotonic() - term
        lease = facade.call(api.get("Lease", "podmortem-tpu-operator", "ops"))["spec"]
        requests = list(facade.requests)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(30)
        facade.stop()
    with open(log_path, encoding="utf-8", errors="replace") as fh:
        tail = fh.read()[-3000:]
    if rc != 0 or entry is None or lease.get("holderIdentity") != "" or not os.path.exists(
            counts_path):
        raise fail(f"fleet cli: exit {rc}, stored {entry}, lease {lease}; log tail: {tail}")
    with open(counts_path) as fh:
        child = json.load(fh)
    launches, steps = child["launches"], sum(child["steps"])
    for name, n in launches.items():
        counts.total[name] += n
    if (launches["ragged_paged_attention"] != layers * steps or not steps
            or not launches["best_window_similarity"] or launches["paged_decode_attention"]
            or launches["flash_prefill_attention"] or entry.get("analysisStatus") not in (
                "Analyzed", "PatternOnly")):
        raise fail(f"fleet cli: launches {launches} over {steps} steps, entry {entry}")
    paths = sorted({path.split("?")[0] for _, path in requests})
    out = {"card": card, "start_to_stored_s": stored_s, "sigterm_to_exit_s": exit_s,
           "exit_code": rc, "lease": lease, "status": entry.get("analysisStatus"),
           "steps": steps, "launches": launches, "http_requests": len(requests),
           "http_paths": paths}
    print(json.dumps({"fleet_cli": out}), flush=True)
    return out


def phase_fleet(results: dict, kernel_modules: dict, dirs: dict) -> dict:
    """The operator's HA and elastic fleet on the checkpoint phase's two
    checkpoints: (a) a leader killed mid-drive and the standby's takeover,
    (b) the autoscaler and endpoint discovery over a 1 -> 2 -> 1 serving
    fleet, (c) a PatternLibrary synced from a local git repository, (d)
    the deployed entry point against a stub apiserver.  Returns each
    kernel's launches summed over the four drives."""
    import gc

    import torch

    from operator_tpu_torch.models.configs import get_config

    card = card_line()
    layers = get_config(CHECKPOINT_ENV["OPERATOR_TPU_MODEL"]).num_layers
    total = {name: 0 for name in kernel_modules}
    out: dict = {"card": card}
    for key, part in (("takeover", fleet_takeover), ("elastic", fleet_elastic),
                      ("pattern_sync", fleet_pattern_sync), ("cli", fleet_cli)):
        # the last part's engines are closed: give their memory back first
        gc.collect()
        torch.cuda.empty_cache()
        counts = fleet_counter(kernel_modules)
        out[key] = part(dirs, counts, layers, card)
        for name, n in counts.total.items():
            total[name] += n
    out["launches"] = total
    results["fleet"] = out
    return total


# ---------------------------------------------------------------------------
# phase 10: card vs CPU on a small engine
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 10: the deployed model (llama-3-8b) with the byte-level tokenizer,
# the supervisor, device errors and an open-loop storm
# ---------------------------------------------------------------------------

DEPLOYED_ENV = {**SERVE_ENV, "OPERATOR_TPU_MODEL": "llama-3-8b"}
LLAMA3_TOKENIZER = os.path.join(ROOT, "tests", "torch_tokenizers", "llama3_bl")
#: the tightened stall budget of the injected stalls, and the injected
#: step's sleep: past the budget, inside the default 10 s join grace
STALL_BUDGET_S = 3.0
STALL_SLEEP_S = 5.0
#: the steps let through before the stall: mid-drive, before any of the
#: ten requests can finish (their prompts alone take longer to prefill)
STALL_AFTER_STEPS = 20
#: device memory allowed above its level before a supervised restart
RESTART_MEMORY_MARGIN = 64 * 2**20
#: the storm: the JAX smoke's shape (``operator_tpu/loadgen/__main__.py``)
STORM_SPEC = {"name": "storm", "rate_per_min": 240.0, "duration_s": 5.0, "burst_factor": 4.0,
              "burst_every_s": 2.0, "burst_len_s": 0.5}
STORM_STALL_AFTER_STEPS = 40


class StallAction:
    """An ``engine.step`` fault action that sleeps ``seconds`` (past the
    tightened stall budget) and records, as it fires, the requests the
    supervisor will collect and the kernels' counts."""

    kind = "sleep"
    label = "stall"

    def __init__(self, seconds: float, engine, kernel_modules: dict) -> None:
        self.seconds, self.engine, self.kernel_modules = seconds, engine, kernel_modules
        self.fired: "dict | None" = None

    def fire(self) -> None:
        engine = self.engine
        self.fired = {
            "in_flight": len(engine._pending) + len(engine._waiting) + engine._submissions.qsize(),
            "launches": {name: m.launches for name, m in self.kernel_modules.items()},
        }
        time.sleep(self.seconds)

    def __repr__(self) -> str:
        return f"<sleep:{self.seconds}>"


def supervisor_counts(metrics) -> dict:
    return {name: metrics.counter(f"supervisor_{name}")
            for name in ("restart", "requeue", "gaveup", "leak")}


def supervised_stall(engine, kernel_modules: dict, drive, steps_before: int, where: str,
                     arrivals_continue: bool = False) -> tuple:
    """Run ``drive()`` with the engine's step sleeping past a tightened
    stall budget after ``steps_before`` steps; fails unless the supervisor
    restarted once, requeued every request in flight (with
    ``arrivals_continue``, an open-loop drive, those that arrived before
    the stall was declared too), gave up on none and leaked nothing, with
    one ``engine-stall`` black-box record.  Returns (the drive's result,
    the record)."""
    from operator_tpu_torch.obs import FlightRecorder
    from operator_tpu_torch.utils.faultinject import OK, FaultPlan

    g = engine.generator
    policy = engine._supervisor
    if policy is None:
        raise fail(f"{where}: the engine is not supervised")
    counts0 = supervisor_counts(g.metrics)
    recorder = FlightRecorder(capacity=16)
    engine.recorder = recorder
    stall = StallAction(STALL_SLEEP_S, engine, kernel_modules)
    plan = FaultPlan(seed=11)
    plan.rule("engine.step", [OK] * steps_before + [stall])
    budget, policy.stall_timeout_s = policy.stall_timeout_s, STALL_BUDGET_S
    g.fault_plan = plan
    try:
        result = drive()
    finally:
        g.fault_plan = None
        policy.stall_timeout_s = budget
        engine.recorder = None
    counts = {k: v - counts0[k] for k, v in supervisor_counts(g.metrics).items()}
    dumps = [r for r in recorder.traces() if r.blackbox]
    record = {
        "stall_budget_s": STALL_BUDGET_S, "stall_sleep_s": STALL_SLEEP_S,
        "join_grace_s": policy.join_grace_s, "steps_before": steps_before,
        "in_flight_at_stall": stall.fired["in_flight"] if stall.fired else None,
        "counters": counts,
        "blackbox": [d.reason for d in dumps],
        "blackbox_requeued": [d.extra.get("requeued") for d in dumps],
        "restart_ready_s": g.metrics.gauge("supervisor_restart_ready_seconds"),
        "launches_at_stall": stall.fired["launches"] if stall.fired else None,
        "gave_up": engine.load_report().gave_up,
    }
    print(json.dumps({"supervised_stall": {where: record}}), flush=True)
    in_flight = record["in_flight_at_stall"]
    requeued = record["blackbox_requeued"][0] if dumps else None
    want = {"restart": 1, "requeue": requeued, "gaveup": 0, "leak": 0}
    if (stall.fired is None or counts != want or record["blackbox"] != ["engine-stall"]
            or not (requeued >= in_flight if arrivals_continue else requeued == in_flight)):
        raise fail(f"{where}: supervised stall {record}, want counters {want} and one "
                   f"engine-stall record")
    if record["gave_up"]:
        raise fail(f"{where}: the engine gave up after one stall")
    return result, record


def deployed_requests(tokenizer) -> tuple:
    """The checkpoint phase's ten ``AnalysisRequest``s, and one long raw
    prompt (fixture lines, past two of K1's splits of 256 keys in the
    byte-level tokenizer's ids) for the held step."""
    requests = provider_requests()
    lines = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
             for line in fixture_lines(name)]
    prompt = ""
    for line in lines * 4:
        prompt += line + "\n"
        if len(tokenizer.encode(prompt)) >= 900:
            break
    return requests, prompt


def phase_deployed(results: dict, kernel_modules: dict) -> dict:
    """llama-3-8b at full width (int8 weights from a seed, the committed
    byte-level tokenizer through ``load_tokenizer``) on the continuous
    path with the reference's defaults (prefix cache, pipeline depth 2,
    speculation, the supervisor on): (a) ten analysis requests through
    ``TPUNativeProvider.generate``, K1 held on one step; (b) a supervised
    stall mid-drive; (c) a one-shot and a persistent device error; (d) an
    open-loop storm on a fresh engine with a stall mid-storm.  Returns
    the kernels' launch counts over (a)."""
    import torch

    from operator_tpu_torch.loadgen import ArrivalProcess, ArrivalSpec
    from operator_tpu_torch.loadgen.storm import EngineReplica, build_storm_stack, run_storm
    from operator_tpu_torch.models.tokenizer import HFTokenizer, load_tokenizer
    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.serving.prompts import build_prompt
    from operator_tpu_torch.serving.provider import TPUNativeProvider, build_serving_engine
    from operator_tpu_torch.serving.sched import mixed as mixed_module
    from operator_tpu_torch.serving.types import SamplingParams
    from operator_tpu_torch.utils.faultinject import OK, FaultPlan, raise_, times

    card = card_line()
    out: dict = {"card": card}
    tokenizer = load_tokenizer(LLAMA3_TOKENIZER)
    if not isinstance(tokenizer, HFTokenizer) or tokenizer.bos_id != 128000:
        raise fail(f"the byte-level fixture did not load as Llama-3's HFTokenizer: {tokenizer}")

    def build():
        torch.cuda.empty_cache()
        memory0 = torch.cuda.memory_allocated()
        started = time.perf_counter()
        engine, model_id = build_serving_engine("cuda", DEPLOYED_ENV, seed=0)
        config = engine.generator.config
        shape = (config.num_layers, config.hidden_size, config.num_heads, config.num_kv_heads,
                 config.head_dim, config.vocab_size, config.rope_theta)
        if shape != (32, 4096, 32, 8, 128, 128256, 500_000.0):
            engine.close()
            raise fail(f"not llama-3-8b at full width: {config}")
        if engine._supervisor is None or engine.scheduler is None:
            engine.close()
            raise fail("the deployed engine is not the supervised continuous one")
        engine.generator.tokenizer = tokenizer
        engine.warmup()
        torch.cuda.synchronize()
        return engine, model_id, {
            "build_s": time.perf_counter() - started,
            "memory_after_load_gib": (torch.cuda.memory_allocated() - memory0) / 2**30,
        }

    def counted(drive):
        for module in kernel_modules.values():
            module.launches = 0
        result = drive()
        return result, {name: m.launches for name, m in kernel_modules.items()}

    requests, long_prompt = deployed_requests(tokenizer)
    engine, model_id, built = build()
    g, sched = engine.generator, engine.scheduler
    layers = g.config.num_layers
    provider = TPUNativeProvider(engine, model_id=model_id)
    try:
        # (a) the drive, on an empty prefix cache (as (b)'s requeued run)
        asyncio.run(provider.generate(requests[0]))
        wait_idle(sched)
        sched.spill_cache()
        encode_ms = []
        for request in requests:
            prompt = build_prompt(request)
            started = time.perf_counter()
            tokenizer.encode(prompt)
            encode_ms.append((time.perf_counter() - started) * 1e3)
        steps0, dev0 = sched.steps, len(sched.device_ms)
        started = time.perf_counter()
        responses, launches = counted(lambda: gated_drive(provider, requests))
        wall = time.perf_counter() - started
        steps = sched.steps - steps0
        wait_idle(sched)
        stream_ms = sched.device_ms[dev0:]
        accounting = balanced(sched, "after the deployed drive")
        bad = [r.to_dict() for r in responses if r.error or not r.completion_tokens]
        if bad:
            raise fail(f"deployed responses without an explanation: {bad}")
        if launches["ragged_paged_attention"] != layers * steps or steps == 0:
            raise fail(f"deployed drive: K1 launched {launches} over {steps} steps")
        if any(n for k, n in launches.items() if k != "ragged_paged_attention"):
            raise fail(f"other kernels launched on the deployed drive: {launches}")
        completion = sum(r.completion_tokens for r in responses)
        # one step's 32 K1 calls held to the plain version: the first step
        # whose live rows reach past the long prompt (a decode or verify step)
        prompt_tokens = len(tokenizer.encode(long_prompt))
        held = HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference, layers,
            lambda dtype, _: TOL[dtype],
            select=lambda q, k, v, table, kv_len, q_count: (
                (kv_len * (q_count > 0)).max().item() > prompt_tokens),
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=k1_split_note,
        )
        mixed_module.ragged_paged_attention = held
        try:
            with eager_programs():
                asyncio.run(engine.generate(long_prompt,
                                            SamplingParams(max_tokens=8, temperature=0.0)))
        finally:
            mixed_module.ragged_paged_attention = held.fn
        bad_held = [c for c in held.held if not c["finite"] or not c["excess"] <= 0]
        splits = max((c["splits_with_keys"] for c in held.held), default=0)
        if len(held.held) != layers or bad_held or splits < 3:
            raise fail(f"deployed drive: {len(held.held)} K1 calls held, {splits} splits with "
                       f"keys, outside tolerance: {bad_held}")
        wait_idle(sched)
        out["drive"] = {
            "model": model_id, "layers": layers, "weights": "int8",
            "tokenizer": "tests/torch_tokenizers/llama3_bl", "slots": g.max_slots,
            "requests": len(requests), "max_tokens": MAX_TOKENS, **built,
            "prompt_tokens": [r.prompt_tokens for r in responses],
            "completion_tokens": completion, "wall_s": wall, "tokens_per_s": completion / wall,
            "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
            "stream_ms_per_step": sum(stream_ms) / len(stream_ms) if stream_ms else None,
            "encode_ms_per_request": sum(encode_ms) / len(encode_ms),
            "launches": launches, "page_accounting": accounting,
            "held_k1_calls": len(held.held), "held_prompt_tokens": prompt_tokens,
            "held_k1_max_abs_err": max(c["max_abs_err"] for c in held.held),
            "held_k1_splits_with_keys": splits,
        }
        print(json.dumps({"deployed": out["drive"], "card": card}), flush=True)

        # (b) a supervised stall mid-drive: the same ten requests, every
        # one requeued, the greedy answers (a)'s
        sched.spill_cache()
        torch.cuda.synchronize()
        memory_before = torch.cuda.memory_allocated()
        steps0 = sched.steps
        (stalled, stall_record), stall_launches = counted(lambda: supervised_stall(
            engine, kernel_modules, lambda: gated_drive(provider, requests),
            STALL_AFTER_STEPS, "deployed"))
        wait_idle(sched)
        stall_steps = sched.steps - steps0
        torch.cuda.synchronize()
        memory_after = torch.cuda.memory_allocated()
        accounting_b = balanced(sched, "after the supervised stall")
        greedy = [i for i, r in enumerate(requests) if r.provider_config.temperature == 0.0]
        mismatched = [i for i in greedy if stalled[i].to_dict() != responses[i].to_dict()]
        if mismatched:
            raise fail(f"greedy answers after the restart differ from the drive's: "
                       f"{[(stalled[i].to_dict(), responses[i].to_dict()) for i in mismatched]}")
        if any(r.error or not r.completion_tokens for r in stalled):
            raise fail(f"a request did not settle with an answer after the restart: "
                       f"{[r.to_dict() for r in stalled]}")
        if stall_launches["ragged_paged_attention"] != layers * stall_steps:
            raise fail(f"stall drive: K1 launched {stall_launches} over {stall_steps} steps")
        if memory_after > memory_before + RESTART_MEMORY_MARGIN:
            raise fail(f"device memory {memory_after} after the restart, {memory_before} before "
                       f"(margin {RESTART_MEMORY_MARGIN})")
        out["stall"] = {
            "steps": stall_steps, "launches": stall_launches,
            "memory_before_gib": memory_before / 2**30, "memory_after_gib": memory_after / 2**30,
            "memory_margin_mib": RESTART_MEMORY_MARGIN / 2**20,
            "greedy_equal_to_drive": True, "page_accounting": accounting_b,
            "supervisor": stall_record,
        }
        print(json.dumps({"deployed_stall": out["stall"], "card": card}), flush=True)

        # (c) device errors through the seam: one absorbed by a requeue;
        # a persistent one fails its request after max_requeues, and with
        # the window's three resets spent the engine gives up
        counts0 = supervisor_counts(g.metrics)
        plan = FaultPlan(seed=7)
        plan.rule("engine.step", raise_(lambda: RuntimeError("injected device error"), "device"))
        g.fault_plan = plan
        try:
            absorbed = asyncio.run(provider.generate(requests[2]))
        finally:
            g.fault_plan = None
        after_one = {k: v - counts0[k] for k, v in supervisor_counts(g.metrics).items()}
        if absorbed.error or not absorbed.completion_tokens or plan.pending():
            raise fail(f"a one-shot device error was not absorbed: {absorbed.to_dict()}")
        plan = FaultPlan(seed=8)
        plan.rule("engine.step", times(20, raise_(
            lambda: RuntimeError("injected device error"), "device")))
        g.fault_plan = plan
        try:
            doomed = asyncio.run(provider.generate(requests[4]))
            deadline = time.monotonic() + 60
            while not engine.load_report().gave_up and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            g.fault_plan = None
        persistent = {k: v - counts0[k] for k, v in supervisor_counts(g.metrics).items()}
        out["device_errors"] = {
            "after_one_shot": after_one, "after_persistent": persistent,
            "persistent_error": doomed.error, "gave_up": engine.load_report().gave_up,
        }
        print(json.dumps({"deployed_device_errors": out["device_errors"], "card": card}),
              flush=True)
        if after_one["restart"] != 1 or after_one["requeue"] < 1 or after_one["gaveup"]:
            raise fail(f"one-shot device error: {after_one}")
        if not doomed.error or persistent["gaveup"] < 1 or not out["device_errors"]["gave_up"]:
            raise fail(f"persistent device error did not give up: {out['device_errors']}")
    finally:
        engine.close()
    del engine, provider, g, sched
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (d) the storm on a fresh engine: the JAX smoke's arrivals at seed 0
    # through the operator -> router -> EngineReplica stack, a stall mid-storm
    engine, model_id, built = build()
    sched = engine.scheduler
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ledger = os.path.join(ROOT, "build", "deployed-storm-ledger.jsonl")
    if os.path.exists(ledger):
        os.remove(ledger)
    process = ArrivalProcess(ArrivalSpec(**STORM_SPEC), seed=0)

    async def storm():
        stack = await build_storm_stack(
            replicas=[EngineReplica("deployed-0", engine)], ledger_path=ledger,
            time_scale=1.0, device="cuda",
        )
        try:
            return await run_storm(stack, process, drain_s=300.0)
        finally:
            stack.close()

    try:
        steps0 = sched.steps
        started = time.perf_counter()
        (report, storm_stall), storm_launches = counted(lambda: supervised_stall(
            engine, kernel_modules, lambda: asyncio.run(storm()), STORM_STALL_AFTER_STEPS,
            "storm", arrivals_continue=True))
        storm_wall = time.perf_counter() - started
        wait_idle(sched)
        storm_steps = sched.steps - steps0
        accounting_d = balanced(sched, "after the storm")
        with open(ledger) as fh:
            lines = [line for line in fh if line.strip()]
        torn = 0
        outcomes: dict = {}
        for line in lines:
            try:
                outcome = json.loads(line).get("outcome")
            except ValueError:
                torn += 1
                continue
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
        total = report["slo"]["total"]
        out["storm"] = {
            "spec": process.spec.to_dict(), "seed": 0, "fingerprint": report["fingerprint"],
            "arrivals": report["arrivals"], "offered_per_min": report["offered_per_min"],
            "achieved_per_min": report["achieved_per_min"],
            "cancelled_at_drain": report["cancelled_at_drain"],
            "admitted": total["admitted"], "completed": total["completed"],
            "shed": total["shed"], "deadline_exceeded": total["deadline_exceeded"],
            "failed": total["failed"], "attainment": total["attainment"],
            "goodput_analyses_per_min": total["goodput_analyses_per_min"],
            "journal_lines": len(lines), "torn_lines": torn, "outcomes": outcomes,
            "wall_s": storm_wall,
            "steps": storm_steps, "launches": storm_launches, "page_accounting": accounting_d,
            "supervisor": storm_stall,
            **{f"engine_{k}": v for k, v in built.items()},
        }
        print(json.dumps({"deployed_storm": out["storm"], "card": card}), flush=True)
        if report["slo"]["pending"] or total["admitted"] != report["arrivals"] - report[
                "cancelled_at_drain"] or report["cancelled_at_drain"]:
            raise fail(f"storm arrivals did not all settle: {out['storm']}")
        if torn or len(lines) != total["admitted"]:
            raise fail(f"storm ledger: {len(lines)} lines, {torn} torn, {total['admitted']} settled")
        if storm_launches["ragged_paged_attention"] != layers * storm_steps:
            raise fail(f"storm: K1 launched {storm_launches} over {storm_steps} steps")
    finally:
        engine.close()
        torch.cuda.empty_cache()
    results["deployed"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 11: the fleet KV fabric — llama-3-8b on a prefill and a decode
# replica on one card
# ---------------------------------------------------------------------------

#: both replicas: the deployed model with the reference's defaults, the
#: fabric on, the mirror on and a host pool of 2 GB (256 blocks of 8 MiB)
FABRIC_ENV = {**DEPLOYED_ENV, "KV_FABRIC": "true", "KV_FABRIC_MIRROR": "true",
              "KV_HOST_POOL_MB": "2048"}
#: D's peer poll: one round at its server's start, then the script's own
#: ``poll_once()`` before each drive (a background round mid-drive would
#: reset the index's failure counts that (c) reads); (b) estimates what
#: the default of 5 s would have left stale
FABRIC_POLL_S = "3600"
DEFAULT_POLL_S = 5.0
#: (c): the black-holed holder's per-fetch budget (KV_FABRIC_FETCH_TIMEOUT_S)
BLACK_HOLE_TIMEOUT_S = 0.25
#: the fetcher's thread slack over the socket timeout (fabric/fetch.py)
FETCH_SLACK_S = 0.25
#: (c): the prompts each fault drive sends (the first four: two greedy)
FAULT_PROMPTS = 4
#: (b): each request's tokens (the prefill leg's one and the decode leg's)
TWO_LEG_TOKENS = 16
#: (b): the requests of the held replay (the drive's first ones; each
#: request's blocks are its own, so a shorter replay is like for like)
REPLAY_REQUESTS = 4
#: llama-3-8b's layers, hidden size and head dim, and its block of tokens
FABRIC_SHAPE = (32, 4096, 128)
FABRIC_PAGE = 64


def held_generate(engine, prompts: list, params: list, *, run=asyncio.run,
                  sequential: bool = False, timing: "dict | None" = None,
                  timeout_s: float = 600.0) -> tuple:
    """Every prompt through ``engine.generate`` at once, the worker's
    admission held until all are queued so two drives take the same steps.
    The hold does not block the worker (it keeps running the fabric
    prefetch's store tasks); with ``sequential`` each request's prefetch
    finishes before the next request starts.  ``run`` runs the drive's
    coroutine (an engine with a fetcher keeps to one event loop: its
    semaphore binds to the loop it first waits on).  ``timing`` receives
    ``queued_s``, the first request's start to the release (with the
    fabric: the prefetches).  Returns (results, seconds from the release
    to each request's first token)."""
    hold = threading.Event()
    hold.set()
    admit = engine._admit_submissions

    def gated(block: bool) -> None:
        if hold.is_set():
            time.sleep(0.001)
            return
        admit(block)

    first: list = [None] * len(prompts)

    async def drive():
        # the worker's idle wait (50 ms) runs out first, so it reads the gate
        await asyncio.sleep(0.2)
        base = engine._submissions.qsize()
        tasks: list = []
        by = time.monotonic() + timeout_s
        begun = time.perf_counter()

        async def queued(n: int) -> None:
            while engine._submissions.qsize() < base + n and not any(t.done() for t in tasks):
                if time.monotonic() > by:
                    raise fail(f"held drive: {engine._submissions.qsize() - base} of {n} queued")
                await asyncio.sleep(0.001)

        for i, (prompt, sp) in enumerate(zip(prompts, params)):
            def on_partial(ids, i=i):
                if first[i] is None:
                    first[i] = time.perf_counter()

            tasks.append(asyncio.ensure_future(engine.generate(prompt, sp, on_partial=on_partial)))
            if sequential:
                await queued(i + 1)
        await queued(len(prompts))
        released = time.perf_counter()
        if timing is not None:
            timing["queued_s"] = released - begun
        hold.clear()
        return released, await asyncio.wait_for(asyncio.gather(*tasks), timeout_s)

    engine._admit_submissions = gated
    try:
        released, results = run(drive())
    finally:
        engine._admit_submissions = admit
    return results, [None if f is None else f - released for f in first]


def on_worker(engine, fn):
    """Run ``fn()`` on the engine's worker between steps, holding its lock."""
    return engine.store_executor.submit(fn).result(120)


def empty_prefix_cache(engine) -> None:
    """Forget every cached block, on the card and in the host pool."""
    def empty():
        sched = engine.scheduler
        store = sched._kvstore
        pool = store.host_pool
        store.host_pool = None  # evicted blocks are forgotten, not pooled
        try:
            sched.spill_cache()
        finally:
            store.host_pool = pool
        for block in list(store._blocks.values()):
            store.forget(block.hash)
        for h in list(pool._entries):
            pool.drop(h)
    on_worker(engine, empty)


def keep_only_pooled(engine, keep: set) -> None:
    """Spill the cache to the host pool and keep only ``keep`` there: the
    next drive restores exactly those blocks and recomputes the rest."""
    def prune():
        sched = engine.scheduler
        store = sched._kvstore
        sched.spill_cache()
        for block in list(store._blocks.values()):
            if block.hash not in keep:
                store.forget(block.hash)
                store.host_pool.drop(block.hash)
        missing = [h.hex() for h in keep if not store.host_pool.has(h)]
        if missing:
            raise fail(f"blocks to restore are not in the host pool: {missing}")
    on_worker(engine, prune)


def fabric_expectation(blocks: list, advertised: set, *, adopt: bool, threshold: int,
                       attempts: "int | None" = None, failures: "dict | None" = None) -> dict:
    """What a drive's prefetches must do, prompt after prompt (each
    prefetch ends before the next starts): ``blocks`` is each prompt's
    matchable block hashes, ``advertised`` the holder's inventory.  A
    wanted block is advertised, not yet in the store and not decayed;
    with ``adopt`` the contiguous run of cached or adopted blocks lands
    (``cached``: each request's cached blocks; ``adopted`` the blocks
    restored), else every fetch fails and a block decays from the index
    after ``threshold``.  ``attempts``: only the first that many wanted
    blocks of a prompt reach the holder (a black hole holds each of the
    fetcher's slots for the whole budget, which the queued fetches'
    budgets run out behind); the rest fall back at once.  ``failures``
    receives each block's failed attempts."""
    store, decayed = set(), set()
    failures = {} if failures is None else failures
    out = {"fetched": 0, "fallback": 0, "adopted": 0, "cached": 0, "decayed": 0}
    for hashes in blocks:
        wanted = [h for h in hashes
                  if h not in store and h.hex() in advertised and h not in decayed]
        tried = wanted if attempts is None else wanted[:attempts]
        out["fetched"] += len(tried)
        out["fallback"] += len(wanted) - len(tried)
        if adopt:
            for h in hashes:
                if h not in store and h not in wanted:
                    break
                if h not in store:
                    store.add(h)
                    out["adopted"] += 1
                out["cached"] += 1
        else:
            for h in tried:
                failures[h] = failures.get(h, 0) + 1
                if failures[h] >= threshold:
                    decayed.add(h)
    out["decayed"] = len(decayed)
    return out


class FetchTaps:
    """Times D's fetch path: each HTTP attempt (and its budget), each
    decode (sha256 and the copy out), each store task on the worker
    (probe, adopt); records the hashes adopted.  ``corrupt`` flips one
    payload byte of every answer; ``on_first_ok()`` runs on the fetch's
    event loop once the first block has decoded."""

    def __init__(self, engine, *, corrupt: bool = False, on_first_ok=None) -> None:
        from operator_tpu_torch.fabric import fetch as fetch_module

        self.engine, self.fetch_module = engine, fetch_module
        self.fetcher = engine.fabric
        self.http: list = []
        self.decode_ms: list = []
        self.tasks: list = []
        self.adopted: list = []
        self._http_get = self.fetcher._http_get
        self._decode = fetch_module.decode_block
        self._submit = engine._submit_host_task
        store = engine.scheduler._kvstore
        self._adopt = store.adopt_host
        self.store = store

        async def http_get(url, budget_s):
            started = time.perf_counter()
            try:
                status, data = await self._http_get(url, budget_s)
            finally:
                self.http.append(((time.perf_counter() - started) * 1e3, budget_s))
            if corrupt and status == 200 and data:
                data = data[:-1] + bytes([data[-1] ^ 0x01])
            return status, data

        def decode(data):
            nonlocal on_first_ok
            started = time.perf_counter()
            try:
                decoded = self._decode(data)
            finally:
                self.decode_ms.append((time.perf_counter() - started) * 1e3)
            if on_first_ok is not None:
                on_first_ok, fire = None, on_first_ok
                fire()
            return decoded

        def submit(fn):
            def timed():
                started = time.perf_counter()
                try:
                    return fn()
                finally:
                    name = getattr(getattr(fn, "func", fn), "__name__", "task")
                    self.tasks.append((name, (time.perf_counter() - started) * 1e3))
            return self._submit(timed)

        def adopt(h, parent, tokens):
            self.adopted.append(h)
            return self._adopt(h, parent, tokens)

        self.fetcher._http_get = http_get
        fetch_module.decode_block = decode
        engine._submit_host_task = submit
        store.adopt_host = adopt

    def close(self) -> None:
        self.fetcher._http_get = self._http_get
        self.fetch_module.decode_block = self._decode
        self.engine._submit_host_task = self._submit
        self.store.adopt_host = self._adopt


class KillableServer:
    """A ``CompletionServer`` (wrapped before its start) that can die as
    its process would: ``kill()`` closes the listener and resets every
    open connection, a transfer in flight included."""

    def __init__(self, server) -> None:
        self.server, self.writers, self.reset = server, set(), None
        handle = server._handle

        async def tracked(reader, writer):
            self.writers.add(writer)
            try:
                await handle(reader, writer)
            finally:
                self.writers.discard(writer)

        server._handle = tracked

    def kill(self) -> None:
        """On the server's event loop; ``reset`` counts the connections cut."""
        listener, self.server._server = self.server._server, None
        listener.close()
        self.reset = len(self.writers)
        for writer in list(self.writers):
            writer.transport.abort()


def block_split_ms(blob: bytes, iters: int = 5) -> dict:
    """One wire block's decode, part by part, on the host: the sha256 over
    the payload and the copy of both tensors out of it."""
    import hashlib

    from operator_tpu_torch.fabric import decode_block

    payload = memoryview(blob)[blob.find(b"\n", 6) + 1:]
    sha, total = [], []
    for _ in range(iters):
        started = time.perf_counter()
        hashlib.sha256(payload).hexdigest()
        sha.append((time.perf_counter() - started) * 1e3)
        started = time.perf_counter()
        decode_block(blob)
        total.append((time.perf_counter() - started) * 1e3)
    sha_ms, decode_ms = min(sha), min(total)
    return {"sha256_ms": sha_ms, "copy_ms": max(0.0, decode_ms - sha_ms), "decode_ms": decode_ms}


def dist(values: list) -> dict:
    values = sorted(values)
    if not values:
        return {"n": 0}
    return {"n": len(values), "min": values[0], "median": values[len(values) // 2],
            "max": values[-1], "mean": sum(values) / len(values)}


def phase_fabric(results: dict, kernel_modules: dict) -> dict:
    """The fleet KV fabric (``fabric_drives``); afterwards every byte the
    two replicas held on the card must be free again (within
    ``RESTART_MEMORY_MARGIN``), before the parity phase.  Returns the
    kernels' launch counts over the phase's drives."""
    import gc

    import torch

    def settled() -> int:
        """Bytes allocated once the garbage of closed engines (they, their
        executors and servers refer to each other) and cuBLAS's
        workspaces are gone: cuBLAS keeps one in the caching allocator for
        each thread's handle and stream until told to free them, and every
        engine's worker thread adds its own."""
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), before

    out: dict = {"card": card_line()}
    memory0, _ = settled()
    totals = fabric_drives(out, kernel_modules, memory0)
    memory1, with_workspaces = settled()
    left = memory1 - memory0
    out["memory_after_close_gib"] = left / 2**30
    out["cublas_workspaces_mib"] = (with_workspaces - memory1) / 2**20
    print(json.dumps({"fabric_memory_after_close_gib": out["memory_after_close_gib"],
                      "cublas_workspaces_mib": out["cublas_workspaces_mib"],
                      "card": out["card"]}), flush=True)
    if left > RESTART_MEMORY_MARGIN:
        raise fail(f"the fabric replicas left {left} bytes on the card")
    results["fabric"] = out
    return totals


def fabric_drives(out: dict, kernel_modules: dict, memory0: int) -> dict:
    """The fleet KV fabric at llama-3-8b's full width: a prefill replica P
    and a decode replica D, each built by ``build_serving_engine`` (one
    set of int8 weights shared) behind its own ``CompletionServer``, with
    ``InvariantAuditor.barrier_hook`` on both schedulers.  (a) P serves
    the ten analysis prompts and mirrors their blocks; D, its index fed
    from P's ``/healthz`` by its ``PeerPoller``, fetches them instead of
    recomputing (against a cold drive on D with the fabric off); D's
    greedy answers equal P's from a like-for-like host-pool restore;
    (c) a corrupted payload, a 404 and a black-holed holder fall back to
    recompute; (b) ten requests as a prefill leg on P and a decode leg on
    D through ``disaggregated_dispatch`` over the ``EngineRouter``, held
    to a replay; (d) no invariant violation.  Returns the kernels' launch
    counts over the phase's drives."""
    import hashlib
    import socket
    from types import SimpleNamespace

    import torch

    import operator_tpu_torch.serving.provider as provider_module
    from operator_tpu_torch.chaos import GameDayView, InvariantAuditor
    from operator_tpu_torch.fabric import disaggregated_dispatch
    from operator_tpu_torch.models.tokenizer import load_tokenizer
    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.router import EngineRouter
    from operator_tpu_torch.router.core import Replica
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.kvstore import block_hashes
    from operator_tpu_torch.serving.prompts import build_prompt
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.serving.sched import mixed as mixed_module
    from operator_tpu_torch.serving.types import SamplingParams, prompt_budget
    from operator_tpu_torch.utils.timing import MetricsRegistry

    card = out["card"]
    tokenizer = load_tokenizer(LLAMA3_TOKENIZER)
    requests, _ = deployed_requests(tokenizer)
    prompts = [build_prompt(r) for r in requests]
    params = [SamplingParams(max_tokens=MAX_TOKENS, temperature=r.provider_config.temperature)
              for r in requests]
    greedy = [i for i, r in enumerate(requests) if r.provider_config.temperature == 0.0]
    totals = {name: 0 for name in kernel_modules}

    def counted(drive, engines: list, where: str):
        """``drive()`` with every count set to 0 before: K1 exactly once
        per layer per step of the engines that stepped, the others never."""
        for module in kernel_modules.values():
            module.launches = 0
        steps0 = [e.scheduler.steps for e in engines]
        result = drive()
        for e in engines:
            wait_idle(e.scheduler)
        steps = sum(e.scheduler.steps - s for e, s in zip(engines, steps0))
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for name, n in launches.items():
            totals[name] += n
        if launches["ragged_paged_attention"] != FABRIC_SHAPE[0] * steps or not steps:
            raise fail(f"fabric {where}: K1 launched {launches} over {steps} steps")
        if any(n for k, n in launches.items() if k != "ragged_paged_attention"):
            raise fail(f"fabric {where}: other kernels launched: {launches}")
        for e in engines:
            balanced(e.scheduler, f"after the fabric {where}")
        return result, steps

    def prefill_steps(engine, steps: int) -> int:
        records = engine.generator.step_clock.ring.records(steps)
        return sum(1 for r in records if r.kind in ("prefill", "mixed"))

    def hashes_of(prompt: str, max_tokens: int = MAX_TOKENS, resume: int = 0) -> list:
        """The matchable block hashes of a request, tokenized and cut as
        the scheduler's enqueue does (``resume`` resumed tokens appended)."""
        g = engines[0].generator
        budget = prompt_budget(g.max_seq, max_tokens) - resume
        tokens = g._truncate_prompt(tokenizer.encode(prompt), budget) + [0] * resume
        matchable = (len(tokens) - 1) // FABRIC_PAGE
        return block_hashes(tokens[:matchable * FABRIC_PAGE], FABRIC_PAGE)

    auditor = InvariantAuditor(metrics=MetricsRegistry())
    barrier = auditor.barrier_hook(lambda sched: GameDayView(schedulers=[sched]))
    started = time.perf_counter()

    def prepare(engine) -> None:
        config = engine.generator.config
        if (config.num_layers, config.hidden_size, config.head_dim) != FABRIC_SHAPE:
            raise fail(f"not llama-3-8b at full width: {config}")
        if engine.fabric is None or engine._supervisor is None or engine.scheduler is None:
            raise fail("a fabric replica is not the supervised continuous one with a fetcher")
        engine.generator.tokenizer = tokenizer
        engine.warmup()
        engine.scheduler.audit_hook = barrier

    engine_p, model_id = build_serving_engine(
        "cuda", {**FABRIC_ENV, "REPLICA_ROLE": "prefill", "SERVING_REPLICA_ID": "replica-p"})
    engines = [engine_p]
    prepare(engine_p)
    server_p = CompletionServer(engine_p, model_id=model_id, host="127.0.0.1", port=0,
                                replica_id="replica-p")
    killable = KillableServer(server_p)
    http = HttpLoop(server_p)
    black_hole = None
    try:
        url_p = f"http://127.0.0.1:{server_p.bound_port}"
        init_params = provider_module.init_params
        # D serves the same read-only int8 tensors: no second seeding
        provider_module.init_params = lambda *a, **k: engine_p.generator.params
        try:
            engine_d, _ = build_serving_engine("cuda", {
                **FABRIC_ENV, "REPLICA_ROLE": "decode", "SERVING_REPLICA_ID": "replica-d",
                "KV_FABRIC_PEERS": url_p, "KV_FABRIC_POLL_S": FABRIC_POLL_S})
        finally:
            provider_module.init_params = init_params
        engines.append(engine_d)
        prepare(engine_d)
        server_d = CompletionServer(engine_d, model_id=model_id, host="127.0.0.1", port=0,
                                    replica_id="replica-d")
        http.servers.append(server_d)
        http.run(server_d.start())
        if engine_d.generator.params is not engine_p.generator.params:
            raise fail("the two replicas do not share their weights")
        if engine_d.fabric_poller is None or engine_p.replica_role != "prefill" \
                or engine_d.replica_role != "decode":
            raise fail("the replicas' roles or D's peer poller are not as configured")
        torch.cuda.synchronize()
        out["build"] = {
            "build_s": time.perf_counter() - started,
            "memory_after_both_builds_gib": (torch.cuda.memory_allocated() - memory0) / 2**30,
            "host_pool_mb": int(FABRIC_ENV["KV_HOST_POOL_MB"]),
        }
        print(json.dumps({"fabric_build": out["build"], "card": card}), flush=True)
        sched_p, sched_d = engine_p.scheduler, engine_d.scheduler
        metrics_d = engine_d.generator.metrics

        def poll_d() -> set:
            """D's one poll round of P's /healthz (P idle); returns what P
            advertised: its 128 most recently used blocks."""
            advertised = set(engine_p.load_report().kv_blocks or ())
            if http.run(engine_d.fabric_poller.poll_once()) != 1:
                raise fail("D's peer poller did not index P")
            return advertised

        def held(engine, ps=prompts, sps=params, **kw):
            return held_generate(engine, ps, sps, run=http.run, **kw)

        def counters_d(*names) -> dict:
            return {n: metrics_d.counter(n) for n in names}

        fabric_counters = ("fabric_fetch_ok", "fabric_prefetch_adopted", "fabric_fetch_corrupt",
                           "fabric_fetch_miss", "fabric_fetch_timeout", "fabric_fetch_error",
                           "fabric_fetch_fallback", "fabric_index_evicted",
                           "fabric_index_decayed", "kv_prefill_tokens_saved", "kv_restore")

        def delta(before: dict) -> dict:
            return {n: metrics_d.counter(n) - v for n, v in before.items()}

        # (a) P serves the ten prompts and mirrors their blocks
        (p_first, _), p_steps = counted(lambda: held(engine_p),
                                        [engine_p], "P drive")
        wait_idle(sched_p)
        cached_p = len(sched_p._kvstore)
        # D cold, with the fabric off
        fetcher = engine_d.fabric
        engine_d.fabric = None
        try:
            (cold, cold_ttft), cold_steps = counted(
                lambda: held(engine_d), [engine_d], "D cold drive")
        finally:
            engine_d.fabric = fetcher
        cold_prefill = prefill_steps(engine_d, cold_steps)
        empty_prefix_cache(engine_d)
        # D with the fabric: its index from P's /healthz, prefetches in turn
        advertised = poll_d()
        blocks = [hashes_of(p) for p in prompts]
        want = fabric_expectation(blocks, advertised, adopt=True,
                                  threshold=fetcher.index.failure_threshold)
        before = counters_d(*fabric_counters)
        taps = FetchTaps(engine_d)
        prefetch: dict = {}
        try:
            (fetched, fabric_ttft), fabric_steps = counted(
                lambda: held(engine_d, sequential=True, timing=prefetch),
                [engine_d], "D fabric drive")
        finally:
            taps.close()
        got = delta(before)
        fabric_prefill = prefill_steps(engine_d, fabric_steps)
        if (got["fabric_fetch_ok"] != want["fetched"] or got["fabric_prefetch_adopted"]
                != want["adopted"] or got["kv_prefill_tokens_saved"] != FABRIC_PAGE * want["cached"]
                or got["kv_restore"] != want["adopted"] or not want["adopted"]):
            raise fail(f"fabric drive: counters {got}, expected {want}")
        # each adopted block is P's device page, byte for byte
        store_p, store_d = sched_p._kvstore, sched_d._kvstore
        cache_p, cache_d = engine_p.generator.paged_cache, engine_d.generator.paged_cache
        differ = []
        for h in taps.adopted:
            entry_p, entry_d = store_p.get(h), store_d.get(h)
            if entry_p is None or entry_d is None or entry_p.page < 0 or entry_d.page < 0:
                raise fail(f"adopted block {h.hex()} is not on the card in both replicas")
            for pages_p, pages_d in ((cache_p.k_pages, cache_d.k_pages),
                                     (cache_p.v_pages, cache_d.v_pages)):
                if not torch.equal(pages_p[:, entry_p.page], pages_d[:, entry_d.page]):
                    differ.append(h.hex())
        if differ:
            raise fail(f"adopted blocks differ from P's pages: {differ}")
        # one request on D whose first prefill step attends restored pages:
        # its 32 K1 calls held to the plain version
        held_k1 = HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference, FABRIC_SHAPE[0],
            lambda dtype, _: TOL[dtype],
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=k1_split_note,
        )
        mixed_module.ragged_paged_attention = held_k1
        try:
            with eager_programs():
                http.run(engine_d.generate(prompts[0] + " Summary:",
                                           SamplingParams(max_tokens=2, temperature=0.0)))
        finally:
            mixed_module.ragged_paged_attention = held_k1.fn
        bad_held = [c for c in held_k1.held if not c["finite"] or not c["excess"] <= 0]
        if len(held_k1.held) != FABRIC_SHAPE[0] or bad_held:
            raise fail(f"fabric: {len(held_k1.held)} K1 calls held over restored pages: {bad_held}")
        wait_idle(sched_d)
        # P, like for like: the same blocks restored from its own pool
        keep_only_pooled(engine_p, set(taps.adopted))
        (restored, _), restore_steps = counted(lambda: held(engine_p),
                                               [engine_p], "P restore drive")
        mismatched = [i for i in greedy if list(fetched[i].token_ids) != list(restored[i].token_ids)]
        if mismatched:
            raise fail(f"greedy answers after a fetch differ from a local restore: {mismatched}")
        blob = engine_p.kv_block_bytes(taps.adopted[0].hex())
        split = block_split_ms(blob)
        adopt_ms = sum(ms for name, ms in taps.tasks if name == "adopt")
        fetch_ms = [h + d for (h, _b), d in zip(taps.http, taps.decode_ms)]
        out["a"] = {
            "prompts": len(prompts), "prompt_tokens": [r.prompt_tokens for r in fetched],
            "p_cached_blocks": cached_p, "advertised_blocks": len(advertised),
            "expected": want, "counters": got, "adopted_blocks": len(taps.adopted),
            "block_bytes": len(blob),
            "fetch_ms_per_block": dist(fetch_ms), "http_ms_per_block": dist([h for h, _ in taps.http]),
            "decode_ms_per_block": dist(taps.decode_ms), "decode_split_one_block": split,
            "adopt_ms_per_block": adopt_ms / len(taps.adopted),
            "probe_ms": dist([ms for name, ms in taps.tasks if name == "probe"]),
            "gb_per_s": len(blob) / (sum(fetch_ms) / len(fetch_ms) / 1e3) / 1e9,
            "d_fabric_steps": fabric_steps, "d_fabric_prefill_steps": fabric_prefill,
            "d_cold_steps": cold_steps, "d_cold_prefill_steps": cold_prefill,
            "d_fabric_ttft_s": dist([t for t in fabric_ttft if t is not None]),
            "d_fabric_prefetch_s": prefetch["queued_s"],
            "d_cold_ttft_s": dist([t for t in cold_ttft if t is not None]),
            "p_steps": p_steps, "p_restore_steps": restore_steps,
            "greedy_equal_to_local_restore": len(greedy),
            "held_k1_calls": len(held_k1.held),
            "held_k1_max_abs_err": max(c["max_abs_err"] for c in held_k1.held),
        }
        print(json.dumps({"fabric_a": out["a"], "card": card}), flush=True)

        # (c) faults on the first FAULT_PROMPTS prompts (S): a flipped
        # payload byte, P's server killed mid-drive, a 404, a black-holed
        # holder; each falls back to recompute, held against D's cold drive
        # of S or, where blocks landed, a like-for-like restore on P
        s_prompts, s_params, s_blocks = (prompts[:FAULT_PROMPTS], params[:FAULT_PROMPTS],
                                         blocks[:FAULT_PROMPTS])
        s_greedy = [i for i in greedy if i < FAULT_PROMPTS]
        threshold = fetcher.index.failure_threshold

        def greedy_s(results) -> list:
            return [list(results[i].token_ids) for i in s_greedy]

        empty_prefix_cache(engine_d)
        engine_d.fabric = None
        try:
            (cold_s, _), _ = counted(lambda: held(engine_d, s_prompts, s_params),
                                     [engine_d], "D cold drive of S")
        finally:
            engine_d.fabric = fetcher
        empty_prefix_cache(engine_d)
        advertised = poll_d()
        want_c = fabric_expectation(s_blocks, advertised, adopt=False, threshold=threshold)
        before = counters_d(*fabric_counters)
        taps = FetchTaps(engine_d, corrupt=True)
        try:
            (corrupt, _), _ = counted(
                lambda: held(engine_d, s_prompts, s_params, sequential=True),
                [engine_d], "corrupt drive")
        finally:
            taps.close()
        got_corrupt = delta(before)
        if (got_corrupt["fabric_fetch_corrupt"] != want_c["fetched"] or taps.adopted
                or got_corrupt["fabric_prefetch_adopted"] or got_corrupt["kv_restore"]
                or got_corrupt["fabric_index_decayed"] != want_c["decayed"]):
            raise fail(f"corrupt payloads: {got_corrupt}, expected {want_c}, adopted {taps.adopted}")
        if greedy_s(corrupt) != greedy_s(cold_s):
            raise fail("greedy answers after corrupt fetches differ from D's cold drive")
        # P's server killed once D's first block has decoded: the fetches
        # in flight are reset, the rest refused
        empty_prefix_cache(engine_d)
        advertised = poll_d()
        port_p = server_p.bound_port
        before = counters_d(*fabric_counters)
        taps = FetchTaps(engine_d, on_first_ok=killable.kill)
        try:
            (killed, _), _ = counted(
                lambda: held(engine_d, s_prompts, s_params, sequential=True),
                [engine_d], "kill drive")
        finally:
            taps.close()
        got_kill = delta(before)
        outlived = [(ms, b) for ms, b in taps.http if ms > (b + FETCH_SLACK_S) * 1e3 + 50]
        failed_kill = got_kill["fabric_fetch_timeout"] + got_kill["fabric_fetch_error"]
        if (killable.reset is None or not got_kill["fabric_fetch_ok"]
                or not got_kill["fabric_fetch_error"] or outlived
                or got_kill["fabric_fetch_fallback"] != failed_kill
                or len(taps.http) != got_kill["fabric_fetch_ok"] + failed_kill
                or got_kill["fabric_fetch_miss"] or got_kill["fabric_fetch_corrupt"]
                or got_kill["fabric_prefetch_adopted"] != len(taps.adopted)
                or got_kill["kv_restore"] != len(taps.adopted)):
            raise fail(f"P killed mid-drive: {got_kill} over {len(taps.http)} attempts, "
                       f"{killable.reset} connections reset, over budget {outlived[:5]}")
        out_kill = {"counters": got_kill, "attempts": len(taps.http),
                    "connections_reset": killable.reset, "adopted": len(taps.adopted),
                    "attempt_ms": dist([ms for ms, _ in taps.http]),
                    "held_to": "P's like-for-like restore" if taps.adopted else "D's cold drive"}
        if taps.adopted:
            # like for like: P restores the blocks D adopted, recomputes the rest
            keep_only_pooled(engine_p, set(taps.adopted))
            (reference, _), _ = counted(lambda: held(engine_p, s_prompts, s_params),
                                        [engine_p], "P restore drive of S")
        else:
            reference = cold_s
        if greedy_s(killed) != greedy_s(reference):
            raise fail("greedy answers after P's death mid-drive differ from "
                       + ("a like-for-like restore on P" if taps.adopted else "D's cold drive"))
        # P back on its port; a 404: its pool emptied under its advertised
        # inventory, the prompt of S with the most advertised blocks
        server_p = CompletionServer(engine_p, model_id=model_id, host="127.0.0.1", port=port_p,
                                    replica_id="replica-p")
        http.servers.append(server_p)
        http.run(server_p.start())
        empty_prefix_cache(engine_d)
        advertised = poll_d()
        on_worker(engine_p, lambda: [store_p.host_pool.drop(h)
                                     for h in list(store_p.host_pool._entries)])
        pick = max(range(FAULT_PROMPTS),
                   key=lambda i: sum(h.hex() in advertised for h in blocks[i]))
        before = counters_d(*fabric_counters)
        (_, _), _ = counted(lambda: held(engine_d, prompts[pick:pick + 1], params[pick:pick + 1]),
                            [engine_d], "404 drive")
        got_404 = delta(before)
        wanted_404 = [h for h in blocks[pick] if h.hex() in advertised]
        stale = [h.hex() for h in wanted_404 if fetcher.index.holders(h.hex())]
        if (got_404["fabric_fetch_miss"] != len(wanted_404)
                or got_404["fabric_index_evicted"] != len(wanted_404) or stale or not wanted_404):
            raise fail(f"404s: {got_404} for {len(wanted_404)} advertised blocks, still indexed "
                       f"{stale}")
        # a black hole: P's server stopped under D's index, its port taken
        # by a listener that never answers
        empty_prefix_cache(engine_d)
        advertised = poll_d()
        http.run(server_p.stop(), timeout=120)
        black_hole = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        black_hole.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        black_hole.bind(("127.0.0.1", port_p))
        black_hole.listen(1024)
        failed: dict = {}
        want_bh = fabric_expectation(s_blocks, advertised, adopt=False, threshold=threshold,
                                     attempts=int(FABRIC_ENV.get("KV_FABRIC_CONCURRENCY", "4")),
                                     failures=failed)
        timeout_s, fetcher.timeout_s = fetcher.timeout_s, BLACK_HOLE_TIMEOUT_S
        before = counters_d(*fabric_counters)
        taps = FetchTaps(engine_d)
        try:
            (holed, _), _ = counted(
                lambda: held(engine_d, s_prompts, s_params, sequential=True),
                [engine_d], "black-hole drive")
            got_bh = delta(before)
            # an advertised block the drive did not try: indexed until its
            # threshold-th consecutive timeout, then decayed
            spare = next(h for h in sorted(advertised)
                         if bytes.fromhex(h) not in failed and fetcher.index.holders(h))
            indexed = []
            for _ in range(threshold):
                http.run(fetcher.fetch_block(spare))
                indexed.append(bool(fetcher.index.holders(spare)))
        finally:
            taps.close()
            fetcher.timeout_s = timeout_s
        decayed_spare = metrics_d.counter("fabric_index_decayed") - before[
            "fabric_index_decayed"] - got_bh["fabric_index_decayed"]
        outlived = [(ms, b) for ms, b in taps.http if ms > (b + FETCH_SLACK_S) * 1e3 + 50]
        if (got_bh["fabric_fetch_timeout"] + got_bh["fabric_fetch_error"] != want_bh["fetched"]
                or got_bh["fabric_fetch_fallback"] != want_bh["fetched"] + want_bh["fallback"]
                or got_bh["fabric_index_decayed"] != want_bh["decayed"] or outlived
                or got_bh["fabric_prefetch_adopted"]
                or indexed != [True] * (threshold - 1) + [False] or decayed_spare != 1):
            raise fail(f"black hole: {got_bh}, expected {want_bh}, over budget {outlived[:5]}, "
                       f"a spare block indexed after each timeout {indexed}")
        if greedy_s(holed) != greedy_s(cold_s):
            raise fail("greedy answers behind a black-holed holder differ from D's cold drive")
        black_hole.close()
        black_hole = None
        out["c"] = {
            "prompts": FAULT_PROMPTS,
            "corrupt": {"expected": want_c, "counters": got_corrupt},
            "killed_mid_drive": out_kill,
            "not_found": {"advertised_wanted": len(wanted_404), "counters": got_404},
            "black_hole": {"expected": want_bh, "counters": got_bh,
                           "budget_s": BLACK_HOLE_TIMEOUT_S, "threshold": threshold,
                           "spare_indexed_after_each_timeout": indexed,
                           "attempt_ms": dist([ms for ms, _ in taps.http])},
            "greedy_equal": len(s_greedy),
        }
        print(json.dumps({"fabric_c": out["c"], "card": card}), flush=True)

        # (b) two legs through the router: P again behind a new server
        server_p = CompletionServer(engine_p, model_id=model_id, host="127.0.0.1", port=0,
                                    replica_id="replica-p")
        http.servers.append(server_p)
        http.run(server_p.start())
        url_p = f"http://127.0.0.1:{server_p.bound_port}"
        url_d = f"http://127.0.0.1:{server_d.bound_port}"
        legs_prompts = [f"Two-leg request {i}.\n{p}" for i, p in enumerate(prompts)]
        router = EngineRouter([Replica("replica-p", url_p), Replica("replica-d", url_d)],
                              metrics=MetricsRegistry())
        by_id = {"replica-p": engine_p, "replica-d": engine_d}
        fetcher.index, own_index = router.health.kv_index, fetcher.index

        def two_legs(count: int = len(legs_prompts)) -> tuple:
            empty_prefix_cache(engine_p)
            empty_prefix_cache(engine_d)
            for rid, engine in by_id.items():
                router.report_load(rid, engine.load_report())
            rows: list = []

            async def drive():
                answers = []
                for prompt in legs_prompts[:count]:
                    row: dict = {}

                    async def prefill_send(replica, attempt, budget_s):
                        result = await by_id[replica.id].generate(
                            prompt, SamplingParams(max_tokens=1, temperature=0.0))
                        row["prefill_end"] = time.perf_counter()
                        for rid, engine in by_id.items():  # the in-process feeder
                            router.report_load(rid, engine.load_report())
                        row["prefill"] = (replica.id, result.completion_tokens)
                        return result

                    async def decode_send(replica, attempt, budget_s, prefix):
                        row["decode_start"] = time.perf_counter()
                        before = counters_d(*fabric_counters)
                        result = await by_id[replica.id].generate(
                            prompt, SamplingParams(max_tokens=TWO_LEG_TOKENS - len(prefix),
                                                   temperature=0.0),
                            resume_tokens=prefix)
                        row["decode"] = (replica.id, list(prefix), delta(before))
                        return SimpleNamespace(token_ids=list(prefix) + list(result.token_ids))

                    _pre, dec = await asyncio.wait_for(disaggregated_dispatch(
                        router, prefill_send, decode_send, key=prompt,
                        request_id=f"two-leg-{len(rows)}", metrics=metrics_d), 600)
                    answers.append(dec.response.token_ids)
                    rows.append(row)
                return answers

            started = time.perf_counter()
            answers = http.run(drive())
            return answers, rows, time.perf_counter() - started

        handoffs0 = metrics_d.counter("fabric_disagg_handoff")
        try:
            (answers, rows, wall), legs_steps = counted(two_legs, engines, "two-leg drive")
            handoffs = metrics_d.counter("fabric_disagg_handoff") - handoffs0
            (replay, _rows, replay_wall), replay_steps = counted(
                lambda: two_legs(REPLAY_REQUESTS), engines, "two-leg replay")
        finally:
            fetcher.index = own_index
        replay_handoffs = metrics_d.counter("fabric_disagg_handoff") - handoffs0 - handoffs
        wrong = []
        for i, row in enumerate(rows):
            full = hashes_of(legs_prompts[i], TWO_LEG_TOKENS - 1, resume=1)
            d = row["decode"][2]
            if (row["prefill"] != ("replica-p", 1) or row["decode"][0] != "replica-d"
                    or len(row["decode"][1]) != 1 or d["fabric_prefetch_adopted"] != len(full)
                    or d["fabric_fetch_ok"] != len(full)
                    or d["kv_prefill_tokens_saved"] != FABRIC_PAGE * len(full)):
                wrong.append((i, row["prefill"], row["decode"], len(full)))
        if handoffs != len(legs_prompts) or replay_handoffs != REPLAY_REQUESTS or wrong:
            raise fail(f"two-leg drive: {handoffs} handoffs, {replay_handoffs} in the replay, "
                       f"legs {wrong}")
        if replay != answers[:REPLAY_REQUESTS]:
            raise fail("two-leg greedy answers differ from a replay of the same drive")
        # the replay's requests on P alone, and the stale index a 5 s poll
        # leaves
        empty_prefix_cache(engine_p)

        def single() -> float:
            async def drive():
                for prompt in legs_prompts[:REPLAY_REQUESTS]:
                    await engine_p.generate(prompt, SamplingParams(max_tokens=TWO_LEG_TOKENS,
                                                                   temperature=0.0))
            started = time.perf_counter()
            http.run(drive())
            return time.perf_counter() - started

        single_wall, single_steps = counted(single, [engine_p], "single-replica drive")
        # polls every 5 s from the first prefill leg's end: a decode leg
        # whose prefill leg ended after the last poll before it finds the
        # index without its blocks
        t0 = rows[0]["prefill_end"]
        stale = sum(1 for row in rows if int((row["decode_start"] - t0) // DEFAULT_POLL_S)
                    == int((row["prefill_end"] - t0) // DEFAULT_POLL_S))
        out["b"] = {
            "requests": len(legs_prompts), "tokens": TWO_LEG_TOKENS, "handoffs": handoffs,
            "two_leg_wall_s": wall, "two_leg_steps": legs_steps,
            "replay_wall_s": replay_wall, "replay_steps": replay_steps,
            "single_replica_wall_s": single_wall, "single_replica_steps": single_steps,
            "blocks_fetched_per_decode_leg": [row["decode"][2]["fabric_fetch_ok"] for row in rows],
            "prefill_to_decode_ms": dist([(r["decode_start"] - r["prefill_end"]) * 1e3
                                          for r in rows]),
            "stale_at_default_poll": stale, "default_poll_s": DEFAULT_POLL_S,
            "replay_requests": REPLAY_REQUESTS, "replay_handoffs": replay_handoffs,
            "replay_equal": True,
        }
        print(json.dumps({"fabric_b": out["b"], "card": card}), flush=True)

        # (d) the auditor through every drive
        if auditor.violations or not auditor.checks:
            raise fail(f"invariant violations at the commit barriers: {auditor.report()}")
        out["d"] = {"barrier_checks": auditor.checks, "violations": 0,
                    "launches_over_the_phase": dict(totals)}
        print(json.dumps({"fabric_d": out["d"], "card": card}), flush=True)
    finally:
        if black_hole is not None:
            black_hole.close()
        http.stop()
        for engine in engines:
            engine.scheduler.audit_hook = None
            engine.close()
    return totals


# ---------------------------------------------------------------------------
# the prefix phase: the int8 gate, shared prefixes and chunked prefill
# ---------------------------------------------------------------------------

#: (a) the int8 gate: the JAX test's prompts, new tokens and 1B-class
#: threshold (tests/test_quant_parity.py)
PARITY_PROMPTS = ("pod crashed exit 137", "oom killed container")
PARITY_NEW_TOKENS = 10
MAX_LOGIT_DIFF = 0.5
#: the phase's engines: the wave phase's, with the default template's
#: preamble primed (b, c, e), and with chunked prefill too (d, f)
PREFIX_ENV = {**WAVE_ENV, "PREFIX_CACHE": "true"}
PREFIX_CHUNK = 256
#: the phase's device and the int8 gate's model (a CPU rehearsal at a
#: tiny width sets both; ``main`` runs on the card only)
PREFIX_DEVICE = "cuda"
GATE_MODEL = "tinyllama-1.1b"
#: (d): the 16 x 2,048 bucket, its rows' prompt characters, and the live
#: decode rows beside it
CHUNK_ROWS = 16
CHUNK_PROMPT_CHARS = 1990
CHUNK_LIVE_ROWS = 4
#: (d): a chunked wave's first-token logits against the one-shot K4
#: wave's, bf16.  Both run the same weights and tokens; the attention
#: differs: the chunk program's dense path rounds the probabilities to
#: bf16 before P.V, K4 keeps them in f32 (3e-2 apart per attention
#: output, WAVE_TOL), in each of 22 layers.  About 5 % of the largest
#: logit of these seeded weights (~5)
CHUNK_LOGIT_TOL = 0.25
#: (c): a custom AIProvider promptTemplate whose static preamble spans
#: more than two 64-token pages
CUSTOM_TEMPLATE = (
    "You are the on-call assistant of the payments platform team. Read the pod's "
    "failure evidence below and answer in two short sections, Cause and Action. Name "
    "the Kubernetes object to change and the exact field. Never speculate past the "
    "quoted log lines; say what to collect next when the evidence is thin.\n\n"
    "Pod {pod_name} in {namespace}.\nPatterns: {patterns}\nLog tail:\n{log_tail}\n"
)


def int8_gate() -> dict:
    """(a): ``parity_report`` of the port's seeded bf16 tinyllama-1.1b
    against ``quantize_params`` of it, on the card."""
    import torch

    from operator_tpu_torch.models import ByteTokenizer, get_config, init_params
    from operator_tpu_torch.models.quant import parity_report, quantize_params

    config = get_config(GATE_MODEL)
    gen = torch.Generator(device=PREFIX_DEVICE).manual_seed(0)
    params = init_params(config, gen, torch.bfloat16, device=PREFIX_DEVICE)
    qparams = quantize_params(params, config)
    started = time.perf_counter()
    report = parity_report(params, qparams, config,
                           [ByteTokenizer().encode(p) for p in PARITY_PROMPTS],
                           max_new_tokens=PARITY_NEW_TOKENS)
    torch.cuda.synchronize()
    report["seconds"] = time.perf_counter() - started
    report["threshold"] = MAX_LOGIT_DIFF
    del params, qparams
    torch.cuda.empty_cache()
    if not report["max_logit_diff"] < MAX_LOGIT_DIFF:
        raise fail(f"int8 gate: max_logit_diff {report['max_logit_diff']} is not under "
                   f"{MAX_LOGIT_DIFF}: {report}")
    return report


def idle_wave(g) -> None:
    deadline = time.time() + 60
    while (g.num_active or g._inflight_blocks) and time.time() < deadline:
        time.sleep(0.01)
    if g.num_active or g._inflight_blocks:
        raise fail("the wave engine did not go idle")


def pool_balances(g, where: str) -> int:
    """Every page is free but the registered prefixes' and every slot is
    free; returns the free pages."""
    want = g.allocator.num_pages - 1 - g.prefix_held_pages
    if g.allocator.available != want or len(g.free_slots()) != g.max_slots:
        raise fail(f"{where}: {g.allocator.available} pages free, want {want}; "
                   f"{len(g.free_slots())} of {g.max_slots} slots")
    return g.allocator.available


def prefix_drive(engine, url: str, bodies: list, kernel_modules: dict, where: str) -> dict:
    """The bodies through the HTTP front, admission held until all are
    queued, every kernel count set to 0 just before and read just after:
    K4 22 times per plain wave (a prefixed wave's suffix attention is the
    dense path, outside any kernel, as in the JAX program), K2/K3 22 x 4
    per decode block, K1 and K5 never; the pool balances after it.
    Returns the waves, each wave's prefill ms (admission to its first
    tokens on the host) and the launches."""
    g = engine.generator
    counter = g.metrics.counter
    names = ("prefill_waves_prefix", "prefill_waves_plain")
    waves0 = {name: counter(name) for name in names}
    blocks0 = g.blocks_dispatched
    ring = g.step_clock.ring
    seq0 = ring.records(1)[0].seq if len(ring) else -1
    for module in kernel_modules.values():
        module.launches = 0
    timing: dict = {}
    replies, _ = held_sends(engine, [lambda b=b: _post(url, b) for b in bodies], timing=timing)
    wall = time.perf_counter() - timing["released"]
    idle_wave(g)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    waves = {name[len("prefill_waves_"):]: counter(name) - waves0[name] for name in names}
    blocks = g.blocks_dispatched - blocks0
    layers = g.config.num_layers
    per_path = {"flash_prefill_attention": layers * waves["plain"],
                "paged_decode_attention": layers * g.decode_block * blocks}
    want = {name: per_path.get(name, 0) for name in kernel_modules}
    if launches != want or not blocks:
        raise fail(f"prefix {where}: launches {launches} over {waves} waves and {blocks} "
                   f"blocks; want {want}")
    tokens = sum(r["usage"]["completion_tokens"] for r in replies)
    return {
        "waves": waves, "blocks": blocks, "tokens": tokens, "wall_s": wall,
        "prefill_ms": [r.device_ms for r in ring.records() if r.seq > seq0
                       and r.kind == "prefill"],
        "launches": launches, "pages_free": pool_balances(g, f"after the {where} drive"),
    }


def prefix_bodies(short: bool = False) -> list:
    """The ten default-template requests of the operator drive, as
    completions: ``build_prompt`` of each fixture log's analysis (2,499 to
    4,015 tokens, over the 2,016-token budget).  ``short``: each with its
    log's last four lines and no pattern analysis (1,432 to 1,774 tokens,
    within the budget), the template's preamble then most of a prompt."""
    from operator_tpu_torch.serving.prompts import build_prompt

    requests = provider_requests()
    if short:
        requests = [dataclasses.replace(r, analysis_result=None, failure_data=dataclasses.replace(
            r.failure_data, logs="\n".join(r.failure_data.logs.splitlines()[-4:])))
            for r in requests]
    return [{"prompt": build_prompt(r), "max_tokens": MAX_TOKENS,
             "temperature": r.provider_config.temperature, "top_p": 0.95}
            for r in requests]


def phase_prefix(results: dict, kernel_modules: dict) -> dict:
    """(a) the int8 gate; (b) primed serving against the unprimed drive,
    K4 held in the build and K2/K3 on rows sharing prefix pages; (c) a
    custom promptTemplate through the provider; (e) a device error under
    the supervisor; then (f) the chunked engine's warmup grid and (d) its
    chunked wave.  Returns the kernels' launches over (b)'s drives."""
    import torch

    card = card_line()
    saved = os.environ.get("OPERATOR_TPU_FLASH_PREFILL")
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    out: dict = {}
    try:
        out["a_int8_gate"] = int8_gate()
        print(json.dumps({"prefix_a": out["a_int8_gate"], "card": card}), flush=True)
        launches = prefix_serving(out, kernel_modules, card)
        out["df_chunked"] = prefix_chunked(kernel_modules)
        print(json.dumps({"prefix_df": out["df_chunked"], "card": card}), flush=True)
    finally:
        if saved is None:
            os.environ.pop("OPERATOR_TPU_FLASH_PREFILL", None)
        else:
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = saved
        torch.cuda.empty_cache()
    out["launches"] = launches
    results["prefix"] = out
    return launches


def prefix_serving(out: dict, kernel_modules: dict, card: str) -> dict:
    """(b), (c), (e) on one engine primed by ``build_serving_engine``."""
    import torch

    from operator_tpu_torch.ops import flash_prefill as fp
    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.prompts import DEFAULT_TEMPLATE, template_preamble
    from operator_tpu_torch.serving.provider import build_serving_engine

    started = time.perf_counter()
    engine, model_id = build_serving_engine(PREFIX_DEVICE, PREFIX_ENV, seed=0)
    g = engine.generator
    try:
        if engine.scheduler is not None or g.max_slots != 32:
            raise fail("prefix: SCHED_MODE=wave did not build the 32-slot wave engine")
        preamble = template_preamble(DEFAULT_TEMPLATE)
        n_keep = g._prefix_keep_len(g.tokenizer.encode(preamble))
        primed = [entry["tokens"] for entry in g._prefixes]
        if len(primed) != 1 or g.prefix_held_pages != n_keep // g.page_size:
            raise fail(f"prefix (b): primed {len(primed)} prefixes holding "
                       f"{g.prefix_held_pages} pages, want the preamble's {n_keep // g.page_size}")
        setup_s = time.perf_counter() - started
        server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
        http = HttpLoop(server)
        url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
        bodies = prefix_bodies()
        try:
            def prime(on: bool) -> None:
                def switch():
                    g.clear_shared_prefixes()
                    if on:
                        g.set_shared_prefix(preamble)
                on_worker(engine, switch)

            launches = dict.fromkeys(kernel_modules, 0)
            workloads = {}
            for workload, load in (("long", bodies), ("short", prefix_bodies(short=True))):
                # warm: each path's programs captured at first use, untimed
                prime(True)
                prefix_drive(engine, url, load, kernel_modules, f"{workload} primed warm-up")
                prime(False)
                prefix_drive(engine, url, load, kernel_modules, f"{workload} unprimed warm-up")
                drives = []
                for on in (False, True, True, False):  # in turns
                    prime(on)
                    where = f"{workload} {'primed' if on else 'unprimed'}"
                    drive = prefix_drive(engine, url, load, kernel_modules, where)
                    drive["primed"] = on
                    if on and (drive["waves"]["prefix"] < 1 or drive["waves"]["plain"]):
                        raise fail(f"prefix (b): the {where} drive's waves {drive['waves']}")
                    if not on and drive["waves"]["prefix"]:
                        raise fail(f"prefix (b): the {where} drive shared: {drive['waves']}")
                    for name, n in drive["launches"].items():
                        launches[name] += n
                    drives.append(drive)
                primed_ms = [m for d in drives if d["primed"] for m in d["prefill_ms"]]
                plain_ms = [m for d in drives if not d["primed"] for m in d["prefill_ms"]]
                workloads[workload] = {
                    "prompt_tokens": [len(g.tokenizer.encode(x["prompt"])) for x in load],
                    "drives": drives,
                    "prefill_ms_primed": primed_ms, "prefill_ms_unprimed": plain_ms,
                    "prefill_ratio_primed_to_unprimed": (
                        (sum(primed_ms) / len(primed_ms)) / (sum(plain_ms) / len(plain_ms))
                    ),
                }
            prime(True)
            b = {
                "model": model_id, "setup_s": setup_s, "prefix_tokens": n_keep,
                "prefix_held_pages": g.prefix_held_pages, "requests": len(bodies),
                "workloads": workloads, "launches": launches,
            }
            # K4 held in the build (the preamble primed again, eagerly)
            k4 = HeldToPlain(fp.flash_prefill_attention, fp.flash_prefill_reference,
                             g.config.num_layers, prefill_drive_limit)
            fp.flash_prefill_attention = k4
            try:
                with eager_programs():
                    on_worker(engine, lambda: (g.clear_shared_prefixes(),
                                               g.set_shared_prefix(preamble)))
            finally:
                fp.flash_prefill_attention = k4.fn
            b["held_build_k4"] = held_record("prefix build K4", k4)
            # K2/K3 held on a decode step whose rows share the prefix pages
            n_pp = n_keep // g.page_size
            prefix_row = torch.tensor(g._prefix_pages, dtype=torch.int32, device=PREFIX_DEVICE)

            def sharing(q, k_pages, v_pages, table, lengths, **_):
                rows = (table[:, :n_pp] == prefix_row).all(dim=1) & (lengths > 0)
                return {"rows_sharing_prefix": int(rows.sum().item())}

            k23 = HeldToPlain(pa.paged_attention, pa.paged_attention_reference,
                              g.config.num_layers, lambda dtype, _: WAVE_TOL[dtype],
                              note=sharing)
            pa.paged_attention = k23
            try:
                with eager_programs():
                    held_sends(engine, [lambda x=x: _post(url, {**x, "max_tokens": 8,
                                                                "temperature": 0.0})
                                        for x in bodies[:4]])
            finally:
                pa.paged_attention = k23.fn
            b["held_decode_k23"] = held_record("prefix decode K2/K3", k23)
            if b["held_decode_k23"]["rows_sharing_prefix"] < 2:
                raise fail(f"prefix (b): the held decode step's rows do not share the "
                           f"prefix pages: {b['held_decode_k23']}")
            idle_wave(g)
            pool_balances(g, "after the held requests")
            out["b_primed"] = b
            print(json.dumps({"prefix_b": {**b, "workloads": {
                w: {k: v for k, v in rec.items() if k != "drives"}
                for w, rec in b["workloads"].items()}}, "card": card}), flush=True)
            out["c_custom_template"] = prefix_custom_template(engine, http, model_id)
            print(json.dumps({"prefix_c": out["c_custom_template"], "card": card}), flush=True)
            out["e_recovery"] = prefix_recovery(engine, url, bodies)
            print(json.dumps({"prefix_e": out["e_recovery"], "card": card}), flush=True)
        finally:
            http.stop()
        return launches
    finally:
        engine.close()


def prefix_custom_template(engine, http: "HttpLoop", model_id: str) -> dict:
    """(c): two requests with a custom ``promptTemplate`` through
    ``TPUNativeProvider``: its preamble is registered once, and the
    second request's wave shares it."""
    from operator_tpu_torch.schema.analysis import (
        AIProviderConfig,
        AnalysisRequest,
        PodFailureData,
    )
    from operator_tpu_torch.serving.provider import TPUNativeProvider

    g = engine.generator
    provider = TPUNativeProvider(engine, model_id=model_id, register_template_prefixes=True)
    registered0 = len(g._prefixes)
    counts = []
    responses = []
    for i, name in enumerate(("oom_java.log", "dns_failure.log")):
        log_text = "\n".join(fixture_lines(name)[-12:])
        request = AnalysisRequest(
            failure_data=PodFailureData.parse({
                "logs": log_text,
                "pod": {"metadata": {"name": f"payments-{i}", "namespace": "prod"}},
            }),
            provider_config=AIProviderConfig(
                provider_id="tpu-native", prompt_template=CUSTOM_TEMPLATE,
                max_tokens=MAX_TOKENS, temperature=0.0),
        )
        before = g.metrics.counter("prefill_waves_prefix")
        response = http.run(provider.generate(request))
        counts.append(g.metrics.counter("prefill_waves_prefix") - before)
        responses.append(response)
    record = {
        "registered": len(g._prefixes) - registered0,
        "custom_prefix_tokens": len(g._prefixes[-1]["tokens"]),
        "prefix_waves_per_request": counts,
        "errors": [r.error for r in responses],
        "completion_tokens": [r.completion_tokens for r in responses],
    }
    if record["registered"] != 1 or counts[1] < 1 or any(record["errors"]):
        raise fail(f"prefix (c): {record}")
    idle_wave(g)
    pool_balances(g, "after the custom template")
    return record


def prefix_recovery(engine, url: str, bodies: list) -> dict:
    """(e): a one-shot device error under the supervisor mid-drive: one
    restart that re-primes every registered prefix, and the next wave
    shares."""
    from operator_tpu_torch.utils.faultinject import OK, FaultPlan, raise_

    g = engine.generator
    registry = [entry["tokens"] for entry in g._prefixes]
    held = g.prefix_held_pages
    counts0 = supervisor_counts(g.metrics)
    plan = FaultPlan(seed=15)
    plan.rule("engine.step", [OK, OK, raise_(
        lambda: RuntimeError("injected device error"), "device")])
    g.fault_plan = plan
    try:
        # 32 tokens: eight blocks, so the third step is mid-drive
        drive_requests(url, bodies[:6], truncated=True)
    finally:
        g.fault_plan = None
    idle_wave(g)
    counts = {k: v - counts0[k] for k, v in supervisor_counts(g.metrics).items()}
    before = g.metrics.counter("prefill_waves_prefix")
    drive_requests(url, [{**x, "max_tokens": 4} for x in bodies[:2]], truncated=True)
    idle_wave(g)
    record = {
        "supervisor": counts, "pending_faults": plan.pending(),
        "reprimed": [entry["tokens"] for entry in g._prefixes] == registry,
        "prefix_held_pages": g.prefix_held_pages,
        "next_wave_prefix_waves": g.metrics.counter("prefill_waves_prefix") - before,
        "pages_free": pool_balances(g, "after the recovery"),
    }
    if (counts["restart"] != 1 or counts["gaveup"] or counts["leak"] or plan.pending()
            or not record["reprimed"] or g.prefix_held_pages != held
            or record["next_wave_prefix_waves"] < 1):
        raise fail(f"prefix (e): {record}")
    return record


def prefix_chunked(kernel_modules: dict) -> dict:
    """(f) ``WARMUP_GRID=serving`` on the primed engine with
    ``PREFILL_CHUNK``: the grid's prefixed and chunked keys, then no
    capture in (d) and a prefixed wave after it; (d) the 16 x 2,048
    bucket chunked while decode rows are live: decode blocks between the
    chunks, ceil(t_pad / chunk) chunks, the reserved slots kept from
    another wave, each row's first-token logits against the one-shot K4
    wave's."""
    import numpy as np
    import torch

    from operator_tpu_torch.models.llama import KVCache, forward
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.serving.types import SamplingParams, _bucket, prompt_budget

    env = {**PREFIX_ENV, "PREFILL_CHUNK": str(PREFIX_CHUNK), "WARMUP_GRID": "serving"}
    engine, _ = build_serving_engine(PREFIX_DEVICE, env, seed=0)
    g = engine.generator
    try:
        if g.prefill_chunk != PREFIX_CHUNK or not g._prefixes:
            raise fail(f"prefix (f): chunk {g.prefill_chunk}, {len(g._prefixes)} prefixes")
        started = time.perf_counter()
        report = asyncio.run(engine.precompile("serving"))
        torch.cuda.synchronize()
        f = {
            "precompile": report, "grid_s": time.perf_counter() - started,
            "prefix_keys": len(g._prefix_fns), "chunk_keys": len(g._chunk_fns),
            "finish_keys": len(g._finish_fns), "plain_keys": len(g._prefill_fns),
            "captures": len(g.graphs.log), "pool_bytes": g.graphs.pool_bytes(),
            "job_buffer_bytes": sum(m.k.nbytes + m.v.nbytes + logits.nbytes
                                    for m, logits in g._job_buffers.values()),
        }
        if not (f["prefix_keys"] and f["chunk_keys"] and f["finish_keys"]):
            raise fail(f"prefix (f): the grid missed the prefixed or chunked keys: {f}")
        captures0 = len(g.graphs.log)

        # (d) live decode rows, then the 16 x 2,048 wave as a chunked job
        live = g.admit([LOG_LINE[: 40 + 8 * i] for i in range(CHUNK_LIVE_ROWS)], [
            SamplingParams(max_tokens=240, temperature=0.0, stop_on_eos=False)
        ] * CHUNK_LIVE_ROWS)
        g.step()
        long_prompts = [(f"row {i} " + LOG_LINE * 14)[:CHUNK_PROMPT_CHARS]
                        for i in range(CHUNK_ROWS)]
        sampling = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)
        chunks0 = g.metrics.stage("prefill_chunk").count
        blocks0 = g.blocks_dispatched
        taken = g.admit(long_prompts, [sampling] * CHUNK_ROWS)
        job = g._prefill_job
        if job is None or job.key != (CHUNK_ROWS, 2048) or set(taken) != g._reserved:
            raise fail(f"prefix (d): no 16 x 2,048 job: {job and job.key}, {taken}")
        other = g.admit(["another wave", "and one more"], [sampling] * 2)
        if set(other) & set(taken) or not other:
            raise fail(f"prefix (d): the reserved slots {taken} went to another wave {other}")
        decoding_between = 0
        while g._prefill_job is not None:
            before = g.blocks_dispatched
            g.step()
            if g._prefill_job is not None:
                decoding_between += g.blocks_dispatched - before
        chunks = g.metrics.stage("prefill_chunk").count - chunks0
        want_chunks = -(-2048 // PREFIX_CHUNK)
        last_logits = g._job_buffers[(CHUNK_ROWS, 2048)][1].clone()
        # the one-shot K4 wave's logits on the same tokens
        budget = prompt_budget(g.max_seq, sampling.max_tokens)
        ids_np = np.zeros((CHUNK_ROWS, 2048), np.int32)
        lengths_np = np.zeros((CHUNK_ROWS,), np.int32)
        for row, prompt in enumerate(long_prompts):
            toks = g._truncate_prompt(g.tokenizer.encode(prompt), budget)
            ids_np[row, : len(toks)] = toks
            lengths_np[row] = len(toks)
        if _bucket(int(lengths_np.max()), 64, g.max_seq) != 2048:
            raise fail(f"prefix (d): rows of {lengths_np.max()} tokens are not the 2,048 bucket")
        with torch.no_grad():
            ids = torch.from_numpy(ids_np).to(PREFIX_DEVICE)
            lengths = torch.from_numpy(lengths_np).to(PREFIX_DEVICE)
            positions = torch.arange(2048, dtype=torch.int32, device=PREFIX_DEVICE)[None].expand(
                CHUNK_ROWS, 2048)
            mini = KVCache.create(g.config, CHUNK_ROWS, 2048, dtype=torch.bfloat16,
                                  device=PREFIX_DEVICE)
            oneshot, _ = forward(g.params, g.config, ids, positions, cache=mini,
                                 cache_offset=0, kv_valid=positions < lengths[:, None],
                                 prefill_lengths=lengths, logits_at=lengths - 1)
            del mini
        err = (last_logits - oneshot).abs()
        while g.num_active or g._inflight_blocks:
            g.step()
        d = {
            "t_pad": 2048, "rows": CHUNK_ROWS, "chunk": PREFIX_CHUNK, "chunks": chunks,
            "decode_blocks_between_chunks": decoding_between,
            "job_blocks": g.blocks_dispatched - blocks0, "live_rows": len(live),
            "reserved": sorted(taken), "other_wave": other,
            "logits_max_abs_err": err.max().item(), "logits_tol": CHUNK_LOGIT_TOL,
            "max_abs_logit": oneshot.abs().max().item(),
            "argmax_equal_rows": int((last_logits.argmax(-1) == oneshot.argmax(-1)).sum()),
            "prompt_tokens": lengths_np.tolist(),
            "chunk_host_ms": g.metrics.stage("prefill_chunk").p50_ms,
        }
        if chunks != want_chunks or not decoding_between:
            raise fail(f"prefix (d): {chunks} chunks (want {want_chunks}), "
                       f"{decoding_between} blocks between them")
        if not d["logits_max_abs_err"] <= CHUNK_LOGIT_TOL:
            raise fail(f"prefix (d): chunked first-token logits {d['logits_max_abs_err']} "
                       f"from the one-shot K4 wave's, tolerance {CHUNK_LOGIT_TOL}")
        # (f): a prefixed wave after the chunked one, then nothing captured
        prompts = [b["prompt"] for b in prefix_bodies()[:4]]
        before = g.metrics.counter("prefill_waves_prefix")
        g.admit(prompts, [sampling] * len(prompts))
        while g.num_active or g._inflight_blocks:
            g.step()
        f["prefixed_waves_after"] = g.metrics.counter("prefill_waves_prefix") - before
        f["captured_after_grid"] = captured(g, captures0)
        if f["captured_after_grid"] or f["prefixed_waves_after"] != 1:
            raise fail(f"prefix (f): {f}")
        pool_balances(g, "after the chunked drive")
        # the 16 x 2,048 wave's prefill ms (admission to its first tokens,
        # nothing else on the card) chunked and one-shot (the chunk unset:
        # the plain bucket, captured at its first, untimed wave), in turns
        one = SamplingParams(max_tokens=1, temperature=0.0, stop_on_eos=False)

        def wave_ms(chunked: bool) -> float:
            g.prefill_chunk = PREFIX_CHUNK if chunked else None
            ring = g.step_clock.ring
            seq0 = ring.records(1)[0].seq
            g.admit(long_prompts, [one] * CHUNK_ROWS)
            while g.num_active or g._inflight_blocks:
                g.step()
            return [r.device_ms for r in ring.records() if r.seq > seq0 and r.kind == "prefill"][0]

        try:
            wave_ms(False)
            timed = [(chunked, wave_ms(chunked)) for chunked in (True, False, False, True)]
        finally:
            g.prefill_chunk = PREFIX_CHUNK
        d["prefill_ms_chunked"] = [ms for c, ms in timed if c]
        d["prefill_ms_oneshot"] = [ms for c, ms in timed if not c]
        d["prefill_ratio_chunked_to_oneshot"] = (
            sum(d["prefill_ms_chunked"]) / sum(d["prefill_ms_oneshot"]))
        pool_balances(g, "after the timed waves")
        return {"d": d, "f": f}
    finally:
        engine.close()


#: the contiguous phase's engine: the wave phase's settings (tinyllama-1.1b,
#: int8, 32 slots, page 64, block 4, depth 2, PREFIX_CACHE off) with
#: ``KV_CACHE_MODE=contiguous`` and ``SCHED_MODE`` at its default
#: (continuous), which the provider must turn into the wave engine; the
#: phase adds ``LORA_DIR``.  Its contiguous cache holds 32 x 2,048
#: positions (1.48 GB in bf16)
CONTIG_ENV = {**{k: v for k, v in WAVE_ENV.items() if k != "SCHED_MODE"},
              "KV_CACHE_MODE": "contiguous", "WARMUP_GRID": "serving"}
#: the phase's device (a CPU rehearsal at a tiny width sets it, with a
#: tiny model of a 2,048 context in CONTIG_ENV)
CONTIG_DEVICE = "cuda"
#: (c): the chunk of the 16 x 2,048 wave, and its first-token logits'
#: tolerance against the one-shot K4 wave's (the prefix phase's (d)
#: tolerance, CHUNK_LOGIT_TOL, stated before this phase's first run)
CONTIG_CHUNK = 256


def contiguous_drive(engine, url: str, bodies: list, kernel_modules: dict, where: str) -> dict:
    """The bodies through the HTTP front, queued in order and admitted
    together, every kernel count set to 0 just before and read just after:
    K4 22 times per prefill wave, K1, K2/K3 and K5 never (the contiguous
    decode's attention is dense PyTorch, as in the JAX program); every
    slot free after it.  Returns the drive's record and the results."""
    g = engine.generator
    for module in kernel_modules.values():
        module.launches = 0
    waves0, blocks0, ms0 = g.prefill_waves, g.blocks_dispatched, len(g.block_ms)
    replies, results, wall = guided_drive(engine, url, bodies)
    idle_wave(g)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    waves, blocks = g.prefill_waves - waves0, g.blocks_dispatched - blocks0
    want = {name: 0 for name in kernel_modules}
    want["flash_prefill_attention"] = g.config.num_layers * waves
    if launches != want or not waves or not blocks:
        raise fail(f"contiguous {where}: launches {launches} over {waves} prefill waves and "
                   f"{blocks} decode blocks; want {want}")
    if len(g.free_slots()) != g.max_slots:
        raise fail(f"contiguous {where}: {len(g.free_slots())} of {g.max_slots} slots free")
    block_ms = g.block_ms[ms0:]
    tokens = sum(r["usage"]["completion_tokens"] for r in replies)
    return {
        "requests": len(bodies), "completion_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "prefill_waves": waves, "decode_blocks": blocks,
        "stream_ms_per_block": sum(block_ms) / len(block_ms) if block_ms else None,
        "launches": launches,
    }, results


def contiguous_blocks(engine) -> dict:
    """One held drive of 32 sampled requests of 32 tokens (every block
    carries all 32 rows); the stream ms of its decode blocks."""
    from operator_tpu_torch.serving.types import SamplingParams

    g = engine.generator
    params = SamplingParams(max_tokens=GRAPHS_BLOCK_TOKENS, temperature=0.7, stop_on_eos=False)
    short = [(LOG_LINE * 2)[:48 + i] for i in range(g.max_slots)]
    return timed_blocks(engine, "contiguous", [
        lambda i=i: engine.submit(short[i], params).result(timeout=300)
        for i in range(g.max_slots)])


def phase_contiguous(results: dict, kernel_modules: dict, seed: int) -> dict:
    """The wave engine's contiguous KV cache at full width (see the module
    doc): (a) the drive and the paged drive's greedy answers, (b) the
    graphs, (d) a guided choice and adapted requests, (e) a device
    error, (c) a chunked wave.  Returns the kernels' launches over (a)'s
    drive."""
    import torch

    from operator_tpu_torch.models.configs import get_config
    from operator_tpu_torch.ops import flash_prefill as fp
    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.utils.compilewatch import CompileWatcher

    card = card_line()
    saved = os.environ.get("OPERATOR_TPU_FLASH_PREFILL")
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    workdir = os.path.join(ROOT, "build", "chip_smoke_contiguous")
    shutil.rmtree(workdir, ignore_errors=True)
    lora_dir = os.path.join(workdir, "lora")
    out: dict = {"card": card}
    tap = LogTap()
    provider_log = logging.getLogger("operator_tpu_torch.serving.provider")
    watcher = CompileWatcher()
    engine = http = None
    try:
        model = CONTIG_ENV["OPERATOR_TPU_MODEL"]
        write_lora_dir(lora_dir, get_config(model), seed, device=CONTIG_DEVICE)
        env = {**CONTIG_ENV, "LORA_DIR": lora_dir}
        started = time.perf_counter()
        provider_log.addHandler(tap)
        try:
            engine, model_id = build_serving_engine(CONTIG_DEVICE, env, seed=0)
        finally:
            provider_log.removeHandler(tap)
        g = engine.generator
        config = g.config
        fell_back = [m for m in tap.messages if "falling back to the wave engine" in m]
        out["fallback_warning"] = fell_back
        if engine.scheduler is not None or g.paged or not fell_back or "paged=False" not in fell_back[0]:
            raise fail(f"contiguous: SCHED_MODE=continuous with KV_CACHE_MODE=contiguous did not "
                       f"fall back to the wave engine with the warning: {fell_back}")
        if (g.decode_block, g.pipeline_depth, g.max_slots, g.max_seq) != (4, 2, 32, 2048):
            raise fail(f"contiguous: block {g.decode_block}, depth {g.pipeline_depth}, "
                       f"{g.max_slots} slots, max_seq {g.max_seq}")
        if CONTIG_DEVICE == "cuda" and (config.num_layers, config.hidden_size,
                                        config.num_heads) != (22, 2048, 32):
            raise fail(f"contiguous: not tinyllama-1.1b at full width: {config}")
        if g.adapter_names != ["incident", "verbose", "zero"]:
            raise fail(f"contiguous: adapters {g.adapter_names}")
        built = time.perf_counter() - started

        # (b) the warmup grid
        report = asyncio.run(engine.precompile("serving"))
        if CONTIG_DEVICE == "cuda":
            torch.cuda.synchronize()
        out["b_graphs"] = {
            "build_s": built, "grid_s": time.perf_counter() - started - built,
            "precompile": report, "captures": len(g.graphs.log),
            "capture_s": g.graphs.capture_s, "pool_bytes": g.graphs.pool_bytes(),
            "cache_bytes": g.cache.k.nbytes + g.cache.v.nbytes,
        }
        captures0 = len(g.graphs.log)
        watcher.mark()

        # (a) the wave phase's ten requests, K4 held in one more request
        server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
        http = HttpLoop(server)
        url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
        bodies = request_bodies()
        drive, answers = contiguous_drive(engine, url, bodies, kernel_modules, "(a)")
        layers = config.num_layers
        drive["held_calls"] = held_drive_calls(url, fp, "flash_prefill_attention", HeldToPlain(
            fp.flash_prefill_attention, fp.flash_prefill_reference, layers,
            prefill_drive_limit), LOG_LINE * 3)
        launches = drive["launches"]
        out["a_drive"] = drive
        print(json.dumps({"contiguous_a": drive, "card": card}), flush=True)

        # the same requests on a paged wave engine of the same weights:
        # the greedy answers must be equal; then (b)'s block ms, in turns
        paged_env = {**env, "KV_CACHE_MODE": "paged", "SCHED_MODE": "wave", "WARMUP_GRID": "off"}
        paged, _ = build_serving_engine(CONTIG_DEVICE, paged_env, seed=0)
        paged_http = None
        try:
            if not paged.generator.paged:
                raise fail("contiguous: the paged comparison engine is not paged")
            paged_server = CompletionServer(paged, model_id=model_id, host="127.0.0.1", port=0)
            paged_http = HttpLoop(paged_server)
            paged_url = f"http://127.0.0.1:{paged_server.bound_port}/v1/completions"
            greedy = [i for i, body in enumerate(bodies) if body["temperature"] == 0.0]

            def compare(other: list) -> dict:
                differ = [i for i in greedy if answers[i].token_ids != other[i].token_ids]
                return {"rows": len(greedy), "differ": differ, "first_divergence": {
                    i: next((k for k, (a, b) in enumerate(zip(
                        answers[i].token_ids, other[i].token_ids)) if a != b), None)
                    for i in differ}}

            # with K2/K3, which keep P in f32 where the dense decode rounds
            # it to bf16: recorded (a near-tie of random weights flips)
            _, kernel_answers, _ = guided_drive(paged, paged_url, bodies)
            idle_wave(paged.generator)
            # with the paged decode's plain version, which rounds P as the
            # dense decode does: the layouts must give the same tokens
            kernel = pa.paged_attention
            pa.paged_attention = pa.paged_attention_reference
            try:
                with eager_programs():
                    _, plain_answers, _ = guided_drive(paged, paged_url, bodies)
            finally:
                pa.paged_attention = kernel
            idle_wave(paged.generator)
            out["a_greedy_vs_paged"] = {"paged_plain_decode": compare(plain_answers),
                                        "paged_k2_k3": compare(kernel_answers)}
            print(json.dumps({"contiguous_a_vs_paged": out["a_greedy_vs_paged"], "card": card}),
                  flush=True)
            if out["a_greedy_vs_paged"]["paged_plain_decode"]["differ"]:
                raise fail(f"contiguous (a): greedy answers differ from the paged drive's "
                           f"with the plain decode: {out['a_greedy_vs_paged']}")
            if CONTIG_DEVICE == "cuda":
                turns = [(name, contiguous_blocks(e)) for name, e in (
                    ("contiguous", engine), ("paged", paged), ("paged", paged),
                    ("contiguous", engine))]
                medians = {name: [r["median_ms"] for n, r in turns if n == name]
                           for name in ("contiguous", "paged")}
                out["b_graphs"]["block_ms"] = {
                    "rows": g.max_slots, "tokens": GRAPHS_BLOCK_TOKENS, "turns": turns,
                    "median_ms": medians,
                    "contiguous_over_paged": sum(medians["contiguous"]) / sum(medians["paged"]),
                }
        finally:
            if paged_http is not None:
                paged_http.stop()
            paged.close()
            del paged
            if CONTIG_DEVICE == "cuda":
                torch._C._cuda_clearCublasWorkspaces()
                torch.cuda.empty_cache()
        after = captured(g, captures0)
        builds = [e for e in watcher.events_since_mark() if e[1].startswith("nvcc:")]
        out["b_graphs"]["captured_after_grid"] = after
        out["b_graphs"]["builds_after_grid"] = builds
        print(json.dumps({"contiguous_b": out["b_graphs"], "card": card}), flush=True)
        if after or builds:
            raise fail(f"contiguous (b): captured or built after the grid: {after} {builds}")

        # (d) a guided choice with an adapter, and the adapters on one prompt
        out["d_guided_lora"] = contiguous_guided(engine, url, kernel_modules)
        print(json.dumps({"contiguous_d": out["d_guided_lora"], "card": card}), flush=True)
        # (e) a device error under the supervisor
        out["e_recovery"] = contiguous_recovery(engine, url, bodies)
        print(json.dumps({"contiguous_e": out["e_recovery"], "card": card}), flush=True)
        # (c) the chunked wave, on the worker between steps
        out["c_chunked"] = engine.store_executor.submit(
            lambda: contiguous_chunked(engine)).result(900)
        print(json.dumps({"contiguous_c": out["c_chunked"], "card": card}), flush=True)
    finally:
        watcher.close()
        if http is not None:
            http.stop()
        if engine is not None:
            engine.close()
        shutil.rmtree(workdir, ignore_errors=True)
        if saved is None:
            os.environ.pop("OPERATOR_TPU_FLASH_PREFILL", None)
        else:
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = saved
        if CONTIG_DEVICE == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = launches
    results["contiguous"] = out
    return launches


def contiguous_guided(engine, url: str, kernel_modules: dict) -> dict:
    """(d): base, ``incident`` and ``zero`` on one prompt (greedy) and a
    ``guided_choice`` with ``incident``, admitted together: the zero
    adapter's answer is the base's, incident's differs, the choice is a
    choice and its tokens never leave the automaton; K4 22 per wave."""
    g = engine.generator
    prompt = LOG_LINE[:120]
    greedy = {"max_tokens": MAX_TOKENS, "temperature": 0.0}
    bodies = [{"prompt": prompt, **greedy},
              {"prompt": prompt, "model": "incident", **greedy},
              {"prompt": prompt, "model": "zero", **greedy},
              {"prompt": "severity of this failure?", "model": "incident",
               "guided_choice": GUIDED_CHOICES, **greedy}]
    for module in kernel_modules.values():
        module.launches = 0
    waves0 = g.prefill_waves
    captures0 = len(g.graphs.log)
    replies, results, wall = guided_drive(engine, url, bodies)
    idle_wave(g)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    base, incident, zero, choice = results
    spec = ("choice", tuple(GUIDED_CHOICES))
    record = {
        "wall_s": wall, "prefill_waves": g.prefill_waves - waves0, "launches": launches,
        "zero_equals_base": zero.token_ids == base.token_ids,
        "incident_differs": incident.token_ids != base.token_ids,
        "choice": choice.text, "choice_replay": replay_in_automaton(g, spec, choice),
        "captured": captured(g, captures0),
    }
    if (not record["zero_equals_base"] or not record["incident_differs"]
            or choice.text not in GUIDED_CHOICES or record["choice_replay"]["left_at"] is not None
            or launches["flash_prefill_attention"] != g.config.num_layers * record["prefill_waves"]
            or launches["paged_decode_attention"] or launches["ragged_paged_attention"]):
        raise fail(f"contiguous (d): {record}")
    return record


def contiguous_recovery(engine, url: str, bodies: list) -> dict:
    """(e): a one-shot device error at the third step of a drive: one
    supervised restart whose reset zeroes the cache and the offsets in
    place (the graphs read them by address), every request requeued and
    answered; the next wave replays its graphs, capturing nothing."""
    from operator_tpu_torch.utils.faultinject import OK, FaultPlan, raise_

    g = engine.generator
    held = (g.cache.k.data_ptr(), g.cache.v.data_ptr(), g.offsets.data_ptr())
    seen: list = []
    reset = g.reset

    def watched_reset(*args, **kwargs):
        reset(*args, **kwargs)
        seen.append({
            "fresh": bool(kwargs.get("fresh")),
            "in_place": (g.cache.k.data_ptr(), g.cache.v.data_ptr(), g.offsets.data_ptr()) == held,
            "zeroed": not (g.cache.k.any() or g.cache.v.any() or g.offsets.any()),
        })

    counts0 = supervisor_counts(g.metrics)
    plan = FaultPlan(seed=16)
    plan.rule("engine.step", [OK, OK, raise_(
        lambda: RuntimeError("injected device error"), "device")])
    g.fault_plan = plan
    g.reset = watched_reset
    try:
        drive_requests(url, bodies[:6])
    finally:
        g.fault_plan = None
        del g.reset  # the method again, no bound method kept on its instance
    idle_wave(g)
    counts = {k: v - counts0[k] for k, v in supervisor_counts(g.metrics).items()}
    captures0, replays0 = g.graphs.captures, g.graphs.replays
    drive_requests(url, [{**b, "max_tokens": 8} for b in bodies[:2]])
    idle_wave(g)
    record = {
        "supervisor": counts, "pending_faults": plan.pending(), "resets": seen,
        "captures_after": g.graphs.captures - captures0,
        "replays_after": g.graphs.replays - replays0,
        "slots_free": len(g.free_slots()),
    }
    if (counts["restart"] != 1 or counts["gaveup"] or counts["leak"] or plan.pending()
            or len(seen) != 1 or not seen[0]["in_place"] or not seen[0]["zeroed"]
            or record["captures_after"] or record["slots_free"] != g.max_slots
            or (CONTIG_DEVICE == "cuda" and not record["replays_after"])):
        raise fail(f"contiguous (e): {record}")
    return record


def contiguous_chunked(engine) -> dict:
    """(c), on the worker between steps: four live decode rows, then a
    16 x 2,048 wave as a chunked job (``prefill_chunk`` 256, eight chunks,
    decode blocks between them); each row's first-token logits against
    the one-shot K4 wave's on the same tokens, within CHUNK_LOGIT_TOL."""
    import numpy as np
    import torch

    from operator_tpu_torch.models.llama import KVCache, forward
    from operator_tpu_torch.serving.types import SamplingParams, _bucket, prompt_budget

    g = engine.generator
    captures0 = len(g.graphs.log)
    g.prefill_chunk = CONTIG_CHUNK
    try:
        live = g.admit([LOG_LINE[: 40 + 8 * i] for i in range(CHUNK_LIVE_ROWS)], [
            SamplingParams(max_tokens=240, temperature=0.0, stop_on_eos=False)
        ] * CHUNK_LIVE_ROWS)
        g.step()
        long_prompts = [(f"row {i} " + LOG_LINE * 14)[:CHUNK_PROMPT_CHARS]
                        for i in range(CHUNK_ROWS)]
        sampling = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)
        chunks0 = g.metrics.stage("prefill_chunk").count
        taken = g.admit(long_prompts, [sampling] * CHUNK_ROWS)
        job = g._prefill_job
        if job is None or job.key != (CHUNK_ROWS, 2048) or set(taken) != g._reserved:
            raise fail(f"contiguous (c): no 16 x 2,048 job: {job and job.key}, {taken}")
        decoding_between = 0
        while g._prefill_job is not None:
            before = g.blocks_dispatched
            g.step()
            if g._prefill_job is not None:
                decoding_between += g.blocks_dispatched - before
        chunks = g.metrics.stage("prefill_chunk").count - chunks0
        last_logits = g._job_buffers[(CHUNK_ROWS, 2048)][1].clone()
        budget = prompt_budget(g.max_seq, sampling.max_tokens)
        ids_np = np.zeros((CHUNK_ROWS, 2048), np.int32)
        lengths_np = np.zeros((CHUNK_ROWS,), np.int32)
        for row, prompt in enumerate(long_prompts):
            toks = g._truncate_prompt(g.tokenizer.encode(prompt), budget)
            ids_np[row, : len(toks)] = toks
            lengths_np[row] = len(toks)
        if _bucket(int(lengths_np.max()), 64, g.max_seq) != 2048:
            raise fail(f"contiguous (c): rows of {lengths_np.max()} tokens are not the 2,048 bucket")
        with torch.no_grad():
            ids = torch.from_numpy(ids_np).to(g.device)
            lengths = torch.from_numpy(lengths_np).to(g.device)
            positions = torch.arange(2048, dtype=torch.int32, device=g.device)[None].expand(
                CHUNK_ROWS, 2048)
            mini = KVCache.create(g.config, CHUNK_ROWS, 2048, dtype=g.cache_dtype,
                                  device=g.device)
            oneshot, _ = forward(g.params, g.config, ids, positions, cache=mini,
                                 cache_offset=0, kv_valid=positions < lengths[:, None],
                                 prefill_lengths=lengths, logits_at=lengths - 1)
            del mini
        err = (last_logits - oneshot).abs()
        while g.num_active or g._inflight_blocks:
            g.step()
    finally:
        g.prefill_chunk = None
    record = {
        "t_pad": 2048, "rows": CHUNK_ROWS, "chunk": CONTIG_CHUNK, "chunks": chunks,
        "decode_blocks_between_chunks": decoding_between, "live_rows": len(live),
        "logits_max_abs_err": err.max().item(), "logits_tol": CHUNK_LOGIT_TOL,
        "max_abs_logit": oneshot.abs().max().item(),
        "argmax_equal_rows": int((last_logits.argmax(-1) == oneshot.argmax(-1)).sum()),
        "captured": captured(g, captures0), "slots_free": len(g.free_slots()),
    }
    if (chunks != -(-2048 // CONTIG_CHUNK) or not decoding_between
            or not record["logits_max_abs_err"] <= CHUNK_LOGIT_TOL
            or record["slots_free"] != g.max_slots):
        raise fail(f"contiguous (c): {record}")
    return record


# ---------------------------------------------------------------------------
# the mesh phase: SERVING_MESH on the wave engine
# ---------------------------------------------------------------------------

#: the deployed replica's knobs (deploy/serving-deployment.yaml): llama-3-8b
#: in int8, 32 slots, SCHED_MODE at its default (continuous: a mesh falls
#: back to the wave engine), decode block 4, pipeline depth 2
MESH_ENV = {
    "OPERATOR_TPU_MODEL": "llama-3-8b",
    "ALLOW_RANDOM_WEIGHTS": "true",
    "SERVING_DTYPE": "int8",
    "MAX_BATCH_SIZE": "32",
    "KV_PAGE_SIZE": "64",
    "DECODE_BLOCK": "4",
    "PIPELINE_DEPTH": "2",
}
#: rehearsal on the CPU: "cpu", and tiny models in MESH_MODELS
MESH_DEVICE = "cuda"
#: (a) and (b)'s model, (c)'s model
MESH_MODELS = ("llama-3-8b", "tinyllama-1.1b")
#: (b)'s depth: four ranks share the card over gloo, whose all-reduce of a
#: decode step's [32, 4096] bf16 activations takes milliseconds
#: (``scripts/torch_mesh_probe.py``), two per layer; every width stays
MESH_B_LAYERS = 8
#: (b) and (c)'s prompts (bytes) and tokens: short, so a prefill wave's
#: all-reduces stay small on gloo; every answer greedy
MESH_PROMPT_CHARS = [16, 40, 100, 220, 64, 120, 180, 30, 200, 90]
MESH_TOKENS = 16
#: (b): the next-token logits of four 32-token rows on four tp ranks
#: against one rank's (bf16: each rank's partial sums round before the
#: all-reduce adds them), and the top-two margin of the one-rank model
#: under which a greedy token may differ
MESH_LOGIT_TOL = 0.25
MESH_RANK_TIMEOUT_S = 600.0
MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")


def mesh_bodies() -> list:
    return [(LOG_LINE * (n // len(LOG_LINE) + 1))[:n] for n in MESH_PROMPT_CHARS]


def mesh_config(name: str, layers: "int | None" = None):
    """A model of the registry, at ``layers`` depth (registered under its
    own name, so ``build_serving_engine`` reads it by name)."""
    from operator_tpu_torch.models import configs

    config = configs.get_config(name)
    if layers is None or layers == config.num_layers:
        return config
    cut = dataclasses.replace(config, num_layers=layers, name=f"{name}-d{layers}")
    configs._REGISTRY[cut.name] = cut
    return cut


def next_token_logits(g, seed: int = 7):
    """The model's next-token logits for four 32-token rows (seeded ids),
    through the generator's shard where it has one: every rank of a mesh
    must call this together."""
    import numpy as np
    import torch

    from operator_tpu_torch.models.llama import forward

    ids = np.random.default_rng(seed).integers(3, 250, (4, 32))
    ids = torch.as_tensor(ids, device=g.device)
    positions = torch.arange(32, device=g.device)[None].expand(4, 32)
    logits, _ = forward(g.params, g.config, ids, positions, shard=g.shard,
                        logits_at=torch.full((4,), 31, device=g.device))
    return logits.float().cpu()


def tie_margins(g, prompts: list, answers: list, got: list) -> list:
    """For each answer ``got`` leaves (``answers``: the one-rank engine's),
    the one-rank model's top-two margin at the first position they
    differ, teacher forced over the prompt and the answer; None where
    they agree."""
    import torch

    from operator_tpu_torch.models.llama import forward

    out = []
    for prompt, want, have in zip(prompts, answers, got):
        at = next((i for i, (a, b) in enumerate(zip(have, want)) if a != b), None)
        if at is None and len(have) == len(want):
            out.append(None)
            continue
        at = min(len(have), len(want)) if at is None else at
        ids = g.tokenizer.encode(prompt) + list(want)
        row = torch.as_tensor([ids], device=g.device)
        positions = torch.arange(len(ids), device=g.device)[None]
        logits, _ = forward(g.params, g.config, row, positions, shard=g.shard,
                            logits_at=torch.tensor([len(ids) - len(want) - 1 + at],
                                                   device=g.device))
        top = logits[0].float().topk(2).values
        out.append(float(top[0] - top[1]))
    return out


def mesh_drive(engine, prompts: list, tokens: int) -> list:
    """Every prompt queued before admission (``held_sends``), greedy."""
    from operator_tpu_torch.serving.types import SamplingParams

    params = SamplingParams(max_tokens=tokens, temperature=0.0, stop_on_eos=False)
    results, _ = held_sends(engine, [
        (lambda p=p: engine.submit(p, params).result(900)) for p in prompts])
    return [r.token_ids for r in results]


def mesh_rank(spec_path: str, rank: int) -> int:
    """One rank of a mesh phase's launch (``--mesh-rank``): joins the
    launch's group from torchrun's environment, builds its engine with
    ``build_serving_engine``, computes ``next_token_logits`` with the
    other ranks, then rank 0 drives the prompts and every other rank
    follows; each writes its record (kernel counts, memory) as JSON."""
    import torch

    from operator_tpu_torch.ops import flash_prefill as fp
    from operator_tpu_torch.serving.meshserve import MeshFollower
    from operator_tpu_torch.serving.provider import build_serving_engine

    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    with open(spec_path) as fh:
        spec = json.load(fh)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(spec["world"]),
                      MASTER_ADDR="localhost", MASTER_PORT=str(spec["port"]),
                      OPERATOR_TPU_FLASH_PREFILL="1")
    mesh_config(spec["model"], spec.get("layers"))
    device = spec["device"]
    started = time.perf_counter()
    engine, model_id = build_serving_engine(device, spec["env"], seed=0)
    follower = isinstance(engine, MeshFollower)
    g = engine.generator
    cuda = g.device.type == "cuda"
    out = {"rank": rank, "model": model_id, "build_s": time.perf_counter() - started,
           "memory_gib": torch.cuda.memory_allocated(g.device) / 2**30 if cuda else None,
           "param_bytes": sum(t.numel() * t.element_size() for t in tree_tensors(g.params)),
           "graphs": g.graphs.stats()["mode"], "tp": g.shard.tp, "data": g.shard.data}
    logits = next_token_logits(g)
    for module in (fp, pa):
        module.launches = 0
    waves0, blocks0 = g.prefill_waves, g.blocks_dispatched
    if follower:
        engine.run()
    else:
        try:
            t0 = time.perf_counter()
            out["tokens"] = mesh_drive(engine, spec["prompts"], spec["tokens"])
            out["wall_s"] = time.perf_counter() - t0
            out["buckets"] = sorted(n for n, *_ in g._prefill_fns)
            out["stream_ms_per_block"] = (statistics.mean(g.block_ms) if g.block_ms else None)
        finally:
            engine.close()
        torch.save(logits, os.path.join(spec["workdir"], "logits.pt"))
    out.update(prefill_waves=g.prefill_waves - waves0, decode_blocks=g.blocks_dispatched - blocks0,
               launches={"flash_prefill_attention": fp.launches,
                         "paged_decode_attention": pa.launches},
               peak_gib=torch.cuda.max_memory_allocated(g.device) / 2**30 if cuda else None)
    with open(os.path.join(spec["workdir"], f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def tree_tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    return [tree]


def mesh_launch(label: str, world: int, model: str, env: dict, layers=None) -> tuple:
    """``world`` ranks of ``python3 chip_smoke.py --mesh-rank``, sharing
    the card; fails unless every rank exits 0 within MESH_RANK_TIMEOUT_S.
    Returns (each rank's record, rank 0's logits)."""
    import socket

    import torch

    workdir = os.path.join(MESH_DIR, label)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    with socket.socket() as probe:
        probe.bind(("localhost", 0))
        port = probe.getsockname()[1]
    spec = {"world": world, "port": port, "model": model, "layers": layers, "env": env,
            "device": MESH_DEVICE, "workdir": workdir, "prompts": mesh_bodies(),
            "tokens": MESH_TOKENS}
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+") for r in range(world)]
    child_env = {**os.environ, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                               spec_path, str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=child_env, cwd=ROOT) for r in range(world)]
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tails = []
    for r, log in enumerate(logs):
        log.seek(0)
        tails.append(log.read()[-3000:])
        log.close()
    if any(proc.returncode != 0 for proc in procs):
        raise fail(f"mesh {label}: ranks exited {[p.returncode for p in procs]}:\n"
                   + "\n".join(f"--- rank {r} ---\n{t}" for r, t in enumerate(tails)))
    records = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as fh:
            records.append(json.load(fh))
    logits = torch.load(os.path.join(workdir, "logits.pt"))
    return records, logits


def check_rank_launches(label: str, records: list, layers: int, block: int) -> list:
    """Every rank launched K4 ``layers`` times per prefill wave and K2/K3
    ``layers * block`` times per decode block."""
    out = []
    for record in records:
        want = {"flash_prefill_attention": layers * record["prefill_waves"],
                "paged_decode_attention": layers * block * record["decode_blocks"]}
        if (record["launches"] != want or not record["prefill_waves"]
                or not record["decode_blocks"]):
            raise fail(f"mesh {label} rank {record['rank']}: launches {record['launches']} "
                       f"over {record['prefill_waves']} waves and {record['decode_blocks']} "
                       f"blocks; want {want}")
        out.append(record["launches"])
    return out


def held_tokens(label: str, got: list, want: list, margins: list, tol: float) -> int:
    """Greedy answers equal wherever the one-rank model's top-two margin
    exceeds ``tol``; returns how many are equal."""
    ties = [m for m in margins if m is not None]
    if any(m > tol for m in ties):
        raise fail(f"mesh {label}: answers left the one-rank engine's at margins {margins} "
                   f"(tol {tol}):\n{got}\n{want}")
    return sum(a == b for a, b in zip(got, want))


def phase_mesh(results: dict, kernel_modules: dict) -> dict:
    """(a) the deployed plan on one rank, (b) its tp = 4 factorisation on
    four ranks sharing the card, (c) dp2tp2 from a checkpoint through the
    sharded load.  Returns (a)'s kernel launches over its HTTP drive."""
    import torch

    from operator_tpu_torch.models.llama import init_params
    from operator_tpu_torch.models.loader import save_params
    from operator_tpu_torch.ops import flash_prefill as fp
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import _parse_mesh_plan, build_serving_engine

    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    card = card_line() if MESH_DEVICE == "cuda" else "cpu"
    # earlier phases' closed engines may still sit in reference cycles,
    # their weights and graph pools with them: (a) needs the card's memory
    free_before = torch.cuda.mem_get_info()[0] if MESH_DEVICE == "cuda" else None
    release_card()
    free_after = torch.cuda.mem_get_info()[0] if MESH_DEVICE == "cuda" else None
    print(json.dumps({"mesh_free_gib": {
        "before_collect": free_before and free_before / 2**30,
        "after_collect": free_after and free_after / 2**30}}), flush=True)
    saved = os.environ.get("OPERATOR_TPU_FLASH_PREFILL")
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    out: dict = {"card": card}
    model_a, model_c = MESH_MODELS
    try:
        # (a) the deployed plan on one rank
        env = {**MESH_ENV, "OPERATOR_TPU_MODEL": model_a}
        plan = _parse_mesh_plan("auto", [torch.device(MESH_DEVICE)], mesh_config(model_a))
        if (plan.dp, plan.fsdp, plan.tp) != (1, 1, 1):
            raise fail(f"mesh (a): SERVING_MESH=auto planned {plan} on one card")
        tap = LogTap()
        provider_log = logging.getLogger("operator_tpu_torch.serving.provider")
        provider_log.addHandler(tap)
        if MESH_DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            engine, model_id = build_serving_engine(
                MESH_DEVICE, {**env, "SERVING_MESH": "dp=1,tp=1"}, seed=0)
        finally:
            provider_log.removeHandler(tap)
        g = engine.generator
        fell_back = [m for m in tap.messages if "falling back to the wave engine" in m]
        mode = g.graphs.stats()["mode"]
        if (engine.scheduler is not None or not fell_back or "mesh=True" not in fell_back[0]
                or g.shard is None or (g.decode_block, g.pipeline_depth, g.max_slots) != (4, 2, 32)):
            raise fail(f"mesh (a): not the wave engine on a one-rank mesh with the fallback "
                       f"warning: {fell_back}, block {g.decode_block}, depth {g.pipeline_depth}")
        if MESH_DEVICE == "cuda" and (mode != "graphs" or not g.shard.capturable):
            raise fail(f"mesh (a): the programs are not CUDA graphs: {mode} ({g.shard.backend})")
        config = g.config
        layers = config.num_layers
        a: dict = {"model": model_id, "plan_auto": dataclasses.asdict(plan),
                   "backend": g.shard.backend, "graphs": mode, "fallback_warning": fell_back[0]}
        try:
            engine.warmup()
            a["setup_s"] = time.perf_counter() - t0
            server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
            http = HttpLoop(server)
            url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
            try:
                _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
                bodies = request_bodies()
                for module in kernel_modules.values():
                    module.launches = 0
                waves0, blocks0, ms0 = g.prefill_waves, g.blocks_dispatched, len(g.block_ms)
                completion, wall = drive_requests(url, bodies)
                launches = {name: m.launches for name, m in kernel_modules.items()}
                waves, blocks = g.prefill_waves - waves0, g.blocks_dispatched - blocks0
                want = {"flash_prefill_attention": layers * waves,
                        "paged_decode_attention": layers * g.decode_block * blocks,
                        "ragged_paged_attention": 0, "best_window_similarity": 0}
                if not waves or not blocks or launches != want:
                    raise fail(f"mesh (a): launches {launches} over {waves} prefill waves and "
                               f"{blocks} decode blocks; want {want}")
                block_ms = g.block_ms[ms0:]
                a.update(requests=len(bodies), completion_tokens=completion, wall_s=wall,
                         tokens_per_s=completion / wall, prefill_waves=waves,
                         decode_blocks=blocks, launches_mesh=launches,
                         stream_ms_per_block=statistics.mean(block_ms) if block_ms else None)
                a["held_prefill_calls"] = held_drive_calls(url, fp, "flash_prefill_attention",
                                                           HeldToPlain(
                    fp.flash_prefill_attention, fp.flash_prefill_reference, layers,
                    prefill_drive_limit), LOG_LINE * 3)
                a["held_decode_calls"] = held_drive_calls(url, pa, "paged_attention", HeldToPlain(
                    pa.paged_attention, pa.paged_attention_reference, layers,
                    lambda dtype, _: WAVE_TOL[dtype]), LOG_LINE * 2)
            finally:
                http.stop()
                del server, http  # they hold the engine
            wait_wave_idle(g)
            prompts = mesh_bodies()
            a["answers"] = mesh_drive(engine, prompts, MESH_TOKENS)
            if MESH_DEVICE == "cuda":
                a["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
                a["memory_gib"] = torch.cuda.memory_allocated() / 2**30
        finally:
            engine.close()
        del engine, g
        release_card()
        plain, _ = build_serving_engine(MESH_DEVICE, {**env, "SCHED_MODE": "wave"}, seed=0)
        try:
            plain_answers = mesh_drive(plain, prompts, MESH_TOKENS)
        finally:
            plain.close()
        del plain
        release_card()
        if a["answers"] != plain_answers:
            raise fail(f"mesh (a): greedy answers differ from the engine without "
                       f"SERVING_MESH:\n{a['answers']}\n{plain_answers}")
        a["equal_to_unmeshed"] = len(prompts)
        print(json.dumps({"mesh_a": a, "card": card}), flush=True)
        out["a"] = a

        # (b) the deployed factorisation on four ranks sharing the card, at
        # MESH_B_LAYERS layers; its reference is one rank at that depth
        cut = mesh_config(model_a, MESH_B_LAYERS)
        # no template prefix primed at build: every rank computes the
        # logits before rank 0 sends its first call
        env_b = {**MESH_ENV, "OPERATOR_TPU_MODEL": cut.name, "PREFIX_CACHE": "false"}
        ref, _ = build_serving_engine(MESH_DEVICE, {**env_b, "SERVING_MESH": "dp=1,tp=1"}, seed=0)
        try:
            ref_logits = next_token_logits(ref.generator)
            ref_answers = mesh_drive(ref, prompts, MESH_TOKENS)
            records, logits = mesh_launch("b", 4, model_a, {**env_b, "SERVING_MESH": "dp=1,tp=4"},
                                          layers=MESH_B_LAYERS)
            got = records[0]["tokens"]
            margins = tie_margins(ref.generator, prompts, ref_answers, got)
        finally:
            ref.close()
        del ref
        release_card()
        err = float((logits - ref_logits).abs().max())
        if not err <= MESH_LOGIT_TOL:
            raise fail(f"mesh (b): next-token logits {err} from one rank's (tol {MESH_LOGIT_TOL})")
        b = {"layers": MESH_B_LAYERS, "width": [cut.hidden_size, cut.num_heads,
                                                cut.num_kv_heads, cut.head_dim, cut.vocab_size],
             "ranks": 4, "per_rank_heads": [cut.num_heads // 4, cut.num_kv_heads // 4,
                                            cut.head_dim],
             "logits_max_abs_err": err, "logit_tol": MESH_LOGIT_TOL,
             "equal_answers": held_tokens("(b)", got, ref_answers, margins, MESH_LOGIT_TOL),
             "margins_where_different": [m for m in margins if m is not None],
             "launches_per_rank": check_rank_launches("(b)", records, MESH_B_LAYERS, 4),
             "memory_gib_per_rank": [r["memory_gib"] for r in records],
             "param_bytes_per_rank": [r["param_bytes"] for r in records],
             "graphs": records[0]["graphs"], "wall_s": records[0]["wall_s"],
             "tokens_per_s": sum(map(len, got)) / records[0]["wall_s"],
             "stream_ms_per_block": records[0]["stream_ms_per_block"],
             "build_s": max(r["build_s"] for r in records)}
        print(json.dumps({"mesh_b": b, "card": card}), flush=True)
        out["b"] = b

        # (c) dp2tp2 from a bf16 checkpoint through the sharded load (int8)
        config_c = mesh_config(model_c)
        ckpt = os.path.join(MESH_DIR, "ckpt")
        gen = torch.Generator(device=MESH_DEVICE).manual_seed(0)
        params = init_params(config_c, gen, torch.bfloat16, device=MESH_DEVICE)
        save_params(params, ckpt, config_c)
        del params
        release_card()
        for name in os.listdir(TOKENIZER_FIXTURE):
            shutil.copy(os.path.join(TOKENIZER_FIXTURE, name), ckpt)
        env_c = {**MESH_ENV, "OPERATOR_TPU_MODEL": model_c, "CHECKPOINT_DIR": ckpt,
                 "WEIGHT_DTYPE": "int8", "PREFIX_CACHE": "false"}
        env_c.pop("ALLOW_RANDOM_WEIGHTS")
        one, _ = build_serving_engine(MESH_DEVICE, {**env_c, "SCHED_MODE": "wave"}, seed=0)
        try:
            one_answers = mesh_drive(one, prompts, MESH_TOKENS)
            records, _ = mesh_launch("c", 4, model_c, {**env_c, "SERVING_MESH": "dp=2,tp=2"})
            got = records[0]["tokens"]
            margins = tie_margins(one.generator, prompts, one_answers, got)
        finally:
            one.close()
        del one
        release_card()
        buckets = records[0]["buckets"]
        if not buckets or any(n % 2 for n in buckets):
            raise fail(f"mesh (c): prefill buckets {buckets} not multiples of dp*fsdp = 2")
        c = {"model": model_c, "ranks": 4, "slots_per_data_rank": 16,
             "per_rank_kv_heads": config_c.num_kv_heads // 2, "buckets": buckets,
             "equal_answers": held_tokens("(c)", got, one_answers, margins, MESH_LOGIT_TOL),
             "margins_where_different": [m for m in margins if m is not None],
             "launches_per_rank": check_rank_launches("(c)", records, config_c.num_layers, 4),
             "memory_gib_per_rank": [r["memory_gib"] for r in records],
             "param_bytes_per_rank": [r["param_bytes"] for r in records],
             "graphs": records[0]["graphs"], "wall_s": records[0]["wall_s"],
             "build_s": max(r["build_s"] for r in records)}
        print(json.dumps({"mesh_c": c, "card": card}), flush=True)
        out["c"] = c
        results["mesh"] = out
        return launches
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
        if saved is None:
            os.environ.pop("OPERATOR_TPU_FLASH_PREFILL", None)
        else:
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = saved


def wait_wave_idle(g, timeout_s: float = 60.0) -> None:
    deadline = time.time() + timeout_s
    while (g.num_active or g._inflight_blocks) and time.time() < deadline:
        time.sleep(0.05)


def release_card() -> None:
    """Free what a closed engine held on the card (cuBLAS workspaces too)."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()


def phase_parity(results: dict, kernel_modules: dict) -> None:
    import torch

    from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, init_params
    from operator_tpu_torch.serving.engine import Generator, ServingEngine
    from operator_tpu_torch.serving.sched import Scheduler
    from operator_tpu_torch.serving.types import SamplingParams

    gen = torch.Generator(device="cpu").manual_seed(0)
    params_cpu = init_params(TINY_TEST, gen, torch.float32, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        return tree.to(device)

    prompts = [LOG_LINE[:30], LOG_LINE * 3, "OOMKilled OOMKilled OOMKilled"]
    sampling = SamplingParams(max_tokens=16, temperature=0.0)

    def run(device, wave, paged=True):
        generator = Generator(
            to(params_cpu, device), TINY_TEST, ByteTokenizer(), max_slots=4,
            max_seq=256, page_size=16, cache_dtype=torch.float32, device=device,
            decode_block=4 if wave else 1, pipeline_depth=2 if wave else 1, paged=paged,
        )
        sched = None if wave else Scheduler(
            generator, chunk=16, token_budget=32, pipeline_depth=2, spec_decode=True,
        )
        engine = ServingEngine(generator, sched)
        try:
            return [r.token_ids for r in engine.generate_batch(prompts, sampling)]
        finally:
            engine.close()

    tokens = {device: run(device, wave=False) for device in ("cuda", "cpu")}
    if tokens["cuda"] != tokens["cpu"]:
        raise fail(f"greedy tokens differ card vs CPU: {tokens}")
    results["parity"] = {"prompts": len(prompts), "tokens": tokens["cuda"]}
    print(json.dumps({"parity": "ok", "tokens": tokens["cuda"]}), flush=True)
    results["store_parity"] = store_parity(to(params_cpu, "cuda"), params_cpu)

    saved = {k: os.environ.get(k) for k in ("OPERATOR_TPU_FLASH_PREFILL", "OPERATOR_TPU_PAGED_KERNEL")}
    wave_parity = []
    try:
        for version in ("v1", "v2"):
            for flash in ("0", "1"):
                os.environ["OPERATOR_TPU_PAGED_KERNEL"] = version
                os.environ["OPERATOR_TPU_FLASH_PREFILL"] = flash
                for module in kernel_modules.values():
                    module.launches = 0
                card = run("cuda", wave=True)
                launches = {name: m.launches for name, m in kernel_modules.items()}
                cpu = run("cpu", wave=True)
                ok = (
                    card == cpu
                    and launches["paged_decode_attention"] > 0
                    and (launches["flash_prefill_attention"] > 0) == (flash == "1")
                    and launches["ragged_paged_attention"] == 0
                    and launches["best_window_similarity"] == 0
                )
                wave_parity.append({"paged_kernel": version, "flash_prefill": flash == "1",
                                    "launches": launches, "tokens_equal": card == cpu})
                print(json.dumps({"wave_parity": wave_parity[-1]}), flush=True)
                if not ok:
                    raise fail(f"wave parity {version}/flash={flash}: card {card} cpu {cpu} "
                               f"launches {launches}")
        # the contiguous cache: K4 in the prefill when flash is on, no
        # decode kernel (its attention is dense PyTorch)
        for flash in ("0", "1"):
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = flash
            for module in kernel_modules.values():
                module.launches = 0
            card = run("cuda", wave=True, paged=False)
            launches = {name: m.launches for name, m in kernel_modules.items()}
            cpu = run("cpu", wave=True, paged=False)
            ok = (card == cpu and (launches["flash_prefill_attention"] > 0) == (flash == "1")
                  and launches["paged_decode_attention"] == 0
                  and launches["ragged_paged_attention"] == 0
                  and launches["best_window_similarity"] == 0)
            wave_parity.append({"contiguous": True, "flash_prefill": flash == "1",
                                "launches": launches, "tokens_equal": card == cpu})
            print(json.dumps({"wave_parity": wave_parity[-1]}), flush=True)
            if not ok:
                raise fail(f"contiguous wave parity flash={flash}: card {card} cpu {cpu} "
                           f"launches {launches}")
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    results["wave_parity"] = wave_parity
    results["family_parity"] = family_parity(to, kernel_modules)
    results["prefix_parity"] = prefix_parity(params_cpu, to, kernel_modules)
    results["analysis_parity"] = analysis_parity(kernel_modules)


#: the families' features at TINY_TEST's size (``tests/test_torch_families.py``'s
#: variants): a 24-token window, q/k/v biases with groups of 7, tied
#: embeddings with llama3 scaling and groups of 3; prompts of three windows
FAMILY_PARITY_PROMPTS = (
    "pod web-7d9f8c crashed with exit code 137, reason OOMKilled, memory limit 512Mi",
    "OOMKilled " * 8,
    "a much longer prompt " * 5,
)


def family_parity(to, kernel_modules: dict) -> dict:
    """Each tiny family variant's continuous engine (f32, speculation on,
    depth 2) on the card and on the CPU: greedy tokens equal, K1 launched
    once per layer per step on the card and no other kernel."""
    from dataclasses import replace

    import torch

    from operator_tpu_torch.models import ByteTokenizer, configs, init_params
    from operator_tpu_torch.serving.engine import Generator, ServingEngine
    from operator_tpu_torch.serving.sched import Scheduler
    from operator_tpu_torch.serving.types import SamplingParams

    tiny = configs.TINY_TEST
    variants = {
        "window": replace(tiny, name="tiny-window", sliding_window=24),
        "bias_g7": replace(tiny, name="tiny-bias-g7", num_heads=14, num_kv_heads=2,
                           attention_bias=True),
        "tied_scaled_g3": replace(
            tiny, name="tiny-tied-g3", num_heads=6, num_kv_heads=2, tie_embeddings=True,
            rope_theta=500_000.0,
            rope_scaling=configs.RopeScaling(factor=32.0, original_max_positions=64)),
    }
    sampling = SamplingParams(max_tokens=16, temperature=0.0)
    out = {}
    for name, config in variants.items():
        params = init_params(config, torch.Generator(device="cpu").manual_seed(0),
                             torch.float32, device="cpu")
        if config.attention_bias:
            seeded_biases(params["layers"], 1)
        tokens, steps = {}, {}
        for device in ("cuda", "cpu"):
            for module in kernel_modules.values():
                module.launches = 0
            generator = Generator(to(params, device), config, ByteTokenizer(), max_slots=4,
                                  max_seq=256, page_size=16, cache_dtype=torch.float32,
                                  device=device)
            sched = Scheduler(generator, chunk=16, token_budget=32, pipeline_depth=2,
                              spec_decode=True)
            engine = ServingEngine(generator, sched)
            try:
                tokens[device] = [r.token_ids for r in engine.generate_batch(
                    list(FAMILY_PARITY_PROMPTS), sampling)]
                steps[device] = sched.steps
            finally:
                engine.close()
            if device == "cuda":
                launches = {k: m.launches for k, m in kernel_modules.items()}
        want = {k: 0 for k in kernel_modules}
        want["ragged_paged_attention"] = config.num_layers * steps["cuda"]
        out[name] = {"tokens_equal": tokens["cuda"] == tokens["cpu"], "launches": launches,
                     "steps": steps["cuda"], "tokens": tokens["cuda"]}
        print(json.dumps({"family_parity": {name: out[name]}}), flush=True)
        if tokens["cuda"] != tokens["cpu"] or launches != want:
            raise fail(f"family parity {name}: card {tokens['cuda']} cpu {tokens['cpu']}, "
                       f"launches {launches} (want {want})")
    return out


TRAIN_STEPS = 5
#: (a) and (b): the batch of each drive, rows x tokens
TRAIN_FULL_BATCH = (8, 512)
TRAIN_LORA_BATCH = (4, 512)
TRAIN_LORA_RANK = 16
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
#: the drives' device and models ((a) full fine-tune, (b) LoRA); a CPU
#: rehearsal sets "cpu" and tiny models
TRAIN_DEVICE = "cuda"
TRAIN_MODELS = ("tinyllama-1.1b", "llama-3-8b")
#: (d): the card's f32 losses against the CPU's
TRAIN_CPU_RTOL = 1e-3


def train_drive(name: str, step, state, args: tuple, tokens: int, card: str) -> tuple:
    """``TRAIN_STEPS`` steps of ``step`` from ``state``; the loss must drop.
    Returns (state, record): the losses, each step's ms, the median of
    steps 2 on, tokens per second at it, and the peak memory."""
    import torch

    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        begun = time.perf_counter()
        state, loss = step(state, *args)
        losses.append(float(loss))  # waits for the step
        ms.append((time.perf_counter() - begun) * 1e3)
    steady = statistics.median(ms[1:])
    record = {"losses": losses, "step_ms": ms, "ms_per_step": steady,
              "tokens_per_s": tokens / (steady / 1e3),
              "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
              "card": card}
    print(json.dumps({f"train_{name}": record}), flush=True)
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)) \
            or losses[-1] >= losses[0]:
        raise fail(f"train ({name}): the loss did not drop over {TRAIN_STEPS} steps: {losses}")
    return state, record


def phase_train(results: dict, kernel_modules: dict, seed: int, profile: bool = False) -> dict:
    """(a)-(d) of the train phase; the kernels' launches over all four.
    With ``profile``, one more step of (a) and of (b) under the profiler."""
    import torch
    import torch.distributed as dist

    from operator_tpu_torch.models import TINY_TEST, get_config, init_params
    from operator_tpu_torch.models.quant import init_params_quantized
    from operator_tpu_torch.parallel import (
        MeshPlan, init_lora, load_train_state, make_lora_train_step, make_mesh,
        make_train_step, mesh_summary, save_train_state, shard_params,
    )
    from operator_tpu_torch.parallel.mesh import tree_leaves, tree_map
    from operator_tpu_torch.parallel.train import adam_moments

    full_config, lora_config = map(get_config, TRAIN_MODELS)
    device = TRAIN_DEVICE
    torch.cuda.empty_cache()
    card = card_line()
    out: dict = {"card": card}
    begun = time.perf_counter()
    for module in kernel_modules.values():
        module.launches = 0
    mesh = make_mesh(MeshPlan(), device_type=device)
    out.update(mesh=mesh_summary(mesh), backend=str(dist.get_backend()))
    if device == "cuda" and "nccl" not in out["backend"]:
        raise fail(f"train: the group's backend is {out['backend']}, not nccl")
    gen = torch.Generator(device=device)

    def batch(rows_tokens: tuple, vocab: int) -> tuple:
        tokens = torch.randint(0, vocab, rows_tokens, generator=gen, device=device,
                               dtype=torch.int32)
        return tokens, torch.ones(rows_tokens, device=device)

    try:
        # (a) full fine-tune, tinyllama-1.1b
        gen.manual_seed(seed)
        init_state, train_step = make_train_step(full_config, mesh)
        state = init_state(init_params(full_config, gen, torch.bfloat16, device=device))
        full_batch = batch(TRAIN_FULL_BATCH, full_config.vocab_size)
        state, out["a_full_tinyllama"] = train_drive(
            "a_full_tinyllama", train_step, state, full_batch,
            TRAIN_FULL_BATCH[0] * TRAIN_FULL_BATCH[1], card)

        # (c) its checkpoint round trip
        started = time.perf_counter()
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        save_train_state(state, TRAIN_DIR)
        saved_s = time.perf_counter() - started
        gen.manual_seed(seed + 1)
        reference = init_state(init_params(full_config, gen, torch.bfloat16, device=device))
        started = time.perf_counter()
        restored = load_train_state(TRAIN_DIR, reference)
        loaded_s = time.perf_counter() - started
        pairs = list(zip((restored.params, *adam_moments(restored)),
                         (state.params, *adam_moments(state))))
        unequal = sum(not torch.equal(a.full_tensor(), b.full_tensor())
                      for got, want in pairs for a, b in zip(tree_leaves(got), tree_leaves(want)))
        _, loss_restored = train_step(restored, *full_batch)
        _, loss_original = train_step(state, *full_batch)
        out["c_checkpoint"] = {
            "leaves": 3 * len(tree_leaves(state.params)), "unequal_leaves": unequal,
            "step": int(restored.step), "save_s": saved_s, "load_s": loaded_s,
            "bytes": sum(f.stat().st_size for f in Path(TRAIN_DIR).iterdir()),
            "next_loss": [float(loss_restored), float(loss_original)], "card": card}
        print(json.dumps({"train_c_checkpoint": out["c_checkpoint"]}), flush=True)
        if unequal or int(restored.step) != TRAIN_STEPS \
                or float(loss_restored) != float(loss_original):
            raise fail(f"train (c): the checkpoint did not round-trip: {out['c_checkpoint']}")
        if profile:
            out["a_full_tinyllama"]["profile"] = profile_call(
                lambda: train_step(state, *full_batch))
        del state, restored, reference, pairs, init_state, train_step
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        torch.cuda.empty_cache()

        # (b) LoRA over an int8 llama-3-8b
        gen.manual_seed(seed)
        base = shard_params(init_params_quantized(lora_config, gen, torch.bfloat16, device=device),
                            mesh, lora_config, quantized=True)
        before = [leaf.to_local().cpu() for leaf in tree_leaves(base)]
        init_lora_state, lora_step = make_lora_train_step(lora_config, mesh, quantized_base=True)
        adapters = init_lora(lora_config, gen, rank=TRAIN_LORA_RANK, device=device)
        lora_state = init_lora_state(adapters)
        lora_batch = batch(TRAIN_LORA_BATCH, lora_config.vocab_size)
        lora_state, out["b_lora_llama3_8b"] = train_drive(
            "b_lora_llama3_8b", lora_step, lora_state, (base, *lora_batch),
            TRAIN_LORA_BATCH[0] * TRAIN_LORA_BATCH[1], card)
        # one more step with the int8 product as a plain expression, whose
        # backward keeps the activation-dtype copy of every int8 matrix:
        # the peak the autograd function in models/quant.py saves
        from operator_tpu_torch.models import llama

        fused_mm = llama.mm
        llama.mm = lambda x, w: (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype) \
            if isinstance(w, dict) else x @ w
        try:
            torch.cuda.reset_peak_memory_stats()
            lora_state, _ = lora_step(lora_state, base, *lora_batch)
            torch.cuda.synchronize()
            out["b_lora_llama3_8b"]["max_memory_allocated_gib_plain_int8_mm"] = (
                torch.cuda.max_memory_allocated() / 2**30)
        finally:
            llama.mm = fused_mm
        if profile:
            out["b_lora_llama3_8b"]["profile"] = profile_call(
                lambda: lora_step(lora_state, base, *lora_batch))
        changed = sum(not torch.equal(leaf.to_local().cpu(), was)
                      for leaf, was in zip(tree_leaves(base), before))
        int8 = [leaf.dtype for leaf in tree_leaves(base)].count(torch.int8)
        out["b_lora_llama3_8b"].update(base_leaves=len(before), base_int8_leaves=int8,
                                       base_changed_leaves=changed)
        if changed or int8 != 7:
            raise fail(f"train (b): the int8 base changed ({changed} leaves) or is not int8 "
                       f"({int8} int8 leaves)")
        del base, before, lora_state, adapters
        torch.cuda.empty_cache()

        # (d) the card against the CPU, tiny-test in f32
        cpu_mesh = make_mesh(MeshPlan(), device_type="cpu")
        cpu_gen = torch.Generator(device="cpu").manual_seed(seed)
        params = init_params(TINY_TEST, cpu_gen, torch.float32, device="cpu")
        tokens = torch.randint(0, TINY_TEST.vocab_size, (4, 32), generator=cpu_gen,
                               dtype=torch.int32)
        mask = torch.ones(4, 32)
        losses: dict = {}
        for where, on in ((device, mesh), ("cpu", cpu_mesh)):
            init_state, train_step = make_train_step(TINY_TEST, on)
            state = init_state(tree_map(lambda t: t.to(where), params))
            losses[where] = []
            for _ in range(TRAIN_STEPS):
                state, loss = train_step(state, tokens.to(where), mask.to(where))
                losses[where].append(float(loss))
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses[device], losses["cpu"]))
        out["d_card_vs_cpu"] = {"losses": losses, "max_rel_diff": worst}
        print(json.dumps({"train_d_card_vs_cpu": out["d_card_vs_cpu"]}), flush=True)
        if worst > TRAIN_CPU_RTOL:
            raise fail(f"train (d): card and CPU losses differ by {worst} relative: {losses}")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        dist.destroy_process_group()
    launches = {name: m.launches for name, m in kernel_modules.items()}
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - begun
    print(json.dumps({"train": {"launches": launches, "wall_s": out["wall_s"], "card": card}}),
          flush=True)
    if any(launches.values()):
        raise fail(f"train: the training path launched a hand-written kernel: {launches}")
    results["train"] = out
    return launches


#: the parity phase's shared prefix (byte tokens: 144 cached at page 16)
PARITY_PREFIX = (
    "You are a Kubernetes failure analyst. Explain the failure using the pattern "
    "evidence and log excerpts provided below; answer with Root Cause and Fix. "
)


def prefix_parity(params_cpu, to, kernel_modules: dict) -> dict:
    """A prefixed wave and a chunked wave (chunk 16) of small f32
    ``tiny-test`` wave engines on the card and on the CPU: the same greedy
    tokens, flash prefill on (the prefix build's and the plain waves' K4
    on the card), the decode kernel launched."""
    import torch

    from operator_tpu_torch.models import TINY_TEST, ByteTokenizer
    from operator_tpu_torch.serving.engine import Generator
    from operator_tpu_torch.serving.types import SamplingParams

    sampling = SamplingParams(max_tokens=16, temperature=0.0, stop_on_eos=False)
    waves = [[PARITY_PREFIX + "pod one OOMKilled", PARITY_PREFIX + "pod two exit code 1"],
             [LOG_LINE, LOG_LINE[:30]]]

    def run(device):
        generator = Generator(
            to(params_cpu, device), TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=256,
            page_size=16, cache_dtype=torch.float32, device=device, decode_block=4,
            pipeline_depth=2, prefill_chunk=16,
        )
        generator.set_shared_prefix(PARITY_PREFIX)
        tokens = []
        for prompts in waves:
            slots = generator.admit(prompts, [sampling] * len(prompts))
            results = {}
            while generator.num_active or generator._inflight_blocks:
                for slot_id, result in generator.step():
                    results[slot_id] = result
            tokens.append([results[s].token_ids for s in slots])
        counter = generator.metrics.counter
        return tokens, {"prefix_waves": counter("prefill_waves_prefix"),
                        "chunks": generator.metrics.stage("prefill_chunk").count}

    saved = os.environ.get("OPERATOR_TPU_FLASH_PREFILL")
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    try:
        for module in kernel_modules.values():
            module.launches = 0
        card, card_counts = run("cuda")
        launches = {name: m.launches for name, m in kernel_modules.items()}
        cpu, cpu_counts = run("cpu")
    finally:
        if saved is None:
            os.environ.pop("OPERATOR_TPU_FLASH_PREFILL", None)
        else:
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = saved
    record = {"tokens_equal": card == cpu, "card": card_counts, "cpu": cpu_counts,
              "launches": launches}
    print(json.dumps({"prefix_parity": record}), flush=True)
    if (card != cpu or card_counts != cpu_counts or card_counts["prefix_waves"] != 1
            or card_counts["chunks"] < 2 or not launches["paged_decode_attention"]
            or launches["ragged_paged_attention"] or launches["best_window_similarity"]):
        raise fail(f"prefix parity: card {card} cpu {cpu}, {record}")
    return record


def store_parity(params_cuda, params_cpu) -> dict:
    """The continuous scheduler with the prefix cache and an 8 MB host
    pool, f32 ``tiny-test``: prompts sharing a prefix arrive in two waves
    with a ``spill_cache()`` and one short request (whose commit window
    puts the spilled pages into the pool) between them, so the second
    wave restores from pinned host memory.  The card must give the CPU's
    tokens, and on the card the warm wave the cold one's."""
    import torch

    from operator_tpu_torch.models import TINY_TEST, ByteTokenizer
    from operator_tpu_torch.ops.kv_transfer import HostKVPool
    from operator_tpu_torch.serving.engine import Generator, ServingEngine
    from operator_tpu_torch.serving.kvstore import PrefixKVStore
    from operator_tpu_torch.serving.sched import Scheduler
    from operator_tpu_torch.serving.types import SamplingParams

    head = LOG_LINE * 2
    prompts = [head + "pod a", head + "pod b restarted", head[:100], LOG_LINE[:50]]
    sampling = SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False)

    def run(device, params):
        generator = Generator(
            params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=256, page_size=16,
            cache_dtype=torch.float32, device=device,
        )
        store = PrefixKVStore(16, host_pool=HostKVPool(8), metrics=generator.metrics)
        sched = Scheduler(generator, chunk=16, token_budget=32, pipeline_depth=2,
                          spec_decode=True, kvstore=store)
        engine = ServingEngine(generator, sched)
        try:
            cold = [r.token_ids for r in engine.generate_batch(prompts, sampling)]
            spilled = sched.spill_cache()
            engine.generate_batch(["drain"], SamplingParams(max_tokens=1, temperature=0.0))
            warm = [r.token_ids for r in engine.generate_batch(prompts, sampling)]
            acc = sched.page_accounting()
            if sum(acc[k] for k in ("available", "row_pages", "store_pages", "prefix_pages")) != acc["total"]:
                raise fail(f"store parity on {device}: pages do not balance {acc}")
            counter = generator.metrics.counter
            return {"cold": cold, "warm": warm, "spilled": spilled,
                    "offloads": counter("kv_offload"), "restores": counter("kv_restore"),
                    "saved": counter("kv_prefill_tokens_saved")}
        finally:
            engine.close()

    card, cpu = run("cuda", params_cuda), run("cpu", params_cpu)
    if card != cpu:
        raise fail(f"store parity: the card's run differs from the CPU's: {card} vs {cpu}")
    if card["warm"] != card["cold"] or not card["restores"] or not card["offloads"]:
        raise fail(f"store parity on the card: warm != cold or no pool round trip: {card}")
    out = {k: v for k, v in card.items() if k not in ("cold", "warm")}
    print(json.dumps({"store_parity": "ok", **out}), flush=True)
    return out


def analysis_parity(kernel_modules: dict) -> dict:
    """``PatternEngine.analyze`` with one tiny f32 ``NeuralEmbedder`` on the
    card and on the CPU over the 12 fixture logs: the same events (pattern,
    source, context), scores within 1e-4 (one step of the 4-digit rounding
    of an event's score; compared by pattern, since a rounding step can
    reorder events of equal score), K5 once per analysis on the card."""
    import torch

    from operator_tpu_torch.models.encoder import ENCODER_TINY_TEST, init_encoder_params
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher
    from operator_tpu_torch.schema.analysis import PodFailureData

    params = init_encoder_params(ENCODER_TINY_TEST, torch.Generator().manual_seed(0),
                                 torch.float32, device="cpu")

    def tokenize(text):
        return [b % ENCODER_TINY_TEST.vocab_size for b in text.encode()]

    def engine(device):
        embedder = NeuralEmbedder(params, ENCODER_TINY_TEST, tokenize, max_tokens=64,
                                  batch_size=8, device=device)
        return PatternEngine(semantic=SemanticMatcher(embedder, device=device))

    def events(result):
        return {e.matched_pattern.id: (e.source, e.context.line_number, e.context.matched_line,
                                       e.context.lines_before, e.context.lines_after, e.score)
                for e in result.events}

    card, cpu = engine("cuda"), engine("cpu")
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))
    for module in kernel_modules.values():
        module.launches = 0
    found = 0
    for name in names:
        failure = PodFailureData(logs="\n".join(fixture_lines(name)))
        got, want = events(card.analyze(failure)), events(cpu.analyze(failure))
        same = got.keys() == want.keys() and all(
            got[k][:-1] == want[k][:-1] and abs(got[k][-1] - want[k][-1]) <= 1e-4 + 1e-9
            for k in got)
        if not same:
            raise fail(f"analysis parity {name}: card {got} cpu {want}")
        found += len(got)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    want_launches = {name: 0 for name in kernel_modules}
    want_launches["best_window_similarity"] = len(names)
    if launches != want_launches:
        raise fail(f"analysis parity launches {launches}, want {want_launches}")
    out = {"logs": len(names), "events": found, "launches": launches}
    print(json.dumps({"analysis_parity": out}), flush=True)
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the graphs phase: the serving programs as captured CUDA graphs
# ---------------------------------------------------------------------------

#: the phase's AOT caches, LoRA files and the warm boot's plan
GRAPHS_DIR = os.path.join(ROOT, "build", "chip_smoke_graphs")
#: the wave grid's automaton (``precompile_grid``'s guided choice): (c)'s
#: guided rows use it, so their tables restack into the captured buffer
GRAPHS_CHOICE = ("warm", "cold")
#: the block drives' tokens (the guided phase's are 64): five blocks of
#: 32 rows each, the eager ones at 0.2-0.3 s a block
GRAPHS_BLOCK_TOKENS = 16


def graph_params(n: int, tokens: int = MAX_TOKENS, **extra) -> list:
    """Half greedy, half sampled; no row stops at EOS, so two drives of the
    same requests take the same steps whatever the sampled rows draw."""
    from operator_tpu_torch.serving.types import SamplingParams

    return [SamplingParams(max_tokens=tokens, temperature=0.0 if i % 2 == 0 else 0.7,
                           top_p=0.95, stop_on_eos=False, **extra) for i in range(n)]


#: each counted kernel module's kernels in a device trace, by symbol
#: (``ops/csrc``; K1's split merge kernel belongs to its one counted launch)
KERNEL_SYMBOLS = {
    name: re.compile(rf"(?<![a-z_]){symbol}(?![a-z_])")  # demangled or mangled
    for name, symbol in (
        ("ragged_paged_attention", "ragged_attention(_tc)?_kernel"),
        ("paged_decode_attention", "paged_decode(_tc)?_kernel"),
        ("flash_prefill_attention", "flash_prefill(_tc)?_kernel"),
        ("best_window_similarity", "best_window_(tiled|rows)"),
    )
}


def traced(drive) -> tuple:
    """``drive()`` under ``torch.profiler`` tracing the device only (no
    host operator events: they would slow the eager drive's host): its
    result, the device's busy share of the wall, and for each counted
    module how many of its kernels the trace holds (replays included) and
    how they group by the call that launched them (a graph replay
    launches all of its kernels under one correlation id): {group size:
    groups}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        result = drive()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3
    # the raw device events (kernels, copies, memsets): building the
    # profiler's Python event tree for a drive's every kernel takes minutes
    device_ns = 0
    kernels = dict.fromkeys(KERNEL_SYMBOLS, 0)
    launches: dict = {module: {} for module in KERNEL_SYMBOLS}
    for event in prof.profiler.kineto_results.events():
        if event.device_type() != DeviceType.CUDA:
            continue
        device_ns += event.duration_ns()
        name = event.name()
        for module, symbol in KERNEL_SYMBOLS.items():
            if symbol.search(name):
                kernels[module] += 1
                by_launch = launches[module]
                by_launch[event.correlation_id()] = by_launch.get(event.correlation_id(), 0) + 1
    groups: dict = {module: {} for module in KERNEL_SYMBOLS}
    for module, by_launch in launches.items():
        for size in by_launch.values():
            groups[module][size] = groups[module].get(size, 0) + 1
    return result, device_ns / 1e6 / wall_ms, kernels, groups


def graph_drive(engine, prompts: list, params: list, kernel_modules: dict, where: str,
                *, profile: bool = False) -> dict:
    """One held drive through ``engine.submit``, every kernel count set to
    0 just before and read just after, each checked exactly: K1 once per
    layer per step (continuous); K2/K3 once per layer per step of each
    block and K4 once per layer per prefill wave (wave, flash prefill on).
    Returns the answers, tokens/s from the release, the stream ms per
    step or block and, with ``profile``, the device's busy share; the
    trace then bounds each count."""
    g, sched = engine.generator, engine.scheduler
    for module in kernel_modules.values():
        module.launches = 0
    stream = sched.device_ms if sched is not None else g.block_ms
    ms0 = len(stream)
    steps0 = sched.steps if sched is not None else g.blocks_dispatched
    waves0 = g.prefill_waves
    timing: dict = {}
    sends = [lambda p=p, sp=sp: engine.submit(p, sp).result(timeout=600)
             for p, sp in zip(prompts, params)]

    def drive():
        results = held_sends(engine, sends, timing=timing)[0]
        wall = time.perf_counter() - timing["released"]
        # settled inside a trace's window: a step still in flight belongs
        # to the drive's counts, so its kernels belong to its trace
        deadline = time.time() + 30
        while (g.num_active or g._inflight_blocks) and time.time() < deadline:
            time.sleep(0.01)
        if sched is not None:
            wait_idle(sched)
        return results, wall

    busy = in_trace = groups = None
    if profile:
        (results, wall), busy, in_trace, groups = traced(drive)
    else:
        results, wall = drive()
    launches = {name: m.launches for name, m in kernel_modules.items()}
    layers = g.config.num_layers
    if sched is not None:
        steps = sched.steps - steps0
        want = {"ragged_paged_attention": layers * steps}
    else:
        steps = g.blocks_dispatched - steps0
        want = {"paged_decode_attention": layers * g.decode_block * steps,
                "flash_prefill_attention": layers * (g.prefill_waves - waves0)}
    want = {name: want.get(name, 0) for name in kernel_modules}
    if launches != want or steps == 0:
        raise fail(f"graphs {where}: launches {launches} over {steps} steps, want {want}")
    if in_trace is not None:
        # CUPTI loses records at a graph's rate (llama-3-8b on an H100: 20,
        # 296 and 30 of 2,784 K1 records in three runs, as whole and
        # partial replays),
        # so the trace bounds the counts: never more kernels than counted,
        # none of a counted kernel missing entirely, and no launch holding
        # more than one step (or block, or wave) launches
        in_trace = {name: in_trace[name] for name in kernel_modules}
        per_launch = {"ragged_paged_attention": layers,
                      "paged_decode_attention": layers * g.decode_block,
                      "flash_prefill_attention": layers}
        if any(in_trace[name] > want[name] or (want[name] and not in_trace[name])
               or max(groups[name], default=0) > per_launch.get(name, 0)
               for name in kernel_modules):
            raise fail(f"graphs {where}: the trace holds kernels {in_trace}, want {want}; "
                       f"kernels per launch {groups}")
    tokens = sum(r.completion_tokens for r in results)
    ms = stream[ms0:]
    return {
        "answers": [list(r.token_ids) for r in results], "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall, "steps": steps,
        "stream_ms_per_step": sum(ms) / len(ms) if ms else None,
        "launches": launches, "launches_in_trace": in_trace,
        "kernels_per_launch_in_trace": groups and {k: v for k, v in groups.items() if v},
        "busy_share": busy,
    }


def greedy_equal(graph: dict, eager: dict, params: list, where: str) -> int:
    """The greedy rows' answers of two drives must be equal; returns how
    many rows were compared."""
    rows = [i for i, sp in enumerate(params) if sp.temperature == 0.0]
    differ = [i for i in rows if graph["answers"][i] != eager["answers"][i]]
    if differ:
        raise fail(f"graphs {where}: greedy answers of rows {differ} differ from eager")
    return len(rows)


def graph_summary(drive: dict) -> dict:
    return {k: v for k, v in drive.items() if k != "answers"}


def captured(g, since: int = 0) -> list:
    return [[name, repr(key), seconds] for name, key, seconds in g.graphs.log[since:]]


def watched_bringup(env: dict, tokenizer=None, *, seed: int = 0, prepare=None) -> tuple:
    """``build_serving_engine`` and the warmup grid at ``WARMUP_GRID`` under a ``CompileWatcher``;
    ``prepare(engine)`` runs between the two.  Returns (engine, watcher,
    the bring-up record)."""
    import torch

    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.utils.compilewatch import CompileWatcher
    from operator_tpu_torch.utils.config import OperatorConfig

    torch.cuda.empty_cache()
    watcher = CompileWatcher()
    started = time.perf_counter()
    engine, model_id = build_serving_engine("cuda", env, seed=seed)
    if tokenizer is not None:
        engine.generator.tokenizer = tokenizer
    if prepare is not None:
        prepare(engine)
    built = time.perf_counter() - started
    report = asyncio.run(engine.precompile(OperatorConfig.from_env(env).warmup_grid))
    torch.cuda.synchronize()
    g = engine.generator
    record = {
        "model": model_id, "build_s": built, "bringup_s": time.perf_counter() - started,
        "precompile": report, "captures": len(g.graphs.log),
        "capture_s": g.graphs.capture_s, "pool_bytes": g.graphs.pool_bytes(),
        "builds": [e[1] for e in watcher.events() if e[1].startswith("nvcc:")],
    }
    watcher.mark()
    return engine, watcher, record


def graphs_continuous(name: str, env: dict, prompts: list, kernel_modules: dict,
                      tokenizer=None) -> dict:
    """(a): one continuous engine from ``build_serving_engine`` with the
    warmup grid and the AOT cache; the held drive with graphs and with the
    un-captured step (``make_mixed_step``'s function, ``Scheduler._mixed_fn``),
    each cold (the prefix cache spilled), then each traced over the first
    four requests at 16 tokens."""
    engine, watcher, out = watched_bringup(env, tokenizer)
    sched = engine.scheduler
    params = graph_params(len(prompts))
    try:
        out["captured"] = captured(engine.generator)
        program = sched._fn
        step = sched._mixed_fn()

        def eager(*args, key=None):
            return step(*args)

        # the traced drives are short (the first four requests, 16 tokens):
        # a trace of every kernel of the whole drive takes minutes to sum
        traced_prompts, traced_params = prompts[:4], graph_params(4, tokens=16)
        drives = {}
        for mode, profile in (("graph", False), ("eager", False), ("eager", True),
                              ("graph", True)):
            sched._fn = program if mode == "graph" else eager
            sched.spill_cache()
            drives[(mode, profile)] = graph_drive(
                engine, *((traced_prompts, traced_params) if profile else (prompts, params)),
                kernel_modules, f"{name} {mode}", profile=profile)
        sched._fn = program
        after = watcher.events_since_mark()
        if after:
            raise fail(f"graphs {name}: captured or built after precompile: {after}")
        graph, eager = drives[("graph", False)], drives[("eager", False)]
        out["greedy_rows_equal"] = greedy_equal(graph, eager, params, name)
        greedy_equal(drives[("graph", True)], drives[("eager", True)], traced_params, name)
        out["graph"] = {**graph_summary(graph), "busy_share": drives[("graph", True)]["busy_share"]}
        out["eager"] = {**graph_summary(eager), "busy_share": drives[("eager", True)]["busy_share"]}
        out["traced"] = {
            "requests": len(traced_prompts), "max_tokens": 16,
            **{key: {m: drives[(m, True)][key] for m in ("graph", "eager")}
               for key in ("steps", "launches", "launches_in_trace")},
            "kernels_per_launch_in_trace": drives[("graph", True)]["kernels_per_launch_in_trace"],
        }
        out["graph_over_eager"] = {
            "tokens_per_s": graph["tokens_per_s"] / eager["tokens_per_s"],
            "stream_ms_per_step": graph["stream_ms_per_step"] / eager["stream_ms_per_step"],
        }
        out["after_precompile"] = {"captures": 0, "builds": 0}
        out["aot"] = engine.generator._aot.stats()
        return out
    finally:
        watcher.close()
        engine.close()


def graphs_wave_blocks(engine, eager_programs_of) -> dict:
    """The guided phase's block drives at 32 rows (16 tokens, sampled) on
    the (c) engine, with graphs and eager: no LoRA pass, on the stack,
    every row adapted, every row guided (the root-cause schema); median
    block ms."""
    from operator_tpu_torch.serving.json_schema import lower_guided_json
    from operator_tpu_torch.serving.types import SamplingParams

    g = engine.generator
    json_regex = lower_guided_json(ROOT_CAUSE_SCHEMA)
    short = [(LOG_LINE * 2)[:48 + i] for i in range(g.max_slots)]
    extra = {"no_lora_pass": {}, "plain": {}, "adapter": {"adapter": "incident"},
             "guided": {"guided_regex": json_regex}}

    def sends(kind: str) -> list:
        params = SamplingParams(max_tokens=GRAPHS_BLOCK_TOKENS, temperature=0.7,
                                stop_on_eos=False, **extra[kind])
        return [lambda i=i: engine.submit(short[i], params).result(timeout=300)
                for i in range(g.max_slots)]

    out = {}
    for kind in extra:
        for mode in ("graph", "eager"):
            restore = eager_programs_of(g) if mode == "eager" else None
            stack = g.lora
            if kind == "no_lora_pass":
                g.lora = None
            try:
                out[f"{kind}_{mode}"] = timed_blocks(engine, kind, sends(kind))
            finally:
                g.lora = stack
                if restore is not None:
                    restore()
    return {"rows": g.max_slots, "tokens": GRAPHS_BLOCK_TOKENS, **out,
            "graph_over_eager": {k: out[f"{k}_graph"]["median_ms"] / out[f"{k}_eager"]["median_ms"]
                                 for k in extra}}


def eager_wave_programs(g):
    """Swap the wave engine's programs for their un-captured functions;
    returns the undo."""
    saved = (g._decode_program, g._decode_guided_program, g._prefill_program)

    def decode(*args, key=None):
        return g._decode_block_paged(*args)

    def prefill(*args, key=None, variant=None):
        return g._prefill(*args)

    g._decode_program = g._decode_guided_program = decode
    g._prefill_program = prefill

    def restore():
        g._decode_program, g._decode_guided_program, g._prefill_program = saved

    return restore


def graphs_wave(env: dict, kernel_modules: dict) -> tuple:
    """(c): the guided phase's wave engine (LORA_DIR, 32 slots, flash
    prefill) with ``WARMUP_GRID=full`` and the AOT cache; plain, adapted,
    guided and mixed held drives with graphs and eager (greedy answers
    equal, K2/K3 and K4 exact), then (b)'s warm boot is run by the caller
    and the block drives and (d) follow.  Returns (engine, watcher, record)."""
    engine, watcher, out = watched_bringup(env)
    g = engine.generator
    if engine.scheduler is not None or g.max_slots != 32 or not g.adapter_names:
        raise fail("graphs (c): not the 32-slot wave engine with adapters")
    out["captured"] = len(g.graphs.log)
    prompts = [(LOG_LINE * (n // len(LOG_LINE) + 1))[:n] for n in PROMPT_CHARS]
    kinds = {
        "plain": [{}] * len(prompts),
        "adapted": [{"adapter": "incident"}] * len(prompts),
        "guided": [{"guided_choice": GRAPHS_CHOICE}] * len(prompts),
        "mixed": [[{}, {"adapter": "verbose"}, {"guided_choice": GRAPHS_CHOICE},
                   {"adapter": "incident", "guided_choice": GRAPHS_CHOICE}][i % 4]
                  for i in range(len(prompts))],
    }
    drives = {}
    for kind, extras in kinds.items():
        params = [dataclasses.replace(sp, **extra)
                  for sp, extra in zip(graph_params(len(prompts)), extras)]
        graph = graph_drive(engine, prompts, params, kernel_modules, f"wave {kind} graph",
                            profile=kind == "mixed")
        restore = eager_wave_programs(g)
        try:
            eager = graph_drive(engine, prompts, params, kernel_modules, f"wave {kind} eager")
        finally:
            restore()
        drives[kind] = {"greedy_rows_equal": greedy_equal(graph, eager, params, f"wave {kind}"),
                        "graph": graph_summary(graph), "eager": graph_summary(eager)}
    after = watcher.events_since_mark()
    out["after_precompile"] = {"captures": len(after), "events": [e[1] for e in after]}
    out["drives"] = drives
    out["aot"] = g._aot.stats()
    return engine, watcher, out


def graphs_restart(engine, kernel_modules: dict) -> dict:
    """(d): a one-shot device error mid-drive on the (c) engine: one
    supervised restart, every request in flight requeued, no graph
    captured again."""
    from operator_tpu_torch.utils.faultinject import OK, FaultPlan, raise_

    g = engine.generator
    prompts = [(LOG_LINE * 2)[:40 + 20 * i] for i in range(8)]
    params = graph_params(len(prompts))
    counts0 = supervisor_counts(g.metrics)
    captures0 = g.graphs.captures
    plan = FaultPlan(seed=11)
    plan.rule("engine.step", [OK, OK, OK, raise_(
        lambda: RuntimeError("injected device error"), "device")])
    g.fault_plan = plan
    try:
        drive = graph_drive(engine, prompts, params, {}, "restart")
    finally:
        g.fault_plan = None
    counts = {k: v - counts0[k] for k, v in supervisor_counts(g.metrics).items()}
    out = {"supervisor": counts, "captures_after_restart": g.graphs.captures - captures0,
           "tokens": drive["tokens"], "pending_faults": plan.pending()}
    if (counts["restart"] != 1 or counts["requeue"] != len(prompts) or counts["gaveup"]
            or out["captures_after_restart"] or plan.pending()
            or drive["tokens"] != len(prompts) * MAX_TOKENS):
        raise fail(f"graphs (d): {out}")
    return out


def graphs_analysis(kernel_modules: dict) -> dict:
    """(e): the analysis phase's long drive (MiniLM-L6 width, the encoder
    buckets as one graph) with graphs and eager: wall, encoder stream ms,
    and every event's score within SIM_TOL of eager's."""
    import torch

    from operator_tpu_torch.models.encoder import MINILM_L6, encode, init_encoder_params
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher
    from operator_tpu_torch.schema.analysis import PodFailureData

    params = init_encoder_params(MINILM_L6, torch.Generator(device="cuda").manual_seed(0),
                                 torch.float32, device="cuda")
    embedder = NeuralEmbedder(params, MINILM_L6, byte_ids, device="cuda")
    matcher = SemanticMatcher(embedder, device="cuda")
    engine = PatternEngine(semantic=matcher)
    timed = TimedEmbedder(embedder)
    matcher.embedder = timed
    engine.analyze(PodFailureData(logs="\n".join(fixture_lines("oom_java.log"))))  # capture
    program = embedder._encode
    logs = crash_loop_log()
    out, events = {}, {}
    for mode in ("graph", "eager", "eager", "graph"):
        embedder._encode = program if mode == "graph" else (
            lambda p, ids, mask, key=None: encode(p, MINILM_L6, ids, mask))
        calls0 = len(timed.embed.calls)
        started = time.perf_counter()
        result = engine.analyze(PodFailureData(logs=logs))
        wall_ms = (time.perf_counter() - started) * 1e3
        spans = timed.embed.spans_ms()[calls0:]
        out.setdefault(mode, []).append({"wall_ms": wall_ms, "encoder_stream_ms": sum(spans)})
        events[mode] = [(e.matched_pattern.id, e.score) for e in result.events]
    embedder._encode = program
    graph, eager = events["graph"], events["eager"]
    worst = max((abs(a[1] - b[1]) for a, b in zip(graph, eager)), default=0.0)
    if [e[0] for e in graph] != [e[0] for e in eager] or not worst <= SIM_TOL:
        raise fail(f"graphs (e): events differ from eager (worst score diff {worst})")
    if embedder.graphs.captures != 1:
        raise fail(f"graphs (e): {embedder.graphs.captures} encoder captures, want 1")
    return {"events": len(graph), "max_score_diff": worst, "tolerance": SIM_TOL,
            "replays": embedder.graphs.replays, **out}


def launch_count_cost(adds: int = 88, replays: int = 200) -> dict:
    """What the kernels' launch counters cost inside a graph: one graph of
    ``adds`` counted launches' device adds (a tinyllama decode block's
    22 layers x 4 steps of K2/K3), replayed back to back, CUDA-event
    timed: device ms per replay and us per add."""
    import torch

    from operator_tpu_torch.ops import _build

    counter = _build.LaunchCounter()
    device = torch.device("cuda", torch.cuda.current_device())
    counter.launched(device)  # the eager launch that makes the device counter
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(adds):
            counter.launched(device)
    graph.replay()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = begin.elapsed_time(end) / replays
    if counter.value() != 1 + adds * (replays + 1):
        raise fail(f"launch counter: {counter.value()} after {replays + 1} replays of {adds}")
    return {"adds": adds, "replays": replays, "ms_per_replay": ms, "us_per_add": ms * 1e3 / adds}


def graphs_warm_boot(plan_path: str) -> int:
    """(b), in its own process: each engine of the plan built on its AOT
    cache again — no ``nvcc`` build, every capture a hit (as many as the
    cache holds records), nothing stored, and no capture or build after
    precompile over a short drive."""
    with open(plan_path) as fh:
        plan = json.load(fh)
    out = {}
    for name, env, prompts in plan:
        engine, watcher, record = watched_bringup(env)
        try:
            aot = engine.generator._aot
            stats = aot.stats()
            records = len(aot.records())
            params = graph_params(len(prompts), tokens=8)
            for future in [engine.submit(p, sp) for p, sp in zip(prompts, params)]:
                future.result(timeout=600)
            after = [e[1] for e in watcher.events_since_mark()]
            record.update({"records": records, "aot": stats, "after_precompile": after})
            if (record["builds"] or stats["hits"] != records or stats["stored"]
                    or stats["live_compiles"] or after or records == 0):
                raise fail(f"graphs (b) {name}: warm boot {record}")
            out[name] = {k: v for k, v in record.items() if k != "precompile"}
        finally:
            watcher.close()
            engine.close()
    print(json.dumps({"graphs_warm": out}), flush=True)
    return 0


def phase_graphs(results: dict, kernel_modules: dict, seed: int) -> dict:
    """The serving programs as captured CUDA graphs (see the module doc):
    (a) the continuous path at tinyllama-1.1b and llama-3-8b, (c) the wave
    path, (b) a warm boot of both tinyllama engines in a second process,
    the block drives, (d) a supervised restart, (e) the analysis."""
    from operator_tpu_torch.models.configs import get_config
    from operator_tpu_torch.models.tokenizer import load_tokenizer
    from operator_tpu_torch.serving.prompts import build_prompt

    card = card_line()
    out: dict = {"card": card}
    part_s = out["part_s"] = {}
    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        part_s[name] = now - mark[0]
        mark[0] = now

    shutil.rmtree(GRAPHS_DIR, ignore_errors=True)
    os.makedirs(GRAPHS_DIR)
    saved = os.environ.get("OPERATOR_TPU_FLASH_PREFILL")
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    try:
        serve_env = {**SERVE_ENV, "WARMUP_GRID": "serving",
                     "AOT_CACHE_PATH": os.path.join(GRAPHS_DIR, "aot")}
        prompts = [(LOG_LINE * (n // len(LOG_LINE) + 1))[:n] for n in PROMPT_CHARS]
        out["a_tinyllama"] = graphs_continuous("tinyllama", serve_env, prompts, kernel_modules)
        print(json.dumps({"graphs_a_tinyllama": out["a_tinyllama"], "card": card}), flush=True)
        lap("a_tinyllama")
        tokenizer = load_tokenizer(LLAMA3_TOKENIZER)
        requests, _ = deployed_requests(tokenizer)
        out["a_llama3"] = graphs_continuous(
            "llama-3-8b", {**DEPLOYED_ENV, "WARMUP_GRID": "serving",
                           "AOT_CACHE_PATH": os.path.join(GRAPHS_DIR, "aot")},
            [build_prompt(r) for r in requests], kernel_modules, tokenizer)
        print(json.dumps({"graphs_a_llama3": out["a_llama3"], "card": card}), flush=True)
        lap("a_llama3")

        lora_dir = os.path.join(GRAPHS_DIR, "lora")
        write_lora_dir(lora_dir, get_config("tinyllama-1.1b"), seed)
        wave_env = {**SERVE_ENV, "LORA_DIR": lora_dir, "PREFIX_CACHE": "false",
                    "WARMUP_GRID": "full",
                    "AOT_CACHE_PATH": os.path.join(GRAPHS_DIR, "aot")}
        engine, watcher, wave = graphs_wave(wave_env, kernel_modules)
        try:
            out["c_wave"] = wave
            print(json.dumps({"graphs_c": wave, "card": card}), flush=True)
            lap("c_wave")
            # (b) the warm boot, in a second process on the same caches
            plan_path = os.path.join(GRAPHS_DIR, "warm_plan.json")
            with open(plan_path, "w") as fh:
                json.dump([["tinyllama_continuous", serve_env, prompts[:4]],
                           ["tinyllama_wave", wave_env, prompts[:4]]], fh)
            started = time.perf_counter()
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--graphs-warm", plan_path],
                capture_output=True, text=True, timeout=600, cwd=ROOT)
            lines = [line for line in child.stdout.splitlines() if line.startswith("{")]
            if child.returncode != 0 or not lines:
                raise fail(f"graphs (b): the warm boot exited {child.returncode}: "
                           f"{child.stderr[-2000:]}")
            warm = json.loads(lines[-1])["graphs_warm"]
            warm["process_s"] = time.perf_counter() - started
            warm["cold_bringup_s"] = {"tinyllama_continuous": out["a_tinyllama"]["bringup_s"],
                                      "tinyllama_wave": wave["bringup_s"]}
            out["b_warm_boot"] = warm
            print(json.dumps({"graphs_b": warm, "card": card}), flush=True)
            lap("b_warm_boot")
            out["c_block_ms"] = graphs_wave_blocks(engine, eager_wave_programs)
            print(json.dumps({"graphs_c_blocks": out["c_block_ms"], "card": card}), flush=True)
            lap("c_blocks")
            out["d_restart"] = graphs_restart(engine, kernel_modules)
            print(json.dumps({"graphs_d": out["d_restart"], "card": card}), flush=True)
            lap("d_restart")
        finally:
            watcher.close()
            engine.close()
        out["e_analysis"] = graphs_analysis(kernel_modules)
        print(json.dumps({"graphs_e": out["e_analysis"], "card": card}), flush=True)
        lap("e_analysis")
        out["launch_count_cost"] = launch_count_cost()
        print(json.dumps({"graphs_launch_count_cost": out["launch_count_cost"], "card": card}),
              flush=True)
        print(json.dumps({"graphs_part_s": part_s, "card": card}), flush=True)
        results["graphs"] = out
        return out
    finally:
        if saved is None:
            os.environ.pop("OPERATOR_TPU_FLASH_PREFILL", None)
        else:
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = saved
        shutil.rmtree(GRAPHS_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: the port as it is deployed — Dockerfile.torch and
# deploy/overlays/h100, each pod run as the kubelet runs it
# ---------------------------------------------------------------------------

DEPLOY_OVERLAY = os.path.join(ROOT, "deploy", "overlays", "h100")
DEPLOY_DOCKERFILE = os.path.join(ROOT, "Dockerfile.torch")
#: where the pods run; a CPU rehearsal sets "cpu" (each command then ends
#: in ``--device cpu``), with DEPLOY_CONFIG (a ModelConfig's fields, under
#: the overlay's model name) registered in each pod by the launch hook and
#: DEPLOY_PREBUILD (a command) in place of the image's nvcc step
DEPLOY_DEVICE = "cuda"
DEPLOY_CONFIG = None
DEPLOY_PREBUILD = None
DEPLOY_REQUESTS = 10
#: the analyze requests' tokens: long enough to be in flight at SIGTERM
DEPLOY_TOKENS = 128
#: free disk wanted beyond the checkpoint's own bytes
DEPLOY_DISK_MARGIN = 2 * 2**30
DEPLOY_POLL_S = 0.1
#: the pods' launch hook (a ``sitecustomize`` on their PYTHONPATH): each
#: kernel's launches written at exit, and a rehearsal's config registered
DEPLOY_HOOK = """
import atexit, json, os, sys
KERNELS = {"ragged_paged_attention": "operator_tpu_torch.ops.ragged_attention",
           "paged_decode_attention": "operator_tpu_torch.ops.paged_attention",
           "flash_prefill_attention": "operator_tpu_torch.ops.flash_prefill",
           "best_window_similarity": "operator_tpu_torch.ops.similarity"}
def dump():
    counts = {name: (sys.modules[module].launches if module in sys.modules else 0)
              for name, module in KERNELS.items()}
    with open(os.environ["CHIP_SMOKE_LAUNCHES_PATH"], "w") as fh:
        json.dump(counts, fh)
atexit.register(dump)
if os.environ.get("CHIP_SMOKE_DEPLOY_CONFIG"):
    sys.path.insert(0, os.getcwd())  # where ``-m`` finds the package, later on
    from operator_tpu_torch.models.configs import ModelConfig, register_config
    register_config(ModelConfig(**json.loads(os.environ["CHIP_SMOKE_DEPLOY_CONFIG"])))
"""
#: the machine's environment a container keeps (what the image's base
#: layers and the device plugin would give it)
DEPLOY_KEEP_ENV = ("LD_LIBRARY_PATH", "LANG", "LC_ALL", "LC_CTYPE", "PYTHONPATH",
                   "CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                   "NVIDIA_DRIVER_CAPABILITIES")


def memory_bytes(quantity: str) -> int:
    """A Kubernetes memory quantity (``48Gi``, ``512Mi``, ``16G``) in bytes."""
    units = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
             "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}
    for unit, factor in units.items():
        if quantity.endswith(unit):
            return int(float(quantity[:-len(unit)]) * factor)
    return int(quantity)


def probe_window_s(probe: dict) -> float:
    """How long after the container starts the kubelet gives ``probe``
    before it acts: the first check's delay and every allowed failure
    (Kubernetes' defaults: period 10 s, threshold 3)."""
    return (probe.get("initialDelaySeconds", 0)
            + probe.get("periodSeconds", 10) * probe.get("failureThreshold", 3))


def stop_budget_s(spec: dict, container: dict) -> float:
    """The grace period less the preStop hook's sleep: what SIGTERM
    leaves the process."""
    hook = ((container.get("lifecycle") or {}).get("preStop") or {}).get("exec") or {}
    command = hook.get("command") or []
    sleep = float(command[1]) if command[:1] == ["sleep"] else 0.0
    return spec.get("terminationGracePeriodSeconds", 30) - sleep


def tree_listing(directory: str) -> dict:
    """Every file under ``directory``: (size, mtime in ns)."""
    out = {}
    for base, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(base, name)
            info = os.stat(path)
            out[os.path.relpath(path, directory)] = (info.st_size, info.st_mtime_ns)
    return out


def image_tree(stage, app: str) -> None:
    """The stage's ``COPY`` lines from the checkout into ``app`` (its
    WORKDIR); a copy from another stage is the pre-built directory, which
    the caller names instead."""
    for sources, destination, origin in stage.copies:
        if origin is not None:
            continue
        for source in sources:
            src = os.path.join(ROOT, source)
            dst = os.path.join(app, destination)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True,
                                ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"))
            else:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)


def machine_path() -> str:
    """PATH with this interpreter first and no directory that holds
    ``nvcc``: the runtime image has no CUDA toolkit."""
    dirs = [os.path.dirname(sys.executable), *os.environ.get("PATH", "").split(os.pathsep)]
    return os.pathsep.join(dict.fromkeys(
        d for d in dirs if d and not os.path.exists(os.path.join(d, "nvcc"))))


def pod_environment(obj: dict, container: dict, image_env: dict, volumes: dict,
                    workdir: str, pod_name: str) -> tuple:
    """What the kubelet gives the container: the image's ENV, then the
    rendered ``env`` (downward API from ``pod_name``), with each path
    under a volume's mount and each image path in ``volumes`` remapped,
    and a Service name in a URL pointed at this pod (the one endpoint
    the headless Service would resolve to).  Returns (env, remaps)."""
    mounts = {m["mountPath"]: volumes[m["name"]] for m in container.get("volumeMounts", [])}
    mounts.update(volumes.get("image", {}))
    remaps: dict = {}

    def remap(name: str, value: str) -> str:
        for mount, target in sorted(mounts.items(), key=lambda kv: -len(kv[0])):
            if value == mount or value.startswith(mount.rstrip("/") + "/"):
                new = target + value[len(mount.rstrip("/")):]
                remaps[name] = [value, new]
                return new
        match = re.fullmatch(r"(https?://)([a-z0-9-]+)(:\d+.*)", value)
        if match and match.group(2) != "localhost":
            new = f"{match.group(1)}127.0.0.1{match.group(3)}"
            remaps[name] = [value, new]
            return new
        return value

    home = os.path.join(workdir, pod_name, "home")
    tmp = os.path.join(workdir, pod_name, "tmp")
    os.makedirs(home, exist_ok=True)
    os.makedirs(tmp, exist_ok=True)
    env = {k: os.environ[k] for k in DEPLOY_KEEP_ENV if k in os.environ}
    env.update({"PATH": machine_path(), "HOME": home, "TMPDIR": tmp})
    for name, value in image_env.items():
        env[name] = remap(name, value)
    fields = {"metadata.name": pod_name, "metadata.namespace": obj["metadata"]["namespace"]}
    for entry in container.get("env", []):
        if "valueFrom" in entry:
            env[entry["name"]] = fields[entry["valueFrom"]["fieldRef"]["fieldPath"]]
        else:
            env[entry["name"]] = remap(entry["name"], str(entry.get("value", "")))
    return env, remaps


def pod_volumes(spec: dict, workdir: str, pod_name: str) -> dict:
    """Each volume of the pod spec -> a directory: a claim's by its name
    (pods of one claim share it), an emptyDir the pod's own."""
    out = {}
    for volume in spec.get("volumes", []):
        claim = (volume.get("persistentVolumeClaim") or {}).get("claimName")
        path = (os.path.join(workdir, "claims", claim) if claim
                else os.path.join(workdir, pod_name, volume["name"]))
        os.makedirs(path, exist_ok=True)
        out[volume["name"]] = path
    return out


class PodSampler:
    """A pod process's resident host memory and the card's memory in use
    beyond ``baseline``, sampled on a thread: ``VmHWM`` (the kernel's
    peak) where ``/proc/<pid>/status`` has it, and the largest ``VmRSS``
    seen; the caller adds the ``ru_maxrss`` of the reaped process."""

    def __init__(self, pid: int, baseline: "int | None") -> None:
        self.pid, self.baseline = pid, baseline
        self.vm_hwm = 0
        self.vm_rss = 0
        self.card_peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="pod-sampler", daemon=True)
        self._thread.start()

    def sample(self) -> None:
        try:
            with open(f"/proc/{self.pid}/status") as fh:
                for line in fh:
                    if line.startswith("VmHWM:"):
                        self.vm_hwm = max(self.vm_hwm, int(line.split()[1]) * 1024)
                    elif line.startswith("VmRSS:"):
                        self.vm_rss = max(self.vm_rss, int(line.split()[1]) * 1024)
        except OSError:
            pass
        if self.baseline is not None:
            import torch

            free, total = torch.cuda.mem_get_info()
            self.card_peak = max(self.card_peak, total - free - self.baseline)

    def _run(self) -> None:
        while not self._stop.wait(0.25):
            self.sample()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(5)


def card_used() -> "int | None":
    if DEPLOY_DEVICE != "cuda":
        return None
    import torch

    free, total = torch.cuda.mem_get_info()
    return total - free


def port_free(port: int) -> bool:
    import socket

    with socket.socket() as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind(("0.0.0.0", port))
            return True
        except OSError:
            return False


def wait_for(check, proc, until: float, what: str, log_path: str) -> float:
    """Poll ``check()`` until true (a refused connection or an HTTP error
    reads as false) and return when.  Fails if the process ends or
    ``until`` passes."""
    while time.monotonic() < until:
        if proc.poll() is not None:
            raise fail(f"deploy: the pod exited {proc.returncode} before {what}; "
                       f"log tail: {log_tail(log_path)}")
        try:
            if check():
                return time.monotonic()
        except OSError:
            pass
        time.sleep(DEPLOY_POLL_S)
    raise fail(f"deploy: no {what} by the deadline; log tail: {log_tail(log_path)}")


def log_tail(path: str, size: int = 3000) -> str:
    with open(path, encoding="utf-8", errors="replace") as fh:
        return fh.read()[-size:]


def tcp_open(port: int) -> bool:
    import socket

    with socket.socket() as sock:
        sock.settimeout(1.0)
        return sock.connect_ex(("127.0.0.1", port)) == 0


def pod_command(container: dict) -> list:
    """The rendered command with ``python`` as this interpreter (the
    machine's, standing in for the image's)."""
    command = list(container["command"])
    if command[0] in ("python", "python3"):
        command[0] = sys.executable
    if DEPLOY_DEVICE != "cuda":
        command += ["--device", DEPLOY_DEVICE]
    return command


class Pod:
    """One container started as the kubelet starts it, its output in a
    log, its memory sampled, and its launch counts read at its exit."""

    def __init__(self, name: str, obj: dict, image, kernels_dir: str, workdir: str,
                 hook_dir: str, extra_env: "dict | None" = None) -> None:
        self.name = name
        self.spec = obj["spec"]["template"]["spec"]
        self.container = self.spec["containers"][0]
        volumes = pod_volumes(self.spec, workdir, name)
        volumes["image"] = {image.env["OPERATOR_TPU_TORCH_BUILD_DIR"]: kernels_dir}
        self.env, self.remaps = pod_environment(obj, self.container, image.env, volumes,
                                                workdir, name)
        self.launches_path = os.path.join(workdir, name, "launches.json")
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (hook_dir, self.env.get("PYTHONPATH")) if p)
        self.env["CHIP_SMOKE_LAUNCHES_PATH"] = self.launches_path
        if DEPLOY_CONFIG is not None:
            self.env["CHIP_SMOKE_DEPLOY_CONFIG"] = json.dumps(DEPLOY_CONFIG)
        self.env.update(extra_env or {})
        self.command = pod_command(self.container)
        self.log_path = os.path.join(workdir, f"{name}.log")
        self.proc = None
        self.sampler = None
        self.max_rss = 0  # the reaped process's ru_maxrss, bytes
        self.children_max_rss = 0  # the largest earlier child's, bytes

    def start(self, app: str) -> float:
        import resource

        baseline = card_used()
        self.children_max_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
        with open(self.log_path, "w") as log:
            started = time.monotonic()
            self.proc = subprocess.Popen(self.command, cwd=app, env=self.env, stdout=log,
                                         stderr=subprocess.STDOUT)
        self.sampler = PodSampler(self.proc.pid, baseline)
        return started

    def terminate(self, budget_s: float) -> tuple:
        """SIGTERM, then the exit code and its seconds (None past twice
        the budget, so a hung drain fails instead of stalling the run).
        The process is reaped with ``wait4``, for its own ``ru_maxrss``."""
        import signal

        self.sampler.sample()
        self.proc.send_signal(signal.SIGTERM)
        sent = time.monotonic()
        while time.monotonic() < sent + 2 * budget_s:
            pid, status, usage = os.wait4(self.proc.pid, os.WNOHANG)
            if pid:
                self.proc.returncode = os.waitstatus_to_exitcode(status)
                self.max_rss = usage.ru_maxrss * 1024  # kB on Linux
                return self.proc.returncode, time.monotonic() - sent
            time.sleep(0.02)
        return None, time.monotonic() - sent

    def close(self) -> None:
        if self.sampler is not None:
            self.sampler.stop()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)

    def launches(self) -> dict:
        if not os.path.exists(self.launches_path):
            raise fail(f"deploy: {self.name} wrote no launch counts at exit; "
                       f"log tail: {log_tail(self.log_path)}")
        with open(self.launches_path) as fh:
            return json.load(fh)

    def memory(self, limit: "str | None") -> dict:
        """The peak resident host memory by each reading (the largest is
        the one held to ``limit``) and the card's peak in use.  The
        reaped ``ru_maxrss`` counts only when it exceeds every earlier
        child's: a kernel that reports the largest of all children there
        (as the card's machine does) cannot attribute a smaller one."""
        readings = {"vm_hwm_gib": self.sampler.vm_hwm / 2**30,
                    "vm_rss_max_sampled_gib": self.sampler.vm_rss / 2**30,
                    "ru_maxrss_gib": (self.max_rss / 2**30
                                      if self.max_rss > self.children_max_rss else 0.0)}
        return {"peak_rss_gib": max(readings.values()), **readings,
                "ru_maxrss_reaped_gib": self.max_rss / 2**30,
                "earlier_children_max_rss_gib": self.children_max_rss / 2**30,
                "limit": limit, "limit_gib": memory_bytes(limit) / 2**30 if limit else None,
                "card_gib": (self.sampler.card_peak / 2**30
                             if self.sampler.baseline is not None else None)}


def deploy_prebuild(stage, app: str, kernels_dir: str) -> subprocess.Popen:
    """(a) The image's pre-build step (the build stage's RUN that runs
    the port's ops module) in a child with no card visible, into a fresh
    directory standing for the stage's OPERATOR_TPU_TORCH_BUILD_DIR."""
    [run] = [r for r in stage.runs if "operator_tpu_torch.ops" in r]
    command = DEPLOY_PREBUILD or shlex.split(run)
    if command[0] in ("python", "python3"):
        command = [sys.executable, *command[1:]]
    env = {**os.environ, **stage.env, "OPERATOR_TPU_TORCH_BUILD_DIR": kernels_dir,
           "CUDA_VISIBLE_DEVICES": ""}
    print(json.dumps({"deploy_prebuild_command": command, "remap": {
        "OPERATOR_TPU_TORCH_BUILD_DIR": [stage.env["OPERATOR_TPU_TORCH_BUILD_DIR"],
                                         kernels_dir]}}), flush=True)
    return subprocess.Popen(command, cwd=app, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def deploy_checkpoint(directory: str, model: str) -> dict:
    """(b) A seeded ``model`` checkpoint in bf16, HF layout, written by
    the loader's own writer, with the committed Llama-3 tokenizer."""
    import torch

    from operator_tpu_torch.models.configs import get_config
    from operator_tpu_torch.models.llama import init_params
    from operator_tpu_torch.models.loader import save_params

    config = get_config(model)
    per_layer = (2 * config.hidden_size * config.num_heads * config.head_dim
                 + 2 * config.hidden_size * config.num_kv_heads * config.head_dim
                 + 3 * config.hidden_size * config.intermediate_size + 2 * config.hidden_size)
    need = 2 * (config.num_layers * per_layer + 2 * config.vocab_size * config.hidden_size
                + config.hidden_size)
    os.makedirs(directory, exist_ok=True)
    free = shutil.disk_usage(directory).free
    if free < need + DEPLOY_DISK_MARGIN:
        raise fail(f"deploy: the {model} checkpoint needs {need / 2**30:.1f} GiB and "
                   f"{DEPLOY_DISK_MARGIN / 2**30:.0f} GiB to spare under {directory}, "
                   f"which has {free / 2**30:.1f} GiB free")
    seeded = init_params(config, torch.Generator(device=DEPLOY_DEVICE).manual_seed(0),
                         torch.bfloat16, device=DEPLOY_DEVICE)
    started = time.perf_counter()
    files = save_params(seeded, directory, config)
    write_s = time.perf_counter() - started
    del seeded
    if DEPLOY_DEVICE == "cuda":
        release_card()
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(LLAMA3_TOKENIZER, name), os.path.join(directory, name))
    written = sum(os.path.getsize(os.path.join(directory, f)) for f in files)
    return {"model": model, "files": len(files), "bytes": written,
            "expected_bytes": need, "disk_free_gib_before": free / 2**30,
            "write_s": write_s, "write_gb_per_s": written / write_s / 1e9,
            "tokenizer": os.path.relpath(LLAMA3_TOKENIZER, ROOT)}


def deploy_serving(pod: Pod, app: str, report) -> dict:
    """(c) The serving replica: start → listening → ``/healthz`` 200 →
    a first completion; ten analyze requests at once and SIGTERM while
    the engine holds all ten: every one answered 200, exit 0 within the
    grace period less the preStop sleep."""
    import http.client

    port = next(p["containerPort"] for p in pod.container["ports"] if p["name"] == "http")
    window = probe_window_s(pod.container["startupProbe"])
    budget = stop_budget_s(pod.spec, pod.container)
    if not port_free(port):
        raise fail(f"deploy: port {port} is taken on this machine")
    started = pod.start(app)
    until = started + window
    listening = wait_for(lambda: tcp_open(port), pod.proc, until, "listening", pod.log_path)
    ready = wait_for(lambda: http_get(port, "/healthz")[0] == 200, pod.proc, until,
                     "/healthz 200", pod.log_path)
    first = _post(f"http://127.0.0.1:{port}/v1/completions",
                  {"prompt": "pod crashed with exit code 137", "max_tokens": 8,
                   "temperature": 0.0}, timeout=window)
    answered = time.monotonic()
    if not first.get("choices"):
        raise fail(f"deploy: the first completion came back without choices: {first}")
    out = {"start_to_listening_s": listening - started, "start_to_healthz_s": ready - started,
           "start_to_first_answer_s": answered - started, "startup_window_s": window}
    for key in ("start_to_listening_s", "start_to_healthz_s", "start_to_first_answer_s"):
        report(f"serving_{key}", out[key], startup_window_s=window)

    # ten analyze requests, each sent whole before SIGTERM
    requests = provider_requests()[:DEPLOY_REQUESTS]
    answers: list = [None] * len(requests)
    connections = []
    for request in requests:
        request.provider_config.max_tokens = DEPLOY_TOKENS
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2 * budget + 60)
        conn.request("POST", "/api/v1/analysis/analyze", json.dumps(request.to_dict()),
                     {"Content-Type": "application/json"})
        connections.append(conn)

    def answer(i: int) -> None:
        try:
            response = connections[i].getresponse()
            answers[i] = (response.status, time.monotonic(), json.loads(response.read()))
        except (OSError, http.client.HTTPException, ValueError) as exc:
            answers[i] = (None, time.monotonic(), repr(exc))

    readers = [threading.Thread(target=answer, args=(i,), daemon=True)
               for i in range(len(requests))]
    for thread in readers:
        thread.start()

    def held() -> bool:
        load = healthz(port).get("load") or {}
        return load.get("queueDepth", 0) + load.get("inflight", 0) >= len(requests)

    wait_for(held, pod.proc, time.monotonic() + 60, "all ten requests in the engine",
             pod.log_path)
    before = sum(a is not None for a in answers)
    rc, exit_s = pod.terminate(budget)
    terminated = time.monotonic() - exit_s
    for thread in readers:
        thread.join(2 * budget + 60)
    statuses = [a[0] if a else None for a in answers]
    bad = [a for a in answers if not a or a[0] != 200 or not isinstance(a[2], dict)
           or a[2].get("error") or not a[2].get("completionTokens")]
    drain = {"requests": len(requests), "answered_before_sigterm": before,
             "statuses": statuses,
             "answered_after_sigterm_s": [a[1] - terminated for a in answers if a],
             "completion_tokens": [a[2].get("completionTokens") for a in answers
                                   if a and isinstance(a[2], dict)],
             "exit_code": rc, "sigterm_to_exit_s": exit_s, "stop_budget_s": budget}
    out["drain"] = drain
    report("serving_drain", drain)
    if before or bad or rc != 0 or exit_s > budget:
        raise fail(f"deploy: the serving pod's drain: {drain}; bad answers {bad[:2]}; "
                   f"log tail: {log_tail(pod.log_path)}")
    if out["start_to_healthz_s"] > window / 2:
        raise fail(f"deploy: the serving pod took {out['start_to_healthz_s']:.1f} s to "
                   f"/healthz, over half its startup window of {window:.0f} s")
    return out


def deploy_operator(pod: Pod, app: str, facade, serving_obj: dict, model: str,
                    report) -> dict:
    """(d) The operator against the stub apiserver: start → listening →
    ``/healthz/live`` → ``/healthz/ready`` → a failing pod's stored
    analysis (its first, which loads the model), then SIGTERM: exit 0
    within the grace period less the preStop sleep, the Lease released."""
    api = facade.api
    port = next(p["containerPort"] for p in pod.container["ports"] if p["name"] == "health")
    window = probe_window_s(pod.container["startupProbe"])
    ready_window = probe_window_s(pod.container["readinessProbe"])
    budget = stop_budget_s(pod.spec, pod.container)
    lease_ns = pod.env["LEASE_NAMESPACE"]
    if not port_free(port):
        raise fail(f"deploy: port {port} is taken on this machine")

    async def seed() -> None:
        await api.create("Deployment", json.loads(json.dumps(serving_obj)))
        for kind, obj in fleet_resources(model, "tpu-native", {"deploy": DEPLOY_TOKENS}):
            await api.create(kind, obj)

    facade.call(seed())
    started = pod.start(app)
    listening = wait_for(lambda: tcp_open(port), pod.proc, started + window, "listening",
                         pod.log_path)
    live = wait_for(lambda: http_get(port, "/healthz/live")[0] == 200, pod.proc,
                    started + window, "/healthz/live 200", pod.log_path)
    ready = wait_for(lambda: http_get(port, "/healthz/ready")[0] == 200, pod.proc,
                     started + ready_window, "/healthz/ready 200", pod.log_path)
    api.set_pod_log("prod", "payment-deploy", "\n".join(fixture_lines("oom_java.log")),
                    previous=True)
    seeded = time.monotonic()
    facade.call(api.create("Pod", operator_pod("payment-deploy", "deploy",
                                               "2026-07-28T13:00:00Z")))
    entry, poked = None, 0
    until = seeded + OPERATOR_QUEUE_S + 300
    while time.monotonic() < until and pod.proc.poll() is None:
        status = facade.call(api.get("Podmortem", "watch-payment-deploy", "ops")).get("status")
        entries = (status or {}).get("recentFailures") or []
        if entries:
            entry = entries[0]
            break
        if time.monotonic() - seeded > 5 * (poked + 1):
            poked += 1  # the MODIFIED the watcher reacts to, if the pod came first
            facade.call(api.patch("Pod", "payment-deploy", "prod", {
                "metadata": {"labels": {"poked": str(poked)}}}))
        time.sleep(DEPLOY_POLL_S)
    stored = time.monotonic()
    out = {"start_to_listening_s": listening - started, "start_to_live_s": live - started,
           "start_to_ready_s": ready - started, "pod_to_stored_s": stored - seeded,
           "start_to_stored_s": stored - started, "startup_window_s": window,
           "readiness_window_s": ready_window,
           "status": (entry or {}).get("analysisStatus")}
    for key in ("start_to_listening_s", "start_to_live_s", "start_to_ready_s",
                "pod_to_stored_s", "start_to_stored_s"):
        report(f"operator_{key}", out[key], startup_window_s=window,
               readiness_window_s=ready_window)
    rc, exit_s = pod.terminate(budget)
    lease = facade.call(api.get("Lease", "podmortem-tpu-operator", lease_ns))["spec"]
    out["stop"] = {"exit_code": rc, "sigterm_to_exit_s": exit_s, "stop_budget_s": budget,
                   "lease_holder": lease.get("holderIdentity")}
    report("operator_stop", out["stop"])
    if entry is None or out["status"] != "Analyzed":
        raise fail(f"deploy: the operator stored {entry} for the failing pod; "
                   f"log tail: {log_tail(pod.log_path)}")
    if rc != 0 or exit_s > budget or lease.get("holderIdentity") != "":
        raise fail(f"deploy: the operator's stop: {out['stop']}; "
                   f"log tail: {log_tail(pod.log_path)}")
    if out["start_to_live_s"] > window / 2:
        raise fail(f"deploy: the operator took {out['start_to_live_s']:.1f} s to "
                   f"/healthz/live, over half its startup window of {window:.0f} s")
    return out


def phase_deploy(results: dict, kernel_modules: dict) -> dict:
    """``Dockerfile.torch`` and ``deploy/overlays/h100`` on this machine:
    (a) the image's kernel pre-build, (b) a seeded checkpoint of the
    overlay's model, (c) the serving pod and (d) the operator pod, each
    run as the kubelet runs its container (the rendered command and env
    on the image's tree and ENV; only the build directory, the volumes'
    paths and a Service URL remapped, each remap printed).  Returns the
    kernels' launches summed over both pods."""
    import tempfile

    from operator_tpu_torch.models.configs import get_config, register_config
    from operator_tpu_torch.operator.kubefacade import KubeFacade
    from operator_tpu_torch.ops import _build
    from operator_tpu_torch.utils import manifests

    card = card_line()
    out: dict = {"card": card}

    def report(name: str, value, **extra) -> None:
        print(json.dumps({f"deploy_{name}": value, **extra, "card": card}), flush=True)

    if DEPLOY_CONFIG is not None:
        from operator_tpu_torch.models.configs import ModelConfig

        register_config(ModelConfig(**DEPLOY_CONFIG))
    objects = manifests.render(DEPLOY_OVERLAY)
    build, image = manifests.read_dockerfile(DEPLOY_DOCKERFILE)
    serving_obj = manifests.deployment(objects, "podmortem-serving")
    operator_obj = manifests.deployment(objects, "podmortem-tpu-operator")
    if DEPLOY_DEVICE == "cuda":
        release_card()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="deploy-", dir=os.path.join(ROOT, "build"))
    pods: list = []
    facade = None
    try:
        app = os.path.join(workdir, "app")  # the image's WORKDIR
        image_tree(image, app)
        hook_dir = os.path.join(workdir, "hook")
        os.makedirs(hook_dir)
        with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as fh:
            fh.write(DEPLOY_HOOK)
        kernels_dir = os.path.join(workdir, "kernels")

        serving = Pod("serving", serving_obj, image, kernels_dir, workdir, hook_dir)
        pods.append(serving)
        model = serving.env["MODEL_ID"]
        # (a) the pre-build, beside (b)'s checkpoint write
        started = time.perf_counter()
        prebuild = deploy_prebuild(build, app, kernels_dir)
        # (b) the checkpoint, where the pods' CHECKPOINT_DIR points
        out["checkpoint"] = deploy_checkpoint(serving.env["CHECKPOINT_DIR"], model)
        report("checkpoint", out["checkpoint"])
        stdout, stderr = prebuild.communicate(timeout=900)
        prebuild_s = time.perf_counter() - started
        lines = [line for line in stdout.splitlines() if line.startswith("{")]
        if prebuild.returncode != 0 or not lines:
            raise fail(f"deploy: the pre-build exited {prebuild.returncode}: {stderr[-3000:]}")
        built = json.loads(lines[-1])
        want = [_build.library_path(name).name for name in _build.source_names()]
        listing = tree_listing(kernels_dir)
        missing = [name for name in want if name not in listing]
        if DEPLOY_PREBUILD is None and missing:
            raise fail(f"deploy: the pre-build left no library for {missing}: {built}")
        out["prebuild"] = {"seconds": built["seconds"], "process_s": prebuild_s,
                           "libraries": sorted(listing), "sources": _build.source_names(),
                           "overlapped_with": "the checkpoint write"}
        report("prebuild_s", built["seconds"], process_s=prebuild_s,
               libraries=len(listing), sources=len(want))

        # (c) and (d), one after the other, on the same checkpoint
        report("serving_pod", {"command": serving.command, "remaps": serving.remaps})
        out["serving"] = deploy_serving(serving, app, report)
        serving.close()
        out["serving"]["memory"] = serving.memory(
            manifests.container(serving_obj)["resources"]["limits"].get("memory"))
        out["serving"]["launches"] = serving.launches()
        report("serving_memory", out["serving"]["memory"])
        facade = KubeFacade(namespace=operator_obj["metadata"]["namespace"]).start()
        kubeconfig = facade.write_kubeconfig(os.path.join(workdir, "kubeconfig"))
        operator = Pod("operator", operator_obj, image, kernels_dir, workdir, hook_dir,
                       {"KUBECONFIG": kubeconfig})
        operator.remaps["KUBECONFIG"] = ["(in-cluster service account)", kubeconfig]
        pods.append(operator)
        report("operator_pod", {"command": operator.command, "remaps": operator.remaps})
        out["operator"] = deploy_operator(operator, app, facade, serving_obj, model, report)
        operator.close()
        limit = manifests.container(operator_obj)["resources"]["limits"].get("memory")
        out["operator"]["memory"] = operator.memory(limit)
        out["operator"]["launches"] = operator.launches()
        report("operator_memory", out["operator"]["memory"])
        out["load_order"] = ("serving first, from the checkpoint just written (its pages "
                             "may still be cached); operator second, warm")

        # nothing was built by a pod, and each pod ran the main path's kernel
        after = tree_listing(kernels_dir)
        out["no_pod_build"] = {"files": len(after), "unchanged": after == listing,
                               "nvcc_on_a_pods_path": [p.name for p in pods if shutil.which(
                                   "nvcc", path=p.env["PATH"])]}
        report("no_pod_build", out["no_pod_build"])
        if after != listing or out["no_pod_build"]["nvcc_on_a_pods_path"]:
            raise fail(f"deploy: a pod changed the pre-built directory: "
                       f"{sorted(set(after.items()) ^ set(listing.items()))}")
        for name, part in (("serving", out["serving"]), ("operator", out["operator"])):
            memory = part["memory"]
            if not memory["peak_rss_gib"]:
                raise fail(f"deploy: no reading of the {name} pod's resident memory: {memory}")
            if memory["limit"] and memory["peak_rss_gib"] > memory["limit_gib"]:
                raise fail(f"deploy: the {name} pod's peak RSS {memory['peak_rss_gib']:.2f} "
                           f"GiB is over its limit {memory['limit']}")
        total = {name: out["serving"]["launches"][name] + out["operator"]["launches"][name]
                 for name in kernel_modules}
        layers = get_config(model).num_layers
        if DEPLOY_DEVICE == "cuda" and (
                out["serving"]["launches"]["ragged_paged_attention"] < layers
                or out["operator"]["launches"]["ragged_paged_attention"] < layers
                or total["paged_decode_attention"] or total["flash_prefill_attention"]):
            raise fail(f"deploy: the pods' launches: serving {out['serving']['launches']}, "
                       f"operator {out['operator']['launches']}")
        out["launches"] = total
        report("launches", {"serving": out["serving"]["launches"],
                            "operator": out["operator"]["launches"]})
        results["deploy"] = out
        return total
    finally:
        for pod in pods:
            pod.close()
        if facade is not None:
            facade.stop()
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase: the model families beyond Llama on the continuous main path
# ---------------------------------------------------------------------------

#: part -> (model, layers kept; None: full depth).  Each at full width, its
#: whole context served (``SERVING_MAX_SEQ``: its ``max_seq_len``) and int8 as
#: SERVE_ENV deploys it;
#: (d) loads a bf16 checkpoint written from the seeded tree
FAMILIES = {"a": ("mistral-7b", None), "b": ("qwen2.5-7b", 4), "c": ("llama-3.2-3b", 4),
            "d": ("qwen2.5-1.5b", None)}
#: (layers, hidden, query heads, KV heads) each part must have
FAMILY_SHAPES = {"mistral-7b": (32, 4096, 32, 8), "qwen2.5-7b": (4, 3584, 28, 4),
                 "llama-3.2-3b": (4, 3072, 24, 8), "qwen2.5-1.5b": (28, 1536, 12, 2)}
FAMILIES_ENV = {**SERVE_ENV, "WARMUP_GRID": "serving"}
FAMILIES_DIR = os.path.join(ROOT, "build", "chip_smoke_families")
FAMILIES_DEVICE = "cuda"
#: (a)'s prompts: a shared head of 4,400 characters (4,401 tokens with
#: BOS: 68 pages, 4,352 tokens, cached by a priming request, more than
#: the window) and ten tails, so every prompt is 4,500-7,000 tokens
MISTRAL_SHARED_CHARS = 4400
MISTRAL_TAIL_CHARS = [99, 300, 2598, 600, 1000, 1500, 200, 2000, 400, 800]
#: (a)'s held request: its decode steps' one live row at kv_len 6,601 and
#: up, so tile 0's first three splits of 512 lie wholly before its window
MISTRAL_HELD_TAIL = 2200
#: the seeded q/k/v biases' scale (init_params draws them as zeros, as JAX)
BIAS_STD = 0.5


def family_config(part: str):
    """(a part's config, registered under its name when cut in depth)."""
    from operator_tpu_torch.models import configs

    name, layers = FAMILIES[part]
    config = configs.get_config(name)
    if layers is not None:
        config = configs.scaled(config, num_layers=layers)
        configs.register_config(config)
    return config


def seeded_biases(layers: dict, seed: int) -> None:
    """Draw the q/k/v biases in place, from ``seed``."""
    import torch

    gen = torch.Generator(device=layers["bq"].device).manual_seed(seed)
    for name in ("bq", "bk", "bv"):
        layers[name].copy_(BIAS_STD * torch.randn(layers[name].shape, generator=gen,
                                                  device=layers[name].device))


def mistral_bodies() -> tuple:
    """(a)'s ten bodies, half greedy, and the shared head they start with;
    each tail starts with its own index, so no two prompts share more."""
    shared = (LOG_LINE * (MISTRAL_SHARED_CHARS // len(LOG_LINE) + 1))[:MISTRAL_SHARED_CHARS]
    bodies = []
    for i, n in enumerate(MISTRAL_TAIL_CHARS):
        tail = (f"[{i}] " + LOG_LINE * (n // len(LOG_LINE) + 1))[:n]
        bodies.append({"prompt": shared + tail, "max_tokens": MAX_TOKENS,
                       "temperature": 0.0 if i % 2 == 0 else 0.7, "top_p": 0.95})
    return bodies, shared


def family_drives(part: str, engine, model_id: str, config, kernel_modules: dict,
                  runs: int, bodies: list, prime: "str | None") -> dict:
    """``runs`` drives of ``bodies`` through the port's HTTP server, each
    after ``spill_cache()`` (and, with ``prime``, one request of that
    prompt, so the drive's prompts hit its cached pages), held until all
    are queued: K1 once per layer per step and no other kernel, pages
    balanced, the greedy answers of every drive the first's.  (a) adds
    one held request whose decode steps each hold all 32 K1 calls to the
    plain version.  Returns the drives' records."""
    import torch

    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.sched import mixed as mixed_module

    sched = engine.scheduler
    server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
    http = HttpLoop(server)
    url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
    out: dict = {}
    try:
        _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
        drives = []
        for run in range(runs):
            sched.spill_cache()
            if prime is not None:
                _post(url, {"prompt": prime, "max_tokens": 1, "temperature": 0.0})
                wait_idle(sched)
            drives.append(timed_drive(url, sched, config, kernel_modules,
                                      f"families ({part}) {run}", bodies, engine=engine))
        greedy = [i for i, body in enumerate(bodies) if body["temperature"] == 0.0]
        for drive in drives[1:]:
            differ = [i for i in greedy if drive["answers"][i] != drives[0]["answers"][i]]
            if differ:
                raise fail(f"families ({part}): greedy answers of rows {differ} differ "
                           f"between two identical drives")
        if prime is not None:
            want = len(bodies) * ((len(prime.encode()) + 1) // PAGE * PAGE)
            saved = [d["kv_economy"]["prefill_tokens_saved"] for d in drives]
            if saved != [want] * runs:
                raise fail(f"families ({part}): the drives reused {saved} prompt tokens, "
                           f"the primed head gives {want}")
        out["drives"] = [{k: v for k, v in d.items() if k != "answers"} for d in drives]
        out["greedy_rows_equal"] = len(greedy)
        out["answers"] = drives[0]["answers"]
        if part == "a":
            window = config.sliding_window
            held_prompt = prime + (LOG_LINE * (MISTRAL_HELD_TAIL // len(LOG_LINE) + 1))[
                :MISTRAL_HELD_TAIL]
            held = held_drive_calls(url, mixed_module, "ragged_paged_attention", HeldToPlain(
                mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
                config.num_layers, lambda dtype, _: TOL[dtype],
                # a decode or verify step whose every live row is past the window
                select=lambda q, k, v, table, kv_len, q_count: bool(
                    (q_count > 0).any() and ((q_count == 0) | (
                        (kv_len > window) & (q_count <= 1 + sched.spec_k))).all()),
                valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None]
                < args[4][:, None],
                note=k1_split_note,
            ), held_prompt)
            n_splits = ra.split_plan(config.max_seq_len)[0]
            if held["n_splits"] != n_splits or held["splits_before_window"] < 3:
                raise fail(f"families (a): the held K1 step's tile 0 {held}: want {n_splits} "
                           f"splits, at least 3 wholly before the window")
            out["held_calls"] = held
        out["page_accounting"] = balanced(sched, f"after the families ({part}) drives")
        return out
    finally:
        http.stop()


def families_part(part: str, kernel_modules: dict, seed: int) -> dict:
    """One part of the families phase: bring-up under a ``CompileWatcher``
    (its build and capture seconds), the drives, nothing captured or built
    after the warmup grid, the card's GiB."""
    import torch

    from operator_tpu_torch.models.llama import init_params
    from operator_tpu_torch.models.loader import save_params
    from operator_tpu_torch.models.quant import quantize_params

    config = family_config(part)
    shape = (config.num_layers, config.hidden_size, config.num_heads, config.num_kv_heads)
    if shape != FAMILY_SHAPES[FAMILIES[part][0]]:
        raise fail(f"families ({part}): not {FAMILIES[part][0]} at full width: {config}")
    env = {**FAMILIES_ENV, "OPERATOR_TPU_MODEL": config.name,
           "SERVING_MAX_SEQ": str(config.max_seq_len)}
    torch.cuda.reset_peak_memory_stats()
    out: dict = {"model": config.name, "layers": config.num_layers,
                 "max_seq": config.max_seq_len, "window": config.sliding_window,
                 "group": config.q_per_kv, "vocab": config.vocab_size,
                 "bias": config.attention_bias, "tied": config.tie_embeddings,
                 "rope_scaling": config.rope_scaling and config.rope_scaling.factor}
    def draw_biases(engine):
        seeded_biases(engine.generator.params["layers"], seed + 1)

    # (label, env, called between build and warmup grid, drives)
    engines = [("engine", env, draw_biases if config.attention_bias else None, 2)]
    tree = None
    if part == "d":
        # the seeded tree, its biases drawn, written as bf16 HF shards and
        # loaded int8 through CHECKPOINT_DIR (no tokenizer.json: bytes);
        # beside it an in-memory engine of the same draws and biases
        ckpt = os.path.join(FAMILIES_DIR, "qwen2.5-1.5b")
        seeded = init_params(config, torch.Generator(device=FAMILIES_DEVICE).manual_seed(seed),
                             torch.bfloat16, device=FAMILIES_DEVICE)
        seeded_biases(seeded["layers"], seed + 1)
        torch.cuda.synchronize()
        started = time.perf_counter()
        files = save_params(seeded, ckpt, config, shard_bytes=1 << 30)
        out["checkpoint"] = {
            "files": len(files), "write_s": time.perf_counter() - started,
            "bytes": sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)}
        tree = quantize_params(seeded, config)
        del seeded
        release_card()
        loaded = {k: v for k, v in env.items() if k != "ALLOW_RANDOM_WEIGHTS"}
        engines = [("loaded", {**loaded, "CHECKPOINT_DIR": ckpt}, None, 2),
                   ("in_memory", env, draw_biases, 1)]
    if part == "a":
        bodies, prime = mistral_bodies()
    else:
        bodies, prime = request_bodies(), None
    for label, engine_env, engine_prepare, runs in engines:
        engine, watcher, record = watched_bringup(engine_env, seed=seed, prepare=engine_prepare)
        try:
            # no name of the generator outlives the engine: release_card
            # below must find its weights and pages unreferenced
            if engine.generator.max_seq != config.max_seq_len or engine.scheduler is None:
                raise fail(f"families ({part}): {label} serves {engine.generator.max_seq} "
                           f"positions, scheduler {engine.scheduler}")
            if tree is not None and not trees_equal(engine.generator.params, tree):
                raise fail(f"families ({part}): the {label} tree is not the seeded tree's "
                           f"quantize_params, byte for byte")
            record["memory_gib"] = torch.cuda.memory_allocated() / 2**30
            record.update(family_drives(part, engine, record["model"], config,
                                        kernel_modules, runs, bodies, prime))
            after = watcher.events_since_mark()
            if after:
                raise fail(f"families ({part}): captured or built after the warmup grid: "
                           f"{after}")
            record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        finally:
            watcher.close()
            engine.close()
            del engine
            release_card()
        out[label] = record
    if part == "d":
        greedy = [i for i, body in enumerate(bodies) if body["temperature"] == 0.0]
        differ = [i for i in greedy
                  if out["loaded"]["answers"][i] != out["in_memory"]["answers"][i]]
        if differ:
            raise fail(f"families (d): greedy answers of rows {differ} differ from the "
                       f"in-memory engine's")
    for record in out.values():
        if isinstance(record, dict):
            record.pop("answers", None)
    return out


#: (e): the first four of (a)'s bodies on the wave engine (one prefill
#: wave of 4 x 8,192 positions beside the 34 GB pool)
MISTRAL_WAVE_REQUESTS = 4


def families_wave(kernel_modules: dict, seed: int) -> dict:
    """(e) mistral-7b at full depth on the wave engine (``SCHED_MODE=wave``,
    decode blocks of 4 at depth 2, flash prefill on, programs captured at
    first use), its whole context served: (a)'s first four bodies, 4,500-
    7,000 prompt tokens, twice through the HTTP server, each held until
    all are queued: K4 once per layer per prefill wave, K2/K3 once per
    layer per step of each block, nothing else; slots and pages free after
    each; the second drive's greedy answers the first's.  Then one more
    request, programs eager, whose first decode step's 32 K2/K3 calls are
    each held to the plain version (a row past the window)."""
    import torch

    pa = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    from operator_tpu_torch.serving.httpserver import CompletionServer

    config = family_config("a")
    env = {**WAVE_ENV, "OPERATOR_TPU_MODEL": config.name, "WARMUP_GRID": "off",
           "SERVING_MAX_SEQ": str(config.max_seq_len)}
    saved = os.environ.get("OPERATOR_TPU_FLASH_PREFILL")
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    torch.cuda.reset_peak_memory_stats()
    engine, watcher, out = watched_bringup(env, seed=seed)
    layers = config.num_layers
    try:
        if engine.scheduler is not None or engine.generator.max_seq != config.max_seq_len:
            raise fail("families (e): not the wave engine over mistral-7b's context")
        out["memory_gib"] = torch.cuda.memory_allocated() / 2**30
        server = CompletionServer(engine, model_id=out["model"], host="127.0.0.1", port=0)
        http = HttpLoop(server)
        url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
        bodies, shared = mistral_bodies()
        bodies = bodies[:MISTRAL_WAVE_REQUESTS]
        try:
            _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
            drives = [wave_drive(engine.generator, kernel_modules, f"families (e) {run}",
                                 lambda: held_requests(engine, url, bodies))
                      for run in range(2)]
            greedy = [i for i, body in enumerate(bodies) if body["temperature"] == 0.0]
            differ = [i for i in greedy if drives[1]["answers"][i] != drives[0]["answers"][i]]
            if differ:
                raise fail(f"families (e): greedy answers of rows {differ} differ between "
                           f"two identical drives")
            held_prompt = shared + (LOG_LINE * (MISTRAL_HELD_TAIL // len(LOG_LINE) + 1))[
                :MISTRAL_HELD_TAIL]
            window = config.sliding_window
            out["held_decode_calls"] = held_drive_calls(
                url, pa, "paged_attention", HeldToPlain(
                    pa.paged_attention, pa.paged_attention_reference, layers,
                    lambda dtype, _: WAVE_TOL[dtype],
                    select=lambda q, k, v, table, lengths, sliding_window=None: bool(
                        lengths.max().item() > window),
                    note=k2_split_note,
                ), held_prompt)
        finally:
            http.stop()
            del http, server  # the server holds the engine: release_card must not
        out["drives"] = [{k: v for k, v in d.items() if k != "answers"} for d in drives]
        out["greedy_rows_equal"] = len(greedy)
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return out
    finally:
        watcher.close()
        engine.close()
        del engine
        release_card()
        if saved is None:
            os.environ.pop("OPERATOR_TPU_FLASH_PREFILL", None)
        else:
            os.environ["OPERATOR_TPU_FLASH_PREFILL"] = saved


def phase_families(results: dict, kernel_modules: dict, seed: int) -> dict:
    """The model families beyond Llama on the continuous main path (see the
    module doc): (a) mistral-7b, (b) qwen2.5-7b, (c) llama-3.2-3b, (d)
    qwen2.5-1.5b from a checkpoint; then (e) mistral-7b on the wave
    engine; the card released between engines.  Returns the kernels'
    launches summed over the drives."""
    card = card_line()
    out: dict = {"card": card, "part_s": {}}
    total: dict = {}
    shutil.rmtree(FAMILIES_DIR, ignore_errors=True)
    os.makedirs(FAMILIES_DIR)
    try:
        for part in FAMILIES:
            begun = time.perf_counter()
            out[part] = families_part(part, kernel_modules, seed)
            out["part_s"][part] = time.perf_counter() - begun
            # the in-memory engine's drive is a comparison, not the path's
            for label, record in out[part].items():
                if label == "in_memory" or not isinstance(record, dict):
                    continue
                for drive in record.get("drives", []):
                    for name, n in drive["launches"].items():
                        total[name] = total.get(name, 0) + n
            print(json.dumps({f"families_{part}": out[part], "card": card}), flush=True)
        begun = time.perf_counter()
        out["e"] = families_wave(kernel_modules, seed)
        out["part_s"]["e"] = time.perf_counter() - begun
        for drive in out["e"]["drives"]:
            for name, n in drive["launches"].items():
                total[name] = total.get(name, 0) + n
        print(json.dumps({"families_e": out["e"], "card": card}), flush=True)
    finally:
        shutil.rmtree(FAMILIES_DIR, ignore_errors=True)
    results["families"] = out
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every result to this JSON file")
    parser.add_argument("--phases",
                        default="device,kernels,train,serve,wave,guided,graphs,analysis,"
                                "checkpoint,tokenizers,operator,remote,fleet,deployed,deploy,"
                                "fabric,prefix,contiguous,mesh,parity,families")
    parser.add_argument("--seed", type=int, default=0,
                        help="the guided, train and families phases' weights and adapters")
    parser.add_argument("--graphs-warm", metavar="PLAN",
                        help="the graphs phase's warm boot (b), in its own process")
    parser.add_argument("--mesh-rank", nargs=2, metavar=("SPEC", "RANK"),
                        help="one rank of the mesh phase's (b) or (c), in its own process")
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    if args.mesh_rank:
        return mesh_rank(args.mesh_rank[0], int(args.mesh_rank[1]))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.graphs_warm:
        return graphs_warm_boot(args.graphs_warm)
    try:
        from operator_tpu_torch.ops import _build
        from operator_tpu_torch.ops import flash_prefill, ragged_attention, similarity

        # the module: the package's ``paged_attention`` is the function, as in JAX
        paged_attention = importlib.import_module("operator_tpu_torch.ops.paged_attention")
    except ImportError as exc:
        print(f"chip_smoke: the operator_tpu_torch package is missing: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernel_modules = {
        "ragged_paged_attention": ragged_attention,
        "paged_decode_attention": paged_attention,
        "flash_prefill_attention": flash_prefill,
        "best_window_similarity": similarity,
    }
    card = card_line()
    print(card, flush=True)
    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    started = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - started
    print(json.dumps({"build_s": results["build_s"], "sources": _build.source_names()}), flush=True)
    results["tensor_core_instructions"] = tensor_core_instructions(_build)
    print(json.dumps({"tensor_core_instructions": results["tensor_core_instructions"]}), flush=True)
    no_mma = [name for name in ("ragged_attention", "paged_attention", "flash_prefill")
              if not results["tensor_core_instructions"][name]]
    if no_mma:
        raise fail(f"no tensor-core instruction (HMMA/HGMMA) in {no_mma}")

    # each phase's seconds, the build's (device) included; after each
    # phase, the threads left (and their names), the host CPU they burn
    # while this one sleeps (what a later phase competes with) and the
    # card's free memory
    phase_s = results["phase_s"] = {"device": time.perf_counter() - started}
    left_behind = results["left_behind"] = {}

    def timed(name: str, fn, *args, **kwargs):
        begun = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - begun
            cpu = time.process_time()
            time.sleep(0.2)
            left_behind[name] = {"threads": threading.active_count(),
                                 "idle_cpu_share": (time.process_time() - cpu) / 0.2,
                                 "names": sorted(t.name for t in threading.enumerate()),
                                 "device_free_gib": torch.cuda.mem_get_info()[0] / 2**30}

    records = []
    if "kernels" in phases:
        records = timed("kernels", lambda: [phase_kernels(results)] + phase_wave_kernels(results)
                        + [phase_similarity_kernels(results, phases)])
    train = timed("train", phase_train, results, kernel_modules, args.seed,
                  "profile" in phases) if "train" in phases else {}
    launches = timed("serve", phase_serve, results, kernel_modules, phases) \
        if "serve" in phases else {}
    if "serve" in phases:
        timed("serve", phase_serve_pool, results, kernel_modules)
    wave_launches = {
        selector: timed("wave", phase_wave, results, kernel_modules, phases, selector)
        for selector in (("v1", "v2") if "wave" in phases else ())
    }
    guided = timed("guided", phase_guided, results, kernel_modules, args.seed) \
        if "guided" in phases else {}
    if "graphs" in phases:
        timed("graphs", phase_graphs, results, kernel_modules, args.seed)
    analysis = timed("analysis", phase_analysis, results, kernel_modules, phases) \
        if "analysis" in phases else {}
    served = phases & {"tokenizers", "operator", "remote", "fleet"}
    if served and "checkpoint" not in phases:
        raise fail(f"the {', '.join(sorted(served))} phase serves the checkpoint phase's "
                   f"checkpoints: add checkpoint")
    checkpoint, dirs = (timed("checkpoint", phase_checkpoint, results, kernel_modules,
                              keep=bool(served))
                        if "checkpoint" in phases else ({}, None))
    tokenizers, operator, remote, fleet = {}, {}, {}, {}
    if served:
        try:
            if "tokenizers" in phases:
                tokenizers = timed("tokenizers", phase_tokenizers, results, kernel_modules, dirs)
            if "operator" in phases:
                operator = timed("operator", phase_operator, results, kernel_modules, dirs)
            if "remote" in phases:
                remote = timed("remote", phase_remote, results, kernel_modules, dirs)
            if "fleet" in phases:
                fleet = timed("fleet", phase_fleet, results, kernel_modules, dirs)
        finally:
            shutil.rmtree(dirs["workdir"], ignore_errors=True)
    deployed = timed("deployed", phase_deployed, results, kernel_modules) \
        if "deployed" in phases else {}
    deploy = timed("deploy", phase_deploy, results, kernel_modules) \
        if "deploy" in phases else {}
    fabric = timed("fabric", phase_fabric, results, kernel_modules) if "fabric" in phases else {}
    prefix = timed("prefix", phase_prefix, results, kernel_modules) \
        if "prefix" in phases else {}
    contiguous = timed("contiguous", phase_contiguous, results, kernel_modules, args.seed) \
        if "contiguous" in phases else {}
    mesh = timed("mesh", phase_mesh, results, kernel_modules) if "mesh" in phases else {}
    if "parity" in phases:
        timed("parity", phase_parity, results, kernel_modules)
    families = timed("families", phase_families, results, kernel_modules, args.seed) \
        if "families" in phases else {}
    phase_s["total"] = time.perf_counter() - started
    print(json.dumps({"phase_s": phase_s, "left_behind": left_behind, "card": card}),
          flush=True)
    # each kernel's count from the drive of the path it serves: K1 the
    # continuous serve phase, the decode kernel the wave drive under its
    # own selector value, the prefill kernel the default (v1) wave drive,
    # K5 the analysis phase's drives (two analyses and the recall queries)
    v1, v2 = wave_launches.get("v1", {}), wave_launches.get("v2", {})
    path_launches = {
        "ragged_paged_attention": launches.get("ragged_paged_attention"),
        "paged_decode_attention_v1": v1.get("paged_decode_attention"),
        "paged_decode_attention_v2": v2.get("paged_decode_attention"),
        "flash_prefill_attention": v1.get("flash_prefill_attention"),
        "best_window_similarity": analysis.get("best_window_similarity"),
    }
    for record in records:
        record["launches"] = path_launches[record["name"]]
        # the same kernel's launches on the checkpoint and operator phases' paths
        base = re.sub(r"_v[12]$", "", record["name"])
        record["launches_checkpoint"] = checkpoint.get(base)
        record["launches_tokenizers"] = tokenizers.get(base)
        record["launches_operator"] = operator.get(base)
        record["launches_remote"] = remote.get(base)
        record["launches_fleet"] = fleet.get(base)
        record["launches_deployed"] = deployed.get(base)
        record["launches_deploy"] = deploy.get(base)
        record["launches_fabric"] = fabric.get(base)
        record["launches_guided"] = guided.get(base)
        record["launches_prefix"] = prefix.get(base)
        record["launches_contiguous"] = contiguous.get(base)
        record["launches_mesh"] = mesh.get(base)
        record["launches_train"] = train.get(base)
        record["launches_families"] = families.get(base)
    kernels = records
    results["kernels"] = kernels
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    results["device"] = device
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
