#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run (non-zero exit) on any fault:

1. device — require CUDA; print the card's name and power limit
   (``nvidia-smi``) and the torch version;
2. build  — compile the eight hand-written kernels (five sources in
   ``csrc/*.cu``, one ``nvcc`` per source, all at once) and print the
   build seconds;
3. kernels against their plain-torch versions, bit for bit, at the main
   path's shapes: the 1 024 000 symbols per byte plane of a batch-4
   ``gemma2-2b`` decode step (real logits of the warm-up prefill), plus
   an odd-chunk case (chunk 1001, an e4m3 plane); each kernel is timed
   with CUDA events beside its plain version (and, for B1, the one-call
   gather ``lut[sym]`` as a yardstick the port never calls), and by the
   profiler's device events (``device_ms``: the device's own time a
   call, where the events loop also holds the host's), and B1's host
   time a call is read with ``time.perf_counter`` over calls that do not
   wait for the device (``host_us``); B1 and its yardstick, both
   host-bound, are read in turns and keep their least reading.  A chain
   probe (one thread, dependent shared-memory table lookups) measures
   the least time of one decode step, which bounds B3, B4 and B6-B8.
   The chunk walkers (B3, B4, B6; with B1 and B2 to code their input)
   also run on ``w_gate[0]``'s hi plane (33.5 M symbols, 16 384 chunks),
   B4 and B6 on a KV-shaped call (chunk 512, as many chunks as the coded
   serve's last read, 6840 a plane, held in phase 5 to the read that
   serve made) and B6 on the odd-chunk plane, each
   with its launch shape (chunks a CTA, warps, CTAs, CTAs an SM, waves),
   ns a step and chain bound.
   The same for B5-B8 ("kernels vs plain (B5-B8)"): B5 (histogram) on
   the logits planes, ``w_gate[0]``'s planes (33.5 M symbols), a plane
   of one value (2^25 symbols), views from bytes 1, 7 and 15 and lengths
   0, 1, 17 and 2^20 + 3, checked to be one device operation a call,
   timed on ``w_gate[0]`` in turns with the match probe (B5's other
   design: warp-aggregated shared atomics, a source kept here as a
   string) and as the store finds the plane (warm, right after the
   split) and after 128 MB of other traffic (cold), and on an empty
   plane (the cost of a call before it counts a symbol);
   B6 (QLC decode) at chunk 2048 on the logits planes with QLC books from
   the same logits, B7/B8 (fused decode + matmul, Huffman / QLC) on three
   layer-0 matrices at full width (``w_down[0]`` at chunk 4096,
   ``w_gate[0]`` at chunk 16384, ``wo[0]`` as 2048 x 2048 at chunk 4096)
   with x = (4, K) bf16, the decode batch: decoded tiles bit for bit, the
   product within ``MATMUL_TOL`` of the plain version, and
   ``torch.matmul`` of the raw weight timed as the yardstick (each
   kernel and yardstick also by its device events);
4. serve ``gemma2-2b`` at full width: bf16 weights from a seeded
   generator, a warm-up prefill of 4 prompts x 64 tokens whose logits'
   byte-plane histograms build the books, then ``Engine.generate`` on 4
   new prompts x 64 tokens for 32 new tokens with a bitexact chunked spec,
   once with the ``multisym`` decode backend (kernel B4) and once with
   ``scan`` (kernel B3).  Every step must decode losslessly, code 2 x 500
   chunks, carry B2 chunk bits equal to histogram (B5) . lengths, and the
   kernels' launch counters must show the path ran through them; the
   decode step without the wire is timed on the device (profiler) at
   batch 4 over 96 cache slots, and the eager 4 x 64 prefill's host ms
   (until the call returns) beside its events and device ms;
5. coded-at-rest serve (``repro_torch.launch.dryrun.memstore_check`` at
   full width), under Huffman and QLC: the whole tree coded into a
   ``CompressedParamStore`` on the card, materialized bit for bit, the
   prompt's prefill cache through a ``CodedKVStore`` bit for bit, a decode
   step on it with bit-identical logits, and ``Engine(param_store=...,
   kv_mode="coded")`` generating the raw engine's 32 x 4 tokens; with its
   own launch counts (B1, B2, B4-B8 must all run);
6. compressed collectives (``repro_torch.comm``) on a loopback ring of
   4 ranks stacked on one card, at ``gemma2-2b`` width: a data-parallel
   gradient all-reduce of one layer's ``w_gate`` shape (2048 x 16 384 bf16
   a rank, N(0, 1e-3^2), books from an earlier draw) by
   ``ring_all_reduce`` (carry ``wire`` and ``f32``, backends ``multisym``
   and ``scan``), ``ring_reduce_scatter``, the 2 x 2
   ``hierarchical_all_reduce`` and an integer-valued payload; the wire
   serve's step logits vocab-sharded over the ranks, gathered by
   ``ring_all_gather`` and the chunked and monolithic transports; a
   prefill hidden state (4 x 64 x 2048 a rank) through
   ``ring_all_to_all``; and ``launch.dryrun.ring_check`` at 8 ranks under
   both codecs.  Launch counts are reset before and read after these
   (``launches_by_path["ring"]``): B1, B2 and the hop decoder (B4, B3
   under ``scan``, B6 for QLC books) once a plane a hop, B5 for the
   payload probe.  Checked: the coded rings equal an uncoded loopback
   ring (the same hop schedule and adds) bit for bit, the integer payload
   ``torch.sum``, the gathers and the permute their inputs; every hop's
   ``hop_coded_bits`` equals B5's histogram . lengths of what it ships;
   ``raw_wire_bits`` the analytic 2(n-1)/n (all_reduce) or (n-1)/n
   (reduce_scatter) of the payload.  Each op is timed (CUDA events;
   profiler device time) with its coded/raw per hop, and a hop's parts
   (decode, add, recode, the loopback move) on their own; that hop's
   B1 -> B2 words and bits, for whole segments and for segments one
   symbol short, equal the plain versions' on CPU copies.  Every op also
   runs on CPU copies (the plain versions) at the logits size (1 024 000
   bf16 a rank; the all-to-all on the hidden state), with one e4m3
   all_reduce whose sums pass 448: the words of each hop, the stats and
   the results must be equal bit for bit, and the e4m3 sums hold NaNs.
   B3, B4 and B6 also walk a monolithic
   stream (one chunk of 1 024 000 symbols).  On one card a loopback hop
   moves no bytes over a link: the times are the codec's cost a hop;
7. train ``gemma2-2b`` at full width (depth not cut) through
   ``repro_torch.launch.train.train`` (on the card each epoch's first
   step captures a ``train.CapturedTrainStep``, the next replays it):
   the seed-0 params, batch 4 x 128
   of ``SyntheticDataset`` tokens, AdamW lr 1e-3 with the cosine
   schedule, 8 steps with ``--compress`` semantics (books bootstrapped
   from the params, ``DriftThresholds(min_symbols=1024)``, a refresh
   check every 2 steps); launch counts reset before and read after these
   steps (``launches_by_path["train"]``: B5 on every gradient leaf and
   plane).  Checked: finite losses, ``grad_raw_bits`` = 16 x params, the
   bootstrap books go stale and an epoch flips, ``n_recompiles`` = the
   epochs built, B5 launched, the allocator's allocated bytes after each
   epoch flip (printed with the reserved) at most 1 % of the card's
   memory past the first flip's (``memory_after_flips``: the superseded
   step's graph, buffers and pool are released); then on one repeated
   batch (lr 1e-4) every
   leaf's B5 histograms equal the plain histogram of its bf16 planes, the
   probe's coded bits equal hist . lengths in int64, the refreshed books
   code the gradients at a lower coded/raw than the bootstrap books, and
   the loss falls over 4 steps (the 2nd and 3rd under the profiler:
   device ms a step, idle share, B5's ms; the 4th's host syncs counted);
   the step's parts (forward + backward, the probe, AdamW) are profiled
   on their own; the reduced config takes one step on the card and one
   on the CPU from the same params and batch, every reading of
   ``train.step.step_deviation`` within ``STEP_TOL``.  Printed: host-clock median step time and
   tokens/s, device ms and idle share, B5's share, coded/raw before and
   after the refresh, the refreshes' host seconds, peak memory;
8. lifecycle: ``launch.dryrun.drift_check`` at 8 ranks on the card
   (every field true), then the wire serve's setup (4 x 64 prompts, 16
   new tokens, ``multisym``) with ``Engine(lifecycle=,
   refresh_every=4)`` under thresholds 0 (every window stale): at least
   one refresh, every step lossless with B2 bits = B5 . the lengths of
   the epoch in force, the tokens of the same engine without
   ``lifecycle=`` (``launches_by_path["lifecycle"]``: B1, B2, B4, B5);
   allocated memory after each of its epoch flips held as phase 7's;
9. MoE: ``llama4-scout-17b-a16e`` at full width with its depth cut to 4
   of 48 layers (10.88 B parameters from seed 0; the gemma2-2b weights
   are freed first).  Launch counts are reset before and read after the
   path (``launches_by_path["moe"]``): ``Engine(ep_degree=4)`` serving 4
   x 64 prompts for 16 tokens through the bitexact wire (books from a
   warm-up prefill's logits), one ``moe_apply_a2a_block`` of layer 0's
   MoE on 8 x 512 hidden states over a loopback ``"model"`` mesh of 4
   (2 sequences a rank, capacity 48, a 1 966 080-element shard a round),
   and ``forward_train`` + backward of the model with ``moe_impl="a2a"``
   on that mesh at batch 4 x 128.  Checked: every serve step lossless
   with B2 bits = B5 . lengths, the tokens of the engine without books,
   ``moe_wire_raw_bits`` = the analytic formula; a replay of the
   engine's steps against one prefill of the whole sequence, each MoE
   layer's inputs and each decode call's counts recorded: the decode's
   counts (routed totals) equal ``moe_prefill``'s on the decode's own
   inputs, every decode step keeps and drops exactly the slots that
   ``_dispatch`` of the forward keeps and drops on those inputs, the
   full-sequence counts differ from the decode's by exactly the tokens
   whose top-1 expert flipped between the two hidden states (printed,
   with the dropped slots), and the decode's logits agree with the
   forward's within ``DECODE_TOL`` on the tokens before a sequence's
   first flip, at least half of them; the a2a result equals
   ``moe_apply`` bit for bit, every decoded receive buffer is the
   uncoded permutation, every round's ``hop_coded_bits`` is a plain
   histogram (``torch.bincount``) . lengths of what it ships, one B4
   launch a plane a round, the block's coded bits the summed ledgers,
   under the bootstrap books and under books built (B5) from the first
   dispatch's payload (``configure_a2a_wire``); the recorded dispatch
   and combine payloads through ``ring_all_to_all`` at the wire's chunk
   (512) under both book sets, on the card and on CPU copies (the
   kernels' plain versions): every hop's words and bit counts, the
   stats and the result bit for bit; through the wire, with the aux loss off
   (on, the a2a path's aux is the mean of per-rank losses, another
   function), the loss within ``STEP_TOL`` of the scatter path's (its
   bit-identity printed) and every gradient within its gradient limit,
   ``moe_wire_coded_bits`` = the summed hop ledgers (the block remat runs
   each wire twice).  Timed: the call, the scatter
   path, the experts' products, each wire with its kernels' device ms;
   the forward + backward's device ms and peak memory; then the
   ``reduced()`` llama4 step on the card and the CPU within
   ``STEP_TOL``;
10. DeepSeek: ``deepseek-v3-671b`` at full width with its depth cut to
   1 ``mla`` + 1 ``mla_moe`` of 61 layers (13.94 B parameters from seed
   0, after llama4 is freed).  Launch counts are reset before and read
   after the path (``launches_by_path["deepseek"]``):
   ``Engine(ep_degree=4)`` serving 4 x 64 prompts for 16 tokens through
   the bitexact wire (books from a warm-up prefill's logits), one
   ``moe_apply_a2a_block`` of the ``mla_moe`` layer on 8 x 512 hidden
   states over a loopback ``"model"`` mesh of 4 (capacity 20, an
   18 350 080-element shard a round), and ``moe_apply_eshard`` of that
   layer on the same states over loopback meshes ``{"data": 2, "model":
   4}`` and ``{"data": 2, "model": 1}``.  Checked: every serve step
   lossless with B2 bits = B5 . lengths, the tokens of the engine without
   books, ``moe_wire_raw_bits`` = the analytic formula; a replay of the
   engine's steps against one prefill of the whole sequence: both MLA
   mixers' outputs and the MoE layer's input (before any router) within
   ``DECODE_TOL`` on every decoded token, the MoE decode's counts equal
   to ``moe_prefill``'s on the decode's own inputs, each decode step's
   kept and dropped slots those of ``_dispatch``, the routing flips
   counted and accounted for (the logits before a sequence's first flip
   printed); the a2a result equal to ``moe_apply`` bit for bit, every
   decoded receive buffer the uncoded permutation, every round's
   ``hop_coded_bits`` a plain histogram . lengths, one B4 launch a plane
   a round, under the bootstrap books and books from the first
   dispatch's payload; B1, B2, B4 and B5 held to their plain versions on
   CPU copies for the dispatch's first round (a whole call's copies
   would take minutes); the eshard call's kept and dropped slots equal
   at model 4 and model 1 and its output within ``ESHARD_TOL``.  Timed:
   the decode step (host median, device ms), the MLA layer's decode and
   prefill, the a2a call with its wires' kernels, ``moe_apply``, the
   experts' products, the eshard call; then the ``reduced()`` DeepSeek
   step on the card and the CPU within ``STEP_TOL`` in float32 (bf16
   printed), and, report only, the bf16 forward's routing flips between
   the card and the CPU, the bf16 step with the flipped tokens masked
   out of the loss, and the first op past a bf16 ulp;
11. RG-LRU: ``recurrentgemma-9b`` at full width and full depth (38
   layers: 12 x (``rec``, ``rec``, ``local``) + 2 ``rec``; 9.63 B
   parameters from seed 0, after DeepSeek is freed).  Launch counts are
   reset before and read after the path (``launches_by_path
   ["recurrentgemma"]``): ``Engine`` serving 4 x 64 prompts for 32
   tokens through the bitexact wire (``multisym``, books from a warm-up
   prefill's logits), the engine without books, and the engine with
   ``kv_mode="coded"`` (Huffman, KV chunk 512: the 12 local layers' K/V
   coded, the 26 ``rec`` layers' ``{h, conv}`` passed through raw).
   Checked: every wire step lossless with B2 bits = B5 . lengths, B1,
   B2 and B4 on one step's logits planes equal to their plain versions
   on CPU copies (after the count), the tokens of the engine without
   books; the coded engine's tokens and
   every step's logits equal to the raw engine's bit for bit, the raw
   state counted alike on both sides of the KV ledger (its coded/raw
   printed); a replay of the engine's steps against one prefill of the
   whole sequence: every decoded token's logits and every ``rec``
   layer's ``h`` after the last step within ``DECODE_TOL``; one ``rec``
   layer's scan on its real gates at 4 x 4096 against a sequential
   float32 loop over the same (a, b) on the card within ``SCAN_TOL``.
   Timed: the decode step (host median, device ms), a ``rec`` layer's
   decode and 4 x 64 prefill, the 4 x 4096 scan, peak memory; then the
   ``reduced()`` step on the card and the CPU in bf16, held to
   ``STEP_TOL`` (where bf16 misses, printed, and the float32 step held),
   beside the first op of the reduced forward whose outputs on the card
   part from the CPU's by more than a bf16 ulp (every op's output taped
   in call order on both devices);
12. Mamba-2: ``mamba2-780m`` at full width and full depth (48 ``mamba``
   layers, d 1536, 48 heads of 64, state 128, tied embeddings; 0.78 B
   parameters), the same path, checks and times as phase 11
   (``launches_by_path["mamba2"]``; the logits plane, 4 x 50 280
   symbols, ends in a 416-symbol chunk; the coded KV engine codes
   nothing and passes every state through), each layer's ``state``
   after the replay against the full prefill's final state (the prompt
   is padded to the 128-step chunk inside) -- the replay held on a
   float32 copy of the weights, the bf16 replay's readings printed
   (``REPLAY_DTYPE``: the random 48-layer stack carries a bf16 rounding
   ~100x, in the reference as in the port) -- and one layer's
   ``ssd_chunked`` on its real (x, dt, B, C) at 4 x 2048 (16 chunks)
   against the sequential recurrence in float32 on the card within
   ``SSD_TOL`` (y and the final state);
13. VLM: ``internvl2-26b`` at full width and full depth (48 ``attn``
   layers, d 6144, 48 heads GQA kv 8, d_ff 16 384, vocab 92 553, untied
   head; 19.861 B parameters, 39.72 GB), on a card the earlier phases
   left empty, its init peak printed (``models.model_init`` writes each
   layer into its stack: the three 9.66 GB FFN stacks are never held
   twice) (``launches_by_path["internvl"]``): ``Engine`` serving 4 x 64
   prompts after seeded 4 x 1024 x 6144 float32 patch embeddings
   (``generate(prefix_embeds=)``) for 32 tokens through the bitexact wire
   (``multisym``, books from a warm-up prefill's logits; the logits
   plane, 4 x 92 553 symbols, is 181 chunks, the last 1572), the engine
   without books, and ``kv_mode="coded"`` (KV chunk 512, 1120-slot
   caches, the first ingest the prefix's and the prompt's 1088 slots).
   Checked as phase 11: every step lossless with B2 bits = B5 . lengths,
   B1, B2 and B4 on one step's planes (the partial last chunk included)
   equal to their plain versions, the tokens of the engine without books, the coded KV engine's tokens
   and every step's logits equal to the raw engine's bit for bit, and a
   replay of the steps against one prefill of the prefix and the whole
   sequence within ``DECODE_TOL``.  Timed: the prefill of 4 x (1024 +
   64) (host until the eager call returns, events, device), a decode
   step (host median, device ms; its
   bound the 38.6 GB of weights a step reads, the head included and the
   table's 4 rows not), peak memory; then the ``reduced()`` step (a
   16-patch prefix) on the card and the CPU in bf16, held to
   ``STEP_TOL``;
14. audio: ``hubert-xlarge`` at full width and full depth (48
   bidirectional ``attn`` layers over frame embeddings, d 1280, vocab
   504; 1.2597 B parameters): one forward of seeded 4 x 1024 frames, its
   logits planes (2 064 384 symbols, 1008 chunks each) through
   ``encode_chunked`` and ``decode_chunked`` (``multisym``, books from a
   warm-up forward; ``launches_by_path["hubert"]``): lossless, B2 bits =
   B5 . lengths, B1, B2 and B4 on each plane and the path's own streams
   and decodes equal to the plain versions on CPU copies; then phase 7's path and checks at batch 4 x 1024,
   ``grad_accum`` 2 (its config's), a refresh check every 4 steps
   (``launches_by_path["hubert_train"]``), the reduced step held in
   bf16;
15. statistics: ``gemma2-2b``'s 18-layer ``w_gate`` stack (18 x 2048 x
   16 384 bf16, seed 0, drawn as phase 4 draws it) at the paper's
   geometry, 18 x 64 = 1152 shards (``launches_by_path["stats"]``):
   ``core.stats.shard_histograms`` (B5 a shard and plane) equal, on both
   planes, to a plain count of the same split made another way;
   ``per_shard_report``'s means printed (ideal, per-shard Huffman, fixed
   codebook; random weights, report only); ``three_stage_encode`` (B5
   scan, host build, B1 -> B2 -> merge) and ``single_stage_encode`` with
   its book on ``w_gate[0]``'s hi plane (33.5 M symbols): equal words and
   bits, bits = B5 . lengths, the stage seconds; and the seven symbol
   schemes' planes of 2^20 seeded values (NaN, inf, 470 among them) equal
   on the card and the CPU;
16. examples and the roofline: the three examples' ``main`` on the
   card (``repro_torch.examples``; ``launches_by_path["examples"]``):
   ``quickstart`` at its sizes (every plane lossless, coded bits = B5 .
   lengths), ``serve_compressed`` at its sizes (the 8-rank gather bit
   for bit, its coded bits = B5 . lengths, the ring's ranks agreeing)
   and ``train_sft_compressed`` at its default width (~100 M
   parameters) with ``--steps 100 --rebuild-every 25`` (the loss falls,
   the first rebuild codes the gradients smaller); then
   ``launch.dryrun.one_card_bound`` (the reference's analytic terms on a
   one-card mesh) of the steps timed above, each at its exact shape --
   phase 4's gemma2-2b decode step at batch 4 over 96 cache slots,
   phase 7's train step at 4 x 128, phase 13's internvl2-26b decode step
   over 1120 slots, phase 14's hubert-xlarge train step at 4 x 1024 in
   two microbatches -- printed beside its device ms with the share
   (bound / measured), which must not pass ``SHARE_LIMIT`` (1.05: past
   it, the count is wrong);
17. ``mamba2-780m`` trained at full width and full depth (0.78 B
   parameters, seed-0 bf16 weights, block remat) at one ``dp_only``
   device's share of ``train_4k``: 1 x 4096 tokens, ``grad_accum`` 1,
   AdamW, through ``launch.train.train`` with ``--compress`` semantics
   for 3 steps (``launches_by_path["mamba2_train"]``: B5 on every
   gradient leaf and plane).  Checked as phase 7: finite losses,
   ``grad_raw_bits`` = 16 x 779 989 248, B5 launched; one step's
   gradients, every leaf and plane, B5 against the plain histogram and
   the probe's coded bits against hist . lengths; ``launch.hillclimb
   --pair mamba2`` in-process on the meta device, its perf log printed;
   the loss falls over 4 steps on one repeated batch, the last three
   under the profiler (device events only: device ms a step, idle
   share), one at each SSD chunk the hillclimb tries (``ssm_chunk`` 128,
   64, 256; the same function, rounded at other points), each printed
   beside that iteration's plan terms.  The config's own chunk's device
   ms against ``one_card_bound`` at 1 x 4096 (the dp_only plan's
   per-device terms, checked equal) within ``SHARE_LIMIT``; the host
   median of the 3 steps; peak memory;
18. the captured decode step: every ``Engine`` above runs its decode
   steps as replays of a ``serve.CapturedStep`` (the step captured once
   as a CUDA graph for each batch size and book epoch, the position in a
   device buffer).  Checked in place, right after the serve path's
   launch counts are read, on the wire engine of phase 4 (``multisym``
   and ``scan``) and of phases 9-13 (``captured_check``): over
   ``CAPTURE_STEPS`` (8) steps from one prefill, each replay against
   ``make_serve_step`` run eagerly on copies of the same inputs -- the
   logits, every cache leaf (positions, MoE counts and recurrent states
   included) and every metric equal bit for bit, and ``LAUNCHES`` grown
   on every replay by the launches its capture counted, B1, B2, B5 and
   B4 (B3 under ``scan``) among them; a ``generate`` of
   ``SYNC_FREE_NEW`` tokens whose replay loop runs in torch's sync debug
   mode "error" but for each step's one metrics copy.  Printed (and
   listed again under this phase's header): the host median of a step,
   eager and captured, over the same steps (each with its metrics
   copy), the device ms of one replay by CUDA events, and the idle
   share 1 - device / captured host median, without the profiler;
19. the captured train step: ``gemma2-2b`` at 4 x 128, ``hubert-xlarge``
   at 4 x 1024 (``grad_accum`` 2) and ``mamba2-780m`` at 1 x 4096, each
   at full width and depth from seed 0 (``captured_train_phase``): 12
   steps as ``launch.train.train`` takes them, with the books'
   thresholds at 0 and one refresh, after step 1, so the run crosses one
   epoch flip; first with the plain step, keeping each step's metrics
   and an int64 checksum of every state leaf, then, the first run
   freed, with ``CapturedTrainStep`` (a capture at steps 0 and 2, ten
   replays): every metric (loss, grad norm, lr, the probe's bits and
   histograms, ...) and every leaf's checksum equal bit for bit (where
   they do not, a second plain run tells whether the plain step is
   itself not reproducible: if it is reproducible, the run fails; if
   not, losses and grad norms are held within ``STEP_TOL`` and the
   differing leaves printed); ``LAUNCHES`` grown on every replay by the
   capture's counts, B5 among them; every replay called in torch's sync
   debug mode "error" (the metrics copy outside it).  Printed: the host
   median of a step (the step and its metrics copy) over the last 8
   steps of the second epoch, plain and captured, the device ms of one
   replay (CUDA events), the idle share 1 - device / captured host
   median, the warm-up and capture seconds and the peak memory
   (``launches_by_path["captured_train"]``: the captured runs);
20. the captured prefill: every ``Engine`` above runs its prefill as a
   replay of a ``serve.CapturedPrefill`` (captured once as a CUDA graph
   for each request shape, an engine's graphs in one memory pool).
   Checked in place, after phase 18's check, on the ``multisym`` wire
   engine of phase 4 and the wire engines of phases 9-13
   (``captured_prefill_check``): at the phase's request shape (4 x 64;
   4 x (1024 + 64) for internvl2-26b), at a shorter prompt
   (``PREFILL_SHORT``, 32 tokens) and at the phase's shape again, each
   call on new inputs against ``prefill`` run eagerly on copies of them
   -- the logits and every cache leaf (KV slots, positions, MoE counts,
   MLA latents, recurrent states) equal bit for bit; exactly two graphs,
   in one pool; allocated and reserved bytes across the shorter shape's
   capture grown by at most its outputs plus 1 % of the card, a replay
   growing none; one call in torch's sync debug mode "error"; a fresh
   engine given both shapes and dropped leaving at most 1 % of the card.
   Printed (and listed again under this phase's header): the host median
   of 11 calls at the phase's shape, eager and captured in turns, each
   ending in one sync, a replay's device ms by CUDA events at both
   shapes, the idle share 1 - device / captured host median, each
   graph's warm-up and capture seconds, the second capture's growth, the
   fresh engine's pool and the peak allocated memory;
21. B4 over the reference's window domain (``window_domain_phase``):
   on phase 3's logits hi plane (1 024 000 symbols, chunk 2048) every K
   from 1 to 16 with s_max 1, 3, 8, 13, 16 and 24, and on ``w_gate[0]``'s
   hi plane (16 384 chunks) K 8, 14 and 16 with s_max 8 and 16, each
   LUT the plane's book builds (``multisym_tables(k=, s_max=)``): the
   kernel equal to its plain version bit for bit and round-tripping the
   plane, one launch a call.  Printed for each: device ms (the profiler:
   the kernel's and the wrapper's re-striding copy's) and CUDA-events ms,
   windows a chunk and the longest chunk's (``multisym_windows``), the
   chain bound, the slow-window share, the row bytes, where the rows
   live and the launch shape;
22. the last lines: one ``{"ring": ...}``, one ``{"lifecycle": ...}``,
   one ``{"train": ...}``, one ``{"moe": ...}``, one ``{"deepseek":
   ...}``, one ``{"recurrent": ...}``, one ``{"prefix": ...}``, one
   ``{"stats": ...}``, one ``{"examples": ...}``, one
   ``{"mamba2_train": ...}``, one ``{"captured": ...}``, one
   ``{"captured_train": ...}``, one ``{"captured_prefill": ...}`` and
   one ``{"window_domain": ...}`` record, one ``{"kernels": [...]}``
   record (B1-B8, with ``launches_by_path`` for every path), then
   ``{"ok": true, "device": {...}}``.

``--profile`` adds a phase before the records: eight serve steps (no
wire, ``multisym``, ``scan``) under ``torch.profiler``, printing device
busy time per step, the idle share, the top kernels and the port's own
kernels (B1-B5 on this path) per step.

It needs a checkout of this repository around it (it imports
``src/repro_torch``) and a CUDA device; without either it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

SEED = 0
BATCH, PROMPT, NEW = 4, 64, 32
CHUNK, ODD_CHUNK = 2048, 1001
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
INT32_LANES_PER_SM = 64          # Hopper SM: 4 partitions x 16 INT32 lanes
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
# B7/B8 against their plain versions: 0.  Both add the same exact
# float32 products (bf16 x bf16) in one fixed order with separate
# multiplies and adds, so any difference is a fault, not rounding.
MATMUL_TOL = 0.0

# The chain probe: one thread walks ``steps`` dependent lookups of the
# form a decoder's step takes at the least (shift, mask, shared-memory
# load), through a table that holds one random cycle over its entries.
CHAIN_PROBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void chain_kernel(const uint32_t* __restrict__ table, int size,
                             long long steps, uint32_t* sink) {
  extern __shared__ uint32_t s[];
  for (int i = threadIdx.x; i < size; i += blockDim.x) s[i] = table[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const uint32_t mask = static_cast<uint32_t>(size - 1);
  uint32_t v = s[0];
  for (long long i = 0; i < steps; ++i) v = s[(v >> 3) & mask];
  *sink = v;
}

extern "C" int chain_launch(const void* table, int size, long long steps,
                            void* sink, void* stream) {
  chain_kernel<<<1, 256, size * sizeof(uint32_t),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), size, steps,
      static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
"""

# B5's two other designs, timed beside it on the same planes (the caller
# zeroes ``out``; whole 512-byte tiles, 16-byte aligned, only).
#
# The match probe: warp-aggregated atomics.
# Each warp keeps its own 256 bins in shared memory; the lanes that hold
# the same symbol find each other (__match_any_sync) and one of them adds
# their number with one shared atomic.  Per-block bins go to the output
# with 64-bit atomics.  Every lane of a warp stays in the loop.
MATCH_PROBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
match_kernel(const uint4* __restrict__ vec, long long n_vec,
             unsigned long long* __restrict__ out) {
  __shared__ uint32_t s[8 * 256];
  for (int i = threadIdx.x; i < 8 * 256; i += 256) s[i] = 0u;
  __syncthreads();
  uint32_t* bins = s + (threadIdx.x >> 5) * 256;
  const int lane = threadIdx.x & 31;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n_vec;
       i += gridDim.x * 256ll) {
    const uint4 v = __ldg(vec + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      const unsigned peers = __match_any_sync(0xffffffffu, b);
      if (lane == __ffs(peers) - 1) atomicAdd(&bins[b], __popc(peers));
    }
  }
  __syncthreads();
  uint32_t sum = 0;
  for (int w = 0; w < 8; ++w) sum += s[w * 256 + threadIdx.x];
  if (sum) atomicAdd(&out[threadIdx.x], static_cast<unsigned long long>(sum));
}

extern "C" int match_launch(const void* sym, long long n_vec, void* out,
                            int grid, void* stream) {
  match_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(sym), n_vec,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


# The private probe: per-thread counters, no two lanes on one address.
# Each thread owns a column of 256 8-bit counters in shared memory (64 KB
# a block): bin b of thread t is byte b & 3 of the word at byte offset
# (b >> 2) * 1024 + 4t, one shared atomic add a symbol into the thread's
# own word; every 15 loads (240 symbols) a flush sums the columns into
# 32-bit bins, four threads a word in 16-bit lanes, and zeroes them.
PRIVATE_PROBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void add(uint8_t* c, uint32_t off, uint32_t inc) {
  atomicAdd(reinterpret_cast<uint32_t*>(c + off), inc);
}

__device__ __forceinline__ void count4(uint8_t* c, uint32_t col,
                                       uint32_t col_hi, uint32_t v) {
  const uint32_t vb = (v & 0xFCFCFCFCu) | col_hi;
  const uint32_t vs = (v & 0x03030303u) << 3;
  add(c, __byte_perm(col, vb, 0x2240), __funnelshift_l(0u, 1u, vs));
  add(c, __byte_perm(col, vb, 0x2250), __funnelshift_l(0u, 1u, vs >> 8));
  add(c, __byte_perm(col, vb, 0x2260), __funnelshift_l(0u, 1u, vs >> 16));
  add(c, __byte_perm(col, vb, 0x2270), __funnelshift_l(0u, 1u, vs >> 24));
}

__device__ uint32_t flush(uint8_t* c, bool zero) {
  const int t = threadIdx.x, lane = t & 31;
  uint4* row = reinterpret_cast<uint4*>(c + (t >> 2) * 1024 + (t & 3) * 256);
  uint32_t lo = 0, hi = 0;
  for (int k = 0; k < 16; ++k) {
    const int j = (k + lane) & 15;
    const uint4 x = row[j];
    if (zero) row[j] = make_uint4(0u, 0u, 0u, 0u);
    lo += (x.x & 0x00FF00FFu) + (x.y & 0x00FF00FFu) + (x.z & 0x00FF00FFu) +
          (x.w & 0x00FF00FFu);
    hi += __byte_perm(x.x, 0, 0x4341) + __byte_perm(x.y, 0, 0x4341) +
          __byte_perm(x.z, 0, 0x4341) + __byte_perm(x.w, 0, 0x4341);
  }
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
  const uint32_t v = (t & 1) ? hi : lo;
  return (t & 2) ? v >> 16 : v & 0xFFFFu;
}

__global__ void __launch_bounds__(256, 3)
private_kernel(const uint4* __restrict__ vec, long long n_vec,
               unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t c[];
  const int t = threadIdx.x;
  const uint32_t col = 4u * t, col_hi = (t >> 6) * 0x01010101u;
  for (int w = 0; w < 64; ++w)
    *reinterpret_cast<uint32_t*>(c + w * 1024 + col) = 0u;
  const long long stride = gridDim.x * 256ll;
  const long long rounds = (n_vec + stride - 1) / stride;
  uint32_t total = 0;
  for (long long r = 0; r < rounds; ++r) {
    const long long i = blockIdx.x * 256ll + t + r * stride;
    if (i < n_vec) {
      const uint4 v = __ldg(vec + i);
      count4(c, col, col_hi, v.x);
      count4(c, col, col_hi, v.y);
      count4(c, col, col_hi, v.z);
      count4(c, col, col_hi, v.w);
    }
    if ((r + 1) % 15 == 0 && r + 1 < rounds) {
      __syncthreads();
      total += flush(c, true);
      __syncthreads();
    }
  }
  __syncthreads();
  total += flush(c, false);
  if (total) atomicAdd(&out[t], static_cast<unsigned long long>(total));
}

extern "C" int private_launch(const void* sym, long long n_vec, void* out,
                              int grid, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      private_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  if (e != cudaSuccess) return static_cast<int>(e);
  private_kernel<<<grid, 256, 65536, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(sym), n_vec,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

class SmokeError(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_kernel_us(prof) -> dict:
    """name -> (summed device us, count) of every kernel, memset and copy
    in a finished torch.profiler run, read from its raw events
    (``key_averages()`` builds a Python tree of every event first: tens
    of seconds for a step of tens of thousands of eager ops)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us, n = out.get(e.name(), (0.0, 0))
            out[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return out


def device_events(torch, fn, reps: int) -> dict:
    """name -> (device us, count) of every kernel, memset and copy that
    ``reps`` calls of ``fn`` (after one warm-up) ran, summed over the
    calls, from torch.profiler's device events (device activity alone:
    no host events are recorded).  A window in which the profiler
    recorded no device event at all (seen once over 20 calls of B5,
    whose output was checked) is read again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = device_kernel_us(prof)
        if out:
            break
    return out


def device_ms(torch, fn, reps: int):
    """(device ms a call, device events a call) of ``fn``: the summed
    time of every device operation it runs.  Unlike ``cuda_ms``, no host
    time is in it."""
    ev = device_events(torch, fn, reps).values()
    return (sum(us for us, _ in ev) / 1e3 / reps,
            sum(n for _, n in ev) / reps)


def device_ops(torch, fn, reps: int = 20) -> dict:
    """name -> device operations a call of ``fn`` runs, over ``reps``
    calls."""
    return {k: n / reps
            for k, (_, n) in device_events(torch, fn, reps).items()}


def kernel_ms(torch, prep, fn, key: str, reps: int = 20) -> float:
    """Device ms a call of the kernels named like ``key`` that ``fn(x)``
    runs, x = ``prep()`` made anew on the same stream before each call
    (so ``prep`` sets what the call finds in the cache)."""
    ev = device_events(torch, lambda: fn(prep()), reps)
    return sum(us for k, (us, _) in ev.items() if key in k) / 1e3 / reps


def host_us(torch, fn, reps: int = 200, rounds: int = 3) -> float:
    """Host time of one call of ``fn`` in microseconds: the least of
    ``rounds`` perf_counter readings over ``reps`` calls with no sync
    (the device runs behind), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return best * 1e6


def eager_reading(torch, fn, rounds: int = 3) -> dict:
    """An eager call's host ms (the time until ``fn`` returns, no sync:
    the least of ``rounds`` calls, each after a sync), its wall ms (CUDA
    events around 2 calls) and device ms and device operations a call
    (the profiler's device events), after one warm-up call.  Host ms
    near the device's means the call is held by the device (or by a full
    launch queue), not by Python."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    dev, ops = device_ms(torch, fn, 2)
    return {"host_ms": min(host), "host_ms_all": host,
            "wall_ms": cuda_ms(torch, fn, 2), "device_ms": dev,
            "device_ops": ops}


def interleaved(fns, measure, rounds: int = 5):
    """The least of ``rounds`` readings of ``measure(fn)`` for each of
    ``fns``, taken in turns (A, B, A, B, ...), so that a slow spell of
    the host falls on all of them alike."""
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], measure(fn))
    return best


def compare(torch, got, want):
    """(mismatching elements, max |difference|) over tensor tuples, with
    int32 words compared as their unsigned values."""
    bad, err = 0, 0
    for g, w in zip(got, want):
        g64 = g.to(torch.int64)
        w64 = w.to(torch.int64)
        if g.dtype == torch.int32:
            g64, w64 = g64 & 0xFFFFFFFF, w64 & 0xFFFFFFFF
        d = (g64 - w64).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    return bad, err


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py needs the repository around it "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2

    from repro_torch.comm.compression import CompressionSpec, histogram256
    from repro_torch.configs import get_config
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import (chunk_capacity_words,
                                          chunk_counts_for, concat_chunks)
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.kernels import bitpack, build, decode, encode
    from repro_torch.launch.dryrun import memstore_check
    from repro_torch.models import (decode_step, forward, model_init,
                                    param_count, prefill)
    from repro_torch.serve import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- 1. device
    phase("device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    print(card)                             # as nvidia-smi gives it
    print(f"{sms} SMs, max SM clock {max_sm_mhz} MHz: INT32 peak "
          f"{int_ops_per_s:.4e} op/s")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} x{torch.cuda.device_count()}")

    # ----------------------------------------------------------- 2. build
    phase("build")
    t0 = time.perf_counter()
    import ctypes
    jobs = [start_probe(build, "chain_probe", CHAIN_PROBE_CU),
            start_probe(build, "match_probe", MATCH_PROBE_CU),
            start_probe(build, "private_probe", PRIVATE_PROBE_CU)]
    try:
        libs = build.build_all()
    except BaseException:
        for _, proc, _ in jobs:
            proc.kill()
            proc.wait()
        raise
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    probe = finish_probe(jobs[0], "chain_launch",
                         [P, ctypes.c_int, LL, P, P])
    b5_probes = {name: finish_probe(job, f"{name}_launch",
                                    [P, LL, P, ctypes.c_int, P])
                 for name, job in (("match", jobs[1]), ("private", jobs[2]))}
    print(f"built {sorted(libs)} and the chain, match and private probes in "
          f"{time.perf_counter() - t0:.3f} s")
    for src, log in sorted(build.build_logs().items()):
        for line in log.splitlines():       # -Xptxas -v, kernel by kernel
            fn = re.search(r"entry function '\w*?\d+(\w+_kernel)"
                           r"(I(?:Li\d+E)+E)?", line)
            if fn:          # a template's arguments, as <13, 8>
                args = re.findall(r"Li(\d+)E", fn.group(2) or "")
                tmpl = f"<{', '.join(args)}>" if args else ""
                print(f"  ptxas {src} {fn.group(1)}{tmpl}:")
            elif "registers" in line or "spill" in line:
                print(f"    {line.replace('ptxas info    :', '').strip()}")

    # ------------------------------- 4a. model + warm-up prefill (books)
    phase("gemma2-2b init + warm-up prefill")
    cfg = get_config("gemma2-2b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
        torch.cuda.synchronize()
        print(f"params: {param_count(params) / 1e9:.4f} B "
              f"in {time.perf_counter() - t0:.1f} s")
        warm = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                             generator=gen, device=dev)
        logits, _ = prefill(params, {"tokens": warm}, cfg, PROMPT + NEW)
    planes = SCHEMES["bf16"].to_symbols(logits)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in planes.items()}
    for p, b in books.items():
        print(f"book {p}: lengths {int(b.lengths.min())}.."
              f"{int(b.lengths.max())}")
    step_logits = logits[:, -1].to(torch.bfloat16)      # one decode step's
    need(bool(torch.isfinite(step_logits.float()).all()), "warm-up logits "
         "are not finite")

    # -------------------------------------- 3. kernels vs plain versions
    phase("kernels vs plain")
    stats = {k: {"mismatches": 0, "max_abs_err": 0} for k in
             ("encode_lookup", "pack_blocks", "decode_chunks_canonical",
              "decode_chunks_multisym")}

    def record(kname, got, want):
        bad, err = compare(torch, got, want)
        stats[kname]["mismatches"] += bad
        stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], err)

    def check_case(tag, sym_planes, case_books, chunk, time_it):
        enc, timing = {}, {}
        for p, sym in sym_planes.items():
            b = case_books[p]
            (lut,) = b.device_tables("lut", dev)
            k1 = encode.encode_lookup(sym, lut)
            record("encode_lookup", k1, encode.encode_lookup_plain(sym, lut))
            k2 = bitpack.pack_blocks(k1[0], k1[1], chunk=chunk)
            record("pack_blocks", k2, bitpack.pack_blocks_plain(
                k1[0], k1[1], chunk=chunk))
            n = sym.numel()
            counts = torch.from_numpy(chunk_counts_for(n, chunk)).to(dev)
            canon = b.device_tables("canonical", dev)
            ms = b.device_tables("multisym", dev)
            (pre,) = b.device_tables("prefix", dev)
            k3 = decode.decode_chunks_canonical(k2[0], counts, *canon,
                                                chunk=chunk, prefix=pre)
            record("decode_chunks_canonical", (k3,),
                   (decode.decode_chunks_canonical_plain(
                       k2[0], counts, *canon, chunk=chunk),))
            k4 = decode.decode_chunks_multisym(k2[0], counts, *ms, *canon,
                                               chunk=chunk)
            record("decode_chunks_multisym", (k4,),
                   (decode.decode_chunks_multisym_plain(
                       k2[0], counts, *ms, *canon, chunk=chunk),))
            cc = chunk_counts_for(n, chunk)
            need(torch.equal(concat_chunks(k4, cc), sym) and
                 torch.equal(concat_chunks(k3, cc), sym),
                 f"{tag}/{p}: kernels do not round-trip the plane")
            enc[p] = (sym, lut, k1, k2, counts, canon, ms, pre)
        print(f"{tag}: chunk {chunk}, {len(sym_planes)} plane(s) x "
              f"{next(iter(sym_planes.values())).numel()} symbols, "
              f"mismatches so far "
              f"{sum(s['mismatches'] for s in stats.values())}")
        if not time_it:
            return enc, timing
        np_ = len(enc)
        each = list(enc.values())

        def over(fn):
            return lambda: [fn(*e) for e in each]

        b1 = over(lambda s, lut, *_: encode.encode_lookup(s, lut))
        b1_lib = over(lambda s, lut, *_: lut[s.long()])
        b2 = over(lambda s, lut, k1, *_: bitpack.pack_blocks(
            k1[0], k1[1], chunk=chunk))
        b3 = over(lambda s, l, k1, k2, c, canon, ms, pre:
                  decode.decode_chunks_canonical(k2[0], c, *canon,
                                                 chunk=chunk, prefix=pre))
        b4 = over(lambda s, l, k1, k2, c, canon, ms, pre:
                  decode.decode_chunks_multisym(k2[0], c, *ms, *canon,
                                                chunk=chunk))
        # B1 and its yardstick are host-bound: both are read in turns
        ms1, lib1 = interleaved((b1, b1_lib),
                                lambda f: cuda_ms(torch, f, 50) / np_)
        host1, lib_host1 = interleaved((b1, b1_lib),
                                       lambda f: host_us(torch, f, rounds=1)
                                       / np_)
        timing["encode_lookup"] = dict(
            ms=ms1,
            plain_ms=cuda_ms(torch, over(
                lambda s, lut, *_: encode.encode_lookup_plain(s, lut)),
                20) / np_,
            library_ms=lib1, host_us=host1, library_host_us=lib_host1)
        timing["pack_blocks"] = dict(
            ms=cuda_ms(torch, b2, 50) / np_,
            plain_ms=cuda_ms(torch, over(
                lambda s, lut, k1, *_: bitpack.pack_blocks_plain(
                    k1[0], k1[1], chunk=chunk)), 10) / np_,
            library_ms=None)
        timing["decode_chunks_canonical"] = dict(
            ms=cuda_ms(torch, b3, 10) / np_,
            plain_ms=cuda_ms(torch, over(
                lambda s, l, k1, k2, c, canon, *_:
                decode.decode_chunks_canonical_plain(
                    k2[0], c, *canon, chunk=chunk)), 1) / np_,
            library_ms=None)
        timing["decode_chunks_multisym"] = dict(
            ms=cuda_ms(torch, b4, 10) / np_,
            plain_ms=cuda_ms(torch, over(
                lambda s, l, k1, k2, c, canon, ms, pre:
                decode.decode_chunks_multisym_plain(
                    k2[0], c, *ms, *canon, chunk=chunk)), 1) / np_,
            library_ms=None)
        for k, fn, lib, reps in (("encode_lookup", b1, b1_lib, 50),
                                 ("pack_blocks", b2, None, 50),
                                 ("decode_chunks_canonical", b3, None, 10),
                                 ("decode_chunks_multisym", b4, None, 10)):
            d_ms, events = device_ms(torch, fn, reps)
            timing[k].update(device_ms=d_ms / np_,
                             device_events_per_call=events / np_,
                             library_device_ms=(device_ms(torch, lib, reps)[0]
                                                / np_ if lib else None))
        return enc, timing

    main_enc, timing = check_case("main path (bf16 logits)",
                                  SCHEMES["bf16"].to_symbols(step_logits),
                                  books, CHUNK, time_it=True)
    odd = SCHEMES["e4m3"].to_symbols(step_logits.float())
    odd_books = {p: build_codebook(histogram256(s).cpu().numpy())
                 for p, s in odd.items()}
    check_case("odd chunk (e4m3 plane)", odd, odd_books, ODD_CHUNK,
               time_it=False)
    step_ns = chain_step_ns(torch, probe, dev)
    print(f"chain probe: {step_ns:.3f} ns per dependent lookup step [{card}]")
    walks = check_walkers(torch, dev, params, cfg, odd, int_ops_per_s,
                          step_ns, sms)
    # phase 21's weight plane, kept on the host until then
    gate_hi = bf16_planes(params["groups"][0][0]["ffn"]["w_gate"][0])[
        "hi"].cpu()
    for k, cases in walks.items():
        st = stats.setdefault(k, {"mismatches": 0, "max_abs_err": 0})
        for r in cases.values():
            st["mismatches"] += r["mismatches"]
            st["max_abs_err"] = max(st["max_abs_err"], r["max_abs_err"])
    for k, s in stats.items():
        need(s["mismatches"] == 0, f"kernel {k} disagrees with its plain "
             f"version: {s}")
    bounds = kernel_bounds(torch, main_enc, CHUNK, chunk_capacity_words,
                           int_ops_per_s, step_ns)
    nb_logits = main_enc["lo"][3][0].shape[0]
    logits_fields = {
        k: dict(ns_per_step=timing[k]["ms"] * 1e6
                / bounds[k][2]["chain_steps_per_chunk"],
                **launch_shape(k, nb_logits, sms, main_enc["lo"][6]))
        for k in ("decode_chunks_canonical", "decode_chunks_multisym")}
    for k, f in logits_fields.items():
        print_walk(k, "logits plane", dict(
            timing[k], **f, chain_bound_ms=bounds[k][2]["chain_bound_ms"]),
            card)
    for k, cases in walks.items():
        for tag, r in cases.items():
            print_walk(k, tag, r, card)
    t = timing["encode_lookup"]
    print(f"  encode_lookup: {t['ms']:.5f} ms a call (device "
          f"{t['device_ms']:.5f}, {t['device_events_per_call']:g} device "
          f"events a call, host {t['host_us']:.2f} us), lut[s.long()] "
          f"{t['library_ms']:.5f} ms (device {t['library_device_ms']:.5f}, "
          f"host {t['library_host_us']:.2f} us) [{card}]")

    phase("kernels vs plain (B5-B8)")
    t0 = time.perf_counter()
    new_kernels = check_b5_to_b8(torch, dev, params, step_logits,
                                 int_ops_per_s, step_ns, sms, b5_probes)
    for k, r in new_kernels.items():
        print(f"{k}: mismatches {r['mismatches']}, max abs err "
              f"{r['max_abs_err']}, {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}, plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}) [{card}]")
        need(r["mismatches"] == 0, f"kernel {k} disagrees with its plain "
             f"version: {r['mismatches']} mismatching elements")
    r = new_kernels["histogram256"]
    print(f"  histogram256: {r['cases']} cases bit for bit; one call "
          f"{r['device_ops_per_call']} on the device; w_gate[0] hi "
          f"{r['w_gate0_hi_ms']:.4f} ms (device "
          f"{r['w_gate0_hi_device_ms']:.4f}; warm "
          f"{r['w_gate0_hi_warm_ms']:.4f}, cold "
          f"{r['w_gate0_hi_cold_ms']:.4f}), lo {r['w_gate0_lo_ms']:.4f}"
          f" ms (device {r['w_gate0_lo_device_ms']:.4f}), bound "
          f"{r['w_gate0_bound_ms']:.5f}; match probe hi "
          f"{r['w_gate0_hi_match_probe_ms']:.4f}, lo "
          f"{r['w_gate0_lo_match_probe_ms']:.4f} ms; private probe hi "
          f"{r['w_gate0_hi_private_probe_ms']:.4f}, lo "
          f"{r['w_gate0_lo_private_probe_ms']:.4f} ms; one value "
          f"{r['one_value_device_ms']:.4f}, empty plane "
          f"{r['empty_plane_device_ms']:.4f} ms (device); wave "
          f"{r.get('wave_ctas')} CTAs, CTAs on logits "
          f"{r.get('grid_logits')}, w_gate[0] {r.get('grid_w_gate0')} "
          f"[{card}]")
    b5_ops = r["device_ops_per_call"]
    need(sum(b5_ops.values()) == 1
         and not any("emset" in k for k in b5_ops),
         f"B5: one call ran {b5_ops} on the device, not one kernel")
    print_walk("decode_chunks_qlc", "logits plane",
               new_kernels["decode_chunks_qlc"], card)
    for k in ("decode_matmul", "decode_matmul_qlc"):
        for tag, r in new_kernels[k]["by_matrix"].items():
            print(f"  {k} {tag}: {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f}), {r['chain_steps']} chain "
                  f"steps, {r['ns_per_step']:.2f} ns a step, {r['ctas']} "
                  f"CTAs, {r['ctas_per_sm']} a SM, {r['waves']} wave(s), "
                  f"chain bound {r['chain_bound_ms']:.4f} ms, x @ w "
                  f"{r['library_ms']:.4f} ms [{card}]")
        for tag, r in new_kernels[k]["extra_cases"].items():
            print(f"  {k} {tag}: tiles exact, product max abs err vs "
                  f"plain {r['max_abs_err']}, rel err vs dense "
                  f"{r['rel_err_vs_dense']:.3e}, longest codes "
                  f"{r['max_code_len']}")
    print(f"B5-B8 phase: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------- 4b. serve at full width
    phase("serve gemma2-2b (bitexact wire)")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    runs, specs, wire_engines = {}, {}, {}
    expect_kernel = {"multisym": "decode_chunks_multisym",
                     "scan": "decode_chunks_canonical"}
    n_sym = BATCH * cfg.vocab_size
    chunks_per_step = 2 * len(chunk_counts_for(n_sym, CHUNK))
    build.reset_launches()                  # the main path's count starts
    for backend in ("multisym", "scan"):
        spec = CompressionSpec.from_books(books, "bf16", tensor_kind="act",
                                          mode="bitexact",
                                          transport="chunked", chunk=CHUNK,
                                          decode_backend=backend)
        specs[backend] = spec
        eng = wire_engines[backend] = Engine(
            params, cfg, ServeConfig(max_cache_len=PROMPT + NEW), spec,
            device=dev)
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        toks, totals = eng.generate(prompts, NEW)
        wall = time.perf_counter() - t0
        grew = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
        steps = eng.step_metrics
        need(toks.shape == (BATCH, NEW), f"tokens shape {toks.shape}")
        need(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token ids")
        need(len(steps) == NEW - 1, f"{len(steps)} decode steps")
        need(totals["act_decode_mismatch"] == 0.0,
             f"{backend}: {totals['act_decode_mismatch']} mismatches")
        need(totals["act_decode_chunks"] == chunks_per_step * (NEW - 1),
             f"{backend}: {totals['act_decode_chunks']} chunks")
        for i, m in enumerate(steps):
            need(m["act_decoded_bits"] == m["act_coded_bits"] > 0,
                 f"{backend} step {i}: B2 bits {m['act_decoded_bits']} != "
                 f"histogram . lengths {m['act_coded_bits']}")
        for k in ("encode_lookup", "pack_blocks", "histogram256",
                  expect_kernel[backend]):
            need(grew[k] > 0, f"{backend}: kernel {k} was not launched")
        step_s = sorted(m["step_seconds"] for m in steps)
        med = step_s[len(step_s) // 2]
        tail = len(step_s) - 11             # ten samples beyond it
        runs[backend] = {"decode_steps": len(step_s),
                         "decode_step_ms_median": med * 1e3,
                         "decode_step_ms_min": step_s[0] * 1e3,
                         "decode_step_ms_tail": step_s[tail] * 1e3,
                         "tail_percentile": 100.0 * (tail + 1) / len(step_s),
                         "tokens_per_s": BATCH / med,
                         "generate_s": wall, "launches": grew,
                         "coded_bits_per_step": totals["act_coded_bits"]
                         / (NEW - 1),
                         "raw_bits_per_step": totals["act_raw_bits"]
                         / (NEW - 1)}
        print(f"{backend}: decode step {med * 1e3:.3f} ms (median of "
              f"{len(steps)}), {BATCH / med:.1f} tokens/s, coded/raw "
              f"{totals['act_coded_bits'] / totals['act_raw_bits']:.4f}, "
              f"launches {grew} [{card}]")
    launches = dict(build.LAUNCHES)         # read right after the main path

    # Phase 18 on both wire engines (their graphs hold the weights: the
    # engines go before the next model is built)
    for backend, eng in wire_engines.items():
        captured_check(torch, eng, prompts, f"gemma2-2b {backend}", card,
                       build, ("encode_lookup", "pack_blocks",
                               "histogram256", expect_kernel[backend]))
    # phase 20 on the multisym engine
    captured_prefill_check(torch, wire_engines["multisym"], prompts,
                           "gemma2-2b", card)
    del wire_engines

    # The serve step itself must not wait for the device: Engine.generate
    # takes the step's one host sync when it reads the metrics.
    for backend, spec in specs.items():
        step_without_sync(torch, params, cfg, prompts, spec)
    print("serve step: no host sync inside (torch sync debug mode 'error')")

    # The same engine without a spec: the model's own step time.
    eng = Engine(params, cfg, ServeConfig(max_cache_len=PROMPT + NEW),
                 device=dev)
    eng.generate(prompts, 8)
    bare = sorted(m["step_seconds"] for m in eng.step_metrics)
    runs["no_wire"] = {"decode_step_ms_median": bare[len(bare) // 2] * 1e3}
    # the step's device time at batch 4 over PROMPT + NEW cache slots,
    # the shape phase 16's roofline bound is reckoned at
    with torch.no_grad():
        _, dcaches = prefill(params, {"tokens": prompts}, cfg, PROMPT + NEW)
        nxt = prompts[:, -1:]
        (runs["no_wire"]["decode_step_device_ms"],
         runs["no_wire"]["decode_step_device_ops"]) = device_ms(
            torch, lambda: decode_step(params, nxt, dcaches, PROMPT, cfg)[0],
            3)
    del dcaches
    print(f"no wire: decode step "
          f"{runs['no_wire']['decode_step_ms_median']:.3f} ms, "
          f"{runs['no_wire']['decode_step_device_ms']:.3f} ms device "
          f"[{card}]")
    # the eager prefill of a request (4 x 64): host beside device
    with torch.no_grad():
        pre = runs["prefill"] = eager_reading(torch, lambda: prefill(
            params, {"tokens": prompts}, cfg, PROMPT + NEW)[0])
    print(f"prefill {BATCH} x {PROMPT} (eager): host {pre['host_ms']:.3f} ms "
          f"(until the call returns), wall {pre['wall_ms']:.3f} ms "
          f"(events), device {pre['device_ms']:.3f} ms in "
          f"{pre['device_ops']:.0f} device ops [{card}]")

    # Output check on a small input: one decode step after a prefill
    # agrees with the full-sequence forward at full width (bf16).
    with torch.no_grad():
        seq = prompts[:1, :9]
        full = forward(params, {"tokens": seq}, cfg)[:, -1].float()
        _, caches = prefill(params, {"tokens": seq[:, :8]}, cfg, 16)
        one, _ = decode_step(params, seq[:, 8:9], caches, 8, cfg)
        one = one[:, 0].float()
    rel = float((one - full).abs().max() / full.abs().max())
    need(bool(torch.isfinite(one).all()) and rel < 5e-2,
         f"decode step vs forward: rel err {rel}")
    print(f"decode step vs full forward (bf16, full width): max rel err {rel}")

    # ---------------------------------- 5. coded-at-rest serve (B1-B8)
    phase("coded-at-rest serve (huffman, qlc)")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()                  # this path's count starts
    coded = memstore_check(cfg, params, device=dev, batch=BATCH,
                           prompt_len=PROMPT, new_tokens=NEW)
    coded_launches = dict(build.LAUNCHES)   # read right after the path
    coded["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"card": card, "coded_at_rest": coded}))
    need(coded["status"] == "ok", "coded-at-rest serve: a check failed "
         "(see the record above)")
    kv_case = {walks[k][f"kv call {p} plane"]["chunks"]
               for k in ("decode_chunks_multisym", "decode_chunks_qlc")
               for p in ("lo", "hi")}
    for codec in ("huffman", "qlc"):
        r = coded[codec]
        need(r["coded_steps"] == NEW - 1, f"{codec}: {r['coded_steps']} "
             f"coded decode steps")
        need(kv_case == {r["kv_last_read_chunks"]}, f"{codec}: the "
             f"KV-shaped calls of phase 3 ({kv_case} chunks) are not the "
             f"coded serve's last read ({r['kv_last_read_chunks']} chunks "
             f"a plane)")
        print(f"{codec}: param ratio {r['param_hbm_ratio']:.4f}, kv ratio "
              f"{r['kv_hbm_ratio']:.4f}, coded step "
              f"{r['coded_step_ms_median']:.3f} ms (median), one step "
              f"{r['one_coded_step']} [{card}]")
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym", "decode_chunks_qlc", "decode_matmul",
              "decode_matmul_qlc"):
        need(coded_launches[k] > 0, f"coded-at-rest serve: kernel {k} was "
             f"not launched")
    print(f"coded-at-rest launches {coded_launches}, peak memory "
          f"{coded['peak_memory_gb']:.2f} GB [{card}]")

    # ------------------------------ 6. compressed collectives (ring)
    phase("compressed collectives (loopback ring of 4 ranks)")
    ring, ring_launches = ring_phase(torch, dev, params, cfg, books,
                                     step_logits, warm, card, build)
    torch.cuda.empty_cache()

    # ------------------------------------ 7. train gemma2-2b (full width)
    phase("train gemma2-2b at full width (gradient probe, lifecycle)")
    del logits, planes
    trained, train_launches = train_phase(torch, dev, params, cfg, card,
                                          build)
    print_train(trained, card)
    torch.cuda.empty_cache()

    # --------------------------------- 8. lifecycle: drift check, refresh
    phase("lifecycle (drift check, serve with book hot-refresh)")
    life, life_launches = lifecycle_phase(torch, dev, params, cfg, books,
                                          prompts, card, build)

    if "--profile" in sys.argv[1:]:
        phase("profile (torch.profiler, device timeline)")
        prof = {k: profile_steps(torch, params, cfg, prompts, spec)
                for k, spec in (("no_wire", None), *specs.items())}
        print(json.dumps({"card": card, "profile": prof}))

    # ---------------- 9. MoE: llama4-scout-17b-a16e at full width (4 of 48)
    phase("MoE: llama4-scout-17b-a16e at full width (4 of 48 layers)")
    # the card holds llama4 alone: the gemma2-2b engine holds its weights
    del params, eng, caches, full, one
    torch.cuda.empty_cache()
    moe_rec, moe_launches = moe_phase(torch, dev, card, build)
    torch.cuda.empty_cache()

    # ------- 10. DeepSeek: deepseek-v3-671b at full width (1 mla + 1 mla_moe)
    phase("DeepSeek: deepseek-v3-671b at full width (1 mla + 1 mla_moe)")
    ds_rec, ds_launches = deepseek_phase(torch, dev, card, build)
    torch.cuda.empty_cache()

    # ------------- 11-12. the recurrent kinds at full width and full depth
    recurrent, rec_launches = {}, {}
    for n, arch in enumerate(RECURRENT, start=11):
        phase(f"{n}. {arch} at full width and depth")
        recurrent[arch], rec_launches[RECURRENT[arch][0]] = recurrent_phase(
            torch, dev, card, build, arch)
        torch.cuda.empty_cache()

    # -------- 13. internvl2-26b served after a 1024-patch prefix (full)
    phase("13. internvl2-26b at full width and depth (a 1024-patch prefix)")
    vlm_rec, vlm_launches = internvl_phase(torch, dev, card, build)
    torch.cuda.empty_cache()

    # ------------- 14. hubert-xlarge coded and trained (full width, depth)
    phase("14. hubert-xlarge at full width and depth (frame embeddings)")
    audio_rec, audio_launches, audio_train_launches = hubert_phase(
        torch, dev, card, build)
    torch.cuda.empty_cache()

    # ------------- 15. the paper's per-shard statistics and its encoders
    phase("15. per-shard statistics (18 x 64 shards) and the two encoders")
    stats_rec, stats_launches = stats_phase(torch, dev, card, build)

    # ------------------------ 16. the examples, and the timed steps' bounds
    phase("16. examples and the roofline")
    measured = {
        "gemma2-2b decode (phase 4)": (
            "gemma2-2b", "decode", PROMPT + NEW, BATCH, 1,
            runs["no_wire"]["decode_step_device_ms"]),
        "gemma2-2b train (phase 7)": (
            "gemma2-2b", "train", TRAIN_SEQ, TRAIN_BATCH,
            trained["grad_accum"],
            trained["profile"]["device_busy_ms_per_step"]),
        "internvl2-26b decode (phase 13)": (
            "internvl2-26b", "decode", PREFIX + PROMPT + NEW, BATCH, 1,
            vlm_rec["serve"]["decode_step_device_ms"]),
        "hubert-xlarge train (phase 14)": (
            "hubert-xlarge", "train", HUBERT_SEQ, HUBERT_BATCH,
            audio_rec["train"]["grad_accum"],
            audio_rec["train"]["profile"]["device_busy_ms_per_step"]),
    }
    ex_rec, ex_launches = examples_phase(torch, dev, card, build, measured)
    torch.cuda.empty_cache()

    # ------------ 17. mamba2-780m trained at full width and depth, 1 x 4096
    phase("17. mamba2-780m trained at full width and depth (1 x 4096)")
    mamba_rec, mamba_launches = mamba_train_phase(torch, dev, card, build)

    # ------------------ 18. the captured decode step (checked in place)
    phase("18. captured decode step")
    want = {"gemma2-2b multisym", "gemma2-2b scan", "llama4-scout-17b-a16e",
            "deepseek-v3-671b", *RECURRENT, "internvl2-26b"}
    need(set(CAPTURED) == want, f"captured step checked on "
         f"{sorted(CAPTURED)}, not on {sorted(want)}")
    for path, r in CAPTURED.items():
        print(f"{path}: host median a step {r['host_ms_median_eager']:.3f} ms "
              f"eager, {r['host_ms_median_captured']:.3f} ms captured "
              f"({r['host_ms_median_eager'] / r['host_ms_median_captured']:.2f}"
              f"x); device {r['device_ms_a_replay']:.3f} ms a replay; idle "
              f"share {r['idle_share']:.3f}; replay = eager bit for bit over "
              f"{r['steps_compared']} steps [{card}]")

    # ------------ 19. the captured train step against the eager step
    phase("19. captured train step (gemma2-2b, hubert-xlarge, mamba2-780m)")
    ct_rec, ct_launches = captured_train_phase(torch, dev, card, build)

    # ------------------ 20. the captured prefill (checked in place)
    phase("20. captured prefill")
    want = {"gemma2-2b", "llama4-scout-17b-a16e", "deepseek-v3-671b",
            *RECURRENT, "internvl2-26b"}
    need(set(CAPTURED_PREFILL) == want, f"captured prefill checked on "
         f"{sorted(CAPTURED_PREFILL)}, not on {sorted(want)}")
    for path, r in CAPTURED_PREFILL.items():
        print(f"{path} {r['shapes']['long']}: host median "
              f"{r['host_ms_median_eager']:.3f} ms eager, "
              f"{r['host_ms_median_captured']:.3f} ms captured "
              f"({r['host_ms_median_eager'] / r['host_ms_median_captured']:.2f}"
              f"x); device {r['device_ms_a_replay']['long']:.3f} ms a replay; "
              f"idle share {r['idle_share']:.3f}; replays = eager bit for bit "
              f"at {r['shapes']['long']} and {r['shapes']['short']} [{card}]")

    # ------------------------------------- 21. B4 over the window domain
    phase("21. B4 over the window domain (K 1-16, s_max 1-24)")
    gate_hi = gate_hi.to(dev)
    gate_book = build_codebook(histogram256(gate_hi).cpu().numpy())
    window = window_domain_phase(torch, dev, {
        "logits hi plane": (main_enc["hi"][0], books["hi"], WINDOW_KS,
                            WINDOW_SMAX),
        "w_gate[0] hi plane": (gate_hi, gate_book, *WINDOW_GATE)},
        step_ns, sms, card)
    del gate_hi
    st = stats["decode_chunks_multisym"]
    for r in (r for cases in window.values() for r in cases.values()):
        st["mismatches"] += r["mismatches"]
        st["max_abs_err"] = max(st["max_abs_err"], r["max_abs_err"])

    # ------------------------------------------------------ 22. records
    source = "src/repro_torch/kernels/csrc/"
    meta = {
        "encode_lookup": ("B1", "encode.cu", "src/repro/kernels/encode.py:65"),
        "pack_blocks": ("B2", "bitpack.cu", "src/repro/kernels/bitpack.py:60"),
        "decode_chunks_canonical": ("B3", "decode.cu",
                                    "src/repro/kernels/decode.py:101"),
        "decode_chunks_multisym": ("B4", "decode.cu",
                                   "src/repro/kernels/decode.py:218"),
    }
    paths = {"wire_serve": launches, "coded_at_rest": coded_launches,
             "ring": ring_launches, "train": train_launches,
             "lifecycle": life_launches, "moe": moe_launches,
             "deepseek": ds_launches, **rec_launches,
             "internvl": vlm_launches, "hubert": audio_launches,
             "hubert_train": audio_train_launches, "stats": stats_launches,
             "examples": ex_launches, "mamba2_train": mamba_launches,
             "captured_train": ct_launches}
    kernels = []
    for k, (tag, src, replaces) in meta.items():
        t = dict(timing[k])
        bound_s, bound_by, extra = bounds[k]
        if k in logits_fields:          # the walkers' shapes and cases
            extra = dict(extra, **logits_fields[k], walks=walks[k])
        kernels.append({
            "name": f"{tag} {k}", "route": "cuda", "source": source + src,
            "replaces": replaces,
            "launches": sum(c[k] for c in paths.values()),
            "launches_by_path": {name: c[k] for name, c in paths.items()},
            "mismatches": stats[k]["mismatches"],
            "max_abs_err": stats[k]["max_abs_err"],
            "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": t.pop("library_ms"), **t, **extra})
    new_meta = {
        "histogram256": ("B5", "histogram.cu",
                         "src/repro/kernels/histogram.py:47"),
        "decode_chunks_qlc": ("B6", "decode.cu",
                              "src/repro/kernels/decode.py:333"),
        "decode_matmul": ("B7", "decode_matmul.cu",
                          "src/repro/kernels/decode_matmul.py:203"),
        "decode_matmul_qlc": ("B8", "decode_matmul.cu",
                              "src/repro/kernels/decode_matmul.py:264"),
    }
    for k, (tag, src, replaces) in new_meta.items():
        r = dict(new_kernels[k])
        if k in walks:
            r.update(mismatches=r["mismatches"] + stats[k]["mismatches"],
                     max_abs_err=max(r["max_abs_err"],
                                     stats[k]["max_abs_err"]),
                     walks=walks[k])
        kernels.append({
            "name": f"{tag} {k}", "route": "cuda", "source": source + src,
            "replaces": replaces,
            "launches": sum(c[k] for c in paths.values()),
            "launches_by_path": {name: c[k] for name, c in paths.items()},
            **r})
    print(json.dumps({"card": card, "serve": runs}))
    print(json.dumps({"ring": ring}))
    print(json.dumps({"card": card, "lifecycle": life}))
    print(json.dumps({"card": card, "train": trained}))
    print(json.dumps({"card": card, "moe": moe_rec}))
    print(json.dumps({"card": card, "deepseek": ds_rec}))
    print(json.dumps({"card": card, "recurrent": recurrent}))
    print(json.dumps({"card": card, "prefix": {"internvl2-26b": vlm_rec,
                                               "hubert-xlarge": audio_rec}}))
    print(json.dumps({"card": card, "stats": stats_rec}))
    print(json.dumps({"card": card, "examples": ex_rec}))
    print(json.dumps({"card": card, "mamba2_train": mamba_rec}))
    print(json.dumps({"card": card, "captured": CAPTURED}))
    print(json.dumps({"card": card, "captured_train": ct_rec}))
    print(json.dumps({"card": card, "captured_prefill": CAPTURED_PREFILL}))
    print(json.dumps({"card": card, "window_domain": window}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def print_walk(kname: str, tag: str, r: dict, card: str) -> None:
    """One line of a decode kernel's case: time, step, launch shape."""
    print(f"  {kname} {tag}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}),"
          f" {r['ns_per_step']:.2f} ns a step, {r['chunks_per_cta']} chunks "
          f"a CTA ({r['walker_warps_per_cta']} warps), {r['ctas']} CTAs, "
          f"{r['ctas_per_sm']} a SM, {r['waves']} wave(s), chain bound "
          f"{r['chain_bound_ms']:.4f} ms [{card}]")


def timed_once(torch, fn):
    """(result, device ms) of one call of ``fn``, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def least_ms(nbytes, int_ops, int_ops_per_s, flops=0.0):
    """(bound ms, by): the larger of bytes over the HBM rate and the
    operations over the card's peak rates (INT32 lanes, bf16 tensor
    cores for products of bf16 inputs)."""
    tb = nbytes / HBM_BYTES_PER_S
    to = int_ops / int_ops_per_s + flops / BF16_FLOP_PER_S
    return (tb * 1e3, "bytes") if tb >= to else (to * 1e3, "operations")


def used_words(bits):
    """Words a decoder must read: each chunk's payload plus its pad."""
    return int(((bits.long() + 31) // 32 + 1).sum())


SHAPE_ENTRIES = {"decode_chunks_canonical": "decode_canonical_shape",
                 "decode_chunks_multisym": "decode_multisym_shape",
                 "decode_chunks_qlc": "decode_qlc_shape"}


def launch_shape(kname: str, nb: int, sms: int, lut=None) -> dict:
    """The launch of decode kernel ``kname`` (B3, B4 or B6) for ``nb``
    chunks, as its C entry chooses it: chunks (walker lanes) a CTA,
    walker warps a CTA, CTAs, dynamic shared memory a CTA, CTAs an SM
    holds at once, and waves; for B4, with the LUT ``lut`` (syms, meta),
    its window K, row bytes and where its rows live."""
    import ctypes
    from repro_torch.kernels.build import I, P, bind
    from repro_torch.kernels.decode import multisym_row_bytes
    shape = (ctypes.c_int * 6)()
    extra = {}
    if kname == "decode_chunks_multisym":
        size, s_max = lut[0].shape
        k, row = size.bit_length() - 1, multisym_row_bytes(size, s_max)
        err = bind("decode", SHAPE_ENTRIES[kname], [I, I, I, P])(
            nb, k, row, ctypes.addressof(shape))
        extra = {"lut_k": k, "lut_s_max": s_max, "row_bytes": row,
                 "rows_in": "shared" if shape[5] else "device"}
    else:
        err = bind("decode", SHAPE_ENTRIES[kname], [I, P])(
            nb, ctypes.addressof(shape))
    need(err == 0, f"{kname} launch-shape query failed ({err})")
    per_cta, warps, ctas, smem, per_sm = list(shape)[:5]
    need(per_sm > 0, f"{kname}: no CTA fits an SM")
    return {"chunks_per_cta": per_cta, "walker_warps_per_cta": warps,
            "ctas": ctas, "smem_bytes_per_cta": smem, "ctas_per_sm": per_sm,
            "waves": -(-ctas // (per_sm * sms)), **extra}


def walk_case(torch, dev, kname, sym, book, chunk, int_ops_per_s, step_ns,
              sms) -> dict:
    """Decode kernel ``kname`` (B3, B4 or B6) on one symbol plane: coded
    by B1 + B2 with ``book``, decoded by the kernel and by its plain
    version, held bit for bit and to the plane, and timed (CUDA events,
    the profiler), with its launch shape, its chain (the longest chunk's
    steps: symbols for B3/B6, windows for B4) and its bounds on this
    data."""
    from repro_torch.core.encoder import PREFIX_BITS, chunk_counts_for
    from repro_torch.core.encoder import concat_chunks
    from repro_torch.core.qlc import qlc_kernel_args
    from repro_torch.kernels import decode, ops
    words, bits = ops.encode_with_book(sym, book, chunk=chunk)
    cc = chunk_counts_for(sym.numel(), chunk)
    counts = torch.from_numpy(cc).to(dev)
    n, nb = sym.numel(), words.shape[0]
    nbits = int(bits.to(torch.int64).sum())
    stream_bytes = used_words(bits) * 4 + nb * 4 + nb * chunk * 4
    canonical_bytes = (3 * 17 + 256) * 4
    steps = int(counts.max())
    extra, lut = {}, None
    if kname == "decode_chunks_qlc":
        args = qlc_kernel_args(book, dev)

        def run():
            return decode.decode_chunks_qlc(words, counts, *args, chunk=chunk)

        def plain():
            return decode.decode_chunks_qlc_plain(words, counts, *args,
                                                  chunk=chunk)
        bound, by = least_ms(stream_bytes + 256 * 4, 16 * n, int_ops_per_s)
        extra["qlc_class_lengths"] = book.class_lengths
    else:
        canon = book.device_tables("canonical", dev)
        lens = torch.from_numpy(book.lengths.astype("int64")).to(dev)[
            sym.long()]
        cut = PREFIX_BITS
        if kname == "decode_chunks_multisym":
            lut = book.device_tables("multisym", dev)

            def run():
                return decode.decode_chunks_multisym(words, counts, *lut,
                                                     *canon, chunk=chunk)

            def plain():
                return decode.decode_chunks_multisym_plain(
                    words, counts, *lut, *canon, chunk=chunk)
            size, s_max = lut[0].shape
            k = size.bit_length() - 1
            win = multisym_windows(torch, lens, chunk, k, s_max)
            steps, windows = int(win.max()), int(win.sum())
            bound, by = least_ms(stream_bytes + canonical_bytes
                                 + size * (min(s_max, k) + 2),
                                 12 * windows + 3 * n, int_ops_per_s)
            extra["windows"] = windows
            cut = k
        else:
            (pre,) = book.device_tables("prefix", dev)

            def run():
                return decode.decode_chunks_canonical(words, counts, *canon,
                                                      chunk=chunk, prefix=pre)

            def plain():
                return decode.decode_chunks_canonical_plain(
                    words, counts, *canon, chunk=chunk)
            bound, by = least_ms(stream_bytes + canonical_bytes
                                 + 2 * (1 << PREFIX_BITS),
                                 8 * n + 5 * nbits, int_ops_per_s)
        extra.update(max_code_len=int(book.lengths.max()),
                     slow_step_share=float((lens > cut).sum()) / n)
    got = run()
    want, plain_ms = timed_once(torch, plain)
    bad, err = compare(torch, (got,), (want,))
    need(torch.equal(concat_chunks(got, cc), sym), f"{kname}: the kernel "
         f"does not round-trip the plane")
    ms = cuda_ms(torch, run, 10)
    d_ms, _ = device_ms(torch, run, 10)
    return {"symbols": n, "chunks": nb, "chunk": chunk, "mismatches": bad,
            "max_abs_err": err, "ms": ms, "device_ms": d_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "chain_steps_per_chunk": steps, "chain_step_ns": step_ns,
            "chain_bound_ms": steps * step_ns * 1e-6,
            "ns_per_step": ms * 1e6 / steps, **extra,
            **launch_shape(kname, nb, sms, lut)}


def kv_call_planes(torch, dev, params, cfg) -> dict:
    """The symbols of a KV-shaped decode call: the byte planes (lo, hi)
    of the K and V of the model's cache node over the PROMPT + NEW - 1
    positions that the coded serve's last read holds (a prefill of that
    many seeded tokens), one stream a plane: as many chunks of
    DEFAULT_KV_CHUNK as that read decodes a plane if its segments (the
    prompt's and one a decode step) are whole chunks.  Phase 5 holds the
    count to the read that the coded serve made (``kv_last_read_chunks``
    of its record)."""
    from repro_torch.core.symbols import bf16_planes
    from repro_torch.models import prefill
    slots = PROMPT + NEW - 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, slots), generator=gen,
                           device=dev)
    with torch.no_grad():
        _, caches = prefill(params, {"tokens": tokens}, cfg, PROMPT + NEW)
    (node,) = [n for group in caches for n in group]
    kv = [node[x][:, :, :slots] for x in ("k", "v")]
    return {p: torch.cat([bf16_planes(t)[p].reshape(-1) for t in kv])
            for p in ("lo", "hi")}


def check_walkers(torch, dev, params, cfg, odd, int_ops_per_s, step_ns,
                  sms) -> dict:
    """The chunk walkers beyond the logits planes, each against its plain
    version: B3, B4 and B6 on ``w_gate[0]``'s hi plane (33.5 M symbols,
    16 384 chunks at CHUNK, far more than SMs) with the plane's own
    Huffman book and a QLC book from the same counts; B4 and B6 on a
    KV-shaped call (chunk 512, the coded serve's last read); B6 on the
    odd-chunk e4m3 plane (chunk 1001), where B1-B4 ran.  Returns kernel ->
    case -> record."""
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import bf16_planes
    from repro_torch.kernels import histogram
    from repro_torch.memstore.kvstore import DEFAULT_KV_CHUNK
    t0 = time.perf_counter()
    out = {k: {} for k in SHAPE_ENTRIES}

    def books_of(sym):
        hist = histogram.histogram256(sym).cpu().numpy()
        return build_codebook(hist), build_codebook(hist, codec="qlc")

    def run(tag, sym, chunk, kernels):
        huff, qlc = books_of(sym)
        for k in kernels:
            book = qlc if k == "decode_chunks_qlc" else huff
            out[k][tag] = walk_case(torch, dev, k, sym, book, chunk,
                                    int_ops_per_s, step_ns, sms)

    gate_hi = bf16_planes(params["groups"][0][0]["ffn"]["w_gate"][0])["hi"]
    run("w_gate[0] hi plane", gate_hi, CHUNK, tuple(SHAPE_ENTRIES))
    for p, sym in kv_call_planes(torch, dev, params, cfg).items():
        run(f"kv call {p} plane", sym, DEFAULT_KV_CHUNK,
            ("decode_chunks_multisym", "decode_chunks_qlc"))
    for p, sym in odd.items():
        run(f"odd chunk {p} plane", sym, ODD_CHUNK, ("decode_chunks_qlc",))
    print(f"walkers beyond the logits planes: {time.perf_counter() - t0:.1f} s")
    return out


# Phase 21: B4's windows.  On the logits plane every K that the
# reference's build_multisym_tables takes, with s_max from 1 (one symbol
# a window) past 16 (a K = 16 window's most); on a weight plane of 16 384
# chunks the windows whose rows fill shared memory (K 14, 16) beside one
# that leaves room (K 8).
WINDOW_KS = tuple(range(1, 17))
WINDOW_SMAX = (1, 3, 8, 13, 16, 24)
WINDOW_GATE = ((8, 14, 16), (8, 16))
WINDOW_REPS = 5


def window_case(torch, dev, tag, enc, book, k, s_max, win, step_ns, sms,
                card):
    """B4 on one coded plane with the book's (k, s_max) LUT: held to its
    plain version bit for bit and to the plane, one launch a call (none
    falls back), timed (the profiler's device events: the kernel's and,
    where the wrapper re-strides the LUT, its copy's; CUDA events over
    the calls), with the windows of each chunk, its chain bound, the
    share of slow windows and the launch shape.  ``win``: the windows
    of each chunk (``multisym_windows``)."""
    from repro_torch.core.codebook import multisym_device_tables
    from repro_torch.core.encoder import concat_chunks
    from repro_torch.kernels import build, decode
    sym, words, counts, cc, canon, lens = enc
    lut = multisym_device_tables(book.multisym_tables(k=k, s_max=s_max), dev)

    def run():
        return decode.decode_chunks_multisym(words, counts, *lut, *canon,
                                             chunk=CHUNK)

    before = build.LAUNCHES["decode_chunks_multisym"]
    got = run()
    launched = build.LAUNCHES["decode_chunks_multisym"] - before
    want = decode.decode_chunks_multisym_plain(words, counts, *lut, *canon,
                                               chunk=CHUNK)
    bad, err = compare(torch, (got,), (want,))
    need(launched == 1, f"B4 {tag} K {k} s_max {s_max}: {launched} launches "
         f"for one call")
    need(bad == 0, f"B4 {tag} K {k} s_max {s_max}: {bad} symbols differ "
         f"from the plain version")
    need(torch.equal(concat_chunks(got, cc), sym), f"B4 {tag} K {k} s_max "
         f"{s_max}: the kernel does not round-trip the plane")
    for _ in range(3):      # a window where the profiler missed a launch
        ev = device_events(torch, run, WINDOW_REPS)     # is read again
        kern = [v for name, v in ev.items() if "multisym" in name]
        if sum(n for _, n in kern) == WINDOW_REPS:
            break
    whole = sum(n for _, n in kern) == WINDOW_REPS     # else not measured
    kern = sum(us for us, _ in kern)
    copy = sum(us for name, (us, _) in ev.items() if "multisym" not in name)
    windows, longest = int(win.sum()), int(win.max())
    r = {"k": k, "s_max": s_max, "w": min(k, s_max), "mismatches": bad,
         "max_abs_err": err,
         "device_ms": kern / 1e3 / WINDOW_REPS if whole else None,
         "restride_device_ms": copy / 1e3 / WINDOW_REPS if whole else None,
         "ms": cuda_ms(torch, run, WINDOW_REPS),
         "windows_per_chunk": windows / win.numel(),
         "chain_steps_per_chunk": longest,
         "chain_bound_ms": longest * step_ns * 1e-6,
         "slow_window_share": float((lens > k).sum()) / windows,
         **launch_shape("decode_chunks_multisym", words.shape[0], sms, lut)}
    dev_ms = (f"{r['device_ms']:.4f} ms (re-stride "
              f"{r['restride_device_ms']:.4f})" if whole else "not measured "
              "(the profiler missed launches)")
    print(f"  B4 {tag} K {k:2d} s_max {s_max:2d}: device {dev_ms}, events "
          f"{r['ms']:.4f} ms"
          f", {r['windows_per_chunk']:.1f} windows a chunk (longest "
          f"{longest}), chain bound {r['chain_bound_ms']:.4f} ms, slow "
          f"{r['slow_window_share']:.4f}; rows of {r['row_bytes']} B in "
          f"{r['rows_in']} memory, {r['chunks_per_cta']} chunks a CTA, "
          f"{r['ctas']} CTAs, {r['waves']} wave(s) [{card}]", flush=True)
    return r


def window_domain_phase(torch, dev, planes, step_ns, sms, card) -> dict:
    """Phase 21: B4 over the reference's window domain (see WINDOW_KS):
    ``planes`` maps a tag to (symbols, book, Ks, s_max values).  Returns
    tag -> "K,s_max" -> ``window_case``'s record."""
    from repro_torch.core.encoder import chunk_counts_for
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    out = {}
    for tag, (sym, book, ks, smaxes) in planes.items():
        words, _ = ops.encode_with_book(sym, book, chunk=CHUNK)
        cc = chunk_counts_for(sym.numel(), CHUNK)
        counts = torch.from_numpy(cc).to(dev)
        lens = torch.from_numpy(book.lengths.astype("int64")).to(dev)[
            sym.long()]
        enc = (sym, words, counts, cc, book.device_tables("canonical", dev),
               lens)
        wins = {}       # the windows depend on K and W = min(K, s_max)
        out[tag] = {}
        for k in ks:
            for s in smaxes:
                w = min(k, s)
                key = (k if w > 1 else 0, w)    # one symbol a window: any K
                if key not in wins:
                    wins[key] = multisym_windows(torch, lens, CHUNK, k, w)
                out[tag][f"{k},{s}"] = window_case(
                    torch, dev, tag, enc, book, k, s, wins[key], step_ns,
                    sms, card)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s, "
          f"{sum(len(v) for v in out.values())} cases [{card}]")
    return out


def check_b5_to_b8(torch, dev, params, step_logits, int_ops_per_s,
                   step_ns, sms, b5_probes):
    """B5-B8 against their plain versions at the main path's shapes (see
    the module docstring), each timed by CUDA events beside its plain
    version and its yardstick.  Returns kernel -> its record fields."""
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import chunk_counts_for, concat_chunks
    from repro_torch.core.qlc import qlc_kernel_args
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.kernels import decode, histogram, ops
    from repro_torch.kernels import decode_matmul as dm
    from repro_torch.memstore import CompressedParamStore

    out = {}
    planes = SCHEMES["bf16"].to_symbols(step_logits)
    layer0 = params["groups"][0][0]
    w_gate0 = layer0["ffn"]["w_gate"][0]

    # ---- B5: exact 256-bin counts
    gate = bf16_planes(w_gate0)
    cases = {"logits lo": planes["lo"], "logits hi": planes["hi"],
             "w_gate[0] hi": gate["hi"], "w_gate[0] lo": gate["lo"],
             # the worst skew: every symbol in one bin of every counter
             "one value, 2^25 symbols": torch.full(
                 (1 << 25,), 0x3F, dtype=torch.uint8, device=dev)}
    for off in (1, 7, 15):              # views starting at any byte
        cases[f"logits lo from byte {off}"] = planes["lo"][off:]
    for n in (0, 1, 17, (1 << 20) + 3):  # ragged lengths
        cases[f"w_gate[0] lo[:{n}]"] = gate["lo"][:n]
    bad = err = 0
    for tag, sym in cases.items():
        got, want = histogram.histogram256(sym), histogram.histogram256_plain(
            sym)
        d = (got - want).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()))
        need(int(got.sum()) == sym.numel(), f"B5 {tag}: counts sum "
             f"{int(got.sum())} != {sym.numel()}")
    # the profiler has lost events of a window on this card (0.95 of the
    # kernel a call over 20 calls, or none at all); a lost event only
    # lowers a count, so one window reading the kernel once a call, and
    # nothing else, settles it (up to three windows are read)
    for _ in range(3):
        dev_ops = device_ops(torch,
                             lambda: histogram.histogram256(gate["hi"]))
        if list(dev_ops.values()) == [1.0]:
            break
    each = list(planes.values())
    n = each[0].numel()
    ms = cuda_ms(torch, lambda: [histogram.histogram256(s) for s in each],
                 50) / 2
    plain_ms = cuda_ms(torch, lambda: [histogram.histogram256_plain(s)
                                       for s in each], 20) / 2
    lib_ms = cuda_ms(torch, lambda: [torch.bincount(s, minlength=256)
                                     for s in each], 50) / 2
    dev_ms = device_ms(torch, lambda: [histogram.histogram256(s)
                                       for s in each], 50)[0] / 2
    lib_dev_ms = device_ms(torch, lambda: [torch.bincount(s, minlength=256)
                                           for s in each], 50)[0] / 2
    bound, by = least_ms(n + 256 * 8, 2 * n, int_ops_per_s)
    gate_bound, _ = least_ms(gate["hi"].numel() + 256 * 8,
                             2 * gate["hi"].numel(), int_ops_per_s)
    rec = {"mismatches": bad, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": lib_ms, "device_ms": dev_ms,
           "library_device_ms": lib_dev_ms, "symbols": n,
           "device_ops_per_call": dev_ops, "cases": len(cases),
           "w_gate0_symbols": gate["hi"].numel(),
           "w_gate0_bound_ms": gate_bound}
    # w_gate[0]'s planes (33.5 M symbols): B5 and its two probes in
    # turns, each plane's device time, and hi as the store finds it:
    # right after the split (warm) and after 128 MB of other traffic
    # (cold: more than the 50 MB L2).
    need(gate["hi"].numel() % 512 == 0, "B5 probes: whole 512-byte tiles")
    p_out = torch.zeros(256, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    probe_grid = {"match": 8 * sms, "private": 3 * sms}

    def probe(name, sym):
        e = b5_probes[name](sym.data_ptr(), sym.numel() // 16,
                            p_out.data_ptr(), probe_grid[name], stream)
        need(e == 0, f"{name} probe: launch failed with cudaError_t {e}")

    for p in ("hi", "lo"):
        for name in b5_probes:
            p_out.zero_()
            probe(name, gate[p])
            need(torch.equal(p_out, histogram.histogram256_plain(gate[p])),
                 f"{name} probe: wrong counts on w_gate[0] {p}")
        kern, *probe_ms = interleaved(
            (lambda: histogram.histogram256(gate[p]),
             *(lambda name=name: probe(name, gate[p]) for name in b5_probes)),
            lambda f: cuda_ms(torch, f, 20))
        rec[f"w_gate0_{p}_ms"] = kern
        for name, t in zip(b5_probes, probe_ms):
            rec[f"w_gate0_{p}_{name}_probe_ms"] = t
        rec[f"w_gate0_{p}_device_ms"] = device_ms(
            torch, lambda: histogram.histogram256(gate[p]), 20)[0]
    # the worst skew, and what a call costs before it counts a symbol
    rec["one_value_device_ms"] = device_ms(
        torch, lambda: histogram.histogram256(cases["one value, 2^25 "
                                                    "symbols"]), 20)[0]
    rec["empty_plane_device_ms"] = device_ms(
        torch, lambda: histogram.histogram256(gate["lo"][:0]), 50)[0]
    sink = torch.empty(1 << 25, dtype=torch.float32, device=dev)
    rec["w_gate0_hi_warm_ms"] = kernel_ms(
        torch, lambda: bf16_planes(w_gate0)["hi"], histogram.histogram256,
        "histogram256")
    rec["w_gate0_hi_cold_ms"] = kernel_ms(
        torch, lambda: (sink.add_(1.0), gate["hi"])[1],
        histogram.histogram256, "histogram256")
    if hasattr(histogram, "launch_grid"):   # an older B5 can be timed too
        wave = histogram.wave_ctas(dev.index)
        rec.update(wave_ctas=wave,
                   grid_logits=histogram.launch_grid(n, wave),
                   grid_w_gate0=histogram.launch_grid(gate["hi"].numel(),
                                                      wave))
    out["histogram256"] = rec

    # ---- B6: QLC decode at chunk 2048, books from the same logits
    books = {p: build_codebook(histogram.histogram256(s).cpu().numpy(),
                               codec="qlc", key=("act", "bf16", p))
             for p, s in planes.items()}
    enc = []
    bad = err = 0
    for p, sym in planes.items():
        words, bits = ops.encode_with_book(sym, books[p], chunk=CHUNK)
        cc = chunk_counts_for(sym.numel(), CHUNK)
        counts = torch.from_numpy(cc).to(dev)
        args = qlc_kernel_args(books[p], dev)
        k6 = decode.decode_chunks_qlc(words, counts, *args, chunk=CHUNK)
        p6 = decode.decode_chunks_qlc_plain(words, counts, *args, chunk=CHUNK)
        d = (k6.to(torch.int64) - p6.to(torch.int64)).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()))
        need(torch.equal(concat_chunks(k6, cc), sym), f"B6 {p}: the QLC "
             f"stream does not round-trip the plane")
        enc.append((words, counts, args, bits))
    ms = cuda_ms(torch, lambda: [decode.decode_chunks_qlc(
        w, c, *a, chunk=CHUNK) for w, c, a, _ in enc], 10) / 2
    dev_ms = device_ms(torch, lambda: [decode.decode_chunks_qlc(
        w, c, *a, chunk=CHUNK) for w, c, a, _ in enc], 10)[0] / 2
    _, plain_ms = timed_once(torch, lambda: [decode.decode_chunks_qlc_plain(
        w, c, *a, chunk=CHUNK) for w, c, a, _ in enc])
    nb = enc[0][0].shape[0]
    words_read = sum(used_words(b) for *_, b in enc) / 2
    bound, by = least_ms(words_read * 4 + nb * 4 + 256 * 4 + nb * CHUNK * 4,
                         16 * n, int_ops_per_s)
    out["decode_chunks_qlc"] = {
        "mismatches": bad, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms / 2, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "device_ms": dev_ms, "library_device_ms": None,
        "chain_steps_per_chunk": CHUNK,
        "chain_step_ns": step_ns, "chain_bound_ms": CHUNK * step_ns * 1e-6,
        "ns_per_step": ms * 1e6 / CHUNK, "symbols": n, "chunks": nb,
        "qlc_class_lengths": {p: b.class_lengths for p, b in books.items()},
        **launch_shape("decode_chunks_qlc", nb, sms)}

    # ---- B7 / B8: fused decode + matmul on three layer-0 matrices
    import ctypes
    from repro_torch.core.encoder import PREFIX_BITS
    from repro_torch.kernels.build import I as C_INT, P as C_PTR, bind
    d_model = w_gate0.shape[0]
    mats = {"w_down[0]": (layer0["ffn"]["w_down"][0], 4096),
            "w_gate[0]": (w_gate0, 16384),
            "wo[0]": (layer0["mixer"]["wo"][0].reshape(-1, d_model), 4096)}
    gen = torch.Generator().manual_seed(SEED + 1)
    xs = {tag: torch.randn((BATCH, w.shape[0]), generator=gen).to(
              torch.bfloat16).to(dev) for tag, (w, _) in mats.items()}
    # The slow-path case: a 2048 x 2048 weight whose lo bytes follow a
    # geometric law (byte k with weight 2^(-k/16)), so the lo book codes
    # the rare bytes in more than PREFIX_BITS bits (about 0.4 % of the lo
    # steps take the canonical search); and two decode batches whose M is
    # no multiple of anything the kernel tiles (M = 1 and M = 37) on wo[0].
    skew = (torch.randn((2048, 2048), generator=gen) * 0.02).to(
        torch.bfloat16).view(torch.int16)
    lo_byte = torch.clamp(-torch.log2(torch.rand((2048, 2048),
                                                 generator=gen)) * 16,
                          max=255).floor().to(torch.int16)
    skew = ((skew & -256) | lo_byte).view(torch.bfloat16).to(dev)
    extra = {"slow path (2048 x 2048, geometric lo bytes)":
             (skew, 4096, torch.randn((BATCH, 2048), generator=gen)),
             "wo[0], M = 1": (mats["wo[0]"][0], 4096,
                              torch.randn((1, 2048), generator=gen)),
             "wo[0], M = 37": (mats["wo[0]"][0], 4096,
                               torch.randn((37, 2048), generator=gen))}
    occupancy = bind("decode_matmul", "decode_matmul_occupancy",
                     [C_INT, C_PTR])
    for codec, kname, kern, plain in (
            ("huffman", "decode_matmul", dm.decode_matmul,
             dm.decode_matmul_plain),
            ("qlc", "decode_matmul_qlc", dm.decode_matmul_qlc,
             dm.decode_matmul_qlc_plain)):
        per_sm = ctypes.c_int(0)
        err = occupancy(int(codec == "qlc"), ctypes.addressof(per_sm))
        need(err == 0, f"{kname}: occupancy query failed ({err})")
        ctas_per_sm = per_sm.value
        rec = {"mismatches": 0, "max_abs_err": 0.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "device_ms": 0.0, "library_device_ms": 0.0,
               "chain_bound_ms": 0.0, "chain_step_ns": step_ns,
               "tolerance": MATMUL_TOL, "ctas_per_sm": ctas_per_sm,
               "by_matrix": {}, "extra_cases": {}}

        def run_case(tag, w, chunk, x):
            """Code w into a store, run the kernel and its plain version
            with tiles, check both; returns (store, blocks, args)."""
            k_rows, n_cols = w.shape
            st = CompressedParamStore.from_tree({"w": w}, codec=codec,
                                                chunk=chunk, min_size=1,
                                                device=dev)
            lo, hi, counts = st.plane_blocks("w")
            tabs = ops.decode_matmul_tables(st.books, dev)
            kw = dict(chunk=chunk, n_cols=n_cols)
            if codec == "huffman":
                kw["prefix"] = ops.decode_matmul_prefix(st.books, dev)
            y, tiles = kern(x, lo, hi, counts, *tabs, tiles=True, **kw)
            kw.pop("prefix", None)
            (yp, tp), p_ms = timed_once(torch, lambda: plain(
                x, lo, hi, counts, *tabs, tiles=True, **kw))
            t_bad = int((tiles.view(torch.int16)
                         != tp.view(torch.int16)).sum())
            need(torch.equal(tiles.reshape(-1)[:w.numel()].view(torch.int16),
                             w.reshape(-1).view(torch.int16)),
                 f"{kname} {tag}: decoded tiles are not the weight")
            y_err = float((y - yp).abs().max())
            need(y_err <= MATMUL_TOL, f"{kname} {tag}: product differs "
                 f"from the plain version by {y_err} > {MATMUL_TOL}")
            dense = (x.float() @ w.float())
            rel = float((y - dense).abs().max() / dense.abs().max())
            need(rel < 1e-4, f"{kname} {tag}: product vs dense rel err {rel}")
            rec["mismatches"] += t_bad
            rec["max_abs_err"] = max(rec["max_abs_err"], y_err)
            lens = {p: int(b.lengths.max()) if codec == "huffman" else
                    max(b.class_lengths) for p, b in st.books.items()}
            r = {"shape": [k_rows, n_cols], "m": x.shape[0], "chunk": chunk,
                 "chunks": lo.shape[0], "plain_ms": p_ms,
                 "tile_mismatches": t_bad, "max_abs_err": y_err,
                 "rel_err_vs_dense": rel, "max_code_len": lens}
            if codec == "huffman":      # lo steps that take the slow path
                cnt = torch.bincount((w.view(torch.int16) & 0xFF).reshape(
                    -1).long(), minlength=256).cpu()
                slow = torch.from_numpy(st.books["lo"].lengths > PREFIX_BITS)
                r["lo_slow_step_share"] = float(cnt[slow].sum() / cnt.sum())
            return st, (lo, hi, counts, tabs, kw), r

        for tag, (w, chunk) in mats.items():
            x = xs[tag]
            st, (lo, hi, counts, tabs, kw), r = run_case(tag, w, chunk, x)
            if codec == "huffman":
                kw["prefix"] = ops.decode_matmul_prefix(st.books, dev)
            k_ms = cuda_ms(torch, lambda: kern(x, lo, hi, counts, *tabs,
                                               **kw), 10)
            lib = cuda_ms(torch, lambda: x @ w, 50)
            k_dev = device_ms(torch, lambda: kern(x, lo, hi, counts, *tabs,
                                                  **kw), 10)[0]
            lib_dev = device_ms(torch, lambda: x @ w, 50)[0]
            lo_bits = torch.from_numpy(st.entries["w"].planes["lo"]
                                       .bit_counts)
            hi_bits = torch.from_numpy(st.entries["w"].planes["hi"]
                                       .bit_counts)
            nb = lo.shape[0]
            nbytes = (x.numel() * 2 + 4 * (used_words(lo_bits)
                                           + used_words(hi_bits))
                      + nb * 4 + 2 * (3 * 17 + 256) * 4
                      + BATCH * w.shape[1] * 4)
            bound, by = least_ms(nbytes, 2 * 16 * w.numel(), int_ops_per_s,
                                 flops=2.0 * BATCH * w.numel())
            chain = chunk * step_ns * 1e-6
            groups = -(-nb // dm.GROUP)
            rec["ms"] += k_ms
            rec["plain_ms"] += r["plain_ms"]
            rec["bound_ms"] += bound
            rec["library_ms"] += lib
            rec["device_ms"] += k_dev
            rec["library_device_ms"] += lib_dev
            rec["chain_bound_ms"] += chain
            r.update(ms=k_ms, bound_ms=bound, bound_by=by,
                     chain_bound_ms=chain, library_ms=lib, device_ms=k_dev,
                     library_device_ms=lib_dev,
                     chain_steps=chunk, ns_per_step=k_ms * 1e6 / chunk,
                     ctas=groups, ctas_per_sm=ctas_per_sm,
                     waves=-(-groups // (ctas_per_sm * sms)),
                     coded_ratio=st.footprint()["ratio"])
            rec["by_matrix"][tag] = r
            del st, lo, hi, counts
        for tag, (w, chunk, x) in extra.items():
            x = x.to(torch.bfloat16).to(dev)
            st, _, r = run_case(tag, w, chunk, x)
            rec["extra_cases"][tag] = r
            del st
        slow = rec["extra_cases"]["slow path (2048 x 2048, geometric lo bytes)"]
        if codec == "huffman":
            need(slow["max_code_len"]["lo"] > PREFIX_BITS, "B7 slow-path "
                 f"case: the lo book's longest code is "
                 f"{slow['max_code_len']['lo']} bits, not over "
                 f"{PREFIX_BITS}")
        rec["bound_by"] = max(rec["by_matrix"].values(),
                              key=lambda r: r["bound_ms"])["bound_by"]
        out[kname] = rec
    return out


def step_without_sync(torch, params, cfg, prompts, spec) -> None:
    """Run one serve step (after a warm-up step that fills the per-book
    device tables) with torch's CUDA sync debug mode set to raise."""
    from repro_torch.models import prefill
    from repro_torch.serve import make_serve_step
    step = make_serve_step(cfg, spec)
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": prompts}, cfg,
                                 PROMPT + NEW)
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, caches, _ = step(params, tok, caches, PROMPT)
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(params, tok, caches, PROMPT + 1)
        except RuntimeError as e:
            import traceback
            where = [ln for ln in traceback.format_exc().splitlines()
                     if "repro_torch" in ln or "chip_smoke" in ln]
            raise SmokeError(f"serve step ({spec.decode_backend}) waits for "
                             f"the device: {e}\n" + "\n".join(where)) from e
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def profile_steps(torch, params, cfg, prompts, spec, steps: int = 8):
    """Device time of ``steps`` serve steps after a prefill and a warm-up
    step (``steps_profile``): busy ms per step, the idle share of the
    steps' wall time, the top kernels and the port's kernels."""
    from repro_torch.models import prefill
    from repro_torch.serve import make_serve_step
    step = make_serve_step(cfg, spec)
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": prompts}, cfg,
                                 PROMPT + NEW)
        tok = logits[:, -1].argmax(-1)[:, None]
        step(params, tok, caches, PROMPT)               # warm-up
        at = {"tok": tok, "pos": PROMPT}

        def one():
            at["pos"] += 1
            logits, _, _ = step(params, at["tok"], caches, at["pos"])
            at["tok"] = logits[:, -1].argmax(-1)[:, None]

        return steps_profile(torch, one, steps)[1]


# ------------------------------------------- 18. the captured decode step
CAPTURE_STEPS = 8             # steps replayed beside the eager step
SYNC_FREE_NEW = 8             # tokens of the generate run in sync mode
CAPTURED = {}                 # path -> phase 18's record of that engine


def same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bytes (a NaN's and a zero's sign too)."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def captured_check(torch, eng, prompts, path, card, build, expect,
                   prefix=None) -> dict:
    """Phase 18 on one engine whose ``generate`` has run (so its
    ``CapturedStep`` holds the graph of this batch size): over
    ``CAPTURE_STEPS`` steps from one prefill, each replay against the
    plain step (``make_serve_step``, eager) on copies of the same inputs
    -- logits, every cache leaf and every metric equal bit for bit, the
    launch counts grown by the capture's (``expect`` among them) -- with
    each side's host time a step (the step and its one metrics copy);
    then a ``generate`` whose replay loop runs in torch's sync debug
    mode "error" except for each step's metrics copy; then the device
    time of one replay by CUDA events.  Records into ``CAPTURED``."""
    from repro_torch.device import metrics_to_host
    from repro_torch.models import prefill
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serve import CapturedStep
    from repro_torch.serve import engine as engine_mod

    t_check = time.perf_counter()
    cap = eng._step
    need(isinstance(cap, CapturedStep), f"{path}: the engine's step is a "
         f"{type(cap).__name__}, not a CapturedStep")
    graph = cap._graphs.get((prompts.shape[0], id(eng.params)))
    need(graph is not None, f"{path}: generate captured no graph")
    counted = graph.capture.launches
    need(all(counted.get(k, 0) > 0 for k in expect),
         f"{path}: the capture counted {counted}, not each of {expect}")

    # ---- replay vs eager, bit for bit, with each side's host time
    batch = {"tokens": prompts}
    if prefix is not None:
        batch["prefix_embeds"] = prefix
    start = prompts.shape[1] + (0 if prefix is None else prefix.shape[1])
    host = {"captured": [], "eager": []}
    with torch.no_grad():
        logits, caches = prefill(eng.params, batch, eng.cfg,
                                 eng.serve.max_cache_len)
        tok = logits[:, -1].argmax(-1)[:, None]
        ecaches = tree_map(torch.clone, caches)
        for i in range(CAPTURE_STEPS):
            pos = start + i
            torch.cuda.synchronize()
            before = dict(build.LAUNCHES)
            t0 = time.perf_counter()
            lc, caches, mc = cap(eng.params, tok, caches, pos)
            metrics_to_host(mc)
            host["captured"].append(time.perf_counter() - t0)
            grew = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES
                    if build.LAUNCHES[k] != before[k]}
            need(grew == counted, f"{path} replay {i}: launches grew by "
                 f"{grew}, the capture counted {counted}")
            t0 = time.perf_counter()
            le, ecaches, me = cap.step(eng.params, tok.clone(), ecaches, pos)
            metrics_to_host(me)
            host["eager"].append(time.perf_counter() - t0)
            need(same_bits(torch, lc, le), f"{path} step {i}: the replayed "
                 f"logits differ from the eager step's")
            for j, (a, b) in enumerate(zip(tree_leaves(caches),
                                           tree_leaves(ecaches))):
                need(same_bits(torch, a, b), f"{path} step {i}: cache leaf "
                     f"{j} {tuple(a.shape)} differs from the eager step's")
            need(sorted(mc) == sorted(me) and all(
                same_bits(torch, mc[k], me[k]) for k in mc),
                f"{path} step {i}: the metrics differ from the eager step's")
            tok = lc[:, -1].argmax(-1)[:, None]
    del ecaches, logits

    # ---- the replay loop of one generate, without a host sync but the
    # metrics copy of each step
    real_step, real_copy = eng._step, engine_mod.metrics_to_host

    def step(*a):
        torch.cuda.set_sync_debug_mode("error")
        return real_step(*a)

    def copy(m):
        torch.cuda.set_sync_debug_mode("default")
        return real_copy(m)

    eng._step, engine_mod.metrics_to_host = step, copy
    try:
        eng.generate(prompts, SYNC_FREE_NEW, prefix_embeds=prefix)
    except RuntimeError as e:
        raise SmokeError(f"{path}: the replay loop waits for the device "
                         f"outside the metrics copy: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
        eng._step, engine_mod.metrics_to_host = real_step, real_copy

    # ---- one replay's device time (CUDA events around the graph alone)
    dev_ms = []
    for _ in range(CAPTURE_STEPS):
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        graph.capture.graph.replay()
        t_end.record()
        t_end.synchronize()
        dev_ms.append(t_start.elapsed_time(t_end))

    def median(v):
        v = sorted(v)
        return v[len(v) // 2]

    cap_ms = median(host["captured"]) * 1e3
    eager_ms = median(host["eager"]) * 1e3
    device = median(dev_ms)
    rec = {"steps_compared": CAPTURE_STEPS, "replay_equals_eager": True,
           "launches_a_replay": counted,
           "sync_free_replays": SYNC_FREE_NEW - 1,
           "host_ms_median_eager": eager_ms,
           "host_ms_median_captured": cap_ms,
           "device_ms_a_replay": device, "device_ms_replays": dev_ms,
           "idle_share": 1.0 - device / cap_ms,
           "seconds": time.perf_counter() - t_check, "card": card}
    CAPTURED[path] = rec
    print(f"{path} captured step: {CAPTURE_STEPS} replays = the eager step "
          f"bit for bit (logits, caches, metrics), launches a replay "
          f"{counted}, {SYNC_FREE_NEW - 1} replays without a host "
          f"sync; host median a step {eager_ms:.3f} ms eager, {cap_ms:.3f} "
          f"ms captured; device {device:.3f} ms a replay (events), idle "
          f"share {rec['idle_share']:.3f} ({rec['seconds']:.1f} s) [{card}]")
    return rec


# ------------------------------------------- 20. the captured prefill
PREFILL_SHORT = 32            # the second request shape's prompt tokens
PREFILL_REPS = 11             # calls in each host median
PREFILL_EVENTS = 5            # replays timed by CUDA events, a shape
PREFILL_MEMORY_SHARE = 0.01   # of the card's memory, past a capture's outputs
CAPTURED_PREFILL = {}         # path -> phase 20's record of that engine


def captured_prefill_check(torch, eng, prompts, path, card,
                           prefix=None) -> dict:
    """Phase 20 on one served engine whose ``generate`` has run (so its
    ``CapturedPrefill`` holds the graph of the phase's request shape):
    each call against the eager ``prefill`` on copies of the same inputs
    (logits and every cache leaf bit for bit), at the phase's shape, at a
    shorter prompt (``PREFILL_SHORT`` tokens, a second graph in the
    first one's pool) and at the phase's shape again; exactly two graphs;
    allocated and reserved bytes across the second shape's capture grown
    by at most its outputs plus ``PREFILL_MEMORY_SHARE`` of the card, a
    replay growing none; one replay in sync debug mode "error"; a fresh
    engine of the same model given both shapes and dropped, its memory
    returned.  Timed: the host median of ``PREFILL_REPS`` calls at the
    phase's shape, eager and captured, each ending in one sync, a
    replay's device ms by CUDA events at both shapes, the idle share
    1 - device / captured host median, each graph's warm-up and capture
    seconds, peak allocated memory.  Records into ``CAPTURED_PREFILL``."""
    from repro_torch.models import prefill
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve import CapturedPrefill, Engine

    t_check = time.perf_counter()
    cap, params, cfg = eng._prefill, eng.params, eng.cfg
    need(isinstance(cap, CapturedPrefill), f"{path}: the engine's prefill "
         f"is a {type(cap).__name__}, not a CapturedPrefill")
    need(len(cap._graphs) == 1, f"{path}: generate left "
         f"{len(cap._graphs)} prefill graphs, not 1")
    slack = PREFILL_MEMORY_SHARE * torch.cuda.get_device_properties(
        0).total_memory
    seq = {"long": prompts.shape[1], "short": PREFILL_SHORT}
    shape = {k: f"{prompts.shape[0]} x "
             f"{'' if prefix is None else f'({prefix.shape[1]} + '}{s}"
             f"{'' if prefix is None else ')'}" for k, s in seq.items()}

    def request(which, variant):
        """New inputs of a shape: the prompts shifted by ``variant`` in
        the vocabulary, the prefix rolled by as many patches."""
        b = {"tokens": (prompts[:, :seq[which]] + variant) % cfg.vocab_size}
        if prefix is not None:
            b["prefix_embeds"] = prefix.roll(variant, dims=1)
        return b

    def memory():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    def held(which, variant, what):
        """One call against the eager prefill, bit for bit: (allocated,
        reserved) bytes the call grew, its outputs' bytes."""
        b = request(which, variant)
        a0, r0 = memory()
        logits, caches = cap(params, b)
        a1, r1 = memory()
        want, want_caches = prefill(params, {k: v.clone()
                                             for k, v in b.items()},
                                    cfg, eng.serve.max_cache_len)
        need(same_bits(torch, logits, want), f"{path} {what}: the "
             f"replayed logits differ from the eager prefill's")
        got, want = tree_leaves(caches), tree_leaves(want_caches)
        need(len(got) == len(want), f"{path} {what}: {len(got)} cache "
             f"leaves, the eager prefill {len(want)}")
        for j, (a, w) in enumerate(zip(got, want)):
            need(same_bits(torch, a, w), f"{path} {what}: cache leaf {j} "
                 f"{tuple(a.shape)} differs from the eager prefill's")
        out = sum(t.numel() * t.element_size() for t in [logits, *got])
        return a1 - a0, r1 - r0, out

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        grew = {"long": held("long", 1, f"{shape['long']} replay")}
        need(grew["long"][:2] == (0, 0), f"{path}: a replay grew memory by "
             f"{grew['long'][:2]} (allocated, reserved) bytes")
        grew["short"] = held("short", 0, f"{shape['short']} capture")
        a, r, out = grew["short"]
        need(a <= out + slack and r <= out + slack, f"{path}: the "
             f"{shape['short']} capture grew allocated / reserved memory by "
             f"{a} / {r} bytes, past its outputs' {out} + {slack:.0f}")
        held("long", 2, f"{shape['long']} replay after the "
             f"{shape['short']} capture")
        held("short", 3, f"{shape['short']} replay")
        need(len(cap._graphs) == 2, f"{path}: {len(cap._graphs)} prefill "
             f"graphs after two request shapes")
        pools = {g.capture.pool for g in cap._graphs.values()}

        # ---- one call (the inputs' copy and the replay) without a sync
        b = request("long", 4)
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            cap(params, b)
        except RuntimeError as e:
            raise SmokeError(f"{path}: a prefill replay waits for the "
                             f"device: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()

        # ---- host median, eager and captured in turns, each one sync
        host = {"eager": [], "captured": []}
        sides = (("eager", lambda: prefill(params, b, cfg,
                                           eng.serve.max_cache_len)),
                 ("captured", lambda: cap(params, b)))
        for _ in range(PREFILL_REPS):
            for side, fn in sides:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host[side].append(time.perf_counter() - t0)
        del b

        # ---- a replay's device time (events around the graph alone)
        dev_ms, seconds = {}, {}
        for g in cap._graphs.values():
            which = ("long" if g.batch["tokens"].shape[1] == seq["long"]
                     else "short")
            seconds[which] = dict(g.capture.seconds)
            ms = []
            for _ in range(PREFILL_EVENTS):
                t_start = torch.cuda.Event(enable_timing=True)
                t_end = torch.cuda.Event(enable_timing=True)
                t_start.record()
                g.capture.graph.replay()
                t_end.record()
                t_end.synchronize()
                ms.append(t_start.elapsed_time(t_end))
            dev_ms[which] = sorted(ms)[len(ms) // 2]
        peak = torch.cuda.max_memory_allocated()

        # ---- a fresh engine given both shapes, then dropped
        before = memory()
        fresh = Engine(params, cfg, eng.serve, device=eng.device)
        fresh._prefill(params, request("long", 5))
        first = memory()
        fresh._prefill(params, request("short", 6))
        second = memory()
        need(len(fresh._prefill._graphs) == 2, f"{path}: the fresh engine "
             f"holds {len(fresh._prefill._graphs)} prefill graphs")
        del fresh
        after = memory()
    need(len(pools) == 1, f"{path}: the two prefill graphs record into "
         f"{len(pools)} pools")
    back = (after[0] - before[0], after[1] - before[1])
    need(max(back) <= slack, f"{path}: dropping an engine left "
         f"{back[0]} allocated / {back[1]} reserved bytes of its two prefill "
         f"graphs")

    def median(v):
        v = sorted(v)
        return v[len(v) // 2]

    eager_ms = median(host["eager"]) * 1e3
    cap_ms = median(host["captured"]) * 1e3
    rec = {"shapes": shape, "replays_equal_eager": 4, "graphs": 2,
           "sync_free_replays": 1,
           "host_ms_median_eager": eager_ms,
           "host_ms_median_captured": cap_ms,
           "device_ms_a_replay": dev_ms,
           "idle_share": 1.0 - dev_ms["long"] / cap_ms,
           "warm_up_and_capture_s": seconds,
           "short_capture_grew_bytes": {"allocated": grew["short"][0],
                                        "reserved": grew["short"][1],
                                        "outputs": grew["short"][2]},
           "fresh_engine_reserved_bytes": {"first_graph":
                                           first[1] - before[1],
                                           "second_graph":
                                           second[1] - first[1]},
           "dropped_engine_left_bytes": {"allocated": back[0],
                                         "reserved": back[1]},
           "peak_allocated_gb": peak / 1e9,
           "seconds": time.perf_counter() - t_check, "card": card}
    CAPTURED_PREFILL[path] = rec
    print(f"{path} captured prefill: {shape['long']} and {shape['short']} "
          f"= the eager prefill bit for bit (logits, caches; 4 calls), one "
          f"pool; host median {eager_ms:.3f} ms eager, {cap_ms:.3f} ms "
          f"captured; device {dev_ms['long']:.3f} / {dev_ms['short']:.3f} "
          f"ms a replay (events), idle share {rec['idle_share']:.3f}; "
          f"warm-up + capture {seconds['long']['warm_up']:.2f} + "
          f"{seconds['long']['capture']:.2f} s / "
          f"{seconds['short']['warm_up']:.2f} + "
          f"{seconds['short']['capture']:.2f} s; the second capture grew "
          f"allocated {grew['short'][0] / 1e6:.1f} MB, reserved "
          f"{grew['short'][1] / 1e6:.1f} MB (outputs "
          f"{grew['short'][2] / 1e6:.1f} MB); a fresh engine's pool "
          f"{(first[1] - before[1]) / 1e6:.1f} + "
          f"{(second[1] - first[1]) / 1e6:.1f} MB, {back[1] / 1e6:.1f} MB "
          f"left once dropped; peak {peak / 1e9:.2f} GB "
          f"({rec['seconds']:.1f} s) [{card}]")
    return rec


# ------------------------------------------- 19. the captured train step
CT_STEPS, CT_FLIP = 12, 1     # steps a run; the epoch flips after step 1
CT_MEDIAN = 8                 # the last steps of epoch 2, in the medians
CT_REPLAYS = 3                # replays timed by CUDA events


def state_checksums(torch, state, block: int = 1 << 26) -> list:
    """One int64 a state leaf: its elements' bits (int16 for bf16, int32
    for float32 and int32) times (index mod 65521) + 1, summed (wrapping
    in int64), a block at a time."""
    from repro_torch.models.common import tree_leaves
    out = []
    for t in tree_leaves(state):
        flat = t.reshape(-1)
        if t.is_floating_point():
            flat = flat.view(torch.int16 if t.element_size() == 2
                             else torch.int32)
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, flat.numel(), block):
            part = flat[i:i + block].to(torch.int64)
            w = torch.arange(i, i + part.numel(), dtype=torch.int64,
                             device=t.device) % 65521 + 1
            total += (part * w).sum()
        out.append(int(total))
    return out


def captured_train_run(torch, dev, cfg, batch, seq, grad_accum, captured,
                       build) -> dict:
    """``CT_STEPS`` train steps of ``cfg`` at full width from seed 0
    (params, data), as ``launch.train.train`` runs them but with an
    epoch flip forced after step ``CT_FLIP`` (thresholds 0): the plain
    step or a ``CapturedTrainStep``.  Each step's host time (the step and
    its metrics copy, after a sync) and metrics; a captured run's replays
    in sync debug mode "error", each growing ``LAUNCHES`` by its
    capture's counts; then every state leaf's checksum, the peak memory
    and, captured, ``CT_REPLAYS`` replays' device ms by CUDA events."""
    from repro_torch.capture import release
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.device import metrics_to_host
    from repro_torch.launch.train import bootstrap_codebooks
    from repro_torch.lifecycle import BookLifecycleManager, DriftThresholds
    from repro_torch.models import model_init
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.train import (CapturedTrainStep, make_train_step,
                                   train_state_init)

    what = f"{cfg.name} {'captured' if captured else 'eager'}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        state = train_state_init(model_init(cfg, gen, device=dev))
    mgr = BookLifecycleManager(thresholds=DriftThresholds(
        kl_bits=0.0, excess_bits=0.0, min_symbols=1, patience=1))
    bootstrap_codebooks(state, mgr)
    sched = cosine_schedule(TRAIN_LR, warmup=1, total=CT_STEPS)

    def build_step(m):
        step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR), sched,
                               grad_accum=grad_accum,
                               comp_spec=m.spec("grad", "bf16", mode="ledger"))
        return CapturedTrainStep(step) if captured else step

    ds = SyntheticDataset(cfg, DataConfig(batch, seq, seed=SEED))
    data = [{k: torch.from_numpy(v).to(dev) for k, v in next(ds).items()}
            for _ in range(CT_STEPS)]
    step_fn = mgr.compiled("train_step", build_step)
    torch.cuda.synchronize()
    build.reset_launches()
    # no graph object is kept across steps: a released graph must go
    rows, host_s, captures, replays = [], [], [], 0
    for i in range(CT_STEPS):
        replay = captured and bool(step_fn._graphs)
        torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        if replay:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step_fn(state, data[i])
        except RuntimeError as e:
            raise SmokeError(f"{what} step {i} ({'replay' if replay else
                             'warm-up and capture' if captured else 'eager'})"
                             f" failed: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host = metrics_to_host(m)
        host_s.append(time.perf_counter() - t0)
        if captured:
            (cap,) = [g.capture for g in step_fn._graphs.values()]
            grew = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES
                    if build.LAUNCHES[k] != before[k]}
            if replay:
                replays += 1
                need(grew == cap.launches and grew.get("histogram256", 0) > 0,
                     f"{what} replay {i}: launches grew by {grew}, the "
                     f"capture counted {cap.launches}")
            else:
                captures.append(dict(cap.seconds))
            del cap
        rows.append(host)
        mgr.observe_train_metrics(host)
        if i == CT_FLIP:
            need(mgr.maybe_refresh() is not None, f"{what}: no epoch flip "
                 f"after step {i}")
            release(step_fn)
            step_fn = mgr.compiled("train_step", build_step)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved = torch.cuda.max_memory_reserved() / 1e9
    sums = state_checksums(torch, state)
    rec = {"rows": rows, "host_ms": [x * 1e3 for x in host_s],
           "checksums": sums, "names": leaf_names(state),
           "peak_memory_gb": peak, "peak_reserved_gb": peak_reserved,
           "launches": launches}
    if captured:
        need(len(captures) == 2 and replays == CT_STEPS - 2,
             f"{what}: {len(captures)} captures, {replays} replays")
        (cap,) = [g.capture for g in step_fn._graphs.values()]
        dev_ms = []
        for _ in range(CT_REPLAYS):         # uncounted: a timing, not the path
            t_start = torch.cuda.Event(enable_timing=True)
            t_end = torch.cuda.Event(enable_timing=True)
            t_start.record()
            cap.graph.replay()
            t_end.record()
            t_end.synchronize()
            dev_ms.append(t_start.elapsed_time(t_end))
        rec.update(device_ms_replays=dev_ms, launches_a_replay=cap.launches,
                   capture_seconds=captures, replays=replays)
        del cap
    release(step_fn)
    del state, m, data, step_fn, mgr
    torch.cuda.empty_cache()
    return rec


def leaf_names(state) -> list:
    """The state's leaf paths in ``tree_leaves`` order."""
    from repro_torch.models.common import tree_leaves
    return (["params" + n for n in tree_leaves(tree_map_names(state.params))]
            + ["opt/step"]
            + ["opt/m" + n for n in tree_leaves(tree_map_names(state.opt.m))]
            + ["opt/v" + n for n in tree_leaves(tree_map_names(state.opt.v))])


def run_differences(a: dict, b: dict) -> list:
    """Where two runs' metrics (step, key) and state checksums (leaf
    name) differ."""
    out = []
    for i, (ra, rb) in enumerate(zip(a["rows"], b["rows"])):
        if sorted(ra) != sorted(rb):
            out.append(f"step {i} keys")
            continue
        out += [f"step {i} {k}" for k in ra if not (
            ra[k] == rb[k] if isinstance(ra[k], float)
            else bool((ra[k] == rb[k]).all()))]
    out += [n for n, x, y in zip(a["names"], a["checksums"], b["checksums"])
            if x != y]
    return out


def captured_train_phase(torch, dev, card, build):
    """Phase 19 (see the module docstring).  Returns the record and the
    captured runs' launch counts, summed."""
    from repro_torch.configs import get_config, train_grad_accum
    from repro_torch.train.step import STEP_TOL

    t_phase = time.perf_counter()
    out, launches = {}, {k: 0 for k in build.LAUNCHES}
    for arch, batch, seq in (("gemma2-2b", TRAIN_BATCH, TRAIN_SEQ),
                             ("hubert-xlarge", HUBERT_BATCH, HUBERT_SEQ),
                             ("mamba2-780m", 1, MAMBA_SEQ)):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        ga = train_grad_accum(arch)
        eager = captured_train_run(torch, dev, cfg, batch, seq, ga, False,
                                   build)
        cap = captured_train_run(torch, dev, cfg, batch, seq, ga, True, build)
        for k, n in cap["launches"].items():
            launches[k] += n
        diffs = run_differences(cap, eager)
        held = "bit for bit"
        if diffs:
            again = captured_train_run(torch, dev, cfg, batch, seq, ga,
                                       False, build)
            eager_diffs = run_differences(again, eager)
            need(eager_diffs, f"{arch}: the captured run differs from the "
                 f"eager run where two eager runs agree bit for bit: "
                 f"{diffs[:12]}")
            rel = {k: max(abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(
                cap["rows"], eager["rows"])) for k in ("loss", "ce",
                                                       "grad_norm")}
            dev_tol = {"loss": max(rel["loss"], rel["ce"]),
                       "grad_norm": rel["grad_norm"]}
            need(all(v <= STEP_TOL[k] for k, v in dev_tol.items()),
                 f"{arch}: captured vs eager {dev_tol} past STEP_TOL; "
                 f"differing: {diffs[:12]}")
            held = (f"within STEP_TOL {dev_tol} (two eager runs differ too, "
                    f"at {eager_diffs[:6]}; the captured run at "
                    f"{diffs[:6]})")
        tail = slice(CT_STEPS - CT_MEDIAN, CT_STEPS)
        e_ms = sorted(eager["host_ms"][tail])[CT_MEDIAN // 2]
        c_ms = sorted(cap["host_ms"][tail])[CT_MEDIAN // 2]
        d_ms = sorted(cap["device_ms_replays"])[CT_REPLAYS // 2]
        r = {"batch": batch, "seq_len": seq, "grad_accum": ga,
             "steps": CT_STEPS, "flip_after_step": CT_FLIP,
             "held": held, "host_ms_median_eager": e_ms,
             "host_ms_median_captured": c_ms, "device_ms_a_replay": d_ms,
             "device_ms_replays": cap["device_ms_replays"],
             "idle_share": 1.0 - d_ms / c_ms,
             "host_ms_eager": eager["host_ms"],
             "host_ms_captured": cap["host_ms"],
             "capture_seconds": cap["capture_seconds"],
             "launches_a_replay": cap["launches_a_replay"],
             "replays": cap["replays"],
             "peak_memory_gb_eager": eager["peak_memory_gb"],
             "peak_memory_gb_captured": cap["peak_memory_gb"],
             "peak_reserved_gb_captured": cap["peak_reserved_gb"],
             "losses": [row["loss"] for row in cap["rows"]],
             "seconds": time.perf_counter() - t0, "card": card}
        need(all(math.isfinite(x) for x in r["losses"]),
             f"{arch}: a loss is not finite: {r['losses']}")
        out[arch] = r
        print(f"{arch} captured train step ({batch} x {seq}, grad_accum "
              f"{ga}): {CT_STEPS} steps across an epoch flip = the eager run "
              f"{held} (every metric, every state leaf's checksum); launches "
              f"a replay {r['launches_a_replay']}; {r['replays']} replays "
              f"without a host sync; host median a step {e_ms:.2f} ms eager, "
              f"{c_ms:.2f} ms captured; device {d_ms:.2f} ms a replay "
              f"(events), idle share {r['idle_share']:.4f}; warm-up and "
              f"capture s {r['capture_seconds']}; peak memory "
              f"{r['peak_memory_gb_eager']:.2f} GB eager, "
              f"{r['peak_memory_gb_captured']:.2f} GB captured (reserved "
              f"{r['peak_reserved_gb_captured']:.2f}); {r['seconds']:.1f} s "
              f"[{card}]")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return out, launches


def start_probe(build, name: str, source: str):
    """Start nvcc on a probe's source, into the kernels' build directory."""
    out = build.build_dir() / name
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(source)
    lib = out / f"lib{name}.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, proc, lib


def finish_probe(job, entry: str, argtypes):
    """Wait for a probe's nvcc and bind its C entry ``entry``."""
    import ctypes
    name, proc, lib = job
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    need(proc.returncode == 0, f"nvcc failed on the {name}:\n{out}")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def chain_step_ns(torch, launch, dev, size: int = 1 << 13,
                  steps: int = 1 << 20) -> float:
    """ns per step of the chain probe: the least of three timed walks of
    ``steps`` dependent lookups through a ``size``-entry table whose
    entries form one random cycle; the walk's end is checked."""
    order = torch.randperm(size, generator=torch.Generator().manual_seed(SEED))
    table = torch.empty(size, dtype=torch.int64)
    table[order] = torch.roll(order, -1) << 3
    table = table.to(torch.int32).to(dev)
    sink = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = launch(table.data_ptr(), size, steps, sink.data_ptr(), stream)
        need(err == 0, f"chain probe: launch failed with cudaError_t {err}")

    best = min(cuda_ms(torch, run, 1) for _ in range(3))
    start = int((order == 0).nonzero()[0, 0])
    want = int(order[(start + steps + 1) % size]) << 3
    need(int(sink.item()) == want, "chain probe: the walk ended at "
         f"{int(sink.item())}, expected {want}")
    return best * 1e6 / steps


def multisym_windows(torch, lens, chunk: int, k: int, s_max: int):
    """Windows B4 steps through in each chunk of a plane whose codes have
    lengths ``lens`` (N,): from its cursor a window takes the following
    codes while they fit in k bits, at most s_max of them, and at least
    one (a longer code's slow path), as ``build_multisym_tables`` does."""
    dev = lens.device
    n = lens.numel()
    nb = -(-n // chunk)
    ln = torch.zeros(nb * chunk, dtype=torch.int64, device=dev)
    ln[:n] = lens.to(torch.int64)
    ends = torch.cat([torch.zeros((nb, 1), dtype=torch.int64, device=dev),
                      ln.reshape(nb, chunk).cumsum(1)], dim=1)
    counts = torch.clamp(n - torch.arange(nb, device=dev) * chunk, max=chunk)
    pos = torch.zeros(nb, dtype=torch.int64, device=dev)
    steps = torch.zeros(nb, dtype=torch.int64, device=dev)
    for i in range(chunk):                  # every window takes a symbol
        if i % 64 == 0 and not bool((pos < counts).any()):
            break                           # (a sync every 64 windows)
        live = pos < counts
        reach = ends.gather(1, pos[:, None]) + k
        fit = torch.searchsorted(ends, reach, right=True)[:, 0] - 1
        nxt = torch.minimum(torch.maximum(fit, pos + 1), pos + s_max)
        pos = torch.where(live, nxt, pos)
        steps += live.to(torch.int64)
    return steps


def kernel_bounds(torch, enc, chunk, cap_words, int_ops_per_s, step_ns):
    """Least time per call (one plane, the mean of the planes) for each
    kernel on this run's data: the larger of bytes over the HBM rate
    (each input read once, each output written once) and 32-bit
    operations over the card's INT32 rate.  B3 and B4 also get their
    chain bound: inside a chunk each step needs the step before it, so
    a call takes at least its longest chunk's steps (B3: its symbols,
    B4: its windows) times the least time of one step (``step_ns``)."""
    n = sum(e[0].numel() for e in enc.values()) / len(enc)
    bits = sum(int(e[3][1].to(torch.int64).sum()) for e in enc.values()
               ) / len(enc)
    nb = -(-int(n) // chunk)
    cap = cap_words(chunk)
    # words a decoder must read: each chunk's payload plus its pad word
    used_words = sum(int(((e[3][1].to(torch.int64) + 31) // 32 + 1).sum())
                     for e in enc.values()) / len(enc)
    tables = (3 * 17 + 256) * 4
    size, s_max = next(iter(enc.values()))[6][0].shape     # the LUT in use
    k = size.bit_length() - 1
    ms_tables = size * (min(s_max, k) + 2)

    def best(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / int_ops_per_s
        return (tb, "bytes") if tb >= to else (to, "operations")

    windows = bits / k                      # a window consumes <= K bits
    out = {
        "encode_lookup": best(n + 256 * 8 + 8 * n + 8, 2 * n),
        "pack_blocks": best(8 * n + nb * cap * 4 + nb * 4, 12 * n),
        "decode_chunks_canonical": best(
            used_words * 4 + nb * 4 + tables + 2 * 4096 + nb * chunk * 4,
            8 * n + 5 * bits),
        "decode_chunks_multisym": best(
            used_words * 4 + nb * 4 + tables + ms_tables + nb * chunk * 4,
            12 * windows + 3 * n),
    }
    chain = {       # the longest chunk's steps, per plane
        "decode_chunks_canonical": {
            p: int(e[4].max()) for p, e in enc.items()},
        "decode_chunks_multisym": {
            p: int(multisym_windows(torch, e[2][1], chunk, e[6][0].shape[0]
                                    .bit_length() - 1, e[6][0].shape[1]).max())
            for p, e in enc.items()},
    }
    extra = {"mean_code_bits": bits / n, "symbols": int(n), "chunks": nb}
    res = {}
    for k, (t, by) in out.items():
        more = dict(extra)
        if k in chain:
            steps = sum(chain[k].values()) / len(enc)
            more.update(chain_steps_per_chunk=steps,
                        chain_steps_by_plane=chain[k], chain_step_ns=step_ns,
                        chain_bound_ms=steps * step_ns * 1e-6)
        res[k] = (t, by, more)
    return res


# ------------------------------------------------------------ ring phase
RING_N = 4                    # ranks of the loopback ring (one card)
RING_CHUNK = 2048
E4M3_SIZE = 1 << 18           # symbols a rank of the e4m3 all_reduce case


def plain_ring(torch, x, carry: str, reduce_only: bool = False):
    """The uncoded loopback ring: the coded ring's hop schedule and adds
    with no coding.  x (n, size) bf16, n ranks stacked → (y, shipped):
    y (n, size) (``reduce_only``: (n, seg), rank i owning segment i), and
    for every hop the wire-dtype components each rank ships, (n, seg)
    apiece.  ``carry="f32"`` ships (rounded value, residual) pairs and
    adds in float32, as ``comm.ring`` does."""
    n, size = x.shape
    seg = -(-size // n)
    acc_dt = torch.float32 if carry == "f32" else x.dtype
    acc = torch.nn.functional.pad(x.to(acc_dt), (0, n * seg - size)
                                  ).reshape(n, n, seg)
    i = torch.arange(n, device=x.device)

    def comps(v):
        if carry == "wire":
            return (v,)
        hi = v.to(x.dtype)
        return (hi, (v - hi.float()).to(x.dtype))

    def value(c):
        return c[0] if carry == "wire" else c[0].float() + c[1].float()

    def hop(c):
        return tuple(torch.roll(ci, 1, 0) for ci in c)

    shipped = []
    start = -1 if reduce_only else 0
    cur = acc[i, (i + start) % n]
    for t in range(n - 1):
        c = comps(cur)
        shipped.append(c)
        cur = value(hop(c)) + acc[i, (i + start - t - 1) % n]
    if reduce_only:
        return cur.to(x.dtype), shipped
    out = torch.zeros((n, n, seg), dtype=acc_dt, device=x.device)
    out[i, (i + 1) % n] = cur
    c = comps(cur)
    for t in range(n - 1):
        shipped.append(c)
        c = hop(c)
        out[i, (i - t) % n] = value(c)
    return out.reshape(n, -1)[:, :size].to(x.dtype), shipped


def plain_hierarchy(torch, x):
    """The uncoded 2 x 2 hierarchical all_reduce (wire carry): x (n_o,
    n_i, size) → inner reduce-scatter, outer all-reduce on the owned
    segment, inner all-gather."""
    n_o, n_i, size = x.shape
    seg = torch.stack([plain_ring(torch, x[o], "wire", True)[0]
                       for o in range(n_o)])                 # (o, i, seg)
    red = torch.stack([plain_ring(torch, seg[:, i], "wire")[0]
                       for i in range(n_i)], dim=1)         # (o, i, seg)
    full = red.reshape(n_o, 1, -1)[..., :size]
    return full.expand(n_o, n_i, size)


def recording_axes(torch, LoopbackAxis, sizes):
    """Loopback axes (``loopback_mesh``'s layout) that keep every tensor
    they move: the words (and bit counts) of each hop or gather."""
    sent = []

    class Rec(LoopbackAxis):
        def ppermute(self, tensors, shift):
            sent.extend(tensors if isinstance(tensors, tuple) else
                        (tensors,))
            return super().ppermute(tensors, shift)

        def all_gather(self, t):
            sent.append(t)
            return super().all_gather(t)

    batch = tuple(sizes.values())
    axes = {name: Rec(n, name=name, batch=batch, dim=d)
            for d, (name, n) in enumerate(sizes.items())}
    return axes, sent


def held_to_plain(torch, LoopbackAxis, name, fn, x, sizes):
    """Runs ``fn(x, axes)`` on the card and on a CPU copy (the kernels'
    plain versions) over recording loopback axes of ``sizes``; fails
    unless every tensor moved (hop words, bit counts), every stat and
    the result are equal bit for bit.  Returns (the card's result, its
    number of tensors moved)."""
    out = []
    for d in (x.device, torch.device("cpu")):
        axes, sent = recording_axes(torch, LoopbackAxis, sizes)
        y, st = fn(x.to(d), axes)
        out.append((y, st, sent))
    (gy, gst, gsent), (cy, cst, csent) = out
    need(len(gsent) == len(csent) and all(
        torch.equal(a.cpu(), b) for a, b in zip(gsent, csent)),
         f"{name}: the card's hop words differ from the plain versions'")
    need(set(gst) == set(cst) and all(
        torch.equal(gst[k].cpu(), cst[k]) for k in gst),
         f"{name}: stats differ from the plain versions'")
    need(torch.equal(bits_of(torch, gy.cpu()), bits_of(torch, cy)),
         f"{name}: result differs from the plain versions'")
    return gy, len(gsent)


def codec_held_to_plain(torch, name, sym, book, chunk, stream=None,
                        decoded=None):
    """B1, B2 and B4 on the card on one plane ``sym`` (outside any
    counted run), against their plain versions on CPU copies: the codes,
    lengths, total bits, words, ``block_bits`` and decoded symbols equal
    bit for bit, and the decode lossless.  Where the main path's
    ``stream`` (``encode_chunked``) and ``decoded`` (``decode_chunked``)
    are given, they are held to the plain versions too."""
    from repro_torch.core.encoder import chunk_counts_for, concat_chunks
    from repro_torch.kernels import bitpack, decode, encode

    cc = chunk_counts_for(sym.numel(), chunk)
    out = []
    for d, b1, b2, b4 in (
            (sym.device, encode.encode_lookup, bitpack.pack_blocks,
             decode.decode_chunks_multisym),
            (torch.device("cpu"), encode.encode_lookup_plain,
             bitpack.pack_blocks_plain, decode.decode_chunks_multisym_plain)):
        (lut,) = book.device_tables("lut", d)
        k1 = b1(sym.to(d), lut)
        k2 = b2(k1[0], k1[1], chunk=chunk)
        k4 = b4(k2[0], torch.from_numpy(cc).to(d),
                *book.device_tables("multisym", d),
                *book.device_tables("canonical", d), chunk=chunk)
        out.append(tuple(k1) + tuple(k2) + (concat_chunks(k4, cc),))
    got, want = out
    for what, g, w in zip(("codes", "lengths", "total bits", "words",
                           "block_bits", "decoded"), got, want):
        need(compare(torch, (g.cpu(),), (w,))[0] == 0 and g.shape == w.shape,
             f"{name}: the card's {what} differ from the plain versions'")
    need(torch.equal(want[-1], sym.cpu()), f"{name}: the plain versions do "
         f"not round-trip the plane")
    if stream is not None:
        need(torch.equal(stream.block_words.cpu(), want[3]) and
             torch.equal(stream.block_bits.cpu(), want[4]),
             f"{name}: the main path's stream differs from the plain "
             f"versions'")
    if decoded is not None:
        need(torch.equal(decoded.cpu(), want[-1]), f"{name}: the main "
             f"path's decode differs from the plain versions'")


def bits_of(torch, t):
    """A tensor's bit pattern as an integer tensor (for bitwise equality)."""
    ints = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
            torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def ring_phase(torch, dev, params, cfg, books, step_logits, warm, card,
               build):
    """The compressed collectives on a loopback ring of RING_N ranks at
    gemma2-2b width (see the module docstring, phase 6).  Returns the
    ring record and the main path's launch counts."""
    from repro_torch.comm import (TRANSPORTS, LoopbackAxis,
                                  hierarchical_all_reduce, loopback_mesh,
                                  ring_all_gather, ring_all_reduce,
                                  ring_all_to_all, ring_reduce_scatter)
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import decode_jit, encode_jit
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.kernels.ops import message_bits, recode_with_book
    from repro_torch.launch.dryrun import ring_check
    from repro_torch.models.blocks import block_apply
    from repro_torch.models.layers import embed_apply
    from repro_torch.models.transformer import _layers
    from repro_torch.comm.transport import decode_blocks
    from repro_torch.comm.wire import wire_add

    n = RING_N
    ax = LoopbackAxis(n)
    mesh = loopback_mesh({"outer": 2, "inner": 2})
    hier_axes = (mesh["inner"], mesh["outer"])
    t_phase = time.perf_counter()

    def hist_books(t, codec="huffman"):
        return {p: build_codebook(histogram_np(torch, s), codec=codec)
                for p, s in SCHEMES["bf16"].to_symbols(t).items()}

    # DP gradient all-reduce: every rank holds one layer's w_gate-shaped
    # gradient, N(0, 1e-3^2); books from an earlier draw (another seed).
    shape = (cfg.d_model, cfg.d_ff)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    grad_books = hist_books(torch.randn(shape, generator=g, device=dev)
                            * 1e-3)
    g.manual_seed(SEED + 2)
    grads = (torch.randn((n, *shape), generator=g, device=dev)
             * 1e-3).to(torch.bfloat16)
    ints = torch.randint(-2, 3, (n, *shape), generator=g,
                         device=dev).to(torch.bfloat16)
    int_books = hist_books(torch.randint(-2, 3, shape, generator=g,
                                         device=dev).to(torch.bfloat16))
    # TP logits gather: the wire serve's step logits, vocab-sharded.
    shards = step_logits.reshape(BATCH, n, -1).transpose(0, 1).contiguous()
    # A prefill hidden state split four ways: rank r holds the hidden
    # state after block r of the warm-up prefill (4 x 64 x 2048).
    with torch.no_grad():
        h = embed_apply(params["embed"], warm, cfg)
        hid = []
        for _, _, _, kind, p in _layers(cfg, params):
            h, _, _ = block_apply(kind, p, h, cfg)
            hid.append(h.to(torch.bfloat16))
            if len(hid) == n:
                break
    hidden = torch.stack(hid)                      # (rank, 4, 64, 2048)
    hid_books = hist_books(hid[0])
    who = {
        "dp_grad": f"data-parallel gradient sync: {n} replicas all-reduce "
                   f"one layer's w_gate gradient {tuple(shape)} bf16",
        "tp_logits": f"tensor-parallel serving: {n} vocab shards of a "
                     f"batch-{BATCH} step's logits gathered on every rank",
        "prefill_a2a": f"sequence/expert parallelism: a prefill hidden "
                       f"state {tuple(hidden.shape[1:])} redistributed "
                       f"among {n} ranks",
    }
    for k, v in who.items():
        print(f"  {k}: {v}")

    def ar(carry, backend, x=None):
        return lambda a=ax: ring_all_reduce(
            grads if x is None else x, a,
            grad_books if x is None else int_books, chunk=RING_CHUNK,
            decode_backend=backend, carry=carry)

    ops = {
        "ar_wire_multisym": ("ar", 1, ar("wire", "multisym")),
        "ar_f32_multisym": ("ar", 2, ar("f32", "multisym")),
        "ar_wire_scan": ("ar", 1, ar("wire", "scan")),
        "ar_f32_scan": ("ar", 2, ar("f32", "scan")),
        "rs_wire_multisym": ("rs", 1, lambda a=ax: ring_reduce_scatter(
            grads, a, grad_books, chunk=RING_CHUNK)),
        "hier_2x2": ("hier", 1, lambda a=hier_axes: hierarchical_all_reduce(
            grads.reshape(2, 2, *shape), a, grad_books, chunk=RING_CHUNK)),
        "ar_int": ("ar", 1, ar("wire", "multisym", ints)),
        "ring_ag": ("ag", 1, lambda a=ax: ring_all_gather(
            shards, a, books, chunk=RING_CHUNK)),
        "chunked_ag": ("chunked", 1, lambda a=ax: TRANSPORTS[
            "chunked"].all_gather(shards, a, books, chunk=RING_CHUNK)),
        "mono_ag": ("mono", 1, lambda a=ax: TRANSPORTS[
            "monolithic"].all_gather(shards, a, books)),
        "ring_a2a": ("a2a", 1, lambda a=ax: ring_all_to_all(
            hidden, a, hid_books, chunk=RING_CHUNK)),
    }

    # ---- the main path: launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    results, per_op = {}, {}
    for name, (_, _, fn) in ops.items():
        before = dict(build.LAUNCHES)
        results[name] = fn()
        per_op[name] = {k: build.LAUNCHES[k] - before[k]
                        for k in build.LAUNCHES
                        if build.LAUNCHES[k] != before[k]}
    checks = {codec: ring_check(8, codec=codec, device=dev, verbose=False)
              for codec in ("huffman", "qlc")}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"ring main path: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches} [{card}]")

    # ---- results against the uncoded ring, sums, gathers, permutes
    for codec, rec in checks.items():
        need(rec["status"] == "ok", f"ring_check ({codec}) on the card: "
             f"{rec}")
    for name in ("ar_wire_multisym", "ar_f32_multisym", "ar_wire_scan",
                 "ar_f32_scan", "rs_wire_multisym"):
        carry = "f32" if "f32" in name else "wire"
        y, st = results[name]
        flat = grads.reshape(n, -1)
        want, shipped = plain_ring(torch, flat, carry,
                                   reduce_only=name.startswith("rs"))
        need(torch.equal(bits_of(torch, y.reshape(want.shape)),
                         bits_of(torch, want)),
             f"{name}: coded ring != uncoded loopback ring")
        hop = st["hop_coded_bits"][0].tolist()
        need(len(hop) == len(shipped), f"{name}: {len(hop)} hops")
        for h, c in enumerate(shipped):            # B5 . lengths per hop
            bits = sum(int(message_bits(p_sym, grad_books[p].lengths))
                       for ci in c for p, p_sym in
                       SCHEMES["bf16"].to_symbols(ci).items())
            need(bits / n == hop[h], f"{name} hop {h}: hop_coded_bits "
                 f"{hop[h]} != B5 . lengths {bits / n}")
        ncomp = 2 if carry == "f32" else 1
        f = 2.0 * (n - 1) / n if name.startswith("ar") else (n - 1) / n
        need(float(st["raw_wire_bits"][0]) == f * flat.shape[1] * 16 * ncomp,
             f"{name}: raw_wire_bits {float(st['raw_wire_bits'][0])}")
    y, _ = results["hier_2x2"]
    need(torch.equal(bits_of(torch, y.reshape(2, 2, -1)), bits_of(
        torch, plain_hierarchy(torch, grads.reshape(2, 2, -1)))),
         "hier_2x2: coded != uncoded hierarchical ring")
    y, _ = results["ar_int"]
    need(torch.equal(y.float(), ints.float().sum(0).expand_as(y)),
         "ar_int: integer payload != torch.sum")
    gathered = shards.reshape(1, -1, shards.shape[-1]).expand(n, -1, -1)
    for name in ("ring_ag", "chunked_ag", "mono_ag"):
        need(torch.equal(bits_of(torch, results[name][0]),
                         bits_of(torch, gathered)), f"{name}: gather")
    coded = {k: float(results[k][1]["coded_wire_bits"][0])
             for k in ("ring_ag", "chunked_ag", "mono_ag")}
    need(len(set(coded.values())) == 1, f"all_gather coded bits {coded}")
    need(torch.equal(bits_of(torch, results["ring_a2a"][0]),
                     bits_of(torch, hidden.transpose(0, 1))),
         "ring_a2a: != the permuted shards")

    # ---- one launch a plane a hop (B4, or B3 under scan; B1 = B2).  A
    # coded stream is made for every hop that ships one and for no other
    # (all_reduce: its 2(n-1) hops; reduce-scatter, all_gather and
    # all_to_all: n-1); the 2 x 2 hierarchy: 1 + 2 + 1.
    encodes = {"ar": 2 * n - 2, "rs": n - 1, "hier": 4, "ag": n - 1,
               "a2a": n - 1}
    decoder = {"scan": "decode_chunks_canonical"}
    for name, (kind, ncomp, _) in ops.items():
        grew = per_op[name]
        if kind in encodes:
            hops = round(float(results[name][1]["hops"].sum()))
            dk = decoder.get(name.split("_")[-1], "decode_chunks_multisym")
            need(grew.get(dk, 0) == hops * 2 * ncomp,
                 f"{name}: {grew.get(dk, 0)} {dk} launches for {hops} hops")
            for k in ("encode_lookup", "pack_blocks"):
                need(grew.get(k, 0) == encodes[kind] * 2 * ncomp,
                     f"{name}: {grew.get(k, 0)} {k} launches")
        if kind in ("ar", "rs", "hier", "a2a"):
            need(grew.get("histogram256", 0) > 0, f"{name}: B5 not launched")
    for k in ("encode_lookup", "pack_blocks", "decode_chunks_multisym",
              "decode_chunks_canonical", "histogram256",
              "decode_chunks_qlc"):
        need(launches[k] > 0, f"ring: kernel {k} was not launched")

    # ---- time a call of each op (events; profiler device time)
    rec = {"n_ranks": n, "chunk": RING_CHUNK, "card": card, "who": who,
           "ops": {}, "hops": {}}
    for name, (kind, ncomp, fn) in ops.items():
        y, st = results[name]
        hop = (st["hop_coded_bits"].reshape(
            -1, st["hop_coded_bits"].shape[-1])[0].tolist()
            if "hop_coded_bits" in st else [])
        r = {"ms": cuda_ms(torch, fn, 2), "launches": per_op[name],
             "raw_wire_bits": float(st["raw_wire_bits"].reshape(-1)[0]),
             "coded_wire_bits": float(st["coded_wire_bits"].reshape(-1)[0])}
        r["device_ms"], r["device_ops"] = device_ms(torch, fn, 2)
        r["coded_over_raw"] = r["coded_wire_bits"] / r["raw_wire_bits"]
        if hop:
            seg_bits = r["raw_wire_bits"] / len(hop)
            r["hop_coded_over_raw"] = [b / seg_bits for b in hop]
        rec["ops"][name] = r
        print(f"  {name}: {r['ms']:.3f} ms (device {r['device_ms']:.3f} ms, "
              f"{r['device_ops']:.0f} device ops), coded/raw "
              f"{r['coded_over_raw']:.4f}"
              + (", per hop " + " ".join(f"{v:.4f}" for v in
                                          r["hop_coded_over_raw"])
                 if hop else "") + f" [{card}]")

    # ---- one hop's parts at the w_gate size (a reduce-scatter hop)
    seg = grads.reshape(n, -1)[:, :grads[0].numel() // n].contiguous()
    seg_len = seg.shape[1]
    counts = torch.full((n * seg_len // RING_CHUNK,), RING_CHUNK,
                        dtype=torch.int32, device=dev)
    planes = {p: s.reshape(-1, RING_CHUNK)
              for p, s in SCHEMES["bf16"].to_symbols(seg).items()}
    enc = {p: recode_with_book(b, seg_len, grad_books[p])
           for p, b in planes.items()}
    # B1 -> B2 on that hop (whole chunks, as the main path's) and on the
    # same blocks read as segments one symbol short (a ragged tail in
    # every rank's last chunk), held to the plain versions on CPU copies
    t0 = time.perf_counter()
    for n_seg in (seg_len, seg_len - 1):
        for p, b in planes.items():
            got = (enc[p] if n_seg == seg_len else
                   recode_with_book(b, n_seg, grad_books[p]))
            want = recode_with_book(b.cpu(), n_seg, grad_books[p])
            need(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                 f"w_gate hop recode ({p} plane, {n_seg} symbols a "
                 f"segment): the card's words or bits != the plain "
                 f"versions'")
    print(f"w_gate hop recode (B1 -> B2, {n} x {seg_len} symbols a plane, "
          f"whole and ragged segments): words and bits equal to the plain "
          f"versions ({time.perf_counter() - t0:.1f} s)")
    parts = {
        "decode_multisym": lambda: [decode_blocks(
            w, counts, grad_books[p], RING_CHUNK, "multisym")
            for p, (w, _) in enc.items()],
        "decode_scan": lambda: [decode_blocks(
            w, counts, grad_books[p], RING_CHUNK, "scan")
            for p, (w, _) in enc.items()],
        "add": lambda: wire_add(seg, seg),
        "recode": lambda: [recode_with_book(
            s.reshape(-1, RING_CHUNK), seg_len, grad_books[p])
            for p, s in SCHEMES["bf16"].to_symbols(seg).items()],
        "recode_ragged": lambda: [recode_with_book(
            s.reshape(-1, RING_CHUNK), seg_len - 1, grad_books[p])
            for p, s in SCHEMES["bf16"].to_symbols(seg).items()],
        "roll": lambda: [ax.ppermute(w.view(n, -1, w.shape[-1]), 1)
                         for w, _ in enc.values()],
    }
    for k, fn in parts.items():
        r = {"ms": cuda_ms(torch, fn, 10)}
        r["device_ms"], r["device_ops"] = device_ms(torch, fn, 10)
        rec["hops"][k] = r
        print(f"  hop part {k} ({n} ranks x {seg.shape[1]} elements, both "
              f"planes): {r['ms']:.4f} ms (device {r['device_ms']:.4f}) "
              f"[{card}]")

    # ---- kernels against plain at the logits size, bit for bit
    t0 = time.perf_counter()
    small = grads.reshape(n, -1)[:, :BATCH * cfg.vocab_size].contiguous()
    cases = {
        "ar_wire_multisym": lambda x, a: ring_all_reduce(
            x, a["r"], grad_books, chunk=RING_CHUNK),
        "ar_f32_multisym": lambda x, a: ring_all_reduce(
            x, a["r"], grad_books, chunk=RING_CHUNK, carry="f32"),
        "ar_wire_scan": lambda x, a: ring_all_reduce(
            x, a["r"], grad_books, chunk=RING_CHUNK, decode_backend="scan"),
        "rs_wire_multisym": lambda x, a: ring_reduce_scatter(
            x, a["r"], grad_books, chunk=RING_CHUNK),
        "hier_2x2": lambda x, a: hierarchical_all_reduce(
            x.reshape(2, 2, -1), (a["inner"], a["outer"]), grad_books,
            chunk=RING_CHUNK),
        "ring_ag": lambda x, a: ring_all_gather(x, a["r"], books,
                                                chunk=RING_CHUNK),
        "chunked_ag": lambda x, a: TRANSPORTS["chunked"].all_gather(
            x, a["r"], books, chunk=RING_CHUNK),
        "mono_ag": lambda x, a: TRANSPORTS["monolithic"].all_gather(
            x, a["r"], books),
        "ring_a2a": lambda x, a: ring_all_to_all(x, a["r"], hid_books,
                                                 chunk=RING_CHUNK),
        "ar_e4m3_wire": lambda x, a: ring_all_reduce(
            x, a["r"], e4m3_books, "e4m3", chunk=RING_CHUNK),
    }
    # e4m3 payloads whose ring sums pass 448 (XLA's overflow to NaN)
    g.manual_seed(SEED + 3)
    e4m3 = (torch.randn((n, E4M3_SIZE), generator=g, device=dev)
            * 150).to(torch.float8_e4m3fn)
    e4m3_books = {p: build_codebook(histogram_np(torch, s), codec="huffman")
                  for p, s in SCHEMES["e4m3"].to_symbols(e4m3).items()}
    inputs = {"ring_ag": shards, "chunked_ag": shards, "mono_ag": shards,
              "ring_a2a": hidden, "ar_e4m3_wire": e4m3}
    compared = {}
    for name, fn in cases.items():
        x = inputs.get(name, small)
        sizes = ({"outer": 2, "inner": 2} if name.startswith("hier")
                 else {"r": n})
        gy, moved = held_to_plain(torch, LoopbackAxis, name, fn, x, sizes)
        compared[name] = {"tensors_moved": moved,
                          "symbols_a_rank": x[0].numel()}
        if gy.dtype == torch.float8_e4m3fn:
            nans = int(torch.isnan(gy.float()).sum())
            need(nans > 0, f"{name}: no sum passed 448 (no NaN)")
            compared[name]["nan_results"] = nans
    rec["kernels_vs_plain"] = compared
    print(f"kernels vs plain at the logits size: {len(compared)} ops, every "
          f"hop's words, stats and results equal ("
          f"{time.perf_counter() - t0:.1f} s)")

    # ---- B3, B4, B6 walk a monolithic stream: chunk = 1 024 000
    mono = {}
    for p, sym in SCHEMES["bf16"].to_symbols(step_logits).items():
        for codec in ("huffman", "qlc"):
            b = build_codebook(histogram_np(torch, sym), codec=codec)
            w, _ = encode_jit(sym, b.codes, b.lengths)
            t = b.tables if codec == "huffman" else None
            fns = ({"B4 multisym": lambda: b_decode(b, w, sym),
                    "B3 canonical": lambda: decode_jit(
                        w, t.first_code, t.base_index, t.num_codes,
                        t.sorted_symbols, sym.numel())}
                   if codec == "huffman" else
                   {"B6 qlc": lambda: b_decode(b, w, sym)})
            for k, fn in fns.items():
                got, ms = timed_once(torch, fn)
                if p == "hi":
                    plain = (b_decode(b, w.cpu(), sym) if "B3" not in k else
                             decode_jit(w.cpu(), t.first_code, t.base_index,
                                        t.num_codes, t.sorted_symbols,
                                        sym.numel()))
                    need(torch.equal(got.cpu().to(torch.uint8),
                                     plain.to(torch.uint8)),
                         f"monolithic {k}: kernel != plain")
                need(torch.equal(got.to(torch.uint8), sym),
                     f"monolithic {k}: does not round-trip the {p} plane")
                mono[f"{k} {p}"] = ms
    rec["monolithic_decode_ms"] = mono
    print("monolithic decode, one chunk of 1 024 000 symbols: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in mono.items()) + f" [{card}]")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


# ------------------------------------------------------ train phase
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_EXTRA = 4, 128, 8, 4
TRAIN_LR, TRAIN_REFRESH = 1e-3, 2


def steps_profile(torch, fn, steps: int):
    """Device time of ``steps`` calls of ``fn`` (each one step, ending in
    the step's own host sync) under torch.profiler, which records the
    device's events alone: busy ms a step from the device events, the
    idle share of the steps' wall time, the port's kernels' ms a step
    and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        out = [fn() for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {k: us for k, (us, _) in device_kernel_us(p).items()}
    busy_ms = sum(kern.values()) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    short = {}
    for k, v in kern.items():                   # names cut to 80 chars
        short[k[:80]] = short.get(k[:80], 0.0) + v / 1e3 / steps
    port = {k.split("::")[1].split("(")[0]: v / 1e3 / steps
            for k, v in kern.items() if k.startswith("(anonymous namespace)")}
    return out, {"steps": steps, "wall_ms_per_step": wall_ms,
                 "device_busy_ms_per_step": busy_ms,
                 "idle_share": 1.0 - busy_ms / wall_ms,
                 "port_kernels_ms_per_step": port,
                 "top_kernels_ms_per_step": dict(sorted(
                     short.items(), key=lambda kv: -kv[1])[:10])}


FLIP_MEMORY_SHARE = 0.01      # of the card's memory, past flip 1's reading


def memory_after_flips(torch, readings, what: str, card) -> dict:
    """The allocator's (allocated, reserved) bytes after each epoch flip,
    printed; allocated after flip k may pass flip 1's by at most
    ``FLIP_MEMORY_SHARE`` of the card's memory (a superseded step's
    graph, buffers and pool must go)."""
    total = torch.cuda.get_device_properties(0).total_memory
    need(len(readings) >= 2, f"{what}: {len(readings)} epoch flips, the "
         f"memory check needs two")
    first = readings[0][0]
    print(f"{what}: after each epoch flip allocated "
          f"{[round(a / 1e9, 3) for a, _ in readings]} GB, reserved "
          f"{[round(r / 1e9, 3) for _, r in readings]} GB [{card}]")
    worst = max(a - first for a, _ in readings[1:])
    need(worst <= FLIP_MEMORY_SHARE * total, f"{what}: allocated memory "
         f"grew {worst / 1e9:.3f} GB past flip 1's over the epoch flips "
         f"(limit {FLIP_MEMORY_SHARE * total / 1e9:.3f} GB)")
    return {"allocated_bytes": [a for a, _ in readings],
            "reserved_bytes": [r for _, r in readings],
            "growth_past_flip_1_bytes": worst, "card_bytes": total}


def grads_held_to_plain(torch, dev, grads, spec, what: str) -> dict:
    """B5 on both bf16 planes of every gradient leaf against the plain
    histogram, and the gradient probe's coded bits against hist .
    lengths in int64 (launches uncounted: a check, not the path).
    Returns the probe's stats under ``spec``."""
    from repro_torch.comm.compression import histogram256
    from repro_torch.core.symbols import bf16_planes
    from repro_torch.kernels.histogram import histogram256_plain
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.step import grad_payload_stats
    total = {p: torch.zeros(256, dtype=torch.int64, device=dev)
             for p in ("lo", "hi")}
    for leaf in tree_leaves(grads):
        for p, sym in bf16_planes(leaf).items():
            h = histogram256(sym)
            need(torch.equal(h, histogram256_plain(sym)),
                 f"{what}: B5 != plain on a {tuple(leaf.shape)} gradient "
                 f"leaf's {p} plane")
            total[p] += h
    coded = sum(int((total[p] * torch.from_numpy(spec.lengths_for(p))
                     .to(dev, torch.int64)).sum()) for p in total)
    probe = grad_payload_stats(grads, spec)
    need(all(torch.equal(probe[f"hist_{p}"], total[p]) for p in total)
         and float(probe["coded_bits"]) == float(coded),
         f"{what}: grad_coded_bits {float(probe['coded_bits'])} != "
         f"hist . lengths {coded}")
    return probe


def train_phase(torch, dev, params, cfg, card, build, *, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, refresh=TRAIN_REFRESH, grad_accum=1):
    """Phases 7 and 14: ``cfg`` (gemma2-2b, hubert-xlarge) trained at full
    width on the card through ``launch.train.train`` (see the module
    docstring), ``batch`` x ``seq``, a refresh check every ``refresh``
    steps.  The reduced step, card vs CPU, is held in bf16.  Returns the record and the main path's launch counts."""
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.train import train
    from repro_torch.models import param_count
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train.step import (grad_payload_stats, loss_and_grads,
                                        make_train_step)

    t_phase = time.perf_counter()
    n_params = param_count(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    run = train(cfg, steps=TRAIN_STEPS, batch_size=batch, seq_len=seq,
                lr=TRAIN_LR, grad_accum=grad_accum, compress=True,
                refresh_every=refresh, seed=SEED, device=dev, params=params)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    mgr, steps, refreshes = run["lifecycle"], run["steps"], run["refreshes"]
    print(f"{cfg.name} train main path: {run['seconds']:.1f} s, launches "
          f"{launches} [{card}]")

    need(all(math.isfinite(s["loss"]) for s in steps),
         f"train: a loss is not finite: {[s['loss'] for s in steps]}")
    need(all(s["grad_raw_bits"] == 16.0 * n_params for s in steps),
         f"train: grad_raw_bits != 16 x {n_params} params")
    epochs = [s["book_epoch"] for s in steps]
    need(epochs[0] == 2.0 and refreshes and max(epochs) > 2.0,
         f"train: the bootstrap books never went stale (epochs {epochs}, "
         f"refreshes {refreshes})")
    built = set(epochs) | {float(mgr.book_epoch)}
    need(mgr.n_recompiles == len(built), f"train: {mgr.n_recompiles} step "
         f"builds for the epochs {sorted(built)}")
    need(launches["histogram256"] > 0, "train: kernel B5 was not launched")
    flip_memory = memory_after_flips(
        torch, [(r["memory_allocated"], r["memory_reserved"])
                for r in refreshes], f"{cfg.name} train", card)

    # ---- the repeated batch: 4 extra steps at a constant lr (in the
    # run's microbatches), the 2nd and 3rd under the profiler, the host
    # syncs of the 4th counted; the loss must fall.  The lr is a tenth of the run's peak: a constant
    # 1e-3 overshoots on one batch at this width (7.75, 11.76, 11.94,
    # 10.22 in a first run on the card)
    state = run["state"]
    spec_new = mgr.spec("grad", "bf16")
    data = {k: torch.from_numpy(v).to(dev) for k, v in next(SyntheticDataset(
        cfg, DataConfig(batch, seq, seed=SEED + 1))).items()}
    _, _, grads = loss_and_grads(state.params, data, cfg)

    # ---- every leaf's B5 histograms against the plain histogram, and
    # the probe's coded bits against hist . lengths in int64
    probe_new = grads_held_to_plain(torch, dev, grads, spec_new,
                                    f"{cfg.name} train")
    probe_boot = grad_payload_stats(grads, run["spec"])
    raw = float(probe_new["raw_bits"])
    ratio_boot = float(probe_boot["coded_bits"]) / raw
    ratio_new = float(probe_new["coded_bits"]) / raw
    need(ratio_new < ratio_boot, f"train: the refreshed books (epoch "
         f"{mgr.book_epoch}) code the gradients at {ratio_new} of raw, "
         f"the bootstrap books at {ratio_boot}")
    del grads, probe_new, probe_boot

    extra = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR / 10),
                            grad_accum=grad_accum, comp_spec=spec_new)
    box = {"state": state}

    def one():
        box["state"], m = extra(box["state"], data)
        return float(m["loss"])

    losses = [one()]
    more, prof = steps_profile(torch, one, TRAIN_EXTRA - 2)
    losses += more
    torch.cuda.synchronize()        # the last: its host syncs counted
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            box["state"], m = extra(box["state"], data)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing" in str(w.message)]
    step_syncs = len(syncs)
    losses.append(float(m["loss"]))
    # the step's parts on the last state, each under the profiler (2
    # calls): forward + backward, the probe, the optimizer (lr 0).  The
    # update consumes its state (it moves the moments in place): it runs
    # on the last state, which nothing reads after this; cloned moments
    # would add 20 GB at this width
    st = box["state"]
    g = loss_and_grads(st.params, data, cfg, grad_accum)[2]
    parts = {
        "forward_backward": steps_profile(torch, lambda: loss_and_grads(
            st.params, data, cfg, grad_accum)[0], 2)[1],
        "grad_probe": steps_profile(torch, lambda: grad_payload_stats(
            g, spec_new)["coded_bits"], 2)[1],
        "adamw": steps_profile(torch, lambda: adamw_update(
            g, st.opt, st.params, AdamWConfig(lr=0.0))[2]["lr"], 2)[1]}
    del g, st
    need(losses[-1] < losses[0] and all(map(math.isfinite, losses)),
         f"train: the loss on a repeated batch did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del box, state, run, extra
    torch.cuda.empty_cache()

    # ---- the reduced config: one step on the card and one on the CPU's
    # plain path from the same params and batch, within STEP_TOL
    reduced = reduced_step_card_vs_cpu(torch, dev, cfg.reduced(),
                                       f"{cfg.name} train", card)

    secs = sorted(s["step_seconds"] for s in steps)
    med = secs[len(secs) // 2]
    b5_ms = sum(v for k, v in prof["port_kernels_ms_per_step"].items()
                if "hist" in k)
    rec = {
        "model": cfg.name, "params": n_params, "batch": batch,
        "seq_len": seq, "grad_accum": grad_accum, "steps": TRAIN_STEPS,
        "refresh_every": refresh, "lr": TRAIN_LR,
        "losses": [s["loss"] for s in steps],
        "book_epochs": epochs, "refreshed_epoch": mgr.book_epoch,
        "refreshes": refreshes, "memory_after_flips": flip_memory,
        "n_recompiles": mgr.n_recompiles,
        "step_ms_median": med * 1e3, "step_ms_all": [s * 1e3 for s in secs],
        "tokens_per_s": batch * seq / med,
        "profile": prof, "parts": parts, "host_syncs_a_step": step_syncs,
        "host_sync_sites": syncs,
        "b5_device_ms_per_step": b5_ms,
        "b5_share_of_device": b5_ms / prof["device_busy_ms_per_step"],
        "grad_coded_over_raw_bootstrap": ratio_boot,
        "grad_coded_over_raw_refreshed": ratio_new,
        "repeated_batch_lr": TRAIN_LR / 10, "repeated_batch_losses": losses,
        "peak_memory_gb": peak_gb,
        "reduced_card_vs_cpu": reduced,
        "seconds": time.perf_counter() - t_phase,
    }
    return rec, launches


# -------------------------------------------------- lifecycle phase
LIFE_NEW, LIFE_REFRESH = 16, 4


def lifecycle_phase(torch, dev, params, cfg, books, prompts, card, build):
    """Phase 8: ``launch.dryrun.drift_check`` at 8 ranks on the card and
    the wire serve with book hot-refresh (see the module docstring).
    Returns the record and the path's launch counts."""
    from repro_torch.launch.dryrun import drift_check
    from repro_torch.lifecycle import BookLifecycleManager, DriftThresholds
    from repro_torch.serve import Engine, ServeConfig

    t_phase = time.perf_counter()
    mgr = BookLifecycleManager(thresholds=DriftThresholds(
        kl_bits=0.0, excess_bits=0.0, min_symbols=1, patience=1))
    for p, b in books.items():                  # the wire serve's books
        mgr.install(("act", "bf16", p), b.source_counts)
    spec = mgr.spec("act", "bf16", mode="bitexact", transport="chunked",
                    chunk=CHUNK, decode_backend="multisym")
    sc = ServeConfig(max_cache_len=PROMPT + LIFE_NEW)
    # ---- the path: launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    drift = drift_check(n=8, device=dev)
    eng = Engine(params, cfg, sc, spec, lifecycle=mgr,
                 refresh_every=LIFE_REFRESH, device=dev)
    flips, refresh = [], eng._maybe_refresh

    def read_after_flip():                      # instrumentation only
        flipped = refresh()
        if flipped:
            flips.append((torch.cuda.memory_allocated(dev),
                          torch.cuda.memory_reserved(dev)))
        return flipped

    eng._maybe_refresh = read_after_flip
    t0 = time.perf_counter()
    toks, totals = eng.generate(prompts, LIFE_NEW)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"lifecycle path: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches} [{card}]")

    need(drift["status"] == "ok" and all(
        v for v in drift.values() if isinstance(v, bool)),
        f"drift_check on the card: {drift}")
    need(totals["book_refreshes"] >= 1, f"hot refresh: no refresh in "
         f"{LIFE_NEW} tokens ({totals})")
    need(totals["act_decode_mismatch"] == 0.0,
         f"hot refresh: {totals['act_decode_mismatch']} mismatches")
    steps = eng.step_metrics
    for i, m in enumerate(steps):               # the books of its epoch
        in_force = eng.epoch_specs[int(m["book_epoch"])]
        want = sum(int((m[f"act_hist_{p}"].astype("int64")
                        * in_force.lengths_for(p)).sum())
                   for p in ("lo", "hi"))
        need(m["act_decoded_bits"] == m["act_coded_bits"] == float(want),
             f"hot refresh step {i} (epoch {m['book_epoch']}): B2 bits "
             f"{m['act_decoded_bits']} != B5 . lengths {want}")
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym"):
        need(launches[k] > 0, f"lifecycle: kernel {k} was not launched")
    flip_memory = memory_after_flips(torch, flips, "hot-refresh serve", card)
    plain = Engine(params, cfg, sc, spec, device=dev)
    toks_plain, _ = plain.generate(prompts, LIFE_NEW)
    need((toks == toks_plain).all(), "hot refresh: the tokens differ from "
         "the engine's without lifecycle=")
    epochs = [m["book_epoch"] for m in steps]
    rec = {"drift_check": drift, "new_tokens": LIFE_NEW,
           "refresh_every": LIFE_REFRESH,
           "book_refreshes": totals["book_refreshes"],
           "memory_after_flips": flip_memory,
           "book_epochs": epochs, "n_recompiles": mgr.n_recompiles,
           "coded_over_raw_by_step": [m["act_coded_bits"]
                                      / m["act_raw_bits"] for m in steps],
           "generate_s": wall,
           "step_ms_median": sorted(m["step_seconds"] for m in steps)[
               len(steps) // 2] * 1e3,
           "seconds": time.perf_counter() - t_phase}
    print(f"hot refresh: {totals['book_refreshes']:g} refreshes, epochs "
          f"{epochs}, tokens = plain engine's, every step lossless "
          f"[{card}]")
    return rec, launches


# -------------------------------------------------------------- MoE phase
MOE_ARCH, MOE_LAYERS, MOE_EP = "llama4-scout-17b-a16e", 4, 4
MOE_NEW = 16
A2A_BATCH, A2A_SEQ = 8, 512
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 128
# decode-step logits vs the full-sequence forward (bf16, full width):
# attention over the cache and over the sequence add in other orders
DECODE_TOL = 5e-2


class Recorder:
    """Records what the MoE path's instrumented functions see: the wire's
    (send, recv, stats) per all-to-all, each MoE layer's prefill input,
    and each decode call's (input, counts before the step, pos).  A context manager: it patches
    ``models.moe._a2a_wire`` and ``models.blocks.moe_prefill`` /
    ``moe_decode`` on entry and restores them on exit."""

    def __init__(self):
        self.wire, self.prefill, self.decode = [], [], []

    def __enter__(self):
        from repro_torch.models import blocks, moe
        self._saved = (moe._a2a_wire, blocks.moe_prefill, blocks.moe_decode)
        wire0, pre0, dec0 = self._saved

        def wire(send, *a):
            recv, st = wire0(send, *a)
            self.wire.append((send.detach(), recv.detach(), st))
            return recv, st

        def pre(params, x, cfg):
            self.prefill.append(x.detach())
            return pre0(params, x, cfg)

        def dec(params, x, counts, pos, cfg):
            # pos is a 0-d device tensor: the taped replays are eager
            self.decode.append((x.detach(), counts.clone(), int(pos)))
            return dec0(params, x, counts, pos, cfg)

        moe._a2a_wire, blocks.moe_prefill, blocks.moe_decode = wire, pre, dec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks, moe
        moe._a2a_wire, blocks.moe_prefill, blocks.moe_decode = self._saved
        return False


def port_kernel_ms(torch, fn, reps: int) -> dict:
    """Device ms a call of ``fn``: each of the port's kernels (B1-B8) and
    the rest of its device operations, from the profiler's events."""
    out, other = {}, 0.0
    for k, (us, _) in device_events(torch, fn, reps).items():
        if k.startswith("(anonymous namespace)"):
            name = k.split("::")[1].split("(")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
        else:
            other += us / 1e3 / reps
    out["other"] = other
    return out


def shipped_bits(torch, send, books, t: int) -> float:
    """A plain histogram (``torch.bincount``, not B5) . lengths of what
    round t of a loopback all-to-all ships (rank i sends its shard
    (i + t) % n), over the ranks, divided by n: the ring's replicated
    ``hop_coded_bits`` of that round."""
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    n = send.shape[0]
    bits = 0
    for i in range(n):
        shard = send[i, (i + t) % n]
        for p, sym in SCHEMES["bf16"].to_symbols(shard).items():
            hist = torch.bincount(sym.reshape(-1).long(), minlength=256)
            bits += books[p].encoded_bits(hist.cpu().numpy())
    return bits / n


def check_wire_calls(torch, calls, books, what: str) -> list:
    """Every recorded all-to-all of a loopback MoE: the decoded receive
    buffers are the uncoded permutation bit for bit, and each round's
    ``hop_coded_bits`` is ``shipped_bits`` of what it ships.  Returns each
    call's (coded, raw) wire bits."""
    out = []
    for c, (send, recv, st) in enumerate(calls):
        need(torch.equal(bits_of(torch, recv),
                         bits_of(torch, send.transpose(0, 1))),
             f"{what} all-to-all {c}: decoded != the uncoded permutation")
        hop = st["hop_coded_bits"][0].tolist()
        for t in range(1, send.shape[0]):
            want = shipped_bits(torch, send, books, t)
            need(hop[t - 1] == want, f"{what} all-to-all {c} round {t}: "
                 f"hop_coded_bits {hop[t - 1]} != histogram . lengths "
                 f"{want}")
        out.append((float(st["coded_wire_bits"].sum()),
                    float(st["raw_wire_bits"].sum())))
    return out


def moe_decode_checks(torch, cfg, layers, r_dec, r_full, n_seq: int):
    """Decode against one prefill of the whole sequence, for each MoE
    layer ``(name, ffn params, the decode's counts, the full prefill's
    counts)`` in the order a step runs them; ``r_dec`` recorded the
    replay (a prefill of the prompts, then one decode call a layer a
    step), ``r_full`` the full prefill.  Checked: the decode's counts
    (routed totals, kept and dropped) equal ``moe_prefill``'s on the
    decode's own inputs; each decode step keeps exactly the slots that
    ``_dispatch`` of the forward keeps on those inputs; the full
    sequence's counts differ from the decode's by exactly the routing
    flips' one-hots.  Returns (flipped (B, n_seq), flips, dropped slots,
    routed slots, slots the decode steps dropped)."""
    from repro_torch.models import moe

    e = cfg.n_experts
    cap = moe.moe_stream_capacity_host(n_seq, cfg)
    flipped = torch.zeros((BATCH, n_seq), dtype=torch.bool,
                          device=r_full.prefill[0].device)
    n_flips, dropped, slots, dec_dropped = 0, 0, 0, 0
    n_moe = len(layers)
    for layer, (name, lp, counts_dec, counts_full) in enumerate(layers):
        steps_in = [r_dec.decode[s * n_moe + layer]
                    for s in range(n_seq - PROMPT)]
        x_dec = torch.cat([r_dec.prefill[layer]]
                          + [x for x, _, _ in steps_in], dim=1)
        x_full = r_full.prefill[layer]
        # the decode's routed totals (kept and dropped) are the forward's
        # on the decode's own inputs
        _, _, c_same = moe.moe_prefill(lp, x_dec, cfg)
        need(torch.equal(c_same, counts_dec), f"{name}: the decode's "
             f"counts != moe_prefill's on the decode's inputs")
        # the decode keeps a slot iff the forward's dispatch does: its
        # counts before the step against the capacity at pos + 1, and
        # the slots that _dispatch on the same inputs sends to the buffer
        ti_d = moe._route(lp, x_dec.reshape(-1, cfg.d_model), cfg)[1]
        _, slot_d, _ = moe._dispatch(x_dec, ti_d.reshape(BATCH, n_seq, -1),
                                     cfg, cap)
        kept_fwd = (slot_d != BATCH * e * cap).reshape(
            BATCH, n_seq, -1)[:, PROMPT:]
        kept_dec = torch.stack([
            before.gather(1, moe._route_probs(
                lp, x.reshape(BATCH, cfg.d_model), cfg)[1])
            < moe.moe_stream_capacity_host(pos + 1, cfg)
            for x, before, pos in steps_in], dim=1)
        need(torch.equal(kept_dec, kept_fwd), f"{name}: the decode's "
             f"kept slots != the forward dispatch's")
        dec_dropped += int((~kept_dec).sum())
        # against the fresh full-sequence prefill: any difference is a
        # token whose hidden state took another expert (a routing flip)
        ti_f = moe._route(lp, x_full.reshape(-1, cfg.d_model), cfg)[1]
        flip = (ti_d != ti_f).any(-1).reshape(BATCH, n_seq)

        def oh(ti):
            return torch.nn.functional.one_hot(ti, e).sum(1).reshape(
                BATCH, n_seq, e)

        delta = ((oh(ti_f) - oh(ti_d)) * flip[..., None]).sum(1)
        need(torch.equal((counts_full - counts_dec).to(delta.dtype), delta),
             f"{name}: full-sequence counts - decode counts != the "
             f"routing flips' difference")
        flipped |= flip
        n_flips += int(flip.sum())
        _, slot, _ = moe._dispatch(x_full, ti_f.reshape(BATCH, n_seq, -1),
                                   cfg, cap)
        dropped += int((slot == BATCH * e * cap).sum())
        slots += slot.numel()
    return flipped, n_flips, dropped, slots, dec_dropped


def moe_phase(torch, dev, card, build):
    """Phase 9: ``llama4-scout-17b-a16e`` at full width, 4 of its 48
    layers (see the module docstring).  Returns the record and the
    path's launch counts."""
    from dataclasses import replace

    from repro_torch.comm import LoopbackAxis, loopback_mesh, ring_all_to_all
    from repro_torch.comm.compression import CompressionSpec, histogram256
    from repro_torch.comm.transport import moe_dispatch_raw_bits, wire_factor
    from repro_torch.configs import get_config
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models import (BlockGroup, decode_step, model_init,
                                    param_count, prefill)
    from repro_torch.models import moe
    from repro_torch.models.common import tree_index, tree_leaves
    from repro_torch.models.layers import (attn_apply, embed_apply,
                                           rmsnorm_apply)
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import make_activation_probe
    from repro_torch.train.step import STEP_TOL, loss_and_grads

    t_phase = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = replace(full, blocks=(BlockGroup(("attn_moe",), MOE_LAYERS),))
    cut = (f"{MOE_ARCH} at full width, depth cut to {MOE_LAYERS} of "
           f"{full.n_layers} layers")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
    n_params = param_count(params)
    gb = sum(a.numel() * a.element_size() for a in tree_leaves(params)) / 1e9
    print(f"{cut}: {n_params / 1e9:.4f} B parameters, {gb:.2f} GB "
          f"[{card}]")
    rec = {"model": MOE_ARCH, "layers": MOE_LAYERS,
           "layers_full": full.n_layers, "cut": cut, "params": n_params,
           "param_gb": gb, "card": card}

    # ---- books for the serve wire: a warm-up prefill's logits (B5)
    warm = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    with torch.no_grad():
        wl, _ = prefill(params, {"tokens": warm}, cfg, PROMPT + MOE_NEW)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(
                 wl[:, -1].to(torch.bfloat16)).items()}
    del wl
    spec = CompressionSpec.from_books(books, "bf16", tensor_kind="act",
                                      mode="bitexact", transport="chunked",
                                      chunk=CHUNK, decode_backend="multisym")
    sc = ServeConfig(max_cache_len=PROMPT + MOE_NEW)
    mesh = loopback_mesh({"model": MOE_EP})
    # forward + backward compare one function on both paths: with the
    # aux loss on, the a2a path's is the mean of per-rank losses (held
    # on the CPU: tests/test_torch_moe.py)
    quiet = replace(cfg, router_aux_weight=0.0)
    a2a_cfg = replace(quiet, moe_impl="a2a")
    p0 = tree_index(params["groups"][0][0], 0)
    tok = torch.randint(0, cfg.vocab_size, (A2A_BATCH, A2A_SEQ),
                        generator=gen, device=dev)
    with torch.no_grad():                   # layer 0's MoE input, 8 x 512
        h = embed_apply(params["embed"], tok, cfg)
        h = h + attn_apply(p0["mixer"], rmsnorm_apply(
            p0["norm_mix"], h, cfg.norm_eps), cfg)
        hid = rmsnorm_apply(p0["norm_ffn"], h, cfg.norm_eps)
    del h
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        SyntheticDataset(cfg, DataConfig(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                                         seed=SEED))).items()}
    saved_wire = dict(moe._A2A_WIRE)
    moe._A2A_WIRE["books"] = None           # the bootstrap books
    boot = moe._a2a_wire_books("bf16")

    # ---- the path: serve through the wire (ep_degree 4 accounting), one
    # compressed dispatch of a full-width layer, forward + backward
    # through the wire; launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    eng = Engine(params, cfg, sc, spec, ep_degree=MOE_EP, device=dev)
    t0 = time.perf_counter()
    toks, totals = eng.generate(prompts, MOE_NEW)
    serve_s = time.perf_counter() - t0
    serve_launches = dict(build.LAUNCHES)
    with Recorder() as r_call, torch.no_grad(), moe.use_mesh(mesh):
        before = dict(build.LAUNCHES)
        y_a2a, _, coded_a2a = moe.moe_apply_a2a_block(p0["ffn"], hid, cfg)
        torch.cuda.synchronize()
        call_launches = {k: build.LAUNCHES[k] - before[k]
                         for k in build.LAUNCHES}
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as r_train, moe.use_mesh(mesh):
        t0 = time.perf_counter()
        loss, (_, _, wire_bits), grads = loss_and_grads(params, tbatch,
                                                        a2a_cfg)
        torch.cuda.synchronize()
        fb_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    fb_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"moe path: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{launches} [{card}]")
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym"):
        need(launches[k] > 0, f"moe: kernel {k} was not launched")

    # ---- serve: lossless, B2 = B5 . lengths, the plain engine's tokens,
    # the analytic dispatch wire
    steps = eng.step_metrics
    need(totals["act_decode_mismatch"] == 0.0,
         f"moe serve: {totals['act_decode_mismatch']} mismatches")
    for i, m in enumerate(steps):
        need(m["act_decoded_bits"] == m["act_coded_bits"] > 0,
             f"moe serve step {i}: B2 bits {m['act_decoded_bits']} != "
             f"histogram . lengths {m['act_coded_bits']}")
    per_step = wire_factor("all_to_all", MOE_EP) * moe_dispatch_raw_bits(
        BATCH, cfg.experts_per_token, cfg.d_model, 16, MOE_LAYERS)
    need(totals["moe_wire_raw_bits"] == per_step * (MOE_NEW - 1),
         f"moe serve: moe_wire_raw_bits {totals['moe_wire_raw_bits']} != "
         f"{per_step} x {MOE_NEW - 1}")
    plain = Engine(params, cfg, sc, device=dev)
    toks_plain, _ = plain.generate(prompts, MOE_NEW)
    need((toks == toks_plain).all(), "moe serve: the tokens differ from "
         "the engine's without books")
    need(serve_launches["decode_chunks_multisym"] > 0,
         "moe serve: B4 was not launched")
    bare = sorted(m["step_seconds"] for m in plain.step_metrics)
    step_s = sorted(m["step_seconds"] for m in steps)
    serve = {"new_tokens": MOE_NEW, "ep_degree": MOE_EP,
             "decode_step_ms_median": step_s[len(step_s) // 2] * 1e3,
             "decode_step_ms_median_no_wire": bare[len(bare) // 2] * 1e3,
             "generate_s": serve_s,
             "coded_over_raw": totals["act_coded_bits"]
             / totals["act_raw_bits"],
             "moe_wire_raw_bits_per_step": per_step,
             "launches": serve_launches}
    # phase 18 (its generate replaces the engine's step metrics, read above)
    captured_check(torch, eng, prompts, "llama4-scout-17b-a16e", card, build,
                   ("encode_lookup", "pack_blocks", "histogram256",
                    "decode_chunks_multisym"))
    captured_prefill_check(torch, eng, prompts, "llama4-scout-17b-a16e",
                           card)                # phase 20

    # ---- decode against prefill: replay the engine's steps, then one
    # prefill of the whole sequence; each MoE layer's inputs recorded
    seq = torch.cat([prompts, torch.from_numpy(toks).to(dev)], dim=1)
    n_seq = PROMPT + MOE_NEW - 1
    with Recorder() as r_dec, torch.no_grad():
        _, caches = prefill(params, {"tokens": prompts}, cfg,
                            PROMPT + MOE_NEW)
        outs = []
        for t in range(PROMPT, n_seq):
            lg, caches = decode_step(params, seq[:, t:t + 1], caches, t, cfg)
            outs.append(lg[:, 0].float())
    with Recorder() as r_full, torch.no_grad():
        lg_full, full_caches = prefill(params, {"tokens": seq[:, :n_seq]},
                                       cfg, PROMPT + MOE_NEW)
    dec_logits = torch.stack(outs, dim=1)
    full_logits = lg_full[:, PROMPT:n_seq].float()
    flipped, n_flips, dropped, slots, dec_dropped = moe_decode_checks(
        torch, cfg, [(f"moe layer {layer}",
                      tree_index(params["groups"][0][0], layer)["ffn"],
                      caches[0][0]["moe_counts"][layer],
                      full_caches[0][0]["moe_counts"][layer])
                     for layer in range(MOE_LAYERS)], r_dec, r_full, n_seq)
    err = ((dec_logits - full_logits).abs().amax(-1)
           / full_logits.abs().amax(-1))           # (B, steps)
    # a flip changes its token's later layers and, through their keys and
    # values, every later token: the tokens before a sequence's first
    # flip are the ones the two paths compute alike
    clean = torch.cumsum(flipped.to(torch.int32), dim=1)[:, PROMPT:n_seq] == 0
    need(int(clean.sum()) >= clean.numel() // 2, f"moe decode vs full "
         f"forward: {int(clean.sum())} of {clean.numel()} tokens before a "
         f"routing flip, fewer than half")
    worst = float(err[clean].max())
    need(bool(torch.isfinite(dec_logits).all()) and worst < DECODE_TOL,
         f"moe decode vs full forward: rel err {worst} (tokens before a "
         f"routing flip)")
    # a decode step's device time, the model's and the wire probe's (the
    # counts are read above: the repeated step only rewrites its slot)
    probe = make_activation_probe(spec)
    last = seq[:, n_seq - 1:n_seq]
    with torch.no_grad():
        step_dev, step_ops = device_ms(torch, lambda: decode_step(
            params, last, caches, n_seq - 1, cfg)[0], 3)
        probe_dev, probe_ops = device_ms(
            torch, lambda: probe(lg), 3)
    table = params["embed"]["table"]          # a step reads B rows of it
    read_gb = gb - table.numel() * table.element_size() / 1e9
    serve.update(decode_step_device_ms=step_dev,
                 decode_step_weight_gb=read_gb,
                 decode_step_device_ops=step_ops,
                 wire_probe_device_ms=probe_dev,
                 wire_probe_device_ops=probe_ops)
    serve.update(decode_vs_forward_rel_err=worst,
                 decode_vs_forward_rel_err_all=float(err.max()),
                 decode_tokens_checked=int(clean.sum()),
                 routing_flips=n_flips, tokens_with_a_flip=int(
                     flipped.sum()), dropped_slots=dropped,
                 decode_dropped_slots=dec_dropped,
                 routed_slots=slots, counts_equal=n_flips == 0)
    print(f"moe serve: decode step {serve['decode_step_ms_median']:.3f} ms "
          f"median ({serve['decode_step_ms_median_no_wire']:.3f} ms without "
          f"the wire), coded/raw {serve['coded_over_raw']:.4f}, "
          f"moe_wire_raw_bits {per_step:.0f} a step; decode vs forward rel "
          f"err {worst:.3e} ({int(clean.sum())} of {clean.numel()} tokens "
          f"before a flip; all {float(err.max()):.3e}); routing flips "
          f"{n_flips}; dropped slots {dropped} of {slots} ({dec_dropped} "
          f"of them in the decode steps, as the forward drops them) "
          f"({cut}) [{card}]")
    print(f"moe serve: a decode step {step_dev:.3f} ms device "
          f"({step_ops:.0f} device ops), its wire probe {probe_dev:.3f} ms "
          f"({probe_ops:.0f}); weights a step reads {read_gb:.2f} GB, "
          f"{read_gb * 1e12 / HBM_BYTES_PER_S:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s [{card}]")
    rec["serve"] = serve
    del caches, full_caches, r_dec, r_full, lg_full, eng, plain

    # ---- the compressed dispatch of one full-width layer, 8 x 512
    y_sc, _ = moe.moe_apply(p0["ffn"], hid, cfg)
    exact = torch.equal(bits_of(torch, y_a2a), bits_of(torch, y_sc))
    diff = float((y_a2a.float() - y_sc.float()).abs().max()
                 / y_sc.float().abs().max())
    # the same rows reach each expert through the same call: bit for bit
    need(exact, f"moe a2a: y != moe_apply bit for bit (max rel {diff})")
    need(len(r_call.wire) == 2, f"moe a2a: {len(r_call.wire)} all-to-alls")
    wire_boot = check_wire_calls(torch, r_call.wire, boot, "moe a2a")
    rounds = MOE_EP - 1
    for k in ("decode_chunks_multisym", "encode_lookup", "pack_blocks"):
        need(call_launches[k] == 2 * 2 * rounds, f"moe a2a: "
             f"{call_launches[k]} {k} launches for 2 x {rounds} rounds "
             f"of 2 planes")
    need(float(coded_a2a) == sum(c for c, _ in wire_boot),
         f"moe a2a: the block's coded bits {float(coded_a2a)} != the "
         f"summed hop ledgers")
    send_d, recv_d, _ = r_call.wire[0]
    send_c, _, _ = r_call.wire[1]
    cap = moe.moe_stream_capacity_host(A2A_SEQ, cfg)
    need(send_d[0, 0].numel() == A2A_BATCH // MOE_EP * cfg.n_experts
         // MOE_EP * cap * cfg.d_model, f"moe a2a: shard {send_d.shape}")

    def call():
        with moe.use_mesh(mesh):
            return moe.moe_apply_a2a_block(p0["ffn"], hid, cfg)[2]

    weights = moe._expert_weights(p0["ffn"])
    e_loc = cfg.n_experts // MOE_EP
    hbuf = recv_d.reshape(MOE_EP, -1, e_loc, cap, cfg.d_model)
    ax = LoopbackAxis(MOE_EP)
    fns = {
        "a2a_block": call,
        "scatter": lambda: moe.moe_apply(p0["ffn"], hid, cfg)[0],
        "experts": lambda: [moe._experts(hbuf[i], weights[
            i * e_loc:(i + 1) * e_loc], cfg) for i in range(MOE_EP)],
        "dispatch_wire": lambda: ring_all_to_all(
            send_d, ax, boot, chunk=moe._A2A_WIRE["chunk"],
            decode_backend=moe._A2A_WIRE["decode_backend"]),
        "combine_wire": lambda: ring_all_to_all(
            send_c, ax, boot, chunk=moe._A2A_WIRE["chunk"],
            decode_backend=moe._A2A_WIRE["decode_backend"]),
    }
    with torch.no_grad():
        times = {}
        for k, fn in fns.items():
            r = {"ms": cuda_ms(torch, fn, 3)}
            r["device_ms"], r["device_ops"] = device_ms(torch, fn, 3)
            times[k] = r
        parts = {k: port_kernel_ms(torch, fns[k], 3)
                 for k in ("dispatch_wire", "combine_wire")}
        # books built by B5 from the first dispatch's own payload
        own = {p: build_codebook(histogram256(s).cpu().numpy(),
                                 key=("moe_dispatch", "bf16", p))
               for p, s in SCHEMES["bf16"].to_symbols(send_d).items()}
        moe.configure_a2a_wire(own)
        with Recorder() as r_own, moe.use_mesh(mesh):
            y_own, _, coded_own = moe.moe_apply_a2a_block(p0["ffn"], hid,
                                                          cfg)
        need(torch.equal(bits_of(torch, y_own), bits_of(torch, y_a2a)),
             "moe a2a: the result moved with the books")
        wire_own = check_wire_calls(torch, r_own.wire, own, "moe a2a "
                                    "(own books)")
        need(float(coded_own) == sum(c for c, _ in wire_own),
             f"moe a2a (own books): the block's coded bits "
             f"{float(coded_own)} != the summed hop ledgers")
        # the wire's kernels against their plain versions on the main
        # path's payloads and shapes (chunk 512, zero-filled capacity
        # rows), under both book sets
        t0 = time.perf_counter()
        vs_plain = {}
        for bname, bk in (("bootstrap", boot), ("own_books", own)):
            for wname, send in (("dispatch", send_d), ("combine", send_c)):
                _, moved = held_to_plain(
                    torch, LoopbackAxis, f"moe a2a {wname} ({bname})",
                    lambda x, a: ring_all_to_all(
                        x, a["r"], bk, chunk=moe._A2A_WIRE["chunk"],
                        decode_backend=moe._A2A_WIRE["decode_backend"]),
                    send, {"r": MOE_EP})
                vs_plain[f"{wname}_{bname}"] = moved
        vs_plain_s = time.perf_counter() - t0
        print(f"moe a2a wire vs plain (dispatch and combine, both book "
              f"sets, chunk {moe._A2A_WIRE['chunk']}): every hop's words "
              f"and bits, the stats and the results equal "
              f"({vs_plain_s:.1f} s)")
    moe._A2A_WIRE.clear()
    moe._A2A_WIRE.update(saved_wire)
    ratio = {f"{w}_{b}": c / r for b, calls in (("bootstrap", wire_boot),
                                               ("own_books", wire_own))
             for w, (c, r) in zip(("dispatch", "combine"), calls)}
    rec["a2a"] = {
        "batch": A2A_BATCH, "seq": A2A_SEQ, "ranks": MOE_EP,
        "capacity": cap, "shard_elements": send_d[0, 0].numel(),
        "chunk": moe._A2A_WIRE["chunk"], "y_bit_identical": exact,
        "y_rel_diff": diff, "launches": call_launches, "times": times,
        "wire_parts_ms_per_call": parts, "coded_over_raw": ratio,
        "kernels_vs_plain": {"tensors_moved": vs_plain,
                             "seconds": vs_plain_s},
        "hop_coded_bits": {
            "bootstrap": [c[2]["hop_coded_bits"][0].tolist()
                          for c in r_call.wire],
            "own_books": [c[2]["hop_coded_bits"][0].tolist()
                          for c in r_own.wire]}}
    print(f"moe a2a ({A2A_BATCH} x {A2A_SEQ}, {MOE_EP} ranks, capacity "
          f"{cap}, {send_d[0, 0].numel()} elements a shard a round): y "
          f"{'bit-identical to' if exact else f'rel {diff:.3e} from'} "
          f"moe_apply; coded/raw " + ", ".join(
              f"{k} {v:.4f}" for k, v in ratio.items()) + f" [{card}]")
    for k, r in times.items():
        print(f"  {k}: {r['ms']:.3f} ms (device {r['device_ms']:.3f} ms, "
              f"{r['device_ops']:.0f} device ops) [{card}]")
    for k, r in parts.items():
        print(f"  {k} device ms a call by kernel: " + ", ".join(
            f"{n} {v:.4f}" for n, v in r.items()) + f" [{card}]")
    del r_call, r_own, send_d, recv_d, send_c, hbuf, fns, y_own

    # ---- forward + backward through the wire against the scatter path
    need(len(r_train.wire) == 4 * MOE_LAYERS,     # forward + block remat
         f"moe train: {len(r_train.wire)} all-to-alls")
    ledger = sum(float(c[2]["hop_coded_bits"].sum()) for c in r_train.wire)
    need(float(wire_bits) > 0 and 2 * float(wire_bits) == ledger,
         f"moe train: moe_wire_coded_bits {float(wire_bits)} != the summed "
         f"hop ledgers {ledger / 2} (forward; the remat re-run again)")
    del r_train
    host = [g.cpu() for g in tree_leaves(grads)]  # 22 GB: held off the card
    del grads
    torch.cuda.empty_cache()
    loss_s, _, g_s = loss_and_grads(params, tbatch, quiet)
    loss_exact = torch.equal(loss, loss_s)
    loss_dev = abs(float(loss) - float(loss_s)) / abs(float(loss_s))
    need(loss_dev <= STEP_TOL["loss"], f"moe train: loss {float(loss)} vs "
         f"the scatter path's {float(loss_s)}")
    names = tree_leaves(tree_map_names(params))
    grad_dev, worst_leaf, exact_leaves = 0.0, "", 0
    for name, ga, gs in zip(names, host, tree_leaves(g_s)):
        ga = ga.to(dev)
        d = max_rel_diff(torch, ga, gs)
        exact_leaves += int(torch.equal(bits_of(torch, ga),
                                        bits_of(torch, gs)))
        if d >= grad_dev:
            grad_dev, worst_leaf = d, name
    need(grad_dev <= STEP_TOL["grads"], f"moe train: gradients {grad_dev} "
         f"of a leaf's max ({worst_leaf}) from the scatter path's")
    del host, g_s
    torch.cuda.empty_cache()
    with moe.use_mesh(mesh):
        fb_dev, fb_ops = device_ms(torch, lambda: loss_and_grads(
            params, tbatch, a2a_cfg)[0], 1)
    rec["train"] = {
        "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ,
        "router_aux_weight": 0.0, "loss": float(loss),
        "loss_scatter": float(loss_s), "loss_bit_identical": loss_exact,
        "loss_rel_dev": loss_dev, "grads_max_rel_dev": grad_dev,
        "grads_worst_leaf": worst_leaf,
        "leaves_bit_identical": exact_leaves, "leaves": len(names),
        "moe_wire_coded_bits": float(wire_bits),
        "forward_backward_s": fb_s, "device_ms": fb_dev,
        "device_ops": fb_ops, "peak_memory_gb": fb_peak}
    print(f"moe forward + backward through the wire ({MOE_TRAIN_BATCH} x "
          f"{MOE_TRAIN_SEQ}, aux weight 0, {cut}): loss {float(loss):.6f} "
          f"(scatter {float(loss_s):.6f}, "
          f"{'bit-identical' if loss_exact else f'rel {loss_dev:.3e}'}), "
          f"gradients within {grad_dev:.3e} of a leaf's max ({exact_leaves}"
          f" of {len(names)} leaves bit-identical), moe_wire_coded_bits "
          f"{float(wire_bits):.0f}; device {fb_dev:.2f} ms, peak memory "
          f"{fb_peak:.2f} GB [{card}]")
    del params, tbatch, hid, y_a2a, y_sc
    torch.cuda.empty_cache()

    # ---- the reduced config: one step on the card and one on the CPU
    rec["reduced_card_vs_cpu"] = reduced_step_card_vs_cpu(
        torch, dev, full.reduced(), "moe", card)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


# --------------------------------------------------------- DeepSeek phase
DS_ARCH, DS_EP, DS_NEW = "deepseek-v3-671b", 4, 16
ESHARD_MESH = {"data": 2, "model": 4}
# moe_apply_eshard on ESHARD_MESH against the same call at model 1: the
# same slots and expert products; the 4-way psum adds a token's partial
# outputs in bf16 in another order than one rank's 8-slot sum.  Each add
# rounds by half a bf16 ulp (2^-9) of its partial sum, so over 8 slots
# the two orders part by at most ~8 x 2^-9 of a token's largest partial
# sum: 2^-5 of the output's max |y|.
ESHARD_TOL = 2.0 ** -5


class MixerTap:
    """Records the output of every MLA mixer call, prefill and decode (a
    context manager: it patches ``models.blocks._MIXERS["mla"]`` on entry
    and restores it on exit)."""

    def __init__(self):
        self.prefill, self.decode = [], []

    def __enter__(self):
        from repro_torch.models import blocks
        self._saved = mixer = blocks._MIXERS["mla"]

        def pre(*a, **kw):
            y, cache = mixer.prefill(*a, **kw)
            self.prefill.append(y.detach())
            return y, cache

        def dec(*a, **kw):
            y, cache = mixer.decode(*a, **kw)
            self.decode.append(y.detach())
            return y, cache

        blocks._MIXERS["mla"] = mixer._replace(prefill=pre, decode=dec)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks._MIXERS["mla"] = self._saved
        return False


def token_rel_err(torch, got, want):
    """max |got - want| / max |want| of each token (the last dim)."""
    return ((got.float() - want.float()).abs().amax(-1)
            / want.float().abs().amax(-1))


def first_round_held(torch, send, books, chunk: int, backend: str) -> dict:
    """Round 1 of a loopback ``ring_all_to_all`` (rank i ships its shard
    (i + 1) % n) on the card and on CPU copies: each rank's B5
    histograms, B1 -> B2's words and bit counts, B4's decoded blocks.
    Fails unless all are equal bit for bit, the decoded symbols are the
    shard's and each rank's B2 bits are its B5 histogram . lengths.
    Returns the sizes held and the seconds taken."""
    from repro_torch.comm.compression import histogram256
    from repro_torch.comm.transport import (decode_blocks, encode_planes,
                                            planes_of)
    from repro_torch.core.encoder import chunk_counts_for

    n = send.shape[0]
    i = torch.arange(n, device=send.device)
    row = send[i, (i + 1) % n].reshape(n, -1)
    out = []
    t0 = time.perf_counter()
    for d in (send.device, torch.device("cpu")):
        r = row.to(d)
        sym = planes_of(r, "bf16", 1)
        hist = {p: torch.stack([histogram256(s) for s in v])
                for p, v in sym.items()}
        enc = encode_planes(r, books, "bf16", chunk=chunk, nl=1)
        counts = torch.from_numpy(chunk_counts_for(r.shape[-1], chunk)
                                  ).to(d).repeat(n)
        dec = {p: decode_blocks(w.reshape(-1, w.shape[-1]), counts,
                                books[p], chunk, backend)
               for p, (w, _, _) in enc.items()}
        out.append((sym, hist, {p: (w, b) for p, (w, b, _) in enc.items()},
                    dec))
    (_, gh, ge, gd), (sym, ch, ce, cd) = out
    for p in gh:
        need(torch.equal(gh[p].cpu(), ch[p]), f"round 1 plane {p}: B5 "
             f"histograms differ from the plain version's")
        need(all(torch.equal(a.cpu(), b) for a, b in zip(ge[p], ce[p])),
             f"round 1 plane {p}: B1 -> B2 words or bits differ from the "
             f"plain versions'")
        need(torch.equal(gd[p].cpu(), cd[p]), f"round 1 plane {p}: B4's "
             f"decoded blocks differ from the plain version's")
        need(torch.equal(cd[p].reshape(n, -1)[:, :sym[p].shape[-1]].to(
            torch.uint8), sym[p]), f"round 1 plane {p}: the decoded "
             f"symbols are not the shard's")
        lens = torch.as_tensor(books[p].lengths, dtype=torch.int64)
        need(torch.equal(ch[p].to(torch.int64) @ lens,
                         ce[p][1].to(torch.int64).sum(-1)),
             f"round 1 plane {p}: B2 bits != B5 . lengths")
    return {"ranks": n, "shard_elements": row.shape[-1],
            "chunks_a_plane": int(counts.numel()),
            "seconds": time.perf_counter() - t0}


def deepseek_phase(torch, dev, card, build):
    """Phase 10: ``deepseek-v3-671b`` at full width, one layer of each
    block group (see the module docstring).  Returns the record and the
    path's launch counts."""
    from dataclasses import replace

    from repro_torch.comm import LoopbackAxis, loopback_mesh, ring_all_to_all
    from repro_torch.comm.compression import CompressionSpec, histogram256
    from repro_torch.comm.transport import moe_dispatch_raw_bits, wire_factor
    from repro_torch.configs import get_config
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.models import (BlockGroup, decode_step, model_init,
                                    param_count, prefill)
    from repro_torch.models import moe
    from repro_torch.models.blocks import block_apply
    from repro_torch.models.common import tree_index, tree_leaves
    from repro_torch.models.layers import embed_apply, rmsnorm_apply
    from repro_torch.models.mla import mla_apply, mla_decode, mla_prefill
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import make_activation_probe

    t_phase = time.perf_counter()
    full = get_config(DS_ARCH)
    cfg = replace(full, blocks=(BlockGroup(("mla",), 1),
                                BlockGroup(("mla_moe",), 1)))
    cut = (f"{DS_ARCH} at full width, depth cut to 1 mla + 1 mla_moe of "
           f"its {full.n_layers} layers (3 mla + 58 mla_moe)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = param_count(params)
    gb = sum(a.numel() * a.element_size() for a in tree_leaves(params)) / 1e9
    print(f"{cut}: {n_params / 1e9:.4f} B parameters, {gb:.2f} GB; init "
          f"{init_s:.1f} s, peak memory {init_peak:.2f} GB [{card}]")
    rec = {"model": DS_ARCH, "layers": ["mla", "mla_moe"],
           "layers_full": full.n_layers, "cut": cut, "params": n_params,
           "param_gb": gb, "init_s": init_s, "init_peak_memory_gb": init_peak,
           "card": card}
    p0 = tree_index(params["groups"][0][0], 0)          # the mla layer
    p1 = tree_index(params["groups"][1][0], 0)          # the mla_moe layer

    # ---- books for the serve wire: a warm-up prefill's logits (B5)
    warm = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    with torch.no_grad():
        wl, _ = prefill(params, {"tokens": warm}, cfg, PROMPT + DS_NEW)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(
                 wl[:, -1].to(torch.bfloat16)).items()}
    del wl
    spec = CompressionSpec.from_books(books, "bf16", tensor_kind="act",
                                      mode="bitexact", transport="chunked",
                                      chunk=CHUNK, decode_backend="multisym")
    sc = ServeConfig(max_cache_len=PROMPT + DS_NEW)
    mesh = loopback_mesh({"model": DS_EP})
    tok = torch.randint(0, cfg.vocab_size, (A2A_BATCH, A2A_SEQ),
                        generator=gen, device=dev)
    with torch.no_grad():               # the mla_moe layer's MoE input
        h = embed_apply(params["embed"], tok, cfg)
        h, _, _ = block_apply("mla", p0, h, cfg)
        h = h + mla_apply(p1["mixer"], rmsnorm_apply(
            p1["norm_mix"], h, cfg.norm_eps), cfg)
        hid = rmsnorm_apply(p1["norm_ffn"], h, cfg.norm_eps)
    del h
    saved_wire = dict(moe._A2A_WIRE)
    moe._A2A_WIRE["books"] = None           # the bootstrap books
    boot = moe._a2a_wire_books("bf16")
    dispatch0 = moe._dispatch

    def eshard(sizes):
        """moe_apply_eshard over a loopback mesh of ``sizes``, and the
        slots its dispatch kept and dropped."""
        got = []

        def tap(*a, **kw):
            out = dispatch0(*a, **kw)
            got.append(out[1])
            return out

        moe._dispatch = tap
        try:
            y, aux = moe.moe_apply_eshard(p1["ffn"], hid, cfg,
                                          loopback_mesh(sizes))
        finally:
            moe._dispatch = dispatch0
        return y, aux, got

    # ---- the path: serve through the wire (ep_degree 4 accounting), one
    # compressed dispatch of the full-width MoE layer, the eshard MoE at
    # model 4 and model 1; launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    eng = Engine(params, cfg, sc, spec, ep_degree=DS_EP, device=dev)
    t0 = time.perf_counter()
    toks, totals = eng.generate(prompts, DS_NEW)
    serve_s = time.perf_counter() - t0
    serve_launches = dict(build.LAUNCHES)
    with Recorder() as r_call, torch.no_grad(), moe.use_mesh(mesh):
        before = dict(build.LAUNCHES)
        y_a2a, _, coded_a2a = moe.moe_apply_a2a_block(p1["ffn"], hid, cfg)
        torch.cuda.synchronize()
        call_launches = {k: build.LAUNCHES[k] - before[k]
                         for k in build.LAUNCHES}
    with torch.no_grad():
        y_es4, aux_es4, slots_es4 = eshard(ESHARD_MESH)
        y_es1, aux_es1, slots_es1 = eshard(dict(ESHARD_MESH, model=1))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"deepseek path: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{launches} [{card}]")
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym"):
        need(launches[k] > 0, f"deepseek: kernel {k} was not launched")

    # ---- serve: lossless, B2 = B5 . lengths, the plain engine's tokens,
    # the analytic dispatch wire (one MoE layer)
    steps = eng.step_metrics
    need(totals["act_decode_mismatch"] == 0.0,
         f"deepseek serve: {totals['act_decode_mismatch']} mismatches")
    for i, m in enumerate(steps):
        need(m["act_decoded_bits"] == m["act_coded_bits"] > 0,
             f"deepseek serve step {i}: B2 bits {m['act_decoded_bits']} != "
             f"histogram . lengths {m['act_coded_bits']}")
    per_step = wire_factor("all_to_all", DS_EP) * moe_dispatch_raw_bits(
        BATCH, cfg.experts_per_token, cfg.d_model, 16, 1)
    need(totals["moe_wire_raw_bits"] == per_step * (DS_NEW - 1),
         f"deepseek serve: moe_wire_raw_bits {totals['moe_wire_raw_bits']} "
         f"!= {per_step} x {DS_NEW - 1}")
    plain = Engine(params, cfg, sc, device=dev)
    toks_plain, _ = plain.generate(prompts, DS_NEW)
    need((toks == toks_plain).all(), "deepseek serve: the tokens differ "
         "from the engine's without books")
    need(serve_launches["decode_chunks_multisym"] > 0,
         "deepseek serve: B4 was not launched")
    bare = sorted(m["step_seconds"] for m in plain.step_metrics)
    step_s = sorted(m["step_seconds"] for m in steps)
    serve = {"new_tokens": DS_NEW, "ep_degree": DS_EP,
             "decode_step_ms_median": step_s[len(step_s) // 2] * 1e3,
             "decode_step_ms_median_no_wire": bare[len(bare) // 2] * 1e3,
             "generate_s": serve_s,
             "coded_over_raw": totals["act_coded_bits"]
             / totals["act_raw_bits"],
             "moe_wire_raw_bits_per_step": per_step,
             "launches": serve_launches}
    # phase 18 (its generate replaces the engine's step metrics, read above)
    captured_check(torch, eng, prompts, "deepseek-v3-671b", card, build,
                   ("encode_lookup", "pack_blocks", "histogram256",
                    "decode_chunks_multisym"))
    captured_prefill_check(torch, eng, prompts, "deepseek-v3-671b",
                           card)                # phase 20

    # ---- decode against one prefill of the whole sequence: the MLA
    # mixers' outputs and the MoE layer's input (before any router) on
    # every decoded token, the MoE counts and drops exactly
    seq = torch.cat([prompts, torch.from_numpy(toks).to(dev)], dim=1)
    n_seq = PROMPT + DS_NEW - 1
    with Recorder() as r_dec, MixerTap() as m_dec, torch.no_grad():
        _, caches = prefill(params, {"tokens": prompts}, cfg,
                            PROMPT + DS_NEW)
        outs = []
        for t in range(PROMPT, n_seq):
            lg, caches = decode_step(params, seq[:, t:t + 1], caches, t, cfg)
            outs.append(lg[:, 0].float())
    with Recorder() as r_full, MixerTap() as m_full, torch.no_grad():
        lg_full, full_caches = prefill(params, {"tokens": seq[:, :n_seq]},
                                       cfg, PROMPT + DS_NEW)
    n_dec = n_seq - PROMPT
    before_router = {
        f"mla mixer {layer}": token_rel_err(
            torch, torch.cat([m_dec.decode[s * 2 + layer]
                              for s in range(n_dec)], dim=1),
            m_full.prefill[layer][:, PROMPT:n_seq])
        for layer in range(2)}
    before_router["moe input"] = token_rel_err(
        torch, torch.cat([x for x, _, _ in r_dec.decode], dim=1),
        r_full.prefill[0][:, PROMPT:n_seq])
    worst_before = {k: float(v.max()) for k, v in before_router.items()}
    for k, v in before_router.items():
        need(bool(torch.isfinite(v).all()) and float(v.max()) < DECODE_TOL,
             f"deepseek decode vs full forward: {k} rel err "
             f"{float(v.max())} on some token")
    flipped, n_flips, dropped, slots, dec_dropped = moe_decode_checks(
        torch, cfg, [("deepseek moe layer", p1["ffn"],
                      caches[1][0]["moe_counts"][0],
                      full_caches[1][0]["moe_counts"][0])],
        r_dec, r_full, n_seq)
    dec_logits = torch.stack(outs, dim=1)
    err = token_rel_err(torch, dec_logits, lg_full[:, PROMPT:n_seq])
    clean = torch.cumsum(flipped.to(torch.int32), dim=1)[:, PROMPT:n_seq] == 0
    need(bool(torch.isfinite(dec_logits).all()), "deepseek decode: logits "
         "are not finite")
    logits_clean = float(err[clean].max()) if bool(clean.any()) else None
    clean_txt = "-" if logits_clean is None else f"{logits_clean:.3e}"
    # a decode step's device time, the model's and the wire probe's; the
    # MLA layer's decode and prefill on their own
    probe = make_activation_probe(spec)
    last = seq[:, n_seq - 1:n_seq]
    mla_cache = tree_index(caches[0][0], 0)
    with torch.no_grad():
        xq = rmsnorm_apply(p0["norm_mix"], embed_apply(
            params["embed"], last, cfg), cfg.norm_eps)
        xp = rmsnorm_apply(p0["norm_mix"], embed_apply(
            params["embed"], prompts, cfg), cfg.norm_eps)
        step_dev, step_ops = device_ms(torch, lambda: decode_step(
            params, last, caches, n_seq - 1, cfg)[0], 3)
        probe_dev, probe_ops = device_ms(torch, lambda: probe(lg), 3)
        mla_times = {}
        for k, fn in (("mla_decode", lambda: mla_decode(
                p0["mixer"], xq, mla_cache, n_seq - 1, cfg)[0]),
                      ("mla_prefill", lambda: mla_prefill(
                          p0["mixer"], xp, cfg, PROMPT + DS_NEW)[0])):
            r = {"ms": cuda_ms(torch, fn, 3)}
            r["device_ms"], r["device_ops"] = device_ms(torch, fn, 3)
            mla_times[k] = r
    table = params["embed"]["table"]          # a step reads B rows of it
    read_gb = gb - table.numel() * table.element_size() / 1e9
    serve.update(decode_step_device_ms=step_dev,
                 decode_step_weight_gb=read_gb,
                 decode_step_device_ops=step_ops,
                 wire_probe_device_ms=probe_dev,
                 wire_probe_device_ops=probe_ops, mla=mla_times,
                 decode_vs_forward_before_router=worst_before,
                 logits_rel_err_before_a_flip=logits_clean,
                 logits_rel_err_all=float(err.max()),
                 logits_tokens_before_a_flip=int(clean.sum()),
                 decode_tokens=int(clean.numel()),
                 routing_flips=n_flips, tokens_with_a_flip=int(
                     flipped.sum()), dropped_slots=dropped,
                 decode_dropped_slots=dec_dropped, routed_slots=slots)
    print(f"deepseek serve: decode step {serve['decode_step_ms_median']:.3f}"
          f" ms median ({serve['decode_step_ms_median_no_wire']:.3f} ms "
          f"without the wire), coded/raw {serve['coded_over_raw']:.4f}, "
          f"moe_wire_raw_bits {per_step:.0f} a step; decode vs full "
          f"forward before any router (every token, rel err): " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst_before.items())
          + f"; routing flips {n_flips} ({int(flipped.sum())} tokens); "
          f"logits rel err {clean_txt} before a flip "
          f"({int(clean.sum())} of {clean.numel()} tokens), "
          f"{float(err.max()):.3e} on all; dropped slots {dropped} of "
          f"{slots} ({dec_dropped} in the decode steps, as the forward "
          f"drops them) ({cut}) [{card}]")
    print(f"deepseek serve: a decode step {step_dev:.3f} ms device "
          f"({step_ops:.0f} device ops), its wire probe {probe_dev:.3f} ms; "
          f"weights a step reads {read_gb:.2f} GB, "
          f"{read_gb * 1e12 / HBM_BYTES_PER_S:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; " + ", ".join(
              f"{k} {r['ms']:.3f} ms ({r['device_ms']:.3f} device)"
              for k, r in mla_times.items()) + f" [{card}]")
    rec["serve"] = serve
    del caches, full_caches, r_dec, r_full, m_dec, m_full, lg_full, eng
    del plain, mla_cache

    # ---- the compressed dispatch of the full-width MoE layer, 8 x 512
    y_sc, _ = moe.moe_apply(p1["ffn"], hid, cfg)
    exact = torch.equal(bits_of(torch, y_a2a), bits_of(torch, y_sc))
    need(exact, "deepseek a2a: y != moe_apply bit for bit")
    need(len(r_call.wire) == 2, f"deepseek a2a: {len(r_call.wire)} "
         f"all-to-alls")
    wire_boot = check_wire_calls(torch, r_call.wire, boot, "deepseek a2a")
    rounds = DS_EP - 1
    for k in ("decode_chunks_multisym", "encode_lookup", "pack_blocks"):
        need(call_launches[k] == 2 * 2 * rounds, f"deepseek a2a: "
             f"{call_launches[k]} {k} launches for 2 x {rounds} rounds "
             f"of 2 planes")
    need(float(coded_a2a) == sum(c for c, _ in wire_boot),
         f"deepseek a2a: the block's coded bits {float(coded_a2a)} != the "
         f"summed hop ledgers")
    send_d, recv_d, _ = r_call.wire[0]
    send_c, _, _ = r_call.wire[1]
    cap = moe.moe_stream_capacity_host(A2A_SEQ, cfg)
    need(send_d[0, 0].numel() == A2A_BATCH // DS_EP * cfg.n_experts
         // DS_EP * cap * cfg.d_model, f"deepseek a2a: shard {send_d.shape}")

    def call():
        with moe.use_mesh(mesh):
            return moe.moe_apply_a2a_block(p1["ffn"], hid, cfg)[2]

    weights = moe._expert_weights(p1["ffn"])
    e_loc = cfg.n_experts // DS_EP
    hbuf = recv_d.reshape(DS_EP, -1, e_loc, cap, cfg.d_model)
    ax = LoopbackAxis(DS_EP)
    wire_kw = dict(chunk=moe._A2A_WIRE["chunk"],
                   decode_backend=moe._A2A_WIRE["decode_backend"])
    fns = {
        "a2a_block": call,
        "scatter": lambda: moe.moe_apply(p1["ffn"], hid, cfg)[0],
        "experts": lambda: [moe._experts(hbuf[i], weights[
            i * e_loc:(i + 1) * e_loc], cfg) for i in range(DS_EP)],
        "dispatch_wire": lambda: ring_all_to_all(send_d, ax, boot,
                                                 **wire_kw),
        "combine_wire": lambda: ring_all_to_all(send_c, ax, boot, **wire_kw),
        "eshard": lambda: moe.moe_apply_eshard(
            p1["ffn"], hid, cfg, loopback_mesh(ESHARD_MESH))[0],
    }
    with torch.no_grad():
        times = {}
        for k, fn in fns.items():
            r = {"ms": cuda_ms(torch, fn, 3)}
            r["device_ms"], r["device_ops"] = device_ms(torch, fn, 3)
            times[k] = r
        parts = {k: port_kernel_ms(torch, fns[k], 3)
                 for k in ("dispatch_wire", "combine_wire")}
        # books built by B5 from the first dispatch's own payload
        own = {p: build_codebook(histogram256(s).cpu().numpy(),
                                 key=("moe_dispatch", "bf16", p))
               for p, s in SCHEMES["bf16"].to_symbols(send_d).items()}
        moe.configure_a2a_wire(own)
        with Recorder() as r_own, moe.use_mesh(mesh):
            y_own, _, coded_own = moe.moe_apply_a2a_block(p1["ffn"], hid,
                                                          cfg)
        need(torch.equal(bits_of(torch, y_own), bits_of(torch, y_a2a)),
             "deepseek a2a: the result moved with the books")
        wire_own = check_wire_calls(torch, r_own.wire, own, "deepseek a2a "
                                    "(own books)")
        need(float(coded_own) == sum(c for c, _ in wire_own),
             f"deepseek a2a (own books): the block's coded bits "
             f"{float(coded_own)} != the summed hop ledgers")
        # the wire's kernels against their plain versions at this shard
        # size: a whole call's CPU copies would take minutes, so the
        # dispatch's first round under the bootstrap books
        held = first_round_held(torch, send_d, boot, wire_kw["chunk"],
                                wire_kw["decode_backend"])
        print(f"deepseek a2a wire vs plain (the dispatch's round 1, "
              f"bootstrap books, chunk {wire_kw['chunk']}, {held['ranks']} "
              f"shards of {held['shard_elements']}): B5 histograms, B1 -> "
              f"B2 words and bits, B4's blocks equal ({held['seconds']:.1f}"
              f" s)")
    moe._A2A_WIRE.clear()
    moe._A2A_WIRE.update(saved_wire)
    ratio = {f"{w}_{b}": c / r for b, calls in (("bootstrap", wire_boot),
                                               ("own_books", wire_own))
             for w, (c, r) in zip(("dispatch", "combine"), calls)}
    rec["a2a"] = {
        "batch": A2A_BATCH, "seq": A2A_SEQ, "ranks": DS_EP,
        "capacity": cap, "shard_elements": send_d[0, 0].numel(),
        "chunk": wire_kw["chunk"], "y_bit_identical": exact,
        "launches": call_launches, "times": times,
        "wire_parts_ms_per_call": parts, "coded_over_raw": ratio,
        "kernels_vs_plain": held,
        "hop_coded_bits": {
            "bootstrap": [c[2]["hop_coded_bits"][0].tolist()
                          for c in r_call.wire],
            "own_books": [c[2]["hop_coded_bits"][0].tolist()
                          for c in r_own.wire]}}
    print(f"deepseek a2a ({A2A_BATCH} x {A2A_SEQ}, {DS_EP} ranks, capacity "
          f"{cap}, {send_d[0, 0].numel()} elements a shard a round): y "
          f"bit-identical to moe_apply; coded/raw " + ", ".join(
              f"{k} {v:.4f}" for k, v in ratio.items()) + f" [{card}]")
    for k, r in times.items():
        print(f"  {k}: {r['ms']:.3f} ms (device {r['device_ms']:.3f} ms, "
              f"{r['device_ops']:.0f} device ops) [{card}]")
    for k, r in parts.items():
        print(f"  {k} device ms a call by kernel: " + ", ".join(
            f"{n} {v:.4f}" for n, v in r.items()) + f" [{card}]")
    del r_call, r_own, send_d, recv_d, send_c, hbuf, fns, y_own

    # ---- the eshard MoE: model 4 against model 1 on the same data shards
    need(len(slots_es4) == len(slots_es1) == 1
         and torch.equal(slots_es4[0], slots_es1[0]),
         "deepseek eshard: the kept and dropped slots at model 4 differ "
         "from those at model 1")
    dp = ESHARD_MESH["data"]
    es_cap = moe.moe_capacity(A2A_BATCH // dp * A2A_SEQ, cfg)
    slot = slots_es4[0]
    es_dropped = int((slot == dp * cfg.n_experts * es_cap).sum())
    kept = torch.bincount((slot[slot != dp * cfg.n_experts * es_cap]
                           // es_cap) % cfg.n_experts,
                          minlength=cfg.n_experts)
    es_diff = float((y_es4.float() - y_es1.float()).abs().max()
                    / y_es1.float().abs().max())
    need(es_diff <= ESHARD_TOL, f"deepseek eshard: model 4 vs model 1 rel "
         f"{es_diff} > {ESHARD_TOL}")
    need(float(aux_es4) == float(aux_es1) or abs(
        float(aux_es4) - float(aux_es1)) <= 1e-6 * abs(float(aux_es1)),
         f"deepseek eshard: aux {float(aux_es4)} vs {float(aux_es1)}")
    vs_scatter = float((y_es4.float() - y_sc.float()).abs().max()
                       / y_sc.float().abs().max())
    rec["eshard"] = {
        "mesh": ESHARD_MESH, "capacity": es_cap, "slots": slot.numel(),
        "dropped_slots": es_dropped, "kept_per_expert_max": int(kept.max()),
        "kept_per_expert_min": int(kept.min()),
        "rel_diff_vs_model_1": es_diff, "tolerance": ESHARD_TOL,
        "bit_identical_to_model_1": torch.equal(bits_of(torch, y_es4),
                                                bits_of(torch, y_es1)),
        "rel_diff_vs_moe_apply": vs_scatter, "aux": float(aux_es4)}
    print(f"deepseek eshard ({A2A_BATCH} x {A2A_SEQ} on {ESHARD_MESH}, "
          f"capacity {es_cap}): the same kept and dropped slots as at "
          f"model 1 ({es_dropped} of {slot.numel()} dropped; kept a expert "
          f"{int(kept.min())}..{int(kept.max())}); y within {es_diff:.3e} of "
          f"model 1's (tolerance {ESHARD_TOL}), {vs_scatter:.3e} from "
          f"moe_apply (other capacities) [{card}]")
    del params, hid, y_a2a, y_sc, y_es4, y_es1, p0, p1
    torch.cuda.empty_cache()

    # ---- the reduced config: one step on the card and one on the CPU,
    # held in float32.  In bf16 the card's products and the CPU's add in
    # other orders through MLA's chains of einsums and a top-2-of-4
    # router, and the step's readings pass STEP_TOL's grad-norm limit (an
    # H100 80GB HBM3 at 700 W read 3.81e-4 against 3e-4, PERF.md §6):
    # printed, not held
    rec["reduced_card_vs_cpu"] = reduced_step_card_vs_cpu(
        torch, dev, full.reduced(dtype=torch.float32), "deepseek", card)
    rec["reduced_card_vs_cpu_bf16"] = reduced_step_card_vs_cpu(
        torch, dev, full.reduced(), "deepseek", card, gate=False)
    rec["reduced_bf16_routing"] = routing_flips(torch, dev, full.reduced(),
                                                card)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


# ------------------------------------------------ recurrent kinds (11, 12)
# arch -> (launches_by_path key, block kind, the cache's state key)
RECURRENT = {"recurrentgemma-9b": ("recurrentgemma", "rec", "h"),
             "mamba2-780m": ("mamba2", "mamba", "state")}
KV_CHUNK = 512                # the coded KV store's chunk
SCAN_LEN, SSD_LEN = 4096, 2048
# the log-depth scan against a sequential float32 loop over the same
# (a, b): ~1 000 float32 adds feed each h where a nears 0.999, in
# another order in each
SCAN_TOL = 1e-4
# ssd_chunked against the sequential recurrence in float32 on the card
# (the reference's own tolerance against its float64 oracle)
SSD_TOL = 2e-4
# The dtype in which each model's decode replay is held to DECODE_TOL
# (the other readings printed).  The random mamba2-780m stack carries a
# bf16 rounding of its input ~100x through its 48 layers: its bf16 replay
# parts from the full prefill by ~0.3 of the logits' max, and the
# reference's own bf16 replay of the same stack at d 256 parts as far
# (tests/test_torch_ssm.py::test_bf16_decode_drift_equals_reference), so
# its replay is held on a float32 copy of the weights.
REPLAY_DTYPE = {"recurrentgemma-9b": "bfloat16", "mamba2-780m": "float32"}


def record_logits(eng) -> list:
    """The list that will hold a copy of every decode step's logits of
    ``eng`` (its step wrapped)."""
    out, step = [], eng._step

    def rec(*a):
        logits, caches, m = step(*a)
        out.append(logits.detach().clone())
        return logits, caches, m

    eng._step = rec
    return out


def op_tape(torch):
    """A ``TorchFunctionMode`` (a context manager) whose ``ops`` list
    gets every floating-point tensor a torch call returns, in call
    order, as a CPU copy; uninitialised allocations (``*empty*``) are
    left out."""
    from torch.overrides import TorchFunctionMode

    class Tape(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", str(func))
            if (isinstance(out, torch.Tensor) and out.is_floating_point()
                    and "empty" not in name):
                self.ops.append((name, out.detach().to("cpu", copy=True)))
            return out

    tape = Tape()
    tape.ops = []
    return tape


def first_divergence(torch, dev, rcfg) -> dict:
    """The reduced model's forward (seed-0 params, 2 x 32 tokens) on the
    CPU and on the card, every op's output taped: the first op whose
    output differs from the CPU's by more than one bf16 ulp of the CPU's
    entry (2^(e-8) for |w| = m 2^e, m in [0.5, 1)), and the first that
    differs at all."""
    import numpy as np

    from repro_torch.models import forward, model_init
    from repro_torch.models.common import tree_map

    params = model_init(rcfg, torch.Generator().manual_seed(SEED),
                        device="cpu")
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, rcfg.vocab_size, (2, 32)))
    tapes = []
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.to(where), params)
        with op_tape(torch) as tape, torch.no_grad():
            forward(p, {"tokens": tok.to(where)}, rcfg)
        tapes.append(tape.ops)
    (cpu, card) = tapes
    out = {"ops": len(cpu), "ops_card": len(card), "first_differing": None,
           "first_beyond_ulp": None}
    for i, ((name, w), (name_d, g)) in enumerate(zip(cpu, card)):
        if name != name_d or w.shape != g.shape:
            out["tapes_part_at"] = {"index": i, "cpu": name, "card": name_d}
            break
        d = (g.double() - w.double()).abs()
        if out["first_differing"] is None and bool((d > 0).any()):
            out["first_differing"] = {"index": i, "op": name}
        ulp = torch.where(w == 0, 0.0, torch.ldexp(
            torch.ones_like(w, dtype=torch.float64),
            torch.frexp(w.double())[1] - 8))
        beyond = d > ulp
        if bool(beyond.any()):
            out["first_beyond_ulp"] = {
                "index": i, "op": name, "shape": list(w.shape),
                "dtype": str(w.dtype).split(".")[-1],
                "entries_beyond": int(beyond.sum()),
                "max_abs_diff": float(d.max()),
                "rel_err": float(d.max() / w.double().abs().max()),
                "ops_before": [n for n, _ in cpu[max(0, i - 6):i]]}
            break
    return out


def serve_three_ways(torch, dev, params, cfg, books, prompts, path, card,
                     build, prefix=None):
    """The serve path of phases 11-13, launch counts reset just before and
    read just after: ``Engine`` through the bitexact wire (``multisym``,
    chunk 2048, ``books``), the engine without books and the coded KV
    engine (chunk 512), each generating ``NEW`` tokens after ``prompts``
    (and ``prefix`` embeddings).  Checked: B1, B2, B4, B5 launched; every
    wire step lossless with B2 bits = B5 . lengths and the logits plane's
    chunks; the tokens of the engine without books; the coded engine's
    tokens and every step's logits equal to the raw engine's, bit for
    bit; B1, B2 and B4 on one decode step's logits planes (181 chunks
    for internvl, the last partial) against their plain versions, after
    the count.  Returns the serve record, the tokens, the launch counts
    and the coded engine."""
    from repro_torch.comm.compression import CompressionSpec
    from repro_torch.core.encoder import chunk_counts_for
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.serve import Engine, ServeConfig

    spec = CompressionSpec.from_books(books, "bf16", tensor_kind="act",
                                      mode="bitexact", transport="chunked",
                                      chunk=CHUNK, decode_backend="multisym")
    kv_spec = CompressionSpec.from_books(books, "bf16", tensor_kind="act",
                                         chunk=KV_CHUNK)
    sc = ServeConfig(max_cache_len=PROMPT + NEW + (
        0 if prefix is None else prefix.shape[1]))
    t_path = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    eng = Engine(params, cfg, sc, spec, device=dev)
    t0 = time.perf_counter()
    toks, totals = eng.generate(prompts, NEW, prefix_embeds=prefix)
    serve_s = time.perf_counter() - t0
    plain = Engine(params, cfg, sc, device=dev)
    plain_logits = record_logits(plain)
    toks_plain, _ = plain.generate(prompts, NEW, prefix_embeds=prefix)
    coded = Engine(params, cfg, sc, kv_spec, kv_mode="coded", device=dev)
    coded_logits = record_logits(coded)
    t0 = time.perf_counter()
    toks_coded, ctot = coded.generate(prompts, NEW, prefix_embeds=prefix)
    coded_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{path} path: {time.perf_counter() - t_path:.1f} s, launches "
          f"{launches} [{card}]")
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym"):
        need(launches[k] > 0, f"{path}: kernel {k} was not launched")

    # ---- the wire: lossless, B2 = B5 . lengths, the plain engine's tokens
    counts = chunk_counts_for(BATCH * cfg.vocab_size, CHUNK)
    steps = eng.step_metrics
    need(toks.shape == (BATCH, NEW), f"{path}: tokens {toks.shape}")
    need(len(steps) == NEW - 1, f"{path}: {len(steps)} decode steps")
    need(totals["act_decode_mismatch"] == 0.0,
         f"{path} serve: {totals['act_decode_mismatch']} mismatches")
    for i, m in enumerate(steps):
        need(m["act_decoded_bits"] == m["act_coded_bits"] > 0,
             f"{path} serve step {i}: B2 bits {m['act_decoded_bits']} != "
             f"histogram . lengths {m['act_coded_bits']}")
        need(m["act_decode_chunks"] == 2 * len(counts),
             f"{path} serve step {i}: {m['act_decode_chunks']} chunks")
    need((toks == toks_plain).all(), f"{path} serve: the tokens differ "
         f"from the engine's without books")
    # ---- coded KV: the raw engine's tokens and logits, bit for bit
    need((toks_coded == toks_plain).all(), f"{path} coded KV: the tokens "
         f"differ from the raw engine's")
    need(len(coded_logits) == len(plain_logits) == NEW - 1,
         f"{path} coded KV: {len(coded_logits)} steps recorded")
    for i, (a, b) in enumerate(zip(coded_logits, plain_logits)):
        need(torch.equal(a.view(torch.int16), b.view(torch.int16)),
             f"{path} coded KV step {i}: logits differ from the raw "
             f"engine's")
    # ---- the wire's kernels at this path's plane, against their plain
    # versions (uncounted launches)
    t0 = time.perf_counter()
    for p, sym in SCHEMES["bf16"].to_symbols(plain_logits[0]).items():
        codec_held_to_plain(torch, f"{path} wire {p}", sym, books[p], CHUNK)
    held_s = time.perf_counter() - t0

    def median_ms(e):
        s = sorted(m["step_seconds"] for m in e.step_metrics)
        return s[len(s) // 2] * 1e3

    kv_ratio = ctot["kv_hbm_coded_bits"] / ctot["kv_hbm_raw_bits"]
    serve = {"new_tokens": NEW, "generate_s": serve_s,
             "coded_kv_generate_s": coded_s,
             "decode_step_ms_median": median_ms(eng),
             "decode_step_ms_median_no_wire": median_ms(plain),
             "coded_kv_decode_step_ms_median": median_ms(coded),
             "coded_over_raw": totals["act_coded_bits"]
             / totals["act_raw_bits"],
             "chunks_a_plane": len(counts),
             "last_chunk_symbols": int(counts[-1]),
             "kv_hbm_raw_bits": ctot["kv_hbm_raw_bits"],
             "kv_hbm_coded_bits": ctot["kv_hbm_coded_bits"],
             "kv_coded_over_raw": kv_ratio, "peak_memory_gb": serve_peak,
             "kernels_vs_plain_s": held_s, "launches": launches}
    print(f"{path} serve: {len(counts)} chunks a plane (the last "
          f"{int(counts[-1])} symbols), every step lossless, B1/B2/B4 on "
          f"step 0's planes equal to their plain versions ({held_s:.2f} s); "
          f"decode step "
          f"{serve['decode_step_ms_median']:.3f} ms median "
          f"({serve['decode_step_ms_median_no_wire']:.3f} ms without the "
          f"wire, {serve['coded_kv_decode_step_ms_median']:.3f} ms with the "
          f"coded KV), coded/raw {serve['coded_over_raw']:.4f}; coded KV "
          f"(chunk {KV_CHUNK}): tokens and every step's logits equal to the "
          f"raw engine's, KV coded/raw {kv_ratio:.4f}; peak memory "
          f"{serve_peak:.2f} GB [{card}]")
    # phase 18 (its generate replaces the engine's step metrics, read above)
    captured_check(torch, eng, prompts, cfg.name, card, build,
                   ("encode_lookup", "pack_blocks", "histogram256",
                    "decode_chunks_multisym"), prefix=prefix)
    captured_prefill_check(torch, eng, prompts, cfg.name, card,
                           prefix=prefix)       # phase 20
    return serve, toks, launches, coded


def recurrent_phase(torch, dev, card, build, arch: str):
    """Phases 11 and 12: ``arch`` (``recurrentgemma-9b`` or
    ``mamba2-780m``) at full width and full depth (see the module
    docstring).  Returns the record and the path's launch counts."""
    from dataclasses import replace

    from repro_torch.comm.compression import histogram256
    from repro_torch.configs import get_config
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.models import (decode_step, model_init, param_count,
                                    prefill)
    from repro_torch.models import rglru, ssm
    from repro_torch.models.common import tree_index, tree_leaves, tree_map
    from repro_torch.models.layers import embed_apply, rmsnorm_apply, silu

    path, kind, skey = RECURRENT[arch]
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = param_count(params)
    gb = sum(a.numel() * a.element_size() for a in tree_leaves(params)) / 1e9
    kinds = cfg.layer_kinds
    print(f"{arch} at full width and depth ({len(kinds)} layers: "
          f"{kinds.count(kind)} {kind}"
          + (f", {len(kinds) - kinds.count(kind)} local" if kind == "rec"
             else "") + f"): {n_params / 1e9:.4f} B parameters, {gb:.2f} "
          f"GB; init {init_s:.1f} s, peak memory {init_peak:.2f} GB [{card}]")
    rec = {"model": arch, "layers": len(kinds), "kinds": sorted(set(kinds)),
           "params": n_params, "param_gb": gb, "init_s": init_s,
           "init_peak_memory_gb": init_peak, "card": card}
    # (group, sub, repeat) of every recurrent layer, in order
    where = [(gi, si, r) for gi, bg in enumerate(cfg.blocks)
             for r in range(bg.repeats)
             for si, k in enumerate(bg.pattern) if k == kind]

    # ---- books for the serve wire: a warm-up prefill's logits (B5)
    warm = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    with torch.no_grad():
        wl, _ = prefill(params, {"tokens": warm}, cfg, PROMPT + NEW)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(
                 wl[:, -1].to(torch.bfloat16)).items()}
    del wl
    serve, toks, launches, coded = serve_three_ways(
        torch, dev, params, cfg, books, prompts, path, card, build)
    # the recurrent states pass through the coded store raw, counted alike
    # on both sides of its ledger; only a local layer's K/V is coded
    segs = coded._kv._segments
    raw_leaf_bits = coded._kv._raw_leaf_bits()
    need(serve["kv_hbm_raw_bits"] - serve["kv_hbm_coded_bits"] == sum(
        s.raw_bits - s.coded_bits for v in segs.values() for s in v),
         f"{path} coded KV: the raw state is not counted alike on both "
         f"sides")
    need(bool(segs) == (kind == "rec"), f"{path} coded KV: coded nodes "
         f"{sorted(segs)}")
    serve.update(kv_coded_nodes=sorted(segs),
                 kv_raw_pass_through_bits=raw_leaf_bits)
    print(f"{path} coded KV: coded nodes {sorted(segs)}, {raw_leaf_bits} "
          f"bits passed through raw [{card}]")
    del coded

    # ---- decode against one prefill of the whole sequence: every decoded
    # token's logits, every recurrent layer's state after the last step
    seq = torch.cat([prompts, torch.from_numpy(toks).to(dev)], dim=1)
    n_seq = PROMPT + NEW - 1

    def replay(ps, c):
        with torch.no_grad():
            _, dc = prefill(ps, {"tokens": prompts}, c, PROMPT + NEW)
            outs = []
            for t in range(PROMPT, n_seq):
                lg, dc = decode_step(ps, seq[:, t:t + 1], dc, t, c)
                outs.append(lg[:, 0].float())
            lg_full, fc = prefill(ps, {"tokens": seq[:, :n_seq]}, c,
                                  PROMPT + NEW)
        err = token_rel_err(torch, torch.stack(outs, dim=1),
                            lg_full[:, PROMPT:n_seq])
        need(bool(torch.isfinite(err).all()), f"{path} decode replay: "
             f"logits not finite")
        return {"logits_rel_err_max": float(err.max()),
                "state_rel_err_by_layer": [
                    max_rel_diff(torch, dc[g][s][skey][r], fc[g][s][skey][r])
                    for g, s, r in where]}, dc

    replays = {}
    replays["bfloat16"], caches = replay(params, cfg)
    if REPLAY_DTYPE[arch] == "float32":
        p32 = tree_map(lambda t: t.float(), params)
        replays["float32"], _ = replay(p32, replace(cfg,
                                                    dtype=torch.float32))
        del p32
    for dt, r in replays.items():
        r["state_rel_err_max"] = max(r["state_rel_err_by_layer"])
        print(f"{path} decode vs one prefill of {n_seq} tokens ({dt}"
              f"{', held' if dt == REPLAY_DTYPE[arch] else ', printed'}): "
              f"logits rel err {r['logits_rel_err_max']:.3e} (every one of "
              f"{BATCH * (n_seq - PROMPT)} tokens), {skey} rel err "
              f"{r['state_rel_err_max']:.3e} (worst of {len(where)} layers)"
              f" [{card}]")
    held = replays[REPLAY_DTYPE[arch]]
    need(held["logits_rel_err_max"] < DECODE_TOL, f"{path} decode vs full "
         f"forward: logits rel err {held['logits_rel_err_max']}")
    need(held["state_rel_err_max"] < DECODE_TOL, f"{path} decode vs full "
         f"forward: {skey} rel err {held['state_rel_err_max']} in some "
         f"layer")
    serve.update(replay=replays, replay_held=REPLAY_DTYPE[arch],
                 decode_tokens=BATCH * (n_seq - PROMPT))

    # ---- one layer's scan (rec) / SSD (mamba) on its real inputs at full
    # length against the sequential recurrence in float32 on the card
    g0, s0, r0 = where[0]
    p = tree_index(params["groups"][g0][s0], r0)
    mix = p["mixer"]
    n_len = SCAN_LEN if kind == "rec" else SSD_LEN
    tok = torch.randint(0, cfg.vocab_size, (BATCH, n_len), generator=gen,
                        device=dev)
    with torch.no_grad():
        u = rmsnorm_apply(p["norm_mix"], embed_apply(params["embed"], tok,
                                                     cfg), cfg.norm_eps)
        t0 = time.perf_counter()
        if kind == "rec":
            a, b = rglru._gates(mix, rglru._causal_conv1d(
                u @ mix["w_in"], mix["conv"]))
            del u
            _, h = rglru._linear_scan(a, b)
            hs, ht = torch.empty_like(b), torch.zeros_like(b[:, 0])
            for t in range(n_len):
                ht = a[:, t] * ht + b[:, t]
                hs[:, t] = ht
            long_err = {"h": max_rel_diff(torch, h, hs)}
            long_case = {"a_min": float(a.min()), "a_max": float(a.max()),
                         "shape": list(a.shape)}

            def long_fn():
                return rglru._linear_scan(a, b)[1]
        else:
            z, x_raw, b_raw, c_raw, dt = ssm._project(mix, u, cfg)
            del u, z
            rep = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
            rep //= cfg.ssm_n_groups
            x = silu(ssm._causal_conv(x_raw, mix["conv_x"]))
            bh = torch.repeat_interleave(silu(ssm._causal_conv(
                b_raw, mix["conv_B"])), rep, dim=2)
            ch = torch.repeat_interleave(silu(ssm._causal_conv(
                c_raw, mix["conv_C"])), rep, dim=2)
            a_neg = -torch.exp(mix["A_log"])
            y, final = ssm.ssd_chunked(x, dt, a_neg, bh, ch,
                                       chunk=cfg.ssm_chunk,
                                       return_final_state=True)
            xf, bf, cf = x.float(), bh.float(), ch.float()
            state = torch.zeros_like(final)
            ys = torch.empty_like(y)
            for t in range(n_len):
                da = torch.exp(dt[:, t] * a_neg[None, :])
                state = (state * da[..., None, None]
                         + dt[:, t][..., None, None]
                         * xf[:, t][..., :, None] * bf[:, t][:, :, None, :])
                ys[:, t] = (state * cf[:, t][:, :, None, :]).sum(-1)
            long_err = {"y": max_rel_diff(torch, y, ys),
                        "state": max_rel_diff(torch, final, state)}
            long_case = {"shape": list(x.shape), "chunks": n_len
                         // cfg.ssm_chunk, "dt_max": float(dt.max())}

            def long_fn():
                return ssm.ssd_chunked(x, dt, a_neg, bh, ch,
                                       chunk=cfg.ssm_chunk)
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        tol = SCAN_TOL if kind == "rec" else SSD_TOL
        need(all(v <= tol for v in long_err.values()), f"{path}: the "
             f"{'scan' if kind == 'rec' else 'SSD'} at {BATCH} x {n_len} vs "
             f"the sequential loop: {long_err} > {tol}")
        long_ms = {"ms": cuda_ms(torch, long_fn, 3)}
        long_ms["device_ms"], long_ms["device_ops"] = device_ms(
            torch, long_fn, 3)
    what = "scan" if kind == "rec" else "ssd_chunked"
    rec["long"] = {"what": what, "batch": BATCH, "length": n_len,
                   "rel_err": long_err, "tolerance": tol, **long_case,
                   "check_s": long_s, **long_ms}
    print(f"{path}: one layer's {what} on its real inputs at {BATCH} x "
          f"{n_len} vs a sequential float32 loop: rel err " + ", ".join(
              f"{k} {v:.3e}" for k, v in long_err.items())
          + f" (tolerance {tol}; {long_case}); {long_ms['ms']:.3f} ms "
          f"({long_ms['device_ms']:.3f} device, {long_ms['device_ops']:.0f} "
          f"device ops) [{card}]")
    del tok
    if kind == "rec":
        del a, b, h, hs, ht
    else:
        del x, bh, ch, y, ys, xf, bf, cf, x_raw, b_raw, c_raw, dt

    # ---- times: a decode step (device), a layer's decode and prefill
    last = seq[:, n_seq - 1:n_seq]
    layer_cache = tree_index(caches[g0][s0], r0)
    decode_fn, prefill_fn = ((rglru.rglru_decode, rglru.rglru_prefill)
                             if kind == "rec" else
                             (ssm.mamba_decode, ssm.mamba_prefill))
    with torch.no_grad():
        xq = rmsnorm_apply(p["norm_mix"], embed_apply(
            params["embed"], last, cfg), cfg.norm_eps)
        xp = rmsnorm_apply(p["norm_mix"], embed_apply(
            params["embed"], prompts, cfg), cfg.norm_eps)
        step_dev, step_ops = device_ms(torch, lambda: decode_step(
            params, last, caches, n_seq - 1, cfg)[0], 3)
        layer = {}
        for k, fn in (("decode", lambda: decode_fn(
                mix, xq, layer_cache, n_seq - 1, cfg)[0]),
                      ("prefill", lambda: prefill_fn(mix, xp, cfg)[0])):
            r = {"ms": cuda_ms(torch, fn, 3)}
            r["device_ms"], r["device_ops"] = device_ms(torch, fn, 3)
            layer[k] = r
    table = params["embed"]["table"]          # a step reads B rows of it
    read_gb = gb - (0 if cfg.tie_embeddings
                    else table.numel() * table.element_size() / 1e9)
    serve.update(decode_step_device_ms=step_dev,
                 decode_step_device_ops=step_ops,
                 decode_step_weight_gb=read_gb, layer=layer)
    print(f"{path}: a decode step {step_dev:.3f} ms device ({step_ops:.0f} "
          f"device ops); weights a step reads {read_gb:.2f} GB, "
          f"{read_gb * 1e12 / HBM_BYTES_PER_S:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; one {kind} layer: " + ", ".join(
              f"{k} {r['ms']:.3f} ms ({r['device_ms']:.3f} device, "
              f"{r['device_ops']:.0f} ops)" for k, r in layer.items())
          + f" [{card}]")
    rec["serve"] = serve
    del params, caches, layer_cache, p, mix, table
    torch.cuda.empty_cache()

    # ---- the reduced config: one step on the card and one on the CPU in
    # bf16, held to STEP_TOL; the first op of the forward whose outputs
    # part by more than a bf16 ulp; float32 held only where bf16 misses
    red = cfg.reduced()
    rec["first_divergence_bf16"] = first_divergence(torch, dev, red)
    print(f"{path} reduced forward, card vs CPU (bf16): "
          f"{json.dumps(rec['first_divergence_bf16'])} [{card}]")
    bf16 = reduced_step_card_vs_cpu(torch, dev, red, path, card, gate=False)
    rec["reduced_card_vs_cpu_bf16"] = bf16
    if not bf16["within_step_tol"]:
        rec["reduced_card_vs_cpu"] = reduced_step_card_vs_cpu(
            torch, dev, cfg.reduced(dtype=torch.float32), path, card)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


# ----------------------------- prefix embeddings (13, 14), statistics (15)
PREFIX = 1024                 # internvl2-26b's patch prefix (its config's)
HUBERT_BATCH, HUBERT_SEQ = 4, 1024
HUBERT_REFRESH = 4
# the paper's geometry: 18 layers x 64 shards of gemma2-2b's w_gate stack
STATS_SHARDS = 64


def internvl_phase(torch, dev, card, build):
    """Phase 13: ``internvl2-26b`` served at full width and full depth
    after a 1024-patch prefix (see the module docstring).  Returns the
    record and the path's launch counts."""
    from repro_torch.comm.compression import histogram256
    from repro_torch.configs import get_config
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.models import (decode_step, model_init, param_count,
                                    prefill)
    from repro_torch.models.common import tree_leaves

    t_phase = time.perf_counter()
    held_gb = torch.cuda.memory_allocated() / 1e9
    need(held_gb < 1.0, f"internvl: the card still holds {held_gb:.2f} GB "
         f"of earlier phases")
    cfg = get_config("internvl2-26b")
    need(cfg.prefix_len == PREFIX, f"internvl: prefix_len {cfg.prefix_len}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = param_count(params)
    gb = sum(a.numel() * a.element_size() for a in tree_leaves(params)) / 1e9
    print(f"internvl2-26b at full width and depth ({cfg.n_layers} attn "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads GQA kv "
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
          f"{n_params / 1e9:.4f} B parameters, {gb:.2f} GB; init "
          f"{init_s:.1f} s, peak memory {init_peak:.2f} GB (held before "
          f"{held_gb:.3f} GB) [{card}]")
    rec = {"model": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "param_gb": gb, "init_s": init_s, "init_peak_memory_gb": init_peak,
           "prefix": PREFIX, "card": card}

    def patches():              # seeded patch embeddings, float32
        return torch.randn((BATCH, PREFIX, cfg.d_model), generator=gen,
                           device=dev)

    # ---- books for the serve wire: a warm-up prefill's logits (B5)
    warm, warm_pfx = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                   generator=gen, device=dev), patches()
    prompts, pfx = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                 generator=gen, device=dev), patches()
    cache_len = PREFIX + PROMPT + NEW
    with torch.no_grad():
        wl, _ = prefill(params, {"tokens": warm, "prefix_embeds": warm_pfx},
                        cfg, cache_len)
    need(wl.shape == (BATCH, PROMPT, cfg.vocab_size), f"internvl: prefill "
         f"logits {tuple(wl.shape)} are not the token positions'")
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(
                 wl[:, -1].to(torch.bfloat16)).items()}
    del wl, warm, warm_pfx
    serve, toks, launches, coded = serve_three_ways(
        torch, dev, params, cfg, books, prompts, "internvl", card, build,
        prefix=pfx)
    # the coded store's first ingest codes the prefix's slots with the
    # prompt's
    first = [int(v[0].slots.numel()) for v in coded._kv._segments.values()]
    need(first == [PREFIX + PROMPT], f"internvl coded KV: the first ingest "
         f"coded {first} slots, not the prefix's and the prompt's "
         f"{PREFIX + PROMPT}")
    serve["kv_first_ingest_slots"] = first[0]
    print(f"internvl coded KV: the first ingest coded {first[0]} slots "
          f"({PREFIX} prefix + {PROMPT} prompt) [{card}]")
    del coded

    # ---- decode against one prefill of the whole sequence (prefix and
    # 95 tokens): every decoded token's logits
    seq = torch.cat([prompts, torch.from_numpy(toks).to(dev)], dim=1)
    n_seq = PROMPT + NEW - 1
    with torch.no_grad():
        _, caches = prefill(params, {"tokens": prompts, "prefix_embeds": pfx},
                            cfg, cache_len)
        outs = []
        for t in range(PROMPT, n_seq):
            lg, caches = decode_step(params, seq[:, t:t + 1], caches,
                                     PREFIX + t, cfg)
            outs.append(lg[:, 0].float())
        full, _ = prefill(params, {"tokens": seq[:, :n_seq],
                                   "prefix_embeds": pfx}, cfg, cache_len)
    err = token_rel_err(torch, torch.stack(outs, dim=1), full[:, PROMPT:])
    need(bool(torch.isfinite(err).all()), "internvl decode replay: logits "
         "not finite")
    serve["replay_logits_rel_err_max"] = float(err.max())
    print(f"internvl decode vs one prefill of {PREFIX} + {n_seq} positions "
          f"(bf16): logits rel err {float(err.max()):.3e} (every one of "
          f"{BATCH * (n_seq - PROMPT)} tokens; tolerance {DECODE_TOL}) "
          f"[{card}]")
    need(float(err.max()) < DECODE_TOL, f"internvl decode vs full forward: "
         f"logits rel err {float(err.max())}")
    del outs, full

    # ---- times: the prefill (4 x (1024 + 64)), a decode step (device)
    last = seq[:, n_seq - 1:n_seq]
    with torch.no_grad():
        pre = {"tokens": prompts, "prefix_embeds": pfx}
        reading = eager_reading(torch, lambda: prefill(params, pre, cfg,
                                                       cache_len)[0])
        pre_ms, pre_dev = reading["wall_ms"], reading["device_ms"]
        pre_ops = reading["device_ops"]
        step_dev, step_ops = device_ms(torch, lambda: decode_step(
            params, last, caches, PREFIX + n_seq - 1, cfg)[0], 3)
    table = params["embed"]["table"]          # a step reads B rows of it
    read_gb = gb - table.numel() * table.element_size() / 1e9
    # the products of the prefill: the layers over every position, the
    # untied head over the token positions only, and the attention's
    # scores and values over all (s x s, as computed)
    s_all, head = PREFIX + PROMPT, params["embed"]["head"].numel()
    pre_flop = (2.0 * (n_params - table.numel() - head) * BATCH * s_all
                + 2.0 * head * BATCH * PROMPT
                + 4.0 * cfg.n_layers * BATCH * s_all ** 2 * cfg.n_heads
                * cfg.head_dim)
    serve.update(prefill_ms=pre_ms, prefill_host_ms=reading["host_ms"],
                 prefill_host_ms_all=reading["host_ms_all"],
                 prefill_device_ms=pre_dev,
                 prefill_device_ops=pre_ops, prefill_matmul_flop=pre_flop,
                 decode_step_device_ms=step_dev,
                 decode_step_device_ops=step_ops,
                 decode_step_weight_gb=read_gb,
                 decode_step_bound_ms=read_gb * 1e12 / HBM_BYTES_PER_S)
    print(f"internvl: prefill of {BATCH} x ({PREFIX} + {PROMPT}) {pre_ms:.2f}"
          f" ms (host {reading['host_ms']:.2f} until the eager call returns,"
          f" {pre_dev:.2f} device, {pre_ops:.0f} device ops; "
          f"{pre_flop / 1e12:.1f} TFLOP of products, "
          f"{pre_flop / BF16_FLOP_PER_S * 1e3:.2f} ms at "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s); a decode step "
          f"{step_dev:.3f} ms device ({step_ops:.0f} device ops), host "
          f"median {serve['decode_step_ms_median_no_wire']:.3f} ms; weights "
          f"a step reads {read_gb:.2f} GB, "
          f"{serve['decode_step_bound_ms']:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s [{card}]")
    rec["serve"] = serve
    del params, caches, table, pfx, prompts, seq
    torch.cuda.empty_cache()

    # ---- the reduced config: one step on the card and one on the CPU in
    # bf16 (a 16-patch prefix), held to STEP_TOL
    rec["reduced_card_vs_cpu"] = reduced_step_card_vs_cpu(
        torch, dev, cfg.reduced(), "internvl", card)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


def hubert_phase(torch, dev, card, build):
    """Phase 14: ``hubert-xlarge`` at full width and full depth (see the
    module docstring): a forward over frame embeddings with its logits
    planes coded and decoded, then training.  Returns the record and the
    launch counts of the coding path and of the train path."""
    from repro_torch.comm.compression import histogram256
    from repro_torch.configs import get_config, train_grad_accum
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import (chunk_counts_for, decode_chunked,
                                          encode_chunked)
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.models import forward, model_init, param_count

    t_phase = time.perf_counter()
    cfg = get_config("hubert-xlarge")
    need(cfg.prefix_only and not cfg.causal, "hubert: not a bidirectional "
         "encoder over frame embeddings")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
    n_params = param_count(params)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"hubert-xlarge at full width and depth ({cfg.n_layers} "
          f"bidirectional attn layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}): {n_params / 1e9:.4f} B parameters; init peak "
          f"{init_peak:.2f} GB [{card}]")

    def frames():               # seeded frame embeddings, float32
        return torch.randn((HUBERT_BATCH, HUBERT_SEQ, cfg.d_model),
                           generator=gen, device=dev)

    # ---- books from a warm-up forward's logits (B5)
    with torch.no_grad():
        wl = forward(params, {"prefix_embeds": frames()}, cfg)
    need(wl.shape == (HUBERT_BATCH, HUBERT_SEQ, cfg.vocab_size),
         f"hubert: logits {tuple(wl.shape)}")
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(
                 wl.to(torch.bfloat16)).items()}
    del wl
    x = frames()

    # ---- the coding path: one forward, each logits plane through B1 ->
    # B2 and B4; launch counts reset just before, read just after
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = forward(params, {"prefix_embeds": x}, cfg)
        planes = SCHEMES["bf16"].to_symbols(logits.to(torch.bfloat16))
        coded = {}
        for p, sym in planes.items():
            stream = encode_chunked(sym, books[p], chunk=CHUNK, device=dev)
            coded[p] = (stream, histogram256(sym),
                        decode_chunked(stream, books[p], backend="multisym"))
    torch.cuda.synchronize()
    code_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym"):
        need(launches[k] > 0, f"hubert: kernel {k} was not launched")
    n_sym = HUBERT_BATCH * HUBERT_SEQ * cfg.vocab_size
    n_chunks = len(chunk_counts_for(n_sym, CHUNK))
    need(bool(torch.isfinite(logits.float()).all()), "hubert: logits not "
         "finite")
    bits = {}
    for p, (stream, hist, dec) in coded.items():
        need(stream.n_chunks == n_chunks and stream.n_symbols == n_sym,
             f"hubert {p}: {stream.n_chunks} chunks of {stream.n_symbols}")
        need(torch.equal(dec, planes[p]), f"hubert {p}: the decode is not "
             f"lossless")
        b2 = int(stream.block_bits.to(torch.int64).sum())
        b5 = int((hist * torch.from_numpy(books[p].lengths).to(
            dev, torch.int64)).sum())
        need(b2 == b5, f"hubert {p}: B2 bits {b2} != histogram . lengths "
             f"{b5}")
        bits[p] = b2
    # the kernels at this plane, and the main path's stream and decode,
    # against their plain versions (uncounted launches)
    t0 = time.perf_counter()
    for p, (stream, _, dec) in coded.items():
        codec_held_to_plain(torch, f"hubert {p}", planes[p], books[p], CHUNK,
                            stream=stream, decoded=dec)
    held_s = time.perf_counter() - t0
    coded_over_raw = sum(bits.values()) / (16.0 * n_sym)
    rec = {"model": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "init_peak_memory_gb": init_peak, "card": card,
           "code": {"symbols_a_plane": n_sym, "chunks_a_plane": n_chunks,
                    "coded_bits": bits, "coded_over_raw": coded_over_raw,
                    "seconds": code_s, "kernels_vs_plain_s": held_s,
                    "launches": launches}}
    print(f"hubert: one forward of {HUBERT_BATCH} x {HUBERT_SEQ} frames, its "
          f"logits planes ({n_sym} symbols, {n_chunks} chunks each) coded "
          f"and decoded losslessly, B2 bits = B5 . lengths; coded/raw "
          f"{coded_over_raw:.4f}; {code_s:.2f} s; B1/B2/B4, the stream and "
          f"the decode equal to the plain versions ({held_s:.2f} s) "
          f"[{card}]")
    del logits, planes, coded, x

    # ---- train at full width (phase 7's path and checks)
    ga = train_grad_accum(cfg.name)
    trained, train_launches = train_phase(
        torch, dev, params, cfg, card, build, batch=HUBERT_BATCH,
        seq=HUBERT_SEQ, refresh=HUBERT_REFRESH, grad_accum=ga)
    print_train(trained, card)
    rec["train"] = trained
    rec["seconds"] = time.perf_counter() - t_phase
    del params
    return rec, launches, train_launches


def stats_phase(torch, dev, card, build):
    """Phase 15: the paper's per-shard statistics and its two encoders
    on gemma2-2b's w_gate stack (see the module docstring).  Returns the
    record and the path's launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import (encoded_size_bits, per_shard_report,
                                  shard_histograms, single_stage_encode,
                                  three_stage_encode)
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.entropy import shannon_entropy
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.kernels.histogram import histogram256
    from repro_torch.models import model_init

    t_phase = time.perf_counter()
    cfg = get_config("gemma2-2b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        w = model_init(cfg, gen, device=dev)["groups"][0][0]["ffn"]["w_gate"]
    torch.cuda.empty_cache()
    layers, rows, cols = w.shape
    n_shards = layers * STATS_SHARDS
    scheme = SCHEMES["bf16"]

    # ---- the path: every shard's histograms (B5 a shard and plane), the
    # two encoders on w_gate[0]'s hi plane; launch counts reset just
    # before, read just after
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    hists = shard_histograms(w, scheme, STATS_SHARDS, layer_axis_len=layers)
    shard_s = time.perf_counter() - t0
    hi = bf16_planes(w[0])["hi"]
    res3, book, stages = three_stage_encode(hi, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = single_stage_encode(hi, book, device=dev)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for k in ("encode_lookup", "pack_blocks", "histogram256"):
        need(launches[k] > 0, f"stats: kernel {k} was not launched")
    need(launches["histogram256"] >= 2 * n_shards, f"stats: "
         f"{launches['histogram256']} B5 launches for {n_shards} shards")

    # ---- every shard's histograms against a plain count of the same
    # split, made another way: each layer's rows cut into 64 column tiles,
    # (shard, symbol) pairs counted by scatter-add
    tile = cols // STATS_SHARDS
    shard_of = torch.arange(STATS_SHARDS, device=dev).repeat_interleave(
        rows * tile) * 256
    plain = {p: [] for p in scheme.planes}
    for li in range(layers):
        t = w[li].reshape(rows, STATS_SHARDS, tile).transpose(0, 1)
        for p, sym in bf16_planes(t).items():
            idx = shard_of + sym.to(torch.int64)
            plain[p].append(torch.zeros(
                STATS_SHARDS * 256, dtype=torch.int64, device=dev
            ).scatter_add_(0, idx, torch.ones_like(idx)).reshape(
                STATS_SHARDS, 256))
    del shard_of, idx
    for p in scheme.planes:
        want = torch.cat(plain[p]).cpu().numpy()
        need(hists[p].shape == (n_shards, 256) and hists[p].dtype == np.int64,
             f"stats {p}: histograms {hists[p].shape} {hists[p].dtype}")
        bad = int((hists[p] != want).any(axis=1).sum())
        need(bad == 0, f"stats {p}: {bad} of {n_shards} shard histograms "
             f"differ from the plain count")
        need(int(hists[p].sum()) == w.numel(), f"stats {p}: "
             f"{int(hists[p].sum())} symbols counted of {w.numel()}")

    # ---- the per-shard report (host): means over the 1152 shards
    t0 = time.perf_counter()
    report = {}
    for p in scheme.planes:
        avg = build_codebook(hists[p].sum(axis=0))
        r = per_shard_report(hists[p], avg.lengths)
        report[p] = {k: float(v.mean()) for k, v in r.items()}
        report[p]["per_shard_minus_fixed"] = float(
            (r["per_shard_huffman"] - r["fixed_codebook"]).mean())
        report[p]["ideal_minus_fixed"] = float(
            (r["ideal"] - r["fixed_codebook"]).mean())
    report_s = time.perf_counter() - t0
    for p, r in report.items():
        print(f"stats {p}: per_shard_report means over {n_shards} shards "
              f"({layers} layers x {STATS_SHARDS}): ideal {r['ideal']:.4f}, "
              f"per-shard Huffman {r['per_shard_huffman']:.4f}, fixed "
              f"codebook {r['fixed_codebook']:.4f}, per-shard - fixed "
              f"{r['per_shard_minus_fixed']:.4f}, ideal - fixed "
              f"{r['ideal_minus_fixed']:.4f}, KL {r['kl_from_avg']:.3e} "
              f"bits (random weights, report only) [{card}]")

    # ---- the two encoders: with the plane's own book, equal words and
    # bits; the bits = B5 . lengths
    n_bits = int(res3.n_bits)
    need(torch.equal(res1.words, res3.words) and int(res1.n_bits) == n_bits,
         "stats: the single stage's words differ from the three stages'")
    ledger = int(encoded_size_bits(histogram256(hi), book.lengths))
    need(ledger == n_bits, f"stats: encoded bits {n_bits} != B5 . lengths "
         f"{ledger}")
    need(stages["wire_bits"] == n_bits + 8 * 256, f"stats: wire_bits "
         f"{stages['wire_bits']}")
    enc = {"symbols": hi.numel(), "n_bits": n_bits,
           "coded_over_raw": n_bits / (8.0 * hi.numel()),
           "wire_bits": stages["wire_bits"],
           "three_stage_s": {k: v for k, v in stages.items()
                             if k.endswith("_s")},
           "single_stage_s": single_s,
           "single_stage_ms": cuda_ms(torch, lambda: single_stage_encode(
               hi, book, device=dev).words, 3)}
    print(f"stats: w_gate[0] hi plane ({hi.numel()} symbols): three stages "
          + ", ".join(f"{k} {v:.4f}" for k, v in enc["three_stage_s"].items())
          + f" s; single stage {single_s:.4f} s ({enc['single_stage_ms']:.3f}"
          f" ms, events over 3 calls); words and {n_bits} bits equal "
          f"(coded/raw {enc['coded_over_raw']:.4f}); wire bits three "
          f"stages {stages['wire_bits']} [{card}]")

    # ---- each scheme's planes of seeded tensors on the card against the
    # plain (CPU) split of the same values
    x = torch.randn(1 << 20, generator=gen, device=dev) * 0.05
    x[:8] = torch.tensor([float("nan"), -float("nan"), float("inf"),
                          -float("inf"), 0.0, -0.0, 470.0, 1e-40], device=dev)
    schemes = {}
    for name, sch in SCHEMES.items():
        got = sch.to_symbols(x)
        want = sch.to_symbols(x.cpu())
        for p in sch.planes:
            need(torch.equal(got[p].cpu(), want[p]), f"stats: scheme {name} "
                 f"plane {p} on the card differs from the CPU's")
        schemes[name] = {p: float(shannon_entropy(
            histogram256(got[p]).cpu().numpy()[:sch.n_symbols]))
            for p in sch.planes}
    print("stats: the seven schemes' planes of 2^20 seeded values (with "
          "the specials) equal on the card and the CPU; entropy bits a "
          "symbol: " + "; ".join(
              f"{n} " + ", ".join(f"{p} {v:.3f}" for p, v in e.items())
              for n, e in schemes.items()) + f" [{card}]")
    rec = {"model": cfg.name, "tensor": "w_gate", "shape": [layers, rows, cols],
           "shards": n_shards, "shard_histograms_s": shard_s,
           "report": report, "report_s": report_s, "encoders": enc,
           "scheme_entropy_bits": schemes, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    del w, hi
    torch.cuda.empty_cache()
    return rec, launches


# ------------------------------------------ examples and the roofline (16)
SFT_ARGS = ["--steps", "100", "--rebuild-every", "25"]
# a measured step against its analytic bound: a share past this means
# the count is wrong (the bound is the least time the work can take)
SHARE_LIMIT = 1.05


def examples_phase(torch, dev, card, build, measured: dict):
    """Phase 16: the three examples' ``main`` on the card (launch counts
    reset just before and read just after), then ``one_card_bound`` of
    each step the script timed (``measured``: name -> (config, kind,
    sequence or cache slots, batch, grad_accum, device ms)) beside its
    device ms.  Returns the record and the examples' launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.examples import (quickstart, serve_compressed,
                                      train_sft_compressed)
    from repro_torch.launch.dryrun import one_card_bound

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    build.reset_launches()
    qs = quickstart.main([], device=dev)
    sv = serve_compressed.main([], device=dev)
    sft = train_sft_compressed.main(SFT_ARGS, device=dev)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    ex_s = time.perf_counter() - t_phase
    for p, r in qs["planes"].items():
        need(r["lossless"] and r["coded_bits"] == r["histogram_dot_lengths"],
             f"quickstart {p}: lossless {r['lossless']}, coded bits "
             f"{r['coded_bits']} vs B5 . lengths {r['histogram_dot_lengths']}")
    g = sv["gather"]
    need(g["bitexact"] and g["coded_bits"] == 8 * g["histogram_dot_lengths"],
         f"serve_compressed gather: bit-exact {g['bitexact']}, coded bits "
         f"{g['coded_bits']} vs 8 x B5 . lengths {g['histogram_dot_lengths']}")
    need(sv["ring"]["finite"] and sv["ring"]["ranks_agree"],
         f"serve_compressed ring: {sv['ring']}")
    losses = sft["losses"]
    need(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
         f"sft: the loss did not fall ({losses[0]} -> {losses[-1]})")
    first = sft["rebuilds"][0]
    need(first["coded_over_raw_after"] < first["coded_over_raw_before"],
         f"sft: the first rebuild did not code the gradients smaller "
         f"({first})")
    for k in ("encode_lookup", "pack_blocks", "decode_chunks_canonical",
              "decode_chunks_multisym", "histogram256"):
        need(launches[k] > 0, f"examples: kernel {k} was not launched")
    print(f"examples: quickstart fixed {qs['fixed_compressibility']:.4f} vs "
          f"three-stage {qs['oracle_compressibility']:.4f}; serve gather "
          f"coded/raw {g['coded_bits'] / g['raw_bits']:.4f}, ring "
          f"{sv['ring']['hops']} hops; sft {sft['params']:,} params, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {sft['steps']} steps in "
          f"{sft['seconds']:.1f} s, rebuild at step {first['step']}: "
          f"gradient coded/raw {first['coded_over_raw_before']:.4f} -> "
          f"{first['coded_over_raw_after']:.4f}; launches {launches}; "
          f"{ex_s:.1f} s [{card}]")

    roof = {}
    for name, (arch, kind, seq, batch, ga, dev_ms) in measured.items():
        b = one_card_bound(get_config(arch), kind=kind, seq_len=seq,
                           global_batch=batch, grad_accum=ga)
        share = b["bound_s"] * 1e3 / dev_ms
        roof[name] = {"arch": arch, "kind": kind, "seq_len": seq,
                      "batch": batch, "grad_accum": ga,
                      "compute_ms": b["analytic_compute_s"] * 1e3,
                      "memory_ms": b["analytic_memory_s"] * 1e3,
                      "bound_ms": b["bound_s"] * 1e3,
                      "bound_by": ("compute" if b["analytic_compute_s"]
                                   >= b["analytic_memory_s"] else "memory"),
                      "device_ms": dev_ms, "share": share,
                      "analytic_flops": b["analytic_flops"],
                      "analytic_bytes": b["analytic_bytes"]}
        print(f"roofline {name}: bound {b['bound_s'] * 1e3:.3f} ms "
              f"({roof[name]['bound_by']}: compute "
              f"{roof[name]['compute_ms']:.3f}, memory "
              f"{roof[name]['memory_ms']:.3f}) vs {dev_ms:.3f} ms device, "
              f"share {share:.4f} [{card}]")
        need(share <= SHARE_LIMIT, f"roofline {name}: the measured step "
             f"takes {share:.4f} of its analytic bound's time, past "
             f"{SHARE_LIMIT}: the count is wrong")
    rec = {"quickstart": qs, "serve_compressed": {
               k: v for k, v in sv.items() if k != "first_request"},
           "sft": {k: v for k, v in sft.items()
                   if k not in ("losses", "coded_over_raw")},
           "sft_losses_first_last": [losses[0], losses[-1]],
           "examples_s": ex_s, "roofline": roof,
           "seconds": time.perf_counter() - t_phase}
    return rec, launches


# -------------------------------- mamba2-780m trained at full width (17)
MAMBA_SEQ = 4096              # train_4k's sequence: one dp_only device's
MAMBA_STEPS = 3               # share of its 256 x 4096 is 1 x 4096
MAMBA_CHUNKS = (64, 128, 256)  # the hillclimb's SSD chunk iterations


def mamba_train_phase(torch, dev, card, build):
    """Phase 17: ``mamba2-780m`` trained at full width and full depth at
    1 x 4096 (see the module docstring), beside the hillclimb's plan of
    the pair.  Returns the record and the main path's launch counts."""
    import tempfile
    from dataclasses import replace
    from repro_torch.configs import get_config, train_grad_accum
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch import hillclimb
    from repro_torch.launch.dryrun import one_card_bound
    from repro_torch.launch.train import train
    from repro_torch.models import model_init, param_count
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.perf_log_md import perf_log
    from repro_torch.train.step import loss_and_grads, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("mamba2-780m")
    need(train_grad_accum(cfg.name) == 1 and cfg.remat == "block",
         "mamba2: not TRAIN_GRAD_ACCUM 1 with block remat")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
    n_params = param_count(params)
    need(n_params == 779_989_248, f"mamba2: {n_params} params")

    # ---- the main path: launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    run = train(cfg, steps=MAMBA_STEPS, batch_size=1, seq_len=MAMBA_SEQ,
                lr=TRAIN_LR, compress=True, refresh_every=0, seed=SEED,
                device=dev, params=params)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    del params
    steps = run["steps"]
    print(f"mamba2-780m train main path: {run['seconds']:.1f} s, launches "
          f"{launches} [{card}]")
    need(all(math.isfinite(s["loss"]) for s in steps),
         f"mamba2 train: a loss is not finite: {[s['loss'] for s in steps]}")
    need(all(s["grad_raw_bits"] == 16.0 * n_params for s in steps),
         f"mamba2 train: grad_raw_bits != 16 x {n_params} params")
    need(launches["histogram256"] > 0,
         "mamba2 train: kernel B5 was not launched")
    parts_s = {"init_and_main_path": time.perf_counter() - t_phase}

    # ---- one step's gradients: B5 against plain on every leaf and
    # plane, the probe's coded bits against hist . lengths
    spec = run["lifecycle"].spec("grad", "bf16")
    state = run["state"]
    data = {k: torch.from_numpy(v).to(dev) for k, v in next(SyntheticDataset(
        cfg, DataConfig(1, MAMBA_SEQ, seed=SEED + 1))).items()}
    grads = loss_and_grads(state.params, data, cfg)[2]
    grads_held_to_plain(torch, dev, grads, spec, "mamba2 train")
    del grads
    parts_s["grad_check"] = time.perf_counter() - t_phase - sum(
        parts_s.values())

    # ---- the hillclimb's plan of the pair, on the meta device
    with tempfile.TemporaryDirectory() as tmp:
        plans = {r["iteration"]: r for r in hillclimb.main(
            ["--pair", "mamba2", "--out", str(Path(tmp) / "hc.json")])}
    print(perf_log(list(plans.values())))
    bound = one_card_bound(cfg, kind="train", seq_len=MAMBA_SEQ,
                           global_batch=1)
    dp = plans["dp_only"]
    need(all(math.isclose(dp[k], bound[k], rel_tol=1e-12) for k in (
        "analytic_compute_s", "analytic_memory_s")),
         "mamba2: the dp_only device's plan is not one card's step")
    parts_s["hillclimb"] = time.perf_counter() - t_phase - sum(
        parts_s.values())

    # ---- the repeated batch: 4 steps at a tenth of the peak lr, the loss
    # must fall; the last three under the profiler (device events), one
    # at each SSD chunk the hillclimb tries (the same function, rounded
    # at other points)
    steps_at = {q: make_train_step(replace(cfg, ssm_chunk=q), AdamWConfig(
        lr=TRAIN_LR / 10), comp_spec=spec) for q in MAMBA_CHUNKS}
    box = {"state": state}
    del state, run

    def one(q):
        box["state"], m = steps_at[q](box["state"], data)
        return float(m["loss"])

    losses = [one(cfg.ssm_chunk)]
    chunks = {}
    for q in sorted(MAMBA_CHUNKS, key=lambda q: q != cfg.ssm_chunk):
        out, pq = steps_profile(torch, lambda: one(q), 1)
        losses += out
        it = plans["baseline(chunk=128)" if q == 128 else f"chunk={q}"]
        chunks[q] = {"device_ms": pq["device_busy_ms_per_step"],
                     "wall_ms": pq["wall_ms_per_step"],
                     "idle_share": pq["idle_share"],
                     "b5_ms": sum(v for k, v in pq[
                         "port_kernels_ms_per_step"].items() if "hist" in k),
                     "top_kernels_ms": pq["top_kernels_ms_per_step"],
                     "plan_compute_ms": it["analytic_compute_s"] * 1e3,
                     "plan_memory_ms": it["analytic_memory_s"] * 1e3,
                     "plan_collective_ms": it["collective_s"] * 1e3,
                     "plan_step_ms": it["roofline_step_s"] * 1e3}
        print(f"mamba2 ssm_chunk {q}: {chunks[q]['device_ms']:.3f} ms "
              f"device, {chunks[q]['wall_ms']:.3f} ms wall a step; plan "
              f"(16 x 16, tp) compute {chunks[q]['plan_compute_ms']:.3f} "
              f"memory {chunks[q]['plan_memory_ms']:.3f} collective "
              f"{chunks[q]['plan_collective_ms']:.3f} ms [{card}]")
    need(losses[-1] < losses[0] and all(map(math.isfinite, losses)),
         f"mamba2 train: the loss on a repeated batch did not fall: "
         f"{losses}")
    parts_s["repeated_batch"] = time.perf_counter() - t_phase - sum(
        parts_s.values())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del box, steps_at, data
    torch.cuda.empty_cache()

    base = chunks[cfg.ssm_chunk]
    dev_ms = base["device_ms"]
    share = bound["bound_s"] * 1e3 / dev_ms
    secs = sorted(s["step_seconds"] for s in steps)
    med = secs[len(secs) // 2]
    rec = {
        "model": cfg.name, "params": n_params, "batch": 1,
        "seq_len": MAMBA_SEQ, "grad_accum": 1, "steps": MAMBA_STEPS,
        "lr": TRAIN_LR, "losses": [s["loss"] for s in steps],
        "step_ms_median": med * 1e3, "step_ms_all": [x * 1e3 for x in secs],
        "tokens_per_s": MAMBA_SEQ / med,
        "repeated_batch_lr": TRAIN_LR / 10, "repeated_batch_losses": losses,
        "device_ms": dev_ms, "idle_share": base["idle_share"],
        "peak_memory_gb": peak_gb,
        "bound_ms": bound["bound_s"] * 1e3,
        "bound_compute_ms": bound["analytic_compute_s"] * 1e3,
        "bound_memory_ms": bound["analytic_memory_s"] * 1e3,
        "share": share, "ssm_chunks": chunks,
        "plan_dp_only": {k: dp[k] for k in (
            "analytic_compute_s", "analytic_memory_s", "collective_s",
            "roofline_step_s", "bottleneck")},
        "parts_s": parts_s, "seconds": time.perf_counter() - t_phase}
    print(f"mamba2-780m train at 1 x {MAMBA_SEQ}: host median "
          f"{med * 1e3:.1f} ms a step, device {dev_ms:.3f} ms, idle share "
          f"{base['idle_share']:.4f}, peak {peak_gb:.2f} GB; bound "
          f"{rec['bound_ms']:.3f} ms (compute {rec['bound_compute_ms']:.3f}, "
          f"memory {rec['bound_memory_ms']:.3f}), share {share:.4f}; "
          f"losses {losses}; {rec['seconds']:.1f} s ({parts_s}) [{card}]")
    need(share <= SHARE_LIMIT, f"mamba2 train: the measured step takes "
         f"{share:.4f} of its analytic bound's time, past {SHARE_LIMIT}: "
         f"the count is wrong")
    return rec, launches


def routing_flips(torch, dev, rcfg, card) -> dict:
    """The reduced DeepSeek's bf16 train step, card vs CPU, read three
    ways (report only): the routing flips between the two devices' bf16
    forwards (a token whose top-k expert set differs in any MoE layer),
    the step deviation with the flipped tokens masked out of the loss,
    and the first op of the forward past a bf16 ulp
    (``first_divergence``)."""
    import numpy as np

    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models import forward_train, model_init, moe
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (STEP_TOL, make_train_step,
                                        step_deviation, train_state_init)

    rparams = model_init(rcfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    rbatch = {k: torch.from_numpy(v) for k, v in next(SyntheticDataset(
        rcfg, DataConfig(TRAIN_BATCH, 32, seed=SEED))).items()}
    routes = {}
    inner = moe._route_probs

    def taped(params, xf, cfg):
        out = inner(params, xf, cfg)
        routes[where].append(out[1].sort(-1).values.cpu())
        return out

    moe._route_probs = taped
    try:
        for where in ("cpu", dev):
            routes[where] = []
            p = tree_map(lambda t: t.to(where), rparams)
            with torch.no_grad():
                forward_train(p, {k: v.to(where) for k, v in rbatch.items()},
                              rcfg)
    finally:
        moe._route_probs = inner
    flips = torch.zeros(rbatch["labels"].shape, dtype=torch.bool)
    for a, b in zip(routes["cpu"], routes[dev]):
        flips |= (a != b).any(-1).reshape(flips.shape)
    n_flips = int(flips.sum())

    def deviation(batch):
        step = make_train_step(rcfg, AdamWConfig(lr=TRAIN_LR))
        got = {}
        for where in ("cpu", dev):
            st = train_state_init(tree_map(lambda t: t.to(where), rparams))
            new, m = step(st, {k: v.to(where) for k, v in batch.items()})
            got[str(where)] = {"loss": float(m["loss"]),
                               "grad_norm": float(m["grad_norm"]),
                               "params": tree_map(lambda t: t.cpu(),
                                                  new.params)}
        return step_deviation(got[str(dev)], got["cpu"], TRAIN_LR)

    masked = dict(rbatch, loss_mask=(~flips).to(torch.float32))
    dev_masked = deviation(masked)
    within = all(v <= STEP_TOL[k] for k, v in dev_masked.items())
    first = first_divergence(torch, dev, rcfg)
    rec = {"tokens": flips.numel(), "flipped_tokens": n_flips,
           "flipped_at": np.argwhere(flips.numpy()).tolist()[:16],
           "masked_deviation": dev_masked, "masked_within_step_tol": within,
           "first_divergence": first}
    print(f"deepseek reduced bf16: {n_flips} of {flips.numel()} tokens "
          f"route to other experts on the card than on the CPU; the step "
          f"with them masked out of the loss, card vs CPU: {dev_masked}, "
          f"within STEP_TOL: {within}; first op past a bf16 ulp: "
          f"{first['first_beyond_ulp']} [{card}]")
    return rec


def print_train(trained, card) -> None:
    """The train record's summary lines (phases 7 and 14)."""
    p = trained["profile"]
    print(f"{trained['model']} train step: {trained['step_ms_median']:.1f} ms "
          f"host-clock median of {TRAIN_STEPS} ({trained['batch']} x "
          f"{trained['seq_len']}, grad_accum {trained['grad_accum']}), "
          f"{trained['tokens_per_s']:.0f} tokens/s; "
          f"device {p['device_busy_ms_per_step']:.2f} ms a step, idle share "
          f"{p['idle_share']:.4f} (profiler, {p['steps']} steps), B5 "
          f"{trained['b5_device_ms_per_step']:.4f} ms a step "
          f"({100 * trained['b5_share_of_device']:.2f} % of device); "
          f"gradient coded/raw {trained['grad_coded_over_raw_bootstrap']:.4f}"
          f" (bootstrap books) -> "
          f"{trained['grad_coded_over_raw_refreshed']:.4f} (epoch "
          f"{trained['refreshed_epoch']}); refresh host s "
          f"{[round(r['seconds'], 4) for r in trained['refreshes']]}; "
          f"peak memory {trained['peak_memory_gb']:.2f} GB; host syncs "
          f"in a step {trained['host_syncs_a_step']} "
          f"{trained['host_sync_sites']} [{card}]")
    for k, r in trained["parts"].items():
        print(f"  train step part {k}: {r['wall_ms_per_step']:.2f} ms wall, "
              f"{r['device_busy_ms_per_step']:.2f} ms device, idle share "
              f"{r['idle_share']:.4f} (profiler, 2 calls) [{card}]")


def reduced_step_card_vs_cpu(torch, dev, rcfg, what: str, card,
                             gate: bool = True) -> dict:
    """One train step of the reduced config ``rcfg`` from seed-0 params
    on a synthetic batch, on the card and on the CPU (the plain path):
    every reading of ``step_deviation`` within ``STEP_TOL`` (only
    printed, not required, when ``gate`` is false)."""
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models import model_init
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (STEP_TOL, make_train_step,
                                        step_deviation, train_state_init)

    rparams = model_init(rcfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    rbatch = next(SyntheticDataset(rcfg, DataConfig(TRAIN_BATCH, 32,
                                                    seed=SEED)))
    step = make_train_step(rcfg, AdamWConfig(lr=TRAIN_LR))
    out = {}
    for where in ("cpu", dev):
        st = train_state_init(tree_map(lambda t: t.to(where), rparams))
        new, m = step(st, {k: torch.from_numpy(v).to(where)
                           for k, v in rbatch.items()})
        out[str(where)] = (tree_map(lambda t: t.cpu(), new.params),
                           float(m["loss"]), float(m["grad_norm"]))
    (pc, lc, gc), (pd, ld, gd) = out["cpu"], out[str(dev)]
    card_vs_cpu = step_deviation({"loss": ld, "grad_norm": gd, "params": pd},
                                 {"loss": lc, "grad_norm": gc, "params": pc},
                                 TRAIN_LR)
    within = all(v <= STEP_TOL[k] for k, v in card_vs_cpu.items())
    need(within or not gate, f"{what}: reduced step, card vs CPU beyond "
         f"STEP_TOL: {card_vs_cpu}")
    print(f"{what} reduced step ({str(rcfg.dtype).split('.')[-1]}), card "
          f"vs CPU: {card_vs_cpu}, within STEP_TOL: {within} [{card}]")
    return {"dtype": str(rcfg.dtype).split(".")[-1], "loss": [ld, lc],
            "grad_norm": [gd, gc], "deviation": card_vs_cpu,
            "within_step_tol": within}


def tree_map_names(tree, prefix=""):
    """The tree with each leaf replaced by its path ("a/b/0/c")."""
    if isinstance(tree, dict):
        return {k: tree_map_names(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_names(v, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return prefix


def max_rel_diff(torch, a, b, block: int = 1 << 26) -> float:
    """max |a - b| / max |b| in float32, a block of elements at a time
    (a full-width expert gradient is 5.4 GB in bf16)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    diff = top = 0.0
    for i in range(0, fa.numel(), block):
        x, y = fa[i:i + block].float(), fb[i:i + block].float()
        diff = max(diff, float((x - y).abs().max()))
        top = max(top, float(y.abs().max()))
    return diff / top


def b_decode(book, words, sym):
    """A monolithic stream's decode through the book's codec (B4 for a
    Huffman book, B6 for QLC)."""
    from repro_torch.core.encoder import decode_with_book
    return decode_with_book(words, book, sym.numel())


def histogram_np(torch, sym):
    """A plane's 256-bin counts as numpy (B5 on the card)."""
    from repro_torch.comm.compression import histogram256
    return histogram256(sym).cpu().numpy()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
