#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: name and power limit (``nvidia-smi``); build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for sm_90a, one process per
   source, all at once, beside the design sweeps ``tools/staging_sweep.cu``
   and ``tools/combine_sweep.cu`` (built from the same sources into
   ``build/``, not run); calibrate the per-transfer and per-launch times
   the H100 cost profile quotes; then fit the cost model's link class
   (``calibrate_link_classes``) on one emulated point-to-point transfer at
   7 sizes from 1 KiB to 256 MiB, and ``calibrate_t_launch`` on a table in
   the reference's compile-table format filled with compiled replays of
   1 MiB a rank (3 (op, algo) groups x 4 chunk counts, written to
   ``build/compile_table_h100.json``), each printed beside ``H100_SXM``'s
   unchanged constants.
2. kernels, each held bit for bit against its plain PyTorch version, with
   CUDA-event times, the bound (bytes / 3.35 TB/s), the plain version's time
   and a one-call PyTorch yardstick where one exists: the merge and the copy
   at the serving path's shapes (both also at every source/destination
   offset mod 16 at odd widths: the copy one kernel a call and timed with
   its source 2 bytes off, the merge with KEEP rows' -0.0 and NaN payloads
   and the bytes around the buffer unwritten, timed beside
   ``index_copy_``/``index_add_`` at the same rows), the quantize pair at
   the training path's hop shape (the dequantize also at every row offset
   mod 4 floats, and timed as the hop calls it, through ``rows=`` into the
   receive view), the merge again at the training path's rounds (each
   class's first and steady round), and both
   in-kernel replays, the device-initiated one (rank groups sized by the
   rows each rank moves, direct puts, point-to-point flags) and the
   shared-buffer one (grid barrier), against each other and the numpy
   simulator, at small shapes over every builder (every source/destination
   misalignment mod 16 bytes on a direct put) and at the six path plans,
   beside the compiled executor's replay of the same plan; both
   flash attention kernels, the CUDA-core
   one (head widths 16-128 and 256) and the sm90 one (bf16 wgmma + TMA,
   head widths 64, 128 and 256, which must refuse widths 16 and 32), which sum in
   another order (f32 within the reference test's 2e-4, bf16 within one
   bf16 rounding of the plain version's f32 result), at the reference's
   cases, at phase 4c's layer shapes, at phase 4d's (a paligemma-3b
   layer: head width 256, a prefix of 256 under query tiles of 256) and at
   phase 12a's (a hymba-1.5b layer: 25 / 5 heads of 64, window 1024: both
   kernels timed, the sm90 one with its TFLOP/s and its share of the
   bound) and at phase 13b's (a qwen1.5-32b layer: 40 / 40 heads of 128,
   causal and global: a group of 1), with
   the flops bound and one scaled_dot_product_attention call (its kernel
   named) as yardstick; mix and scaled_add (on no path of either package)
   at the embedding's flat size.
3. serving, default policy: minitron-8b at full width (8 of 32 layers,
   bf16, seeded random weights) on an emulated data axis of 4 ranks;
   ``Engine(distribute=True, double_buffer=True)`` broadcasts the weights,
   then ``generate`` serves batch 4, prompt 128, 32 decode steps; a warm
   re-run of the same loop times prefill and the decode steps apart.
4. compiled replay: the same weights broadcast again from NaN-filled
   replicas with the pinned pipelined chain and the compiled executor.
4b. tuned in-kernel replay: a tuner table built on the card (each serving
   bucket's analytic plan, timed as one in-kernel replay, recorded with
   ``exec_path='inkernel'``, saved, loaded), then
   ``distribute_weights(tuner=...)`` from NaN-filled replicas: replicas
   bit-equal to phase 3's, one device-initiated in-kernel launch per bucket
   plan, no merge launches and none of the shared-buffer replay.
4c. long-context serving: gemma3-27b at full width (6 of 62 layers, one
   whole 5 local : 1 global period, bf16, seeded random weights) broadcast
   to 4 emulated ranks, staged through chunked_copy, then ``generate`` of one 4096-token
   prompt per rank and 32 decode steps, then the warm re-run: every
   layer's prefill goes through the sm90 flash kernel (24 launches a
   pass, none of the CUDA-core one); the local layers decode from rings
   of 1024. Then one prefill per rank under ``torch.profiler`` (device
   time by kernel, busy share).
4d. vision-prefix serving: paligemma-3b at full width and depth (18
   layers, bf16, seeded random weights) broadcast to 4 emulated ranks,
   staged through chunked_copy, then ``generate`` of one request per rank
   (256 stub patch embeddings from the port's ``batches`` + 3840 text
   tokens: 4096 positions) and 32 decode steps, then the warm re-run:
   every layer's prefill (bf16, head width 256) goes through the sm90
   flash kernel with the prefix-LM mask (18 launches a pass, none of the
   CUDA-core one). Then one prefill per rank under ``torch.profiler``.
5. small-input references: the port's f32 smoke model on the card against
   the same model on the CPU, gemma3-27b-smoke (window 64) in f32 at a
   4096-token prompt, and paligemma-3b-smoke widened to head width 256 and
   a prefix of 256 in f32 at 256 patches + 3840 tokens: the card's
   CUDA-core flash kernel (the f32 route) against the CPU's plain version.
6. training: minitron-8b at full width (1 of 32 layers, bf16, seeded
   weights) on 4 emulated data ranks, global batch 8 x 512 tokens, 3 steps
   in each sync mode from the same weights and batches: grad_allreduce,
   param_bcast, param_bcast with ``bcast_algo='ring_allreduce'`` (the
   explicit ring of ``core.algorithms`` per gradient leaf: no plan kernel),
   tuned_allreduce (compiled executor: fused_combine),
   overlap_allreduce (the same plans streamed through the overlap engine at
   its tuned depth) and again with ``prefetch_stream`` (a second stream
   broadcasts a rank-stacked copy of the updated parameters after every
   update), and compressed_allreduce over bf16 (the passthrough), int8 and
   fp8 wires (compiled: the quantize kernels); then param_bcast, the ring
   and tuned_allreduce again with the synced gradient rows compared; then
   tuned_allreduce with
   ``RunConfig.tuner_table`` naming two tables that differ only in
   ``exec_path`` (compiled, then inkernel). Checks: equal step-0 losses,
   bit-equal synced rows in the two reruns, the bf16 wire's and both
   overlap runs' parameters bit-identical to tuned_allreduce's,
   overlap_allreduce launching as many fused_combine as tuned_allreduce
   (the prefetch's extra broadcast launches, each run's depth and peak
   memory printed), the in-kernel table's parameters
   bit-identical to the compiled table's (with no merge launch and one
   device-initiated in-kernel launch per bucket plan and step), the
   bf16-wire modes' last losses and per-step grad norms close to
   grad_allreduce's (the plain mean, which runs none of the port's
   kernels), int8's last loss within 5e-3 of tuned_allreduce's, finite
   losses; then one f32 smoke
   param_bcast run on the card against the CPU.
6m. MoE training: mixtral-8x7b at full width (1 of 32 layers, 8 experts
   top-2, vocab 32000, bf16, seeded weights; the router f32 among bf16
   leaves) on the 4 emulated ranks, phase 6's batch and 3 steps, through
   the einsum dispatch: grad_allreduce (one pass over the global batch: the
   aux of the whole batch), tuned_allreduce with the synced rows compared
   (each rank's aux its own) and compressed_allreduce over the int8 wire.
   Checks: finite losses, rows bit-equal, tuned_allreduce's last loss within
   1e-3 of grad_allreduce's (their aux difference printed), int8's within
   5e-3 of tuned_allreduce's, the router's leaves in the bucket plan's f32
   buckets, the int8 residual an f32 row a rank (the router's finite and
   nonzero); then mixtral-8x7b-smoke in f32 under grad_allreduce and
   tuned_allreduce on the card against the CPU.
6v. vision-prefix training: paligemma-3b at full width and depth (18
   layers, bf16, seeded weights) trains 3 steps of tuned_allreduce on the 4 ranks,
   one sequence of 256 stub patches + 3840 tokens a rank: attention at
   4096 keys takes the differentiable block loop, so neither flash kernel
   launches (checked); merge launches, step and peak printed; then
   paligemma-3b-smoke in f32 on the card against the CPU.
6f. the recurrent, hybrid, encoder-decoder and MHA families: xlstm-350m
   (24 layers), hymba-1.5b (32), whisper-large-v3 (32 + 32, 1500 stub
   frames a sequence) and qwen1.5-32b (FAMILY_MHA_LAYERS of 64, the deepest
   whose peak stays under 70 GiB) at full width, bf16, seeded weights, on
   the 4 emulated ranks, phase 6's batch and 3 steps: each under
   grad_allreduce and under tuned_allreduce (compiled, the synced rows
   compared), xlstm also under param_bcast (the paper's mode, rows
   compared); xlstm's explicit modes, with a grad_allreduce beside them,
   at one superblock of 8 layers (host-bound at full depth). Checks:
   finite losses, rows bit-equal, every run's peak under 70 GiB, merge
   launches on each family's path and no flash launch (training has no
   flash kernel); each explicit mode's last loss and grad norms against
   grad_allreduce's at its depth within the larger of phase 6's limits
   (1e-3, 2e-4 relative) and FAMILY_CONTROL_MULT times the distance of a
   bf16 control that splits grad_allreduce into the ranks' passes and runs
   no sync (FAMILY_BF16_CONTROL, measured by tools/family_controls.py);
   then, after the path's counts are read, each family in f32 at one
   layer (encoder too), full width, every explicit mode
   within 1e-4 / 1e-5 relative of grad_allreduce. Then the memory probe:
   one forward and backward of one 4096-token sequence through hymba-1.5b
   at full depth with remat (one rank's share of the reference's
   ``train_4k``), its peak and seconds. Last (after the kernels line is
   read), the four smoke configs in f32 under tuned_allreduce on the card
   against the CPU.
6t. training on a model axis: phase 6's minitron-8b (1 layer, full width,
   8 x 512 tokens, remat, 3 steps, bf16) under grad_allreduce on a (2, 2)
   ('data', 'model') mesh of the same 4 emulated ranks, the parameters and
   AdamW state blocked by ``param_specs(fsdp=True)``: each step gathers
   every model rank's shard from its data ranks' blocks (``pallgather`` on
   the strided data groups), runs the tensor-parallel forward and backward
   and updates the blocks. Twice: with ``compiled_collectives`` (the merge
   in every gather round) and through a tuner table that routes every
   gather in-kernel (``rdma_replay``), the two runs' parameters bit-equal.
   Printed beside phase 6's one-axis grad_allreduce: step seconds, peak
   GiB, each rank row's held bytes of parameters + AdamW state, the
   gather's milliseconds a step (CUDA events). Checks: the last loss and
   grad norms within phase 6's limits (1e-3, 2e-4 relative) of phase 6's
   one-axis grad_allreduce, peaks under 70 GiB; after the path's counts
   are read, one step from the initial blocks with each model rank's
   gathered shard bit-equal to the plain concatenation of its blocks and
   every row holding a copy of a block bit-equal to its owner's (the
   parameters and both moments), the same run in f32 within 1e-4 (last
   loss) and 1e-5 (grad norms, relative) of the one-axis f32 run, and
   minitron-8b-smoke in f32 on (2, 2), card against CPU, within 1e-4.
6u. model-axis training of the other families (after 6f, whose one-axis
   runs it reads): ``grad_allreduce`` on 6t's (2, 2) mesh in the blocked
   FSDP + TP layout (``param_specs(fsdp=True, attn_fallback='replicate')``),
   full width, bf16, 3 steps, each config beside its one-axis run earlier in
   the script on the same data: mixtral-8x7b at 6m's cut (1 of 32 layers, 8
   x 512 tokens; its 8 experts cut 4 a model rank, the f32 router's columns
   too), compiled and through an in-kernel tuner table (``rdma_replay``
   gathers, the parameters bit-equal to the compiled run's), beside 6m's
   grad_allreduce; whisper-large-v3 at 6f's shapes (32 + 32 layers, 8 x
   (1500 stub frames + 512 tokens); self and cross attention on 10 heads a
   rank) beside 6f's grad_allreduce; paligemma-3b at 6v's shapes (18
   layers, 4 x (256 patches + 3840 tokens); its one kv head whole in every
   shard, 4 query heads a rank over it) in 4 microbatches, a sequence a
   pass as 6v's ranks pass (one pass over the 4 sequences holds their f32
   logits over 257,280 words several times over), beside 6v's
   tuned_allreduce. Each prints its step seconds, peak GiB and the
   gathers' ms a step beside the one-axis run's step and peak, each rank
   row's held bytes of parameters + AdamW state, and the merge and
   ``inkernel_rdma`` launches. Checks: the last loss and grad norms within
   the larger of phase 6's limits (1e-3, 2e-4 relative) and 3x a control's
   distance from the one-axis run (that run with every element of its
   first attention output projection moved by at most one bf16 step: a
   MoE's routing moves on one rounding); after the last step, before the
   full trees are assembled (outside the steps' times), every rank row
   holding a copy of a block bit-equal to the block's owner (parameters and
   both moments); peaks under 70 GiB; no flash launch; each config at one
   layer (encoder too) in f32, TF32 off, the TP run within 1e-4 (last loss)
   and 1e-5 (grad norms, relative) of the one-axis grad_allreduce; then
   mixtral-, whisper- and paligemma-3b-smoke in f32 on (2, 2) (every QKV
   bias drawn nonzero), card against CPU, within 1e-4.
7. collectives: ``pallgather``, ``preduce_scatter``, ``preduce`` and
   ``pallreduce`` at minitron-8b's training embedding bucket (1,048,576,000
   bf16 elements a rank) on the 4 emulated ranks, each with
   ``inkernel=True`` (one device-initiated launch) and ``compiled=True``,
   bit-equal to each other and to the device-initiated replay's plain
   version on the same buffer; the one-shot max/min ``pallreduce`` against
   ``torch.amax``/``amin``.
7b. algorithms: ``pipelined_chain_fused`` bit-equal to the generic
   unrolled replay of the same schedule (4 x 21 chunks of bf16, 16M
   elements a rank); ``schedule_bcast`` at 21 chunks and at 300 (the
   compiled route: fused_combine) bit-equal to the root's row;
   ``ring_allreduce`` on the card bit-equal to the CPU (4 x 16M, f32 and
   bf16); at the training embedding bucket the ring timed beside
   ``pallreduce(algo='ring_allreduce')`` compiled and in-kernel, all three
   bit-equal.
8. streams: a 2-entry graph from ``plan_streams`` over phase 6's parameter
   shapes on the 4 emulated ranks, ``grad_sync`` (allreduce, reversed,
   priority 1) and ``weight_prefetch`` (bcast, after grad_sync), through
   ``execute_streams(stage=True, compiled=True)``: each tree bit-equal to
   its entry replayed alone, bucket 0 of each bit-equal to
   ``simulate_lowered``, one chunked_copy per non-empty bucket and one
   fused_combine per class-round; the host-clock time of the interleave
   beside the two entries run one after the other (one sample, no claim
   about overlap on one card).
8b. trees: ``pallreduce_tree`` and ``pbcast_tree`` over phase 8's two
   trees with ``stage=True`` (one chunked_copy per non-empty bucket) and
   ``pbcast_tree(inter_pod=True)``, each bit-equal to ``stage=False``.
9. online tuning: an ``OnlineTuner`` over the 9 default arms (3 allreduce
   algorithms x 3 wire formats) at 16M f32 a rank, ``len(arms) + 8``
   steps, each arm's plan timed on the card (median of 3 CUDA-event
   replays) and held against the f32 sum of the rows: every arm tried in
   the first 9 steps, the table ending at the lowest measurement, every
   improving record a new fingerprint and a plan-cache miss; each arm's
   ``cost_wire`` prediction printed beside its time.
10. MoE serving: mixtral-8x7b at full width (2 of 32 layers, 8 experts
   top-2, window 4096, bf16, seeded random weights) on the 4 emulated
   ranks: ``Engine(distribute=True, double_buffer=True)`` as phase 3, then
   ``generate`` of batch 4, prompt 128, 32 decode steps through the einsum
   dispatch and the warm re-run, then the compiled pipelined chain from
   NaN-filled replicas as phase 4 (replicas bit-equal each time).
10b. expert parallelism: the same model's prefill of one 4096-token
   sequence a rank through ``apply_lm(mesh=, transport=)`` with
   ``moe_dispatch='alltoallv'`` (each MoE layer's rows out and back through
   ``palltoallv``), once with the compiled and once with the in-kernel
   executor, bit-equal, its logits against the einsum dispatch's within a
   stated bf16 limit; each MoE layer's block matrices through the compiled,
   in-kernel and unrolled executors, bit-equal to each other and to a host
   reshuffle, timed beside the bytes bound; ragged ``pallgatherv`` and
   ``palltoallv`` cases with zero-row ranks at rows of 4096 bf16, likewise;
   the expert-parallel ``moe_ffn`` at E = 6 in f32 against the einsum path;
   then the three MoE smoke configs in f32, card against CPU.
11. faults: (a) phase 6's tuned_allreduce run with rank 1 reported dead
   (``Trainer(health=MeshHealth(n=4, dead_ranks=(1,)))``): the fallback
   line printed, finite losses, no plan kernel launched, the first step's
   loss and grad norm within phase 6's limits of a tuned_allreduce step on 3
   ranks over the batch without rank 1's rows; (b) at the training
   embedding bucket, the allreduce and the bcast from rank 2 replanned on
   the 3 survivors (``plan_degraded``), each run on the survivors' rows
   compiled and in-kernel, bit-equal to each other and to the replay's
   plain version, rank 1's row untouched, timed (CUDA events) beside the
   healthy 4-rank plan and the bytes bound; a dead root refused
   (``DeadRankError``); a slow-link report re-priced, its replay bit-equal
   to the healthy plan's; (c) ``apply_plan_resilient`` at the same bucket:
   the bf16 plan served in-kernel, an int8-wire plan served by the compiled
   stage after the in-kernel veto (its launches those of
   ``apply_plan(compiled=True)``), a 1e-9 s timeout a straggler with the
   same bits, each stage's replay fed to a ``Watchdog``; (d) a weight
   distribution with ``drain_dir=`` whose second bucket fails: a
   ``WeightSyncError`` and a checkpoint bit-equal to row 0.
12. recurrent and hybrid serving: (a) hymba-1.5b at full width and depth
   (32 layers, 1,918,465,664 params, 4.50 GB a replica, 1.33 GB of it f32)
   and (b) xlstm-350m (24 layers, 290,927,700 params) on the 4 emulated
   ranks: ``Engine(distribute=True, double_buffer=True)``, replicas
   bit-equal; ``generate`` of batch 4 (a 4096-token prompt a rank for
   hymba, 2048 for xlstm) and 32 decode steps, the recurrent states in the
   stacked caches; the warm re-run timing prefill and decode apart; the
   compiled pipelined chain from NaN-filled replicas; one profiled prefill
   (device ms by kernel class, hymba's flash device ms printed beside the
   52 ms the CUDA-core kernel took there). Every hymba prefill pass launches
   the sm90 flash kernel 32 times (bf16, head width 64) and the CUDA-core
   one never; xlstm launches neither. (c) hymba-1.5b-smoke and
   xlstm-350m-smoke in f32, card against CPU.
13. encoder-decoder and MHA serving, as phase 12 serves: (a) whisper-large-v3
   at full width and depth (32 encoder and 32 decoder layers, d_model 1280,
   20 heads of 64, QKV biases) with one 30-second segment (1500 stub frames
   from the port's ``batches``) and a 4-token prompt a rank: the encoder
   in train mode, bidirectional, then the decoder with cross attention; no
   flash launch (every attention under 4096 keys); one cross K/V pair a
   decoder layer in the caches, which decode hands back uncopied. (b)
   qwen1.5-32b at full width (MHA_LAYERS of 64 layers, 40 / 40 heads of
   128, QKV biases, d_ff 27392; the phase's peak under 70 GiB, asserted)
   with one 4096-token prompt a rank: each
   layer's prefill through the sm90 flash kernel at a group of 1, none of
   the CUDA-core one; then rank 0's request prefilled again and decoded
   32 steps over an f8 cache of 8192 slots (every step of every layer the
   head-blocked softmax, counted) and over a bf16 cache, peaks and decode
   ms printed; the head-blocked softmax at layer 0's f8 cache against
   ``_sdpa`` over the cast cache within one bf16 step. (c)
   whisper-large-v3-smoke and qwen1.5-32b-smoke (and its MHA variant) in
   f32 with nonzero QKV biases, card against CPU.
14. the hierarchical mesh, every rank of a ('pod', 'data') mesh emulated on
   the one card (a transfer across pods is an HBM copy, as one within a
   pod): (a) on two pods of 4 at phase 7's embedding bucket a rank
   (1,048,576,000 bf16, 16.8 GB over 8 ranks), ``hierarchical_bcast``
   (pod level first), ``pallreduce_tree`` and ``overlap_allreduce_tree``
   (``hierarchical_allreduce_axes``: pod level last, priced inter-pod), each
   compiled and in-kernel, bit-equal to the plain replay of the same
   per-level plans, each level's plan printed and its replay timed by CUDA
   events, the strided pod level's gather and scatter copies timed; the
   broadcast on (1, 8), (8, 1) and one 8-rank axis bit-equal to the root's
   row; (b) phase 6's minitron-8b on a (2, 2) mesh in param_bcast, its ring,
   tuned_allreduce, overlap_allreduce and the int8 wire, rows compared,
   losses and grad norms within phase 6's limits of phase 6's one-axis runs;
   (c) phase 3's minitron-8b on a (2, 2) mesh, the staged and the compiled
   distribution (pod level first, replicas bit-equal), a generate and a warm
   prefill and decode; (d) minitron-8b-smoke in f32 under tuned_allreduce
   on (2, 2), card against CPU.
15. tensor-parallel serving, every rank of a (2, 2) ('data', 'model') mesh
   emulated on the card (the 4 ranks of phase 3: 2 data ranks of 2 model
   ranks): (a) phase 3's minitron-8b (8 layers) distributed staged
   (``Engine(distribute=True, double_buffer=True)``) and by the compiled
   pipelined chain, both with ``specs=`` (``param_specs(fsdp=False,
   attn_fallback='head_dim')``): the broadcast along the strided data
   groups (rows m, m + 2), then the cut, every rank's row bit-equal to its
   block of the loaded weights; s beside phase 3's, peaks, the memory held
   after the cut, the strided data level's gathers and scatters at the
   embedding bucket; (b) ``generate`` of batch 4 (2 a data rank), prompt
   128, 32 steps (tokens in the vocab, log-probs finite and at most 0); the
   warm prefill ms a data rank and decode tok/s beside phase 3's; (c) one
   4096-token prompt a data rank: 32 ``flash_attention_sm90`` launches a
   pass (8 layers x 2 model ranks x 2 data ranks, 16 query and 4 kv heads
   a model rank) and none of the CUDA-core kernel, the warm prefill ms, one
   prefill under ``torch.profiler``. Then, after the path's counts are
   read, (b)'s references: the greedy tokens and each data rank's prefill
   logits beside the one-axis engine's on the same weights, held against
   the control of the one-axis engine with one weight element one bf16
   step up (within 2x its largest ratio to 2^-7 |ref| + 1e-2 and 10x its
   share over that limit), every TP layer held against the layer in f32
   (its largest error at most the one-axis layer's plus one bf16 rounding
   of its largest output), the same weights in f32 end to end within 1e-3;
   and (c)'s kernel check: every flash call of one data rank's 4096-token
   prefill recorded, each the sm90 kernel's on a head shard, within one
   bf16 rounding of the plain version's f32 result on its inputs, the
   first timed beside the plain version and scaled_dot_product_attention
   (``serve_tp_shard`` in the sm90 kernel's JSON line); (d)
   minitron-8b-smoke in f32 on (2, 2), card against CPU (prefill logits
   within 1e-3, greedy tokens equal).
16. tensor-parallel serving of the other families on phase 15's (2, 2)
   ('data', 'model') mesh, each at full width, bf16, seeded random
   weights, distributed staged (``Engine(distribute=True,
   double_buffer=True)``) and by the compiled pipelined chain, both with
   ``specs=``, every shard bit-equal to its ``param_specs`` block: (a)
   mixtral-8x7b, 2 of 32 layers (phase 10's cut), 4 experts a model rank,
   batch 4 (2 a data rank), prompt 128, 32 steps, and a third distribution
   through a tuner table built on the card for the data level's buckets
   (``exec_path='inkernel'``: the device-initiated replay); (b)
   paligemma-3b, 18 layers, one request a data rank of 256 patches + 3840
   tokens and 32 steps: its one kv head takes the head-dim split and the
   sequence-split cache (4128 slots, half a model rank), 36 sm90 flash
   launches a data rank's prefill pass and none of the CUDA-core kernel;
   (c) whisper-large-v3, 32 + 32 layers, one request a data rank of 1500
   stub frames + 4 tokens, 32 steps. Each prints its distributions' s, the
   peak (under 70 GiB), the warm prefill ms a data rank and decode tok/s
   beside its one-axis phase (10, 4d, 13a); tokens in the vocab, log-probs
   finite and at most 0. Then, after the path's counts are read, the
   greedy tokens beside the one-axis engine's on the same weights, and
   every TP layer (the encoder's too) held against the layer in f32, fed
   the one-axis hidden state: its largest error at most the one-axis
   layer's plus one bf16 rounding of its largest output. (d)
   mixtral-8x7b-, moonshot-v1-16b-a3b-, paligemma-3b- and
   whisper-large-v3-smoke in f32 on (2, 2), card against CPU (prefill
   logits within 1e-3, greedy tokens equal).
17. tensor-parallel serving of the recurrent and hybrid families on phase
   15's (2, 2) ('data', 'model') mesh, as phase 16 serves (staged and
   compiled distribution with ``specs=``, every shard bit-equal; one
   request a data rank, 32 steps; beside the one-axis phase), each model
   rank's recurrent state its ``cache_specs`` block: (a) hymba-1.5b, 32
   layers, a 4096-token prompt (12a's): its 25 / 5 heads of 64 on the
   head-dim split, all 25 query heads attending once over the gathered kv
   heads (32 sm90 launches a data rank's pass, none of the CUDA-core
   kernel), the ring of 1024 slots split 512 a model rank, Mamba on 1600
   channels a rank; (b) xlstm-350m, 24 layers, a 2048-token prompt (12b's):
   mLSTM on 256 key dims a head a rank, sLSTM on 512 of d a rank. Each
   prints 16's numbers, then, after the path's counts are read, the tokens
   against the one-axis engine, every layer against the layer in f32 (as
   16, asserted), one data rank's prefill under ``torch.profiler`` (busy
   share), and for (b) the sLSTM loop's launches and host ms a token beside
   the one-axis loop's (``serve tp_recurrent slstm loop:``). (c)
   xlstm-350m-smoke, hymba-1.5b-smoke and hymba-1.5b-smoke with 5 query and
   1 kv heads in f32 on (2, 2) at 80-token prompts, card against CPU.
18. tensor-parallel serving in the reference's remaining layouts, on the
   engines of phases 15-17 while they live (bf16, full width): a batch
   that divides no data axis is one serving group, its forward run once on
   the model ranks of data coordinate 0, every cache cut over all its
   (data, model) ranks as ``cache_specs`` places it (the sequence on
   'data'). (a) phase 15's minitron-8b served from the compiled chain with
   ``specs=`` (every shard bit-equal), one 4096-token request (2064 slots
   a data rank, 16 sm90 launches a pass) and 3 requests of 128, beside
   15c's and 15b's numbers; (b) paligemma-3b, one request of 256 patches +
   3840 tokens (1032 slots a (data, model) rank); (c) hymba-1.5b, one
   4096-token request (its ring 256 slots a rank, Mamba's state kept
   once); (d) whisper-large-v3, 1500 frames + 4 tokens (750 cross frames a
   data rank). (e) a model axis of 8: minitron-8b (8 layers, 4096 tokens,
   64 sm90 launches a pass) and whisper-large-v3 (32 + 32 layers) on (1,
   8), cut by ``shard_stacked``; xlstm-350m (24 layers, 512 tokens) on (2,
   8) after the staged and the compiled distribution with ``specs=``, its
   sLSTM loop's launches a token beside 17b's. Each run prints the warm
   prefill ms a group, the decode ms a step and tok/s, the cache layout
   and the peak; then, after its counts, the greedy tokens equal to the
   one-axis engine's (asserted), (a)'s decode logits against 15b's
   control, (e)'s layers against the layer in f32. (f) the CPU tests'
   cases (``tests/test_torch_tp_layouts.py``) in f32, card against CPU.
Last, the trap check: a subprocess launches the device-initiated replay
with one wait target raised by one and must exit with code 3, which it
gives only when the synchronize right after the launch raises, within 60 s.

Launch counts are zeroed right before each path and read right after it:
phases 3-4 (the serving path), phase 4b's distribution (the tuned serving
path), phase 4c (the long-prompt serving path), phase 4d (the
vision-prefix serving path), phase 5's two long-prompt references (the
f32 flash route), phase 6's runs (the training path), phase 6t's two timed
runs (the model-axis training path, ``train_tp``), phase 6u's four timed
runs (``train_tp_fam``: the sum of their own counts, without the tuner
table's timed gathers or the smoke runs), phase 6m (the MoE
training path), phase 6v (the vision-prefix training path), phase 6f's
four families' runs, each a path of its own (``train_recurrent``,
``train_hybrid``, ``train_encdec``, ``train_mha``; not their controls or
the probe), phase 7 (the
collective entry points), phase 7b (the algorithms), phase 8's interleave
(the stream path), phase 8b (the tree variants), phase 9 (the online
tuner), phase 10 (the MoE serving path), phase 10b (the expert-parallel
path), phase 11 (the fault runtime), phases 12a and 12b (the hybrid and
the recurrent serving paths) and phases 13a and 13b (the encoder-decoder
and the MHA serving paths), phase 14 (the hierarchical mesh's path) and
phases 15a-15c's own runs (the tensor-parallel serving path,
``serve_tp``, without 15b's references and 15c's kernel check), phases
16a-16c's own runs, each a path of its own (``tp_moe``, ``tp_vlm``,
``tp_encdec``: the distributions and the served requests, without the
one-axis references, the layer checks and 16a's table recording), and
phases 17a-17b's likewise (``tp_hybrid``, ``tp_recurrent``; without the
profiled prefill and the sLSTM count either), phases 18a-18d's runs (one
path, ``tp_seq``, each run zeroed before and added after, 18a's compiled
distribution included) and 18e's (``tp_m8``, xlstm's distributions
included), without their one-axis references and checks; the launches that compare
kernels with their plain versions, the replays timed to fill the tuner
tables and the calibrate phase's replays are not counted. The last three lines of output are the kernels
JSON, the card, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
BATCH, PROMPT, STEPS, RANKS, LAYERS = 4, 128, 32, 4, 8
LONG_PROMPT, LONG_LAYERS = 4096, 6  # phase 4c: gemma3-27b, one whole 5:1 period
VLM_TEXT = 3840  # phase 4d: paligemma-3b, 256 patches + 3840 tokens = 4096 positions
# the reference's flash cases (tests/test_kernels.py):
# B, T, S, H, KV, hd, causal, window, prefix, bq, bk
FLASH_CASES = (
    (2, 128, 128, 4, 2, 32, True, None, 0, 64, 64),
    (1, 256, 256, 4, 1, 64, True, 64, 0, 64, 64),
    (2, 128, 128, 2, 2, 32, True, None, 32, 64, 32),
    (1, 128, 128, 4, 4, 32, False, None, 0, 128, 128),
    (1, 64, 64, 8, 2, 16, True, 32, 16, 32, 32),
    (1, 128, 128, 2, 1, 16, True, None, 96, 32, 32),   # a prefix tile skipped
    (1, 96, 96, 4, 2, 128, True, 40, 0, 32, 32),       # hd 128, a partial row block
    (1, 80, 80, 2, 1, 64, True, None, 0, 16, 16),      # partial row and key tiles
    # head width 128, the sm90 kernel's: caller tiles below its 128 x 128, a
    # prefix with a window, a skipped prefix tile, partial tiles, window 0
    # (rows without an allowed key: the mean of their kept keys' v)
    (2, 256, 256, 4, 2, 128, True, None, 0, 64, 64),
    (1, 384, 384, 2, 2, 128, True, 100, 48, 64, 32),
    (1, 128, 128, 2, 1, 128, True, None, 96, 32, 32),
    (1, 80, 80, 2, 1, 128, True, None, 0, 16, 16),
    (1, 256, 256, 2, 2, 128, False, 0, 0, 64, 64),
    (1, 128, 128, 2, 1, 128, True, 0, 0, 32, 32),
    # head width 128 at a group of 4, a tensor-parallel head shard's
    # (minitron-8b at M = 2: 16 query and 4 kv heads a model rank): whole
    # tiles, then partial tiles over 2 sequences
    (1, 256, 256, 16, 4, 128, True, None, 0, 128, 128),
    (2, 200, 200, 8, 2, 128, True, None, 0, 40, 40),
    # head width 256, both kernels (the sm90 one on 64-key tiles): a skipped
    # prefix tile, partial row and key tiles, a window with a prefix,
    # paligemma's caller tiles (256, 128) over a prefix of 256
    (1, 128, 128, 2, 1, 256, True, None, 96, 32, 32),
    (1, 80, 80, 2, 1, 256, True, None, 0, 16, 16),
    (1, 96, 96, 4, 2, 256, True, 40, 0, 32, 32),
    (1, 384, 384, 2, 1, 256, True, 100, 48, 64, 32),
    (1, 512, 512, 4, 1, 256, True, None, 256, 256, 128),
    # head width 64, both kernels (the sm90 one on 128 x 128 tiles): an odd
    # group (hymba-1.5b's 25 / 5 is a group of 5), a window with a prefix,
    # partial row and key tiles under caller tiles below 128, window 0, a
    # window over an odd group
    (1, 256, 256, 10, 2, 64, True, None, 0, 128, 128),
    (1, 384, 384, 2, 1, 64, True, 100, 48, 64, 32),
    (1, 200, 200, 5, 1, 64, True, None, 0, 40, 40),
    (1, 256, 256, 2, 2, 64, False, 0, 0, 64, 64),
    (2, 512, 512, 10, 2, 64, True, 128, 0, 128, 128),
)
FLASH_F32_TOL = 2e-4  # the reference test's f32 tolerance, atol = rtol
# bf16 output against the plain version's f32 result: one rounding to bf16
# (half a step of its 8-bit significand, at most 2^-8 of the value) plus
# room for the f32 sums' order (f32 readings 6.6e-7, PERF.md)
FLASH_BF16_REL, FLASH_BF16_ABS = 2.0**-8, 1e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LAYERS = 8, 512, 3, 1
TRAIN_MODES = (  # (label, RunConfig fields)
    ("grad_allreduce", {"sync_mode": "grad_allreduce"}),
    ("param_bcast", {"sync_mode": "param_bcast"}),
    ("param_bcast_ring", {"sync_mode": "param_bcast", "bcast_algo": "ring_allreduce"}),
    ("tuned_allreduce", {"sync_mode": "tuned_allreduce", "compiled_collectives": True}),
    ("overlap_allreduce", {"sync_mode": "overlap_allreduce", "compiled_collectives": True}),
    ("overlap_prefetch", {"sync_mode": "overlap_allreduce", "compiled_collectives": True,
                          "prefetch_stream": True}),
    ("compressed_bf16", {"sync_mode": "compressed_allreduce", "wire_format": "bf16",
                         "compiled_collectives": True}),
    ("compressed_int8", {"sync_mode": "compressed_allreduce", "wire_format": "int8",
                         "compiled_collectives": True}),
    ("compressed_fp8", {"sync_mode": "compressed_allreduce", "wire_format": "fp8",
                        "compiled_collectives": True}),
)
TRAIN_RUN = {"learning_rate": 1e-3, "warmup_steps": 1, "total_steps": TRAIN_STEPS, "seed": 0}
# rerun with the synced rows compared
ROW_CHECKED = ("param_bcast", "param_bcast_ring", "tuned_allreduce")
# the calibrate phase: one emulated point-to-point transfer at each size
# (bytes, 1 KiB to 256 MiB), and compiled replays of 1 MiB a rank at each
# chunk count of three (op, algo) groups
LINK_BYTES = tuple(1 << k for k in (10, 13, 16, 19, 22, 25, 28))
LAUNCH_GROUPS = (("bcast", "pipelined_chain"), ("reduce", "pipelined_reduce_chain"),
                 ("allreduce", "fused_rsb"))
LAUNCH_KS = (4, 8, 16, 32)
ALG_ELEMS = 1 << 24  # phases 7b and 9: elements a rank
MOE_LAYERS, MOE_PROMPT = 2, 4096  # phases 10 and 10b: mixtral-8x7b, 2 of 32 layers
# phase 10b: the expert-parallel prefill's logits against the einsum
# dispatch's. The expert-parallel path routes every shard and runs every
# rank's local experts with the einsum path's contractions on the same
# shapes, and the one-hot dispatch and combine contractions are exact in
# any order (one, or k, nonzero products a sum), so the reading expected is
# 0: only the rows' travel differs, and it copies. The limit allows one
# bf16 rounding step of a logit, 2^-7 relative, plus the 5e-2 absolute that
# the port's tests give bf16 prefill logits between two implementations.
# Routing each shard by itself instead (an f32 router GEMM over 4,096 rows,
# not 16,384) read 1.207 with 26,826 logits over this limit: the router's
# ulps sent near-tie tokens to another expert
MOE_EP_REL, MOE_EP_ABS = 2.0**-7, 5e-2
# phase 6m: mixtral-8x7b at full width, 1 of 32 layers (1,582,346,240
# params), phase 6's batch and steps; the timed runs and their fields
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_MODES = (
    ("grad_allreduce", {"sync_mode": "grad_allreduce"}),
    ("tuned_allreduce", {"sync_mode": "tuned_allreduce", "compiled_collectives": True}),
    ("compressed_int8", {"sync_mode": "compressed_allreduce", "wire_format": "int8",
                         "compiled_collectives": True}),
)
# phase 6v: paligemma-3b at full width and depth (18 layers, 2,508,793,856
# params; the peak stays under 70 GiB, PERF.md §5), one sequence of 256
# patches + VLM_TEXT tokens a rank
VLM_TRAIN_LAYERS = 18
# phase 6f: (path, arch, layers, runs, the f32 control's layers) at full
# width, phase 6's batch and steps; None keeps the config's depth.
# qwen1.5-32b runs at the deepest depth whose tuned_allreduce peak stays
# under 70 GiB: about 20 bytes a parameter (bf16 weights and gradient, 4
# rank rows of bf16 gradients, AdamW's f32 m and v) over 779 M + 526 M x L
# parameters, and the sync's padded copy of a bucket. 4 layers ran out of
# the card's memory there: 60.90 GiB allocated and 11.94 GiB of the cache
# free but in pieces, under a 5.80 GiB request for the embedding bucket's
# padded copy (PERF.md §6)
FAMILY_MHA_LAYERS = 3
FAMILY_RUNS = {  # label: (RunConfig fields, rows compared)
    "grad_allreduce": ({"sync_mode": "grad_allreduce"}, False),
    "tuned_allreduce": ({"sync_mode": "tuned_allreduce", "compiled_collectives": True}, True),
    "param_bcast": ({"sync_mode": "param_bcast"}, True),
    # the bf16 control of tools/family_controls.py: the ranks' passes of 2
    # sequences, no sync
    "grad_allreduce_split": ({"sync_mode": "grad_allreduce", "num_microbatches": RANKS}, False),
}
# phase 6f's bf16 hold: each explicit mode's last loss and grad norms
# (relative, the largest over the steps) within the larger of phase 6's
# limits (1e-3, 2e-4) and FAMILY_CONTROL_MULT times the bf16 control's
# distance from grad_allreduce at the mode's depth. The control is
# grad_allreduce over the ranks' own pass shapes (``num_microbatches`` =
# RANKS: the same passes of 2 sequences, their gradients' mean in f32, no
# sync), so its distance is what the split alone costs in bf16. It runs no
# sync code and its readings repeat to every digit, so they are held here
# and tools/family_controls.py measures them again (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md §6). The modes read at most 1.52x the control
# (xlstm), 1.23x (hymba), 1.29x (whisper) and 2.35x (qwen's grad norms;
# its loss 4.768e-5, inside 1e-3)
FAMILY_CONTROL_MULT = 3.0
FAMILY_BF16_CONTROL = {  # arch: the control's (last loss, grad norms) distance
    "xlstm-350m": (4.8065185546875e-04, 1.3794130824902154e-04),  # 8 layers
    "hymba-1.5b": (7.844924926757812e-03, 2.5286742395500025e-03),
    "whisper-large-v3": (1.7642974853515625e-03, 2.7829578322423505e-04),
    "qwen1.5-32b": (1.33514404296875e-05, 2.360481482253643e-04),  # 3 layers
}
# and the sync in f32: each family at FAMILY_F32_LAYERS layers (encoder
# too), full width, every explicit mode within FAMILY_F32_LOSS (last loss)
# and FAMILY_F32_NORM (grad norms, relative) of grad_allreduce
FAMILY_F32_LAYERS, FAMILY_F32_LOSS, FAMILY_F32_NORM = 1, 1e-4, 1e-5
# xlstm's explicit modes, and a grad_allreduce to hold them to, run at one
# superblock (7 mLSTM blocks and the sLSTM one): each of their steps is
# four passes through sLSTM's token loop, host-bound at 15-22 s a step at
# 24 layers (PERF.md §5); its grad_allreduce runs at full depth too, for
# the peak
FAMILY_RECURRENT_SYNC_LAYERS = 8
FAMILY_TRAIN = (  # (path, arch, layers, runs, the explicit runs' layers)
    ("train_recurrent", "xlstm-350m", None, ("grad_allreduce", "tuned_allreduce", "param_bcast"),
     FAMILY_RECURRENT_SYNC_LAYERS),
    ("train_hybrid", "hymba-1.5b", None, ("grad_allreduce", "tuned_allreduce"), None),
    ("train_encdec", "whisper-large-v3", None, ("grad_allreduce", "tuned_allreduce"), None),
    ("train_mha", "qwen1.5-32b", FAMILY_MHA_LAYERS, ("grad_allreduce", "tuned_allreduce"), None),
)
FAMILY_PEAK_LIMIT = 70 * 2**30
PROBE_SEQ = 4096  # the memory probe: one sequence of the reference's train_4k
FAULT_DEAD = 1  # phase 11: the rank reported dead
# phase 12: one prompt a rank, hymba-1.5b's of 4096 tokens (past its window
# of 1024: the long-prompt route), xlstm-350m's of its training context
HYBRID_PROMPT, RECURRENT_PROMPT = 4096, 2048
# phase 13: whisper-large-v3 at full width and depth, one 30-second segment
# (1500 stub frames) and a 4-token prompt a rank; qwen1.5-32b at full width,
# MHA_LAYERS of 64 layers, one 4096-token prompt a rank, then decode over an
# f8 cache of F8_MAX_LEN slots. The depth is the deepest whose phase peak
# stays under 70 GiB: the staged distribution holds the root's weights, 4
# replicas and the rank-stacked buckets in flight, each MLP matrix of every
# layer a bucket of 4 x 0.28 GB a layer; 8 layers peaked at 71.70 GiB
# (PERF.md §4)
ENCDEC_PROMPT, MHA_PROMPT, MHA_LAYERS, F8_MAX_LEN = 4, 4096, 7, 8192
# phase 14: the hierarchical mesh. 14a's two pods of 4 at phase 7's
# embedding bucket a rank; 14b's modes
POD_MESH, HIER_ELEMS = (2, 4), 1_048_576_000
HIER_TRAIN_MODES = ("param_bcast", "param_bcast_ring", "tuned_allreduce", "overlap_allreduce",
                    "compressed_int8")
# phase 15: tensor-parallel serving on a ('data', 'model') mesh of the same
# 4 ranks as phase 3 (2 data ranks of 2 model ranks); 15c's prompt a data
# rank. 15b reads the prefill logits against the one-axis engine's beside
# one bf16 rounding of them (TP_REL |ref| + TP_ABS), and holds every TP
# layer against the layer in f32: its largest error at most the one-axis
# layer's plus one bf16 rounding (2^-8, half a step) of the layer's
# largest output, the extra rounding of each partial before the model
# axis's sum. End to end the bf16 logits are held against a control, the
# one-axis engine's own logits with one weight element moved one bf16
# step: the TP engine's largest ratio to the limit at most TP_RATIO_MULT x
# the control's, its share of logits over the limit at most TP_SHARE_MULT
# x the control's (read 7.49 against 5.12, and 26.17% against 3.59%: PERF.md
# §6); a fault that moves most logits fails it
TP_MESH, TP_LONG_PROMPT = (2, 2), 4096
# phase 6t: grad_allreduce on the (2, 2) ('data', 'model') mesh, the gathers
# through the compiled replay (the merge in every round)
TP_TRAIN_FIELDS = {"sync_mode": "grad_allreduce", "compiled_collectives": True}
# phase 6u: the MoE, encoder-decoder and vision-prefix families trained as
# phase 6t trains minitron-8b, on its (2, 2) mesh, each beside the one-axis
# run of the same config and data earlier in the script: (arch, layers (None:
# all), global batch, text tokens a sequence, microbatches, the one-axis
# phase, its RunConfig fields). mixtral-8x7b also runs through an in-kernel
# tuner table (TP_TRAIN_INKERNEL). paligemma-3b passes its 4 sequences one at
# a time (4 microbatches, the passes 6v's ranks make, the same mean loss: its
# aux is 0): one pass over the 4 ran out of memory (76.83 GiB allocated, a
# 14.72 GiB request, tools/train_tp_families.py --one-pass on NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md §6). The bf16 hold is 6f's: the last loss
# and grad norms within the larger of phase 6's limits and
# FAMILY_CONTROL_MULT times a control's distance from the one-axis run, the
# control that run with every element of its first attention output
# projection moved by at most one bf16 step (one rounding of the attention's
# output, as the partial sums make). A MoE's routing moves on such a
# rounding: mixtral-8x7b's bf16 TP forward dispatched 420 of 4096 tokens
# otherwise (tools/tp_routing.py), its run's last loss 3.657e-3 and grad
# norms 2.874e-3 from 6m's, while in f32 at the same cut it dispatched every
# token alike, 8.2e-8 apart (PERF.md §6); each family in f32 at one layer
# (encoder too) within FAMILY_F32_LOSS / FAMILY_F32_NORM of the one-axis
# grad_allreduce
TP_TRAIN_FAMILIES = (
    ("mixtral-8x7b", MOE_TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, 1, "6m",
     {"sync_mode": "grad_allreduce"}),
    ("whisper-large-v3", None, TRAIN_BATCH, TRAIN_SEQ, 1, "6f", {"sync_mode": "grad_allreduce"}),
    ("paligemma-3b", VLM_TRAIN_LAYERS, RANKS, VLM_TEXT, RANKS, "6v",
     {"sync_mode": "tuned_allreduce", "compiled_collectives": True}),
)
TP_TRAIN_INKERNEL = "mixtral-8x7b"
TP_TRAIN_SMOKE = ("mixtral-8x7b-smoke", "whisper-large-v3-smoke", "paligemma-3b-smoke")
TP_REL, TP_ABS, TP_LAYER_REL = 2.0**-7, 1e-2, 2.0**-8
# phase 16: the MoE, vision-prefix and encoder-decoder families on phase 15's
# mesh. (path, arch, layers (None: all), requests a data rank, prompt tokens,
# sm90 flash launches a data rank's prefill pass, the one-axis phase)
TP_FAMILY_RUNS = (("tp_moe", "mixtral-8x7b", MOE_LAYERS, BATCH // TP_MESH[0], PROMPT, 0, "10"),
                  ("tp_vlm", "paligemma-3b", None, 1, VLM_TEXT, 36, "4d"),
                  ("tp_encdec", "whisper-large-v3", None, 1, ENCDEC_PROMPT, 0, "13a"))
TP_FAMILY_SMOKE = ("mixtral-8x7b-smoke", "moonshot-v1-16b-a3b-smoke", "paligemma-3b-smoke",
                   "whisper-large-v3-smoke")
TP_PEAK_LIMIT = 70 * 2**30
TP_RATIO_MULT, TP_SHARE_MULT = 2.0, 10.0
# phase 17: the recurrent and hybrid families on phase 15's mesh, as phase
# 16's runs, beside phase 12's one-axis runs at their prompts (hymba's one
# attention a layer on the head-dim split: one sm90 launch a layer a pass)
TP_SSM_RUNS = (("tp_hybrid", "hymba-1.5b", None, 1, HYBRID_PROMPT, 32, "12a"),
               ("tp_recurrent", "xlstm-350m", None, 1, RECURRENT_PROMPT, 0, "12b"))
TP_SSM_SMOKE = (("xlstm-350m-smoke", {}), ("hymba-1.5b-smoke", {}),
                ("hymba-1.5b-smoke", {"num_heads": 5, "num_kv_heads": 1}))
TP_SSM_SMOKE_PROMPT = 80  # past the smoke configs' chunk of 16 and window of 64
# the sLSTM loop's launches a token: the difference of two prompts' counts
SLSTM_TOKENS = (16, 48)
# phase 18: the reference's remaining serving layouts. 18a-18d (the ``tp_seq``
# path) serve batches that divide no data axis on phases 15-17's (2, 2)
# engines: one request over both data ranks, the caches' sequence on 'data';
# 18a also TP_SEQ_BATCH requests at PROMPT tokens. 18e (``tp_m8``) serves on a
# model axis of 8: minitron-8b (phase 15's 8 layers, one TP_LONG_PROMPT-token
# request) and whisper-large-v3 (32 + 32 layers) on (1, 8), cut by
# ``shard_stacked``; xlstm-350m (24 layers, one TP_M8_PROMPT-token request:
# the sLSTM loop's launches grow with M) on (2, 8) after the staged and the
# compiled distribution. Each run's warm re-run times TP_TIMED_STEPS decode
# steps; 18a holds TP_SEQ_DECODE steps of decode logits against phase 15's
# control; 18f serves the CPU tests' cases (tests/test_torch_tp_layouts.py):
# (config, overrides, mesh, requests, prompt) in f32, card against CPU
TP_SEQ_BATCH, TP_M8, TP_M8_PROMPT, TP_TIMED_STEPS, TP_SEQ_DECODE = 3, 8, 512, 8, 8
TP_SEQ_RUNS = {"tp_vlm": "16b", "tp_encdec": "16c", "tp_hybrid": "17a"}  # 18b, 18d, 18c
TP_LAYOUT_SMOKE = (
    ("minitron-8b-smoke", {}, (2, 2), 1, 64), ("minitron-8b-smoke", {}, (2, 2), 3, 64),
    ("minitron-8b-smoke", {}, (2, 2), 1, 63), ("minitron-8b-smoke", {}, (2, 2, 2), 2, 64),
    ("paligemma-3b-smoke", {}, (2, 2), 1, 64),
    ("hymba-1.5b-smoke", {"num_heads": 5, "num_kv_heads": 1}, (2, 2), 1, 80),
    ("whisper-large-v3-smoke", {}, (2, 2), 1, 8), ("xlstm-350m-smoke", {}, (1, 8), 2, 40),
    ("whisper-large-v3-smoke", {"frontend_len": 24}, (1, 8), 2, 8),
    ("whisper-large-v3-smoke", {"frontend_len": 20}, (1, 8), 2, 8))
SWEEPS = ("staging_sweep", "combine_sweep")  # tools/<name>.cu, built into build/<name>


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def bits(torch, t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(torch, a, b) -> bool:
    return bool(torch.equal(bits(torch, a), bits(torch, b)))


def max_abs_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    return float(torch.where(both_nan, 0.0, (a - b).abs()).max())


def calibrate(torch) -> dict:
    """Per-transfer and per-launch times of the emulated mesh (the ``ts``
    and ``t_launch`` of the H100 cost profile): one point-to-point transfer
    of a 1 KiB block between two ranks through the unrolled executor, and
    one fused_combine launch on a 1 KiB block."""
    from repro_torch.comm.executors import execute_collective
    from repro_torch.core.schedules import chain
    from repro_torch.kernels.combine_update import fused_combine_update

    buf = torch.randn((2, 1, 512), device="cuda").to(torch.bfloat16)
    sched = chain(2)
    ts_ms = time_ms(torch, lambda: execute_collective(sched, buf), reps=2000, warmup=50)
    recv = torch.randn((2, 1, 512), device="cuda").to(torch.bfloat16)
    zero = torch.zeros(2, dtype=torch.int32, device="cuda")
    one = torch.ones(2, dtype=torch.int32, device="cuda")
    tl_ms = time_ms(torch, lambda: fused_combine_update(buf, recv, zero, zero, one, 0),
                    reps=2000, warmup=50)
    return {"ts_s": ts_ms * 1e-3, "t_launch_s": tl_ms * 1e-3}


def calibrate_fits(torch) -> dict:
    """Fit the cost model's link class and per-round launch cost on the
    card. The link: one emulated point-to-point transfer (rank 0's row into
    rank 1's through the unrolled executor, one copy of the row) timed with
    CUDA events at each of :data:`LINK_BYTES`, fitted by
    ``calibrate_link_classes``. The launch cost: a table in the
    reference's compile-table format (``n4/<op>/<algo>/K<k>`` with
    ``num_rounds``) of compiled replays of 1 MiB a rank, fitted by
    ``calibrate_t_launch`` and written to ``build/compile_table_h100.json``.
    ``H100_SXM`` itself is not changed."""
    from repro_torch.comm import apply_plan, plan_collective
    from repro_torch.comm.executors import execute_collective
    from repro_torch.core import cost_model
    from repro_torch.core.schedules import chain

    hw = cost_model.H100_SXM
    sched, samples = chain(2), []
    for nbytes in LINK_BYTES:
        buf = torch.empty((2, 1, nbytes // 2), dtype=torch.bfloat16, device="cuda").normal_()
        ms = time_ms(torch, lambda: execute_collective(sched, buf),
                     reps=200 if nbytes < 1 << 24 else 20)
        samples.append((nbytes, ms * 1e-3))
        del buf
    link = cost_model.calibrate_link_classes({"emulated": samples})["emulated"]
    assert link.bw < hw.hbm_bw, (link, samples)
    table = {}
    for op, algo in LAUNCH_GROUPS:
        for k in LAUNCH_KS:
            plan = plan_collective(op, 1 << 20, RANKS, algo=algo, num_chunks=k)
            x = torch.randn((RANKS, 1 << 19), device="cuda").to(torch.bfloat16)
            apply_plan(plan, x.clone(), compiled=True)  # warm-up
            secs = []
            for _ in range(3):
                arg = x.clone()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                apply_plan(plan, arg, compiled=True)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            # The reference's table holds the seconds to lower the unrolled
            # program under this field; the port lowers no device program,
            # so the field holds the host seconds of one compiled replay
            # after a synchronize (the median of 3), which grows with the
            # round count as the lowering does, and one function reads both.
            table[f"n{RANKS}/{op}/{algo}/K{k}"] = {
                "num_rounds": plan.lowered().num_rounds, "unrolled_lower_s": sorted(secs)[1]}
    t_launch = cost_model.calibrate_t_launch(table)
    path = os.path.join(ROOT, "build", "compile_table_h100.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    log(f"calibrate link: emulated point-to-point transfers {[(b, '%.3e' % t) for b, t in samples]} "
        f"(bytes, s) fit bw {link.bw:.4e} B/s, ts {link.ts:.4e} s, beside H100_SXM link_bw "
        f"{hw.link_bw:.4e}, ts {hw.ts:.4e} (hbm_bw {hw.hbm_bw:.4e})")
    rows = ", ".join(f"{k} {e['num_rounds']} rounds {e['unrolled_lower_s'] * 1e3:.3f} ms"
                     for k, e in sorted(table.items()))
    log(f"calibrate t_launch: {rows}; fit {t_launch:.4e} s a round "
        f"beside H100_SXM t_launch {hw.t_launch:.4e} s (table: build/compile_table_h100.json)")
    return {"link": {"samples": samples, "bw": link.bw, "ts": link.ts},
            "t_launch_table": table, "t_launch": t_launch,
            "h100_sxm": {"link_bw": hw.link_bw, "ts": hw.ts, "t_launch": hw.t_launch}}


def _moving_rows(torch, buf, recv, start, lo, hi):
    """The flat row indices of ``buf`` (n * K, C) that a round writes and
    those of ``recv`` (n * B, C) it reads, from the round tables."""
    n, K, _C = buf.shape
    B = recv.shape[1]
    dst, src = [], []
    for r, (s, a, b) in enumerate(zip(start.tolist(), lo.tolist(), hi.tolist())):
        for i in range(max(a, 0), min(b, B)):
            dst.append(r * K + s + i)
            src.append(r * B + i)
    as_index = lambda v: torch.tensor(v, dtype=torch.long, device=buf.device)  # noqa: E731
    return as_index(dst), as_index(src)


def round_times(torch, buf, recv, start, lo, hi, combine, reps: int = 10) -> dict:
    """CUDA-event times of one ``fused_combine_update`` round on ``buf`` in
    place, its bytes bound, and one library call at the same moving rows of
    the flattened buffer: ``index_copy_`` when the round overwrites,
    ``index_add_`` when it accumulates (a yardstick of time only: its bf16
    rounding may differ). The buffer's values change."""
    from repro_torch.kernels import combine_update as cu

    n, K, C = buf.shape
    dst, src = _moving_rows(torch, buf, recv, start, lo, hi)
    rows = int(dst.numel())
    moved = recv.view(-1, C)[src].contiguous()
    flat = buf.view(n * K, C)
    lib = (lambda: flat.index_add_(0, dst, moved)) if combine else \
        (lambda: flat.index_copy_(0, dst, moved))
    ms = time_ms(torch, lambda: cu.fused_combine_update(buf, recv, start, lo, hi, combine),
                 reps=reps)
    library_ms = time_ms(torch, lib, reps=reps)
    bound = rows * C * buf.element_size() * (3 if combine else 2) / HBM_BYTES_PER_S * 1e3
    return {"rows": rows, "ms": ms, "bound_ms": bound, "library_ms": library_ms,
            "library": "index_add_" if combine else "index_copy_"}


def check_fused_combine_offsets(torch) -> None:
    """Both entry points at odd widths, one launch a round, bit-equal to the
    plain version at every pair of (destination row, recv row) offsets mod
    16 that the dtype allows (16 pairs in f32, 64 in bf16): the buffer and
    recv are views of byte pools at every base offset, so each moving row
    and its recv row take every pair; starts above 0, KEEP rows holding
    -0.0 and NaN payloads on each side of every moving row, and sentinel
    bytes before and after the buffer, all unwritten."""
    from repro_torch.kernels import combine_update as cu

    gen = torch.Generator(device="cuda").manual_seed(3)
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    # rank 0 moves row 2 of 6, rank 1 rows 2-4, rank 2 row 3, rank 3 none
    start, lo, hi = ints([1, 2, 1, 3]), ints([1, 0, 2, 1]), ints([2, 3, 3, 1])
    n, K, B = 4, 6, 3
    for dt, C in ((torch.float32, 1029), (torch.bfloat16, 1029), (torch.bfloat16, 4099)):
        es = torch.empty((), dtype=dt).element_size()
        size = n * K * C * es
        buf_pool = torch.empty(size + 32, dtype=torch.int8, device="cuda")
        recv_pool = torch.empty(n * B * C * es + 32, dtype=torch.int8, device="cuda")
        recv_vals = torch.randn((n, B, C), generator=gen, device="cuda").to(dt)
        init = torch.randn((n, K, C), generator=gen, device="cuda").to(dt)
        dst_rows, _src = _moving_rows(torch, init, init[:, :B], start, lo, hi)
        keep = torch.ones(n * K, dtype=torch.bool, device="cuda")
        keep[dst_rows] = False
        flat = init.view(n * K, C)
        flat[keep, 0] = -0.0
        flat[keep, 1] = float("nan")
        bits(torch, flat)[keep, 2] = 0x7FC3 if dt == torch.bfloat16 else 0x7FC01234
        # the plain entry point: per-row modes over 6 rows, specials in its KEEP rows
        modes = ints([2, 0, 1, 0, 2, 1]).reshape(6, 1)
        rows = torch.randn((6, C), generator=gen, device="cuda").to(dt)
        rows[1, 0] = -0.0
        rows[3, 1] = float("nan")
        bits(torch, rows)[3, 2] = 0x7FC3 if dt == torch.bfloat16 else 0x7FC01234
        for do in range(0, 16, es):
            for so in range(0, 16, es):
                recv = recv_pool[so:so + n * B * C * es].view(dt).view(n, B, C)
                recv.copy_(recv_vals)
                for combine in (0, 1):
                    buf_pool.fill_(0x5A)
                    buf = buf_pool[do:do + size].view(dt).view(n, K, C)
                    buf.copy_(init)
                    want = buf_pool.clone()
                    cu.fused_combine_update_plain(want[do:do + size].view(dt).view(n, K, C),
                                                  recv, start, lo, hi, combine)
                    cu.fused_combine_update(buf, recv, start, lo, hi, combine)
                    assert torch.equal(buf_pool, want), \
                        f"fused_combine_update {dt} C={C} +{do}/+{so} combine={combine}"
                buf_pool.fill_(0x5A)
                cur = buf_pool[do:do + 6 * C * es].view(dt).view(6, C)
                cur.copy_(rows)
                src = recv.view(n * B, C)[:6]
                want = buf_pool.clone()
                cu.fused_combine_plain(want[do:do + 6 * C * es].view(dt).view(6, C), src, modes)
                cu.fused_combine(cur, src, modes)
                assert torch.equal(buf_pool, want), f"fused_combine {dt} C={C} +{do}/+{so}"
    before = cu.fused_combine_update.launches
    cu.fused_combine_update(buf, recv, start, lo, hi, 1)
    assert cu.fused_combine_update.launches == before + 1, "one launch counted a round"
    log("kernel fused_combine_update (4, 6, 1029) f32, (4, 6, 1029) and (4, 6, 4099) bf16, "
        "1-3 moving rows of 3 a rank, overwrite and accumulate, and fused_combine (6, C), "
        "at every destination x recv offset mod 16: bit-equal to plain, KEEP rows (-0.0, "
        "NaN payloads) and the bytes around the buffer unwritten, one launch a round")


def check_fused_combine(torch) -> dict:
    """fused_combine at (8, 262144) and (1, 16384000), bf16 and f32, with
    -0.0 and NaN payloads in KEEP rows; the offsets check; then
    fused_combine_update at the round shape phase 4 gives it on the
    embedding bucket, which is the kernel's line in the kernels JSON."""
    from repro_torch.kernels import combine_update as cu

    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in ((8, 262144), (1, 16384000)):
        for dt in (torch.bfloat16, torch.float32):
            B, C = shape
            cur = torch.randn(shape, generator=gen, device="cuda").to(dt)
            recv = torch.randn(shape, generator=gen, device="cuda").to(dt)
            modes = [0, 1, 2, 0, 1, 2, 0, 2][:B] if B > 1 else [2]
            mode = torch.tensor(modes, dtype=torch.int32, device="cuda").reshape(B, 1)
            for r, m in enumerate(modes):
                if m == cu.KEEP:
                    cur[r, 0] = -0.0
                    cur[r, 1] = float("nan")
                    bits(torch, cur)[r, 2] = 0x7FC3 if dt == torch.bfloat16 else 0x7FC01234
            k = cu.fused_combine(cur.clone(), recv, mode)
            p = cu.fused_combine_plain(cur.clone(), recv, mode)
            torch.cuda.synchronize()
            assert same_bits(torch, k, p), f"fused_combine {shape} {dt} differs from plain"
            work = cur.clone()
            ms = time_ms(torch, lambda: cu.fused_combine(work, recv, mode))
            log(f"kernel fused_combine {shape} {str(dt)[6:]}: bit-equal to plain, "
                f"{ms:.4f} ms")
    check_fused_combine_offsets(torch)

    # one round of phase 4's compiled pipelined chain on the embedding bucket,
    # chunked as the planner chunks it: ranks 1..3 overwrite one chunk each
    from repro_torch.comm import plan_cached
    from repro_torch.configs import get_config

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    chunks = plan_cached("bcast", N * 2, RANKS, algo="pipelined_chain").num_chunks
    n, K, C = RANKS, 2, -(-N // chunks)
    buf = torch.randn((n, K, C), generator=gen, device="cuda").to(torch.bfloat16)
    recv = torch.randn((n, 1, C), generator=gen, device="cuda").to(torch.bfloat16)
    start = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device="cuda")
    lo = torch.tensor([0, 0, 0, 0], dtype=torch.int32, device="cuda")
    hi = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device="cuda")
    k = cu.fused_combine_update(buf.clone(), recv, start, lo, hi, 0)
    p = cu.fused_combine_update_plain(buf.clone(), recv, start, lo, hi, 0)
    torch.cuda.synchronize()
    assert same_bits(torch, k, p), "fused_combine_update differs from plain"
    err = max_abs_err(torch, k, p)
    del k, p
    work = buf.clone()
    t = round_times(torch, work, recv, start, lo, hi, 0, reps=20)
    plain_ms = time_ms(torch, lambda: cu.fused_combine_update_plain(work, recv, start, lo, hi, 0),
                       reps=5)
    line = {"name": "fused_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/combine_update.cu",
            "replaces": "src/repro/kernels/combine_update.py:52",
            "max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"], "library": t["library"],
            "shape": [n, K, C], "dtype": "bfloat16"}
    log(f"kernel fused_combine_update ({n}, {K}, {C}) bf16 overwrite round "
        f"({chunks} chunks, {t['rows']} rows): bit-equal, {t['ms']:.4f} ms (bound "
        f"{t['bound_ms']:.4f} ms, plain {plain_ms:.4f} ms, index_copy_ {t['library_ms']:.4f} ms)")
    return line


def check_fused_combine_training(torch) -> list[dict]:
    """fused_combine_update at the training path's round shapes, bit for
    bit against its plain version: on the embedding bucket, of the int8
    compressed allreduce plan (f32 at the plan's odd chunk width) and of
    the tuned bf16 allreduce plan, for each class (accumulate, overwrite)
    its first round that moves a row and its first steady round (the most
    rows any of its rounds moves), each with the start/lo/hi rows of its
    lowered plan's round tables, timed beside ``index_add_`` /
    ``index_copy_`` at the same rows."""
    import numpy as np

    from repro_torch.comm import plan_cached
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import combine_update as cu

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    algo = RunConfig().allreduce_algo
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for label, dt, fmt in (("compressed int8", torch.float32, "int8"),
                           ("tuned", torch.bfloat16, None)):
        esize = 4 if dt == torch.float32 else 2
        plan = plan_cached("allreduce", N * esize, RANKS, algo=algo, wire_format=fmt)
        low = plan.lowered()
        K = low.num_chunks
        C = -(-N // K)
        buf = torch.randn((RANKS, K, C), generator=gen, device="cuda").to(dt)
        ref = buf.clone()
        for combine, name in ((1, "accumulate"), (0, "overwrite")):
            moving = [(int((c.hi[r] - c.lo[r]).clip(min=0).sum()), c, r)
                      for c in low.classes for r in range(low.num_rounds)
                      if int(c.combine[r]) == combine and (c.hi[r] > c.lo[r]).any()]
            most = max(m for m, _c, _r in moving)
            picks = (("first", next(x for x in moving if x[0] == min(m for m, *_ in moving))),
                     ("steady", next(x for x in moving if x[0] == most)))
            for kind, (rows, cls, r) in picks:
                tab = torch.from_numpy(np.stack([cls.recv_start[r], cls.lo[r], cls.hi[r]])).to(
                    device="cuda", dtype=torch.int32)
                recv = torch.randn((RANKS, cls.block, C), generator=gen, device="cuda").to(dt)
                cu.fused_combine_update(buf, recv, tab[0], tab[1], tab[2], combine)
                cu.fused_combine_update_plain(ref, recv, tab[0], tab[1], tab[2], combine)
                torch.cuda.synchronize()
                assert same_bits(torch, buf, ref), \
                    f"fused_combine_update {label} {name} {kind} round differs from plain"
                t = round_times(torch, buf, recv, tab[0], tab[1], tab[2], combine)
                assert t["rows"] == rows, (t["rows"], rows)
                ref.copy_(buf)
                out.append({"plan": label, "algo": plan.algo, "class": name, "round": kind,
                            "round_index": r, "shape": [RANKS, K, C], "dtype": str(dt)[6:], **t})
                log(f"kernel fused_combine_update ({RANKS}, {K}, {C}) {str(dt)[6:]} {label} "
                    f"{plan.algo} {name} {kind} round {r} ({rows} rows): bit-equal, "
                    f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, {t['library']} "
                    f"{t['library_ms']:.4f} ms)")
                del recv
        del buf, ref
    return out


COPY_N = 1_048_576_000 + 37  # the staging copy's bf16 elements (phase 2)


def copy_times(torch, x) -> dict:
    """CUDA-event times of ``chunked_copy`` and ``clone`` on ``x`` (16-byte
    aligned) and on ``x[1:]`` (the source 2 bytes off, one element
    shorter)."""
    from repro_torch.kernels.chunked_copy import chunked_copy, chunked_copy_plain

    xs = x[1:]
    return {"aligned_ms": time_ms(torch, lambda: chunked_copy(x), reps=10),
            "misaligned_ms": time_ms(torch, lambda: chunked_copy(xs), reps=10),
            "plain_ms": time_ms(torch, lambda: chunked_copy_plain(x), reps=10),
            "clone_ms": time_ms(torch, lambda: x.clone(), reps=10),
            "clone_misaligned_ms": time_ms(torch, lambda: xs.clone(), reps=10)}


def check_chunked_copy(torch) -> dict:
    """One launch per copy at every source and destination byte offset mod
    16 (int8, 1003 bytes: every byte lands, none around it changes), the
    staging bucket's shape aligned and with the source 2 bytes off, each
    bit-equal to the plain version and timed beside ``clone``; one profiled
    call of each shows one kernel each."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import chunked_copy as cc

    gen = torch.Generator(device="cuda").manual_seed(2)
    small = torch.randn(1003, generator=gen, device="cuda")
    for x in (small, small[1:]):  # ragged, and 4 bytes off 16-byte alignment
        assert same_bits(torch, cc.chunked_copy(x), cc.chunked_copy_plain(x))
    src = torch.randint(-128, 128, (1003 + 32,), dtype=torch.int8, device="cuda",
                        generator=gen)
    dst = torch.empty_like(src)
    for so in range(16):
        for do in range(16):
            dst.fill_(0x5A)
            cc._launch(dst[do:do + 1003], src[so:so + 1003])
            want = torch.full_like(dst, 0x5A)
            want[do:do + 1003] = src[so:so + 1003]
            assert torch.equal(dst, want), f"chunked_copy source +{so} destination +{do}"
    log("kernel chunked_copy (1003,) and (1002,) f32 unaligned, (1003,) int8 at every "
        "source x destination byte offset mod 16: bit-equal to plain, nothing else written")
    N = COPY_N
    x = torch.randn(N, generator=gen, device="cuda").to(torch.bfloat16)
    errs = []
    for v in (x, x[1:]):
        k = cc.chunked_copy(v)
        p = cc.chunked_copy_plain(v)
        torch.cuda.synchronize()
        assert same_bits(torch, k, p), f"chunked_copy ({v.numel()},) differs from plain"
        errs.append(max_abs_err(torch, k, p))
        del k, p
    before = cc.chunked_copy.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cc.chunked_copy(x)
        cc.chunked_copy(x[1:])
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_time_total > 0]
    assert cc.chunked_copy.launches == before + 2, "chunked_copy counts one launch a copy"
    assert sum(n for _k, n in kernels) == 2, kernels  # one kernel a call
    t = copy_times(torch, x)
    grid = cc.copy_plan(2 * N, x.data_ptr()).grid
    line = {"name": "chunked_copy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunked_copy.cu",
            "replaces": "src/repro/kernels/chunked_copy.py:37",
            "max_abs_err": max(errs), "ms": t["aligned_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": 2 * N * 2 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": t["clone_ms"], "misaligned_ms": t["misaligned_ms"],
            "misaligned_bound_ms": 2 * (N - 1) * 2 / HBM_BYTES_PER_S * 1e3,
            "library_misaligned_ms": t["clone_misaligned_ms"],
            "grid": grid, "kernels_per_call": 1,
            "shape": [N], "dtype": "bfloat16"}
    log(f"kernel chunked_copy ({N},) bf16: bit-equal, one kernel a call "
        f"({[k[:40] for k, _n in kernels]}), grid {grid} blocks; "
        f"aligned {t['aligned_ms']:.4f} ms (bound {line['bound_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, clone {t['clone_ms']:.4f} ms); source 2 bytes off "
        f"{t['misaligned_ms']:.4f} ms (clone {t['clone_misaligned_ms']:.4f} ms)")
    return line


def _quant_bits_equal(torch, a, b) -> tuple[bool, int]:
    """(bit-equal where not both NaN, count of both-NaN positions whose
    payload bits differ)."""
    nan = (a.float().isnan() & b.float().isnan())
    view = {1: torch.uint8, 4: torch.int32}[a.element_size()]
    same = a.view(view) == b.view(view)
    return bool((same | nan).all()), int((nan & ~same).sum())


def embed_wire_hop() -> tuple[int, int, int, list]:
    """(rows, width, block, land) of the largest compressed hop on the
    training path's largest bucket, the embedding's: the planner's int8
    allreduce plan chunks it, a class round quantizes the rows its active
    pairs merge, and the hop dequantizes them into the rows ``land`` of the
    class's receive view ``(4 * block, width)``."""
    from repro_torch.comm import plan_cached
    from repro_torch.configs import get_config

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    plan = plan_cached("allreduce", N * 4, RANKS, wire_format="int8")
    low = plan.lowered()
    cls, s = max(((cls, s) for cls in low.classes for s in range(low.num_rounds)),
                 key=lambda cs: sum(int(cs[0].hi[cs[1], d] - cs[0].lo[cs[1], d])
                                    for _src, d in cs[0].perm))
    land = [d * cls.block + i for _src, d in cls.perm
            for i in range(int(cls.lo[s, d]), int(cls.hi[s, d]))]
    return len(land), -(-N // plan.schedule.num_chunks), cls.block, land


def dequantize_times(torch, fmt: str) -> dict:
    """CUDA-event times of ``dequantize_blocks`` at the embedding bucket's
    largest ``fmt`` hop: into a contiguous ``(rows, C)``
    output, and as the compressed hop calls it, into the receive view
    ``(4 * block, C)`` through ``rows=``; for int8 also one
    ``torch.mul`` of the payload by its broadcast scales into a ``(rows,
    Cp)`` f32 buffer (the same bytes but the ragged tail's)."""
    from repro_torch.kernels import quantize as qk

    rows, C, block, land = embed_wire_hop()
    gen = torch.Generator(device="cuda").manual_seed(6)
    v, s = qk.quantize_blocks(torch.randn((rows, C), generator=gen, device="cuda"), fmt)
    out = torch.empty((rows, C), device="cuda")
    recv = torch.empty((RANKS * block, C), device="cuda")
    idx = torch.tensor(land, dtype=torch.int64, device="cuda")
    res = {"shape": [rows, C], "block": block, "land": land,
           "contiguous_ms": time_ms(torch, lambda: qk.dequantize_blocks(
               v, s, out_cols=C, out=out), reps=20),
           "hop_ms": time_ms(torch, lambda: qk.dequantize_blocks(
               v, s, out_cols=C, out=recv, rows=idx), reps=20)}
    if fmt == "int8":
        nb = s.shape[1]
        full = torch.empty((rows, nb * 256), device="cuda")
        res["library_ms"] = time_ms(torch, lambda: torch.mul(
            v.view(rows, nb, 256), s[..., None], out=full.view(rows, nb, 256)), reps=20)
    return res


def check_quantize(torch) -> list[dict]:
    """quantize_blocks / dequantize_blocks against their plain versions, bit
    for bit, int8 and fp8: a ragged width, the training path's odd width,
    an all-zero block, +-1e30 and 1e-30, a NaN block, zero rows; the
    dequantize also into rows at every offset mod 4 floats and through
    ``rows=`` into the compressed hop's receive view; then times at the
    embedding bucket's hop shape (the kernels JSON lines)."""
    from repro_torch.kernels import quantize as qk

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, C, block, land = embed_wire_hop()
    small = torch.randn((3, 1000), generator=gen, device="cuda") * 3
    small[1, :256] = 0.0
    small[2, 0], small[2, 1], small[2, 2:10] = 1e30, -1e30, 1e-30
    small[0, 300] = float("nan")
    wide = torch.randn((rows, C), generator=gen, device="cuda")
    wide[0, 256:512] = 0.0
    wide[1, 1:3] = 1e30
    wide[-1, C - 5] = float("nan")
    idx = torch.tensor(land, dtype=torch.int64, device="cuda")
    nan_payload = 0
    for fmt in ("int8", "fp8"):
        for x in (small, small[:, 1:], small[:0], wide):
            v, s = qk.quantize_blocks(x, fmt)
            pv, ps = qk.quantize_blocks_plain(x, fmt)
            torch.cuda.synchronize()
            for a, b in ((v, pv), (s, ps)):
                ok, differ = _quant_bits_equal(torch, a, b)
                assert ok and a.shape == b.shape, f"quantize_blocks {fmt} {tuple(x.shape)} differs"
                nan_payload += differ
            d = qk.dequantize_blocks(v, s, out_cols=x.shape[1])
            pd = qk.dequantize_blocks_plain(pv, ps, out_cols=x.shape[1])
            torch.cuda.synchronize()
            ok, differ = _quant_bits_equal(torch, d, pd)
            assert ok and d.shape == pd.shape, f"dequantize_blocks {fmt} {tuple(x.shape)} differs"
            nan_payload += differ
            if not x.shape[0]:
                continue
            # rows at every offset mod 4 floats: four base offsets, pitch C + 1
            B, cols = x.shape
            for base in range(4):
                pool = torch.full((B * (cols + 1) + 4,), 7.0, device="cuda")
                grid = pool[base:base + B * (cols + 1)].view(B, cols + 1)
                qk.dequantize_blocks(v, s, out_cols=cols, out=grid[:, :cols])
                ok, _ = _quant_bits_equal(torch, grid[:, :cols], pd)
                assert ok, f"dequantize_blocks {fmt} {tuple(x.shape)} at +{base} floats differs"
                assert bool((grid[:, cols] == 7.0).all() and (pool[:base] == 7.0).all()
                            and (pool[base + B * (cols + 1):] == 7.0).all()), \
                    f"dequantize_blocks {fmt} {tuple(x.shape)} at +{base} wrote outside its rows"
                del pool, grid
        v, s = qk.quantize_blocks(wide, fmt)
        recv = torch.full((RANKS * block, C), 7.0, device="cuda")
        qk.dequantize_blocks(v, s, out_cols=C, out=recv, rows=idx)
        ok, differ = _quant_bits_equal(torch, recv[idx], qk.dequantize_blocks_plain(
            v, s, out_cols=C))
        assert ok, f"dequantize_blocks {fmt} through rows= into the receive view differs"
        rest = torch.ones(RANKS * block, dtype=torch.bool, device="cuda")
        rest[idx] = False
        assert bool((recv[rest] == 7.0).all()), "dequantize_blocks wrote outside its rows"
        del recv
    log(f"kernel quantize/dequantize int8+fp8 at (3, 1000), (3, 999), (0, 1000), "
        f"({rows}, {C}): bit-equal to plain ({nan_payload} NaN positions with other "
        "payload bits); dequantize bit-equal at every row offset mod 4 floats and through "
        f"rows= into the hop's receive view ({RANKS * block}, {C}), rows {land}")

    one_way = rows * C * (4 + 1 + 4 / 256)  # f32 in, a byte and 1/256 scale out
    v, s = qk.quantize_blocks(wide, "int8")
    pv, ps = qk.quantize_blocks_plain(wide, "int8")
    out = torch.empty_like(wide)
    d = qk.dequantize_blocks(v, s, out_cols=C, out=out)
    pd = qk.dequantize_blocks_plain(pv, ps, out_cols=C)
    torch.cuda.synchronize()
    deq = {fmt: dequantize_times(torch, fmt) for fmt in ("int8", "fp8")}
    lines = []
    for name, err, fn, plain, src in (
        ("quantize_blocks", max_abs_err(torch, v, pv), lambda: qk.quantize_blocks(wide, "int8"),
         lambda: qk.quantize_blocks_plain(wide, "int8"), "quantize.py:73"),
        ("dequantize_blocks", max_abs_err(torch, d, pd),
         lambda: qk.dequantize_blocks(v, s, out_cols=C, out=out),
         lambda: qk.dequantize_blocks_plain(pv, ps, out_cols=C), "quantize.py:101"),
    ):
        ms = time_ms(torch, fn, reps=20)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        line = {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/quantize.cu",
                "replaces": f"src/repro/kernels/{src}",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": one_way / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": None, "shape": [rows, C], "dtype": "float32/int8"}
        extra = ""
        if name == "dequantize_blocks":
            line["library_ms"] = deq["int8"]["library_ms"]
            line["library_call"] = ("torch.mul(values.view(B, nb, 256), scales[..., None], "
                                    "out=(B, Cp) f32): the same bytes but the ragged tail's")
            line["hop_ms"] = deq["int8"]["hop_ms"]
            line["fp8_ms"] = deq["fp8"]["contiguous_ms"]
            line["fp8_hop_ms"] = deq["fp8"]["hop_ms"]
            extra = (f"; as the hop calls it (rows= into ({RANKS * block}, {C})) "
                     f"{deq['int8']['hop_ms']:.4f} ms; fp8 {deq['fp8']['contiguous_ms']:.4f} / "
                     f"{deq['fp8']['hop_ms']:.4f} ms; torch.mul {deq['int8']['library_ms']:.4f} ms")
        log(f"kernel {name} ({rows}, {C}) int8: {ms:.4f} ms (bound {line['bound_ms']:.4f} ms, "
            f"plain {plain_ms:.4f} ms){extra}")
        lines.append(line)
    return lines


def _small_schedules(n: int, K: int) -> list:
    """Every builder of the port at (n, K), and for n == 3 two hand-made
    schedules in which ranks swap a chunk (overwrite and accumulate): the
    class-rounds that stage through the landing scratch."""
    from repro_torch.comm import schedules as tcs
    from repro_torch.core import schedules as ts

    out = [
        ts.build("direct", n), ts.build("chain", n),
        ts.build("pipelined_chain", n, 1 % n, num_chunks=K), ts.build("binomial", n),
        tcs.build_op("reduce", "binomial_reduce", n, 0),
        tcs.build_op("reduce", "pipelined_reduce_chain", n, 0, num_chunks=K),
        tcs.build_op("allreduce", "fused_rsb", n, 0, num_chunks=K),
        tcs.build_op("allgather", "ring_allgather", n, 0),
        tcs.build_op("reduce_scatter", "ring_reduce_scatter", n, 0),
    ]
    if n >= 3:
        out.append(tcs.build_op("allreduce", "ring_allreduce", n, 0))
    if n >= 4:
        out.append(ts.build("bidir_chain", n, 0, num_chunks=K))
    if n >= 4 and n & (n - 1) == 0:
        out += [ts.build("scatter_allgather", n), ts.build("knomial", n, k=4)]
    if n == 3:
        T = ts.Transfer
        for comb in (False, True):
            out.append(ts.Schedule("swap", 3, 0, 2, (
                ts.Round((T(0, 1, 0, 1, comb), T(1, 0, 0, 1, comb))),
                ts.Round((T(1, 2, 0, 2, comb),)),
                ts.Round((T(2, 0, 1, 1, comb), T(0, 2, 1, 1, comb), T(1, 0, 0, 1, comb))),
            ), kind="allreduce" if comb else "bcast"))
    return out


def _mark_kept_rows(torch, buf, tables) -> int:
    """-0.0 (and NaN, where the replay only copies or the type is f32) in
    the first columns of every row that no class-round writes. The bf16
    sum of a NaN rounds to another payload in PyTorch than in the kernel,
    so bf16 NaNs go only where nothing accumulates. Returns the rows
    marked."""
    written = set()
    for c, perm in enumerate(tables.perms):
        for s in range(tables.num_rounds):
            for _src, dst in perm:
                r0 = int(tables.recv_start[c, s, dst])
                written.update((dst, r0 + i) for i in range(int(tables.lo[c, s, dst]),
                                                             int(tables.hi[c, s, dst])))
    nan_ok = buf.dtype == torch.float32 or not tables.combine.any()
    kept = [(r, k) for r in range(tables.n) for k in range(tables.num_chunks)
            if (r, k) not in written]
    for r, k in kept:
        buf[r, k, 0] = -0.0
        if nan_ok and buf.shape[2] > 2:
            buf[r, k, 1] = float("nan")
            bits(torch, buf)[r, k, 2] = 0x7FC3 if buf.dtype == torch.bfloat16 else 0x7FC01234
    return len(kept)


def _sim_check(torch, replay, low, x, cols) -> None:
    """Replay integer-valued ``x`` (exact in f32 and bf16) with the kernel
    ``replay`` and hold the columns ``cols`` against the port's numpy
    simulator; the replay acts on whole rows, so any column subset is a full
    check."""
    from repro_torch.core.simulator import simulate_lowered

    before = x[:, :, cols].float().cpu().numpy()
    replay(low, x)
    torch.cuda.synchronize()
    want = simulate_lowered(low, list(before))
    got = x[:, :, cols].float().cpu().numpy()
    for r in range(x.shape[0]):
        assert (got[r] == want[r]).all(), (low.name, r, "kernel differs from simulate_lowered")


# the device-initiated replay's plans at the training embedding bucket:
# (label, op, algo) of the serving chain of phase 4, phase 4b's analytic
# bucket plan, the training plan (its line in the kernels JSON) and phase
# 7's other in-kernel entry points
RDMA_PATH_PLANS = (
    ("serving chain (phase 4)", "bcast", "pipelined_chain"),
    ("serving analytic (phase 4b)", "bcast", "auto"),
    ("training fused_rsb (phase 6)", "allreduce", "auto"),
    ("pallgather (phase 7)", "allgather", "auto"),
    ("preduce_scatter (phase 7)", "reduce_scatter", "auto"),
    ("preduce (phase 7)", "reduce", "auto"),
)


def check_inkernel(torch) -> list[dict]:
    """Both in-kernel replays, the device-initiated one (``rdma_replay``,
    what ``execute_inkernel`` runs) and the shared-buffer one
    (``inkernel_replay_shared``), bit for bit against their plain versions,
    each other and the numpy simulator: every builder at n in {2, 3, 4, 8},
    K in {1, 4, 5}, widths 3 (spans shorter than a vector), 37 (under which
    the DIRECT spans take every source-against-destination offset mod 16
    bytes, asserted), 64 (aligned) and 1029 (many vectors a warp), bf16 and
    f32, with -0.0 and NaN in kept rows, and the swap schedules (STAGED
    class-rounds); then at the path shapes (:data:`RDMA_PATH_PLANS` on the
    embedding bucket), timed beside each other and the compiled executor's
    replay of the same plan, with the device-initiated replay's rank groups
    (timed also at equal groups), the bytes one launch allocates beyond its
    flag words (the landing slot, read from the allocator's counters and
    asserted 0) and DIRECT/STAGED class-rounds. The training plan is
    each kernel's line in the kernels JSON."""
    import ctypes

    from repro_torch.comm import plan_cached
    from repro_torch.comm.executors import execute_compiled
    from repro_torch.configs import get_config
    from repro_torch.core.schedules import lower_schedule, pack_tables
    from repro_torch.kernels import _build
    from repro_torch.kernels import inkernel_collective as ik

    gen = torch.Generator(device="cuda").manual_seed(6)
    lib = _build.load("inkernel_collective")
    lib.repro_inkernel_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    grids = {f"{d}/{'vec' if v else 'elem'}": lib.repro_inkernel_grid(code, v)
             for d, code in (("f32", 0), ("bf16", 1)) for v in (1, 0)}
    log(f"kernel inkernel_replay: cooperative grids (blocks of 256) {grids}")
    resident = {d: ik._resident(dt) for d, dt in (("f32", torch.float32),
                                                   ("bf16", torch.bfloat16))}
    log(f"kernel inkernel_rdma: resident blocks of 256 (the groups' sum) {resident}")
    cases = staged = marked = 0
    shifts = {2: set(), 4: set()}
    for n in (2, 3, 4, 8):
        for K in (1, 4, 5):
            for sched in _small_schedules(n, K):
                low = lower_schedule(sched)
                tables = pack_tables(low)
                staged += int((ik.round_modes(tables) == ik.STAGED).sum())
                for dt in (torch.bfloat16, torch.float32):
                    for cols in (3, 37, 64, 1029):
                        es = 2 if dt == torch.bfloat16 else 4
                        shifts[es] |= ik._direct_shifts(tables, cols, es)
                        shape = (n, low.num_chunks, cols)
                        buf = torch.randn(shape, generator=gen, device="cuda").to(dt)
                        marked += _mark_kept_rows(torch, buf, tables)
                        k = ik.inkernel_replay_shared(low, buf.clone())
                        p = ik.inkernel_replay_shared_plain(low, buf.clone())
                        r = ik.rdma_replay(low, buf.clone())
                        rp = ik.rdma_replay_plain(low, buf.clone())
                        torch.cuda.synchronize()
                        assert same_bits(torch, k, p), (sched.name, n, K, dt, cols)
                        assert same_bits(torch, r, rp), ("rdma", sched.name, n, K, dt, cols)
                        assert same_bits(torch, r, k), ("rdma/shared", sched.name, n, K, dt, cols)
                        for replay in (ik.inkernel_replay_shared, ik.rdma_replay):
                            ints = torch.empty(shape, device="cuda", dtype=dt).random_(
                                -4, 5, generator=gen)
                            _sim_check(torch, replay, low, ints, list(range(cols)))
                        cases += 1
    assert staged > 0, "no small case exercised the staged path"
    for es, seen in shifts.items():
        assert seen == set(range(16 // es)), ("a misalignment no DIRECT span took", es, seen)
    log(f"kernel inkernel_replay, inkernel_rdma: {cases} small cases each bit-equal to its "
        f"plain version, to the other kernel and to simulate_lowered ({staged} staged "
        f"class-rounds, {marked} kept rows marked; DIRECT spans at every source/destination "
        f"offset mod 16 bytes: bf16 {sorted(shifts[2])}, f32 {sorted(shifts[4])})")

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    out = []
    for label, op, algo in RDMA_PATH_PLANS:
        plan = plan_cached(op, N * 2, RANKS, algo=algo)
        low = plan.lowered()
        tables = pack_tables(low)
        K, C = low.num_chunks, -(-N // low.num_chunks)
        buf = torch.randn((RANKS, K, C), generator=gen, device="cuda", dtype=torch.bfloat16)
        kept = _mark_kept_rows(torch, buf, tables)
        k = ik.inkernel_replay_shared(low, buf.clone())
        p = ik.inkernel_replay_shared_plain(low, buf.clone())
        torch.cuda.synchronize()
        assert same_bits(torch, k, p), f"inkernel_replay {label} differs from plain"
        del p
        p = ik.rdma_replay_plain(low, buf.clone())
        r = ik.rdma_replay(low, buf.clone())
        torch.cuda.synchronize()
        assert same_bits(torch, r, p), f"inkernel_rdma {label} differs from its plain version"
        assert same_bits(torch, r, k), f"inkernel_rdma {label} differs from inkernel_replay"
        err = 0.0  # bit-equal (a float copy of 4.2e9 elements would not fit beside them)
        del p, r
        c = execute_compiled(low, buf.clone())
        torch.cuda.synchronize()
        assert same_bits(torch, k, c), f"inkernel_replay {label} differs from execute_compiled"
        del c, buf
        # the rank groups as sized (rdma_replay) against equal groups, as the
        # kernel had them before they were sized by the rows each rank moves
        dev_tab = ik._rdma_device_tables(tables, k.device)
        even = (resident["bf16"] // RANKS,) * RANKS
        ms = time_ms(torch, lambda: ik.inkernel_replay_shared(low, k), reps=5, warmup=1)
        rdma_ms = time_ms(torch, lambda: ik.rdma_replay(low, k), reps=5, warmup=1)
        even_ms = time_ms(torch, lambda: ik.rdma_launch(k, tables, dev_tab, even),
                          reps=5, warmup=1)
        even_ms2 = time_ms(torch, lambda: ik.rdma_launch(k, tables, dev_tab, even),
                           reps=5, warmup=1)
        rdma_ms2 = time_ms(torch, lambda: ik.rdma_replay(low, k), reps=5, warmup=1)
        ms2 = time_ms(torch, lambda: ik.inkernel_replay_shared(low, k), reps=5, warmup=1)
        compiled_ms = time_ms(torch, lambda: execute_compiled(low, k), reps=3, warmup=1)
        plain_ms = time_ms(torch, lambda: ik.inkernel_replay_shared_plain(low, k),
                           reps=2, warmup=1)
        rdma_plain_ms = time_ms(torch, lambda: ik.rdma_replay_plain(low, k), reps=2, warmup=1)
        # the same plan at a width of 8: the flags, barriers and launch alone
        tiny = torch.zeros((RANKS, K, 8), device="cuda", dtype=torch.bfloat16)
        proto_ms = time_ms(torch, lambda: ik.rdma_replay(low, tiny), reps=5, warmup=1)
        shared_proto_ms = time_ms(torch, lambda: ik.inkernel_replay_shared(low, tiny),
                                  reps=5, warmup=1)
        del tiny
        # what one launch allocates beyond its flag words: the landing slot
        torch.cuda.synchronize()
        stat = "allocated_bytes.all.allocated"
        before = torch.cuda.memory_stats()[stat]
        torch.empty((RANKS, ik._flag_words(RANKS)), dtype=torch.int32, device="cuda")
        flag_bytes = torch.cuda.memory_stats()[stat] - before
        before = torch.cuda.memory_stats()[stat]
        ik.rdma_replay(low, k)
        torch.cuda.synchronize()
        land_bytes = torch.cuda.memory_stats()[stat] - before - flag_bytes
        assert land_bytes == 0, f"{label}: a launch allocates {land_bytes} bytes of slot"
        for replay in (ik.inkernel_replay_shared, ik.rdma_replay):
            k.random_(-4, 5, generator=gen)
            _sim_check(torch, replay, low, k, list(range(64)) + list(range(C - 64, C)))
        del k, dev_tab
        torch.cuda.empty_cache()
        moved = ik.replay_bytes(tables, C, 2)
        bound = moved / HBM_BYTES_PER_S * 1e3
        modes = ik.round_modes(tables)
        ran, stage = int((modes != ik.SKIP).sum()), int((modes == ik.STAGED).sum())
        waits = int((ik.rdma_wait_targets(tables) > 0).sum())
        groups = list(ik.rdma_groups(tables, resident["bf16"]))
        log(f"kernel inkernel_replay {label}: {plan.algo}, ({RANKS}, {K}, {C}) bf16, "
            f"{low.num_rounds} rounds x {low.num_classes} classes ({ran} class-rounds, "
            f"{stage} staged, {ran - 1 + stage} grid barriers), {kept} kept rows marked: "
            f"bit-equal to plain, to execute_compiled and (64 + 64 columns) to "
            f"simulate_lowered; {ms:.4f} ms / {ms2:.4f} ms (bound {bound:.4f} ms for "
            f"{moved / 1e9:.3f} GB, compiled {compiled_ms:.4f} ms, plain {plain_ms:.4f} ms)")
        log(f"kernel inkernel_rdma {label}: {plan.algo} K={K}, rank groups {groups} "
            f"blocks (units {ik._rank_units(tables).tolist()}), {ran - stage} DIRECT / "
            f"{stage} STAGED class-rounds, landing slot {land_bytes} bytes, {waits} flag "
            f"waits: bit-equal to its plain version, to inkernel_replay and (64 + 64 "
            f"columns) to simulate_lowered; {rdma_ms:.4f} ms / {rdma_ms2:.4f} ms (bound "
            f"{bound:.4f} ms, {bound / min(rdma_ms, rdma_ms2):.1%} of it; shared {ms:.4f} / "
            f"{ms2:.4f} ms, compiled {compiled_ms:.4f} ms, plain {rdma_plain_ms:.4f} ms; "
            f"equal groups {list(even)} {even_ms:.4f} / {even_ms2:.4f} ms); at width 8 (the protocol alone) {proto_ms:.4f} ms, shared {shared_proto_ms:.4f} ms")
        if op == "allreduce":
            common = {"route": "cuda", "max_abs_err": err, "bound_ms": bound,
                      "bound_by": "bytes", "library_ms": None, "compiled_ms": compiled_ms,
                      "plan": f"{plan.algo} K={K}", "shape": [RANKS, K, C],
                      "dtype": "bfloat16"}
            out.append({"name": "inkernel_replay",
                        "source": "src/repro_torch/kernels/csrc/inkernel_collective.cu",
                        "replaces": "src/repro/kernels/inkernel_collective.py:136",
                        "ms": ms, "plain_ms": plain_ms, **common})
            out.append({"name": "inkernel_rdma",
                        "source": "src/repro_torch/kernels/csrc/inkernel_rdma.cu",
                        "replaces": "src/repro/kernels/inkernel_collective.py:246",
                        "ms": rdma_ms, "plain_ms": rdma_plain_ms, "shared_ms": ms,
                        "groups": groups, "land_bytes": land_bytes,
                        "even_groups_ms": min(even_ms, even_ms2), **common})
    return out


_TRAP = r"""
import sys
sys.path.insert(0, SRC)
import torch
from repro_torch.comm import schedules as tcs
from repro_torch.core import schedules as ts
from repro_torch.kernels import inkernel_collective as ik

tables = ts.pack_tables(ts.lower_schedule(tcs.build_op("allreduce", "fused_rsb", 4, 0,
                                                       num_chunks=4)))
tab = ik.rdma_table(tables).copy()
waits = tab[..., 10].nonzero()
at = tuple(int(w[-1]) for w in waits)
tab[at + (10,)] += 1  # the last receive wait, one signal more than is ever sent
buf = torch.randn((4, 4, 64), device="cuda")
dev_tab = torch.from_numpy(tab).cuda()
torch.cuda.synchronize()  # nothing before the launch has failed
ik.rdma_launch(buf, tables, dev_tab)  # the launch itself succeeds: the trap comes later
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    # exit 3 only here: the synchronize right after the launch raised
    print(f"wait target raised by one at (round, class, rank) {at[:3]}: "
          f"{str(e).splitlines()[0]}", file=sys.stderr)
    sys.exit(3)
print("inkernel_rdma returned with a wait that is never met")
"""


def check_trap(torch) -> float:
    """A wait that is never met must end the kernel, not hang the card: a
    subprocess (a trap leaves its CUDA context unusable) launches the
    device-initiated replay with one wait target raised by one. The launch
    returns success (``_build.check`` cannot see a trap); the subprocess
    must exit with code 3, which it gives only when the synchronize right
    after the launch raises, within 60 s. Returns its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", f"SRC = {SRC!r}\n" + _TRAP],
                          capture_output=True, text=True, timeout=60, cwd=ROOT)
    secs = time.perf_counter() - t0
    assert proc.returncode == 3, ("the raised wait did not trap at the synchronize after "
                                  "the launch", proc.returncode, proc.stdout,
                                  proc.stderr[-2000:])
    msg = proc.stderr.strip().splitlines()[-1]
    torch.cuda.synchronize()
    assert torch.ones(1, device="cuda").item() == 1.0, "this process's context is unusable"
    log(f"trap: exit {proc.returncode} after {secs:.1f} s, raised by the synchronize after "
        f"the launch: {msg}")
    return secs


def _flash_path_case(torch, gen, arch: str, window):
    """q, k, v of one layer's prefill at 4096 positions: a gemma3-27b layer
    (phase 4c), a paligemma-3b layer with its prefix of 256 stub patches
    under the query tiles its prefill passes (phase 4d), a hymba-1.5b
    layer (phase 12a) or a qwen1.5-32b layer (phase 13b)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import prefill_tiles

    cfg = get_config(arch)
    T, H, KV, hd = LONG_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn((1, T, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, T, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((1, T, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    bq, bk = prefill_tiles(T, cfg.prefix_len)
    return q, k, v, {"causal": True, "window": window, "prefix": cfg.prefix_len, "bq": bq,
                     "bk": bk}


def _sdpa_call(torch, q, k, v, kw):
    """One PyTorch call computing the same attention (the yardstick; the
    port never calls it): heads-first views, GQA, a causal flag for the
    global layer and a boolean mask for a windowed or prefix-LM one."""
    import torch.nn.functional as F

    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    window, prefix = kw["window"], kw["prefix"]
    if window is None and not prefix:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                      enable_gqa=True)
    T = q.shape[1]
    i = torch.arange(T, device=q.device)
    mask = i[None, :] <= i[:, None]
    if prefix:
        mask = mask | (i[None, :] < prefix)
    if window is not None:
        mask = mask & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, enable_gqa=True)


def _sdpa_kernel(torch, fn) -> str:
    """The name of the device kernel that takes most of one call's time:
    which of scaled_dot_product_attention's backends ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [(e.device_time_total, e.key) for e in prof.key_averages() if e.device_time_total > 0]
    return max(kern)[1][:100] if kern else "not measured"


def _flash_bound(q, k, v, kw) -> tuple[float, float, str]:
    """The flops of the allowed pairs in kept tiles, the bound ms (the
    larger of those flops at the bf16 peak and q, k, v in and the output
    out, bf16, at the HBM rate) and what bounds it."""
    from repro_torch.kernels import flash_attention as fa

    B, T, H, hd = q.shape
    flops = fa.attention_flops(T, k.shape[1], H, hd, B, **kw)
    moved = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound = max(flops / BF16_FLOPS_PER_S, moved / HBM_BYTES_PER_S) * 1e3
    by = "operations" if flops / BF16_FLOPS_PER_S >= moved / HBM_BYTES_PER_S else "bytes"
    return flops, bound, by


def flash_bf16_share(torch, got, want32) -> float:
    """The largest |got - want32| / (2^-8 |want32| + 1e-5) of a bf16 output
    against the plain version's f32 result: at most 1 when the kernel's f32
    result, rounded once to bf16, is the plain one."""
    lim = FLASH_BF16_REL * want32.abs() + FLASH_BF16_ABS
    return float(((got.float() - want32).abs() / lim).max())


def check_flash_attention(torch) -> list[dict]:
    """Both flash kernels against the plain version: the reference's cases
    (and those of tile skipping, partial tiles and head widths 128 and
    256), then the phase 4c shapes (a gemma3-27b layer at 4096 tokens: the
    global layer and a local one, window 1024) and the phase 4d shape (a
    paligemma-3b layer: 8 query heads and 1 kv head of 256, the prefix of
    256 under query tiles of 256) and the phase 12a shape (a hymba-1.5b
    layer: 25 query heads and 5 kv heads of 64, a group of 5, window 1024)
    and the phase 13b shape (a qwen1.5-32b layer: 40 query and 40 kv heads
    of 128, a group of 1, causal and global).
    Every case goes through the CUDA-core
    kernel in f32 and bf16 and, where its head width is 64, 128 or 256,
    through the sm90 kernel in bf16, which must refuse widths 16 and 32;
    ``flash_attention`` itself must give the output of the kernel its route
    names. Not bit-equal to the plain version: the kernels sum in another
    order. f32 is held as the reference's test holds its kernel, |kernel -
    plain| <= 2e-4 + 2e-4 |plain|; bf16 against the plain version's f32
    result on the same inputs, within one bf16 rounding (FLASH_BF16_REL,
    FLASH_BF16_ABS). At the path shapes each kernel is timed beside the
    plain version and one scaled_dot_product_attention call; the kernels
    JSON gets one line per kernel, at one serving-path shape (the sm90
    kernel: gemma's global layer; the CUDA-core kernel: hymba's layer, the
    serving path it took until the sm90 kernel took width 64, kept as the
    row's earlier time), the other shapes beside it (the sm90 kernel's
    ``hymba_layer``)."""
    from repro_torch.kernels import flash_attention as fa

    def held(q, k, v, kw, what) -> dict:
        """Every route of one case: q, k, v are bf16-valued."""
        q32, k32, v32 = q.float(), k.float(), v.float()
        want32 = fa.flash_attention_plain(q32, k32, v32, **kw)
        got32 = fa.flash_fwd(q32, k32, v32, **kw)
        got = {"flash_attention": fa.flash_fwd(q, k, v, **kw)}
        if q.shape[3] in fa.SM90_HEAD_DIMS:
            got["flash_attention_sm90"] = fa.flash_sm90(q, k, v, **kw)
        else:
            try:
                fa.flash_sm90(q, k, v, **kw)
            except ValueError as e:
                assert "head widths" in str(e), e
            else:
                raise AssertionError(f"flash_sm90 took head width {q.shape[3]}: {what}")
        routed = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(bits(torch, routed),
                           bits(torch, got[fa.kernel_route(q.dtype, q.shape[3])])), what
        assert got32.dtype == torch.float32 and got32.shape == q.shape
        assert torch.allclose(got32, want32, rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL), \
            (what, "float32", max_abs_err(torch, got32, want32))
        out = {"f32_err": max_abs_err(torch, got32, want32)}
        for name, got16 in got.items():
            assert got16.dtype == torch.bfloat16 and got16.shape == q.shape
            share = flash_bf16_share(torch, got16, want32)
            assert share <= 1.0, (what, name, share, max_abs_err(torch, got16, want32))
            out[name] = {"bf16_err": max_abs_err(torch, got16, want32), "bf16_share": share}
        del want32, got32, got, routed
        return out

    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {"f32_err": 0.0}
    sm90_cases = 0
    for case in FLASH_CASES:
        B, T, S, H, KV, hd, causal, window, prefix, bq, bk = case
        q = torch.randn((B, T, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(causal=causal, window=window, prefix=prefix, bq=bq, bk=bk)
        res = held(q, k, v, kw, case)
        worst["f32_err"] = max(worst["f32_err"], res.pop("f32_err"))
        sm90_cases += "flash_attention_sm90" in res
        for name, errs in res.items():
            w = worst.setdefault(name, {"bf16_err": 0.0, "bf16_share": 0.0})
            for key, val in errs.items():
                w[key] = max(w[key], val)
    log(f"kernel flash_attention: {len(FLASH_CASES)} cases within tolerance of plain, f32 "
        f"(CUDA-core) max abs err {worst['f32_err']:.3e} (tol 2e-4 + 2e-4 |plain|); bf16 "
        f"against plain's f32, limit 2^-8 |plain| + 1e-5: CUDA-core kernel "
        f"{worst['flash_attention']['bf16_err']:.3e} ({worst['flash_attention']['bf16_share']:.3f}"
        f" of the limit), sm90 kernel on the {sm90_cases} cases of head widths 64, 128 and 256 "
        f"{worst['flash_attention_sm90']['bf16_err']:.3e} "
        f"({worst['flash_attention_sm90']['bf16_share']:.3f} of the limit)")

    kernels = {"flash_attention": (fa.flash_fwd, "flash_attention.cu"),
               "flash_attention_sm90": (fa.flash_sm90, "flash_attention_sm90.cu")}
    # (label, arch, window, the kernel whose JSON line this shape is)
    shapes = (("global", "gemma3-27b", None, "flash_attention_sm90"),
              ("local", "gemma3-27b", 1024, None),
              ("vlm", "paligemma-3b", None, None),
              ("hybrid", "hymba-1.5b", 1024, "flash_attention"),
              ("mha", "qwen1.5-32b", None, None))
    side_key = {"global": "gemma_global", "local": "local_window_1024", "vlm": "paligemma_layer",
                "hybrid": "hymba_layer", "mha": "qwen_layer"}
    lines, sides = {}, {}
    for label, arch, window, line_of in shapes:
        q, k, v, kw = _flash_path_case(torch, gen, arch, window)
        res = held(q, k, v, kw, label)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **kw), reps=3,
                           warmup=1)
        sdpa = _sdpa_call(torch, q, k, v, kw)
        library_ms = time_ms(torch, sdpa, reps=10)
        library_kernel = _sdpa_kernel(torch, sdpa)
        B, T, H, hd = q.shape
        flops, bound, by = _flash_bound(q, k, v, kw)
        for name, (fn, src) in kernels.items():
            if name not in res:  # the sm90 kernel refused this width (held checked it)
                continue
            ms = time_ms(torch, lambda: fn(q, k, v, **kw), reps=20 if "sm90" in name else 10)
            errs = res[name]
            log(f"kernel {name} {label} ({B}, {T}, {H}, {hd}) x ({B}, {k.shape[1]}, "
                f"{k.shape[2]}, {hd}) window {window} prefix {kw['prefix']} tiles "
                f"({kw['bq']}, {kw['bk']}): max abs err f32 {res['f32_err']:.3e} "
                f"(CUDA-core kernel, tol 2e-4 + 2e-4 |plain|), bf16 {errs['bf16_err']:.3e} "
                f"against plain's f32, {errs['bf16_share']:.3f} of the limit 2^-8 |plain| + "
                f"1e-5; bf16 {ms:.4f} ms (bound {bound:.4f} ms by {by}, {bound / ms:.1%} of the "
                f"kernel's time; {flops / 1e9:.1f} GFLOP "
                f"of allowed pairs in kept tiles: {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; "
                f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms "
                f"in {library_kernel})")
            numbers = {"max_abs_err": errs["bf16_err"], "bf16_share_of_limit": errs["bf16_share"],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "library_ms": library_ms, "library_kernel": library_kernel,
                       "gflop": flops / 1e9}
            if name == "flash_attention":
                numbers["max_abs_err_f32"] = res["f32_err"]
            if name == line_of:
                lines[name] = {"name": name, "route": "cuda",
                               "source": f"src/repro_torch/kernels/csrc/{src}",
                               "replaces": "src/repro/kernels/flash_attention.py:102", **numbers,
                               "shape": [list(q.shape), list(k.shape)], "dtype": "bfloat16"}
            else:
                sides.setdefault(name, {})[side_key[label]] = numbers
        del q, k, v
    for name, extra in sides.items():
        lines[name].update(extra)
    return list(lines.values())


def check_param_update(torch) -> list[dict]:
    """mix and scaled_add bit for bit against their plain versions: f32 and
    bf16 at a ragged length, unaligned by one element, then at the flat
    1,048,576,000-element bf16 size of the embedding, timed beside the
    plain versions and one PyTorch call each (lerp, add with alpha)."""
    from repro_torch.kernels import param_update as pu

    gen = torch.Generator(device="cuda").manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        w = torch.randn(100_003, generator=gen, device="cuda").to(dt)
        u = torch.randn(100_003, generator=gen, device="cuda").to(dt)
        for a in (0.25, 0.01, 1e-3 / 7):
            for ws, us in ((w, u), (w[1:], u[1:]), (w[:5], u[:5])):
                assert same_bits(torch, pu.mix(ws, us, a), pu.mix_plain(ws, us, a)), (dt, a)
                assert same_bits(torch, pu.scaled_add(ws, us, a),
                                 pu.scaled_add_plain(ws, us, a)), (dt, a)
    log("kernel mix/scaled_add f32+bf16 at 100,003 / 100,002 (unaligned) / 5 elements, "
        "a in {0.25, 0.01, 1e-3/7}: bit-equal to plain")
    N, a = 1_048_576_000, 0.01
    w = torch.randn(N, generator=gen, device="cuda").to(torch.bfloat16)
    u = torch.randn(N, generator=gen, device="cuda").to(torch.bfloat16)
    lines = []
    for name, fn, plain, library in (
        ("mix", pu.mix, pu.mix_plain, lambda: torch.lerp(w, u, a)),
        ("scaled_add", pu.scaled_add, pu.scaled_add_plain, lambda: torch.add(w, u, alpha=-a)),
    ):
        k = fn(w, u, a)
        p = plain(w, u, a)
        torch.cuda.synchronize()
        assert same_bits(torch, k, p), f"{name} differs from plain"
        err = max_abs_err(torch, k, p)
        del k, p
        ms = time_ms(torch, lambda: fn(w, u, a), reps=10)
        plain_ms = time_ms(torch, lambda: plain(w, u, a), reps=3, warmup=1)
        library_ms = time_ms(torch, library, reps=10)
        bound = 3 * N * 2 / HBM_BYTES_PER_S * 1e3
        log(f"kernel {name} ({N},) bf16 a={a}: bit-equal, {ms:.4f} ms (bound {bound:.4f} ms, "
            f"plain {plain_ms:.4f} ms, {'lerp' if name == 'mix' else 'add(alpha=-a)'} "
            f"{library_ms:.4f} ms)")
        lines.append({"name": name, "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/param_update.cu",
                      "replaces": f"src/repro/kernels/param_update.py:{67 if name == 'mix' else 73}",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": "bytes", "library_ms": library_ms, "shape": [N],
                      "dtype": "bfloat16", "path": "none in either package"})
    del w, u
    torch.cuda.empty_cache()
    return lines


def replicas_equal(torch, stacked, root=None) -> bool:
    from repro_torch.core.tree import tree_leaves

    roots = None if root is None else tree_leaves(root)
    for i, leaf in enumerate(tree_leaves(stacked)):
        ref = leaf[:1] if roots is None else roots[i][None]
        if not bool((bits(torch, leaf) == bits(torch, ref)).all()):
            return False
    return True


def serve(torch) -> tuple[dict, object]:
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    mesh = make_mesh(RANKS, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts["chunked_copy"] > 0, counts
    # every row, the root's included, against the weights that were loaded
    assert replicas_equal(torch, engine.params, params), "a replica differs from the loaded weights"
    del params

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size - 1, size=(BATCH, PROMPT))
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    assert res.tokens.shape == (BATCH, STEPS) and res.logprobs.shape == (BATCH, STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    peak = torch.cuda.max_memory_allocated()

    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS)
    out = {
        "params": n_params, "replica_bytes": n_params * 2,
        "distribute_s": dist_s, "chunked_copy_launches": counts["chunked_copy"],
        "generate_s": gen_s, "prefill_ms_per_rank": prefill_s / RANKS * 1e3,
        "decode_tokens_per_s": BATCH * STEPS / decode_s,
        "max_memory_allocated": peak, "first_tokens": res.tokens[:, :4].tolist(),
    }
    log(f"serve: {n_params} params, distribution {dist_s:.3f} s "
        f"({counts['chunked_copy']} chunked_copy launches), generate {gen_s:.3f} s (cold, "
        f"whole call); warm: prefill {out['prefill_ms_per_rank']:.2f} ms/rank, "
        f"decode steps {out['decode_tokens_per_s']:.1f} tok/s; peak {peak / 2**30:.2f} GiB")
    return out, engine


def _rank_batches(torch, tokens, embeds=None, ranks: int = RANKS) -> list[dict]:
    """Each data rank's requests, split as ``Engine.generate`` splits the
    batch over ``ranks`` data ranks."""
    tok = torch.as_tensor(tokens, device="cuda")
    embs = [None] * ranks if embeds is None else torch.tensor_split(embeds, ranks)
    return [{"tokens": part, "embeds": emb}
            for part, emb in zip(torch.tensor_split(tok, ranks), embs)]


def time_prefill_decode(torch, engine, tokens, steps: int, embeds=None) -> tuple[float, float]:
    """A warm re-run of ``generate``'s greedy loop over ``tokens`` (B, T)
    (and a vision config's patch ``embeds``), data rank by data rank on
    each one's replica (on a model axis, its model ranks' shards), with
    prefill and the ``steps`` decode steps (``decode_step`` and the argmax,
    at positions after the prefix and the text) timed in separate windows,
    each closed by a synchronize. Returns the seconds of all data ranks'
    prefills and of all their decode steps."""
    T = tokens.shape[1]
    offset = engine.cfg.prefix_len if engine.cfg.frontend == "vision" else 0
    prefill_s = decode_s = 0.0
    with torch.no_grad():
        for r, batch in enumerate(_rank_batches(torch, tokens, embeds, engine.n)):
            params = engine.replica(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = engine.prefill(params, batch, max_len=T + steps)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            nxt = torch.argmax(logits[:, -1], dim=-1)
            del logits  # (B, T, vocab) f32: 4.3 GB a rank at gemma's 4096 x 262,144
            for i in range(steps):
                logits, caches = engine.decode_step(params, nxt[:, None], caches,
                                                    T + offset + i)
                nxt = torch.argmax(logits[:, 0], dim=-1)
            torch.cuda.synchronize()
            prefill_s += t1 - t0
            decode_s += time.perf_counter() - t1
    return prefill_s, decode_s


def _kernel_class(name: str) -> str:
    """A device kernel's class by its name: the flash kernels, matmuls
    (cuBLAS and CUTLASS GEMMs, cuBLAS's ``nvjet`` ones included), PyTorch's
    element-wise kernels, or other (reductions, copies, concatenations)."""
    if "flash_fwd" in name:
        return "flash"
    if any(s in name for s in ("gemm", "Gemm", "cutlass", "xmma", "gemv", "cublas", "nvjet")):
        return "matmul"
    return "elementwise" if "elementwise" in name else "other"


def device_rows(prof) -> list:
    """``(name, device ms, launches)`` of every kernel and copy a
    ``torch.profiler`` run recorded on the card, by name, largest first:
    read from the profiler's raw device events, where ``key_averages()``
    first turns every event into a Python object, which took most of a
    profiled prefill of 10^5 launches."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((name, ms, n) for name, (ms, n) in rows.items()), key=lambda r: -r[1])


def profile_prefill(torch, engine, tokens, top: int = 8, embeds=None,
                    label: str = "serve long", ranks: int = RANKS) -> list[dict]:
    """One warm prefill of the prompt of each of the first ``ranks`` ranks
    (one request a rank) on its replica under ``torch.profiler``, after one
    unprofiled warm-up prefill: wall ms, device ms (the kernels of one
    stream do not overlap, so their sum is the busy time), the flash
    kernels' ms (both names, ``flash_fwd`` and ``flash_fwd_sm90``), the
    device ms by kernel class (:func:`_kernel_class`) and the ``top``
    kernels as ``(name, ms, launches)`` (:func:`device_rows`). The profiler
    records the device activity alone: with the host's operators too, its
    own processing of a prefill of about 10^5 launches takes longer than the
    phase's serving."""
    from torch.profiler import ProfilerActivity, profile

    max_len = tokens.shape[1] + STEPS
    out = []
    for r, batch in enumerate(_rank_batches(torch, tokens, embeds, engine.n)[:ranks]):
        params = engine.replica(r)
        with torch.no_grad():
            engine.prefill(params, batch, max_len=max_len)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits = engine.prefill(params, batch, max_len=max_len)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            del logits
        kern = device_rows(prof)
        by_class: dict = {}
        for name, ms, _n in kern:
            by_class[_kernel_class(name)] = by_class.get(_kernel_class(name), 0.0) + ms
        res = {"wall_ms": wall_ms, "device_ms": sum(row[1] for row in kern),
               "flash_ms": sum(ms for name, ms, _n in kern
                               if "flash_fwd<" in name or "flash_fwd_sm90" in name),
               "by_class_ms": {k: round(v, 3) for k, v in sorted(by_class.items())},
               "launches": sum(row[2] for row in kern),
               "top": [(name[:60], round(ms, 3), n) for name, ms, n in kern[:top]]}
        log(f"{label} profile rank {r} (one warm prefill, profiler on): wall "
            f"{res['wall_ms']:.2f} ms, device kernels {res['device_ms']:.2f} ms "
            f"({res['device_ms'] / res['wall_ms']:.1%} busy, {res['launches']} launches), "
            f"flash {res['flash_ms']:.2f} ms; by class {res['by_class_ms']}; top kernels "
            f"(name, ms, launches): {res['top']}")
        out.append(res)
    return out


def serve_long(torch) -> dict:
    """Phase 4c: gemma3-27b at full width (6 of 62 layers: five local
    layers of window 1024 and the global one, bf16, seeded random weights)
    distributed to 4 emulated ranks, staged through chunked_copy, then
    ``generate`` of one 4096-token
    prompt per rank and 32 decode steps (max_len 4128: the local layers'
    caches are rings of 1024), then the warm re-run and one profiled
    prefill per rank. Every layer's prefill (bf16, head width 128) goes
    through the sm90 flash kernel: 6 x 4 launches per pass, none of the
    CUDA-core one. Launch counts are zeroed by the caller right before; the
    profiled prefills are counted apart."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(get_config("gemma3-27b"), num_layers=LONG_LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=make_mesh(RANKS, device="cuda"), distribute=True,
                    double_buffer=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts["flash_attention_sm90"] == 0 and counts["chunked_copy"] > 0, counts
    assert replicas_equal(torch, engine.params, params), "a gemma replica differs from the weights"
    # the replicas sit in the stacked leaves, each rank's row where the leaf's row starts
    assert all(t.is_contiguous() for t in tree_leaves(engine.params))
    del params
    dist_peak = torch.cuda.max_memory_allocated()

    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size - 1, size=(RANKS, LONG_PROMPT))
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    cold = kernels.launch_counts()["flash_attention_sm90"]
    assert res.tokens.shape == (RANKS, STEPS) and res.logprobs.shape == (RANKS, STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    assert cold == LONG_LAYERS * RANKS, cold
    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS)
    warm = kernels.launch_counts()["flash_attention_sm90"] - cold
    assert warm == LONG_LAYERS * RANKS, warm
    assert kernels.launch_counts()["flash_attention"] == 0, "a bf16 prefill left the sm90 route"
    peak = torch.cuda.max_memory_allocated()
    assert peak < torch.cuda.get_device_properties(0).total_memory, peak
    out = {
        "params": n_params, "replica_bytes": n_params * 2, "distribute_s": dist_s,
        "distribute_peak": dist_peak, "chunked_copy_launches": counts["chunked_copy"],
        "generate_s": gen_s,
        "prefill_ms_per_rank": prefill_s / RANKS * 1e3,
        "decode_tokens_per_s": RANKS * STEPS / decode_s, "max_memory_allocated": peak,
        "flash_attention_launches": {"cold": cold, "warm": warm},
        "first_tokens": res.tokens[:, :4].tolist(),
    }
    log(f"serve long: gemma3-27b {LONG_LAYERS} layers, {n_params} params, distribution "
        f"{dist_s:.3f} s ({counts['chunked_copy']} chunked_copy launches, peak "
        f"{dist_peak / 2**30:.2f} GiB), generate {gen_s:.3f} s (cold, {RANKS} x "
        f"{LONG_PROMPT} tokens + {STEPS} steps); warm: prefill "
        f"{out['prefill_ms_per_rank']:.2f} ms/rank, decode steps "
        f"{out['decode_tokens_per_s']:.1f} tok/s; flash_attention_sm90 launches {cold} cold + "
        f"{warm} warm; peak {peak / 2**30:.2f} GiB")
    out["counts"] = kernels.launch_counts()  # the path's; the profiled prefills come after
    out["profile"] = profile_prefill(torch, engine, tokens)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_vlm(torch) -> dict:
    """Phase 4d: paligemma-3b at full width and depth (18 layers, bf16,
    seeded random weights) distributed to 4 emulated ranks, staged through
    chunked_copy, then ``generate`` of one request per rank (256 stub patch
    embeddings and 3840 text tokens from the port's ``batches``: 4096
    positions) and 32 decode steps (positions 4096-4127, after the prefix
    and the text), then the warm re-run and one profiled prefill per rank.
    Every layer's prefill (bf16, head width 256) goes through the sm90
    flash kernel: 18 x 4 launches per pass, none of the CUDA-core one. Launch
    counts are zeroed by the caller right before; the profiled prefills are
    counted apart."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    cfg = get_config("paligemma-3b")
    params = Model(cfg).init(seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=make_mesh(RANKS, device="cuda"), distribute=True,
                    double_buffer=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts["flash_attention_sm90"] == 0 and counts["chunked_copy"] > 0, counts
    assert replicas_equal(torch, engine.params, params), "a paligemma replica differs"
    del params
    dist_peak = torch.cuda.max_memory_allocated()

    batch = next(batches(make_source(cfg, seed=2), cfg, batch=RANKS, seq=VLM_TEXT,
                         device="cuda"))
    tokens, embeds = batch["tokens"], batch["embeds"]
    assert tuple(embeds.shape) == (RANKS, cfg.prefix_len, cfg.d_model)
    assert embeds.dtype == torch.bfloat16
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens, "embeds": embeds}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    cold = kernels.launch_counts()["flash_attention_sm90"]
    assert res.tokens.shape == (RANKS, STEPS) and res.logprobs.shape == (RANKS, STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    assert cold == cfg.num_layers * RANKS, cold
    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS, embeds)
    warm = kernels.launch_counts()["flash_attention_sm90"] - cold
    assert warm == cfg.num_layers * RANKS, warm
    assert kernels.launch_counts()["flash_attention"] == 0, "a bf16 prefill left the sm90 route"
    peak = torch.cuda.max_memory_allocated()
    assert peak < torch.cuda.get_device_properties(0).total_memory, peak
    out = {
        "params": n_params, "replica_bytes": n_params * 2, "distribute_s": dist_s,
        "distribute_peak": dist_peak, "chunked_copy_launches": counts["chunked_copy"],
        "generate_s": gen_s,
        "prefill_ms_per_rank": prefill_s / RANKS * 1e3,
        "decode_tokens_per_s": RANKS * STEPS / decode_s, "max_memory_allocated": peak,
        "flash_attention_launches": {"cold": cold, "warm": warm},
        "first_tokens": res.tokens[:, :4].tolist(),
    }
    log(f"serve vlm: paligemma-3b {cfg.num_layers} layers, {n_params} params, distribution "
        f"{dist_s:.3f} s ({counts['chunked_copy']} chunked_copy launches, peak "
        f"{dist_peak / 2**30:.2f} GiB), generate {gen_s:.3f} s (cold, {RANKS} x "
        f"({cfg.prefix_len} patches + {VLM_TEXT} tokens) + {STEPS} steps); warm: prefill "
        f"{out['prefill_ms_per_rank']:.2f} ms/rank, decode steps "
        f"{out['decode_tokens_per_s']:.1f} tok/s; flash_attention_sm90 launches {cold} cold + "
        f"{warm} warm, flash_attention 0; peak {peak / 2**30:.2f} GiB")
    out["counts"] = kernels.launch_counts()  # the path's; the profiled prefills come after
    out["profile"] = profile_prefill(torch, engine, tokens, embeds=embeds, label="serve vlm")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compiled_replay(torch, root, mesh) -> tuple[dict, dict]:
    """``root``: phase 3's root replica (a copy; the engine is gone). Row 0
    of the new stack is that copy, so the replicas are held against it.
    Returns the phase's numbers and the distributed tree."""
    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.serve import distribute_weights, replicate

    stacked = replicate(root, RANKS, fill_root_only=True)
    root.clear()  # row 0 of the stack holds it now
    for leaf in tree_leaves(stacked):
        leaf[1:].fill_(float("nan"))
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, plans = distribute_weights(stacked, mesh, algo="pipelined_chain", compiled=True,
                                    double_buffer=True, return_plans=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = kernels.launch_counts()
    launched = after["fused_combine"] - before["fused_combine"]
    assert launched > 0, (before, after)
    assert replicas_equal(torch, out, tree_map(lambda t: t[0], stacked)), \
        "compiled replicas differ from phase 3's"
    rounds = sum(p.lowered().num_rounds for ps in plans.values() for p in ps)
    log(f"compiled: pipelined_chain over {len(plans['data'])} buckets, {rounds} rounds, "
        f"{launched} fused_combine launches, {secs:.3f} s, replicas bit-equal to phase 3")
    return {"distribute_s": secs, "fused_combine_launches": launched, "rounds": rounds}, out


def record_inkernel_table(torch, tuner, buckets, op: str, extras: list[dict],
                          n: int = RANKS) -> list:
    """For each bucket ``(bytes, elements, dtype)``: the analytic plan's
    algo and chunk count on ``n`` ranks, one timed in-kernel replay of it
    (the device-initiated kernel, which ``execute_inkernel`` runs) on a
    scratch buffer of the bucket's chunked shape (after one warm-up
    replay), and a ``record`` into each tuner of ``tuner`` with the
    matching ``extras``. Returns ``(algo, chunks, rounds, classes, ms)``
    per bucket."""
    from repro_torch.comm import plan_cached
    from repro_torch.kernels.inkernel_collective import rdma_replay

    rows = []
    for M, elems, dtype in buckets:
        plan = plan_cached(op, M, n)
        low = plan.lowered()
        buf = torch.zeros((n, low.num_chunks, -(-elems // low.num_chunks)), dtype=dtype,
                          device="cuda")
        ms = time_ms(torch, lambda: rdma_replay(low, buf), reps=1, warmup=1)
        del buf
        for t, ex in zip(tuner, extras):
            t.record(M, n, plan.algo, plan.num_chunks, ms * 1e-3, op=op, extras=ex)
        rows.append((plan.algo, plan.num_chunks, low.num_rounds, low.num_classes, ms))
    torch.cuda.empty_cache()
    return rows


def tuned_inkernel(torch, stacked, mesh) -> dict:
    """Phase 4b: a tuner table built on the card (every serving bucket's
    analytic plan, timed as one in-kernel replay, recorded with
    ``exec_path='inkernel'``, saved and loaded back), then
    ``distribute_weights(tuner=...)`` from NaN-filled replicas. ``stacked``
    is phase 4's result: row 0 holds phase 3's weights. Launch counts are
    zeroed right before the distribution and read right after."""
    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.core.tuner import Tuner
    from repro_torch.serve import distribute_weights
    from repro_torch.serve.engine import plan_distribution

    spec, _plans = plan_distribution(stacked, mesh)
    tuner = Tuner()
    buckets = list(zip(spec.bucket_bytes(), spec.bucket_sizes, spec.bucket_dtypes))
    rows = record_inkernel_table(torch, [tuner], buckets, "bcast", [{"exec_path": "inkernel"}])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "serve_table.json")
        tuner.save(path)
        loaded = Tuner.load(path)
    root = tree_map(lambda t: t[0], stacked)
    for leaf in tree_leaves(stacked):
        leaf[1:].fill_(float("nan"))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, plans = distribute_weights(stacked, mesh, tuner=loaded, double_buffer=True,
                                    return_plans=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    replayed = sum(1 for p in plans["data"] if p.lowered() is not None
                   and p.lowered().num_rounds > 0)
    assert all(p.decision.exec_path == "inkernel" for p in plans["data"]), plans
    assert counts["fused_combine"] == 0 == counts["inkernel_replay"], counts
    assert counts["inkernel_rdma"] == replayed > 0, (counts, replayed)
    assert replicas_equal(torch, out, root), "in-kernel replicas differ from phase 3's"
    log(f"tuned in-kernel: table of {len(tuner.table)} entries from {len(rows)} buckets "
        f"(algo, chunks, rounds, classes, replay ms: {rows}); distribution {secs:.3f} s, "
        f"{counts['inkernel_rdma']} inkernel_rdma launches for {replayed} bucket plans, "
        f"{counts['chunked_copy']} chunked_copy, 0 fused_combine, 0 inkernel_replay; replicas "
        "bit-equal to "
        "phase 3")
    return {"distribute_s": secs, "counts": counts, "plans": replayed, "buckets": rows}


def _plain_collective(torch, plan, x):
    """What ``apply_plan(plan, x)`` returns with the device-initiated
    replay's plain version (``rdma_replay_plain``) in place of its kernel:
    the same buffer layout for each op, on the card. Updates ``x`` in place
    where its flat length divides into the plan's chunks."""
    from repro_torch.comm.api import _chunked, _unchunked
    from repro_torch.kernels import inkernel_collective as ik

    n, low = plan.n, plan.lowered()
    flat = x.reshape(n, -1)
    ranks = torch.arange(n, device=x.device)
    if plan.op == "allgather":
        buf = torch.zeros((n, n, flat.shape[1]), dtype=x.dtype, device=x.device)
        buf[ranks, ranks] = flat
        return ik.rdma_replay_plain(low, buf).reshape((n, n) + tuple(x.shape[1:]))
    if plan.op == "reduce_scatter":
        return ik.rdma_replay_plain(low, _chunked(flat, n)[0])[ranks, ranks]
    buf, pad = _chunked(flat, low.num_chunks)
    return _unchunked(ik.rdma_replay_plain(low, buf), pad, x.shape)


def collectives(torch) -> dict:
    """Phase 7: the four collective entry points at the size of minitron-8b's
    training embedding bucket (1,048,576,000 bf16 elements a rank) on the 4
    emulated ranks, each through the device-initiated in-kernel executor
    (``inkernel=True``) and the compiled one (``compiled=True``), held bit
    for bit against each other and against the device-initiated replay's
    plain version on the same buffer (:func:`_plain_collective`):
    ``pallgather`` of the per-rank quarter shards, ``preduce_scatter``,
    ``preduce`` and ``pallreduce``, at the planner's own choice of
    algorithm; then the one-shot max and min ``pallreduce`` on 16M f32
    elements a rank, against ``torch.amax`` / ``amin``. Launch counts are
    zeroed by the caller before this phase; the plain version launches no
    kernel."""
    from repro_torch import comm, kernels
    from repro_torch.comm import plan_cached
    from repro_torch.configs import get_config

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((RANKS, N), generator=gen, device="cuda", dtype=torch.bfloat16)
    shards = x[:, :N // RANKS].clone()
    runs = (("pallgather", "allgather", shards, comm.pallgather),
            ("preduce_scatter", "reduce_scatter", x, comm.preduce_scatter),
            ("preduce", "reduce", x, comm.preduce),
            ("pallreduce", "allreduce", x, comm.pallreduce))
    out = {}
    for name, op, value, fn in runs:
        plan = plan_cached(op, (RANKS if op == "allgather" else 1) * value[0].numel() * 2, RANKS)
        res, secs, launched = [], [], []
        for flag in ("inkernel", "compiled"):
            arg = value.clone()  # the executors update a divisible buffer in place
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res.append(fn(arg, **{flag: True}))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            after = kernels.launch_counts()
            launched.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
            del arg
        assert launched[0] == {"inkernel_rdma": 1}, (name, launched)
        assert launched[1].get("inkernel_rdma", 0) == 0 < launched[1]["fused_combine"], \
            (name, launched)
        assert same_bits(torch, res[0], res[1]), f"{name}: inkernel and compiled differ"
        assert bool(torch.isfinite(res[0]).all()), name
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = _plain_collective(torch, plan, value.clone())
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        assert kernels.launch_counts() == after, (name, "the plain version launched a kernel")
        assert same_bits(torch, res[0], want), f"{name}: inkernel differs from its plain version"
        del want
        out[name] = {"algo": plan.algo, "chunks": plan.num_chunks,
                     "shape": list(res[0].shape), "inkernel_s": secs[0],
                     "compiled_s": secs[1], "plain_s": plain_s, "launches": launched}
        log(f"collectives {name}: {plan.algo} K={plan.num_chunks}, {tuple(value.shape)} -> "
            f"{tuple(res[0].shape)} bf16: inkernel {secs[0]:.4f} s ({launched[0]}), compiled "
            f"{secs[1]:.4f} s ({launched[1]}), plain {plain_s:.4f} s: all three bit-equal")
        del res
        torch.cuda.empty_cache()
    del x, shards
    torch.cuda.empty_cache()
    y = torch.randn((RANKS, 1 << 24), generator=gen, device="cuda")
    for combiner, reduce in (("max", torch.amax), ("min", torch.amin)):
        t0 = time.perf_counter()
        got = comm.pallreduce(y.clone(), combiner=combiner)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert torch.equal(got, reduce(y, dim=0, keepdim=True).expand_as(y)), combiner
        out[f"pallreduce_{combiner}"] = {"shape": list(y.shape), "s": secs}
        log(f"collectives pallreduce combiner={combiner}: ({RANKS}, {1 << 24}) f32 one-shot, "
            f"{secs:.4f} s, equal to torch.{reduce.__name__}")
    return out


def _simulated_bucket(torch, plan, bucket):
    """The numpy replay (``simulate_lowered``) of ``plan`` on the rank-stacked
    bucket ``(n, size)``, in f32; returns its first ``size`` columns."""
    import numpy as np

    from repro_torch.comm.api import _chunked
    from repro_torch.core.simulator import simulate_lowered

    size = bucket.shape[1]
    buf, _pad = _chunked(bucket, plan.lowered().num_chunks, dtype=torch.float32)
    want = simulate_lowered(plan.lowered(), list(buf.cpu().numpy()))
    return np.stack(want).reshape(bucket.shape[0], -1)[:, :size]


def streams(torch) -> dict:
    """Phase 8: a 2-entry stream graph from ``plan_streams`` over the
    1-layer minitron-8b parameter shapes of phase 6 on the 4 emulated ranks:
    ``grad_sync`` (allreduce, reversed, priority 1) and ``weight_prefetch``
    (bcast, priority 0, after grad_sync), replayed by
    ``execute_streams(stage=True, compiled=True)``. The gradients are
    random bf16 rows; the prefetch tree's row 0 holds random weights and
    rows 1-3 NaN, which the broadcast must overwrite. Bucket 0 of each entry
    holds small integers, exact in bf16 and f32 through every partial sum,
    so that it can be held against the numpy replay of its plan. Checks:
    each tree bit-equal to its entry replayed alone through
    ``execute_stream_entry``, bucket 0 bit-equal to ``simulate_lowered``,
    replicas bit-equal, one ``chunked_copy`` per non-empty bucket and one
    ``fused_combine`` per class-round. Launch counts are zeroed right
    before the interleave and read right after it."""
    from repro_torch import kernels
    from repro_torch.comm import (StreamSpec, dispatch_schedule, execute_stream_entry,
                                  execute_streams, plan_streams)
    from repro_torch.configs import RunConfig
    from repro_torch.core import bucketing
    from repro_torch.core.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    shapes = _phase8_shapes(torch)
    run = RunConfig(**TRAIN_RUN)
    axes = (("data", RANKS),)
    graph = plan_streams([
        StreamSpec(name="grad_sync", tree=shapes, axes=axes, op="allreduce", priority=1,
                   bucket_bytes=run.bcast_bucket_bytes, reverse=True),
        StreamSpec(name="weight_prefetch", tree=shapes, axes=axes, op="bcast", priority=0,
                   after=("grad_sync",), bucket_bytes=run.bcast_bucket_bytes),
    ])
    gen = torch.Generator(device="cuda").manual_seed(8)
    first = frozenset(m.index for m in graph.entries[0].spec.leaves if m.bucket == 0)
    trees = {"grad_sync": _phase8_tree(torch, shapes, gen, root_only=False, small=first),
             "weight_prefetch": _phase8_tree(torch, shapes, gen, root_only=True, small=first)}
    alone = {name: tree_map(lambda t: t.clone(), t) for name, t in trees.items()}
    want0 = {}
    for e in graph.entries:
        b0 = bucketing.pack_buckets(trees[e.name], e.spec)[0]
        want0[e.name] = _simulated_bucket(torch, e.plans["data"][0], b0)
    sched = dispatch_schedule(graph)

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = execute_streams(graph, trees, stage=True, compiled=True)
    torch.cuda.synchronize()
    interleave_s = time.perf_counter() - t0
    counts = kernels.launch_counts()

    t0 = time.perf_counter()
    for e in graph.entries:
        execute_stream_entry(e, alone[e.name], stage=True, compiled=True)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0

    buckets = staged = merges = 0
    for e in graph.entries:
        got, want = tree_leaves(out[e.name]), tree_leaves(alone[e.name])
        assert all(same_bits(torch, a, b) for a, b in zip(got, want)), \
            f"{e.name}: the interleave differs from the entry replayed alone"
        for t in got:  # every rank holds the same result
            assert all(same_bits(torch, t[r], t[0]) for r in range(1, RANKS)), e.name
        b0 = bucketing.pack_buckets(out[e.name], e.spec)[0]
        assert (b0.float().cpu().numpy() == want0[e.name]).all(), \
            f"{e.name}: bucket 0 differs from simulate_lowered"
        for k, size in enumerate(e.spec.bucket_sizes):
            low = e.plans["data"][k].lowered()
            buckets += 1
            staged += size > 0
            merges += len(low.classes) * low.num_rounds if size and low is not None else 0
    assert counts["chunked_copy"] == staged and counts["fused_combine"] == merges, \
        (counts, staged, merges)
    assert counts["inkernel_rdma"] == 0 == counts["inkernel_replay"], counts
    del trees, alone, out
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    rec = {"buckets": buckets, "staged": staged, "merges": merges, "interleave_s": interleave_s,
           "serial_s": serial_s, "phase_s": phase_s,
           "entries": {e.name: {"algos": sorted({p.algo for p in e.plans["data"]}),
                                "depth": e.overlap_depth, "depth_source": e.depth_source,
                                "priority": e.priority} for e in graph.entries},
           "dispatch": len(sched)}
    log(f"streams: grad_sync + weight_prefetch over {buckets} buckets ({staged} staged), "
        f"{counts['chunked_copy']} chunked_copy and {counts['fused_combine']} fused_combine "
        f"launches (one a non-empty bucket, one a class-round); each tree bit-equal to its "
        f"entry alone, bucket 0 to simulate_lowered, replicas bit-equal; entries "
        f"{rec['entries']}; host clock: interleave {interleave_s:.4f} s, the two entries one "
        f"after the other {serial_s:.4f} s (one sample each); phase {phase_s:.1f} s")
    rec["counts"] = counts
    return rec


def _launched(torch, before: dict) -> dict:
    from repro_torch import kernels

    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def algorithms(torch) -> dict:
    """Phase 7b: ``core.algorithms`` on the card. ``pipelined_chain_fused``
    bit-equal to ``execute_collective`` of the same ``pipelined_chain``
    schedule at 4 x 21 chunks of bf16 (:data:`ALG_ELEMS` a rank, rows 1-3
    NaN); ``schedule_bcast`` at 21 chunks (the unrolled replay) and at 300
    (the compiled one, which must launch fused_combine) bit-equal to the
    root's row; ``ring_allreduce`` at 4 x :data:`ALG_ELEMS` in f32 and bf16
    bit-equal to the same call on the CPU; then ``ring_allreduce`` at the
    training embedding bucket (1,048,576,000 bf16 a rank) timed with CUDA
    events beside ``pallreduce(algo='ring_allreduce')`` compiled and
    in-kernel, after one warm-up call each, all three bit-equal. Launch
    counts are zeroed by the caller right before."""
    from repro_torch import comm, kernels
    from repro_torch.comm.executors import execute_collective
    from repro_torch.configs import get_config
    from repro_torch.core import algorithms as alg
    from repro_torch.core.schedules import build

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}

    def stacked(K: int):
        buf = torch.randn((RANKS, K, -(-ALG_ELEMS // K)), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        buf[1:] = float("nan")
        return buf

    def rooted(buf, got) -> bool:
        return all(same_bits(torch, got[r], buf[0]) for r in range(RANKS))

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    buf = stacked(21)
    fused, fused_ms = timed(lambda: alg.pipelined_chain_fused(buf.clone(), root=0))
    generic, generic_ms = timed(lambda: execute_collective(
        build("pipelined_chain", RANKS, 0, num_chunks=21), buf.clone()))
    assert same_bits(torch, fused, generic), "pipelined_chain_fused differs from the schedule"
    assert rooted(buf, fused), "pipelined_chain_fused is not the root's row"
    out["pipelined_chain_fused"] = {"shape": list(buf.shape), "ms": fused_ms,
                                    "execute_collective_ms": generic_ms}
    del fused, generic
    for K in (21, 300):
        buf = stacked(K)
        before = kernels.launch_counts()
        got, ms = timed(lambda: alg.schedule_bcast(buf.clone(), algo="pipelined_chain"))
        launched = _launched(torch, before)
        assert rooted(buf, got), f"schedule_bcast K={K} is not the root's row"
        if K == 300:  # 302 rounds: the compiled replay, one merge a class-round
            assert launched.get("fused_combine", 0) > 0, launched
        else:
            assert not launched, launched
        out[f"schedule_bcast_K{K}"] = {"shape": list(buf.shape), "ms": ms, "launches": launched}
        del got
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((RANKS, ALG_ELEMS), generator=torch.Generator().manual_seed(9))
        x = x.to(dtype)
        want = alg.ring_allreduce(x.clone())
        got = alg.ring_allreduce(x.cuda())
        assert same_bits(torch, got.cpu(), want), f"ring_allreduce {dtype}: card differs from CPU"
        del x, want, got
    log(f"algorithms: pipelined_chain_fused {tuple(out['pipelined_chain_fused']['shape'])} bf16 "
        f"bit-equal to execute_collective ({fused_ms:.3f} / {generic_ms:.3f} ms) and the root; "
        f"schedule_bcast K=21 ({out['schedule_bcast_K21']['ms']:.3f} ms, "
        f"{out['schedule_bcast_K21']['launches']}) and K=300 "
        f"({out['schedule_bcast_K300']['ms']:.3f} ms, {out['schedule_bcast_K300']['launches']}) "
        f"bit-equal to the root; ring_allreduce ({RANKS}, {ALG_ELEMS}) f32 and bf16 card "
        "bit-equal to CPU")
    torch.cuda.empty_cache()
    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    x = torch.randn((RANKS, N), generator=gen, device="cuda", dtype=torch.bfloat16)
    runs = (("ring_allreduce", lambda a: alg.ring_allreduce(a)),
            ("pallreduce compiled", lambda a: comm.pallreduce(a, algo="ring_allreduce",
                                                              compiled=True)),
            ("pallreduce inkernel", lambda a: comm.pallreduce(a, algo="ring_allreduce",
                                                              inkernel=True)))
    ring, times = None, {}
    for name, fn in runs:
        fn(x.clone())  # warm-up: the plan is built and lowered on the host once
        before = kernels.launch_counts()
        res, ms = timed(lambda: fn(x.clone()))
        times[name] = {"ms": ms, "launches": _launched(torch, before)}
        if ring is None:
            ring = res
        else:
            assert same_bits(torch, res, ring), f"{name} differs from ring_allreduce"
        del res
    out["ring_embedding"] = {"shape": [RANKS, N], **times}
    log(f"algorithms ring at the embedding bucket ({RANKS}, {N}) bf16, CUDA events (the "
        "clone of the input included), all three bit-equal: " + ", ".join(
            f"{k} {v['ms']:.3f} ms {v['launches']}" for k, v in times.items()))
    del x, ring
    torch.cuda.empty_cache()
    return out


def _phase8_shapes(torch):
    """The 1-layer minitron-8b parameter shapes of phase 6 (meta tensors)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    shapes = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    del params
    torch.cuda.empty_cache()
    return shapes


def _phase8_tree(torch, shapes, gen, *, root_only: bool, small=frozenset()):
    """A rank-stacked tree of ``shapes`` on the 4 emulated ranks: random
    rows (leaves in ``small`` hold small integers, exact in bf16 and f32
    through every partial sum), rows 1-3 NaN when ``root_only``."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(shapes)
    out = []
    for i, m in enumerate(leaves):
        t = torch.empty((RANKS,) + tuple(m.shape), dtype=m.dtype, device="cuda")
        if i in small:
            t.copy_(torch.randint(-8, 8, t.shape, generator=gen, device="cuda"))
        else:
            t.normal_(generator=gen)
        if root_only:
            t[1:] = float("nan")
        out.append(t)
    return tree_unflatten(treedef, out)


def tree_variants(torch) -> dict:
    """Phase 8b: the tree collectives over phase 8's two rank-stacked trees
    (phase 6's parameter shapes on the 4 emulated ranks: random gradient
    rows, and weights in row 0 with rows 1-3 NaN). ``pallreduce_tree`` and
    ``pbcast_tree`` with ``stage=True`` bit-equal to ``stage=False``, with
    one ``chunked_copy`` per non-empty bucket (and none unstaged);
    ``pbcast_tree(inter_pod=True)`` bit-equal too, every replica the root's
    row; the buckets whose broadcast algorithm the inter-pod price changes
    are counted. Launch counts are zeroed by the caller right before."""
    from repro_torch import comm, kernels
    from repro_torch.comm import plan_cached
    from repro_torch.configs import RunConfig
    from repro_torch.core import bucketing
    from repro_torch.core.tree import tree_leaves, tree_map

    shapes = _phase8_shapes(torch)
    bb = RunConfig(**TRAIN_RUN).bcast_bucket_bytes
    spec = bucketing.plan_buckets(shapes, bb)
    buckets = [(M, size) for M, size in zip(spec.bucket_bytes(), spec.bucket_sizes)]
    nonempty = sum(1 for _M, size in buckets if size)
    gen = torch.Generator(device="cuda").manual_seed(10)

    def clone(t):
        return tree_map(lambda a: a.clone(), t)

    def same(a, b) -> bool:
        return all(same_bits(torch, x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    def run(fn, tree, **kw):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(tree, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, _launched(torch, before)

    rec = {"buckets": len(buckets), "nonempty": nonempty}
    grads = _phase8_tree(torch, shapes, gen, root_only=False)
    plain, plain_s, plain_n = run(lambda t, **kw: comm.pallreduce_tree(t, ("data",), **kw),
                                  clone(grads), bucket_bytes=bb)
    staged, staged_s, staged_n = run(lambda t, **kw: comm.pallreduce_tree(t, ("data",), **kw),
                                     grads, bucket_bytes=bb, stage=True)
    assert same(plain, staged), "pallreduce_tree: stage=True differs from stage=False"
    assert plain_n.get("chunked_copy", 0) == 0 and staged_n["chunked_copy"] == nonempty, \
        (plain_n, staged_n, nonempty)
    rec["pallreduce_tree"] = {"s": plain_s, "staged_s": staged_s, "launches": plain_n,
                              "staged_launches": staged_n}
    del grads, plain, staged
    torch.cuda.empty_cache()
    weights = _phase8_tree(torch, shapes, gen, root_only=True)
    root = [t[0].clone() for t in tree_leaves(weights)]
    plain, plain_s, plain_n = run(comm.pbcast_tree, clone(weights), bucket_bytes=bb)
    staged, staged_s, staged_n = run(comm.pbcast_tree, weights, bucket_bytes=bb, stage=True)
    assert same(plain, staged), "pbcast_tree: stage=True differs from stage=False"
    assert plain_n.get("chunked_copy", 0) == 0 and staged_n["chunked_copy"] == nonempty, \
        (plain_n, staged_n, nonempty)
    del staged
    inter, inter_s, inter_n = run(comm.pbcast_tree, weights, bucket_bytes=bb, inter_pod=True)
    assert same(plain, inter), "pbcast_tree: inter_pod=True differs"
    for t, r in zip(tree_leaves(plain), root):
        assert all(same_bits(torch, t[k], r) for k in range(RANKS)), "a replica is not the root's"
    changed = [(plan_cached("bcast", M, RANKS).algo, plan_cached("bcast", M, RANKS,
                                                                  inter_pod=True).algo)
               for M, size in buckets if size]
    moved = sum(a != b for a, b in changed)
    rec["pbcast_tree"] = {"s": plain_s, "staged_s": staged_s, "inter_pod_s": inter_s,
                          "launches": plain_n, "staged_launches": staged_n,
                          "inter_pod_launches": inter_n, "algos": changed,
                          "inter_pod_changed": moved}
    del weights, plain, inter, root
    torch.cuda.empty_cache()
    ar, bc = rec["pallreduce_tree"], rec["pbcast_tree"]
    log(f"trees: {len(buckets)} buckets ({nonempty} non-empty), host clock: pallreduce_tree "
        f"stage=True {ar['staged_s']:.4f} s {ar['staged_launches']} bit-equal to stage=False "
        f"{ar['s']:.4f} s {ar['launches']}; pbcast_tree stage=True {bc['staged_s']:.4f} s "
        f"{bc['staged_launches']} and inter_pod=True {bc['inter_pod_s']:.4f} s "
        f"{bc['inter_pod_launches']} bit-equal to stage=False {bc['s']:.4f} s {bc['launches']}, "
        f"replicas the root's; one chunked_copy a non-empty bucket; the inter-pod price changes "
        f"the algorithm of {moved} of {nonempty} buckets ({changed})")
    return rec


def online(torch) -> dict:
    """Phase 9: ``OnlineTuner(Tuner(H100_SXM), 'allreduce', M, 4, seed=0)``
    with M = :data:`ALG_ELEMS` f32 a rank and the default arms (3 algorithms
    x 3 wire formats), ``len(arms) + 8`` steps. ``measure`` replays the
    arm's plan through ``apply_plan(compiled=True)`` (as phase 6's tuned
    modes route it) on a fresh copy of the rows: one warm-up, then the
    median of 3 CUDA-event times. Each result is held against the f32 sum
    of the rows (bf16 wire: rtol = atol = 2e-5; int8 2%, fp8 9% of the
    largest magnitude). Checks: every arm tried in the first ``len(arms)``
    steps; the table's entry for the point ends as the arm with the lowest
    single measurement (source 'empirical'); every improving record changes
    the tuner's fingerprint and the next ``plan_cached`` for the point
    misses the cache, every other step keeps both. Launch counts are zeroed
    by the caller right before."""
    from repro_torch import comm
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.core.tuner import OnlineTuner, Tuner

    M = 4 * ALG_ELEMS
    tuner = Tuner(H100_SXM)
    ot = OnlineTuner(tuner, "allreduce", M, RANKS, seed=0)
    assert len(ot.arms) == 9, ot.arms
    x = torch.randn((RANKS, ALG_ELEMS), generator=torch.Generator(device="cuda").manual_seed(11),
                    device="cuda")
    want = x.sum(0)
    scale = float(want.abs().max())
    work = torch.empty_like(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def measure(dec) -> float:
        plan = comm.plan_cached("allreduce", M, RANKS, algo=dec.algo, num_chunks=dec.num_chunks,
                                tuner=tuner, wire_format=dec.wire_format)
        ms = []
        for i in range(4):
            work.copy_(x)
            start.record()
            res = comm.apply_plan(plan, work, compiled=True)
            end.record()
            end.synchronize()
            if i:
                ms.append(start.elapsed_time(end))
        fmt = dec.wire_format or "bf16"
        if fmt == "bf16":
            ok = bool(((res - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())
        else:
            ok = float((res - want).abs().max()) <= {"int8": 0.02, "fp8": 0.09}[fmt] * scale
        assert ok, (dec, float((res - want).abs().max()), scale)
        return sorted(ms)[1] * 1e-3

    def entry():
        d = tuner.select(M, RANKS, op="allreduce")
        return d if d.source == "empirical" else None

    comm.plan_cached("allreduce", M, RANKS, tuner=tuner)
    steps = []
    for _ in range(len(ot.arms) + 8):
        prev, fp = entry(), tuner.fingerprint()
        dec, secs = ot.step(measure)
        improved = prev is None or secs < prev.predicted_s
        misses = comm.cache_stats()["misses"]
        comm.plan_cached("allreduce", M, RANKS, tuner=tuner)
        missed = comm.cache_stats()["misses"] > misses
        assert (tuner.fingerprint() != fp) == improved == missed, (dec, secs, prev, missed)
        steps.append({"arm": [dec.algo, dec.num_chunks, dec.wire_format], "source": dec.source,
                      "predicted_s": dec.predicted_s, "s": secs, "improved": improved})
    tried = {tuple(st["arm"]) for st in steps[:len(ot.arms)]}
    assert tried == set(ot.arms), (tried, ot.arms)
    best = min(steps, key=lambda st: st["s"])
    final = entry()
    assert final is not None and [final.algo, final.num_chunks, final.wire_format] == \
        best["arm"] and final.predicted_s == best["s"], (final, best)
    first = {tuple(st["arm"]): st for st in steps[:len(ot.arms)]}
    log("online: " + ", ".join(
        f"{a[0]}/K{a[1]}/{a[2]} cost_wire {first[a]['predicted_s'] * 1e3:.4f} ms measured "
        f"{first[a]['s'] * 1e3:.4f} ms" for a in ot.arms)
        + f"; steps {[(st['arm'][0], st['arm'][2], st['source'], round(st['s'] * 1e3, 4)) for st in steps]}"
        + f"; table: {final.algo}/K{final.num_chunks}/{final.wire_format} at "
          f"{final.predicted_s * 1e3:.4f} ms (the lowest single measurement), best mean arm "
          f"{ot.best_arm()}; {sum(st['improved'] for st in steps)} improving records, each a "
          "new fingerprint and a plan-cache miss")
    del x, work, want
    torch.cuda.empty_cache()
    return {"arms": [list(a) for a in ot.arms], "steps": steps,
            "table": [final.algo, final.num_chunks, final.wire_format, final.predicted_s],
            "best_mean_arm": list(ot.best_arm())}


def serve_moe(torch) -> tuple[dict, object]:
    """Phase 10: mixtral-8x7b at full width (2 of 32 layers: attention with
    window 4096, 8 experts top-2 of width 14336, bf16, seeded random
    weights) distributed to 4 emulated ranks as phase 3 distributes
    (``Engine(distribute=True, double_buffer=True)``: the tuned broadcast,
    each bucket staged through chunked_copy), replicas bit-equal to the
    weights; ``generate`` with batch 4 (one prompt a rank), prompt 128, 32
    decode steps through the einsum dispatch, then the warm re-run; then,
    as phase 4 does, the weights broadcast again from NaN-filled replicas
    with the pinned pipelined chain and the compiled executor
    (fused_combine), replicas bit-equal to the root. Launch counts are
    zeroed by the caller right before. Returns the numbers and the engine,
    which phase 10b serves from."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine, distribute_weights

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=MOE_LAYERS)
    assert cfg.moe_dispatch == "einsum"
    params = Model(cfg).init(seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    mesh = make_mesh(RANKS, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts["chunked_copy"] > 0, counts
    assert replicas_equal(torch, engine.params, params), "a mixtral replica differs"
    del params
    dist_peak = torch.cuda.max_memory_allocated()

    rng = np.random.RandomState(10)
    tokens = rng.randint(0, cfg.vocab_size - 1, size=(BATCH, PROMPT))
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    assert res.tokens.shape == (BATCH, STEPS) and res.logprobs.shape == (BATCH, STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS)
    peak = torch.cuda.max_memory_allocated()

    for leaf in tree_leaves(engine.params):
        leaf[1:].fill_(float("nan"))
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    distribute_weights(engine.params, mesh, algo="pipelined_chain", compiled=True,
                       double_buffer=True)
    torch.cuda.synchronize()
    compiled_s = time.perf_counter() - t0
    merges = kernels.launch_counts()["fused_combine"] - before["fused_combine"]
    assert merges > 0, merges
    assert replicas_equal(torch, engine.params), "compiled mixtral replicas differ from the root"
    out = {
        "params": n_params, "replica_bytes": n_params * 2, "distribute_s": dist_s,
        "distribute_peak": dist_peak, "chunked_copy_launches": counts["chunked_copy"],
        "generate_s": gen_s, "prefill_ms_per_rank": prefill_s / RANKS * 1e3,
        "decode_tokens_per_s": BATCH * STEPS / decode_s, "max_memory_allocated": peak,
        "compiled_distribute_s": compiled_s, "compiled_fused_combine_launches": merges,
        "first_tokens": res.tokens[:, :4].tolist(),
    }
    log(f"serve moe: mixtral-8x7b {MOE_LAYERS} layers, {n_params} params, distribution "
        f"{dist_s:.3f} s ({counts['chunked_copy']} chunked_copy launches, peak "
        f"{dist_peak / 2**30:.2f} GiB), generate {gen_s:.3f} s (cold, batch {BATCH}, prompt "
        f"{PROMPT}, {STEPS} steps, einsum dispatch); warm: prefill "
        f"{out['prefill_ms_per_rank']:.2f} ms/rank, decode steps "
        f"{out['decode_tokens_per_s']:.1f} tok/s; peak {peak / 2**30:.2f} GiB; compiled "
        f"pipelined chain from NaN replicas {compiled_s:.3f} s ({merges} fused_combine "
        "launches), replicas bit-equal")
    return out, engine


def _gatherv_host(torch, x, sizes):
    """pallgatherv by torch indexing on the card: each rank's valid rows,
    concatenated, on every rank."""
    rows = torch.cat([x[r, :s] for r, s in enumerate(sizes)])
    return rows[None].expand((x.shape[0],) + tuple(rows.shape)).clone()


def _alltoallv_host(torch, x, m, in_padded: bool, out_padded: bool):
    """palltoallv by torch indexing on the card (``m`` an n x n list): block
    (s, d) from rank s's input layout to rank d's output layout, zeros
    elsewhere."""
    n = len(m)
    elem = tuple(x.shape[3:]) if in_padded else tuple(x.shape[2:])
    bmax = max(max(row) for row in m)
    rmax = max(sum(m[s][r] for s in range(n)) for r in range(n))
    out = x.new_zeros(((n, n, bmax) if out_padded else (n, rmax)) + elem)
    for r in range(n):
        pos = 0
        for s in range(n):
            h = m[s][r]
            if in_padded:
                block = x[s, r, :h]
            else:
                start = sum(m[s][:r])
                block = x[s, start:start + h]
            if out_padded:
                out[r, s, :h] = block
            else:
                out[r, pos:pos + h] = block
            pos += h
    return out


# the executors every ragged case is held across (fused=False: the unrolled)
RAGGED_EXECUTORS = (("compiled", {"compiled": True}), ("inkernel", {"inkernel": True}),
                    ("unrolled", {"fused": False}))


def _ragged_case(torch, label: str, fn, x, kw: dict, host, valid_rows: int,
                 reps: int = 0) -> dict:
    """``fn(x, **kw)`` through the three executors: each bit-equal to the
    others and to ``host`` (torch indexing, no kernel); with ``reps``, each
    timed by CUDA events beside the bytes bound (the ``valid_rows`` rows
    of the input read once, the output written once)."""
    from repro_torch import kernels

    out, launches = {}, {}
    for name, ex in RAGGED_EXECUTORS:
        before = kernels.launch_counts()
        got = fn(x, **kw, **ex)
        launches[name] = _launched(torch, before)
        assert got.shape == host.shape, (label, name, tuple(got.shape), tuple(host.shape))
        assert same_bits(torch, got, host), f"{label}: {name} differs from the host reshuffle"
        del got
    assert launches["inkernel"] == {"inkernel_rdma": 1}, (label, launches)
    assert launches["compiled"].get("fused_combine", 0) > 0, (label, launches)
    assert not launches["unrolled"], (label, launches)
    rec = {"launches": launches}
    if reps:
        elem_bytes = host.element_size() * math.prod(
            host.shape[3:] if kw.get("out_padded") else host.shape[2:])
        bound_ms = (valid_rows * elem_bytes + host.numel() * host.element_size()) \
            / HBM_BYTES_PER_S * 1e3
        for name, ex in RAGGED_EXECUTORS:
            out[name] = time_ms(torch, lambda ex=ex: fn(x, **kw, **ex), reps=reps, warmup=1)
        rec.update(ms=out, bound_ms=bound_ms)
    return rec


def moe_ep(torch, engine) -> dict:
    """Phase 10b: an expert-parallel prefill of phase 10's 2-layer model
    (rank 0's replica) over the 4 emulated ranks: ``apply_lm(mode='prefill',
    mesh=mesh)`` with ``moe_dispatch='alltoallv'``, one 4096-token sequence
    a rank, every layer's attention through the sm90 flash kernel (window
    4096), every MoE layer's expert rows moved out and back by
    ``palltoallv``, run twice: ``transport=`` pins its executor to the
    compiled (fused_combine) and then to the in-kernel (inkernel_rdma)
    one, and the two give the same bits. Those two runs are the path whose
    launches the kernels line counts. Held: (a) the same tokens through
    the einsum dispatch, logits within :data:`MOE_EP_REL` /
    :data:`MOE_EP_ABS` (the expert-parallel route is the einsum path's
    arithmetic with the transports in between, so this holds the
    transports, see ``moe._expert_parallel``); (b) at each MoE
    layer's own block matrices (recorded from the prefill), both transports
    through the compiled, in-kernel and unrolled executors, bit-equal to
    each other and to the host reshuffle, timed beside the bytes bound; (c)
    ragged cases at rows of 4096 bf16 (pallgatherv at sizes (3, 1, 0, 2)
    and (5, 0, 0, 7); palltoallv on seeded matrices with a rank that
    receives nothing and one that sends nothing, compact and padded), each
    bit-equal across the three executors and to the host reshuffle, and the
    expert-parallel ``moe_ffn`` at E = 6 over the 4 ranks (partition
    (2, 2, 1, 1), a shared expert) in f32 within 1e-5 of the einsum path.
    Launch counts are zeroed by the caller right before."""
    import numpy as np

    from repro_torch import comm, kernels
    from repro_torch.comm import api
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    from repro_torch.models.transformer import apply_lm

    cfg = dataclasses.replace(engine.cfg, moe_dispatch="alltoallv")
    mesh, params = engine.mesh, engine.replica(0)
    tokens = torch.as_tensor(np.random.RandomState(11).randint(
        0, cfg.vocab_size - 1, size=(RANKS, MOE_PROMPT)), device="cuda")
    S = moe._group_size(MOE_PROMPT, cfg)
    C = moe._capacity(S, cfg.experts_per_token, cfg.num_experts, cfg.capacity_factor)
    R = MOE_PROMPT // S * C
    cnt = moe.expert_partition(cfg.num_experts, RANKS)

    # the path: the prefill with its transports through the compiled and
    # then the in-kernel executor (``transport=`` pins palltoallv's), the
    # launch counts read around each; the first run records each transport's
    # input (a copy) for (b). Both runs are cold: the first builds the plans
    # and the second the in-kernel executor's tables.
    calls = []

    def pinned(ex: dict, record: bool):
        def transport(x, **kw):
            if record:
                calls.append((x.clone(), kw))
            return comm.palltoallv(x, **kw, **ex)
        return transport

    runs = {}
    with torch.no_grad():
        for name, ex in (("compiled", {"compiled": True}), ("inkernel", {"inkernel": True})):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _caches, got_aux = apply_lm(params, cfg, tokens=tokens, mode="prefill",
                                             mesh=mesh,
                                             transport=pinned(ex, name == "compiled"))
            torch.cuda.synchronize()
            runs[name] = {"logits": got, "aux": float(got_aux),
                          "s": time.perf_counter() - t0, "launches": _launched(torch, before)}
            del got, _caches
    L = cfg.num_layers
    assert runs["compiled"]["launches"].get("fused_combine", 0) > 0, runs["compiled"]["launches"]
    assert "inkernel_rdma" not in runs["compiled"]["launches"], runs["compiled"]["launches"]
    assert runs["inkernel"]["launches"].get("inkernel_rdma") == 2 * L, runs["inkernel"]["launches"]
    assert "fused_combine" not in runs["inkernel"]["launches"], runs["inkernel"]["launches"]
    assert all(r["launches"].get("flash_attention_sm90") == L for r in runs.values()), runs
    assert len(calls) == 2 * L, len(calls)
    ep, ep_aux = runs["compiled"]["logits"], runs["compiled"]["aux"]
    assert same_bits(torch, runs["inkernel"]["logits"], ep) \
        and runs["inkernel"]["aux"] == ep_aux, "the in-kernel prefill differs from the compiled"
    counts = {k: sum(r["launches"].get(k, 0) for r in runs.values())
              for k in kernels.launch_counts()}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, _caches, ref_aux = apply_lm(params, engine.cfg, tokens=tokens, mode="prefill")
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        del _caches
        err = max_abs_err(torch, ep, ref)
        over = int(((ep - ref).abs() > MOE_EP_ABS + MOE_EP_REL * ref.abs()).sum())
        aux_err = abs(ep_aux - float(ref_aux))
        assert bool(torch.isfinite(ep).all()) and over == 0 and aux_err < 1e-6, \
            (err, over, aux_err)
        # then one warm pass of each, CUDA events (not counted: the path's
        # launches are the two runs above)
        warm = {name: time_ms(torch, lambda ex=ex: apply_lm(
            params, cfg, tokens=tokens, mode="prefill", mesh=mesh,
            transport=pinned(ex, False)), reps=1, warmup=0)
            for name, ex in (("compiled", {"compiled": True}), ("inkernel", {"inkernel": True}))}
        warm["einsum"] = time_ms(torch, lambda: apply_lm(params, engine.cfg, tokens=tokens,
                                                         mode="prefill"), reps=1, warmup=0)
    for r in runs.values():
        del r["logits"]
    del ep, ref
    torch.cuda.empty_cache()
    prefill_ms = {name: r["s"] * 1e3 for name, r in runs.items()}
    prefill_ms["einsum"] = ref_s * 1e3
    log(f"moe ep: mixtral-8x7b {L} layers, {RANKS} x {MOE_PROMPT} tokens, "
        f"S={S} nG={MOE_PROMPT // S} C={C} R={R}, experts {cnt} a rank; prefill (cold, host "
        f"clock) with the transports compiled {prefill_ms['compiled']:.2f} ms (recording "
        f"their inputs), in-kernel {prefill_ms['inkernel']:.2f} ms, einsum dispatch "
        f"{prefill_ms['einsum']:.2f} ms; warm (CUDA events) {warm['compiled']:.2f}, "
        f"{warm['inkernel']:.2f} and {warm['einsum']:.2f} ms; the two bit-equal; logits "
        "against the einsum "
        f"dispatch max abs diff {err:.3e} ({over} over {MOE_EP_ABS} + {MOE_EP_REL} |ref|), aux "
        f"diff {aux_err:.3e}; launches compiled {runs['compiled']['launches']}, in-kernel "
        f"{runs['inkernel']['launches']}")

    # (b) the model's own block matrices through every executor
    transports = []
    for i, (x, kw) in enumerate(calls):
        m = [list(row) for row in api.alltoallv_matrix(kw["sizes"], RANKS)]
        host = _alltoallv_host(torch, x, m, kw.get("in_padded", False),
                               kw.get("out_padded", False))
        rec = _ragged_case(torch, f"layer {i // 2} {'out' if i % 2 == 0 else 'back'}",
                           comm.palltoallv, x, kw, host, sum(map(sum, m)), reps=3)
        rec.update(layer=i // 2, way="out" if i % 2 == 0 else "back",
                   rows_per_rank=sum(m[0]), shape=list(x.shape))
        transports.append(rec)
        log(f"moe ep transport layer {rec['layer']} {rec['way']}: {tuple(x.shape)} bf16, "
            f"{rec['rows_per_rank']} rows a rank ({rec['rows_per_rank'] * x.shape[-1] * 2 / 1e6:.1f}"
            f" MB): compiled {rec['ms']['compiled']:.3f} ms, inkernel {rec['ms']['inkernel']:.3f} "
            f"ms, unrolled {rec['ms']['unrolled']:.3f} ms, bound {rec['bound_ms']:.3f} ms; "
            "bit-equal to each other and to the host reshuffle")
        del host
    calls.clear()
    torch.cuda.empty_cache()

    # (c) ragged cases at rows of 4096 bf16, zero-row ranks included
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = []
    for sizes in ((3, 1, 0, 2), (5, 0, 0, 7)):
        x = torch.randn((RANKS, max(sizes), 4096), generator=gen, device="cuda").to(
            torch.bfloat16)
        for r, s in enumerate(sizes):
            x[r, s:] = 99.0  # poison beyond the valid prefix
        for algo in ("auto", "ring_allgatherv", "doubling_allgatherv"):
            _ragged_case(torch, f"pallgatherv {sizes} {algo}", comm.pallgatherv, x,
                         {"sizes": sizes, "algo": algo}, _gatherv_host(torch, x, sizes), 0)
        cases.append(f"pallgatherv {sizes} x 3 algos")
    mats = []
    rng = np.random.RandomState(1)
    for trial in range(3):
        mm = rng.randint(0, 4, size=(RANKS, RANKS))
        if trial == 1:
            mm[:, 2] = 0  # rank 2 receives nothing
        if trial == 2:
            mm[1, :] = 0  # rank 1 sends nothing
        mats.append(mm.tolist())
    mats.append([[2, 0, 1, 3], [0, 0, 0, 0], [1, 4, 0, 0], [2, 2, 2, 2]])
    for j, m in enumerate(mats):
        send = [sum(row) for row in m]
        bmax = max(max(row) for row in m)
        compact = torch.full((RANKS, max(send), 4096), 88.0, device="cuda",
                             dtype=torch.bfloat16)
        padded = torch.full((RANKS, RANKS, bmax, 4096), 77.0, device="cuda",
                            dtype=torch.bfloat16)
        for s in range(RANKS):
            pos = 0
            for d in range(RANKS):
                block = torch.randn((m[s][d], 4096), generator=gen, device="cuda").to(
                    torch.bfloat16)
                compact[s, pos:pos + m[s][d]] = block
                padded[s, d, :m[s][d]] = block
                pos += m[s][d]
        layouts = ((False, False),) if j < 3 else ((False, False), (True, True), (True, False),
                                                   (False, True))
        for ip, op in layouts:
            x = padded if ip else compact
            for algo in ("auto", "pairwise_alltoallv", "ring_alltoallv"):
                _ragged_case(torch, f"palltoallv {m} {ip}/{op} {algo}", comm.palltoallv, x,
                             {"sizes": m, "algo": algo, "in_padded": ip, "out_padded": op},
                             _alltoallv_host(torch, x, m, ip, op), 0)
        cases.append(f"palltoallv {m}: {len(layouts)} layouts x 3 algos")
    log(f"moe ep ragged: {cases}, rows of 4096 bf16, each bit-equal across compiled, inkernel "
        "and unrolled and to the host reshuffle")

    torch.backends.cuda.matmul.allow_tf32 = False
    small = ModelConfig(name="ep6", family="moe", num_layers=1, d_model=128, num_heads=2,
                        num_kv_heads=2, d_ff=256, vocab_size=32, num_experts=6,
                        experts_per_token=2, moe_group_size=32, num_shared_experts=1)
    assert moe.expert_partition(6, RANKS) == (2, 2, 1, 1)
    p = moe.init_moe(torch.Generator(device="cuda").manual_seed(13), small, torch.float32)
    x = torch.randn((8, 64, 128), generator=gen, device="cuda")
    with torch.no_grad():
        y_ep, aux_ep = moe.moe_ffn(p, x, dataclasses.replace(small, moe_dispatch="alltoallv"),
                                   mesh=mesh)
        y, aux = moe.moe_ffn(p, x, small)
    small_err = max_abs_err(torch, y_ep, y)
    assert small_err < 1e-5 and abs(float(aux_ep) - float(aux)) < 1e-6, (small_err, aux_ep, aux)
    log(f"moe ep small: moe_ffn E=6 over {RANKS} ranks (2, 2, 1, 1) + a shared expert, f32, "
        f"alltoallv vs einsum max abs diff {small_err:.3e} (tol 1e-5)")
    return {"prefill_ms": prefill_ms, "warm_prefill_ms": warm,
            "logits_max_abs_diff": err, "aux_diff": aux_err,
            "S": S, "C": C, "R": R, "experts_per_rank": list(cnt),
            "prefill_launches": {name: r["launches"] for name, r in runs.items()},
            "transports": transports, "ragged_cases": cases, "small_moe_max_abs_diff": small_err,
            "counts": counts}


def moe_smoke_reference(torch) -> float:
    """mixtral-8x7b-smoke, qwen3-moe-30b-a3b-smoke and
    moonshot-v1-16b-a3b-smoke in f32: prefill of 80 tokens (past
    mixtral-smoke's window of 64) and 2 decode steps on the card against
    the CPU, logits within 1e-3 as phase 5 holds the other smoke
    configs."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for i, arch in enumerate(("mixtral-8x7b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")):
        cfg = dataclasses.replace(get_config(f"{arch}-smoke"), dtype="float32",
                                  kv_cache_dtype="float32")
        model = Model(cfg)
        cpu = model.init(seed=20 + i, device="cpu")
        gpu = tree_map(lambda t: t.cuda(), cpu)
        tokens = torch.randint(0, cfg.vocab_size, (2, 80),
                               generator=torch.Generator().manual_seed(20 + i))
        e = []
        with torch.no_grad():
            a, ca = model.prefill(cpu, {"tokens": tokens}, max_len=82)
            b, cb = model.prefill(gpu, {"tokens": tokens.cuda()}, max_len=82)
            e.append(float((a - b.cpu()).abs().max()))
            nxt = torch.argmax(a[:, -1], dim=-1)[:, None]
            for s in range(2):
                a, ca = model.decode_step(cpu, nxt, ca, 80 + s)
                b, cb = model.decode_step(gpu, nxt.cuda(), cb, 80 + s)
                e.append(float((a - b.cpu()).abs().max()))
                nxt = torch.argmax(a[:, 0], dim=-1)[:, None]
        assert all(math.isfinite(v) and v < 1e-3 for v in e), (arch, e)
        errs[arch] = max(e)
    log(f"reference: MoE smoke configs f32, card vs CPU, max abs diff of prefill / decode "
        f"logits {({k: '%.3e' % v for k, v in errs.items()})} (tol 1e-3)")
    return max(errs.values())


def small_reference(torch) -> float:
    """The f32 smoke model on the card against the same model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("minitron-8b-smoke"), dtype="float32",
                              kv_cache_dtype="float32")
    model = Model(cfg)
    cpu = model.init(seed=3, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, _ = model.prefill(cpu, {"tokens": tokens}, max_len=20)
        b, _ = model.prefill(gpu, {"tokens": tokens.cuda()}, max_len=20)
    err = float((a - b.cpu()).abs().max())
    assert math.isfinite(err) and err < 1e-3, err
    log(f"reference: smoke f32 prefill logits, card vs CPU, max abs diff {err:.3e} (tol 1e-3)")
    return err


def small_long_reference(torch) -> float:
    """gemma3-27b-smoke in f32 (window 64) at a 4096-token prompt, prefill
    and 2 decode steps: the card (prefill attention through the CUDA-core
    flash kernel, the f32 route) against the CPU (its plain version). Launch
    counts are zeroed by the caller right before."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3-27b-smoke"), dtype="float32",
                              kv_cache_dtype="float32")
    model = Model(cfg)
    cpu = model.init(seed=5, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                           generator=torch.Generator().manual_seed(5))
    errs = []
    with torch.no_grad():
        a, ca = model.prefill(cpu, {"tokens": tokens}, max_len=LONG_PROMPT + 2)
        b, cb = model.prefill(gpu, {"tokens": tokens.cuda()}, max_len=LONG_PROMPT + 2)
        errs.append(float((a - b.cpu()).abs().max()))
        nxt = torch.argmax(a[:, -1], dim=-1)[:, None]
        for i in range(2):
            a, ca = model.decode_step(cpu, nxt, ca, LONG_PROMPT + i)
            b, cb = model.decode_step(gpu, nxt.cuda(), cb, LONG_PROMPT + i)
            errs.append(float((a - b.cpu()).abs().max()))
            nxt = torch.argmax(a[:, 0], dim=-1)[:, None]
    launched = kernels.launch_counts()["flash_attention"]
    assert launched == cfg.num_layers, launched
    assert kernels.launch_counts()["flash_attention_sm90"] == 0, "f32 took the sm90 route"
    assert all(math.isfinite(e) and e < 1e-3 for e in errs), errs
    log(f"reference: gemma3-27b-smoke f32 at {LONG_PROMPT} tokens, card ({launched} "
        f"flash_attention launches) vs CPU (plain), max abs diff of prefill / decode logits "
        f"{['%.3e' % e for e in errs]} (tol 1e-3)")
    return max(errs)


def train_mode(torch, cfg, mesh, fields: dict, check_rows: bool = False, health=None,
               batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ, inspect=None, prepare=None):
    """One Trainer run of TRAIN_STEPS steps from the seeded weights (on a
    mesh in ``health``'s state, when given) on a global batch of ``batch``
    x ``seq`` text tokens (and a vision config's prefix). Returns the final
    parameters and the run's record; its tokens/s count every position the
    model runs, the prefix included. ``inspect(params, opt_state, trainer)``, when
    given, returns entries for the record, read before the state is
    dropped; ``prepare(trainer)``, when given, runs before the first step."""
    from repro_torch import kernels
    from repro_torch.configs import RunConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()
    trainer = Trainer(cfg, RunConfig(**TRAIN_RUN, **fields), mesh=mesh, check_rows=check_rows,
                      health=health)
    if prepare is not None:
        prepare(trainer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, hist = trainer.train(batch=batch, seq=seq, steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    depths = (overlap_depths(torch, trainer, params)
              if fields["sync_mode"] == "overlap_allreduce" else None)
    extra = inspect(params, opt, trainer) if inspect is not None else {}
    del opt, trainer
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), (fields, losses)
    step_s = (hist[-1]["time_s"] - hist[0]["time_s"]) / (TRAIN_STEPS - 1)
    record = {
        "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
        "first_step_s": hist[0]["time_s"], "step_s": step_s,
        "aux": [h["aux"] for h in hist],
        "tokens_per_s": batch * (seq + (cfg.prefix_len if cfg.frontend else 0)) / step_s,
        "run_s": total_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": {k: after[k] - before[k] for k in after},
        "params": sum(t.numel() for t in tree_leaves(params)),
    }
    if check_rows:
        record["grad_rows_differ"] = [int(h["grad_rows_differ"]) for h in hist]
    if depths is not None:
        record["depths"] = depths
    record.update(extra)
    return params, record


def overlap_depths(torch, trainer, params) -> dict:
    """Each stream's [in-flight depth, depth_source] in an overlap_allreduce
    run: the prefetch form's planned graph (the step's ``graph``), or the
    plan ``overlap_allreduce_tree`` resolves in every step of the
    single-stream form (cached, so this call returns the same plan)."""
    from repro_torch.comm import hierarchical_allreduce_axes, plan_overlap
    from repro_torch.core.tree import tree_map
    from repro_torch.dist import topology

    graph = getattr(trainer._step_fn, "graph", None)
    if graph is not None:
        return {e.name: [e.overlap_depth, e.depth_source] for e in graph.entries}
    run, sizes = trainer.run, topology.axis_sizes(trainer.mesh)
    shapes = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    oplan = plan_overlap(shapes, [(a, sizes[a]) for a in hierarchical_allreduce_axes(trainer.mesh)
                                  if sizes[a] > 1],
                         algo=run.allreduce_algo, bucket_bytes=run.bcast_bucket_bytes,
                         inter_pod_axes=topology.inter_pod_axes(trainer.mesh),
                         compute_s=run.overlap_compute_s, overlap_depth=run.overlap_depth)
    return {"overlap": [oplan.overlap_depth, oplan.depth_source]}


def train_tables(torch, d: str) -> tuple[dict, int]:
    """Two tuner tables for phase 6 from the same measured points: every
    training bucket's analytic allreduce plan, timed as one in-kernel replay
    on the card, recorded once with ``exec_path='compiled'`` and once with
    ``'inkernel'``; saved under ``d``. Returns the paths by exec path and
    the bucket plans a step replays."""
    from repro_torch.comm import plan_cached
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import bucketing
    from repro_torch.core.tuner import Tuner
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    spec = bucketing.plan_buckets(params, RunConfig(**TRAIN_RUN).bcast_bucket_bytes)
    del params
    torch.cuda.empty_cache()
    tuners = {"compiled": Tuner(), "inkernel": Tuner()}
    buckets = list(zip(spec.bucket_bytes(), spec.bucket_sizes, spec.bucket_dtypes))
    rows = record_inkernel_table(torch, list(tuners.values()), buckets, "allreduce",
                                 [{"exec_path": e} for e in tuners])
    paths = {}
    for exec_path, t in tuners.items():
        paths[exec_path] = os.path.join(d, f"train_{exec_path}.json")
        t.save(paths[exec_path])
    loaded = Tuner.load(paths["inkernel"])
    plans = [plan_cached("allreduce", M, RANKS, tuner=loaded) for M, _e, _d in buckets if M]
    replayed = sum(1 for p in plans if p.lowered().num_rounds > 0)
    log(f"train tables: {len(buckets)} buckets (algo, chunks, rounds, classes, replay ms: "
        f"{rows}); {replayed} bucket plans a step")
    return paths, replayed


def _deviation(r: dict, base: dict) -> tuple[float, float]:
    """A run's last loss's distance from ``base``'s and its grad norms'
    largest relative distance over the steps."""
    return (abs(r["losses"][-1] - base["losses"][-1]),
            max(abs(a - b) / b for a, b in zip(r["grad_norms"], base["grad_norms"])))


def train(torch, table_runs: list, plans_per_step: int) -> dict:
    """Phase 6: each sync mode trains 3 steps from the same seeded weights
    and batches; then param_bcast and tuned_allreduce again with the synced
    rows compared (``check_rows``, left out of the timed runs because it
    adds passes over the synced gradients); then ``table_runs``, the
    tuned_allreduce runs whose tuner tables route every bucket plan to the
    compiled and to the in-kernel executor. Returns per-mode numbers;
    raises on any failed check."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    mesh = make_mesh(RANKS, device="cuda")
    out, tuned, tabled = {}, None, None

    def on_host(params):  # held off the card, so each run's peak is its own
        return [t.cpu() for t in tree_leaves(params)]

    def same_as(held, params):
        return all(same_bits(torch, a, b) for a, b in zip(held, on_host(params)))

    runs = [(label, fields, False) for label, fields in TRAIN_MODES]
    runs += [(label + "+check_rows", dict(TRAIN_MODES)[label], True) for label in ROW_CHECKED]
    runs += [(label, fields, False) for label, fields in table_runs]
    for label, fields, check_rows in runs:
        params, r = train_mode(torch, cfg, mesh, fields, check_rows)
        if label == "tuned_allreduce":
            tuned = on_host(params)
        elif label in ("overlap_allreduce", "overlap_prefetch"):
            assert same_as(tuned, params), f"{label}'s parameters differ from tuned_allreduce's"
        elif label == "compressed_bf16":
            assert same_as(tuned, params), \
                "the bf16 wire's parameters differ from tuned_allreduce's"
            tuned = None
        elif label.startswith("param_bcast_ring"):  # the explicit ring, not a plan
            assert all(r["launches"][k] == 0 for k in
                       ("fused_combine", "inkernel_rdma", "chunked_copy")), r["launches"]
        elif label == "table_compiled":
            tabled = on_host(params)
            assert r["launches"]["inkernel_rdma"] == 0 < r["launches"]["fused_combine"], r
        elif label == "table_inkernel":
            assert same_as(tabled, params), \
                "the in-kernel table's parameters differ from the compiled table's"
            tabled = None
            assert r["launches"]["fused_combine"] == 0 == r["launches"]["inkernel_replay"], r
            assert r["launches"]["inkernel_rdma"] == plans_per_step * TRAIN_STEPS, \
                (r["launches"], plans_per_step)
        del params
        out[label] = r
        log(f"train {label}: losses {['%.4f' % x for x in r['losses']]}, grad norms "
            f"{['%.4f' % x for x in r['grad_norms']]}, step {r['step_s']:.3f} s "
            f"(first {r['first_step_s']:.3f} s), {r['tokens_per_s']:.0f} tok/s, peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB, "
            + (f"rows differ {r['grad_rows_differ']}, " if check_rows else "")
            + (f"depth, source {r['depths']}, " if "depths" in r else "")
            + f"launches {r['launches']}")
    ref = out["tuned_allreduce"]["losses"]
    for label, r in out.items():
        assert abs(r["losses"][0] - ref[0]) <= 1e-3, ("step-0 loss", label, r["losses"], ref)
    for label in ROW_CHECKED:
        rows = out[label + "+check_rows"]["grad_rows_differ"]
        assert not any(rows), (label, "synced rows differ", rows)
    merges = {label: out[label]["launches"]["fused_combine"]
              for label in ("tuned_allreduce", "overlap_allreduce", "overlap_prefetch")}
    assert merges["overlap_allreduce"] == merges["tuned_allreduce"], merges
    peaks = {label: round(r["max_memory_allocated"] / 2**30, 2) for label, r in out.items()}
    log(f"train overlap: overlap_allreduce and overlap_prefetch bit-equal to tuned_allreduce; "
        f"fused_combine launches {merges}: the weight_prefetch broadcast adds "
        f"{merges['overlap_prefetch'] - merges['tuned_allreduce']} in {TRAIN_STEPS} steps; "
        f"peak GiB {peaks}")
    log("train ring: " + ", ".join(
        f"{label} step {out[label]['step_s']:.4f} s, peak "
        f"{out[label]['max_memory_allocated'] / 2**30:.2f} GiB"
        for label in ("param_bcast_ring", "param_bcast", "tuned_allreduce", "grad_allreduce"))
        + "; param_bcast_ring launches no fused_combine, inkernel_rdma or chunked_copy")
    # grad_allreduce's plain mean is the one sync that runs none of the
    # port's kernels: the bf16-wire modes must track it. Bounds set from
    # the readings of the proof run (NVIDIA H100 80GB HBM3, 700 W): last
    # losses within 1.7e-4, grad norms within 3.8e-5 relative at every step.
    base = out["grad_allreduce"]
    for label in ("param_bcast", "param_bcast_ring", "tuned_allreduce", "overlap_allreduce",
                  "overlap_prefetch", "compressed_bf16"):
        r = out[label]
        d_loss, d_norm = _deviation(r, base)
        log(f"train {label} against grad_allreduce: last loss differs by {d_loss:.3e} "
            f"(bound 1e-3), grad norms by {d_norm:.3e} relative at most (bound 2e-4)")
        assert d_loss <= 1e-3 and d_norm <= 2e-4, (label, r["losses"], r["grad_norms"],
                                                   base["losses"], base["grad_norms"])
    d_int8 = abs(out["compressed_int8"]["losses"][-1] - ref[-1])
    log(f"train compressed_int8 against tuned_allreduce: last loss differs by {d_int8:.3e} "
        "(bound 5e-3; the reference's own test allows 0.05)")
    assert d_int8 <= 5e-3, (out["compressed_int8"]["losses"], ref)
    return out


def _train_line(r: dict) -> str:
    return (f"losses {['%.4f' % x for x in r['losses']]}, aux "
            f"{['%.6f' % x for x in r['aux']]}, grad norms "
            f"{['%.4f' % x for x in r['grad_norms']]}, step {r['step_s']:.4f} s (first "
            f"{r['first_step_s']:.3f} s), {r['tokens_per_s']:.0f} tok/s, peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")


def _tp_train_mesh(dev: str = "cuda"):
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(TP_MESH[1], n=RANKS, device=dev)


def _held_bytes(trainer, rank: int = 0) -> tuple[int, int]:
    """Bytes rank row ``rank`` holds of the parameters and AdamW's two f32
    moments in the trainer's blocked layout, and the one-axis total."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.dist import sharding

    shapes = tree_flatten(trainer.model.param_shapes())[0]
    specs = tree_flatten(trainer.specs, sharding.is_spec)[0]
    row = one = 0
    for t, spec in zip(shapes, specs):
        block = sharding.shard_slices(spec, tuple(t.shape), trainer.mesh, rank)
        n = math.prod(sl.stop - sl.start for sl in block)
        row += n * (t.element_size() + 8)
        one += t.numel() * (t.element_size() + 8)
    return row, one


def _gather_table(torch, cfg, mesh, d: str) -> tuple[str, list]:
    """A tuner table that routes every gather of the model-axis step
    in-kernel: for each distinct frame a data group gathers (a leaf's block
    a rank, 2 data ranks), one ``pallgather(inkernel=True)`` of such a
    frame timed on the card (after one warm-up) and recorded with
    ``exec_path='inkernel'``; saved under ``d``. Returns the path and the
    (bytes, algo, chunks, ms) rows."""
    from repro_torch import comm
    from repro_torch.comm import plan_cached
    from repro_torch.core.tree import tree_flatten
    from repro_torch.core.tuner import Tuner
    from repro_torch.dist import sharding
    from repro_torch.models import Model
    from repro_torch.train.train_step import _fsdp_dim, tp_specs

    model = Model(cfg)
    shapes = tree_flatten(model.param_shapes())[0]
    specs = tree_flatten(tp_specs(model, mesh), sharding.is_spec)[0]
    n = dict(zip(mesh.axis_names, mesh.devices.shape))["data"]
    frames = set()
    for t, spec in zip(shapes, specs):
        if _fsdp_dim(spec)[1]:
            block = sharding.shard_slices(spec, tuple(t.shape), mesh, 0)
            frames.add((math.prod(sl.stop - sl.start for sl in block), t.dtype))
    tuner, rows = Tuner(), []
    for elems, dtype in sorted(frames, key=lambda f: f[0]):
        frame = torch.zeros((n, elems), dtype=dtype, device="cuda")
        M = n * elems * frame.element_size()
        plan = plan_cached("allgather", M, n)
        ms = time_ms(torch, lambda: comm.pallgather(frame, inkernel=True), reps=1, warmup=1)
        del frame
        tuner.record(M, n, plan.algo, plan.num_chunks, ms * 1e-3, op="allgather",
                     extras={"exec_path": "inkernel"})
        rows.append((M, plan.algo, plan.num_chunks, round(ms, 4)))
    torch.cuda.empty_cache()
    path = os.path.join(d, "train_tp_inkernel.json")
    tuner.save(path)
    return path, rows


def _tp_copies_and_gather(torch, cfg) -> dict:
    """One step of the model-axis trainer from its initial blocks: each
    model rank's gathered shard of every leaf bit-equal to the plain
    concatenation of its data ranks' blocks, and after the step every row
    holding a copy of a block bit-equal to its owner's, in the parameters
    and both AdamW moments."""
    import numpy as np

    from repro_torch import comm
    from repro_torch.configs import RunConfig
    from repro_torch.core.tree import tree_flatten, tree_leaves
    from repro_torch.data.pipeline import batches
    from repro_torch.dist import sharding
    from repro_torch.train.train_step import _fsdp_dim, gather_model_shards
    from repro_torch.train.trainer import Trainer

    mesh = _tp_train_mesh()
    trainer = Trainer(cfg, RunConfig(**TRAIN_RUN, **TP_TRAIN_FIELDS), mesh=mesh)
    params, opt = trainer.init_state()
    specs = tree_flatten(trainer.specs, sharding.is_spec)[0]
    shape = tuple(mesh.devices.shape)
    def gather(frame, axis):
        return comm.pallgather(frame, compiled=True)

    gathered = 0
    for leaf, spec in zip(tree_leaves(params), specs):
        k, axes = _fsdp_dim(spec)
        for j, g in enumerate(gather_model_shards(leaf, spec, mesh, gather)):
            ranks = [r for r in range(mesh.size) if np.unravel_index(r, shape)[-1] == j]
            want = torch.cat([leaf[r] for r in ranks], dim=k) if axes else leaf[ranks[0]]
            assert same_bits(torch, g, want), ("gather", spec, j)
            gathered += g.numel()
            del g, want
    it = batches(trainer.source, cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device="cuda")
    params, opt, _ = trainer._step_fn(params, opt, next(it))
    copies = _copies_bit_equal(torch, (params, opt["m"], opt["v"]), specs, mesh)
    del params, opt, trainer
    return {"gathered_elements": gathered, "copied_elements_equal": copies}


def _copies_bit_equal(torch, trees, specs, mesh) -> int:
    """Every rank row of the blocked ``trees`` (leaves beside ``specs``)
    that holds a copy of a block bit-equal to the row of the block's owner
    (its coordinates on the axes the spec names, 0 on the others),
    asserted. Returns the elements compared."""
    import numpy as np

    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist import sharding

    shape, names = tuple(mesh.devices.shape), tuple(mesh.axis_names)
    copies = 0
    for tree in trees:
        for leaf, spec in zip(tree_leaves(tree), specs):
            named = set(sharding.spec_axes(spec))
            for r in range(mesh.size):
                coords = np.unravel_index(r, shape)
                owner = int(np.ravel_multi_index(
                    [c if a in named else 0 for a, c in zip(names, coords)], shape))
                if owner != r:
                    assert same_bits(torch, leaf[r], leaf[owner]), ("copy", spec, r)
                    copies += leaf[r].numel()
    return copies


def train_tp(torch, training: dict) -> tuple[dict, dict]:
    """Phase 6t (see the module's docstring). Returns the phase's numbers
    and the launch counts of its two timed runs (the ``train_tp`` path)."""
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    mesh = _tp_train_mesh()
    one = training["grad_allreduce"]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        table, table_rows = _gather_table(torch, cfg, mesh, d)
        log(f"train tp table: in-kernel gathers (bytes, algo, chunks, ms) {table_rows}")
        gc.collect()
        torch.cuda.empty_cache()

        def gather_ms(_params, _opt, trainer):
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in trainer._step_fn.gather_events]
            return {"gather_ms": ms, "held": _held_bytes(trainer)}

        kernels.reset_launch_counts()
        held = None
        for label, fields in (("compiled", TP_TRAIN_FIELDS),
                              ("inkernel", {"sync_mode": "grad_allreduce",
                                            "tuner_table": table})):
            params, r = train_mode(torch, cfg, mesh, fields, inspect=gather_ms)
            if label == "compiled":
                held = [t.cpu() for t in tree_leaves(params)]
            else:
                assert all(same_bits(torch, a, b.cpu()) for a, b in
                           zip(held, tree_leaves(params))), \
                    "the in-kernel gathers' parameters differ from the compiled ones'"
                held = None
            del params
            out[label] = r
        counts = kernels.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    comp, ink = out["compiled"], out["inkernel"]
    assert comp["launches"]["fused_combine"] > 0 == comp["launches"]["inkernel_rdma"], comp
    assert ink["launches"]["inkernel_rdma"] > 0 == ink["launches"]["fused_combine"], ink
    row, total = comp["held"]
    for label, r in out.items():
        d_loss, d_norm = _deviation(r, one)
        log(f"train tp {label}: " + _train_line(r) + f"; beside phase 6's one-axis "
            f"grad_allreduce step {one['step_s']:.4f} s, peak "
            f"{one['max_memory_allocated'] / 2**30:.2f} GiB; gather ms a step "
            f"{['%.3f' % x for x in r['gather_ms']]}; last loss {d_loss:.3e} from the "
            f"one-axis run (bound 1e-3), grad norms {d_norm:.3e} relative (bound 2e-4)")
        assert d_loss <= 1e-3 and d_norm <= 2e-4, (label, r, one)
        assert r["max_memory_allocated"] < 70 * 2**30, (label, r["max_memory_allocated"])
    log(f"train tp held: {row} bytes of parameters + AdamW state a rank row "
        f"({row / 2**30:.3f} GiB), {row / total:.4f} of the one-axis {total} bytes")
    out["held_row_bytes"], out["held_one_axis_bytes"] = row, total

    # after the path's counts: the gather and the copies, f32, the smoke run
    out["checks"] = _tp_copies_and_gather(torch, cfg)
    log(f"train tp checks: {out['checks']} (gathered shards bit-equal to the "
        "concatenation of their blocks; copies bit-equal to their owners)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(cfg, dtype="float32")
    runs = {}
    for label, m in (("one-axis", make_mesh(RANKS, device="cuda")), ("tp", mesh)):
        params, runs[label] = train_mode(torch, f32, m, TP_TRAIN_FIELDS)
        del params
    d_loss, d_norm = _deviation(runs["tp"], runs["one-axis"])
    log(f"train tp f32: losses {['%.6f' % x for x in runs['tp']['losses']]} beside the "
        f"one-axis {['%.6f' % x for x in runs['one-axis']['losses']]}; last loss {d_loss:.3e} "
        f"(bound 1e-4), grad norms {d_norm:.3e} relative (bound 1e-5); peaks "
        f"{runs['tp']['max_memory_allocated'] / 2**30:.2f} and "
        f"{runs['one-axis']['max_memory_allocated'] / 2**30:.2f} GiB")
    assert d_loss <= 1e-4 and d_norm <= 1e-5, runs
    out["f32"] = {"d_loss": d_loss, "d_norm": d_norm,
                  **{k: {"losses": v["losses"], "grad_norms": v["grad_norms"]}
                     for k, v in runs.items()}}
    smoke = dataclasses.replace(get_config("minitron-8b-smoke"), dtype="float32")
    run = RunConfig(**TRAIN_RUN, **TP_TRAIN_FIELDS)
    losses = {}
    with tempfile.TemporaryDirectory() as d:
        for dev in ("cpu", "cuda"):
            tr = Trainer(smoke, run, mesh=_tp_train_mesh(dev), ckpt_dir=d, device=dev)
            if dev == "cpu":
                params, opt = tr.init_state()
                checkpoint.save_checkpoint(d, 0, tr._full(params))
                checkpoint.save_checkpoint(os.path.join(d, "opt"), 0,
                                           tr._opt_map(tr._full, opt))
            losses[dev] = [h["loss"] for h in tr.train(batch=8, seq=32, steps=2,
                                                       log_every=1)[2]]
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    log(f"train tp smoke: minitron-8b-smoke f32 on (2, 2), card against CPU, losses "
        f"{losses['cuda']} and {losses['cpu']}, max abs diff {err:.3e} (tol 1e-4)")
    assert len(losses["cuda"]) == 2 and err <= 1e-4, losses
    out["smoke_err"] = err
    return out, counts


def _hold_copies(torch, trainer, into: dict) -> None:
    """Hooks ``trainer`` so that after its last step, when ``train`` first
    assembles the full parameters (outside the steps' times), every rank
    row holding a copy of a block is asserted bit-equal to the block's
    owner in the parameters and both AdamW moments
    (:func:`_copies_bit_equal`); the elements compared land in
    ``into['copied_elements_equal']``."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.dist import sharding

    step, full, last = trainer._step_fn, trainer._full, {}
    specs = tree_flatten(trainer.specs, sharding.is_spec)[0]

    def stepped(params, opt, batch):
        out = step(params, opt, batch)
        last["state"] = out[:2]
        return out

    def assembled(tree, **kw):
        if "state" in last:
            params, opt = last.pop("state")
            into["copied_elements_equal"] = _copies_bit_equal(
                torch, (params, opt["m"], opt["v"]), specs, trainer.mesh)
        return full(tree, **kw)

    stepped.gather_events = step.gather_events
    trainer._step_fn, trainer._full = stepped, assembled


def _tp_family_smoke(torch) -> dict:
    """TP_TRAIN_SMOKE in f32 on (2, 2) under grad_allreduce, card against
    CPU: 2 steps of 8 x 32 from one initial state (the CPU trainer's, every
    QKV bias drawn nonzero from a seed, saved as a checkpoint that both
    restore), per-step losses within 1e-4. Returns each config's largest
    difference."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    run = RunConfig(**TRAIN_RUN, **TP_TRAIN_FIELDS)
    errs = {}
    for arch in TP_TRAIN_SMOKE:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        losses = {}
        with tempfile.TemporaryDirectory() as d:
            for dev in ("cpu", "cuda"):
                tr = Trainer(cfg, run, mesh=_tp_train_mesh(dev), ckpt_dir=d, device=dev)
                if dev == "cpu":
                    params, opt = tr.init_state()
                    params = tr._full(params)
                    gen = torch.Generator().manual_seed(50)
                    for path, t in zip(tree_paths(params), tree_leaves(params)):
                        if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
                            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
                    checkpoint.save_checkpoint(d, 0, params)
                    checkpoint.save_checkpoint(os.path.join(d, "opt"), 0,
                                               tr._opt_map(tr._full, opt))
                losses[dev] = [h["loss"] for h in tr.train(batch=8, seq=32, steps=2,
                                                           log_every=1)[2]]
        err = [abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"])]
        assert len(err) == 2 and max(err) <= 1e-4, (arch, losses)
        errs[arch] = max(err)
    log(f"train tp_fam smoke: f32 on (2, 2), card against CPU, losses' max abs diff "
        f"{ {k: '%.3e' % v for k, v in errs.items()} } (tol 1e-4)")
    return errs


def _jittered(torch, trainer) -> None:
    """Hooks ``trainer`` so that in its initial state every element of its
    first attention output projection ``wo`` is moved by at most one bf16
    step, at random (times ``1 + 2^-8 u``, ``u`` uniform in [-1, 1) from a
    seeded generator, rounded back): phase 6u's bf16 control, one rounding
    of every element of the attention's output, as the model axis's bf16
    partial sums make."""
    from repro_torch.core.tree import tree_leaves, tree_paths

    init = trainer.restore_or_init

    def jittered():
        params, opt, step = init()
        w = next(t for p, t in zip(tree_paths(params), tree_leaves(params))
                 if p.endswith("attn/wo"))
        gen = torch.Generator(device=w.device).manual_seed(0)
        u = torch.rand(w.shape, generator=gen, device=w.device) * 2 - 1
        w.copy_((w.float() * (1 + 2.0**-8 * u)).to(w.dtype))
        return params, opt, step

    trainer.restore_or_init = jittered


def _tp_family_f32(torch, cfg, micro: int) -> dict:
    """``cfg`` at FAMILY_F32_LAYERS layers (encoder too) in f32, TF32 off:
    the TP trainer on (2, 2) against the one-axis grad_allreduce on 4
    ranks, both in ``micro`` microbatches, last loss within
    FAMILY_F32_LOSS and grad norms within FAMILY_F32_NORM relative."""
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(cfg, num_layers=FAMILY_F32_LAYERS, dtype="float32",
                              encoder_layers=FAMILY_F32_LAYERS if cfg.encoder_layers else 0)
    batch = RANKS if cfg.frontend == "vision" else TRAIN_BATCH
    seq = VLM_TEXT if cfg.frontend == "vision" else TRAIN_SEQ
    runs = {}
    for label, mesh, fields in (
            ("one-axis", make_mesh(RANKS, device="cuda"), {"sync_mode": "grad_allreduce"}),
            ("tp", _tp_train_mesh(), TP_TRAIN_FIELDS)):
        gc.collect()
        torch.cuda.empty_cache()
        params, runs[label] = train_mode(torch, f32, mesh, {**fields, "num_microbatches": micro},
                                         batch=batch, seq=seq)
        del params
    d_loss, d_norm = _deviation(runs["tp"], runs["one-axis"])
    log(f"train tp_fam {cfg.name} f32 ({FAMILY_F32_LAYERS} layer): losses "
        f"{['%.6f' % x for x in runs['tp']['losses']]} beside the one-axis "
        f"{['%.6f' % x for x in runs['one-axis']['losses']]}; last loss {d_loss:.3e} (bound "
        f"{FAMILY_F32_LOSS}), grad norms {d_norm:.3e} relative (bound {FAMILY_F32_NORM})")
    assert d_loss <= FAMILY_F32_LOSS and d_norm <= FAMILY_F32_NORM, (cfg.name, runs)
    return {"d_loss": d_loss, "d_norm": d_norm}


def train_tp_families(torch, one_axis: dict) -> tuple[dict, dict]:
    """Phase 6u (see the module's docstring). ``one_axis``: the one-axis
    run of each config by phase ('6m', '6f', '6v'). Returns the phase's
    numbers and the launch counts of its timed runs (the ``train_tp_fam``
    path: the sum of their own counts, without the tuner table's timed
    gathers, the controls, the f32 runs or the smoke runs)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh

    mesh = _tp_train_mesh()
    out, counts = {}, None
    for arch, layers, batch, seq, micro, phase, one_fields in TP_TRAIN_FAMILIES:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        one = one_axis[phase]
        rec = out[arch] = {}
        gc.collect()
        torch.cuda.empty_cache()
        params, control = train_mode(torch, cfg, make_mesh(RANKS, device="cuda"), one_fields,
                                     batch=batch, seq=seq,
                                     prepare=lambda tr: _jittered(torch, tr))
        del params
        c_loss, c_norm = _deviation(control, one)
        lim_loss, lim_norm = (max(1e-3, FAMILY_CONTROL_MULT * c_loss),
                              max(2e-4, FAMILY_CONTROL_MULT * c_norm))
        rec["control"] = {"d_loss": c_loss, "d_norm": c_norm, "losses": control["losses"],
                          "grad_norms": control["grad_norms"]}
        log(f"train tp_fam {arch} control (phase {phase}'s one-axis run, every element of the "
            f"first attention wo moved by at most one bf16 step): last loss {c_loss:.3e} and "
            f"grad norms "
            f"{c_norm:.3e} relative from the one-axis run; the TP runs' bound {lim_loss:.3e} / "
            f"{lim_norm:.3e} (phase 6's 1e-3 / 2e-4 or {FAMILY_CONTROL_MULT:g}x the control)")
        with tempfile.TemporaryDirectory() as d:
            runs = [("compiled", {**TP_TRAIN_FIELDS, "num_microbatches": micro})]
            if arch == TP_TRAIN_INKERNEL:
                table, table_rows = _gather_table(torch, cfg, mesh, d)
                log(f"train tp_fam {arch} table: in-kernel gathers (bytes, algo, chunks, ms) "
                    f"{table_rows}")
                runs.append(("inkernel", {"sync_mode": "grad_allreduce", "tuner_table": table,
                                          "num_microbatches": micro}))
            held = None
            for label, fields in runs:
                gc.collect()
                torch.cuda.empty_cache()
                copies = {}

                def inspect(_params, _opt, trainer):
                    torch.cuda.synchronize()
                    return {"gather_ms": [a.elapsed_time(b)
                                          for a, b in trainer._step_fn.gather_events],
                            "held": [_held_bytes(trainer, r) for r in range(mesh.size)]}

                params, r = train_mode(torch, cfg, mesh, fields, batch=batch, seq=seq,
                                       inspect=inspect,
                                       prepare=lambda tr: _hold_copies(torch, tr, copies))
                r.update(copies)
                if label == "compiled" and len(runs) > 1:
                    held = [t.cpu() for t in tree_leaves(params)]
                elif held is not None:
                    assert all(same_bits(torch, a, b.cpu()) for a, b in
                               zip(held, tree_leaves(params))), \
                        f"{arch}: the in-kernel gathers' parameters differ from the compiled ones'"
                    held = None
                del params
                counts = ({k: counts[k] + v for k, v in r["launches"].items()} if counts
                          else dict(r["launches"]))
                d_loss, d_norm = _deviation(r, one)
                rows = [b for b, _ in r["held"]]
                log(f"train tp_fam {arch} {label} ({cfg.num_layers} layers, {r['params']} "
                    f"params, {batch} x {seq} tokens, {micro} microbatch(es)): " + _train_line(r)
                    + f"; beside phase {phase}'s one-axis run: step {one['step_s']:.4f} s, peak "
                    f"{one['max_memory_allocated'] / 2**30:.2f} GiB; gather ms a step "
                    f"{['%.3f' % x for x in r['gather_ms']]}; held bytes a rank row {rows} "
                    f"({rows[0] / r['held'][0][1]:.4f} of the one-axis {r['held'][0][1]}); "
                    f"{r['copied_elements_equal']} copied elements bit-equal to their owners; "
                    f"merge {r['launches']['fused_combine']} and inkernel_rdma "
                    f"{r['launches']['inkernel_rdma']} launches; last loss {d_loss:.3e} from "
                    f"the one-axis run, grad norms {d_norm:.3e} relative (bound {lim_loss:.3e} "
                    f"/ {lim_norm:.3e})")
                assert d_loss <= lim_loss and d_norm <= lim_norm, (arch, label, r, one)
                assert r["max_memory_allocated"] < 70 * 2**30, (arch, label,
                                                                r["max_memory_allocated"])
                assert r["copied_elements_equal"] > 0, (arch, label)
                launches = r["launches"]
                if label == "compiled":
                    assert launches["fused_combine"] > 0 == launches["inkernel_rdma"], launches
                else:
                    assert launches["inkernel_rdma"] > 0 == launches["fused_combine"], launches
                flash = launches["flash_attention"] + launches["flash_attention_sm90"]
                assert flash == 0, f"training launched a flash kernel: {launches}"
                r["d_loss"], r["d_norm"] = d_loss, d_norm
                rec[label] = r
        gc.collect()
        torch.cuda.empty_cache()
        rec["f32"] = _tp_family_f32(torch, cfg, micro)
    gc.collect()
    torch.cuda.empty_cache()
    out["smoke_err"] = _tp_family_smoke(torch)
    return out, counts


def train_moe(torch) -> dict:
    """Phase 6m: mixtral-8x7b at full width (MOE_TRAIN_LAYERS of 32 layers,
    8 experts top-2, bf16, seeded weights) trains phase 6's 3 steps of 8 x
    512 tokens on the 4 emulated ranks: grad_allreduce (one pass over the
    global batch, the aux of the whole batch), tuned_allreduce with the
    synced rows compared (each rank's aux its own) and compressed_allreduce
    over the int8 wire. The router's leaves are f32 among bf16 ones: the
    bucket plan's f32 buckets are printed, and the int8 run's residual is
    checked to keep an f32 row a rank, finite and nonzero in the router's
    rows. Launch counts are zeroed by the caller right before."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import bucketing
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=MOE_TRAIN_LAYERS)
    mesh = make_mesh(RANKS, device="cuda")

    def residual(params, opt, _trainer):
        rows = {}
        for path, p, e in zip(tree_paths(params), tree_leaves(params), tree_leaves(opt["ef"])):
            assert e.dtype == torch.float32 and tuple(e.shape) == (RANKS,) + tuple(p.shape), \
                (path, e.dtype, tuple(e.shape))
            if path.endswith("router"):
                amax = [float(row.abs().max()) for row in e]
                assert all(math.isfinite(a) and a > 0 for a in amax), (path, amax)
                rows[path] = amax
        return {"router_residual_amax": rows}

    out, spec_line = {}, None
    for label, fields in MOE_TRAIN_MODES:
        params, r = train_mode(torch, cfg, mesh, fields, check_rows=label == "tuned_allreduce",
                               inspect=residual if label == "compressed_int8" else None)
        if spec_line is None:
            spec = bucketing.plan_buckets(params, RunConfig().bcast_bucket_bytes)
            paths = tree_paths(params)
            f32 = [(b, spec.bucket_sizes[b],
                    [paths[m.index] for m in spec.leaves if m.bucket == b])
                   for b, d in enumerate(spec.bucket_dtypes) if d == torch.float32]
            routers = [p for p in paths if p.endswith("router")]
            assert all(any(p in leaves for _b, _n, leaves in f32) for p in routers), f32
            spec_line = f"{spec.num_buckets} buckets, f32 (bucket, elements, leaves) {f32}"
        del params
        out[label] = r
        log(f"train moe {label}: " + _train_line(r)
            + (f", rows differ {r['grad_rows_differ']}" if "grad_rows_differ" in r else "")
            + (f", router residual amax by rank {r['router_residual_amax']}"
               if "router_residual_amax" in r else ""))
    log(f"train moe buckets: {spec_line}")
    base, tuned, int8 = out["grad_allreduce"], out["tuned_allreduce"], out["compressed_int8"]
    assert not any(tuned["grad_rows_differ"]), tuned["grad_rows_differ"]
    assert tuned["launches"]["fused_combine"] > 0 and int8["launches"]["quantize_blocks"] > 0, \
        (tuned["launches"], int8["launches"])
    d_loss = abs(tuned["losses"][-1] - base["losses"][-1])
    d_aux = [t - g for t, g in zip(tuned["aux"], base["aux"])]
    d_int8 = abs(int8["losses"][-1] - tuned["losses"][-1])
    log(f"train moe tuned_allreduce against grad_allreduce: last loss differs by {d_loss:.3e} "
        f"(bound 1e-3); aux, per-rank mean minus global, {['%.3e' % x for x in d_aux]}; "
        f"compressed_int8 against tuned_allreduce: last loss differs by {d_int8:.3e} "
        "(bound 5e-3)")
    assert d_loss <= 1e-3 and d_int8 <= 5e-3, (base["losses"], tuned["losses"], int8["losses"])
    return out


def train_vlm(torch) -> dict:
    """Phase 6v: paligemma-3b at full width (VLM_TRAIN_LAYERS of 18
    layers, bf16, seeded weights) trains 3 steps of tuned_allreduce on the
    4 emulated ranks, one sequence a rank: 256 stub patch embeddings +
    VLM_TEXT tokens, 4096 positions. Training attention at 4096 keys takes
    the differentiable block loop, so neither flash kernel launches.
    Launch counts are zeroed by the caller right before."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_config("paligemma-3b"), num_layers=VLM_TRAIN_LAYERS)
    params, r = train_mode(torch, cfg, make_mesh(RANKS, device="cuda"),
                           {"sync_mode": "tuned_allreduce", "compiled_collectives": True},
                           batch=RANKS, seq=VLM_TEXT)
    del params
    log(f"train vlm tuned_allreduce ({VLM_TRAIN_LAYERS} layers, {r['params']} params, "
        f"{RANKS} x ({cfg.prefix_len} + {VLM_TEXT}) positions): " + _train_line(r))
    flash = {k: r["launches"][k] for k in ("flash_attention", "flash_attention_sm90")}
    assert not any(flash.values()), f"training launched a flash kernel: {flash}"
    assert r["launches"]["fused_combine"] > 0, r["launches"]
    return r


def _family_run(torch, arch: str, cfg, label: str, what: str = "") -> dict:
    """One phase-6f run: ``cfg`` trains phase 6's 3 steps of 8 x 512 tokens
    (an encoder-decoder adds its stub frames) on the 4 emulated ranks under
    FAMILY_RUNS[``label``]. Its peak under 70 GiB, no flash launch, the
    synced rows bit-equal where compared. Returns the run's record."""
    from repro_torch.launch.mesh import make_mesh

    fields, check_rows = FAMILY_RUNS[label]
    params, r = train_mode(torch, cfg, make_mesh(RANKS, device="cuda"), fields,
                           check_rows=check_rows)
    del params
    r["layers"] = cfg.num_layers
    log(f"train {arch} {what}{label} ({cfg.num_layers} layers, {r['params']} params): "
        + _train_line(r) + (f", rows differ {r['grad_rows_differ']}" if check_rows else ""))
    assert r["max_memory_allocated"] < FAMILY_PEAK_LIMIT, (arch, label, r)
    flash = {k: r["launches"][k] for k in ("flash_attention", "flash_attention_sm90")}
    assert not any(flash.values()), f"training launched a flash kernel: {flash}"
    if check_rows:
        assert not any(r["grad_rows_differ"]), (arch, label, r["grad_rows_differ"])
    return r


def train_family(torch, arch: str, cfg, sync_cfg, labels) -> dict:
    """Phase 6f, one family's path: ``cfg`` (full width) under
    grad_allreduce and ``sync_cfg`` (``cfg``, or it at fewer layers) under
    each explicit run of ``labels``, with a grad_allreduce of its own where
    it is cut (``grad_allreduce_cut``). The merge must launch. Returns the
    runs by label."""
    from repro_torch.data.pipeline import batches, make_source

    out = {"grad_allreduce": _family_run(torch, arch, cfg, "grad_allreduce")}
    if sync_cfg is not cfg:
        out["grad_allreduce_cut"] = _family_run(torch, arch, sync_cfg, "grad_allreduce")
    for label in labels:
        if label != "grad_allreduce":
            out[label] = _family_run(torch, arch, sync_cfg, label)
    assert out["tuned_allreduce"]["launches"]["fused_combine"] > 0, out["tuned_allreduce"]
    if cfg.arch_type == "encdec":  # the host's share of each step: the stub frames
        it = batches(make_source(cfg, seed=0), cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = next(it)
        torch.cuda.synchronize()
        out["frames_s"] = time.perf_counter() - t0
        log(f"train {arch}: one batch's {tuple(b['embeds'].shape)} stub frames drawn on the "
            f"host and copied in {out['frames_s']:.3f} s (inside each step's time)")
        del b, it
    return out


def family_checks(torch, arch: str, sync_cfg, labels, out: dict) -> None:
    """Phase 6f, one family's agreement, after its path's counts are read:
    each explicit run of ``out`` against the grad_allreduce at its depth,
    last loss and grad norms within the larger of phase 6's limits (1e-3,
    2e-4 relative) and FAMILY_CONTROL_MULT times the bf16 control's
    distance (FAMILY_BF16_CONTROL); then the family in f32 at
    FAMILY_F32_LAYERS layers (encoder too), every explicit mode within
    FAMILY_F32_LOSS / FAMILY_F32_NORM of grad_allreduce (its records go
    into ``out``)."""
    base = out.get("grad_allreduce_cut", out["grad_allreduce"])
    explicit = [label for label in labels if label != "grad_allreduce"]
    c_loss, c_norm = FAMILY_BF16_CONTROL[arch]
    lim_loss = max(1e-3, FAMILY_CONTROL_MULT * c_loss)
    lim_norm = max(2e-4, FAMILY_CONTROL_MULT * c_norm)
    for label in explicit:
        d_loss, d_norm = out[label]["against_grad_allreduce"] = _deviation(out[label], base)
        log(f"train {arch} {label} against grad_allreduce ({sync_cfg.num_layers} layers): last "
            f"loss differs by {d_loss:.3e}, grad norms by {d_norm:.3e} relative at most "
            f"(bound {lim_loss:.3e} / {lim_norm:.3e}: phase 6's 1e-3 / 2e-4 or "
            f"{FAMILY_CONTROL_MULT:g}x the bf16 control's {c_loss:.3e} / {c_norm:.3e}; "
            f"{d_loss / c_loss:.2f}x / {d_norm / c_norm:.2f}x the control)")
        assert d_loss <= lim_loss and d_norm <= lim_norm, (
            arch, label, out[label]["losses"], out[label]["grad_norms"], base["losses"],
            base["grad_norms"])
    f32 = dataclasses.replace(sync_cfg, dtype="float32", num_layers=FAMILY_F32_LAYERS,
                              encoder_layers=FAMILY_F32_LAYERS if sync_cfg.encoder_layers else 0)
    exact = {label: _family_run(torch, arch, f32, label, "f32 control ")
             for label in ["grad_allreduce", *explicit]}
    out["control_f32"] = {}
    for label in explicit:
        d_loss, d_norm = out["control_f32"][label] = _deviation(exact[label],
                                                                exact["grad_allreduce"])
        log(f"train {arch} f32 control {label} against grad_allreduce ({FAMILY_F32_LAYERS} "
            f"layer): last loss differs by {d_loss:.3e} (bound {FAMILY_F32_LOSS}), grad norms "
            f"by {d_norm:.3e} relative at most (bound {FAMILY_F32_NORM})")
        assert d_loss <= FAMILY_F32_LOSS and d_norm <= FAMILY_F32_NORM, (arch, label, exact)
    assert exact["tuned_allreduce"]["launches"]["fused_combine"] > 0, exact["tuned_allreduce"]


def hybrid_memory_probe(torch) -> dict:
    """Phase 6f's probe: one forward and backward (remat, as the trainer
    runs it) of one PROBE_SEQ-token sequence through hymba-1.5b at full
    depth, bf16, seeded weights: one rank's share of the reference's
    ``train_4k``. The peak above the weights and their gradients is what a
    sequence costs; four of them in one grad_allreduce pass are projected
    from it beside AdamW's state (one sample, host clock)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.models import Model

    cfg = get_config("hymba-1.5b")
    model = Model(cfg)
    leaves, treedef = tree_flatten(model.init(seed=0, device="cuda"))
    ps = [p.requires_grad_(True) for p in leaves]
    n_params = sum(p.numel() for p in ps)
    toks = torch.randint(0, cfg.vocab_size, (1, PROBE_SEQ + 1),
                         generator=torch.Generator().manual_seed(0)).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = model.loss(tree_unflatten(treedef, ps), batch, remat=True)
    grads = torch.autograd.grad(loss, ps)
    loss = float(loss.detach())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    del grads, ps, leaves
    assert math.isfinite(loss), loss
    per_seq = peak - weights - grad_bytes
    # a grad_allreduce pass of 4 such sequences: the weights, their
    # gradients, AdamW's f32 m and v, and 4 sequences' share
    four = weights + grad_bytes + 8 * n_params + 4 * per_seq
    out = {"seq": PROBE_SEQ, "peak": peak, "weights": weights, "per_seq": per_seq,
           "s": secs, "four_projected": four, "loss": loss}
    log(f"train probe hymba-1.5b ({cfg.num_layers} layers, {n_params} params, remat): one "
        f"{PROBE_SEQ}-token sequence forward and backward {secs:.3f} s, peak "
        f"{peak / 2**30:.2f} GiB (weights {weights / 2**30:.2f}, their gradients "
        f"{grad_bytes / 2**30:.2f}, the sequence {per_seq / 2**30:.2f}); 4 sequences in one "
        f"grad_allreduce pass projected at {four / 2**30:.2f} GiB "
        f"({'fits' if four < 80e9 else 'does not fit'} in 80 GB)")
    return out


def train_families(torch) -> tuple[dict, dict]:
    """Phase 6f: the four families of FAMILY_TRAIN, each a path whose
    launch counts are zeroed right before its runs and read right after
    them, before its agreement checks run the f32 control; then the hybrid
    memory probe (counted on no path). Returns the numbers and the counts
    by path."""
    from repro_torch import kernels
    from repro_torch.configs import get_config

    out, counts = {}, {}
    for path, arch, layers, labels, sync_layers in FAMILY_TRAIN:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        sync_cfg = (cfg if sync_layers is None
                    else dataclasses.replace(cfg, num_layers=sync_layers))
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        out[path] = train_family(torch, arch, cfg, sync_cfg, labels)
        counts[path] = kernels.launch_counts()
        runs = [r for r in out[path].values() if isinstance(r, dict)]
        assert all(c == sum(r["launches"][k] for r in runs) for k, c in counts[path].items()), \
            (path, counts[path], [r["launches"] for r in runs])
        family_checks(torch, arch, sync_cfg, labels, out[path])
    gc.collect()
    torch.cuda.empty_cache()
    out["probe"] = hybrid_memory_probe(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def small_train_references(torch) -> dict:
    """The f32 smoke trainings on the card against the same runs on the
    CPU, 2 steps each from one initial state (saved as a checkpoint by the
    CPU trainer and restored by both), per-step losses within 1e-4:
    minitron-8b-smoke under param_bcast (phase 6), mixtral-8x7b-smoke under
    grad_allreduce and tuned_allreduce (6m), paligemma-3b-smoke under
    tuned_allreduce (6v); xlstm-350m-smoke, hymba-1.5b-smoke,
    whisper-large-v3-smoke and qwen1.5-32b-smoke under tuned_allreduce
    with compiled collectives (6f: the merge on the card, its plain version
    on the CPU), every QKV bias drawn nonzero from a seed before the
    checkpoint is saved."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    compiled = {"compiled_collectives": True}
    for arch, mode, extra in (("minitron-8b-smoke", "param_bcast", {}),
                              ("mixtral-8x7b-smoke", "grad_allreduce", {}),
                              ("mixtral-8x7b-smoke", "tuned_allreduce", {}),
                              ("paligemma-3b-smoke", "tuned_allreduce", {}),
                              ("xlstm-350m-smoke", "tuned_allreduce", compiled),
                              ("hymba-1.5b-smoke", "tuned_allreduce", compiled),
                              ("whisper-large-v3-smoke", "tuned_allreduce", compiled),
                              ("qwen1.5-32b-smoke", "tuned_allreduce", compiled)):
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        run = RunConfig(sync_mode=mode, **TRAIN_RUN, **extra)
        losses = {}
        with tempfile.TemporaryDirectory() as d:
            for dev in ("cpu", "cuda"):
                tr = Trainer(cfg, run, mesh=make_mesh(RANKS, device=dev), ckpt_dir=d,
                             device=dev)
                if dev == "cpu":
                    params, opt = tr.init_state()
                    gen = torch.Generator().manual_seed(50)
                    for path, t in zip(tree_paths(params), tree_leaves(params)):
                        if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
                            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
                    checkpoint.save_checkpoint(d, 0, params)
                    checkpoint.save_checkpoint(os.path.join(d, "opt"), 0, opt)
                losses[dev] = [h["loss"] for h in tr.train(batch=8, seq=32, steps=2,
                                                           log_every=1)[2]]
        err = [abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"])]
        assert len(err) == 2 and all(e <= 1e-4 for e in err), (arch, mode, losses, err)
        errs[f"{arch} {mode}"] = max(err)
    log("reference: smoke f32 training losses, card vs CPU, max abs diff "
        f"{ {k: '%.3e' % v for k, v in errs.items()} } (tol 1e-4)")
    return errs


def faults_training(torch, tuned: dict) -> dict:
    """Phase 11a: phase 6's tuned_allreduce run on a mesh whose rank 1 is
    reported dead (``Trainer(health=)``): the trainer prints its fallback
    line and trains on the survivors' mean, launching no plan kernel. Its
    first step's loss and grad norm are held against a tuned_allreduce step
    on 3 ranks from the same initial state on the batch without rank 1's
    two rows (the survivors' mean computed another way: a plan's allreduce
    of the three ranks' gradients), within phase 6's bf16-mode limits. Not
    against grad_allreduce: its one pass over 6 sequences scales the
    loss's gradient by 1/3072, which bf16 rounds 0.19% high (a 1.9e-3
    higher grad norm than the f32 gradient's; tools/grad_precision.py),
    where each rank's 1/1024 is exact."""
    import contextlib
    import io

    from repro_torch.comm import MeshHealth
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    health = MeshHealth(n=RANKS, dead_ranks=(FAULT_DEAD,))
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        params, rec = train_mode(torch, cfg, make_mesh(RANKS, device="cuda"),
                                 {"sync_mode": "tuned_allreduce", "compiled_collectives": True},
                                 health=health)
    sys.stdout.write(said.getvalue())
    assert "falls back to psum-over-survivors" in said.getvalue(), said.getvalue()
    del params
    assert rec["launches"]["fused_combine"] == 0 == rec["launches"]["inkernel_rdma"], rec
    gc.collect()
    torch.cuda.empty_cache()
    ref = Trainer(cfg, RunConfig(**TRAIN_RUN, sync_mode="tuned_allreduce",
                                 compiled_collectives=True),
                  mesh=make_mesh(RANKS - 1, device="cuda"))
    params, opt = ref.init_state()
    batch = next(batches(ref.source, cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device="cuda"))
    per_rank = TRAIN_BATCH // RANKS
    keep = torch.tensor([r for r in range(TRAIN_BATCH) if r // per_rank != FAULT_DEAD],
                        device="cuda")
    _, _, out = ref._step_fn(params, opt, {k: v[keep] for k, v in batch.items()})
    want_loss, want_norm = float(out["loss"]), float(out["grad_norm"])
    del params, opt, out, ref, batch
    d_loss = abs(rec["losses"][0] - want_loss)
    d_norm = abs(rec["grad_norms"][0] - want_norm) / want_norm
    log(f"faults train: {said.getvalue().splitlines()[0]}")
    log(f"faults train: losses {['%.4f' % x for x in rec['losses']]}, step {rec['step_s']:.4f} "
        f"s, peak {rec['max_memory_allocated'] / 2**30:.2f} GiB (phase 6 tuned_allreduce "
        f"{tuned['step_s']:.4f} s, {tuned['max_memory_allocated'] / 2**30:.2f} GiB), launches "
        f"{ {k: v for k, v in rec['launches'].items() if v} }; first step against tuned_allreduce "
        f"on 3 ranks without rank {FAULT_DEAD}'s rows: loss {rec['losses'][0]:.6f} / "
        f"{want_loss:.6f} ({d_loss:.3e}, bound 1e-3), grad norm {rec['grad_norms'][0]:.6f} / "
        f"{want_norm:.6f} ({d_norm:.3e} relative, bound 2e-4)")
    assert d_loss <= 1e-3 and d_norm <= 2e-4, (rec["losses"], rec["grad_norms"], want_loss,
                                                want_norm)
    rec.update(survivor_loss=want_loss, survivor_grad_norm=want_norm)
    return rec


def _plan_line(plan) -> str:
    return (f"{plan.algo} K={plan.num_chunks} n={plan.n} root={plan.root} "
            f"predicted {plan.predicted_s * 1e3:.3f} ms")


def _replay_bound_ms(plan, cols: int) -> float:
    """The bytes bound of one replay of ``plan`` at ``cols`` bf16 elements a
    rank: the rows every class-round reads and writes (read twice on
    combine rounds), over 3.35 TB/s."""
    from repro_torch.kernels import inkernel_collective as ik

    tables = ik.pack_tables(plan.lowered())
    return ik.replay_bytes(tables, -(-cols // plan.lowered().num_chunks), 2) \
        / HBM_BYTES_PER_S * 1e3


def faults_plans(torch, x) -> tuple[dict, dict]:
    """Phase 11b: the degraded plans at the training embedding bucket
    (``x``: (4, 1,048,576,000) bf16) with rank 1 dead: the allreduce and
    the bcast from physical rank 2 (logical root 1) replanned on the 3
    survivors, each run on the survivors' rows with the compiled and the
    in-kernel executor, bit-equal to each other and to the device-initiated
    replay's plain version, written back with row 1 untouched; each timed
    (CUDA events) beside the healthy 4-rank plan and the bytes bound; a dead
    root refused; a slow-link report re-priced with the healthy schedule
    and the same bits. Returns the numbers and the healthy allreduce's
    compiled result (the chain's reference)."""
    from repro_torch.comm import DeadRankError, MeshHealth, apply_plan, plan_cached, plan_degraded

    n, N = x.shape
    M = N * x.element_size()
    health = MeshHealth(n=n, dead_ranks=(FAULT_DEAD,))
    survivors = [r for r in range(n) if r != FAULT_DEAD]
    out, healthy_allreduce = {}, None
    for op, root in (("allreduce", 0), ("bcast", 2)):
        healthy = plan_cached(op, M, n, root=root)
        plan = plan_cached(op, M, n, root=root, health=health)
        assert plan.survivors == tuple(survivors) and plan.n == n - 1, plan
        assert plan.root == (survivors.index(root) if op == "bcast" else 0), plan
        rows = x[survivors]
        res = {flag: apply_plan(plan, rows.clone(), **{flag: True})
               for flag in ("compiled", "inkernel")}
        want = _plain_collective(torch, plan, rows.clone())
        for flag, got in res.items():
            assert same_bits(torch, got, want), f"degraded {op} {flag} differs from plain"
        y = x.clone()
        y[survivors] = res["inkernel"]
        assert same_bits(torch, y[FAULT_DEAD], x[FAULT_DEAD]), f"degraded {op}: row 1 moved"
        if op == "bcast":
            assert all(same_bits(torch, y[r], x[root]) for r in survivors), op
        del y, res, want
        rec = {"healthy": {"plan": _plan_line(healthy), "bound_ms": _replay_bound_ms(healthy, N)},
               "degraded": {"plan": _plan_line(plan), "bound_ms": _replay_bound_ms(plan, N)}}
        for label, p, buf in (("healthy", healthy, x), ("degraded", plan, rows)):
            scratch = buf.clone()
            for flag in ("compiled", "inkernel"):
                rec[label][f"{flag}_ms"] = time_ms(
                    torch, lambda: apply_plan(p, scratch, **{flag: True}), reps=3, warmup=1)
            del scratch
        if op == "allreduce":
            healthy_allreduce = apply_plan(healthy, x.clone(), compiled=True)
        del rows
        torch.cuda.empty_cache()
        out[op] = rec
        log(f"faults plans {op}" + (f" root {root}" if op == "bcast" else "") + ", "
            + "; ".join(f"{label} {r['plan']}: compiled {r['compiled_ms']:.3f} ms, in-kernel "
                        f"{r['inkernel_ms']:.3f} ms (bound {r['bound_ms']:.3f} ms)"
                        for label, r in rec.items())
            + f"; degraded compiled == in-kernel == plain, row {FAULT_DEAD} bit-unchanged")
    try:
        plan_degraded("bcast", M, n, health, root=FAULT_DEAD)
    except DeadRankError as e:
        log(f"faults plans: bcast from dead root {FAULT_DEAD} refused: DeadRankError: {e}")
    else:
        raise AssertionError("a bcast from a dead root was planned")
    slow = MeshHealth(n=n, slow_links={(0, 1): 4.0})
    healthy = plan_cached("allreduce", M, n)
    plan = plan_degraded("allreduce", M, n, slow)
    assert plan.survivors is None and plan.schedule.name == healthy.schedule.name, plan
    assert plan.num_chunks == healthy.num_chunks and plan.decision.source.endswith("+degraded")
    assert plan.predicted_s > healthy.predicted_s, (plan.predicted_s, healthy.predicted_s)
    got = apply_plan(plan, x.clone(), compiled=True)
    assert same_bits(torch, got, healthy_allreduce), "the slow-link plan's replay differs"
    del got
    out["slow_link"] = {"plan": _plan_line(plan), "source": plan.decision.source}
    log(f"faults plans slow link (0, 1) x4: {_plan_line(plan)} ({plan.decision.source}; "
        f"healthy {healthy.predicted_s * 1e3:.3f} ms), replay bit-equal to the healthy plan's")
    return out, healthy_allreduce


def faults_chain(torch, x, want) -> dict:
    """Phase 11c: ``apply_plan_resilient`` at the same bucket. The healthy
    bf16 allreduce under the default policy is served by the in-kernel
    stage (one ``inkernel_rdma`` launch, no merge), bit-equal to the
    compiled replay ``want``; the int8-wire plan, nothing injected, burns
    the in-kernel stage's attempt and retry on the executor's veto and is
    served by the compiled stage with the launches of
    ``apply_plan(compiled=True)`` and bit-equal to it; ``timeout_s=1e-9``
    flags a straggler and still returns the same bits. Then each stage's
    replay, timed by CUDA events, is fed to a ``Watchdog``."""
    from repro_torch import kernels
    from repro_torch.comm import (FallbackPolicy, Tuner, Watchdog, apply_plan,
                                  apply_plan_resilient, plan_cached)
    from repro_torch.comm.api import _one_shot_fallback
    from repro_torch.comm.resilience import DEFAULT_CHAIN

    n, N = x.shape
    plan = plan_cached("allreduce", N * x.element_size(), n)
    out = {}

    def chain(p, **policy):
        events = []
        before = kernels.launch_counts()
        got = apply_plan_resilient(p, x, policy=FallbackPolicy(**policy),
                                   on_event=events.append)
        return got, [(e.stage, e.attempt, e.outcome) for e in events], \
            _launched(torch, before), [e.elapsed_s for e in events]

    got, events, launched, secs = chain(plan)
    assert events == [("inkernel", 0, "ok")], events
    assert launched == {"inkernel_rdma": 1}, launched
    assert same_bits(torch, got, want), "the chain's in-kernel stage differs from compiled"
    del got
    out["bf16"] = {"events": events, "elapsed_s": secs, "launches": launched}
    got, events, launched_s, secs_s = chain(plan, timeout_s=1e-9)
    assert events == [("inkernel", 0, "straggler")], events
    assert same_bits(torch, got, want), "the straggler's result differs"
    del got
    out["straggler"] = {"events": events, "elapsed_s": secs_s}
    torch.cuda.empty_cache()
    plan8 = plan_cached("allreduce", N * 4, n, wire_format="int8")
    before = kernels.launch_counts()
    want8 = apply_plan(plan8, x.clone(), compiled=True)
    direct = _launched(torch, before)
    got, events8, launched8, secs8 = chain(plan8)
    assert events8 == [("inkernel", 0, "error"), ("inkernel", 1, "error"),
                       ("compiled", 0, "ok")], events8
    assert launched8 == direct and "inkernel_rdma" not in launched8, (launched8, direct)
    assert same_bits(torch, got, want8), "the int8 chain differs from apply_plan(compiled=True)"
    del got, want8
    torch.cuda.empty_cache()
    out["int8"] = {"plan": _plan_line(plan8), "events": events8, "elapsed_s": secs8,
                   "launches": launched8}
    log(f"faults chain bf16 {_plan_line(plan)}: {out['bf16']['events']} in "
        f"{out['bf16']['elapsed_s'][0]:.4f} s, {out['bf16']['launches']}, bit-equal to compiled; "
        f"timeout_s=1e-9: {events} in {secs_s[0]:.4f} s, same bits")
    log(f"faults chain int8 {_plan_line(plan8)}: {events8} in "
        f"{', '.join(f'{t:.4f}' for t in secs8)} s, launches {launched8} (apply_plan "
        "compiled=True: the same), bit-equal to it")
    wd = Watchdog(Tuner())
    scratch = x.clone()
    runs = {"inkernel": lambda: apply_plan(plan, scratch, inkernel=True),
            "compiled": lambda: apply_plan(plan, scratch, compiled=True),
            "unrolled": lambda: apply_plan(plan, scratch, compiled=False, inkernel=False),
            "xla": lambda: _one_shot_fallback(plan, scratch)}
    assert tuple(runs) == DEFAULT_CHAIN
    expected = wd.expected_s(plan)
    stages = {}
    for stage, fn in runs.items():
        ms = time_ms(torch, fn, reps=3, warmup=1)
        flagged = wd.observe(plan, ms / 1e3) is not None
        stages[stage] = {"ms": ms, "measured_over_expected": ms / 1e3 / expected,
                         "straggler": flagged}
    del scratch
    out["watchdog"] = {"expected_s": expected, "stages": stages,
                       "reports": len(wd.reports)}
    log(f"faults watchdog (H100_SXM prices the plan at {expected * 1e3:.3f} ms): " + ", ".join(
        f"{k} {v['ms']:.3f} ms = {v['measured_over_expected']:.2f}x"
        + (" (straggler, recorded)" if v["straggler"] else "") for k, v in stages.items()))
    return out


def faults_drain(torch) -> dict:
    """Phase 11d: phase 6's 1-layer minitron weights distributed from row 0
    to 4 emulated ranks with ``double_buffer=True`` and ``drain_dir=``,
    the stream replay's ``apply_plan`` raising on its second call (one
    bucket has landed, ``chunked_copy`` has run): ``WeightSyncError``
    chained to the cause, a checkpoint at step 0 whose tree is bit-equal to
    the pre-distribution row 0. The directory lives under ``build/`` and is
    removed."""
    from repro_torch import kernels
    from repro_torch.comm import WeightSyncError
    from repro_torch.comm import streams as comm_streams
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import distribute_weights, replicate
    from repro_torch.train import checkpoint as ckpt

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    stacked = replicate(Model(cfg).init(seed=0, device="cuda"), RANKS, fill_root_only=True)
    root = tree_map(lambda t: t[0].cpu(), stacked)
    real, calls = comm_streams.apply_plan, []

    def fail_second(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected: a rank lost mid-broadcast")
        return real(*args, **kw)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        before = kernels.launch_counts()
        comm_streams.apply_plan = fail_second
        t0 = time.perf_counter()
        try:
            distribute_weights(stacked, make_mesh(RANKS, device="cuda"), double_buffer=True,
                               drain_dir=d)
        except WeightSyncError as e:
            err = e
        else:
            raise AssertionError("the injected failure did not raise WeightSyncError")
        finally:
            comm_streams.apply_plan = real
        secs = time.perf_counter() - t0
        launched = _launched(torch, before)
        assert isinstance(err.__cause__, RuntimeError) and "drained" in str(err), err
        assert len(calls) == 2 and launched.get("chunked_copy", 0) > 0, (calls, launched)
        assert ckpt.latest_step(d) == 0, os.listdir(d)
        fname = os.path.join(d, "ckpt_00000000.npz")
        assert fname in str(err), err
        size = os.path.getsize(fname)
        back = ckpt.restore_checkpoint(d, 0, root)
        assert all(same_bits(torch, a, b) for a, b in zip(tree_leaves(back), tree_leaves(root))), \
            "the drained checkpoint differs from the pre-distribution row 0"
        del back
    del stacked, root
    log(f"faults drain: WeightSyncError after {secs:.2f} s (snapshot of row 0, one bucket, the "
        f"atomic save; launches {launched}), {size / 1e9:.3f} GB at step 0 restored bit for "
        f"bit; cause: {err.__cause__!r}")
    return {"s": secs, "bytes": size, "launches": launched}


def faults(torch, tuned: dict) -> dict:
    """Phase 11, the fault runtime: (a) degraded training, (b) degraded
    plans, (c) the resilient chain, (d) drain on failure. Launch counts are
    zeroed by the caller before this phase; the plain version launches no
    kernel."""
    from repro_torch.configs import get_config

    rec = {"train": faults_training(torch, tuned)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("minitron-8b")
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((RANKS, cfg.padded_vocab * cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    rec["plans"], want = faults_plans(torch, x)
    rec["chain"] = faults_chain(torch, x, want)
    del x, want
    gc.collect()
    torch.cuda.empty_cache()
    rec["drain"] = faults_drain(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def small_vlm_reference(torch) -> float:
    """paligemma-3b-smoke widened to head width 256 and a prefix of 256
    patches, in f32, at 256 patches + 3840 tokens (4096 positions): prefill
    and 2 decode steps on the card (prefill attention through the CUDA-core
    flash kernel at width 256, query tiles of 256 over the prefix) against
    the CPU (its plain version). Counts the launches since the caller's
    last zeroing."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("paligemma-3b-smoke"), dtype="float32",
                              kv_cache_dtype="float32", head_dim=256, prefix_len=256,
                              frontend_len=256)
    model = Model(cfg)
    cpu = model.init(seed=6, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    batch = next(batches(make_source(cfg, seed=6), cfg, batch=1, seq=VLM_TEXT))
    on_card = {key: t.cuda() for key, t in batch.items()}
    before = kernels.launch_counts()["flash_attention"]
    pos = cfg.prefix_len + VLM_TEXT
    errs = []
    with torch.no_grad():
        a, ca = model.prefill(cpu, batch, max_len=VLM_TEXT + 2)
        b, cb = model.prefill(gpu, on_card, max_len=VLM_TEXT + 2)
        errs.append(float((a - b.cpu()).abs().max()))
        nxt = torch.argmax(a[:, -1], dim=-1)[:, None]
        for i in range(2):
            a, ca = model.decode_step(cpu, nxt, ca, pos + i)
            b, cb = model.decode_step(gpu, nxt.cuda(), cb, pos + i)
            errs.append(float((a - b.cpu()).abs().max()))
            nxt = torch.argmax(a[:, 0], dim=-1)[:, None]
    launched = kernels.launch_counts()["flash_attention"] - before
    assert launched == cfg.num_layers, launched
    assert kernels.launch_counts()["flash_attention_sm90"] == 0, "f32 took the sm90 route"
    assert all(math.isfinite(e) and e < 1e-3 for e in errs), errs
    log(f"reference: paligemma-3b-smoke (head width 256, prefix 256) f32 at {cfg.prefix_len} "
        f"patches + {VLM_TEXT} tokens, card ({launched} flash_attention launches) vs CPU "
        f"(plain), max abs diff of prefill / decode logits {['%.3e' % e for e in errs]} "
        "(tol 1e-3)")
    return max(errs)


def serve_family(torch, arch: str, prompt: int, label: str, flash_per_pass: int, *,
                 layers: int | None = None, flash_note: str = "", after=None) -> dict:
    """Phase 12a (hymba-1.5b), 12b (xlstm-350m), 13a (whisper-large-v3) or
    13b (qwen1.5-32b, ``layers`` of its 64): the config at full width
    and depth (bf16 weights, their f32 leaves in f32, seeded random; an
    encoder-decoder's requests each one 30-second segment of stub frames
    from the port's ``batches``) distributed to 4 emulated ranks as phase 3 distributes
    (``Engine(distribute=True, double_buffer=True)``: each bucket staged
    through chunked_copy), replicas bit-equal to the weights; ``generate``
    of batch 4 (one ``prompt``-token request a rank) and 32 decode steps,
    the recurrent states carried in the stacked caches; the warm re-run
    timing prefill and decode apart; then, as phase 10 does, the weights
    broadcast again from NaN-filled replicas with the pinned pipelined
    chain and the compiled executor (fused_combine), replicas bit-equal to
    the root; then ``after(engine, tokens, embeds)``, whose dict joins the
    result; last one profiled prefill of rank 0, counted apart (its flash
    device ms printed beside ``flash_note``). Every prefill pass launches
    the sm90 flash kernel ``flash_per_pass`` times (hymba's: each layer's
    windowed attention at bf16 width 64; qwen's: each layer's at width 128)
    and the CUDA-core one never. Launch counts are zeroed by the caller right
    before; ``after`` reads them first."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine, distribute_weights

    assert not torch.backends.cuda.matmul.allow_tf32  # the f32 projections stay f32
    t_start = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = Model(cfg).init(seed=0, device="cuda")
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    replica_bytes = sum(t.numel() * t.element_size() for t in leaves)
    f32_bytes = sum(t.numel() * 4 for t in leaves if t.dtype == torch.float32)
    del leaves
    mesh = make_mesh(RANKS, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts["chunked_copy"] > 0, counts
    assert counts["flash_attention"] == counts["flash_attention_sm90"] == 0, counts
    assert replicas_equal(torch, engine.params, params), f"a {arch} replica differs"
    del params
    dist_peak = torch.cuda.max_memory_allocated()

    rng = np.random.RandomState(12)
    tokens = rng.randint(0, cfg.vocab_size - 1, size=(RANKS, prompt))
    embeds = None
    if cfg.arch_type == "encdec":
        embeds = next(batches(make_source(cfg, seed=13), cfg, batch=RANKS, seq=prompt,
                              device="cuda"))["embeds"]
        assert tuple(embeds.shape) == (RANKS, cfg.frontend_len, cfg.d_model)
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens, "embeds": embeds}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    cold = kernels.launch_counts()["flash_attention_sm90"]
    assert res.tokens.shape == (RANKS, STEPS) and res.logprobs.shape == (RANKS, STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    assert cold == flash_per_pass * RANKS, cold
    t_warm = time.perf_counter()
    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS, embeds)
    warm_s = time.perf_counter() - t_warm
    warm = kernels.launch_counts()["flash_attention_sm90"] - cold
    assert warm == flash_per_pass * RANKS, warm
    assert kernels.launch_counts()["flash_attention"] == 0, "a bf16 prefill took the " \
        "CUDA-core kernel"

    for leaf in tree_leaves(engine.params):
        leaf[1:].fill_(float("nan"))
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    distribute_weights(engine.params, mesh, algo="pipelined_chain", compiled=True,
                       double_buffer=True)
    torch.cuda.synchronize()
    compiled_s = time.perf_counter() - t0
    merges = kernels.launch_counts()["fused_combine"] - before["fused_combine"]
    assert merges > 0, merges
    assert replicas_equal(torch, engine.params), f"compiled {arch} replicas differ from the root"
    peak = torch.cuda.max_memory_allocated()  # the phase's, from the distribution on
    out = {
        "params": n_params, "replica_bytes": replica_bytes, "f32_bytes": f32_bytes,
        "layers": cfg.num_layers, "distribute_s": dist_s, "distribute_peak": dist_peak,
        "chunked_copy_launches": counts["chunked_copy"], "generate_s": gen_s,
        "prefill_ms_per_rank": prefill_s / RANKS * 1e3,
        "decode_tokens_per_s": RANKS * STEPS / decode_s, "max_memory_allocated": peak,
        "flash_attention_sm90_launches": {"cold": cold, "warm": warm},
        "compiled_distribute_s": compiled_s, "compiled_fused_combine_launches": merges,
        "first_tokens": res.tokens[:, :4].tolist(),
    }
    frames = "" if embeds is None else f" and {cfg.frontend_len} frames"
    enc = f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else ""
    log(f"{label}: {arch} {cfg.num_layers} of {get_config(arch).num_layers} layers{enc}, "
        f"{n_params} params "
        f"({replica_bytes / 1e9:.2f} GB a replica, {f32_bytes / 1e9:.2f} GB of it f32), "
        f"distribution {dist_s:.3f} s ({counts['chunked_copy']} chunked_copy launches, peak "
        f"{dist_peak / 2**30:.2f} GiB), generate {gen_s:.3f} s (cold, {RANKS} x {prompt} "
        f"tokens{frames} + {STEPS} steps); warm: prefill {out['prefill_ms_per_rank']:.2f} ms/rank, "
        f"decode steps {out['decode_tokens_per_s']:.1f} tok/s; flash_attention_sm90 launches "
        f"{cold} cold + {warm} warm, flash_attention 0; compiled pipelined chain from NaN "
        f"replicas {compiled_s:.3f} s ({merges} fused_combine launches), replicas bit-equal; "
        f"phase peak {peak / 2**30:.2f} GiB")
    out["counts"] = kernels.launch_counts()  # the path's; the profiled prefill comes after
    if after is not None:
        out.update(after(engine, tokens, embeds))
    t_prof = time.perf_counter()
    out["profile"] = profile_prefill(torch, engine, tokens, embeds=embeds, label=label, ranks=1)
    out["profile_s"] = time.perf_counter() - t_prof
    if flash_per_pass:
        log(f"{label}: flash device time of one profiled prefill "
            f"{out['profile'][0]['flash_ms']:.3f} ms ({flash_per_pass} launches of the sm90 "
            f"kernel){flash_note}")
    out["warm_s"], out["phase_s"] = warm_s, time.perf_counter() - t_start
    log(f"{label}: phase {out['phase_s']:.1f} s, of which generate {gen_s:.1f}, warm re-run "
        f"{warm_s:.1f}, profiled prefill {out['profile_s']:.1f}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cross_caches(torch, engine, tokens, embeds) -> dict:
    """Phase 13a's check of the caches, rank 0's request: one ``cross``
    key and value pair a decoder layer (stacked over the layers, one
    segment of frames each, in the compute dtype), the self-attention
    caches sized by the text alone (the frames take no position), and a
    decode step that hands back the same cross tensors (no copy a step)."""
    from repro_torch.core.tree import tree_leaves

    cfg = engine.cfg
    batch = _rank_batches(torch, tokens, embeds)[0]
    T = tokens.shape[1]
    shape = (cfg.frontend_len, cfg.num_kv_heads, cfg.head_dim)
    with torch.no_grad():
        logits, caches = engine.model.prefill(engine.replica(0), batch, max_len=T + STEPS)
        crosses = [c["cross"] for c in caches["blocks"] + caches["tail"]]
        pairs = sum(c["cross"]["k"].shape[0] for c in caches["blocks"]) + len(caches["tail"])
        assert pairs == cfg.num_layers, pairs
        for c in crosses:
            for t in (c["k"], c["v"]):
                assert tuple(t.shape[-3:]) == shape and t.dtype == torch.bfloat16, t.shape
        assert all(tuple(c["attn"]["k"].shape[-3:-2]) == (T + STEPS,) for c in caches["blocks"])
        ptrs = [t.data_ptr() for c in crosses for t in (c["k"], c["v"])]
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _lg, caches = engine.model.decode_step(engine.replica(0), nxt, caches, T)
        assert [t.data_ptr() for c in caches["blocks"] + caches["tail"]
                for t in (c["cross"]["k"], c["cross"]["v"])] == ptrs, "decode copied the cross K/V"
    cross_bytes = sum(t.numel() * t.element_size() for c in crosses for t in (c["k"], c["v"]))
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(caches))
    log(f"serve encdec caches: {pairs} cross K/V pairs (one a decoder layer, "
        f"{cfg.frontend_len} frames x {cfg.num_kv_heads} x {cfg.head_dim} bf16 each), "
        f"{cross_bytes / 1e6:.1f} MB of the request's {cache_bytes / 1e6:.1f} MB of caches; "
        f"self-attention caches of {T + STEPS} slots; decode hands back the same tensors")
    return {"cross_pairs": pairs, "cross_bytes": cross_bytes, "cache_bytes": cache_bytes}


def f8_decode(torch, engine, tokens, _embeds) -> dict:
    """Phase 13b's narrow-cache decode, rank 0's request on its replica:
    prefill and ``STEPS`` greedy decode steps at ``max_len`` F8_MAX_LEN with
    ``kv_cache_dtype='float8_e5m2'`` (the reference's dry-run override),
    every step of every layer through ``_decode_sdpa_headblocked`` (counted),
    then the same with a bf16 cache; each run's peak GiB (and the decode
    steps' own rise over the memory held before them), decode ms a step,
    finite log-probs <= 0 and tokens in the vocab. Then at layer 0's real
    f8 cache one decode query (seeded, bf16) through the head-blocked
    softmax against ``_sdpa`` over the whole cache cast to bf16: within one
    bf16 step, 2^-7 |sdpa| + 1e-5; each call timed (CUDA events) with the
    memory it adds."""
    import numpy as np

    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import Model
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L

    assert F8_MAX_LEN >= L.HEADBLOCKED_MIN_S
    params = engine.replica(0)
    batch = {"tokens": torch.as_tensor(tokens[:1], device="cuda")}
    T = tokens.shape[1]
    inner, calls = L._decode_sdpa_headblocked, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    runs, keep = {}, None
    for kv in ("float8_e5m2", "bfloat16"):
        cfg = dataclasses.replace(engine.cfg, kv_cache_dtype=kv)
        model = Model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        L._decode_sdpa_headblocked = counted
        try:
            with torch.no_grad():
                logits, caches = model.prefill(params, batch, max_len=F8_MAX_LEN)
                cur = logits[:, -1]
                del logits
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                prefill_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                calls[0] = 0
                toks, lps = [], []
                t0 = time.perf_counter()
                for i in range(STEPS):
                    nxt = torch.argmax(cur, dim=-1)
                    lps.append(torch.log_softmax(cur, dim=-1).gather(1, nxt[:, None])[:, 0])
                    toks.append(nxt)
                    logits, caches = model.decode_step(params, nxt[:, None], caches, T + i)
                    cur = logits[:, 0]
                torch.cuda.synchronize()
                decode_s = time.perf_counter() - t0
        finally:
            L._decode_sdpa_headblocked = inner
        decode_peak = torch.cuda.max_memory_allocated()
        toks = torch.stack(toks, dim=1).cpu().numpy()
        lps = torch.stack(lps, dim=1).float().cpu().numpy()
        assert ((toks >= 0) & (toks < cfg.padded_vocab)).all()
        assert np.isfinite(lps).all() and (lps <= 0).all()
        attn = caches["blocks"][0]["attn"]
        assert attn["k"].dtype == getattr(torch, kv) and attn["k"].shape[2] == F8_MAX_LEN
        want_calls = STEPS * cfg.num_layers if kv == "float8_e5m2" else 0
        assert calls[0] == want_calls, (kv, calls[0], want_calls)
        runs[kv] = {"peak": max(prefill_peak, decode_peak), "decode_rise": decode_peak - held,
                    "cache_bytes": sum(t.numel() * t.element_size()
                                       for t in tree_leaves(caches)),
                    "decode_ms_per_step": decode_s / STEPS * 1e3, "headblocked_calls": calls[0],
                    "first_tokens": toks[0, :4].tolist()}
        if kv == "float8_e5m2":
            keep = {key: attn[key][0] for key in ("k", "v", "pos")}
        del caches, cur, attn

    cfg = engine.cfg
    spec = B.attn_spec_for(cfg, None)
    gen = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((1, 1, cfg.num_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    mask = (keep["pos"] >= 0)[None, None, :]
    k, v = keep["k"], keep["v"]
    calls_mem = {}
    for name, fn in (("headblocked", lambda: L._decode_sdpa_headblocked(q, k, v, mask, spec)),
                     ("sdpa_cast", lambda: L._sdpa(q, k.to(q.dtype), v.to(q.dtype), mask, spec))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        calls_mem[name] = {"adds_bytes": torch.cuda.max_memory_allocated() - base,
                           "ms": time_ms(torch, fn, reps=20)}
    got, want = L._decode_sdpa_headblocked(q, k, v, mask, spec), L._sdpa(
        q, k.to(q.dtype), v.to(q.dtype), mask, spec)
    lim = 2.0**-7 * want.float().abs() + 1e-5
    share = float(((got.float() - want.float()).abs() / lim).max())
    same = float((bits(torch, got) == bits(torch, want)).float().mean())
    assert share <= 1.0, share
    f8, b16 = runs["float8_e5m2"], runs["bfloat16"]
    log(f"serve mha f8 decode: rank 0, prefill {T} tokens then {STEPS} steps at max_len "
        f"{F8_MAX_LEN}: f8 cache {f8['cache_bytes'] / 1e9:.3f} GB, peak "
        f"{f8['peak'] / 2**30:.2f} GiB, decode rise {f8['decode_rise'] / 2**20:.1f} MiB, "
        f"{f8['decode_ms_per_step']:.2f} ms a step, {f8['headblocked_calls']} head-blocked "
        f"calls ({STEPS} steps x {cfg.num_layers} layers); bf16 cache "
        f"{b16['cache_bytes'] / 1e9:.3f} GB, peak {b16['peak'] / 2**30:.2f} GiB, decode rise "
        f"{b16['decode_rise'] / 2**20:.1f} MiB, {b16['decode_ms_per_step']:.2f} ms a step; "
        f"log-probs finite <= 0, tokens in the vocab")
    hb = min(8, cfg.num_kv_heads)  # _decode_sdpa_headblocked's block of kv heads
    while cfg.num_kv_heads % hb:
        hb -= 1
    log(f"serve mha head-blocked check, layer 0's f8 cache ({int(mask.sum())} of {F8_MAX_LEN} "
        f"slots, {cfg.num_kv_heads} kv heads in blocks of {hb}): against _sdpa over the cache "
        f"cast to bf16 {share:.3f} of the limit 2^-7 |sdpa| + 1e-5 ({same:.1%} bit-equal); "
        f"head-blocked {calls_mem['headblocked']['ms']:.4f} ms adding "
        f"{calls_mem['headblocked']['adds_bytes'] / 2**20:.1f} MiB, cast + _sdpa "
        f"{calls_mem['sdpa_cast']['ms']:.4f} ms adding "
        f"{calls_mem['sdpa_cast']['adds_bytes'] / 2**20:.1f} MiB")
    return {"f8_decode": runs, "headblocked_check": {"share_of_limit": share,
                                                     "bit_equal_share": same, **calls_mem}}


def encdec_mha_smoke_reference(torch) -> float:
    """whisper-large-v3-smoke (16 stub frames from ``batches``) and
    qwen1.5-32b-smoke, with its MHA variant (2 query and 2 kv heads), in
    f32 with seeded nonzero QKV biases: prefill of 24 tokens and 2 decode
    steps on the card against the CPU, logits within 1e-3 as phase 5 holds
    the other smoke configs."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.models import Model

    errs = {}
    variants = (("whisper-large-v3", {}), ("qwen1.5-32b", {}), ("qwen1.5-32b", {"num_heads": 2}))
    for i, (arch, extra) in enumerate(variants):
        cfg = dataclasses.replace(get_config(f"{arch}-smoke"), dtype="float32",
                                  kv_cache_dtype="float32", **extra)
        model = Model(cfg)
        cpu = model.init(seed=40 + i, device="cpu")
        gen = torch.Generator().manual_seed(40 + i)
        for path, t in zip(tree_paths(cpu), tree_leaves(cpu)):
            if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
        gpu = tree_map(lambda t: t.cuda(), cpu)
        batch = next(batches(make_source(cfg, seed=40 + i), cfg, batch=2, seq=24))
        batch.pop("labels")
        on_card = {key: t.cuda() for key, t in batch.items()}
        e = []
        with torch.no_grad():
            a, ca = model.prefill(cpu, batch, max_len=26)
            b, cb = model.prefill(gpu, on_card, max_len=26)
            e.append(float((a - b.cpu()).abs().max()))
            nxt = torch.argmax(a[:, -1], dim=-1)[:, None]
            for s in range(2):
                a, ca = model.decode_step(cpu, nxt, ca, 24 + s)
                b, cb = model.decode_step(gpu, nxt.cuda(), cb, 24 + s)
                e.append(float((a - b.cpu()).abs().max()))
                nxt = torch.argmax(a[:, 0], dim=-1)[:, None]
        assert all(math.isfinite(v) and v < 1e-3 for v in e), (cfg.name, extra, e)
        errs[f"{cfg.name}{'-mha' if extra else ''}"] = max(e)
    log(f"reference: encoder-decoder and MHA smoke configs f32 (nonzero QKV biases), card vs "
        f"CPU, max abs diff of prefill / decode logits "
        f"{({k: '%.3e' % v for k, v in errs.items()})} (tol 1e-3)")
    return max(errs.values())


def family_smoke_reference(torch) -> float:
    """hymba-1.5b-smoke and xlstm-350m-smoke in f32: prefill of 80 tokens
    (past hymba-smoke's window of 64; 5 chunks of 16) and 2 decode steps on
    the card against the CPU, logits within 1e-3 as phase 5 holds the other
    smoke configs."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model

    errs = {}
    for i, arch in enumerate(("hymba-1.5b", "xlstm-350m")):
        cfg = dataclasses.replace(get_config(f"{arch}-smoke"), dtype="float32",
                                  kv_cache_dtype="float32")
        model = Model(cfg)
        cpu = model.init(seed=30 + i, device="cpu")
        gpu = tree_map(lambda t: t.cuda(), cpu)
        tokens = torch.randint(0, cfg.vocab_size, (2, 80),
                               generator=torch.Generator().manual_seed(30 + i))
        e = []
        with torch.no_grad():
            a, ca = model.prefill(cpu, {"tokens": tokens}, max_len=82)
            b, cb = model.prefill(gpu, {"tokens": tokens.cuda()}, max_len=82)
            e.append(float((a - b.cpu()).abs().max()))
            nxt = torch.argmax(a[:, -1], dim=-1)[:, None]
            for s in range(2):
                a, ca = model.decode_step(cpu, nxt, ca, 80 + s)
                b, cb = model.decode_step(gpu, nxt.cuda(), cb, 80 + s)
                e.append(float((a - b.cpu()).abs().max()))
                nxt = torch.argmax(a[:, 0], dim=-1)[:, None]
        assert all(math.isfinite(v) and v < 1e-3 for v in e), (arch, e)
        errs[arch] = max(e)
    log(f"reference: recurrent and hybrid smoke configs f32, card vs CPU, max abs diff of "
        f"prefill / decode logits {({k: '%.3e' % v for k, v in errs.items()})} (tol 1e-3)")
    return max(errs.values())


def _level_plan_line(ax: str, plan) -> str:
    return (f"{ax}: {plan.n} ranks, inter_pod {plan.inter_pod}, {plan.algo} K={plan.num_chunks}, "
            f"predicted {plan.predicted_s * 1e3:.3f} ms, wire {plan.wire_bytes()} B")


def _rows_equal(torch, a, b) -> bool:
    """``a`` and ``b`` bit-equal, compared a rank row at a time (a whole
    8-rank comparison would hold one bool a byte of the buffer)."""
    return a.shape == b.shape and all(same_bits(torch, a[r], b[r]) for r in range(a.shape[0]))


def _levels_replayed(torch, x, mesh, plans: dict, replay) -> tuple:
    """``x`` through each level of ``plans`` (``{axis: plan}`` in level
    order), every group of ranks along the axis replayed by ``replay(plan,
    frame)`` (``comm.api.level_replay``); each level's ms by CUDA events.
    Returns the result and the ms by axis."""
    import functools

    from repro_torch.comm import level_replay

    ms = {}
    for ax, plan in plans.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        x = level_replay(x, ax, functools.partial(replay, plan), mesh=mesh)
        end.record()
        end.synchronize()
        ms[ax] = start.elapsed_time(end)
    return x, ms


def hierarchical_collectives(torch) -> dict:
    """Phase 14a: the two-level collectives on a ('pod', 'data') mesh of
    POD_MESH ranks at HIER_ELEMS bf16 elements a rank (phase 7's embedding
    bucket: 16.8 GB over the 8 ranks), each entry point compiled and
    in-kernel: ``hierarchical_bcast``
    (the pod level first), ``pallreduce_tree`` and ``overlap_allreduce_tree``
    over ``hierarchical_allreduce_axes`` (the pod level last, priced
    inter-pod). Each result bit-equal to the plain replay of the same
    per-level plans (every group of every level through
    ``rdma_replay_plain``, which launches nothing), so compiled and
    in-kernel are bit-equal to each other; each level replayed again alone
    and timed by CUDA events; the strided level's gather and scatter copies
    timed apart (each group's rows gathered, and scattered back). Then the
    broadcast on the (1, 8) and (8, 1) meshes and as
    one 8-rank ('data',) axis, each bit-equal to the root's row."""
    import functools

    from repro_torch import comm, kernels
    from repro_torch.comm import apply_plan, plan_cached, plan_overlap
    from repro_torch.core.bcast import hierarchical_bcast
    from repro_torch.dist import topology
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(POD_MESH, axis_names=("pod", "data"), device="cuda")
    n, M = mesh.size, HIER_ELEMS * 2
    sizes = topology.axis_sizes(mesh)
    gen = torch.Generator(device="cuda")

    def fresh():
        return torch.randn((n, HIER_ELEMS), generator=gen.manual_seed(14), device="cuda",
                           dtype=torch.bfloat16)

    down, up = topology.bcast_axes(mesh), comm.hierarchical_allreduce_axes(mesh)
    inter = topology.INTER_POD_AXES
    overlap = plan_overlap({"embed": torch.empty((HIER_ELEMS,), dtype=torch.bfloat16,
                                                 device="meta")},
                           [(ax, sizes[ax]) for ax in up], inter_pod_axes=inter)
    ops = {
        "hierarchical_bcast": (
            {ax: plan_cached("bcast", M, sizes[ax], inter_pod=ax in inter) for ax in down},
            lambda x, **ex: hierarchical_bcast(x, mesh=mesh, **ex)),
        "pallreduce_tree": (
            {ax: plan_cached("allreduce", M, sizes[ax], inter_pod=ax in inter) for ax in up},
            lambda x, **ex: comm.pallreduce_tree({"embed": x}, up, inter_pod_axes=inter,
                                                 mesh=mesh, **ex)["embed"]),
        "overlap_allreduce_tree": (
            {ax: overlap.plans[ax][0] for ax in up},
            lambda x, **ex: comm.overlap_allreduce_tree({"embed": x}, up, inter_pod_axes=inter,
                                                        mesh=mesh, **ex)["embed"]),
    }
    out = {}
    for name, (plans, entry) in ops.items():
        for ax, plan in plans.items():
            log(f"hierarchical {name} plan {_level_plan_line(ax, plan)}")
        t0 = time.perf_counter()
        want, _ = _levels_replayed(torch, fresh(), mesh, plans,
                                   lambda plan, f: _plain_collective(torch, plan, f))
        plain_s = time.perf_counter() - t0
        rec = {"plans": {ax: {"ranks": p.n, "inter_pod": p.inter_pod, "algo": p.algo,
                              "chunks": p.num_chunks, "predicted_s": p.predicted_s,
                              "wire_bytes": p.wire_bytes()} for ax, p in plans.items()},
               "plain_s": plain_s}
        for flag in ("compiled", "inkernel"):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = entry(fresh(), **{flag: True})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = kernels.launch_counts()
            launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            assert _rows_equal(torch, got, want), f"{name} {flag}: differs from the plain replay"
            del got
            if flag == "inkernel":
                assert set(launched) == {"inkernel_rdma"}, (name, launched)
            else:
                assert "inkernel_rdma" not in launched and launched["fused_combine"] > 0, \
                    (name, launched)
            replay = functools.partial(apply_plan, **{flag: True})
            got, ms = _levels_replayed(torch, fresh(), mesh, plans,
                                       lambda plan, f, r=replay: r(plan, f))
            assert _rows_equal(torch, got, want), f"{name} {flag}: a level replay differs"
            del got
            rec[flag] = {"s": secs, "launches": launched, "level_ms": ms}
            log(f"hierarchical {name} {flag}: {secs:.4f} s ({launched}), levels "
                f"{ {ax: round(v, 3) for ax, v in ms.items()} } ms (CUDA events); bit-equal "
                f"to the plain per-level replay ({plain_s:.4f} s)")
        del want
        torch.cuda.empty_cache()
        out[name] = rec
    # the strided (pod) level's copies: each group's rows gathered into a
    # contiguous frame, and scattered back, as level_replay makes them
    x = fresh()
    view = x.view(POD_MESH[0], POD_MESH[1], -1)
    frames = [view[:, d].contiguous() for d in range(POD_MESH[1])]
    gather_ms = time_ms(torch, lambda: [f.copy_(view[:, d]) for d, f in enumerate(frames)],
                        reps=5, warmup=1)
    scatter_ms = time_ms(torch, lambda: [view[:, d].copy_(f) for d, f in enumerate(frames)],
                         reps=5, warmup=1)
    copy_bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
    del x, view, frames
    out["strided_copies"] = {"gather_ms": gather_ms, "scatter_ms": scatter_ms,
                             "bound_ms": copy_bound}
    log(f"hierarchical strided level: the {POD_MESH[1]} groups' gathers {gather_ms:.3f} ms + "
        f"scatters back {scatter_ms:.3f} ms over the {n} x {HIER_ELEMS} bf16 buffer (bound "
        f"{copy_bound:.3f} ms each, bytes read and written / 3.35 TB/s), once a pod level")
    # the degenerate meshes and one 8-rank axis: the root's row everywhere
    root = fresh()[0].clone()
    degenerate = {}
    for shape in ((8,), (1, 8), (8, 1)):
        m = make_mesh(shape, axis_names=("data",) if len(shape) == 1 else ("pod", "data"),
                      device="cuda")
        t0 = time.perf_counter()
        got = (comm.pbcast(fresh(), compiled=True) if len(shape) == 1
               else hierarchical_bcast(fresh(), mesh=m, compiled=True))
        torch.cuda.synchronize()
        degenerate["x".join(map(str, shape))] = time.perf_counter() - t0
        assert all(same_bits(torch, got[r], root) for r in range(n)), shape
        del got
    del root
    torch.cuda.empty_cache()
    out["degenerate_s"] = degenerate
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"hierarchical degenerate: the broadcast on (1, 8), (8, 1) and one 8-rank axis, each "
        f"bit-equal to the root's row (s: { {k: round(v, 4) for k, v in degenerate.items()} }); "
        f"phase peak {out['max_memory_allocated'] / 2**30:.2f} GiB")
    return out


def hierarchical_training(torch, training: dict) -> dict:
    """Phase 14b: phase 6's minitron-8b (TRAIN_LAYERS layer, 8 x 512 tokens,
    3 steps) on a (2, 2) ('pod', 'data') mesh, the same 4 ranks, in the
    HIER_TRAIN_MODES, every run comparing its synced rows: zero rows differ
    on the bf16 wire; each run's last loss and grad norms within phase 6's
    limits of phase 6's one-axis run of the same mode (``training``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    mesh = make_mesh((2, 2), axis_names=("pod", "data"), device="cuda")
    out = {}
    for label in HIER_TRAIN_MODES:
        params, r = train_mode(torch, cfg, mesh, dict(TRAIN_MODES)[label], check_rows=True)
        del params
        one = training.get(label + "+check_rows", training[label])
        d_loss, d_norm = _deviation(r, one)
        int8 = label == "compressed_int8"
        if int8:
            assert d_loss <= 5e-3, (label, r["losses"], one["losses"])
        else:
            assert not any(r["grad_rows_differ"]), (label, r["grad_rows_differ"])
            assert d_loss <= 1e-3 and d_norm <= 2e-4, (label, r, one)
        out[label] = r
        log(f"hierarchical train {label}: losses {['%.4f' % x for x in r['losses']]}, step "
            f"{r['step_s']:.3f} s beside the one-axis {one['step_s']:.3f} s, peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB beside "
            f"{one['max_memory_allocated'] / 2**30:.2f} GiB, rows differ "
            f"{r['grad_rows_differ']}, last loss {d_loss:.3e} from the one-axis run "
            f"(bound {'5e-3' if int8 else '1e-3'}), grad norms {d_norm:.3e} relative"
            + ("" if int8 else " (bound 2e-4)") + f", launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    return out


def hierarchical_serving(torch, phase3: dict) -> dict:
    """Phase 14c: phase 3's minitron-8b (LAYERS layers) on a (2, 2) ('pod',
    'data') mesh: the staged distribution of ``Engine(distribute=True,
    double_buffer=True)`` and the compiled pipelined chain from NaN-filled
    replicas, each planned pod level first with every replica bit-equal to
    the loaded weights; one generate and a warm prefill and decode."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine, distribute_weights

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    mesh = make_mesh((2, 2), axis_names=("pod", "data"), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    assert replicas_equal(torch, engine.params, params), "a staged replica differs"
    stacked = engine.params
    for leaf in tree_leaves(stacked):
        leaf[1:].fill_(float("nan"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, plans = distribute_weights(stacked, mesh, algo="pipelined_chain", compiled=True,
                                  double_buffer=True, return_plans=True)
    torch.cuda.synchronize()
    compiled_s = time.perf_counter() - t0
    assert list(plans) == ["pod", "data"], list(plans)
    assert replicas_equal(torch, stacked, params), "a compiled replica differs"
    del params
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size - 1, size=(BATCH, PROMPT))
    res = engine.generate({"tokens": tokens}, steps=STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS)
    peak = torch.cuda.max_memory_allocated()
    del engine, stacked
    out = {"staged_s": staged_s, "compiled_s": compiled_s, "phase3_s": phase3["distribute_s"],
           "prefill_ms_per_rank": prefill_s / RANKS * 1e3,
           "decode_tokens_per_s": BATCH * STEPS / decode_s, "max_memory_allocated": peak,
           "plans": {ax: [p.algo for p in ps] for ax, ps in plans.items()}}
    log(f"hierarchical serve: (2, 2) mesh, staged distribution {staged_s:.3f} s and compiled "
        f"pipelined chain {compiled_s:.3f} s (pod level first, replicas bit-equal) beside phase "
        f"3's one-axis {phase3['distribute_s']:.3f} s; warm prefill "
        f"{out['prefill_ms_per_rank']:.2f} ms/rank, decode {out['decode_tokens_per_s']:.1f} "
        f"tok/s; peak {peak / 2**30:.2f} GiB")
    return out


def hierarchical_smoke(torch) -> float:
    """Phase 14d: minitron-8b-smoke in f32 under tuned_allreduce on a (2, 2)
    ('pod', 'data') mesh, 2 steps on the card and on the CPU from one
    initial state, losses within 1e-4."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("minitron-8b-smoke"), dtype="float32")
    run = RunConfig(sync_mode="tuned_allreduce", compiled_collectives=True, **TRAIN_RUN)
    losses = {}
    with tempfile.TemporaryDirectory() as d:
        for dev in ("cpu", "cuda"):
            tr = Trainer(cfg, run, mesh=make_mesh((2, 2), axis_names=("pod", "data"),
                                                  device=dev), ckpt_dir=d, device=dev)
            if dev == "cpu":
                params, opt = tr.init_state()
                checkpoint.save_checkpoint(d, 0, params)
                checkpoint.save_checkpoint(os.path.join(d, "opt"), 0, opt)
            losses[dev] = [h["loss"] for h in tr.train(batch=8, seq=32, steps=2,
                                                       log_every=1)[2]]
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    assert len(losses["cuda"]) == 2 and err <= 1e-4, (losses, err)
    log(f"hierarchical smoke: minitron-8b-smoke f32 tuned_allreduce on (2, 2), card vs CPU, "
        f"max abs loss diff {err:.3e} (tol 1e-4)")
    return err


def hierarchical(torch, training: dict, phase3: dict) -> dict:
    """Phase 14, the hierarchical mesh: 14a to 14d."""
    out = {"collectives": hierarchical_collectives(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    out["training"] = hierarchical_training(torch, training)
    gc.collect()
    torch.cuda.empty_cache()
    out["serving"] = hierarchical_serving(torch, phase3)
    gc.collect()
    torch.cuda.empty_cache()
    out["smoke_err"] = hierarchical_smoke(torch)
    return out


def _tp_mesh(dev: str = "cuda"):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(TP_MESH, axis_names=("data", "model"), device=dev)


def _shards_equal(torch, stacked, params, specs, mesh) -> bool:
    """Every rank's row of every leaf bit-equal to the block of the loaded
    leaf that its spec names."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.sharding import is_spec, shard_slices

    for leaf, full, spec in zip(tree_leaves(stacked), tree_leaves(params),
                                tree_leaves(specs, is_spec), strict=True):
        for r in range(mesh.size):
            if not same_bits(torch, leaf[r], full[shard_slices(spec, tuple(full.shape), mesh,
                                                                r)]):
                return False
    return True


def tp_distribution(torch, phase3: dict) -> tuple[dict, object, object]:
    """Phase 15a: phase 3's minitron-8b (LAYERS layers) on a (2, 2) ('data',
    'model') mesh: the staged distribution of ``Engine(distribute=True,
    double_buffer=True)`` and the compiled pipelined chain, both with
    ``specs=`` (the TP serving layout), every rank's row bit-equal to its
    block of the loaded weights; host-clock s beside phase 3's, the peak
    during each and the memory held after the cut; then the strided data
    level's gather and scatter copies at the largest bucket (the embedding),
    timed as phase 14a times the pod level's. Returns the numbers, the
    staged engine and the loaded weights."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import Model
    from repro_torch.serve import Engine, distribute_weights, replicate
    from repro_torch.serve.engine import rank_rows

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    mesh = _tp_mesh()
    specs = param_specs(Model(cfg).param_shapes(), mesh, fsdp=False, attn_fallback="head_dim")
    root_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    staged_peak = torch.cuda.max_memory_allocated() / 2**30
    held = torch.cuda.memory_allocated() / 2**30
    assert _shards_equal(torch, engine.params, params, specs, mesh), "a staged shard differs"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, plans = distribute_weights(
        replicate(params, mesh.size, fill_root_only=True, roots=rank_rows(mesh)[0]), mesh,
        specs=specs, algo="pipelined_chain", compiled=True, double_buffer=True,
        return_plans=True)
    torch.cuda.synchronize()
    compiled_s = time.perf_counter() - t0
    compiled_peak = torch.cuda.max_memory_allocated() / 2**30
    assert list(plans) == ["data"], list(plans)
    assert _shards_equal(torch, out, params, specs, mesh), "a compiled shard differs"
    del out
    torch.cuda.empty_cache()
    # the strided data level's copies: each group (rows m, m + 2) gathered
    # into a contiguous frame, and scattered back, as level_replay makes them
    E = cfg.padded_vocab * cfg.d_model
    x = torch.empty((mesh.size, E), dtype=torch.bfloat16, device="cuda")
    view = x.view(TP_MESH[0], TP_MESH[1], -1)
    frames = [view[:, m].contiguous() for m in range(TP_MESH[1])]
    gather_ms = time_ms(torch, lambda: [f.copy_(view[:, m]) for m, f in enumerate(frames)],
                        reps=5, warmup=1)
    scatter_ms = time_ms(torch, lambda: [view[:, m].copy_(f) for m, f in enumerate(frames)],
                         reps=5, warmup=1)
    copy_bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
    del x, view, frames
    torch.cuda.empty_cache()
    out = {"staged_s": staged_s, "compiled_s": compiled_s, "phase3_s": phase3["distribute_s"],
           "plans": {ax: [p.algo for p in ps] for ax, ps in plans.items()},
           "root_gib": root_gib, "staged_peak_gib": staged_peak,
           "compiled_peak_gib": compiled_peak, "held_after_cut_gib": held,
           "strided_gather_ms": gather_ms, "strided_scatter_ms": scatter_ms,
           "strided_bound_ms": copy_bound}
    log(f"serve tp distribution: (2, 2) ('data', 'model'), staged {staged_s:.3f} s and "
        f"compiled pipelined chain {compiled_s:.3f} s (data level, {len(plans['data'])} "
        f"bucket plans), each cut to the TP specs with every shard bit-equal, beside phase "
        f"3's one-axis {phase3['distribute_s']:.3f} s; peak {staged_peak:.2f} GiB staged, "
        f"{compiled_peak:.2f} compiled; held after the cut {held:.2f} GiB (the loaded "
        f"weights {root_gib:.2f} of it); strided data level at the embedding bucket: "
        f"gathers {gather_ms:.3f} ms + scatters {scatter_ms:.3f} ms (bound {copy_bound:.3f} "
        f"ms each, bytes read and written / 3.35 TB/s)")
    return out, engine, params


def _logit_diff(got, want) -> tuple[float, float, float]:
    """Max abs difference, its largest ratio to TP_REL |ref| + TP_ABS and
    the share of logits beyond that limit."""
    err = (got - want).abs()
    ratio = err / (TP_REL * want.abs() + TP_ABS)
    return float(err.max()), float(ratio.max()), float((ratio > 1).float().mean())


def tp_serving(torch, engine, phase3: dict) -> tuple[dict, object, object]:
    """Phase 15b, the TP engine's own runs: it serves batch BATCH (BATCH / 2
    a data rank), prompt PROMPT, STEPS decode steps (tokens in the vocab,
    log-probs finite and at most 0); the warm prefill ms a data rank and
    decode tok/s beside phase 3's. Returns the numbers, the prompts and the
    greedy tokens, which :func:`tp_against_one_axis` holds afterwards."""
    import numpy as np

    cfg = engine.cfg
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size - 1, size=(BATCH, PROMPT))
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    assert res.tokens.shape == (BATCH, STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS)
    out = {"generate_s": gen_s, "prefill_ms_per_data_rank": prefill_s / engine.n * 1e3,
           "decode_tokens_per_s": BATCH * STEPS / decode_s,
           "phase3_prefill_ms_per_rank": phase3["prefill_ms_per_rank"],
           "phase3_decode_tokens_per_s": phase3["decode_tokens_per_s"]}
    log(f"serve tp: batch {BATCH} ({BATCH // engine.n} a data rank), generate {gen_s:.3f} s "
        f"(cold); warm prefill {out['prefill_ms_per_data_rank']:.2f} ms a data rank, decode "
        f"{out['decode_tokens_per_s']:.1f} tok/s, beside phase 3's "
        f"{phase3['prefill_ms_per_rank']:.2f} ms a rank (1 request) and "
        f"{phase3['decode_tokens_per_s']:.1f} tok/s")
    return out, tokens, res.tokens


def tp_against_one_axis(torch, engine, params, tokens, tp_tokens) -> dict:
    """Phase 15b's references, run after the ``serve_tp`` path's counts are
    read: the TP engine's greedy tokens and each data rank's prefill logits
    beside the one-axis engine's on the same weights (the loaded tree,
    served as one replica).

    The model axis's partial sums round each partial to bf16 before they
    are added, so the TP engine's bits differ from the one-axis engine's,
    and a bf16 model of random weights 8 layers deep carries such a
    difference to its logits at far more than one rounding (TP_REL |ref| +
    TP_ABS): the one-axis engine's own logits move that far when one
    element of one weight moves by one bf16 step. That move is the control:
    the TP logits' largest ratio to the limit and their share over it are
    held within TP_RATIO_MULT and TP_SHARE_MULT of the control's. Held
    besides: every layer, fed the one-axis hidden state, against the layer
    in f32 as accurate as the one-axis layer but for one bf16 rounding
    (:func:`_layer_check`); and the same weights in f32 (TF32 off), TP
    against one-axis end to end, logits within 1e-3."""
    from repro_torch.core.tree import tree_map
    from repro_torch.serve import Engine

    cfg = engine.cfg
    one = Engine(cfg, params)  # the one-axis engine: one replica, the loaded tree itself
    ref = one.generate({"tokens": tokens}, steps=STEPS)
    agree = int((tp_tokens == ref.tokens).sum())
    batches = _rank_batches(torch, tokens, ranks=engine.n)
    bf16, moved = [], None
    with torch.no_grad():
        for d, batch in enumerate(batches):
            want = one.prefill(one.replica(0), batch, max_len=PROMPT + STEPS)[0]
            got = engine.prefill(engine.replica(d), batch, max_len=PROMPT + STEPS)[0]
            assert bool(torch.isfinite(got).all())
            bf16.append(_logit_diff(got, want))
            if d == 0:  # the control: one element of layer 0's w_down one bf16 step up
                w = params["decoder"]["blocks"][0]["mlp"]["w_down"].view(-1)
                keep = w[12345].clone()
                w[12345] = keep * (1 + 2.0**-7)
                moved = _logit_diff(one.prefill(one.replica(0), batch,
                                                max_len=PROMPT + STEPS)[0], want)
                w[12345] = keep
            del got, want
        layer_ratio, mean_ratio, _ = _layer_check(torch, engine, one, batches[0])
    assert layer_ratio <= 1.0, f"a TP layer lies off the f32 layer: {layer_ratio}"
    worst = max(bf16, key=lambda r: r[1])
    share = max(r[2] for r in bf16)
    assert worst[1] <= TP_RATIO_MULT * moved[1] and share <= TP_SHARE_MULT * moved[2], \
        ("the bf16 TP logits lie farther from the one-axis engine's than the control allows",
         worst, share, moved)
    del one
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    one32, tp32 = Engine(cfg32, p32), Engine(cfg32, p32, mesh=engine.mesh)
    del p32
    f32_err = 0.0
    with torch.no_grad():
        for d, batch in enumerate(batches):
            want = one32.prefill(one32.replica(0), batch, max_len=PROMPT)[0]
            got = tp32.prefill(tp32.replica(d), batch, max_len=PROMPT)[0]
            f32_err = max(f32_err, float((got - want).abs().max()))
            del got, want
    del one32, tp32
    torch.cuda.empty_cache()
    assert f32_err <= 1e-3, f"f32 TP logits off the one-axis engine's: {f32_err}"
    out = {"bf16_logits": {"max_abs_err": worst[0], "limit_ratio": worst[1],
                           "share_over_limit": share},
           "one_ulp_weight_logits": {"max_abs_err": moved[0], "limit_ratio": moved[1],
                                     "share_over_limit": moved[2]},
           "layer_limit_ratio": layer_ratio, "layer_mean_err_ratio": mean_ratio,
           "f32_logits_max_abs_err": f32_err, "tokens_agree": agree, "tokens": BATCH * STEPS}
    log(f"serve tp logits: greedy tokens agree {agree} / {BATCH * STEPS} with the one-axis "
        f"engine's; every layer fed the one-axis state, against the layer in f32: "
        f"the TP layer's largest error within {layer_ratio:.3f} of the one-axis layer's plus "
        f"one bf16 rounding (2^-8) of its largest output, its mean error at most "
        f"{mean_ratio:.3f} x the one-axis layer's; f32 weights end to end max abs diff "
        f"{f32_err:.3e} (tol 1e-3); bf16 end to end max abs diff {worst[0]:.4f}, "
        f"{worst[1]:.2f} x the limit, {share:.2%} of logits over it, beside the control (one "
        f"weight element one bf16 step up in the one-axis engine): {moved[0]:.4f}, "
        f"{moved[1]:.2f} x, {moved[2]:.2%} (held within {TP_RATIO_MULT:g} x and "
        f"{TP_SHARE_MULT:g} x: {worst[1] / moved[1]:.2f} x and "
        f"{share / moved[2] if moved[2] else math.inf:.2f} x)")
    return out


def tp_long(torch, engine) -> dict:
    """Phase 15c: one TP_LONG_PROMPT-token prompt a data rank through the TP
    engine: each pass's flash launches counted (LAYERS x 2 model ranks x 2
    data ranks of the sm90 kernel at 16 query and 4 kv heads a model rank,
    none of the CUDA-core one), the warm prefill ms a data rank, one
    prefill under ``torch.profiler``."""
    import numpy as np

    from repro_torch import kernels

    cfg = engine.cfg
    tokens = np.random.RandomState(15).randint(0, cfg.vocab_size - 1,
                                               size=(engine.n, TP_LONG_PROMPT))
    before = kernels.launch_counts()
    with torch.no_grad():
        for d, batch in enumerate(_rank_batches(torch, tokens, ranks=engine.n)):
            logits, _ = engine.prefill(engine.replica(d), batch, max_len=TP_LONG_PROMPT)
            assert bool(torch.isfinite(logits[:, -1]).all())
            del logits
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    sm90 = after["flash_attention_sm90"] - before["flash_attention_sm90"]
    core = after["flash_attention"] - before["flash_attention"]
    want = LAYERS * engine.tp * engine.n
    assert sm90 == want and core == 0, (sm90, core, want)
    prefill_s, _ = time_prefill_decode(torch, engine, tokens, 1)
    prof = profile_prefill(torch, engine, tokens, label="serve tp long", ranks=1)
    out = {"sm90_launches_a_pass": sm90, "cuda_core_launches": core,
           "prefill_ms_per_data_rank": prefill_s / engine.n * 1e3, "profile": prof}
    log(f"serve tp long: one {TP_LONG_PROMPT}-token prompt a data rank, "
        f"{sm90} flash_attention_sm90 launches a pass ({LAYERS} layers x {engine.tp} model "
        f"ranks x {engine.n} data ranks, 16 query / 4 kv heads a model rank), {core} of the "
        f"CUDA-core kernel; warm prefill {out['prefill_ms_per_data_rank']:.2f} ms a data rank; "
        f"profiled {prof[0]['device_ms'] / prof[0]['wall_ms']:.1%} busy")
    return out


def tp_flash_shard(torch, engine) -> dict:
    """Phase 15c's kernel check, run after the ``serve_tp`` path's counts
    are read: data rank 0's TP_LONG_PROMPT-token prefill again, with every
    call of ``flash_attention`` recorded (its q, k, v, keywords and the
    output the path went on with). Each is the sm90 kernel's, on a head
    shard (the config's heads and kv heads over the model ranks), and lies
    within one bf16 rounding of the plain version's f32 result on the same
    inputs. The first call is timed beside the plain version and one
    scaled_dot_product_attention call, for the kernels JSON."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa

    cfg = engine.cfg
    tokens = np.random.RandomState(15).randint(0, cfg.vocab_size - 1, size=(1, TP_LONG_PROMPT))
    batch = _rank_batches(torch, tokens, ranks=1)[0]
    calls, launched = [], fa.flash_attention

    def record(q, k, v, **kw):
        out = launched(q, k, v, **kw)
        calls.append((q.clone(), k.clone(), v.clone(), kw, out))
        return out

    fa.flash_attention = record
    try:
        with torch.no_grad():
            engine.prefill(engine.replica(0), batch, max_len=TP_LONG_PROMPT)
    finally:
        fa.flash_attention = launched
    heads = (cfg.num_heads // engine.tp, cfg.num_kv_heads // engine.tp)
    assert len(calls) == LAYERS * engine.tp, len(calls)
    worst, err = 0.0, 0.0
    for q, k, v, kw, out in calls:
        assert (q.shape[2], k.shape[2]) == heads and q.shape[1] == TP_LONG_PROMPT, \
            (q.shape, k.shape, heads)
        assert fa.kernel_route(q.dtype, q.shape[3]) == "flash_attention_sm90"
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        worst = max(worst, flash_bf16_share(torch, out, want32))
        err = max(err, max_abs_err(torch, out, want32))
        del want32
    assert worst <= 1.0, f"sm90 flash on the TP head shard off the plain version: {worst}"
    q, k, v, kw, _ = calls[0]
    del calls
    ms = time_ms(torch, lambda: fa.flash_sm90(q, k, v, **kw), reps=20)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **kw), reps=3, warmup=1)
    library_ms = time_ms(torch, _sdpa_call(torch, q, k, v, kw), reps=10)
    flops, bound, by = _flash_bound(q, k, v, kw)
    out = {"calls_checked": LAYERS * engine.tp, "shape": [list(q.shape), list(k.shape)],
           "tiles": [kw["bq"], kw["bk"]], "max_abs_err": err, "bf16_share_of_limit": worst,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": library_ms, "gflop": flops / 1e9}
    log(f"serve tp flash: data rank 0's {LAYERS * engine.tp} flash_attention_sm90 calls on "
        f"head shards {tuple(q.shape)} x {tuple(k.shape)} tiles ({kw['bq']}, {kw['bk']}), "
        f"each against the plain version's f32 result on its inputs: max abs err {err:.3e}, "
        f"{worst:.3f} of the limit 2^-8 |plain| + 1e-5; bf16 {ms:.4f} ms (bound {bound:.4f} "
        f"ms by {by}, {bound / ms:.1%}), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms")
    return out


def tp_smoke(torch) -> float:
    """Phase 15d: minitron-8b-smoke in f32 on (2, 2) ('data', 'model'),
    distributed and served on the card and on the CPU from one tree: each
    data rank's prefill logits within 1e-3, the greedy tokens equal."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("minitron-8b-smoke"), dtype="float32")
    params = Model(cfg).init(seed=0, device="cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size - 1, size=(BATCH, 16))
    logits, toks = {}, {}
    for dev in ("cpu", "cuda"):
        engine = Engine(cfg, tree_map(lambda t: t.to(dev), params), mesh=_tp_mesh(dev),
                        distribute=True, device=dev)
        with torch.no_grad():
            logits[dev] = torch.cat([
                engine.prefill(engine.replica(d), {"tokens": b["tokens"].to(dev)},
                               max_len=24)[0].cpu()
                for d, b in enumerate(_rank_batches(torch, tokens, ranks=engine.n))])
        toks[dev] = engine.generate({"tokens": tokens}, steps=8).tokens
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    assert err <= 1e-3 and (toks["cpu"] == toks["cuda"]).all(), (err, toks)
    log(f"serve tp smoke: minitron-8b-smoke f32 on (2, 2) ('data', 'model'), card vs CPU, "
        f"max abs prefill logit diff {err:.3e} (tol 1e-3), greedy tokens equal")
    return err


def tensor_parallel(torch, phase3: dict, seq_counts: dict) -> tuple[dict, dict]:
    """Phase 15, TP serving: 15a to 15c, the TP engine's own runs, counted
    as the ``serve_tp`` path; then, uncounted, 15b's one-axis and f32
    references; then phase 18a on the same engine and weights, counted into
    the ``tp_seq`` path's ``seq_counts``; then 15c's flash check and 15d.
    Returns the numbers and the path's launch counts."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    dist_rec, engine, params = tp_distribution(torch, phase3)
    serve_rec, tokens, tp_tokens = tp_serving(torch, engine, phase3)
    long_rec = tp_long(torch, engine)
    counts = kernels.launch_counts()
    serve_rec.update(tp_against_one_axis(torch, engine, params, tokens, tp_tokens))
    seq_rec = tp_seq_minitron(torch, engine, params, {"long": long_rec, "serving": serve_rec},
                              seq_counts)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    long_rec["flash_check"] = tp_flash_shard(torch, engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out = {"distribution": dist_rec, "serving": serve_rec, "long": long_rec,
           "tp_seq": seq_rec, "smoke_err": tp_smoke(torch)}
    return out, counts


def _layer_params(stack: dict, layout, l: int):
    """Layer ``l``'s parameters (or its model ranks' list of them) from a
    stack in the superblock layout: row ``l // period`` of slot
    ``l % period``, or its tail entry."""
    from repro_torch.core.tree import tree_map

    i, s = l % layout.period, l // layout.period
    if s < layout.num_super:
        return tree_map(lambda t: t[s], stack["blocks"][i])
    return stack["tail"][l - layout.num_super * layout.period]


def _layer_check(torch, engine, one, batch) -> tuple[float, float, int]:
    """The layer check of phases 15b and 16: each layer of the TP engine on
    data rank 0's shards and the one-axis engine's layer, each fed the
    one-axis hidden state (an encoder-decoder's encoder layers
    first, in train mode and bidirectional, then its decoder layers on the
    one-axis encoder's normed output; a vision config's decoder over the
    patches and the text, the prefix-LM mask), against that layer in f32
    from the same bf16 input and weights (TF32 off). Returns the largest
    ratio of the TP layer's largest error to the one-axis layer's plus
    TP_LAYER_REL times its largest output, the largest ratio of the mean
    errors, and the layers checked."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import tensor_parallel as tp_lib
    from repro_torch.models.blocks import apply_block
    from repro_torch.models.layers import embed_tokens, rms_norm
    from repro_torch.models.transformer import StackLayout, _dtype

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = engine.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    full, shards = one.replica(0), engine.replica(0)
    dt = _dtype(cfg)
    x = embed_tokens(full["embed"], batch["tokens"]) * torch.tensor(
        cfg.d_model**0.5, dtype=dt, device=batch["tokens"].device)
    prefix_len, cross = 0, None
    if cfg.frontend == "vision":
        x = torch.cat([batch["embeds"].to(dt), x], dim=1)
        prefix_len = batch["embeds"].shape[1]
    passes = [("decoder", StackLayout(cfg), "prefill", True)]
    if cfg.arch_type == "encdec":
        passes.insert(0, ("encoder", StackLayout(cfg, encoder=True), "train", False))
    worst, worst_mean, n = 0.0, 0.0, 0
    for name, layout, mode, causal in passes:
        h = batch["embeds"].to(dt) if name == "encoder" else x
        xi = None if name == "encoder" else cross
        for l in range(layout.num_layers):
            p = _layer_params(full[name], layout, l)
            ps = [_layer_params(s[name], layout, l) for s in shards]
            kind, win = layout.kinds[l], layout.windows[l]
            kw = {"mode": mode, "prefix_len": prefix_len, "causal": causal}
            want = apply_block(p, h, cfg, kind, win, cross_inputs=xi, **kw)[0]
            got = tp_lib._block(ps, h, cfg, kind, win, cross_inputs=xi, **kw)[0]
            exact = apply_block(tree_map(lambda t: t.float(), p), h.float(), cfg32, kind, win,
                                cross_inputs=None if xi is None else xi.float(), **kw)[0]
            e_tp, e_one = (got.float() - exact).abs(), (want.float() - exact).abs()
            limit = float(e_one.max()) + TP_LAYER_REL * float(want.abs().max())
            worst = max(worst, float(e_tp.max()) / limit)
            worst_mean = max(worst_mean, float(e_tp.mean()) / float(e_one.mean()))
            h, n = want, n + 1
            del got, exact, e_tp, e_one
        if name == "encoder":
            cross = rms_norm(full["enc_norm"], h, cfg.norm_eps)
    return worst, worst_mean, n


def _inkernel_serve_table(torch, cfg, mesh):
    """Phase 16a's tuner table, built on the card as phase 4b builds its own:
    each of the data level's buckets (the full tree's, the broadcast runs
    before the cut) planned on the data axis's ranks, timed as one
    in-kernel replay, recorded with ``exec_path='inkernel'``, saved and
    loaded back."""
    from repro_torch.core.tree import tree_map
    from repro_torch.core.tuner import Tuner
    from repro_torch.models import Model
    from repro_torch.serve.engine import plan_distribution

    stacked = tree_map(lambda t: torch.empty((mesh.size,) + tuple(t.shape), device="meta",
                                             dtype=t.dtype), Model(cfg).param_shapes())
    spec, _plans = plan_distribution(stacked, mesh)
    tuner = Tuner()
    buckets = list(zip(spec.bucket_bytes(), spec.bucket_sizes, spec.bucket_dtypes))
    rows = record_inkernel_table(torch, [tuner], buckets, "bcast", [{"exec_path": "inkernel"}],
                                 n=TP_MESH[0])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tp_serve_table.json")
        tuner.save(path)
        return Tuner.load(path), rows


def tp_family(torch, path: str, arch: str, layers, per_rank: int, prompt: int,
              flash_per_pass: int, one_axis: dict, phase: str, then=None) -> dict:
    """Phase 16a, 16b, 16c, 17a or 17b (see the module docstring). Returns
    the numbers, with the path's launch counts under ``counts``: zeroed
    after 16a's table is recorded and read before the one-axis references,
    the layer check and ``then(engine, one, tokens, numbers)``, whose dict
    joins the numbers (``one``: the one-axis engine on the same weights,
    ``numbers`` the run's so far)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import Model
    from repro_torch.serve import Engine, distribute_weights, replicate
    from repro_torch.serve.engine import rank_rows

    t_start = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    mesh = _tp_mesh()
    table = None
    if path == "tp_moe":
        table, table_rows = _inkernel_serve_table(torch, cfg, mesh)
    params = Model(cfg).init(seed=0, device="cuda")
    specs = param_specs(Model(cfg).param_shapes(), mesh, fsdp=False, attn_fallback="head_dim")
    roots = rank_rows(mesh)[0]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    assert _shards_equal(torch, engine.params, params, specs, mesh), f"a staged {arch} shard differs"
    dists = {}
    for how, kw in (("compiled", {"algo": "pipelined_chain", "compiled": True}),
                    ("inkernel", {"tuner": table})):
        if how == "inkernel" and table is None:
            continue
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, plans = distribute_weights(
            replicate(params, mesh.size, fill_root_only=True, roots=roots), mesh, specs=specs,
            double_buffer=True, return_plans=True, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = kernels.launch_counts()
        assert _shards_equal(torch, out, params, specs, mesh), f"a {how} {arch} shard differs"
        del out
        torch.cuda.empty_cache()
        dists[how] = {"s": secs, **{k: after[k] - before[k]
                                    for k in ("fused_combine", "inkernel_rdma")}}
        if how == "inkernel":
            assert all(p.decision.exec_path == "inkernel" for p in plans["data"]), plans
            assert dists[how]["fused_combine"] == 0 < dists[how]["inkernel_rdma"], dists[how]
    tokens = np.random.RandomState(16).randint(0, cfg.vocab_size - 1,
                                               size=(per_rank * engine.n, prompt))
    embeds = None
    if cfg.frontend == "vision" or cfg.arch_type == "encdec":
        embeds = next(batches(make_source(cfg, seed=16), cfg, batch=per_rank * engine.n,
                              seq=prompt, device="cuda"))["embeds"]
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens, "embeds": embeds}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    cold = kernels.launch_counts()["flash_attention_sm90"] - before["flash_attention_sm90"]
    assert res.tokens.shape == (len(tokens), STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens, STEPS, embeds)
    counts = kernels.launch_counts()
    warm = counts["flash_attention_sm90"] - before["flash_attention_sm90"] - cold
    want = flash_per_pass * engine.n
    assert cold == warm == want and counts["flash_attention"] == 0, (cold, warm, want, counts)
    peak = torch.cuda.max_memory_allocated()
    assert peak < TP_PEAK_LIMIT, f"phase 16 {arch} peaked at {peak / 2**30:.2f} GiB"
    serve_s = time.perf_counter() - t_start

    # uncounted: the one-axis engine on the same weights, and the layer check
    one = Engine(cfg, params)
    agree = 0
    rank_batches = _rank_batches(torch, tokens, embeds, ranks=engine.n)
    for d, batch in enumerate(rank_batches):
        ref = one.generate(batch, steps=STEPS)
        agree += int((ref.tokens == res.tokens[d * per_rank:(d + 1) * per_rank]).sum())
    with torch.no_grad():
        layer_ratio, mean_ratio, checked = _layer_check(torch, engine, one,
                                                                rank_batches[0])
    assert layer_ratio <= 1.0, f"a TP {arch} layer lies off the f32 layer: {layer_ratio}"
    out = {"layers": cfg.num_layers, "staged_s": staged_s,
           **{f"{how}_s": r["s"] for how, r in dists.items()}, "distributions": dists,
           "peak_gib": peak / 2**30, "generate_s": gen_s,
           "prefill_ms_per_data_rank": prefill_s / TP_MESH[0] * 1e3,
           "decode_tokens_per_s": len(tokens) * STEPS / decode_s,
           "decode_ms_a_step": decode_s / (TP_MESH[0] * STEPS) * 1e3,
           "flash_sm90_a_pass": cold, "tokens_agree": agree, "tokens": int(res.tokens.size),
           "layer_limit_ratio": layer_ratio, "layer_mean_err_ratio": mean_ratio,
           "layers_checked": checked, "one_axis": {k: one_axis[k] for k in (
               "distribute_s", "prefill_ms_per_rank", "decode_tokens_per_s")},
           "serve_s": serve_s, "counts": counts}
    if then is not None:
        out.update(then(engine, one, tokens, dict(out)))
    del one, engine, params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_start
    if table is not None:
        out["table_buckets"] = table_rows
    frames = f" + {cfg.frontend_len} frames" if cfg.arch_type == "encdec" else ""
    enc = f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else ""
    patches = f"{cfg.prefix_len} patches + " if cfg.frontend == "vision" else ""
    log(f"serve {path}: {arch} {cfg.num_layers}{enc} layers on (2, 2) ('data', 'model'), "
        f"distribution staged {staged_s:.3f} s, "
        + ", ".join(f"{how} {r['s']:.3f} s ({r['fused_combine']} fused_combine, "
                    f"{r['inkernel_rdma']} inkernel_rdma)" for how, r in dists.items())
        + f", every shard bit-equal, beside phase {phase}'s one-axis "
        f"{one_axis['distribute_s']:.3f} s; peak {peak / 2**30:.2f} GiB; {per_rank} request(s) "
        f"a data rank of {patches}{prompt} tokens{frames}, {STEPS} steps: warm prefill "
        f"{out['prefill_ms_per_data_rank']:.2f} ms a data rank (phase {phase}: "
        f"{one_axis['prefill_ms_per_rank']:.2f} ms a rank), decode "
        f"{out['decode_tokens_per_s']:.1f} tok/s, {out['decode_ms_a_step']:.2f} ms a data "
        f"rank's step (phase {phase}: {one_axis['decode_tokens_per_s']:.1f} tok/s, "
        f"{1e3 / one_axis['decode_tokens_per_s']:.2f} ms a rank's step); flash_attention_sm90 "
        f"{cold} a pass ({flash_per_pass} a data rank), flash_attention 0; greedy tokens "
        f"agree {agree} / {res.tokens.size} with the one-axis engine; {checked} layers against the layer in f32: the TP layer's largest error within "
        f"{layer_ratio:.3f} of the one-axis layer's plus one bf16 rounding of its largest "
        f"output, mean error at most {mean_ratio:.3f} x the one-axis layer's; phase "
        f"{out['phase_s']:.1f} s (served {serve_s:.1f})")
    return out


def tp_family_smoke(torch, cases=tuple((name, {}) for name in TP_FAMILY_SMOKE),
                    prompt: int = 16, label: str = "serve tp families smoke") -> dict:
    """Phase 16d (the four smoke configs) or 17c (``cases``: (config,
    overrides of its fields) pairs, ``prompt`` tokens a request) in f32 on
    (2, 2) ('data', 'model'), distributed and served on the card and on the
    CPU from one tree: each data rank's prefill logits within 1e-3, the
    greedy tokens of 8 steps equal."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for name, over in cases:
        cfg = dataclasses.replace(get_config(name), dtype="float32", **over)
        key = name + "".join(f" {k}={v}" for k, v in over.items())
        params = Model(cfg).init(seed=0, device="cpu")
        tokens = np.random.RandomState(0).randint(0, cfg.vocab_size - 1, size=(BATCH, prompt))
        n = cfg.prefix_len if cfg.frontend == "vision" else cfg.frontend_len
        embeds = None if not n else torch.as_tensor(
            np.random.RandomState(1).randn(BATCH, n, cfg.d_model).astype(np.float32))
        logits, toks = {}, {}
        for dev in ("cpu", "cuda"):
            engine = Engine(cfg, tree_map(lambda t: t.to(dev), params), mesh=_tp_mesh(dev),
                            distribute=True, device=dev)
            emb = None if embeds is None else embeds.to(dev)
            with torch.no_grad():
                logits[dev] = torch.cat([
                    engine.prefill(engine.replica(d), {"tokens": b["tokens"].to(dev),
                                                       "embeds": b["embeds"]},
                                   max_len=prompt + 8)[0].cpu()
                    for d, b in enumerate(_rank_batches(torch, tokens, emb, ranks=engine.n))])
            toks[dev] = engine.generate({"tokens": tokens, "embeds": emb}, steps=8).tokens
        errs[key] = float((logits["cpu"] - logits["cuda"]).abs().max())
        assert errs[key] <= 1e-3 and (toks["cpu"] == toks["cuda"]).all(), (key, errs, toks)
    log(f"{label}: f32 on (2, 2) ('data', 'model'), {prompt}-token prompts, card vs CPU, max "
        f"abs prefill logit diff {errs} (tol 1e-3), greedy tokens equal")
    return errs


def _tp_seq_then(torch, path: str, arch: str, flash: int, seq_counts: dict):
    """The ``then`` of 16b, 16c and 17a: phase 18b, 18d or 18c on the
    phase's engine (:func:`tp_seq_family`), its counts added to the
    ``tp_seq`` path's ``seq_counts``; None for the other runs."""
    if path not in TP_SEQ_RUNS:
        return None
    return lambda engine, one, tokens, rec: {"tp_seq": tp_seq_family(
        torch, engine, one, tokens, seq_counts, flash, f"serve tp_seq {arch}",
        TP_SEQ_RUNS[path], rec)}


def tp_families(torch, one_axis: dict, seq_counts: dict) -> tuple[dict, dict]:
    """Phase 16: 16a-16c, each its own path, then 16d; 16b's and 16c's
    engines serve 18b and 18d, into the ``tp_seq`` path's ``seq_counts``.
    ``one_axis`` holds phases 10, 4d and 13a's numbers by phase. Returns the
    numbers and the paths' launch counts."""
    t0 = time.perf_counter()
    out, counts = {}, {}
    for path, arch, layers, per_rank, prompt, flash, phase in TP_FAMILY_RUNS:
        out[path] = tp_family(torch, path, arch, layers, per_rank, prompt, flash,
                              one_axis[phase], phase,
                              then=_tp_seq_then(torch, path, arch, flash, seq_counts))
        counts[path] = out[path].pop("counts")
    out["smoke_err"] = tp_family_smoke(torch)
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve tp families: phase 16 {out['phase_s']:.1f} s")
    return out, counts


def slstm_launches(torch, engine, one) -> dict:
    """17b's sLSTM loop, host-bound: on data rank 0's first sLSTM layer, the
    device launches a token and the host-clock ms a token of the
    tensor-parallel loop (two model ranks' shards) and of the one-axis loop
    (the same layer of ``one``), each the difference between prefills of
    SLSTM_TOKENS[1] and SLSTM_TOKENS[0] random bf16 tokens over the tokens
    between: launches counted by ``torch.profiler`` (kernels and copies,
    :func:`device_rows`), each prefill warmed up once and timed alone."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm
    from repro_torch.models import tensor_parallel as tp_lib
    from repro_torch.models.transformer import StackLayout

    cfg = engine.cfg
    layout = StackLayout(cfg)
    l = cfg.layer_kinds().index("slstm")
    ps = [{"ssm": _layer_params(s["decoder"], layout, l)["ssm"]} for s in engine.replica(0)]
    p1 = _layer_params(one.replica(0)["decoder"], layout, l)["ssm"]
    gen = torch.Generator(device="cuda").manual_seed(17)
    runs = {"tp": lambda x: tp_lib._slstm_tp(ps, x, cfg, mode="prefill", caches=None),
            "one_axis": lambda x: ssm.slstm_seq(p1, x, cfg)}
    out = {}
    with torch.no_grad():
        for name, fn in runs.items():
            n, secs = [], []
            for T in SLSTM_TOKENS:
                x = torch.randn((1, T, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
                fn(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn(x)
                    torch.cuda.synchronize()
                n.append(sum(row[2] for row in device_rows(prof)))
            span = SLSTM_TOKENS[1] - SLSTM_TOKENS[0]
            out[name] = {"launches_a_token": (n[1] - n[0]) / span,
                         "ms_a_token": (secs[1] - secs[0]) / span * 1e3, "launches": n}
    log(f"serve tp_recurrent slstm loop: layer {l}, {out['tp']['launches_a_token']:.2f} launches "
        f"and {out['tp']['ms_a_token']:.4f} ms a token on 2 model ranks beside the one-axis "
        f"loop's {out['one_axis']['launches_a_token']:.2f} and "
        f"{out['one_axis']['ms_a_token']:.4f} ms (launches at {SLSTM_TOKENS} tokens: "
        f"{out['tp']['launches']} / {out['one_axis']['launches']})")
    return out


def tp_ssm_after(torch, path: str, engine, one, tokens) -> dict:
    """17a and 17b after their path's counts: one data rank's warm prefill
    under ``torch.profiler`` (device busy share, launches, ms by kernel
    class), and for xlstm the sLSTM loop's launches a token."""
    out = {"profile": profile_prefill(torch, engine, tokens, label=f"serve {path}", ranks=1)}
    if "slstm" in engine.cfg.layer_kinds():
        out["slstm_loop"] = slstm_launches(torch, engine, one)
    return out


def tp_ssm(torch, one_axis: dict, seq_counts: dict) -> tuple[dict, dict]:
    """Phase 17: 17a and 17b, each its own path, then 17c; 17a's engine
    serves 18c, into the ``tp_seq`` path's ``seq_counts``. ``one_axis``
    holds phases 12a and 12b's numbers by phase. Returns the numbers and the
    paths' launch counts."""
    t0 = time.perf_counter()
    out, counts = {}, {}
    for path, arch, layers, per_rank, prompt, flash, phase in TP_SSM_RUNS:
        seq = _tp_seq_then(torch, path, arch, flash, seq_counts)

        def then(engine, one, tokens, rec, path=path, seq=seq):
            extra = tp_ssm_after(torch, path, engine, one, tokens)
            return extra if seq is None else {**extra, **seq(engine, one, tokens, rec)}
        out[path] = tp_family(torch, path, arch, layers, per_rank, prompt, flash,
                              one_axis[phase], phase, then=then)
        counts[path] = out[path].pop("counts")
    out["smoke_err"] = tp_family_smoke(torch, TP_SSM_SMOKE, TP_SSM_SMOKE_PROMPT,
                                       label="serve tp ssm smoke")
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve tp ssm: phase 17 {out['phase_s']:.1f} s")
    return out, counts


def _group_batches(torch, engine, tokens, embeds=None) -> list:
    """Each serving group of ``engine`` (``Engine.groups``, as
    ``batch_specs`` places the batch) with its share of the requests."""
    tok = torch.as_tensor(tokens, device=engine.device)
    return [(g, {"tokens": tok[g.lo:g.hi], "embeds": None if embeds is None else embeds[g.lo:g.hi]})
            for g in engine.groups(len(tokens))]


def time_groups(torch, engine, tokens, steps: int, embeds=None) -> tuple[float, float, str]:
    """:func:`time_prefill_decode` over the serving groups: each group's
    prefill on the shards of its data coordinate 0, its caches cut over the
    group's mesh, then ``steps`` decode steps, in separate windows closed by
    a synchronize. Returns the seconds of all groups' prefills and of all
    their decode steps, and the first group's cache layout
    (:func:`_cache_slots`)."""
    T = tokens.shape[1]
    offset = engine.cfg.prefix_len if engine.cfg.frontend == "vision" else 0
    prefill_s = decode_s = 0.0
    layout = None
    with torch.no_grad():
        for g, batch in _group_batches(torch, engine, tokens, embeds):
            params = engine.shards(g.ranks[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = engine.prefill(params, batch, max_len=T + STEPS, mesh=g.mesh)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            nxt = torch.argmax(logits[:, -1], dim=-1)
            del logits
            for i in range(steps):
                logits, caches = engine.decode_step(params, nxt[:, None], caches, T + offset + i)
                nxt = torch.argmax(logits[:, 0], dim=-1)
            torch.cuda.synchronize()
            prefill_s += t1 - t0
            decode_s += time.perf_counter() - t1
            layout = layout or _cache_slots(caches)
            del caches
    return prefill_s, decode_s, layout


def _cache_slots(caches) -> str:
    """The layout the run served from: the first block's attention and
    cross caches as the serving group's ranks hold them, each distinct
    block (slots or frames x kv heads) held once however many ranks list
    it."""
    blk = (caches["blocks"] or caches["tail"])[0]
    parts = []
    for key in ("attn", "cross"):
        if key in blk[0]:
            held = {c[key]["k"].data_ptr(): tuple(c[key]["k"].shape[-3:-1]) for c in blk}
            parts.append(f"{key} in {len(held)} block(s) of {sorted(set(held.values()))} "
                         f"(slots, kv heads) over {len(blk)} ranks")
    return "; ".join(parts) or "no attention cache"


def tp_layout_run(torch, label: str, engine, one, tokens, embeds=None, *, flash_per_pass: int,
                  counts, beside: str = "") -> dict:
    """One run of phase 18 on ``engine``: ``generate`` (cold), then a warm
    re-run of its loop group by group (TP_TIMED_STEPS decode steps), the
    sm90 flash launches of each prefill pass (``flash_per_pass`` a serving
    group, cold and warm alike) and none of the CUDA-core kernel, the
    peak; its launch counts added to ``counts``. Then, uncounted: the
    greedy tokens equal to the one-axis engine ``one``'s on the same
    weights. Returns the numbers."""
    import numpy as np

    from repro_torch import kernels

    cfg = engine.cfg
    groups = engine.groups(len(tokens))
    prompt = tokens.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens, "embeds": embeds}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    cold = kernels.launch_counts()["flash_attention_sm90"]
    assert res.tokens.shape == (len(tokens), STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    prefill_s, decode_s, layout = time_groups(torch, engine, tokens, TP_TIMED_STEPS, embeds)
    c = kernels.launch_counts()
    warm = c["flash_attention_sm90"] - cold
    want = flash_per_pass * len(groups)
    assert cold == warm == want and c["flash_attention"] == 0, (label, cold, warm, want, c)
    peak = torch.cuda.max_memory_allocated()
    assert peak < TP_PEAK_LIMIT, f"{label} peaked at {peak / 2**30:.2f} GiB"
    for k, n in c.items():
        counts[k] = counts.get(k, 0) + n
    ref = one.generate({"tokens": tokens, "embeds": embeds}, steps=STEPS)
    agree = int((ref.tokens == res.tokens).sum())
    assert agree == res.tokens.size, (f"{label}: greedy tokens off the one-axis engine's",
                                      res.tokens, ref.tokens)
    out = {"requests": len(tokens), "prompt": prompt, "groups": len(groups),
           "group_ranks": [list(map(int, g.ranks.shape)) for g in groups],
           "generate_s": gen_s, "prefill_ms": prefill_s / len(groups) * 1e3,
           "decode_ms_a_step": decode_s / (len(groups) * TP_TIMED_STEPS) * 1e3,
           "decode_tokens_per_s": len(tokens) * TP_TIMED_STEPS / decode_s,
           "flash_sm90_a_pass": cold, "peak_gib": peak / 2**30, "layout": layout,
           "tokens_agree": agree, "tokens": int(res.tokens.size)}
    log(f"{label}: {len(tokens)} request(s) of {prompt} tokens, {len(groups)} serving "
        f"group(s) of {out['group_ranks'][0]} (data, model) ranks; caches: {layout}; generate "
        f"{gen_s:.3f} s (cold); warm prefill {out['prefill_ms']:.2f} ms a group, decode "
        f"{out['decode_ms_a_step']:.2f} ms a group's step, {out['decode_tokens_per_s']:.1f} "
        f"tok/s{beside}; flash_attention_sm90 {cold} a pass ({flash_per_pass} a group), "
        f"flash_attention 0; peak {peak / 2**30:.2f} GiB; greedy tokens equal to the one-axis "
        f"engine's ({agree} / {res.tokens.size})")
    return out


def tp_seq_logits(torch, engine, one, tokens, control: dict) -> dict:
    """18a's decode check, after the path's counts: one TP_LONG_PROMPT-token
    request over both data ranks (the caches' sequence on 'data') and the
    one-axis engine, both fed the one-axis engine's greedy tokens for
    TP_SEQ_DECODE decode steps; the decode logits' largest ratio to TP_REL
    |ref| + TP_ABS and their share over it held within TP_RATIO_MULT and
    TP_SHARE_MULT of phase 15b's control (one weight element one bf16 step
    up in the one-axis engine)."""
    T = tokens.shape[1]
    (g, batch), = _group_batches(torch, engine, tokens)
    params, got, want = engine.shards(g.ranks[0]), [], []
    with torch.no_grad():
        lt, ct = engine.prefill(params, batch, max_len=T + STEPS, mesh=g.mesh)
        lo, co = one.prefill(one.replica(0), batch, max_len=T + STEPS)
        nxt = torch.argmax(lo[:, -1], dim=-1)[:, None]
        del lt, lo
        for i in range(TP_SEQ_DECODE):
            lt, ct = engine.decode_step(params, nxt, ct, T + i)
            lo, co = one.decode_step(one.replica(0), nxt, co, T + i)
            got.append(lt[:, 0])
            want.append(lo[:, 0])
            nxt = torch.argmax(lo[:, 0], dim=-1)[:, None]
    err, ratio, share = _logit_diff(torch.cat(got), torch.cat(want))
    moved = control["one_ulp_weight_logits"]
    assert ratio <= TP_RATIO_MULT * moved["limit_ratio"] \
        and share <= TP_SHARE_MULT * moved["share_over_limit"], \
        ("18a's bf16 decode logits lie farther from the one-axis engine's than the control "
         "allows", err, ratio, share, moved)
    log(f"serve tp_seq logits: {TP_SEQ_DECODE} decode steps after one {T}-token request over "
        f"both data ranks, against the one-axis engine fed the same tokens: max abs diff "
        f"{err:.4f}, {ratio:.2f} x the limit, {share:.2%} of logits over it, beside phase 15b's "
        f"control {moved['limit_ratio']:.2f} x, {moved['share_over_limit']:.2%} (held within "
        f"{TP_RATIO_MULT:g} x and {TP_SHARE_MULT:g} x)")
    return {"max_abs_err": err, "limit_ratio": ratio, "share_over_limit": share}


def _serve_compiled_distribution(torch, engine, params, specs) -> float:
    """The compiled pipelined chain with ``specs=`` from the rows of data
    coordinate 0 of ``engine``'s mesh; the engine then serves from its
    result, every shard bit-equal to its block of ``params``. Returns the
    host-clock s."""
    from repro_torch.serve import distribute_weights, replicate
    from repro_torch.serve.engine import rank_rows

    mesh = engine.mesh
    engine.params = None  # the rows the chain replaces
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.params = distribute_weights(
        replicate(params, mesh.size, fill_root_only=True, roots=rank_rows(mesh)[0]), mesh,
        specs=specs, algo="pipelined_chain", compiled=True, double_buffer=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert _shards_equal(torch, engine.params, params, specs, mesh), "a compiled shard differs"
    return secs


def tp_seq_minitron(torch, engine, params, phase15: dict, counts: dict) -> dict:
    """Phase 18a on phase 15's engine and weights: the compiled pipelined
    chain with ``specs=`` (every shard bit-equal to its block) serves the
    runs, then one TP_LONG_PROMPT-token request over both data ranks (the
    caches' sequence on 'data', 2064 slots a data rank, the kv heads on
    'model'; LAYERS x 2 model ranks sm90 launches a pass, computed once) and
    TP_SEQ_BATCH requests at PROMPT tokens (a batch on no data axis), each
    beside 15c's and 15b's numbers (:func:`tp_layout_run`); then, after the
    counts, the decode logits' check (:func:`tp_seq_logits`)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    cfg = engine.cfg
    specs = param_specs(Model(cfg).param_shapes(), engine.mesh, fsdp=False,
                        attn_fallback="head_dim")
    kernels.reset_launch_counts()
    dist_s = _serve_compiled_distribution(torch, engine, params, specs)
    c = kernels.launch_counts()
    for k, n in c.items():
        counts[k] = counts.get(k, 0) + n
    one = Engine(cfg, params)
    rng = np.random.RandomState(18)
    long_tokens = rng.randint(0, cfg.vocab_size - 1, size=(1, TP_LONG_PROMPT))
    batch_tokens = rng.randint(0, cfg.vocab_size - 1, size=(TP_SEQ_BATCH, PROMPT))
    p15, s15 = phase15["long"], phase15["serving"]
    out = {"compiled_s": dist_s, "distribution_launches": {k: c[k] for k in (
        "fused_combine", "chunked_copy")}}
    out["long"] = tp_layout_run(
        torch, "serve tp_seq minitron-8b long", engine, one, long_tokens,
        flash_per_pass=LAYERS * engine.tp, counts=counts,
        beside=f" (15c, one request a data rank: {p15['prefill_ms_per_data_rank']:.2f} ms a data "
               f"rank)")
    out["batch"] = tp_layout_run(
        torch, "serve tp_seq minitron-8b batch", engine, one, batch_tokens, flash_per_pass=0,
        counts=counts,
        beside=f" (15b, {BATCH // engine.n} requests a data rank: "
               f"{s15['prefill_ms_per_data_rank']:.2f} ms a data rank, "
               f"{s15['decode_tokens_per_s']:.1f} tok/s)")
    out["logits"] = tp_seq_logits(torch, engine, one, long_tokens, s15)
    del one
    log(f"serve tp_seq: phase 18a compiled distribution {dist_s:.3f} s "
        f"({out['distribution_launches']}), every shard bit-equal")
    return out


def tp_seq_family(torch, engine, one, tokens, counts: dict, flash_per_pass: int,
                  label: str, phase: str, prior: dict) -> dict:
    """Phase 18b, 18c or 18d, the ``then`` of 16b, 17a or 16c: one request
    of the phase's prompt (its first) over both data ranks of its engine
    (:func:`tp_layout_run`), beside the phase's own numbers ``prior`` (one
    request a data rank)."""
    from repro_torch.data.pipeline import batches, make_source

    cfg = engine.cfg
    embeds = None
    if cfg.frontend == "vision" or cfg.arch_type == "encdec":
        embeds = next(batches(make_source(cfg, seed=18), cfg, batch=1, seq=tokens.shape[1],
                              device="cuda"))["embeds"]
    return tp_layout_run(
        torch, label, engine, one, tokens[:1], embeds, flash_per_pass=flash_per_pass,
        counts=counts,
        beside=f" (phase {phase}, one request a data rank: "
               f"{prior['prefill_ms_per_data_rank']:.2f} ms a data rank, "
               f"{prior['decode_ms_a_step']:.2f} ms a step)")


def tp_m8(torch, one_axis: dict) -> tuple[dict, dict]:
    """Phase 18e, the ``tp_m8`` path: a model axis of TP_M8 ranks, one
    request each (:func:`tp_layout_run`), every layer against the layer in
    f32 as phases 16-17 hold it (:func:`_layer_check`, uncounted):
    minitron-8b (phase 15's LAYERS layers and seed) on (1, 8) with a
    TP_LONG_PROMPT-token prompt (4 query / 1 kv heads a rank: LAYERS x 8
    sm90 launches a pass); whisper-large-v3 on (1, 8) with 1500 frames + 4
    tokens (20 heads of 64: the head-width split, 8 wide a rank; the cross
    caches' 1500 frames whole); both cut by ``shard_stacked`` (no data
    level to broadcast over); xlstm-350m on (2, 8) after the staged and the
    compiled distribution with ``specs=`` (every shard bit-equal), one
    TP_M8_PROMPT-token request over both data ranks (4 mLSTM heads over 8
    ranks: 64 of 512 key rows a head a rank, the gates computed once; the
    states kept once), and its sLSTM loop's launches a token beside phase
    17b's. ``one_axis``: phases 15c, 16c and 17b's numbers (on 2 model
    ranks). Returns the numbers and the path's launch counts."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    t_start = time.perf_counter()
    counts, out = {}, {}
    runs = (("minitron-8b", LAYERS, TP_LONG_PROMPT, LAYERS * TP_M8, "15c"),
            ("whisper-large-v3", None, ENCDEC_PROMPT, 0, "16c"),
            ("xlstm-350m", None, TP_M8_PROMPT, 0, "17b"))
    for arch, layers, prompt, flash, phase in runs:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        params = Model(cfg).init(seed=0, device="cuda")
        rec = {}
        if arch == "xlstm-350m":
            mesh = make_mesh((2, TP_M8), axis_names=("data", "model"), device="cuda")
            specs = param_specs(Model(cfg).param_shapes(), mesh, fsdp=False,
                                attn_fallback="head_dim")
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
            torch.cuda.synchronize()
            rec["staged_s"] = time.perf_counter() - t0
            assert _shards_equal(torch, engine.params, params, specs, mesh), "a staged shard differs"
            rec["compiled_s"] = _serve_compiled_distribution(torch, engine, params, specs)
            c = kernels.launch_counts()
            rec["distribution_launches"] = {k: c[k] for k in ("fused_combine", "chunked_copy")}
            for k, n in c.items():
                counts[k] = counts.get(k, 0) + n
        else:
            engine = Engine(cfg, params, mesh=make_local_mesh(TP_M8, n=TP_M8, device="cuda"))
        one = Engine(cfg, params)
        tokens = np.random.RandomState(18).randint(0, cfg.vocab_size - 1, size=(1, prompt))
        embeds = None
        if cfg.arch_type == "encdec":
            embeds = next(batches(make_source(cfg, seed=18), cfg, batch=1, seq=prompt,
                                  device="cuda"))["embeds"]
        prior = one_axis[phase]
        rec.update(tp_layout_run(
            torch, f"serve tp_m8 {arch}", engine, one, tokens, embeds, flash_per_pass=flash,
            counts=counts,
            beside=f" (phase {phase} on 2 model ranks: "
                   f"{prior['prefill_ms_per_data_rank']:.2f} ms a data rank)"))
        # the layer check at a short prompt (the layers' math does not depend on the length)
        check = {"tokens": torch.as_tensor(tokens[:, :min(prompt, PROMPT)], device="cuda"),
                 "embeds": embeds}
        with torch.no_grad():
            ratio, mean_ratio, checked = _layer_check(torch, engine, one, check)
        assert ratio <= 1.0, f"a TP {arch} layer on {TP_M8} ranks lies off the f32 layer: {ratio}"
        rec.update({"layer_limit_ratio": ratio, "layer_mean_err_ratio": mean_ratio,
                    "layers_checked": checked})
        log(f"serve tp_m8 {arch} layers: {checked} layers on {TP_M8} model ranks against the "
            f"layer in f32: the TP layer's largest error within {ratio:.3f} of the one-axis "
            f"layer's plus one bf16 rounding of its largest output, mean error at most "
            f"{mean_ratio:.3f} x the one-axis layer's")
        if arch == "xlstm-350m":
            rec["slstm_loop"] = slstm_launches(torch, engine, one)
            prior17 = one_axis["17b"].get("slstm_loop", {}).get("tp", {})
            log(f"serve tp_m8 slstm loop: {rec['slstm_loop']['tp']['launches_a_token']:.2f} "
                f"launches and {rec['slstm_loop']['tp']['ms_a_token']:.4f} ms a token on "
                f"{TP_M8} model ranks beside phase 17b's on 2: "
                f"{prior17.get('launches_a_token', math.nan):.2f} and "
                f"{prior17.get('ms_a_token', math.nan):.4f} ms")
        out[arch] = rec
        del engine, one, params
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_start
    log(f"serve tp_m8: phase 18e {out['phase_s']:.1f} s")
    return out, counts


def tp_layout_smoke(torch) -> dict:
    """Phase 18f: the CPU tests' cases (TP_LAYOUT_SMOKE) in f32, distributed
    and served on the card and on the CPU from one tree: each serving
    group's prefill logits within 1e-3, the greedy tokens of 8 steps
    equal."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for i, (name, over, shape, B, T) in enumerate(TP_LAYOUT_SMOKE):
        cfg = dataclasses.replace(get_config(name), dtype="float32", **over)
        key = f"{name}{''.join(f' {k}={v}' for k, v in over.items())} {shape} {B}x{T}"
        params = Model(cfg).init(seed=0, device="cpu")
        tokens = np.random.RandomState(i).randint(0, 500, size=(B, T))
        n = cfg.prefix_len if cfg.frontend == "vision" else cfg.frontend_len
        embeds = None if not n else torch.as_tensor(
            np.random.RandomState(i + 1).randn(B, n, cfg.d_model).astype(np.float32))
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        logits, toks = {}, {}
        for dev in ("cpu", "cuda"):
            engine = Engine(cfg, tree_map(lambda t: t.to(dev), params),
                            mesh=make_mesh(shape, axis_names=names, device=dev),
                            distribute=True, device=dev)
            emb = None if embeds is None else embeds.to(dev)
            tok = torch.as_tensor(tokens, device=dev)
            with torch.no_grad():
                logits[dev] = torch.cat([
                    engine.prefill(engine.shards(g.ranks[0]),
                                   {"tokens": tok[g.lo:g.hi],
                                    "embeds": None if emb is None else emb[g.lo:g.hi]},
                                   max_len=T + 8, mesh=g.mesh)[0].cpu()
                    for g in engine.groups(B)])
            toks[dev] = engine.generate({"tokens": tokens, "embeds": emb}, steps=8).tokens
        errs[key] = float((logits["cpu"] - logits["cuda"]).abs().max())
        assert errs[key] <= 1e-3 and (toks["cpu"] == toks["cuda"]).all(), (key, errs, toks)
    log(f"serve tp layouts smoke: f32, the CPU tests' cases, card vs CPU, max abs prefill "
        f"logit diff {errs} (tol 1e-3), greedy tokens equal")
    return errs


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch is missing beside this script", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch import kernels
    from repro_torch.kernels import _build

    name_power = card()
    log(f"card: {name_power}")
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sweeps = {name: subprocess.Popen(  # the design sweeps, from the same sources, beside them
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-o", str(_build.BUILD_DIR.parent / name), os.path.join(ROOT, "tools", f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SWEEPS}
    try:
        _build.build_all()
    finally:
        sweep_logs = {name: p.communicate()[0] for name, p in sweeps.items()}
    for name, p in sweeps.items():
        assert p.returncode == 0, f"tools/{name}.cu does not build:\n{sweep_logs[name]}"
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.SOURCES)} sources "
        f"and {', '.join(f'tools/{name}.cu' for name in SWEEPS)}")
    for src in _build.SOURCES:
        logf = _build.BUILD_DIR / f"{src}.log"
        if logf.exists():
            for ln in logf.read_text().splitlines():
                if "registers" in ln or "spill" in ln or "Performance Loss" in ln:
                    log(f"  ptxas {src}: {ln.strip()}")
    marks = [("build", time.perf_counter() - t0)]  # each phase's end, seconds from the build's start

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter() - t0))

    cal = calibrate(torch)
    log(f"calibrate: ts {cal['ts_s']:.3e} s, t_launch {cal['t_launch_s']:.3e} s")
    fits = calibrate_fits(torch)

    lines = [check_fused_combine(torch), check_chunked_copy(torch), *check_quantize(torch),
             *check_inkernel(torch), *check_flash_attention(torch), *check_param_update(torch)]
    lines[0]["training_rounds"] = check_fused_combine_training(torch)
    mark("calibrate and kernel checks (1-2)")
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    serving, engine = serve(torch)
    from repro_torch.core.tree import tree_map

    root, mesh = tree_map(lambda t: t[0].clone(), engine.params), engine.mesh
    del engine  # frees the four replicas before phase 4 builds its own
    torch.cuda.empty_cache()
    log(f"memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before phase 4")
    compiled, stacked = compiled_replay(torch, root, mesh)
    serve_counts = kernels.launch_counts()
    del root
    tuned = tuned_inkernel(torch, stacked, mesh)
    tuned_counts = tuned.pop("counts")
    log(f"serving: tuned in-kernel distribution {tuned['distribute_s']:.3f} s beside the "
        f"compiled pipelined chain's {compiled['distribute_s']:.3f} s")
    del stacked, mesh
    mark("serving (3-4b)")
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    long = serve_long(torch)
    long_counts = long.pop("counts")
    log(f"memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before phase 4d")
    kernels.reset_launch_counts()
    vlm = serve_vlm(torch)
    vlm_counts = vlm.pop("counts")
    mark("long-prompt and vision serving (4c-4d)")

    small_reference(torch)
    kernels.reset_launch_counts()
    small_long_reference(torch)
    small_vlm_reference(torch)
    ref_long_counts = kernels.launch_counts()
    mark("references (5)")
    numbers = {"serve": serving, "compiled": compiled, "tuned_inkernel": tuned,
               "serve_long": long, "serve_vlm": vlm}
    log(f"serving numbers: {json.dumps(numbers)}")

    with tempfile.TemporaryDirectory() as d:
        tables, plans_per_step = train_tables(torch, d)
        table_runs = [(f"table_{e}", {"sync_mode": "tuned_allreduce", "tuner_table": tables[e]})
                      for e in ("compiled", "inkernel")]
        kernels.reset_launch_counts()
        training = train(torch, table_runs, plans_per_step)
        train_counts = kernels.launch_counts()
    mark("training (6)")
    gc.collect()
    torch.cuda.empty_cache()
    tp_training, train_tp_counts = train_tp(torch, training)
    mark("model-axis training (6t)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    moe_training = train_moe(torch)
    train_moe_counts = kernels.launch_counts()
    mark("MoE training (6m)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    vlm_training = train_vlm(torch)
    train_vlm_counts = kernels.launch_counts()
    mark("vision-prefix training (6v)")
    family_training, family_counts = train_families(torch)
    mark("family training and the hybrid probe (6f)")
    gc.collect()
    torch.cuda.empty_cache()
    tp_fam_training, train_tp_fam_counts = train_tp_families(
        torch, {"6m": moe_training["grad_allreduce"],
                "6f": family_training["train_encdec"]["grad_allreduce"], "6v": vlm_training})
    mark("model-axis training of the other families (6u)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    colls = collectives(torch)
    coll_counts = kernels.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    algos = algorithms(torch)
    algo_counts = kernels.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    stream_rec = streams(torch)
    stream_counts = stream_rec.pop("counts")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    tree_rec = tree_variants(torch)
    tree_counts = kernels.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    online_rec = online(torch)
    online_counts = kernels.launch_counts()
    mark("collectives to online tuner (7-9)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    moe_serving, engine = serve_moe(torch)
    moe_serve_counts = kernels.launch_counts()
    mark("MoE serving (10)")
    kernels.reset_launch_counts()
    moe_rec = moe_ep(torch, engine)
    moe_ep_counts = moe_rec.pop("counts")
    mark("expert parallelism (10b)")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    moe_smoke_reference(torch)
    mark("MoE smoke configs, card against CPU (10b)")
    kernels.reset_launch_counts()
    fault_rec = faults(torch, training["tuned_allreduce"])
    fault_counts = kernels.launch_counts()
    mark("faults (11)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    hybrid = serve_family(torch, "hymba-1.5b", HYBRID_PROMPT, "serve hybrid",
                          flash_per_pass=32,  # one attention a layer
                          flash_note=", beside 52 ms when the CUDA-core kernel took width 64 "
                                     "(PERF.md §5)")
    hybrid_counts = hybrid.pop("counts")
    kernels.reset_launch_counts()
    recurrent = serve_family(torch, "xlstm-350m", RECURRENT_PROMPT, "serve recurrent",
                             flash_per_pass=0)
    recurrent_counts = recurrent.pop("counts")
    family_smoke_reference(torch)
    mark("recurrent and hybrid serving (12)")
    kernels.reset_launch_counts()
    encdec = serve_family(torch, "whisper-large-v3", ENCDEC_PROMPT, "serve encdec",
                          flash_per_pass=0, after=lambda *a: cross_caches(torch, *a))
    encdec_counts = encdec.pop("counts")
    kernels.reset_launch_counts()
    mha = serve_family(torch, "qwen1.5-32b", MHA_PROMPT, "serve mha",
                       flash_per_pass=MHA_LAYERS, layers=MHA_LAYERS,  # one attention a layer
                       after=lambda *a: f8_decode(torch, *a))
    mha_counts = mha.pop("counts")
    assert mha["max_memory_allocated"] < 70 * 2**30, "phase 13b's depth cut leaves 70 GiB"
    encdec_mha_smoke_reference(torch)
    mark("encoder-decoder and MHA serving (13)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    hier = hierarchical(torch, training, serving)
    hier_counts = kernels.launch_counts()
    mark("hierarchical mesh (14)")
    gc.collect()
    torch.cuda.empty_cache()
    seq_counts = {}  # the tp_seq path: phase 18a-18d's runs inside phases 15-17
    tp, tp_counts = tensor_parallel(torch, serving, seq_counts)
    mark("tensor-parallel serving (15, 18a)")
    gc.collect()
    torch.cuda.empty_cache()
    tp_fam, tp_fam_counts = tp_families(torch, {"10": moe_serving, "4d": vlm, "13a": encdec},
                                        seq_counts)
    mark("tensor-parallel families (16, 18b, 18d)")
    gc.collect()
    torch.cuda.empty_cache()
    tp_rec, tp_rec_counts = tp_ssm(torch, {"12a": hybrid, "12b": recurrent}, seq_counts)
    mark("tensor-parallel recurrent and hybrid (17, 18c)")
    gc.collect()
    torch.cuda.empty_cache()
    tp8, tp8_counts = tp_m8(torch, {"15c": tp["long"], "16c": tp_fam["tp_encdec"],
                                    "17b": tp_rec["tp_recurrent"]})
    mark("a model axis of 8 (18e)")
    tp8["smoke_err"] = tp_layout_smoke(torch)
    mark("tensor-parallel layouts smoke, card against CPU (18f)")
    # each kernel on the path that runs it: the merge on the serving and
    # training paths (the MoE and vision-prefix trainings of phases 6m and 6v
    # and the four families' of 6f too) and the streams phase, the staging
    # copy on the serving paths and the streams phase, the quantize pair on
    # the training paths (6 and 6m), the device-initiated in-kernel replay
    # on the tuned serving path (phase 4b),
    # the collective entry points (phase 7) and in training, the sm90 flash
    # kernel on both long-prompt serving paths (phases 4c and 4d), the
    # CUDA-core one on phase 5's f32 long-prompt references; the merge also
    # on phase 7b's compiled routes and phase 9's arms, the in-kernel replay
    # on phase 7b's in-kernel ring, the staging copy on phase 8b's staged
    # trees, the quantize pair on phase 9's compressed arms; the merge and
    # the staging copy on the MoE serving path (phase 10), the merge, the
    # in-kernel replay and the sm90 flash kernel on the expert-parallel path
    # (phase 10b: its two prefills, the transports through the compiled and
    # the in-kernel executor); the merge, the in-kernel replay, the staging
    # copy and the quantize pair on the fault runtime (phase 11); the merge,
    # the staging copy on both phase-12 serving paths and both phase-13 ones,
    # and the sm90 flash kernel on the hybrid one (hymba-1.5b's prefill, bf16
    # at width 64) and the MHA one (qwen1.5-32b's, width 128, a group of 1;
    # whisper's attention stays dense under 4096 keys); mix and
    # scaled_add are on no path of either package; the merge, the staging
    # copy, the quantize pair and the in-kernel replay on the hierarchical
    # mesh's path (phase 14: its collectives, trainings and distributions); the
    # merge and the in-kernel replay on the model-axis training path (phase 6t:
    # its compiled and its in-kernel-table run's gathers) and on the other
    # families' (train_tp_fam, phase 6u: the compiled runs' gathers, mixtral's
    # table run's); the merge, the
    # staging copy and the sm90 flash kernel on the tensor-parallel serving path (phase 15:
    # its two distributions and the long prompt's prefills); the merge and the
    # staging copy on each of phase 16's three paths (tp_moe, tp_vlm, tp_encdec:
    # their distributions), the in-kernel replay on tp_moe (its table-routed
    # distribution) and the sm90 flash kernel on tp_vlm (paligemma's prefills on
    # the head-dim split); the merge and the staging copy on both of phase 17's
    # paths (tp_hybrid, tp_recurrent: their distributions) and the sm90 flash
    # kernel on tp_hybrid (hymba's prefills on the head-dim split); the merge,
    # the staging copy and the sm90 flash kernel on phase 18's two paths (tp_seq:
    # 18a's compiled distribution and the long prompts' prefills; tp_m8: xlstm's
    # two distributions on (2, 8) and minitron's prefills on 8 model ranks); and
    # the shared-buffer
    # replay on none of the port's (the reference, too, reaches it only off
    # its accelerator; phase 2 holds it at the path plans). A line's
    # ``launches`` are those of its last path.
    paths = {"fused_combine": ("tp_seq", "tp_m8", "tp_hybrid", "tp_recurrent", "tp_moe", "tp_vlm", "tp_encdec",
                               "train_tp", "train_tp_fam", "serve_tp", "hierarchical",
                               "serve_encdec", "serve_mha",
                               "serve_hybrid", "serve_recurrent",
                               "faults", "serve_moe", "moe_ep", "serve", "train", "train_moe",
                               "train_vlm", *family_counts, "algorithms", "online",
                               "streams"),
             "chunked_copy": ("tp_seq", "tp_m8", "tp_hybrid", "tp_recurrent", "tp_moe", "tp_vlm", "tp_encdec",
                              "serve_tp", "hierarchical", "serve_encdec", "serve_mha",
                              "serve_hybrid", "serve_recurrent",
                              "faults", "serve_moe", "serve", "serve_long", "serve_vlm", "trees",
                              "streams"),
             "quantize_blocks": ("hierarchical", "faults", "online", "train_moe", "train"),
             "dequantize_blocks": ("hierarchical", "faults", "online", "train_moe", "train"),
             "inkernel_replay": (),
             "inkernel_rdma": ("tp_moe", "train_tp", "train_tp_fam", "hierarchical", "faults", "moe_ep", "serve_tuned", "collectives", "algorithms",
                               "train"),
             "flash_attention_sm90": ("tp_seq", "tp_m8", "tp_hybrid", "tp_vlm", "serve_tp", "moe_ep", "serve_long", "serve_vlm", "serve_hybrid",
                                      "serve_mha"),
             "flash_attention": ("reference_long",),
             "mix": (), "scaled_add": ()}
    counts = {"serve": serve_counts, "serve_tuned": tuned_counts, "train": train_counts,
              "train_moe": train_moe_counts, "train_vlm": train_vlm_counts,
              "serve_long": long_counts, "serve_vlm": vlm_counts,
              "reference_long": ref_long_counts, "collectives": coll_counts,
              "algorithms": algo_counts, "streams": stream_counts, "trees": tree_counts,
              "online": online_counts, "serve_moe": moe_serve_counts, "moe_ep": moe_ep_counts,
              "faults": fault_counts, "serve_hybrid": hybrid_counts,
              "serve_recurrent": recurrent_counts, "serve_encdec": encdec_counts,
              "serve_mha": mha_counts, "hierarchical": hier_counts, "serve_tp": tp_counts,
              "train_tp": train_tp_counts, "train_tp_fam": train_tp_fam_counts,
              "tp_seq": seq_counts, "tp_m8": tp8_counts,
              **family_counts, **tp_fam_counts, **tp_rec_counts}
    assert long_counts["flash_attention"] == 0, long_counts
    assert vlm_counts["flash_attention"] == 0, vlm_counts
    assert hybrid_counts["flash_attention"] == 0, hybrid_counts
    assert recurrent_counts["flash_attention"] == recurrent_counts["flash_attention_sm90"] == 0
    assert encdec_counts["flash_attention"] == encdec_counts["flash_attention_sm90"] == 0
    assert mha_counts["flash_attention"] == 0, mha_counts
    assert tp_counts["flash_attention"] == 0, tp_counts
    for path, c in family_counts.items():  # training has no flash kernel
        assert c["flash_attention"] == c["flash_attention_sm90"] == 0, (path, c)
    # the sm90 kernel on the TP path's head shard (phase 15c's check)
    next(ln for ln in lines if ln["name"] == "flash_attention_sm90")["serve_tp_shard"] = \
        tp["long"]["flash_check"]
    for line in lines:
        if not paths[line["name"]]:
            assert line["name"] in ("mix", "scaled_add", "inkernel_replay"), line["name"]
            line["launches"], line["launches_by_path"] = 0, {}
            continue
        line["launches_by_path"] = {p: counts[p][line["name"]] for p in paths[line["name"]]}
        for p, k in line["launches_by_path"].items():
            assert k > 0, f"{line['name']} never launched on the {p} path"
        line["launches"] = line["launches_by_path"][paths[line["name"]][-1]]
    assert all(c["inkernel_replay"] == 0 for c in counts.values()), counts
    small_train_references(torch)
    mark("training references (6, 6m, 6v, 6f)")
    log(f"training numbers: {json.dumps(training)}")
    log(f"model-axis training numbers: {json.dumps(tp_training)}")
    log(f"model-axis family training numbers: {json.dumps(tp_fam_training)}")
    log(f"moe and vlm training numbers: "
        f"{json.dumps({'train_moe': moe_training, 'train_vlm': vlm_training})}")
    log(f"family training numbers: {json.dumps(family_training)}")
    log(f"collectives numbers: {json.dumps(colls)}")
    log(f"streams numbers: {json.dumps(stream_rec)}")
    log(f"calibrate numbers: {json.dumps(fits)}")
    log(f"algorithms numbers: {json.dumps(algos)}")
    log(f"trees numbers: {json.dumps(tree_rec)}")
    log(f"online numbers: {json.dumps(online_rec)}")
    log(f"moe numbers: {json.dumps({'serve_moe': moe_serving, 'moe_ep': moe_rec})}")
    log(f"faults numbers: {json.dumps(fault_rec)}")
    log(f"recurrent and hybrid numbers: "
        f"{json.dumps({'serve_hybrid': hybrid, 'serve_recurrent': recurrent})}")
    log(f"encoder-decoder and MHA numbers: "
        f"{json.dumps({'serve_encdec': encdec, 'serve_mha': mha})}")
    log(f"hierarchical numbers: {json.dumps(hier)}")
    log(f"tensor-parallel numbers: {json.dumps(tp)}")
    log(f"tensor-parallel family numbers: {json.dumps(tp_fam)}")
    log(f"tensor-parallel recurrent and hybrid numbers: {json.dumps(tp_rec)}")
    log(f"tensor-parallel model axis of 8 numbers: {json.dumps(tp8)}")
    check_trap(torch)
    mark("trap check")
    log("phase ends, s from the build's start: "
        + ", ".join(f"{name} {t:.1f}" for name, t in marks))
    print(json.dumps({"kernels": lines}))
    print(f"card: {name_power}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
