#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path (plain, speculative,
under the SLO scheduler, grammar-constrained, multi-tenant LoRA,
supervised, with a write-ahead log and cold-restart recovery, in a
serving cluster of supervised replicas, on the host KV tier), dense
decoding, Paddle fused-op decoder and training step on one NVIDIA
card.

    python3 chip_smoke.py                      # full run
    python3 chip_smoke.py --layers 2 --requests 4 --train-layers 2 \
        --train-steps 2                        # short check
    python3 chip_smoke.py --only 3h            # build, then phase 3h alone
    python3 chip_smoke.py --only 3i            # build, then phase 3i alone
    python3 chip_smoke.py --only 3j            # build, then phase 3j alone
    python3 chip_smoke.py --only 3k            # build, then phase 3k alone

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card and build: prints the card's name and power limit
   (``nvidia-smi``), then builds every CUDA kernel of ``paddle_tpu_torch``
   from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together) and prints the build time and ptxas's register report; the
   warp-specialised Hopper kernels (B1, B2 and B3 in bf16, D = 64 and
   128: six) must enter with the launch bound's 168 registers, or
   nothing is launched (``hopper_ptxas``), and every bf16 B11
   instantiation (the prefill wgmma and the verify key-split kernels)
   and every instantiation of the key-split decode kernel
   (``csrc/paged_split.cuh``: four for B8, four for B7's dense cache,
   which must not spill, eight for B9/B10) is listed with its registers
   and spills (``ptxas B11``, ``ptxas B8``, ``ptxas B7``, ``ptxas
   B9/B10``).
2. Kernel vs plain: B9 (ragged paged decode), B10 (fused RoPE paged
   decode) and B11 (flash chunk prefill), each with bf16 and int8 KV, at
   the serving shapes (H = HK = 32, D = 128, page 16, B = 8 rows of
   mixed lengths up to 2048 with one of length 1; T = 256 chunks at
   several context caps), and B11 at the speculative verify shapes
   (B = 8 rows of ragged contexts against ctx_cap + T columns): linear
   at T = 5 (``spec_k=4``, ctx_cap 1024 and 2048) and tree (B11-tree)
   at T = 9 under the (2, 4) comb tree, bf16 and int8 rows, where a
   planted fault (one ancestor bit of a depth-2 node cleared) must fail
   the row check and a chain tree must give B11-linear's bits; and B11
   under GQA (H = 32, HK = 8, ctx_cap 2048) at T = 256 and at the linear
   verify's T = 5, bf16 and int8 rows. B9 and B10 read a token-major
   pool whose bf16 slots past each row's length and page 0 are NaN,
   through tables with -1 past each row's pages (the plain versions
   read a NaN-free copy); NaN must not reach the output, and the plain
   version without the longest row's last 64 keys must fail the row
   check. They are also run where the key split rule splits (one row of
   4,096 tokens: 8 splits; the ragged rows under GQA, HK = 8: 4), and
   at every shape with 1, 2, 4 and 8 splits forced, each held to the row
   rule and timed; at the two splitting shapes the rule's choice fails
   unless it is 10% faster than one split (``check_decode``). Each
   kernel's output is held against its
   plain PyTorch version on the same inputs within the stated bf16
   tolerance, and timed with CUDA events beside its plain version, one
   PyTorch library call computing the same function
   (``scaled_dot_product_attention`` on the pre-gathered cache) and the
   card's bound for the work. Then B1-B3 (flash attention forward and
   its two backward passes) at the training shape (B = 4, S = 4096,
   H = 12, D = 128, causal), at the same length with D = 64 (H = 24)
   and at ten ragged ones (Sq != Sk both ways, lengths that are not
   multiples of 64), each against its plain version and against a
   planted fault the check must reject (``check_flash``); the two long
   shapes are timed beside SDPA's forward (B1) and backward (B2, B3:
   fwd + bwd - fwd, one call for all three gradients), with TFLOP/s and
   the share of the bound. Then
   B4a/B4b (fused RMSNorm forward and backward) and B5a/B5b (fused
   SwiGLU) at the training shape (N = 16384 rows, h = 1536, i = 4096,
   bf16), at Llama-2-7B widths (h = 4096, i = 11008) and at a ragged
   row count in f32 (N = 1003, h = 5120, i = 13824), each row against
   its plain version and against its planted fault (``check_fused``);
   the training shape is timed beside ``F.rms_norm``. Then B7 (decode
   attention against a contiguous cache) in bf16 and int8 at the
   Llama-2-7B dense decode shape (B = 8, H = HK = 32, D = 128, S = 2048,
   mixed lengths with one of 1) and at the JAX bench model's (H = HK =
   12, S = 192), and where the key split rule splits (one row of 4,096;
   GQA, HK = 8, over the mixed lengths), on a layer view of a two-layer
   cache whose columns past each row's length are NaN, row by row
   against the plain version on a clean copy, with a planted fault (the
   longest row's last 64 live keys dropped) that must fail, timed beside
   SDPA under a boolean length mask and the bound, and swept over forced
   1/2/4/8 key splits, each within the row limit, the rule's choice 10%
   faster than one split where it splits (``check_dense_decode``). Then B6 (fused RoPE)
   on q and k cut as strided views from one qkv tensor, at the
   Llama-2-7B prefill shape (B = 8, S = 1024, H = HK = 32, D = 128,
   bf16) and a ragged GQA one in f32 (S = 1003, H = 32, HK = 8, D = 64),
   forward and backward (sign -1), row by row against the plain version
   (FUSED_RTOL) with a planted fault (the sign of sin flipped), the
   forward timed beside the plain version and the bound
   (``check_rope``); and B8 (decode attention over a head-major page
   pool) at the Llama-2-7B decode shape with page 64, in bf16 and int8
   with (B, HK) and (HK,) scales, NaN past every row's length, -1 past
   its pages, row by row against the plain version with a planted fault
   (the longest row's last 64 keys dropped), timed beside the plain
   version, SDPA and the bound, and the same at the Paddle decoder's
   shape (8 equal rows of 1,056 tokens in 17 pages; bf16 and (B, HK)
   int8), and where the key split rule splits: one row of 4,096 tokens
   (8 splits) and the ragged rows under GQA (HK = 8, 4 splits); every
   shape but the (HK,) one is also run with 1, 2, 4 and 8 splits forced
   (each held to the row rule, each timed), and at the two splitting
   shapes the rule's choice fails unless it is 10% faster than one
   split (``check_paged_hm``).
3. The engine at Llama-2-7B width and a quarter of its depth (8
   layers; the script's time limit holds every phase but 3d, at 16,
   there), random
   weights from a seeded generator: ``max_batch=8, page_size=16,
   max_len=2048, prefill_chunk=256`` serving the request set in four
   tiers, KV {bf16, int8} x fused {off, on}. Per tier the launch
   counters are zeroed just
   before ``run()`` and read just after, and must equal the counts the
   tier's path implies; every request must finish with its token count;
   one request's prompt and output are fed back through the kernel-free
   prefill and its logits held against the kernel decode step's. Then
   ``torch.profiler`` traces a few prefill chunks and decode steps of
   the bf16 KV, fused tier and splits the card's kernel time into the
   attention kernels, matmuls and the rest, against the host's wall time.
   Then speculation (all fused): n-gram ``spec_k=4``
   on the same weights and requests; then, with ``wo`` and ``wd`` of the
   layers past the draft's depth damped by 1e-3 (the JAX bench's
   alignment, so that acceptance is real) and non-repetitive prompts, a
   plain tier and a draft-tree tier (``draft_layers = L / 2``,
   ``spec_tree=(2, 4)``) for KV bf16 and int8. Per tier the launch
   counters must equal what its counted forwards imply (B11-tree only
   in the tree tiers), every request must finish, both pools must
   drain and a draft tier's acceptance must be over 0.3; tokens/s, ms
   per step by kind, acceptance, tokens committed per row and verify,
   peak memory and the share of tokens equal to the comparison tier's
   are recorded (bf16 kernels may split near-ties, so that share is
   reported, not gated: identity is gated on the CPU), beside the same
   shares between the plain tiers with and without the fused kernels.
   Last, ``torch.profiler`` traces a few draft-tree steps and splits
   them into proposal and verify on the host clock.
3e. The SLO scheduler (``ServingScheduler``) over the engine at the
   same width and a quarter of the depth (8 layers), fresh weights from
   phase 3's seed,
   budget 384:
   phase 3's 16 requests as alternating NORMAL and LOW, then after 8
   steps four HIGH requests of 512 prompt tokens and 32 new, each
   admitted by preempting a LOW one; KV bf16 and int8 with the fused
   kernels and bf16 without, each synchronous and ``overlap=True`` (bf16
   fused in turns: sync, overlap, overlap, sync); a no-budget,
   no-burst set in the same turns, which must be token-identical; an
   overlapped n-gram run (``spec_k=4``) and a short plain one with every
   ``decode_dispatch``, ``spec_dispatch`` and ``prefill_dispatch`` under
   ``torch.cuda.set_sync_debug_mode("error")``; ``torch.profiler``
   windows of 8 decoding rows in the same turns (``device_breakdown``).
   Per run: every request finishes, no plan over the budget, the
   allocator balanced after the drain, a burst run preempts and resumes,
   launches equal the counted forwards (B10 or B9 per decode, B11 per
   fused prefill chunk and verify); ms a step, tokens/s,
   ``host_frac_ema``, the host split into dispatch, commit and the
   scheduler's own work, and the greedy-token agreement of each burst
   run with its synchronous twin (bf16 fused also with the no-budget
   run, the same requests uninterrupted), beside phase 3's
   fused-vs-unfused yardstick (``run_scheduler``).
3f. Grammar-constrained serving under the scheduler at the engine's
   width and a quarter of its depth (8 layers), fresh weights from
   phase 3's seed, eos id 2: over a seeded synthetic table of 32,000
   token strings (``synthetic_vocab``; there is no tokenizer), a
   tool-call JSON schema
   (``json_schema_dfa``), a menu of 16 token sequences
   (``dfa_from_sequences``) and a comma-list regex (``dfa_from_regex``),
   each with its compile seconds and table MB (``grammar ...`` lines).
   Phase 3's 16 prompts with 64 new tokens each, 8 carrying the JSON
   grammar, 4 the menu, 4 free, as alternating NORMAL and LOW. An
   identity gate without budget or burst, in turns: a free run on a
   ``constraints=False`` engine; each request under a DFA of its own
   free-run tokens, synchronous and overlapped; all requests free on a
   ``constraints=True`` engine; the free run overlapped: all
   token-identical. Burst runs (budget 384, phase 3e's HIGH burst) for
   KV bf16 and int8 fused, synchronous and overlapped, and bf16 unfused
   synchronous. An overlapped run of 8 requests (4 JSON with 256 new
   tokens, 2 list, a menu, a free one), sampled at temperature 0.9, with
   every dispatch, the mask upload included, under the sync debug mode.
   ``torch.profiler`` windows of 8 decoding rows, free and
   JSON-constrained. Per run: every constrained request's tokens walk
   its DFA on the host (``walk``), eos-ended JSON decodes through the
   table to an object with the schema's keys and types (at least one in
   the sync-checked run), an eos-ended menu request emitted one menu
   sequence, a burst run preempts (and resumes) a constrained request,
   the allocator balances, launches equal the counted forwards; ms a
   step, tokens/s, the host ms a step of the DFA work and of the mask
   upload, mask uploads against decode steps (``constrained ...`` lines,
   ``run_constrained``).
3i. The multi-tenant adapter pool (``adapters=``: 4 slots of rank 16,
   six random q/o adapters from phase 3's seed, ``init_lora`` at scale
   0.04) on the engine at the same width and a quarter of the depth (8
   layers), fresh weights from phase 3's seed, fused, KV bf16 and int8.
   Gates: (a) phase 3's first 8 requests (48 new tokens at most) served
   as base rows on an engine with the pool are token-identical to an
   engine without it; (b) four rows on adapters 1-4 prefill through B11
   and decode one step through B10 with the pool's LoRA term, each
   row's prefill and decode logits within 0.25 of the plain chunk
   composition on weights with that adapter dense-merged
   (``merge_lora``), and the same decode with rows 0 and 1's slots
   swapped (a planted fault) must fail it; (c) the 8 requests on
   adapters 1-4 differ from the base rows' tokens in at least 25% of
   positions; (d) phase 3e's requests and HIGH burst on adapters 0-6
   under the scheduler (budget 384, a RAM host store below the pool),
   bf16 and int8: LRU reclaim demotes and promotes, each promotion's
   CRC checked; the same run with the first promoted payload corrupted
   falls back once, counted, with the same tokens; four NORMAL rows
   pinning every slot beside four LOW base rows make a NORMAL request
   on a fifth adapter wait, with no preemption; (e) launches equal the
   counted forwards (B10 per decode, B11 per prefill chunk and, under
   n-gram ``spec_k=4``, per verify); (f) pins and allocators balance
   after every drain, and an overlapped run holds every dispatch and
   every pool install to the sync debug mode. Reported: ms a decode step
   of 8 rows (4 on adapters) without a pool, with one (the factor
   gather once a forward) and with the gather per layer, in turns
   (none, forward, layer, twice), the first three profiled; install,
   demote and promote ms and bytes, from RAM and from a standing store
   on local disk (``adapters ...`` lines, ``run_adapters``).
3j. The write-ahead log (``EngineSupervisor(wal_dir=...)``) on phase
   3e's engine with ``host_tier=True`` at the same width and a quarter
   of the depth (8 layers), fresh weights from phase 3's seed, phase
   3e's 16 requests and HIGH burst, fused, budget 384, the log in a
   temporary directory on local disk. Gates: (a) the process dies (the
   supervisor dropped without a drain) at decode_step, prefill_chunk,
   commit, swap_in, wal_append (a torn write), wal_fsync and
   checkpoint_write, each at the middle of the site's calls in an
   uninterrupted run (bf16; int8 KV at decode_step and wal_append), and
   ``recover_from_disk`` rebuilds it: no request lost or duplicated,
   every token on disk at the death kept (``check_recovery``), the torn
   tail counted, a flight dump a death, allocators balanced; (b) a
   recovery whose journal drops one committed token is rejected; (c) a
   bit flipped in a mid-log segment and a checkpoint claiming an lsn the
   log never reached are quarantined and counted, and nothing past them
   is installed; (d) a checkpoint every 16 steps prunes segments and
   keeps the directory under 1 MiB; (e) ``checkpoint_prefix=True``:
   after a cold restart every prompt's chain matches, its pages
   byte-equal to the checkpointed ones, and the system prompt hits 192
   tokens; (f) launches equal the counted forwards (B10 per decode, B11
   per prefill chunk, replays included), and an overlapped run with the
   log holds every dispatch to the sync debug mode. Reported: ms a step
   with the journal off, ``"group"``, ``"commit"`` and ``"off"`` in turns
   (twice), the supervisor's host ms after each step (journal and
   log), the log's host ms, bytes and frames a step, fsync ms; each
   recovery's scan, engine build, install and replay ms against resident
   tokens and replayed records; checkpoint ms, bytes and the stall in
   its step, with and without the trie's pages; token agreement with
   the uninterrupted run (``wal ...`` lines, ``run_wal``).
3k. The serving cluster (``ServingCluster``: supervised replicas of
   phase 3j's engine, fused, the host tier on, behind the
   ``ClusterRouter``) at the same width and a quarter of the depth (8
   layers), one params dict from phase 3's seed shared by every
   replica, phase 3e's 16 requests over four tenants, each prompt on
   its tenant's own 192-token system prompt (12 pages), budget 384.
   Gates: (a) routed over 2 replicas and over one (KV bf16 and int8),
   each tenant's first request first: every request finishes once with
   its count, no rid lost or doubled and none running on two replicas
   at once (``check_cluster_handles``), every replica's allocator
   balanced, and on 2 replicas each tenant's later requests on its
   bound replica, each sharing 192 prefix tokens or more there; (b) 3
   replicas, the first a prefill replica, host-staged and
   ``direct_handoff=True``, the hooks on: the first handoff's
   decode-side pages byte-equal the exported payload (staged) or the
   prefill replica's pages (direct) (``check_pages_bytes``), the
   hooks' import counter equals ``handoffs_total`` and the export
   counter the exports (each counted once), staged a tampered second
   export is caught by the CRC with its request still on the prefill
   replica and an armed third import is retried; (c) 3 replicas,
   ``circuit_threshold=2``: once every request holds a token, the
   busiest replica swaps a session out and its next step fails until
   its circuit opens; the cluster fails over, the swapped session
   swaps in on a survivor, the rest replay; ten steps later a tenant's
   bound replica is retired mid-decode, and the tenant's next prompt
   shares 192 tokens on the replacement's restored trie; (d)
   ``synth_trace`` (four tenants on 12-page system prompts, tails of
   32-256 tokens, 16-64 new, 6 virtual s at 6 requests/s with one
   burst) through ``run_trace`` under a ``FakeClock``: one prefill
   replica, an autoscaled decode tier (1 to 3), an
   ``AdmissionController``, a ``TenantQuota`` on one tenant,
   ``overlap=True``, every dispatch under the sync debug mode and any
   failed replica step fatal: nothing lost or doubled, at least one
   scale-up, one scale-down and one ``rejected_ratelimit``; (e) 2
   replicas with ``wal_dir`` on local disk: a failover (the failed-over
   replica's directory then recovers only sessions it owns), then a
   process death (``crashy``), the cluster object dropped and
   ``ServingCluster.recover_from_disk``: every request finishes once,
   the tokens on disk a prefix of the final ones; (f) in every run the
   launches equal the forwards of every engine built (B10 a decode, B11
   a prefill chunk, replays included). Reported: ms a cluster step, the
   router's and the handoffs' host ms a step, tokens/s, a profiled
   window's card busy and idle share (bf16, 2 replicas and one),
   token agreement with the one-replica run, handoff ms, pages and
   bytes (staged and direct), failover ms and replayed tokens, retire
   ms and drain bytes, the ``SLOReport``, the restart's scan, build and
   install ms against resident tokens (``cluster ...`` lines,
   ``run_cluster``).
3g. Supervised serving (``EngineSupervisor`` over the engine) at
   Llama-2-7B's width and a quarter of its depth (8 layers), fresh
   weights from
   phase 3's seed, phase 3e's 16 requests and HIGH burst, budget 384:
   an uninterrupted run; one run per engine site the port has with a
   ``raise`` fault at the middle of that site's calls in the
   uninterrupted run of the same engine (alloc, free, decode_step,
   prefill_chunk, transfer, sched_tick; dispatch and commit
   overlapped; verify_step under n-gram ``spec_k=4``; draft_propose
   and tree_verify on phase 3's damped draft-tree engine,
   ``draft_layers = L / 2, spec_tree=(2, 4)``, each engine after its own
   uninterrupted run); ``corrupt`` at transfer; a stall past a 5 s
   watchdog at decode_step; a drain to a file at the middle of the run
   and a restore, then a new request on the shared system prompt. Per
   run: every request finishes, launches equal the forwards of every
   engine the run built, the allocator balances (the drained engine's
   too), one recovery per armed fault counted under its site label
   (``serving_fault_injected_total``), each request's tokens committed
   before the fault a prefix of what the journal restored and that a
   prefix of its final tokens (``check_recovery``), and after the
   restore the new request hits the restored prefix trie (192 tokens
   or more). A run whose recovery's journal drops one committed token
   must be rejected by that check. Reported, not gated: each run's
   share of tokens that agree with its engine's uninterrupted run
   (bf16 replays rebuild the KV through B11 where the uninterrupted
   run wrote it through B10, so a near-tie may split), recovery ms and
   replayed tokens. Then eight requests overlapped with every dispatch
   under the sync debug mode, observability hooks (metrics and request
   tracing) off, on, on, off, with ms a step and the host ms of the
   dispatch and commit halves (``supervised ...`` lines,
   ``run_supervised``). The drain's restore reports the host ms of its
   page scatter by part (read, pin, copy).
3h. The host KV tier (``host_tier=True``) at Llama-2-7B's width and
   a quarter of its depth (8 layers; ``--only 3h``: all 32), fresh
   weights from
   phase 3's seed. Resume
   turns: eight requests decoding, the one nearest 600 tokens preempted
   and resumed by replay, swap, swap, replay, KV bf16 and int8, each
   turn timed between card synchronizations (swap-out and swap-in ms
   and bytes, the swap-in's host time by part, replay ms and tokens);
   the swapped-in pages must be byte-equal to the swapped-out ones.
   Phase 3e's burst runs (16 requests, four HIGH, budget 384, fused)
   without and with the host tier in turns (bf16 off, on, on, off;
   int8 off, on), with metrics on: every swap counted once (by the
   cache, the hooks and a wrapper), every swapped victim resumed once,
   the first two swap-ins byte-equal, launches equal the counted
   forwards, the allocator balanced; one overlapped with every dispatch
   and every ``preempt_request`` (where the swap-out is queued) under
   the sync debug mode; one whose first swap-in finds a planted corrupt
   payload, which must end in a counted ``corrupt`` fallback to replay.
   Demote / promote on an 80-page pool (the system prompt's 192 tokens
   hit again after their pages were demoted), a restart on a standing
   store on local disk (12 pages promoted, 192 tokens hit), a request
   handed from a prefill engine to a decode engine on the same weights,
   host-staged and page to page (pages byte-equal, tokens equal to
   in-place decode), and ``defrag`` (live pages byte-equal,
   fragmentation 0, tokens equal to the same script without it)
   (``host_tier ...`` lines, ``run_host_tier``).
3c. Dense decoding (``generate``, ``beam_search``,
   ``precompute_prompt_cache``) at the same width and a quarter of the
   depth (8 layers), fresh
   seeded weights: the JAX bench's decode tier (B = 8, prompt 128, 64
   new, greedy) for weights {bf16, int8, int4} x KV {bf16, int8}; a
   long tier (prompt 1920, 128 new), with its own profile; beam search (B = 2, 4 beams, 32
   new); a shared 200-token prompt cache; a left-padded batch. Per tier
   decode tokens/s net of the prefill (``bench.py``'s ``decode_rate``),
   ms per decode step, peak memory, and the launch counters, zeroed
   just before the timed calls and read just after: B7 L * (new - 1)
   per call, none in the left-padded tier. Each bench tier's decode
   logits through B7 are held within 0.25 of the plain composition's
   (``use_kernel=False``), and ``torch.profiler`` splits the bf16 and
   int8-weight decode steps into B7, matmuls, dequantization and the
   rest (``run_dense``).
3d. The Paddle fused-op decoder (``paddle_decoder``): a Llama-2-7B
   decoder at half its depth (16 layers) written against
   ``paddle_tpu_torch.incubate.nn.functional`` (``fused_rms_norm``,
   ``fused_rotary_position_embedding``, ``block_multihead_attention``,
   ``swiglu``) around ``torch.matmul`` projections, fresh seeded
   weights, B = 8 prompts of 1024 tokens, one batched prefill, 64 greedy
   new tokens, pages of 64, KV bf16 and int8 (dynamic (B, HK) scales
   from the prefill's amax). Per tier the launch counters are zeroed
   after the prefill and read after the decode: per layer and step B6
   twice, B8 once, B4a twice (and once for the final norm), B5a once;
   each step's logits within 0.25 of ``generate``'s cached forward on
   the same tokens; decode tokens/s, ms a step, peak memory, the share
   of greedy tokens that forward picks; then a ``torch.profiler`` split
   of a few decode steps into B6, B8, B4a/B5a, matmuls and the rest
   (``run_paddle_decoder``).
3b. Training: ``make_train_step`` on the JAX bench's training model
   (20 layers, hidden 1536, seq 4096, batch 4, ``seq_chunk=512``), once
   with ``fused_kernels="xla"`` and once with "auto" (RMSNorm and SwiGLU
   through B4/B5), each 2 warm-up and 5 timed steps with the launch
   counters zeroed just before the timed steps (per layer and step B1
   twice, as backward recomputes the checkpointed layer, B2 and B3 once;
   under "auto" also B4a four times, B4b twice, B5a twice and B5b once,
   and B4a and B4b once more for the final norm); tokens/s, MFU, peak
   memory and the losses, which must be finite and fall; a
   ``torch.profiler`` split of one step and the card time of the
   optimizer's part alone (``update_ms``); then, for each mode, the
   whole-slice check (``whole_slice``) of a 2-layer model in bf16 on the
   card against f32 on the CPU.
4. The ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Exits with 1 and prints no result when no CUDA card is visible. A JSON
record of the run goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores
SLEEP_CYCLES = 20_000_000      # ~10 ms of the card's clock (time_ms)
# Every attention kernel against its plain version, row by row (a row is
# one D-vector: a query's output or dQ, a key's dK or dV):
#     |kernel row - plain row| <= ROW_RTOL * |plain row| + ROW_FLOOR * rms
# with rms the root mean square of the plain tensor's row norms. Rows
# shrink with their context (an output row of a query that sees t keys
# of N(0, 1) values has norm ~ sqrt(D / t)), so the limit follows each
# row and not the tensor's largest values. The kernels round their
# outputs to bf16 (2^-9 relative) and p and ds to bf16 before the
# products, as the TPU kernels do; on an H100 the worst rows of B1-B3
# and B9-B11 read 0.3-0.6% of their norms. The floor only admits rows
# that cancel to zero up to f32 rounding (dQ of the first query, dK and
# dV of keys no query sees). A flash kernel that skips its last key
# tile moves the late rows by 50-100%: check_flash plants that fault in
# the plain versions and fails unless the check rejects it.
ROW_RTOL, ROW_FLOOR = 2e-2, 1e-4
# B4a-B5b (fused RMSNorm and SwiGLU) round one f32 result once, as their
# plain versions do, so a bf16 row differs from its plain row by at most
# one bf16 ulp an element (2^-7 of the element): the row check's share
# is 2^-7 (f32: 1e-5, the same math summed in another order), with the
# same floor; dw is held as one vector. Planted faults, each of which
# the check must reject: B4a with eps ten times too large (the inputs'
# row scales spread over 1e-3..7, so eps matters in the small rows), B4b
# without the last CTA's dw partial, B5a with g and u swapped, B5b with
# dsilu = sigmoid(g).
FUSED_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
FAULT_TILE = 64                # keys dropped by the planted fault
LOGITS_ATOL = 0.25             # bf16 through 32 layers, logits ~ N(0, 1)
# flash B1's lse against the plain forward in f32 from the same bf16
# inputs: both f32 (~9 at S = 4096, ulp 1e-6), summed in other orders
LSE_ATOL = 1e-5
# whole-slice check: a 2-layer full-width model in bf16 on the card
# against f32 on the CPU from the same parameters, relative errors of
# the loss, the gradient norm, and each layer's wq, wk and wv gradient
# (the leaves that only the flash backward feeds; bf16 gradients through
# two layers of bf16 activations). Two planted attention faults on the
# CPU side (attention output zero; last key tile skipped) must fail it.
SLICE_LOSS_RTOL, SLICE_GNORM_RTOL, SLICE_LEAF_RTOL = 2e-4, 5e-3, 4e-2
ATTN_LEAVES = ("wq", "wk", "wv")
# under fused_kernels="auto" the check also holds the leaves that the
# fused RMSNorm and SwiGLU feed, which read as the attention's do (1-2%
# per layer on an H100), to the same limit; the CPU side with a planted
# B4 fault (eps ten times too large) and one in B5 (dsilu = sigmoid)
# must fail it
FUSED_LEAVES = ("attn_norm", "mlp_norm", "wg", "wu")
REPO = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _template_args(mangled: str) -> str:
    """The template arguments of a mangled kernel name, readable:
    ``13__nv_bfloat16Li128ELb0ELi1E`` -> ``bf16, 128, false, 1``."""
    out = []
    while mangled:
        if mangled.startswith("13__nv_bfloat16"):
            out.append("bf16")
            mangled = mangled[15:]
        elif mangled[0] in "af":
            out.append("int8" if mangled[0] == "a" else "float")
            mangled = mangled[1:]
        else:
            m = re.match(r"L([ib])(\d+)E", mangled)
            if not m:
                break
            v = m.group(2)
            out.append(v if m.group(1) == "i" else
                       ("true" if v == "1" else "false"))
            mangled = mangled[m.end():]
    return ", ".join(out)


def ptxas_report(log_text: str, kernels: str) -> list:
    """ptxas's report (``-Xptxas -v``) of the kernels in a build log whose
    names match the regex ``kernels``: registers, spills, and whether
    ptxas serialized their wgmma instructions."""
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if re.search(kernels, m.group(1)) else None
            if cur:
                out.setdefault(cur, {"serialized": False})
            continue
        m = re.search(r"serialized .*function '(\S+)'", line)
        if m and re.search(kernels, m.group(1)):
            out.setdefault(m.group(1), {"serialized": False})
            out[m.group(1)]["serialized"] = line.split("due to")[-1].split(
                " for the function")[0].strip()
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    recs = []
    for mangled, r in out.items():
        recs.append(dict(r, kernel=_kernel_name(mangled)))
    return recs


def _kernel_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled kernel: the identifier
    ending in ``_kernel`` whose length prefix matches it (an anonymous
    namespace's hash may run digits into that prefix)."""
    for m in re.finditer(r"(?=(\d+)[a-z_])", mangled):
        st = m.start() + len(m.group(1))
        ident = mangled[st:st + int(m.group(1))]
        rest = mangled[st + len(ident):]
        if ident.endswith("_kernel") and rest.startswith("I"):
            args = re.match(r"I(.*?)EEv", rest)
            return (f"{ident}<{_template_args(args.group(1))}>" if args
                    else ident)
    return mangled


def hopper_ptxas(log_text: str) -> list:
    """ptxas's report of the warp-specialised Hopper flash kernels
    (``*_wgmma_kernel``). The entry count must be the launch bound's 168
    (384 threads, one CTA an SM): the consumers' ``setmaxnreg.inc`` to
    240 takes the registers the producer's ``setmaxnreg.dec`` to 24 gives
    up, and no more."""
    return ptxas_report(log_text, r"_wgmma_kernel")


def bound_ms(nbytes: float, flops: float, rate: float = BF16_FLOPS_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Card ms of one ``fn()``: CUDA events around ``reps`` calls, queued
    behind a sleep kernel of ~10 ms, so that the host has queued every
    call before the first starts and the events time the card, not the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def row_ratio(torch, got, want, rtol: float = ROW_RTOL) -> float:
    """The worst row of ``got`` against ``want`` as a share of its limit
    (``rtol`` and ROW_FLOOR above); the check passes at <= 1, and a NaN
    fails it."""
    g, w = got.float(), want.float()
    ref = w.norm(dim=-1)
    lim = rtol * ref + ROW_FLOOR * ref.square().mean().sqrt()
    return ((g - w).norm(dim=-1) / lim).max().item()


def check_close(torch, got, want, what: str, rtol: float = ROW_RTOL):
    """Fail unless every row of ``got`` is within its limit of ``want``;
    returns (max abs error, worst row's share of its limit)."""
    ratio = row_ratio(torch, got, want, rtol)
    err = (got.float() - want.float()).abs().max().item()
    if not ratio <= 1.0:
        fail(f"{what}: worst row at {ratio:.3g} of its limit ({rtol} * "
             f"|plain row| + {ROW_FLOOR} * rms); max abs err {err}")
    return err, ratio


# ---------------------------------------------------------------- phase 2
RAGGED_LENS = (1, 2048, 1537, 700, 1024, 333, 2000, 64)


def decode_inputs(torch, kv_int8: bool, seed: int, lens=RAGGED_LENS,
                  pps: int = 128, HK: int = 32):
    """B9/B10's arguments at the engine's decode shape: B = len(lens)
    rows (by default mixed lengths 1 ... 2048) in tables of ``pps`` pages
    of 16 over a shuffled token-major (P, 16, HK, 128) pool, H = 32, -1
    past each row's pages; int8 pages with per-token scales. bf16 pools
    hold NaN in every slot past each row's length and in page 0 (where -1
    entries point); ``clean`` holds the same pools with the NaN cleared,
    for the plain versions and SDPA (which multiply NaN by zero weights)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, D, page = len(lens), 32, 128, 16
    P = 1 + B * pps
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1).reshape(
        B, pps).to(torch.int32)
    live_pages = (lens.long() + page - 1) // page
    bt[torch.arange(pps, device="cuda")[None, :] >= live_pages[:, None]] = -1
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    shape = (P, page, HK, D)
    if kv_int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:3], generator=g, device="cuda") * 0.02
                  + 0.005 for _ in range(2))
        clean = (kp, vp)
    else:
        kp, vp = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        ks = vs = None
        clean = (kp.clone(), vp.clone())
        pos = torch.arange(pps * page, device="cuda")
        for b in range(B):
            pages = bt[b].long().repeat_interleave(page)
            tail = (pos >= lens[b].long()) & (pages >= 0)
            for t in (kp, vp):
                t[pages[tail], pos[tail] % page] = float("nan")
        kp[0] = vp[0] = float("nan")
    return dict(q=q, k_pages=kp, v_pages=vp, block_tables=bt, lengths=lens,
                ks_pages=ks, vs_pages=vs, clean=clean, live_pages=live_pages)


def check_decode(torch, F, kernels, fused: bool, kv_int8: bool, seed: int,
                 lens=RAGGED_LENS, pps: int = 128, HK: int = 32,
                 sweep: bool = False):
    """B9 (B10 with ``fused``: q rotated at each row's position in the
    kernel) on ``decode_inputs``: row by row against the plain version on
    the clean pools; NaN must not reach the output; the plain version
    without the longest row's last FAULT_TILE keys must fail the check.
    Timed beside the plain version, SDPA under a boolean length mask on
    the cache gathered and dequantized beforehand (kv heads repeated under
    GQA; B10's q rotated beforehand) and the bound (the live K and V rows,
    their scales and table entries, q, the output, the cos/sin rows).
    ``sweep`` also runs the kernel with each key split count forced
    (``split_ms``), each held to the same row rule."""
    from paddle_tpu_torch.models.llama import rope_tables
    pa, sf = kernels.paged_attention, kernels.serving_fused
    x = decode_inputs(torch, kv_int8, seed, lens, pps, HK)
    q, kp, vp, bt, lens = (x["q"], x["k_pages"], x["v_pages"],
                           x["block_tables"], x["lengths"])
    ck_pool, cv_pool = x["clean"]
    B, H, D = q.shape
    page = kp.shape[1]
    kw = dict(ks_pages=x["ks_pages"], vs_pages=x["vs_pages"])
    what = f"{'B10' if fused else 'B9'} kv_int8={kv_int8} HK={HK}"
    rope = {}
    if fused:
        cos, sin = rope_tables(pps * page, D, 10000.0, device="cuda")
        pos = (lens - 1).long()
        rope = dict(cos_row=cos[pos], sin_row=sin[pos])

    def kern():
        if fused:
            return sf.fused_paged_decode_attention(
                q, rope["cos_row"], rope["sin_row"], kp, vp, bt, lens, **kw)
        return pa.paged_attention(q, kp, vp, bt, lens, **kw)

    def plain(n=lens):
        if fused:
            return sf.fused_paged_decode_plain(
                q, rope["cos_row"], rope["sin_row"], ck_pool, cv_pool, bt, n,
                **kw)
        return pa.paged_attention_plain(q, ck_pool, cv_pool, bt, n, **kw)

    out_k = kern()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        fail(f"{what}: NaN past the lengths reached the output")
    out_p = plain()
    err, ratio = check_close(torch, out_k, out_p, what)
    bad = lens.clone()
    longest = int(torch.argmax(lens))
    bad[longest] -= FAULT_TILE
    fault = row_ratio(torch, out_k, plain(bad))
    if not fault > 1.0:
        fail(f"{what}: the check passes the plain version without the "
             f"last {FAULT_TILE} keys of row {longest} (worst row at "
             f"{fault:.3g})")
    # library yardstick: SDPA over the clean cache gathered and
    # dequantized beforehand (outside the timed call)
    ck = pa.gather_pages(ck_pool, bt)
    cv = pa.gather_pages(cv_pool, bt)
    if kv_int8:
        ck = (ck.float() * pa.gather_pages(kw["ks_pages"], bt)[..., None]
              ).bfloat16()
        cv = (cv.float() * pa.gather_pages(kw["vs_pages"], bt)[..., None]
              ).bfloat16()
    K = ck.permute(0, 2, 1, 3).repeat_interleave(H // HK, 1).contiguous()
    V = cv.permute(0, 2, 1, 3).repeat_interleave(H // HK, 1).contiguous()
    mask = (torch.arange(K.shape[2], device="cuda")[None, :]
            < lens[:, None].long())[:, None, None, :]
    ql = (sf.rotate_q_plain(q, rope["cos_row"], rope["sin_row"]) if fused
          else q)[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(ql, K, V, attn_mask=mask)

    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=5, warmup=1)
    lib_ms = time_ms(torch, lib)
    n_tok = int(lens.sum().item())
    esz = 1 if kv_int8 else 2
    nbytes = (2 * B * H * D * 2                       # q in, out
              + 2 * n_tok * HK * D * esz              # live K and V rows
              + (2 * n_tok * HK * 4 if kv_int8 else 0)  # token scales
              + int(x["live_pages"].sum().item()) * 4 + B * 4  # table, lens
              + (2 * B * (D // 2) * 4 if fused else 0))  # cos/sin rows
    b_ms, b_by = bound_ms(nbytes, 4 * n_tok * H * D)
    rec = dict(shape=what, B=B, H=H, HK=HK, lengths=lens.tolist(),
               max_abs_err=err, row_ratio=ratio, fault_row_ratio=fault,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    if sweep:
        rec["split_ms"] = {}
        for n in pa.DECODE_SPLITS:
            def forced(n=n):
                return pa.launch_paged_decode(q, kp, vp, bt, lens, splits=n,
                                              **rope, **kw)
            r = row_ratio(torch, forced(), out_p)
            if not r <= 1.0:
                fail(f"{what}: {n} forced key splits at {r:.3g} of the "
                     f"row limit")
            rec["split_ms"][n] = time_ms(torch, forced)
    return rec


def check_chunk(torch, F, kernels, kv_int8: bool, ctx_cap: int,
                ctx_len: int, HK: int = 32):
    """B11 at T = 256, H = 32 (HK kv heads) against a (1, ctx_cap + 256)
    temp cache whose valid columns start at ctx_cap - ctx_len."""
    sf = kernels.serving_fused
    g = torch.Generator(device="cuda").manual_seed(100 + ctx_cap + 32 - HK)
    B, T, H, D = 1, 256, 32, 128
    W = ctx_cap + T
    kstart = torch.tensor([ctx_cap - ctx_len], dtype=torch.int32,
                          device="cuda")
    q = torch.randn((B, T, H, D), generator=g, device="cuda").bfloat16()
    if kv_int8:
        ck = torch.randint(-127, 128, (B, W, HK, D), generator=g,
                           device="cuda", dtype=torch.int8)
        cv = torch.randint(-127, 128, (B, W, HK, D), generator=g,
                           device="cuda", dtype=torch.int8)
        kr = torch.rand((B, W, HK), generator=g, device="cuda") * 0.02 + 0.005
        vr = torch.rand((B, W, HK), generator=g, device="cuda") * 0.02 + 0.005
    else:
        ck = torch.randn((B, W, HK, D), generator=g, device="cuda").bfloat16()
        cv = torch.randn((B, W, HK, D), generator=g, device="cuda").bfloat16()
        kr = vr = None
    kw = dict(k_rows=kr, v_rows=vr)

    def kern():
        return sf.flash_chunk_attention(q, ck, cv, W, kstart, **kw)

    def plain():
        return sf.flash_chunk_attention_plain(q, ck, cv, W, kstart, **kw)

    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    err, ratio = check_close(torch, out_k, out_p,
                             f"B11 kv_int8={kv_int8} ctx_cap={ctx_cap} "
                             f"HK={HK}")
    K, V, Q = sdpa_operands(torch, q, ck, cv, kr, vr)
    kpos = torch.arange(W, device="cuda")[None, :]
    qpos = (W - T) + torch.arange(T, device="cuda")[:, None]
    mask = (kpos <= qpos) & (kpos >= int(kstart[0]))

    def lib():
        return F.scaled_dot_product_attention(Q, K, V, attn_mask=mask)

    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=5, warmup=1)
    lib_ms = time_ms(torch, lib)
    ks0 = int(kstart[0])
    cols = W - ks0
    esz = 1 if kv_int8 else 2
    pairs = sum((W - T + t) - ks0 + 1 for t in range(T))
    nbytes = (2 * B * T * H * D * 2 + 2 * cols * HK * D * esz
              + (2 * cols * HK * 4 if kv_int8 else 0) + 4)
    flops = 4 * pairs * H * D
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(shape=f"T={T} ctx_cap={ctx_cap} H={H} HK={HK}",
                max_abs_err=err, row_ratio=ratio, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def sdpa_operands(torch, q, ck, cv, kr, vr):
    """SDPA's (B, H, S, D) operands for a chunk: the cache dequantized
    (int8) and its kv heads repeated to q's, beforehand."""
    if kr is not None:
        ck = (ck.float() * kr[..., None]).bfloat16()
        cv = (cv.float() * vr[..., None]).bfloat16()
    rep = q.shape[2] // ck.shape[2]
    K, V = (t.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).contiguous()
            for t in (ck, cv))
    return K, V, q.permute(0, 2, 1, 3).contiguous()


def comb_tree_mask(torch, T: int, width: int):
    """(T, T) ancestor-or-self matrix of the engine's comb tree with
    ``T - 1`` draft nodes: a chain of ``(T - 1) // width`` nodes off the
    root, then ``width - 1`` siblings of each chain node (the order
    ``build_comb_tree`` emits)."""
    import numpy as np
    from paddle_tpu_torch.serving import build_comb_tree, \
        tree_ancestor_matrix
    depth = (T - 1) // width
    t = build_comb_tree(0, np.arange(1, depth + 1),
                        [np.arange(width - 1) + 100 * (d + 1)
                         for d in range(depth)])
    return torch.from_numpy(tree_ancestor_matrix(t.parents))


def verify_inputs(torch, kv_int8: bool, ctx_cap: int, T: int, seed: int,
                  HK: int = 32):
    """A verify chunk at the serving width: B = 8 rows of committed
    lengths from ``ctx_cap`` down to 1 (kstart = ctx_cap - length),
    T new queries, H = 32, HK kv heads, D = 128, a (B, ctx_cap + T) temp
    cache."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, D = 8, 32, 128
    W = ctx_cap + T
    lens = [ctx_cap, int(0.93 * ctx_cap), int(0.75 * ctx_cap),
            ctx_cap // 2, int(0.34 * ctx_cap), int(0.16 * ctx_cap), 16, 1]
    kstart = torch.tensor([ctx_cap - n for n in lens], dtype=torch.int32,
                          device="cuda")
    q = torch.randn((B, T, H, D), generator=g, device="cuda").bfloat16()
    if kv_int8:
        ck = torch.randint(-127, 128, (B, W, HK, D), generator=g,
                           device="cuda", dtype=torch.int8)
        cv = torch.randint(-127, 128, (B, W, HK, D), generator=g,
                           device="cuda", dtype=torch.int8)
        kr = torch.rand((B, W, HK), generator=g, device="cuda") * 0.02 + 0.005
        vr = torch.rand((B, W, HK), generator=g, device="cuda") * 0.02 + 0.005
    else:
        ck = torch.randn((B, W, HK, D), generator=g, device="cuda").bfloat16()
        cv = torch.randn((B, W, HK, D), generator=g, device="cuda").bfloat16()
        kr = vr = None
    return q, ck, cv, kr, vr, kstart, W


def check_verify(torch, F, kernels, kv_int8: bool, ctx_cap: int, T: int,
                 tree: bool, HK: int = 32):
    """B11 at the verify shape (``verify_inputs``): linear (B11-linear,
    T = spec_k + 1) or, with ``tree``, B11-tree under the (2, (T-1)/2)
    comb tree of every row. Held row by row against the plain version.
    Tree only: the plain version with one ancestor bit of a depth-2
    node cleared (node 2 no longer sees node 1) must fail the same
    check, and a chain tree through the kernel must give B11-linear's
    bits. Timed beside the plain version, SDPA under the same boolean
    mask on the cache dequantized beforehand, and the bound."""
    sf = kernels.serving_fused
    q, ck, cv, kr, vr, kstart, W = verify_inputs(
        torch, kv_int8, ctx_cap, T, seed=232 + T + ctx_cap // 64 - HK,
        HK=HK)
    B, _, H, D = q.shape
    qoff = W - T
    kw = dict(k_rows=kr, v_rows=vr)
    what = (f"{'B11-tree' if tree else 'B11-linear'} kv_int8={kv_int8} "
            f"ctx_cap={ctx_cap} T={T} H={H} HK={HK}")
    anc = (comb_tree_mask(torch, T, 2).cuda() if tree else
           torch.tril(torch.ones((T, T), dtype=torch.bool, device="cuda")))
    tm = anc.expand(B, T, T).contiguous() if tree else None

    def kern():
        return sf.flash_chunk_attention(q, ck, cv, W, kstart, tree_mask=tm,
                                        **kw)

    def plain():
        return sf.flash_chunk_attention_plain(q, ck, cv, W, kstart,
                                              tree_mask=tm, **kw)

    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    err, ratio = check_close(torch, out_k, out_p, what)
    rec = dict(shape=what)
    if tree:
        bad = tm.clone()
        bad[:, 2, 1] = False                # node 2 (depth 2) loses node 1
        fault = row_ratio(torch, out_k, sf.flash_chunk_attention_plain(
            q, ck, cv, W, kstart, tree_mask=bad, **kw))
        if not fault > 1.0:
            fail(f"{what}: the check passes the plain version with an "
                 f"ancestor bit cleared (worst row at {fault:.3g})")
        chain = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                      device="cuda")).expand(B, T, T)
        same = torch.equal(
            sf.flash_chunk_attention(q, ck, cv, W, kstart,
                                     tree_mask=chain, **kw),
            sf.flash_chunk_attention(q, ck, cv, W, kstart, **kw))
        if not same:
            fail(f"{what}: a chain tree does not give B11-linear's bits")
        rec.update(fault_row_ratio=fault, chain_equals_linear=same)
    K, V, Q = sdpa_operands(torch, q, ck, cv, kr, vr)
    kpos = torch.arange(W, device="cuda")
    chunk = torch.zeros((T, W), dtype=torch.bool, device="cuda")
    chunk[:, qoff:] = anc
    seen = (kpos[None, :] < qoff) | chunk                  # (T, W)
    mask = seen[None] & (kpos[None, None, :] >= kstart[:, None, None].long())
    mask4 = mask[:, None]                                  # (B, 1, T, W)

    def lib():
        return F.scaled_dot_product_attention(Q, K, V, attn_mask=mask4)

    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=5, warmup=1)
    lib_ms = time_ms(torch, lib)
    esz = 1 if kv_int8 else 2
    cols = int((W - kstart.long()).sum())          # visible columns read
    nbytes = (2 * B * T * H * D * 2 + 2 * cols * HK * D * esz
              + (2 * cols * HK * 4 if kv_int8 else 0) + 4 * B
              + (4 * B * T if tree else 0))
    flops = 4 * D * H * int(mask.sum())             # visible (query, col)
    b_ms, b_by = bound_ms(nbytes, flops)
    rec.update(max_abs_err=err, row_ratio=ratio, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    return rec

def check_dense_decode(torch, F, kernels, kv_int8: bool, H: int, S: int,
                       lens, seed: int, HK: int = 0, sweep: bool = False):
    """B7 on layer 1 of a (2, B, S, HK, D) dense cache (HK = H unless
    given, D = 128, B = len(lens)), every column at or past a row's
    length NaN (int8: its scale NaN), held row by row against the plain
    version on the same cache with a clean tail; the plain version
    without the last FAULT_TILE live keys of the longest row must fail
    the same check. Timed beside the plain version, SDPA under a boolean
    length mask on the cache dequantized, transposed and (under GQA) its
    kv heads repeated beforehand, and the bound (the live K and V rows
    and their scales, q, the output and the lengths). ``sweep`` also
    runs the kernel with each key split count forced (``split_ms``),
    each held to the same row rule."""
    fz = kernels.fused
    g = torch.Generator(device="cuda").manual_seed(seed)
    HK = HK or H
    B, D = len(lens), 128
    shape = (2, B, S, HK, D)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    if kv_int8:
        k = torch.randint(-127, 128, shape, generator=g, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand(shape[:4], generator=g, device="cuda") * 0.02 + 0.005
        vs = torch.rand(shape[:4], generator=g, device="cuda") * 0.02 + 0.005
    else:
        k = torch.randn(shape, generator=g, device="cuda").bfloat16()
        v = torch.randn(shape, generator=g, device="cuda").bfloat16()
        ks = vs = None
    clean = [t if t is None else t[1] for t in (k, v, ks, vs)]
    dirty = [t if t is None else t.clone() for t in (k, v, ks, vs)]
    tail = (torch.arange(S, device="cuda")[None, :]
            >= lens[:, None].long())                          # (B, S)
    for i in ((2, 3) if kv_int8 else (0, 1)):
        dirty[i][1][tail] = float("nan")
    ck, cv, kr, vr = (t if t is None else t[1] for t in dirty)
    kw = dict(k_rows=kr, v_rows=vr)
    pkw = dict(k_rows=clean[2], v_rows=clean[3])
    what = f"B7 kv_int8={kv_int8} H{H} HK{HK} S{S}"

    def kern():
        return fz.decode_attention(q, ck, cv, lens, **kw)

    def plain():
        return fz.decode_attention_plain(q, clean[0], clean[1], lens, **pkw)

    out_k = kern()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        fail(f"{what}: NaN past the lengths reached the output")
    out_p = plain()
    torch.cuda.synchronize()
    err, ratio = check_close(torch, out_k, out_p, what)
    bad = lens.clone()
    longest = int(torch.argmax(lens))
    bad[longest] -= FAULT_TILE
    fault = row_ratio(torch, out_k, fz.decode_attention_plain(
        q, clean[0], clean[1], bad, **pkw))
    if not fault > 1.0:
        fail(f"{what}: the check passes the plain version without the "
             f"last {FAULT_TILE} live keys of row {longest} (worst row at "
             f"{fault:.3g})")
    if kv_int8:
        ckd = (clean[0].float() * clean[2][..., None]).bfloat16()
        cvd = (clean[1].float() * clean[3][..., None]).bfloat16()
    else:
        ckd, cvd = clean[0], clean[1]
    K, V = (t.permute(0, 2, 1, 3).repeat_interleave(H // HK, 1).contiguous()
            for t in (ckd, cvd))
    mask = (~tail)[:, None, None, :]
    ql = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(ql, K, V, attn_mask=mask)

    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=5, warmup=1)
    lib_ms = time_ms(torch, lib)
    n_tok = int(lens.sum().item())
    esz = 1 if kv_int8 else 2
    nbytes = (2 * B * H * D * 2 + 2 * n_tok * HK * D * esz
              + (2 * n_tok * HK * 4 if kv_int8 else 0) + 4 * B)
    b_ms, b_by = bound_ms(nbytes, 4 * n_tok * H * D)
    rec = dict(shape=what, lengths=lens.tolist(), max_abs_err=err,
               row_ratio=ratio, fault_row_ratio=fault, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    if sweep:
        rec["split_ms"] = {}
        for n in fz.DECODE_SPLITS:
            def forced(n=n):
                return fz.launch_decode(q, ck, cv, lens, splits=n, **kw)
            r = row_ratio(torch, forced(), out_p)
            if not r <= 1.0:
                fail(f"{what}: {n} forced key splits at {r:.3g} of the "
                     f"row limit")
            rec["split_ms"][n] = time_ms(torch, forced)
    return rec


def flash_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the flash kernels compute: all, or under the
    top-left causal mask those with key <= query."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + max(0, sq - sk) * sk


def check_flash(torch, F, fa, B, sq, sk, H, HK, D, causal, seed, timed):
    """B1, B2 and B3 on one shape (bf16), each against its plain version
    in f32 on the same bf16 inputs: B1's O and lse; dQ, dK and dV from
    ``flash_attention(...).backward(dO)`` (the training path's autograd
    op, GQA group sums included) against the plain backward passes on
    B1's own lse and ``delta = rowsum(O * dO)`` of B1's own O, as the op
    gives them to B2 and B3. Then the planted fault: the plain versions
    without the last FAULT_TILE keys that some query sees must fail the
    same row checks, every output of them. With ``timed``, each kernel's
    time beside its plain version's, its bound, and SDPA's."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(s, h):
        return torch.randn((B, s, h, D), generator=g,
                           device="cuda").bfloat16()

    q, k, v, do = rand(sq, H), rand(sk, HK), rand(sk, HK), rand(sq, H)
    rep, scale = H // HK, D ** -0.5
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    what = f"B{B} Sq{sq} Sk{sk} H{H} HK{HK} D{D} causal={causal}"
    out, lse = fa.flash_fwd(q, kr, vr, causal=causal, scale=scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_op = fa.flash_attention(*leaves, causal=causal)
    o_op.backward(do)
    torch.cuda.synchronize()
    if not torch.equal(o_op.detach(), out):
        fail(f"B1 {what}: the autograd op's O is not flash_fwd's")
    got = {"O": out, "dQ": leaves[0].grad, "dK": leaves[1].grad,
           "dV": leaves[2].grad}
    del o_op, leaves
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    qf, kf, vf, dof = (t.float() for t in (q, kr, vr, do))

    def plain_over(keys: int):
        """O, lse, dQ, dK, dV of the plain versions over the first
        ``keys`` keys; dK and dV summed over each GQA group, zero past
        ``keys``."""
        kk, vk = kf[:, :keys], vf[:, :keys]
        o, l = fa.flash_attention_plain(qf, kk, vk, causal, scale)
        dk, dv = fa.flash_bwd_dkv_plain(qf, kk, vk, dof, lse, delta, causal,
                                        scale)
        dq = fa.flash_bwd_dq_plain(qf, kk, vk, dof, lse, delta, causal, scale)

        def group(t):
            t = F.pad(t, (0, 0, 0, 0, 0, sk - keys))
            return t.reshape(B, sk, HK, rep, D).sum(3)

        return {"O": o, "dQ": dq, "dK": group(dk), "dV": group(dv)}, l

    want, want_lse = plain_over(sk)
    errs, ratios = {}, {}
    for n in got:
        errs[n], ratios[n] = check_close(torch, got[n], want[n],
                                         f"{n} {what}")
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_ATOL:
        fail(f"B1 lse {what}: max abs err {lse_err} > {LSE_ATOL}")
    del want, want_lse
    seen = min(sq, sk) if causal else sk
    fault, _ = plain_over(seen - FAULT_TILE)
    fault_ratios = {n: row_ratio(torch, got[n], fault[n]) for n in got}
    del fault, qf, kf, vf, dof
    for n, r in fault_ratios.items():
        if not r > 1.0:
            fail(f"{n} {what}: the check passes the plain version without "
                 f"its last {FAULT_TILE} seen keys (worst row at {r:.3g} of "
                 f"its limit)")
    by_kernel = {"B1": ("O",), "B2": ("dK", "dV"), "B3": ("dQ",)}
    rec = {"shape": what, "max_abs_err": errs, "row_ratio": ratios,
           "fault_row_ratio": fault_ratios, "lse_err": lse_err,
           "kernel_err": {b: max(errs[n] for n in ns)
                          for b, ns in by_kernel.items()},
           "kernel_row_ratio": {b: max(ratios[n] for n in ns)
                                for b, ns in by_kernel.items()}}
    if not timed:
        return rec
    kw = dict(causal=causal, scale=scale)
    args = (q, kr, vr, do, lse, delta)
    ms = {"B1": time_ms(torch, lambda: fa.flash_fwd(q, kr, vr, **kw)),
          "B2": time_ms(torch, lambda: fa.flash_bwd_dkv(*args, **kw)),
          "B3": time_ms(torch, lambda: fa.flash_bwd_dq(*args, **kw))}
    plain = {
        "B1": time_ms(torch, lambda: fa.flash_attention_plain(
            q, kr, vr, causal, scale), reps=3, warmup=1),
        "B2": time_ms(torch, lambda: fa.flash_bwd_dkv_plain(
            *args, causal, scale), reps=3, warmup=1),
        "B3": time_ms(torch, lambda: fa.flash_bwd_dq_plain(
            *args, causal, scale), reps=3, warmup=1)}
    Q, K, V, dO = (t.transpose(1, 2).contiguous() for t in (q, kr, vr, do))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        Q, K, V, is_causal=causal))
    Ql, Kl, Vl = (t.requires_grad_() for t in (Q, K, V))

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(Ql, Kl, Vl, is_causal=causal)
        return torch.autograd.grad(o, (Ql, Kl, Vl), dO)

    lib_fb = time_ms(torch, lib_fwd_bwd)
    # SDPA's backward alone, which computes dQ, dK and dV in one call: the
    # yardstick of B2 and B3 together (not one PyTorch call of B3's own)
    lib_bwd = lib_fb - lib_fwd
    pairs = B * H * flash_pairs(sq, sk, causal)
    qbytes, kbytes = B * sq * H * D * 2, B * sk * H * D * 2
    rows = B * H * sq * 4                             # one f32 per row
    work = {  # bytes (each input read once, each output written once), flops
        "B1": (2 * qbytes + 2 * kbytes + rows, 4 * D * pairs),
        "B2": (2 * qbytes + 4 * kbytes + 2 * rows, 8 * D * pairs),
        "B3": (3 * qbytes + 2 * kbytes + 2 * rows, 6 * D * pairs)}
    for name in ("B1", "B2", "B3"):
        b_ms, b_by = bound_ms(*work[name])
        sdpa = lib_fwd if name == "B1" else lib_bwd
        rec[name] = dict(ms=ms[name],
                         plain_ms=plain[name], bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_fwd if name == "B1" else None,
                         tflops=work[name][1] / ms[name] / 1e9,
                         bound_share=b_ms / ms[name],
                         vs_sdpa=ms[name] / sdpa)
    rec["sdpa_fwd_ms"], rec["sdpa_fwd_bwd_ms"] = lib_fwd, lib_fb
    rec["sdpa_bwd_ms"] = lib_bwd
    return rec


def check_fused(torch, F, fk, n: int, h: int, i: int, dtype, seed: int,
                timed: bool):
    """B4a and B4b on (n, h) rows, B5a and B5b on (n, i), each against
    its plain version on the same inputs (FUSED_RTOL), then against its
    planted fault, which the same check must reject. x's rows have
    scales spread over 1e-3..7; B4b gets B4a's own rstd, as the autograd
    op hands it over, and the autograd ops must give the wrappers'
    results. With ``timed``, each kernel's time beside its plain
    version's, its bound, and ``F.rms_norm``'s for B4a (forward) and
    B4b (forward and backward)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    eps, name = 1e-5, str(dtype).split(".")[-1]
    rtol = FUSED_RTOL[name]
    what = f"N{n} h{h} i{i} {name}"

    def rand(rows_cols, scale=1.0):
        return (torch.randn(rows_cols, generator=g, device="cuda")
                * scale).to(dtype)

    x = rand((n, h), torch.exp(torch.empty(
        (n, 1), device="cuda").uniform_(-7, 2, generator=g)))
    w = (1 + 0.1 * torch.randn((h,), generator=g, device="cuda")).to(dtype)
    ct, gate, up, d = rand((n, h)), rand((n, i), 3.0), rand((n, i)), \
        rand((n, i))
    out, rstd = fk.rms_fwd(x, w, eps)
    dx, dw = fk.rms_bwd(x, w, rstd, ct)
    act = fk.swiglu_fwd(gate, up)
    dg, du = fk.swiglu_bwd(gate, up, d)
    leaves = [t.clone().requires_grad_() for t in (x, w, gate, up)]
    o_op = fk.rms_norm(leaves[0], leaves[1], eps)
    o_op.backward(ct)
    a_op = fk.swiglu(leaves[2], leaves[3])
    a_op.backward(d)
    torch.cuda.synchronize()
    if not (torch.equal(o_op.detach(), out) and torch.equal(a_op.detach(),
                                                            act)
            and all(torch.equal(t.grad, r) for t, r in
                    zip(leaves, (dx, dw, dg, du)))):
        fail(f"B4/B5 {what}: the autograd ops differ from the wrappers")
    del leaves, o_op, a_op
    got = {"B4a": {"out": out, "rstd": rstd}, "B4b": {"dx": dx,
                                                      "dw": dw[None]},
           "B5a": {"out": act}, "B5b": {"dg": dg, "du": du}}
    p_out, p_rstd = fk.rms_norm_fwd_plain(x, w, eps)
    p_dx, p_dw = fk.rms_norm_bwd_plain(x, w, rstd, ct)
    p_dg, p_du = fk.swiglu_bwd_plain(gate, up, d)
    want = {"B4a": {"out": p_out, "rstd": p_rstd},
            "B4b": {"dx": p_dx, "dw": p_dw[None]},
            "B5a": {"out": fk.swiglu_fwd_plain(gate, up)},
            "B5b": {"dg": p_dg, "du": p_du}}
    errs, ratios = {}, {}
    for k, outs in got.items():
        res = [check_close(torch, t, want[k][o], f"{k} {o} {what}", rtol)
               for o, t in outs.items()]
        errs[k] = max(e for e, _ in res)
        ratios[k] = max(r for _, r in res)
    del want
    # the planted faults
    f_out, f_rstd = fk.rms_norm_fwd_plain(x, w, 10 * eps)
    last = (n - 1) // fk.RMS_BWD_ROWS * fk.RMS_BWD_ROWS
    _, f_dw = fk.rms_norm_bwd_plain(x[:last], w, rstd[:last], ct[:last])
    sig = torch.sigmoid(gate.float())
    f_dg = (d.float() * up.float() * sig).to(dtype)
    faults = {"B4a": {"out": f_out, "rstd": f_rstd},
              "B4b": {"dw": f_dw[None]},
              "B5a": {"out": fk.swiglu_fwd_plain(up, gate)},
              "B5b": {"dg": f_dg}}
    fault_ratios = {k: max(row_ratio(torch, got[k][o], t, rtol)
                           for o, t in outs.items())
                    for k, outs in faults.items()}
    del faults, f_out, f_rstd, f_dw, f_dg, sig
    for k, r in fault_ratios.items():
        if not r > 1.0:
            fail(f"{k} {what}: the check passes its planted fault (worst "
                 f"row at {r:.3g} of its limit)")
    rec = {"shape": what, "max_abs_err": errs, "row_ratio": ratios,
           "fault_row_ratio": fault_ratios}
    if not timed:
        return rec
    e = x.element_size()
    ms = {"B4a": time_ms(torch, lambda: fk.rms_fwd(x, w, eps)),
          "B4b": time_ms(torch, lambda: fk.rms_bwd(x, w, rstd, ct)),
          "B5a": time_ms(torch, lambda: fk.swiglu_fwd(gate, up)),
          "B5b": time_ms(torch, lambda: fk.swiglu_bwd(gate, up, d))}
    plain = {
        "B4a": time_ms(torch, lambda: fk.rms_norm_fwd_plain(x, w, eps),
                       reps=5, warmup=1),
        "B4b": time_ms(torch, lambda: fk.rms_norm_bwd_plain(x, w, rstd, ct),
                       reps=5, warmup=1),
        "B5a": time_ms(torch, lambda: fk.swiglu_fwd_plain(gate, up),
                       reps=5, warmup=1),
        "B5b": time_ms(torch, lambda: fk.swiglu_bwd_plain(gate, up, d),
                       reps=5, warmup=1)}
    lib_fwd = time_ms(torch, lambda: F.rms_norm(x, (h,), w, eps))
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()

    def lib_fwd_bwd():
        o = F.rms_norm(xl, (h,), wl, eps)
        return torch.autograd.grad(o, (xl, wl), ct)

    lib_fb = time_ms(torch, lib_fwd_bwd)
    nh, ni = n * h, n * i
    work = {  # bytes (each input read once, each output written once),
              # f32 operations per element as the kernels do them
        "B4a": (2 * nh * e + h * e + 4 * n, 4 * nh),
        "B4b": (3 * nh * e + 2 * h * e + 4 * n, 8 * nh),
        "B5a": (3 * ni * e, 5 * ni),
        "B5b": (5 * ni * e, 11 * ni)}
    for k in ("B4a", "B4b", "B5a", "B5b"):
        b_ms, b_by = bound_ms(*work[k], rate=F32_FLOPS_PER_S)
        rec[k] = dict(ms=ms[k], plain_ms=plain[k], bound_ms=b_ms,
                      bound_by=b_by,
                      library_ms={"B4a": lib_fwd, "B4b": lib_fb}.get(k))
    rec["rms_norm_fwd_ms"], rec["rms_norm_fwd_bwd_ms"] = lib_fwd, lib_fb
    return rec


def check_rope(torch, tl, fk, B: int, S: int, H: int, HK: int, D: int,
               dtype, seed: int, timed: bool):
    """B6 on q (B, S, H, D) and k (B, S, HK, D), strided views of one
    fused qkv tensor as the incubate decoder makes them, with (S, D/2)
    f32 tables: forward (sign +1) and backward (sign -1), each output row
    against the plain version on the same inputs (FUSED_RTOL: both round
    one f32 result once); the autograd op ``rope_qk`` must give the
    wrappers' results. Planted fault: the plain version with the sign of
    sin flipped, which the same check must reject. With ``timed``, the
    forward of q and k (two launches) beside its plain version and the
    bound (q and k read and written once, the tables read once). No
    single PyTorch call computes RoPE, so there is no library time."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    name = str(dtype).split(".")[-1]
    rtol = FUSED_RTOL[name]
    what = f"B{B} S{S} H{H} HK{HK} D{D} {name}"
    qkv = torch.randn((B, S, (H + 2 * HK) * D), generator=g,
                      device="cuda").to(dtype)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + HK) * D].unflatten(-1, (HK, D))
    ct = torch.randn_like(q)
    cos, sin = tl.rope_tables(S, D, 10000.0, device="cuda")
    got = {(nm, sign): fk.rope_apply(x, cos, sin, sign)
           for nm, x in (("q", q), ("k", k)) for sign in (1.0, -1.0)}
    leaves = [t.clone().requires_grad_() for t in (q, k)]
    rq, rk = fk.rope_qk(*leaves, cos, sin)
    torch.autograd.backward((rq, rk), (ct, torch.ones_like(rk)))
    torch.cuda.synchronize()
    if not (torch.equal(rq.detach(), got["q", 1.0])
            and torch.equal(rk.detach(), got["k", 1.0])
            and torch.equal(leaves[0].grad, fk.rope_apply(ct, cos, sin,
                                                          -1.0))):
        fail(f"B6 {what}: the autograd op differs from the wrappers")
    del leaves, rq, rk
    errs, ratios, faults = [], [], []
    for (nm, sign), out in got.items():
        x = q if nm == "q" else k
        e, r = check_close(torch, out, fk.rope_plain(x, cos, sin, sign),
                           f"B6 {nm} sign {sign:+.0f} {what}", rtol)
        errs.append(e)
        ratios.append(r)
        faults.append(row_ratio(torch, out, fk.rope_plain(x, cos, sin,
                                                          -sign), rtol))
    if not min(faults) > 1.0:
        fail(f"B6 {what}: the check passes the plain version with the "
             f"sign of sin flipped (worst row at {min(faults):.3g})")
    rec = {"shape": what, "max_abs_err": max(errs), "row_ratio": max(ratios),
           "fault_row_ratio": min(faults)}
    if not timed:
        return rec
    rec["ms"] = time_ms(torch, lambda: (fk.rope_apply(q, cos, sin),
                                        fk.rope_apply(k, cos, sin)))
    rec["plain_ms"] = time_ms(torch, lambda: (fk.rope_plain(q, cos, sin),
                                              fk.rope_plain(k, cos, sin)),
                              reps=5, warmup=1)
    n = q.numel() + k.numel()
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        2 * n * q.element_size() + 2 * cos.numel() * 4, 6 * n,
        rate=F32_FLOPS_PER_S)
    rec["library_ms"] = None
    rec["library"] = "none: no single PyTorch call computes RoPE"
    return rec


def check_paged_hm(torch, F, fk, scales: str, seed: int,
                   lens=(1, 2048, 1537, 700, 1024, 333, 2000, 64),
                   pps: int = 32, H: int = 32, HK: int = 32,
                   sweep: bool = False):
    """B8 over a head-major (P, HK, page, D) pool at the Llama-2-7B
    decode shape (B = len(lens), H = HK = 32, D = 128, page 64, Paddle's
    ``block_size`` default; by default ragged lengths 1 ... 2048 in a
    table of ``pps`` = 32 pages, or the Paddle decoder's 8 equal rows in
    its 17 pages; HK = 8 for Llama-3-8B's GQA): pages scattered through
    a shuffled block table with -1 past each row's pages; in bf16 every
    slot past a row's length and the whole of page 0 (where -1 entries
    point) NaN. ``scales``: "bf16", or int8 pages with "(HK,)" or
    "(B, HK)" dequant scales. Held row by row against the plain version
    on the same pool (which masks what lies past the lengths); NaN must
    not reach the output; the plain version without the longest row's
    last FAULT_TILE keys must fail the check. Timed beside the plain
    version, SDPA under a boolean length mask on the cache gathered and
    dequantized beforehand (NaN cleared; kv heads repeated under GQA),
    and the bound (the live K and V rows, their table entries and scales,
    q and the output). ``sweep`` also runs the kernel with each key split
    count forced (``split_ms``), each held to the same row rule."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, D, page = len(lens), 128, 64
    P = 1 + B * pps
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1).reshape(
        B, pps).to(torch.int32)
    live_pages = (lens.long() + page - 1) // page
    bt[torch.arange(pps, device="cuda")[None, :] >= live_pages[:, None]] = -1
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    shape = (P, HK, page, D)
    quant = scales != "bf16"
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        sshape = (HK,) if scales == "(HK,)" else (B, HK)
        ks = torch.rand(sshape, generator=g, device="cuda") * 0.02 + 0.005
        vs = torch.rand(sshape, generator=g, device="cuda") * 0.02 + 0.005
    else:
        kp = torch.randn(shape, generator=g, device="cuda").bfloat16()
        vp = torch.randn(shape, generator=g, device="cuda").bfloat16()
        ks = vs = None
        # NaN in every slot past each row's length, and in page 0
        pos = torch.arange(pps * page, device="cuda")
        for b in range(B):
            tail = pos[None, :] >= lens[b].long()
            pages = bt[b].clamp(min=0).long().repeat_interleave(page)
            for t in (kp, vp):
                t[pages[tail[0]], :, pos[tail[0]] % page] = float("nan")
        kp[0] = vp[0] = float("nan")
    kw = dict(k_dequant_scale=ks, v_dequant_scale=vs)
    what = f"B8 {scales}"

    def kern():
        return fk.paged_decode_attention(q, kp, vp, bt, lens, **kw)

    def plain():
        return fk.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)

    out_k = kern()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        fail(f"{what}: NaN past the lengths reached the output")
    out_p = plain()
    err, ratio = check_close(torch, out_k, out_p, what)
    bad = lens.clone()
    longest = int(torch.argmax(lens))
    bad[longest] -= FAULT_TILE
    fault = row_ratio(torch, out_k, fk.paged_decode_attention_plain(
        q, kp, vp, bt, bad, **kw))
    if not fault > 1.0:
        fail(f"{what}: the check passes the plain version without the "
             f"last {FAULT_TILE} keys of row {longest} (worst row at "
             f"{fault:.3g})")
    # library yardstick: SDPA on the gathered, dequantized, NaN-free cache
    idx = bt.clamp(min=0).long()

    def gathered(pool, sc):
        c = pool[idx].permute(0, 2, 1, 3, 4).reshape(B, HK, pps * page, D)
        if sc is not None:
            c = (c.float() * sc.expand(B, HK)[:, :, None, None]).bfloat16()
        return torch.nan_to_num(c)

    K, V = (gathered(kp, ks).repeat_interleave(H // HK, 1),
            gathered(vp, vs).repeat_interleave(H // HK, 1))
    mask = (torch.arange(pps * page, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None, :]
    ql = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(ql, K, V, attn_mask=mask)

    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=5, warmup=1)
    lib_ms = time_ms(torch, lib)
    n_tok = int(lens.sum().item())
    esz = 1 if quant else 2
    nbytes = (2 * B * H * D * 2 + 2 * n_tok * HK * D * esz
              + (2 * ks.numel() * 4 if quant else 0)
              + int(live_pages.sum().item()) * 4 + B * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * n_tok * H * D)
    rec = dict(shape=what, B=B, H=H, HK=HK, lengths=lens.tolist(),
               max_abs_err=err, row_ratio=ratio, fault_row_ratio=fault,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    if sweep:
        rec["split_ms"] = {}
        for n in fk.DECODE_SPLITS:
            def forced(n=n):
                return fk.launch_paged_decode_hm(q, kp, vp, bt, lens,
                                                 splits=n, **kw)
            r = row_ratio(torch, forced(), out_p)
            if not r <= 1.0:
                fail(f"{what}: {n} forced key splits at {r:.3g} of the "
                     f"row limit")
            rec["split_ms"][n] = time_ms(torch, forced)
    return rec


# ---------------------------------------------------------------- phase 3
def make_requests(n: int, vocab: int, seed: int):
    """Prompts of 128..1024 tokens and 32..128 new tokens; every fourth
    request opens with one shared 200-token system prompt."""
    import numpy as np
    rs = np.random.RandomState(seed)
    system = rs.randint(3, vocab, (200,)).astype(np.int32)
    reqs = []
    for i in range(n):
        plen = int(rs.randint(128, 1025))
        p = rs.randint(3, vocab, (plen,)).astype(np.int32)
        if i % 4 == 0:
            p[:200] = system
        reqs.append((p, int(rs.randint(32, 129))))
    return reqs


def chunked_prefill(torch, gen, eng, slot, seq, fused, params=None,
                    adapter_slot=None):
    """Prefill ``seq`` into ``slot``'s pages in the engine's chunk
    widths and context buckets; returns the last chunk's logits.
    ``params`` replaces the engine's weights; ``adapter_slot`` adds the
    LoRA term of that slot of the engine's adapter pool."""
    cache = eng.cache
    ad = {}
    if adapter_slot is not None:
        ad = dict(adapters=eng.adapters.arrays,
                  adapter_slot=torch.tensor([adapter_slot]).cuda())
    page = cache.page_size
    bt = torch.from_numpy(cache.block_tables[slot].copy()).cuda()
    done, logits = 0, None
    while done < seq.size:
        width = min(cache.pages_for(seq.size - done) * page,
                    eng.prefill_chunk)
        take = min(seq.size - done, width)
        ctx_cap = cache.ctx_cap_pages(cache.pages_for(done)) * page
        chunk = torch.zeros((1, width), dtype=torch.int32)
        chunk[0, :take] = torch.from_numpy(seq[done:done + take])
        logits, _ = gen.paged_prefill_chunk(
            eng.params if params is None else params, chunk.cuda(),
            cache.pool, bt, eng.cfg, ctx_cap=ctx_cap, ctx_len=done,
            chunk_len=take, fused=fused, **ad)
        done += take
    return logits


def consistency(torch, gen, eng, req):
    """Decode-step logits through the tier's kernels vs the kernel-free
    prefill (``fused=False``) of the same sequence."""
    import numpy as np
    cache = eng.cache
    seq = np.concatenate([req.prompt[0],
                          np.asarray(req.tokens[:-1], np.int32)])
    n = seq.size
    cache.admit(0, n + 1)
    chunked_prefill(torch, gen, eng, 0, seq[:-1], eng.fused)
    lengths = torch.zeros(eng.max_batch, dtype=torch.int32)
    lengths[0] = n - 1
    last = torch.zeros(eng.max_batch, dtype=torch.int32)
    last[0] = int(seq[-1])
    active = torch.zeros(eng.max_batch, dtype=torch.bool)
    active[0] = True
    dec, _ = gen.paged_decode_forward(
        eng.params, last.cuda(), cache.pool,
        torch.from_numpy(cache.block_tables.copy()).cuda(),
        lengths.cuda(), eng.cfg, active=active.cuda(), fused=eng.fused)
    cache.admit(1, n)
    ref = chunked_prefill(torch, gen, eng, 1, seq, False)
    cache.release(0)
    cache.release(1)
    d, r = dec[0].float(), ref[0].float()
    err = (d - r).abs().max().item()
    return dict(logits_max_abs_err=err,
                logits_max_abs=r.abs().max().item(),
                argmax_equal=bool(int(d.argmax()) == int(r.argmax())),
                argmax_is_last_token=bool(int(d.argmax()) == req.tokens[-1]))


def make_distinct_requests(n: int, vocab: int, seed: int):
    """Non-repetitive requests for the draft tiers: each prompt's
    128..1024 tokens drawn without replacement (so the n-gram proposer
    finds nothing to copy and acceptance measures the draft model), and
    32..128 new tokens."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [(rs.choice(np.arange(3, vocab), int(rs.randint(128, 1025)),
                       replace=False).astype(np.int32),
             int(rs.randint(32, 129))) for _ in range(n)]


def damp_draft_tail(params, draft_layers: int):
    """Scale ``wo`` and ``wd`` of layers ``[draft_layers:]`` by 1e-3 in
    place (the JAX bench's ``_align_draft_params``): the layers past the
    draft's depth barely move the residual stream, so the truncated
    draft tracks the target and acceptance is real."""
    for n in ("wo", "wd"):
        params["layers"][n][draft_layers:] *= 1e-3


def token_agreement(got, want):
    """How far the tokens of ``got`` follow ``want``'s: the share of
    generated positions that are equal, the share that lie before their
    request's first difference, and the first difference as (request,
    position), or None."""
    same = prefix = total = 0
    first = None
    for r, (a, b) in enumerate(zip(got, want)):
        n = max(len(a), len(b))
        eq = [i < len(a) and i < len(b) and a[i] == b[i] for i in range(n)]
        same += sum(eq)
        total += n
        k = eq.index(False) if False in eq else n
        prefix += k
        if k < n and first is None:
            first = (r, k)
    return dict(tokens_equal_share=same / max(1, total),
                tokens_before_divergence_share=prefix / max(1, total),
                first_divergence=first)


def run_tier(torch, kernels, gen, Engine, params, cfg, reqs, name, kv,
             fused=True, check_logits=False, **spec):
    """One tier of the engine: KV bf16 or int8, ``fused`` on or off,
    with ``spec`` speculation arguments or none (plain decode). The
    launch counters are zeroed just before ``run()`` and read just
    after; they must equal what the tier's counted forwards imply (per
    layer: B10, or B9 unfused, for each decode and draft-decode step;
    fused, B11 for each prefill chunk, linear verify and draft catch-up
    chunk and B11-tree for each tree verify). Every request finishes
    with its count, both pools drain, and a draft tier's acceptance is
    over 0.3. Each prefill chunk and engine step is timed (host clock,
    synchronised), the steps filed by the forward they ran. With
    ``check_logits`` one request's sequence is fed back through the
    kernel-free prefill and its logits held against the tier's decode
    step's (``consistency``)."""
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 kv_cache_dtype=kv, prefill_chunk=256, fused=fused, **spec)
    handles = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    attr = "spec_step" if eng.spec is not None else "decode_step"
    orig_step, orig_prefill = getattr(eng, attr), eng.prefill_step
    steps = {"prefill": [], "decode": [], "verify": [], "tree": []}

    def timed(fn, kinds):
        def wrapper(*a, **k):
            before = dict(eng.forwards)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = fn(*a, **k)
            torch.cuda.synchronize()
            if n:
                kind = next(k for k in kinds if eng.forwards[k] > before[k])
                steps[kind].append((time.perf_counter() - t0) * 1e3)
            return n
        return wrapper

    setattr(eng, attr, timed(orig_step, ("tree", "verify", "decode")))
    eng.prefill_step = timed(orig_prefill, ("prefill",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    delattr(eng, attr)                      # back to the class methods
    del eng.prefill_step
    for h, (p, m) in zip(handles, reqs):
        if not h.done or len(h.tokens) != m or h.finish_reason != "max_len":
            fail(f"tier {name}: request {h.rid} finished "
                 f"{h.finish_reason} with {len(h.tokens)}/{m} tokens")
    st = eng.stats()
    f, L = st["forwards"], cfg.num_layers
    Ld = eng.draft_cfg.num_layers if eng.draft_cfg is not None else 0
    decode = L * f["decode"] + Ld * f["draft_decode"]
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    if fused:
        want.update(B10=decode, B11=L * (f["prefill"] + f["verify"])
                    + Ld * f["draft_catchup"])
        want["B11-tree"] = L * f["tree"]
    else:
        want["B9"] = decode
    if counts != want:
        fail(f"tier {name}: launches {counts} != {want} (forwards {f})")
    eng.cache.prefix.drop_all(eng.cache.allocator)
    alloc = eng.cache.allocator
    if alloc.num_used or alloc.allocs_total != alloc.frees_total:
        fail(f"tier {name}: pages leaked ({alloc.stats()})")
    rec = dict(tier=name, kv=kv or "bf16", fused=fused,
               spec={k: list(v) if isinstance(v, tuple) else v
                     for k, v in spec.items()},
               requests=len(handles),
               generated_tokens=sum(len(h.tokens) for h in handles),
               wall_s=wall, forwards=f,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts, cow_copies=st["cow_copies"],
               shares_total=st["shares_total"])
    rec["tokens_per_s"] = rec["generated_tokens"] / wall
    for k, v in steps.items():
        if v:
            rec[f"{k}_ms_mean"] = sum(v) / len(v)
            rec[f"{k}_ms_median"] = sorted(v)[len(v) // 2]
    if eng.spec is not None:
        sp = eng.spec
        rec.update({k: st[k] for k in ("spec_drafted_total",
                                       "spec_accepted_total",
                                       "spec_verify_steps")})
        rec["acceptance"] = sp.acceptance_rate
        # tokens a speculating row commits per verify: its accepted
        # drafts (its accepted root path past the root) plus the bonus
        rec["mean_committed_per_row_verify"] = (
            (sp.accepted_total + sp.verify_steps) / max(1, sp.verify_steps))
    if eng.draft_cache is not None:
        dc = eng.draft_cache
        if dc.allocator.num_used or dc.active.any():
            fail(f"tier {name}: the draft pool did not drain "
                 f"({dc.allocator.stats()})")
        if not eng.spec.acceptance_rate > 0.3:
            fail(f"tier {name}: draft acceptance "
                 f"{eng.spec.acceptance_rate:.3f} is not over 0.3")
        rec["draft_layers"] = eng.draft_layers
    if check_logits:
        cons = consistency(torch, gen, eng, handles[0])
        if not cons["logits_max_abs_err"] <= LOGITS_ATOL:
            fail(f"tier {name}: decode logits vs kernel-free prefill "
                 f"{cons}")
        rec.update(cons)
    rec["tokens"] = [list(h.tokens) for h in handles]
    del eng, handles
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def show(rec) -> str:
    """A tier record as one JSON line, without its token lists."""
    return json.dumps({k: v for k, v in rec.items() if k != "tokens"})

def device_breakdown(torch, prof, calls: int, wall_ms: float, skip=()):
    """Split the card's kernel time in ``prof`` by kind, per call, against
    the host's wall time per call. Only the card's own events are summed:
    a CPU operator's self device time repeats the time of the kernels it
    launched. ``skip``: keys of ``record_function`` spans, whose device
    side is a span over kernels counted already."""
    from torch.autograd import DeviceType
    kinds = {"attention kernel": 0.0, "B4/B5 kernel": 0.0,
             "B6 kernel": 0.0, "gemm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA or ev.key in skip
                or not ev.self_device_time_total):
            continue
        us = ev.self_device_time_total
        top.append((us, ev.count, ev.key))
        key = ev.key.lower()
        if ("paged_decode" in key or "flash_" in key
                or "decode_attention" in key):
            kinds["attention kernel"] += us
        elif any(w in key for w in ("rms_fwd_kernel", "rms_bwd_kernel",
                                    "swiglu_fwd_kernel",
                                    "swiglu_bwd_kernel")):
            kinds["B4/B5 kernel"] += us
        elif "rope_kernel" in key:
            kinds["B6 kernel"] += us
        elif any(w in key for w in ("gemm", "gemv", "nvjet", "xmma",
                                    "cutlass", "splitk")):
            kinds["gemm"] += us
        else:
            kinds["other"] += us
    busy = sum(kinds.values()) / 1e3 / calls
    if busy == 0.0:
        return {"device_time": "not measured (profiler saw no kernels)",
                "wall_ms_per_call": wall_ms}
    return {"wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_per_call_by_kind": {k: v / 1e3 / calls
                                           for k, v in kinds.items()},
            "top_kernels": [
                {"name": name[:90], "ms_per_call": us / 1e3 / calls,
                 "launches_per_call": n / calls}
                for us, n, name in sorted(top, reverse=True)[:12]]}


def profile_tier(torch, Engine, params, cfg, reqs, chunks: int = 4,
                 steps: int = 8):
    """Where the time goes in the bf16 KV, fused tier (kernels B10 and
    B11): admit 8 requests, trace ``chunks`` prefill chunks, finish the
    prefills, then trace ``steps`` decode steps of all 8 rows, each with
    ``torch.profiler``. Launches made here are not counted on the main
    path."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 prefill_chunk=256, fused=True)
    for p, _ in reqs[:8]:
        eng.submit(p, max_new_tokens=128)
    eng._admit()
    eng.prefill_step()                     # warm
    torch.cuda.synchronize()
    widths = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            widths.append(eng.prefill_step())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / chunks
    prefill = device_breakdown(torch, prof, chunks, wall)
    prefill["chunk_widths"] = widths
    while eng._pending:
        eng.prefill_step()
    mask = eng.ready_mask()
    eng.decode_step(mask)                  # warm
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode_step(mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    decode = device_breakdown(torch, prof, steps, wall)
    lengths = eng.cache.lengths[mask]
    decode.update(rows=int(mask.sum()),
                  mean_length=float(lengths.mean()))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"tier": "bf16 KV, fused", "prefill_chunk": prefill,
            "decode_step": decode}



def profile_spec_tier(torch, Engine, params, cfg, reqs, draft_layers: int,
                      steps: int = 4):
    """Where the time of a draft-tree step goes (bf16 KV, fused): admit
    8 requests, finish their prefills and one warm step (the draft
    pool's cold catch-up), then trace ``steps`` steps of all 8 rows with
    ``torch.profiler``, each split on the host clock into the proposal
    (draft catch-up and draft decode) and the tree verify with its
    commit. Launches made here are not counted on the main path."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 prefill_chunk=256, fused=True, draft_layers=draft_layers,
                 spec_tree=(2, 4))
    for p, _ in reqs[:8]:
        eng.submit(p, max_new_tokens=128)
    eng._admit()
    while eng._pending:
        eng.prefill_step()
    mask = eng.ready_mask()
    eng.spec_step(mask)                    # warm: cold draft catch-up
    torch.cuda.synchronize()
    propose, verify = [], []
    before = dict(eng.forwards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ts = time.perf_counter()
            drafts = eng.propose_drafts(mask)
            torch.cuda.synchronize()
            tv = time.perf_counter()
            eng.spec_step(mask, drafts)
            torch.cuda.synchronize()
            propose.append((tv - ts) * 1e3)
            verify.append((time.perf_counter() - tv) * 1e3)
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rec = device_breakdown(torch, prof, steps, wall)
    rec.update(tier="draft-tree, bf16 KV, fused", rows=int(mask.sum()),
               mean_length=float(eng.cache.lengths[mask].mean()),
               propose_ms=propose, verify_and_commit_ms=verify,
               forwards={k: v - before[k] for k, v in eng.forwards.items()})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec

# --------------------------------------------------------------- phase 3e
SCHED_BUDGET = 384      # one 256-token chunk plus the decode rows, with room
BURST_AT = 8            # scheduler steps before the HIGH burst arrives


def burst_requests(n: int, vocab: int, seed: int):
    """The HIGH burst: ``n`` prompts of 512 tokens, 32 new tokens each."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [(rs.randint(3, vocab, (512,)).astype(np.int32), 32)
            for _ in range(n)]


def instrument_engine(torch, eng, no_sync: bool, extra=()):
    """Time ``eng``'s dispatch halves (``decode_dispatch``,
    ``spec_dispatch``, ``prefill_dispatch``) and commit halves
    (``commit_inflight``, ``commit_prefills``: the fetch and the host
    bookkeeping) on the host clock, outermost calls only, and count the
    dispatch calls. With ``no_sync`` every dispatch, and every call of
    the ``extra`` methods (counted under ``calls``, not timed), runs
    under ``torch.cuda.set_sync_debug_mode("error")``, so a
    synchronizing operation inside one raises. Returns the live
    tallies."""
    kinds = {"decode_dispatch": "dispatch", "spec_dispatch": "dispatch",
             "prefill_dispatch": "dispatch", "commit_inflight": "commit",
             "commit_prefills": "commit"}
    kinds.update(dict.fromkeys(extra, "checked"))
    tally = {"calls": {k: 0 for k, v in kinds.items() if v != "commit"},
             "dispatch_s": 0.0, "commit_s": 0.0, "checked_s": 0.0}
    depth = {"dispatch": 0, "commit": 0, "checked": 0}

    def wrap(name, kind, fn):
        def wrapper(*a, **k):
            if kind != "commit":
                tally["calls"][name] += 1
            outer = depth[kind] == 0
            if outer:
                if no_sync and kind != "commit":
                    torch.cuda.set_sync_debug_mode("error")
                t0 = time.perf_counter()
            depth[kind] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[kind] -= 1
                if outer:
                    tally[f"{kind}_s"] += time.perf_counter() - t0
                    if no_sync and kind != "commit":
                        torch.cuda.set_sync_debug_mode(0)
        return wrapper

    for name, kind in kinds.items():
        setattr(eng, name, wrap(name, kind, getattr(eng, name)))
    return tally


def run_sched(torch, kernels, Engine, Scheduler, Priority, params, cfg,
              reqs, highs, name, kv=None, fused=True, overlap=False,
              budget=SCHED_BUDGET, sync_check=False, grammars=None,
              eos=None, setup=None, sync_extra=(), adapters=None,
              adapter_ids=None, **spec):
    """One scheduler run at the engine's serving shape: ``reqs``
    submitted as alternating NORMAL and LOW, the ``highs`` (if any)
    submitted as HIGH after ``BURST_AT`` steps, then driven as
    ``ServingScheduler.run`` drives it (an empty step fences). The
    launch counters are zeroed just before the first step and read
    after the drain; they must equal the counted forwards. Every request
    finishes with its count, every plan stays within the budget, the
    allocator is balanced after the drain, and a burst run that finds
    all 8 slots busy preempts and resumes at least once. The host time
    of a step splits into dispatch, commit and the rest (the
    scheduler's admission and planning); ``sync_check`` runs every
    dispatch under the sync debug mode (``instrument_engine``).
    ``grammars`` (one token DFA or None per request of ``reqs``) builds
    the engine with ``constraints=True`` and submits each request with
    its DFA; the host time of the DFA work (``ConstraintState.mask``
    and ``advance``) and the mask uploads are then recorded, and the
    handles returned under ``"handles"``. ``eos`` is the engine's eos
    id. ``setup(eng)`` runs on the fresh engine before the first step;
    ``sync_extra`` names more engine methods held to the sync check.
    On a host-tier engine (``host_tier=True`` in ``spec``) the record
    carries the tier's counters (``tier``). ``adapters`` (an adapter
    pool or its keyword dict) builds the engine with it, and
    ``adapter_ids`` gives the adapter of each request of ``reqs`` and
    then of ``highs``; every pin must be dropped after the drain, and
    the record carries the pool's counters (``adapters``)."""
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 kv_cache_dtype=kv, prefill_chunk=256, fused=fused,
                 overlap=overlap, eos_token_id=eos,
                 constraints=grammars is not None, adapters=adapters,
                 **spec)
    if setup is not None:
        setup(eng)
    sched = Scheduler(eng, token_budget=budget)
    ids = list(adapter_ids or [0] * (len(reqs) + len(highs or ())))
    handles = [sched.submit(p, max_new_tokens=m,
                            priority=Priority.LOW if i % 2 else
                            Priority.NORMAL, adapter_id=ids[i],
                            constraint=grammars[i] if grammars else None)
               for i, (p, m) in enumerate(reqs)]
    tally = instrument_engine(torch, eng, sync_check, sync_extra)
    dfa = None
    if grammars is not None:
        dfa = time_dfa_work()
        upload = eng._cmask_device

        def timed_upload():
            t0 = time.perf_counter()
            try:
                return upload()
            finally:
                dfa["upload_s"] += time.perf_counter() - t0
        eng._cmask_device = timed_upload
    plans, steps = [], 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    while True:
        if highs and steps == BURST_AT:
            handles += [sched.submit(p, max_new_tokens=m,
                                     priority=Priority.HIGH,
                                     adapter_id=ids[len(reqs) + j])
                        for j, (p, m) in enumerate(highs)]
        more = sched.step()
        steps += 1
        plan = sched.last_plan
        plans.append(plan.scheduled_tokens)
        if budget is not None and plan.scheduled_tokens > budget:
            fail(f"sched {name}: step {steps} planned "
                 f"{plan.scheduled_tokens} tokens over the budget {budget}")
        if not more:
            break
        if (plan.scheduled_tokens == 0 and plan.reserved_tokens == 0
                and sched.last_committed == 0):
            sched._idle_fence()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if dfa is not None:
        dfa["restore"]()
    counts = kernels.launch_counts()
    for h in handles:
        if not h.done or (len(h.tokens) != h.max_new_tokens
                          and h.finish_reason != "eos"):
            fail(f"sched {name}: request {h.rid} finished "
                 f"{h.finish_reason} with {len(h.tokens)}/"
                 f"{h.max_new_tokens} tokens")
    st = sched.stats()
    f, L = st["forwards"], cfg.num_layers
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    if fused:
        want.update(B10=L * f["decode"], B11=L * (f["prefill"] + f["verify"]))
    else:
        want["B9"] = L * f["decode"]
    if counts != want:
        fail(f"sched {name}: launches {counts} != {want} (forwards {f})")
    # the burst preempts when it finds every slot busy (the full
    # request set; a short check with fewer requests may not)
    if highs and len(reqs) >= 8 and not (sched.preemptions_total >= 1
                                         and sched.resumes_total >= 1):
        fail(f"sched {name}: {sched.preemptions_total} preemptions, "
             f"{sched.resumes_total} resumes under the HIGH burst")
    tier = (eng.cache.tier_stats()
            if getattr(eng.cache, "host", None) is not None else None)
    eng.cache.prefix.drop_all(eng.cache.allocator)
    alloc = eng.cache.allocator
    if (alloc.num_used or alloc.allocs_total != alloc.frees_total
            or eng.has_inflight()):
        fail(f"sched {name}: allocator not balanced ({alloc.stats()})")
    pool = eng.adapters
    if pool is not None and any(pool._pins.values()):
        fail(f"sched {name}: adapter pins left after the drain "
             f"({pool._pins})")
    gen_tokens = sum(len(h.tokens) for h in handles)
    rec = dict(run=name, kv=kv or "bf16", fused=fused, overlap=overlap,
               budget=budget, spec={k: v for k, v in spec.items()},
               requests=len(handles), burst=len(highs or ()),
               generated_tokens=gen_tokens, wall_s=wall, steps=steps,
               step_ms_mean=wall * 1e3 / steps,
               tokens_per_s=gen_tokens / wall,
               max_plan_tokens=max(plans),
               host_frac_ema=sched.host_frac_ema,
               idle_fences_total=sched.idle_fences_total,
               preemptions_total=sched.preemptions_total,
               resumes_total=sched.resumes_total, forwards=f,
               launches=counts,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if eng.spec is not None:
        rec.update({k: st[k] for k in ("spec_drafted_total",
                                       "spec_accepted_total",
                                       "spec_verify_steps")})
    rec["dispatch_ms_per_step"] = tally["dispatch_s"] * 1e3 / steps
    rec["commit_ms_per_step"] = tally["commit_s"] * 1e3 / steps
    rec["other_host_ms_per_step"] = (rec["step_ms_mean"]
                                     - rec["dispatch_ms_per_step"]
                                     - rec["commit_ms_per_step"])
    if sync_check:
        rec["dispatch_calls_without_sync"] = tally["calls"]
    if tier is not None:
        rec["tier"] = tier
        rec["scatter_host_ms"] = {k: v * 1e3 for k, v in
                                  eng.cache.scatter_host_s.items()}
    if pool is not None:
        rec["adapters"] = pool.stats()
        rec["adapter_rows"] = sum(1 for i in ids if i)
    if dfa is not None:
        rec.update(
            constrained=sum(g is not None for g in grammars),
            dfa_host_ms_per_step=dfa["s"] * 1e3 / steps,
            mask_upload_host_ms_per_step=dfa["upload_s"] * 1e3 / steps,
            dfa_mask_calls=dfa["mask"], dfa_advance_calls=dfa["advance"],
            mask_uploads=eng.cmask_uploads, decode_steps=f["decode"],
            constrained_preempted=sum(
                h.preemptions for h, g in zip(handles, grammars)
                if g is not None))
        rec["handles"] = handles
    rec["tokens"] = [list(h.tokens) for h in handles]
    del eng, sched, handles
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def profile_sched(torch, Engine, Scheduler, params, cfg, reqs,
                  overlap: bool, steps: int = 8, grammar=None):
    """Where a scheduler step's time goes (bf16 KV, fused, no budget):
    submit 8 requests, drive until every prefill is done, then trace
    ``steps`` scheduler steps of the 8 decoding rows with
    ``torch.profiler``, synchronous or overlapped; with ``grammar`` (a
    token DFA) every request carries it on a ``constraints=True``
    engine. Launches made here are not counted on the main path."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 prefill_chunk=256, fused=True, overlap=overlap,
                 constraints=grammar is not None)
    sched = Scheduler(eng)
    for p, _ in reqs[:8]:
        sched.submit(p, max_new_tokens=128, constraint=grammar)
    while eng.pending_prefills() or any(sched._queues.values()):
        sched.step()
    sched.step()                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        sched.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rec = device_breakdown(torch, prof, steps, wall)
    rec.update(overlap=overlap, rows=int(eng.cache.active.sum()),
               host_frac_ema=sched.host_frac_ema,
               constrained=grammar is not None)
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_scheduler(torch, kernels, cfg, seed: int, reqs, yardstick):
    """Phase 3e: the SLO scheduler over the engine at ``cfg``'s width
    and depth, on fresh weights from phase 3's seed. Burst runs
    (``SCHED_BUDGET``, the HIGH burst) for
    KV bf16 and int8 with the fused kernels and bf16 without, each
    synchronous and overlapped (bf16 fused in turns: sync, overlap,
    overlap, sync, so that the spread of one mode is seen beside the
    gap between them); a no-budget, no-burst set in the same turns that
    must be token-identical; an overlapped n-gram run and a short plain
    one with every dispatch under the sync debug mode; profiled windows
    in the same turns. Greedy-token agreement of each burst run with
    its synchronous twin, and of the bf16 fused ones with the no-budget
    run (the same requests uninterrupted), is reported beside phase 3's
    fused-vs-unfused yardstick."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine as E
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.serving import Priority, ServingScheduler as S
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    highs = burst_requests(4, cfg.vocab_size, seed + 7)
    turns = (False, True, True, False)
    runs, agreement = [], {}

    def in_turns(stem, modes, *a, **kw):
        out = {}
        for i, overlap in enumerate(modes):
            name = (f"{stem}-{'overlap' if overlap else 'sync'}"
                    + ("-2" if overlap in modes[:i] else ""))
            rec = run_sched(torch, kernels, E, S, Priority, params, cfg,
                            *a, name=name, overlap=overlap, **kw)
            print("sched " + show(rec))
            runs.append(rec)
            out.setdefault(overlap, []).append(rec)
        return out

    for kv, fused in ((None, True), ("int8", True), (None, False)):
        tag = f"{'int8' if kv else 'bf16'}-{'fused' if fused else 'unfused'}"
        pair = in_turns(f"burst-{tag}",
                        turns if (kv, fused) == (None, True)
                        else (False, True), reqs, highs, kv=kv, fused=fused)
        sync, ov = pair[False][0]["tokens"], pair[True][0]["tokens"]
        agreement[tag] = {"overlap_vs_sync": token_agreement(ov, sync)}
        if tag == "bf16-fused":
            burst = (sync, ov)
    pair = in_turns("nobudget-bf16-fused", turns, reqs, None, budget=None)
    toks = [r["tokens"] for rs in pair.values() for r in rs]
    if any(t != toks[0] for t in toks):
        fail("sched: the no-budget runs are not token-identical, "
             f"{[token_agreement(t, toks[0]) for t in toks]}")
    agreement["nobudget_overlap_vs_sync"] = token_agreement(toks[-1],
                                                            toks[0])
    n = len(reqs)
    agreement["bf16-fused"].update(
        sync_vs_uninterrupted=token_agreement(burst[0][:n], toks[0]),
        overlap_vs_uninterrupted=token_agreement(burst[1][:n], toks[0]))
    # every dispatch under the sync debug mode: an overlapped n-gram run
    # (verify and prefill dispatches) and a short plain one (decode)
    for name, sub, spec, kinds in (
            ("ngram-overlap-nosync", reqs[:8], {"spec_k": 4},
             ("spec_dispatch", "prefill_dispatch")),
            ("plain-overlap-nosync", reqs[:4], {},
             ("decode_dispatch", "prefill_dispatch"))):
        rec = run_sched(torch, kernels, E, S, Priority, params, cfg, sub,
                        None, name, overlap=True, sync_check=True, **spec)
        calls = rec["dispatch_calls_without_sync"]
        if not all(calls[k] for k in kinds) or (
                spec and not rec["forwards"]["verify"]):
            fail(f"sched {name}: a dispatch kind did not run under the "
                 f"sync check ({calls}, forwards {rec['forwards']})")
        print("sched " + show(rec))
        runs.append(rec)
    agreement["plain_fused_vs_unfused"] = yardstick
    print("sched agreement " + json.dumps(agreement))
    profiles = []
    for overlap in turns:
        p = profile_sched(torch, E, S, params, cfg, reqs, overlap)
        profiles.append(p)
        print("sched profile " + json.dumps(p))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "agreement": agreement, "profiles": profiles}


# --------------------------------------------------------------- phase 3f
#: the tool call the JSON requests must emit: an enum, a string, an
#: integer and a boolean (``json_schema_dfa``'s subset), keys in order
TOOL_SCHEMA = {"type": "object", "properties": {
    "tool": {"enum": ["search", "book", "cancel"]},
    "city": {"type": "string"}, "days": {"type": "integer"},
    "metric": {"type": "boolean"}}}
LIST_REGEX = "[a-z]+(,[a-z]+)*"
CONSTRAINED_NEW = 64    # new tokens of every phase 3f request
# the JSON requests of the sync-checked run, which samples: a string
# field closes with a token that holds a quote, ~2% of the tokens it
# admits, so 64 tokens rarely reach the closing brace (and greedy
# decoding of random weights repeats one token inside the string)
LONG_JSON_NEW = 256
CONSTRAINED_EOS = 2


def synthetic_vocab(vocab: int, seed: int) -> list:
    """Token strings for the grammar lift (there is no tokenizer in the
    repository): ids 0-2 empty (pad, bos, eos: never admitted by a
    regex), ids 3-97 the 95 printable ASCII characters, the rest seeded
    strings of 2-6 characters drawn from letters, digits and
    ``{}":,_-`` and space."""
    import numpy as np
    rs = np.random.RandomState(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                    '0123456789{}":,_- ')
    toks = ["", "", ""] + [chr(c) for c in range(32, 127)]
    while len(toks) < vocab:
        toks.append("".join(rs.choice(alphabet, int(rs.randint(2, 7)))))
    return toks[:vocab]


def walk(dfa, tokens, eos):
    """Hold ``tokens`` to ``dfa`` from its table alone: each token before
    the last has a live transition from the state the ones before it
    reached; an eos comes only as the last token, from an accepting
    state, a dead end (no live transition) or a live eos transition.
    With no eos id, a state with no live transition ends the grammar
    (the rest runs free). Returns (state reached, ended in eos)."""
    s = dfa.start
    for i, t in enumerate(int(t) for t in tokens):
        live = dfa.next[s] >= 0
        if eos is not None and t == eos:
            if not (dfa.accepting[s] or not live.any() or live[eos]):
                fail(f"eos at position {i} from state {s}, which is "
                     f"neither accepting nor a dead end")
            if i != len(tokens) - 1:
                fail(f"tokens after eos at position {i}")
            return s, True
        if eos is None and not live.any():
            return s, False
        if not live[t]:
            fail(f"token {t} at position {i} is not admitted from state "
                 f"{s}: {list(tokens)}")
        s = int(dfa.next[s, t])
    return s, False


def check_tool_call(text: str):
    """``text`` is a JSON object with ``TOOL_SCHEMA``'s keys, in order,
    and types."""
    try:
        obj = json.loads(text)
    except ValueError as e:
        fail(f"an eos-ended JSON request does not parse ({e}): {text!r}")
    props = TOOL_SCHEMA["properties"]
    ok = (isinstance(obj, dict) and list(obj) == list(props)
          and obj["tool"] in props["tool"]["enum"]
          and isinstance(obj["city"], str)
          and type(obj["days"]) is int and type(obj["metric"]) is bool)
    if not ok:
        fail(f"an eos-ended JSON request breaks the schema: {text!r}")
    return obj


def build_grammars(serving, toks, vocab: int, seed: int):
    """The phase's three grammars over the synthetic table: the tool
    call (``json_schema_dfa``), a menu of 16 seeded sequences of 4-12
    tokens (``dfa_from_sequences``) and a comma list
    (``dfa_from_regex``); each with its compile seconds and table MB."""
    import numpy as np
    rs = np.random.RandomState(seed)
    menu = [rs.randint(3, vocab, (int(rs.randint(4, 13)),)).tolist()
            for _ in range(16)]
    out, info = {}, {}
    for name, build in (
            ("json", lambda: serving.json_schema_dfa(TOOL_SCHEMA, toks)),
            ("menu", lambda: serving.dfa_from_sequences(menu, vocab)),
            ("list", lambda: serving.dfa_from_regex(LIST_REGEX, toks))):
        t0 = time.perf_counter()
        out[name] = build()
        info[name] = dict(compile_s=time.perf_counter() - t0,
                          states=out[name].num_states,
                          table_mb=out[name].next.nbytes / 2**20)
    return out, menu, info


def time_dfa_work():
    """Time ``ConstraintState.mask`` and ``advance`` (the engine's DFA
    work: building mask rows, advancing states) on the host clock until
    ``tally["restore"]()`` puts the methods back."""
    from paddle_tpu_torch.serving.constraints import ConstraintState as C
    tally = {"s": 0.0, "mask": 0, "advance": 0, "upload_s": 0.0}
    orig = {n: getattr(C, n) for n in ("mask", "advance")}

    def timed(name, fn):
        def wrapper(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                tally["s"] += time.perf_counter() - t0
                tally[name] += 1
        return wrapper

    for n, fn in orig.items():
        setattr(C, n, timed(n, fn))
    tally["restore"] = lambda: [setattr(C, n, fn) for n, fn in orig.items()]
    return tally


def check_constrained(rec, grammars, kinds, toks, menu):
    """A phase 3f run's outputs: every constrained request walks its
    DFA (``walk``); an eos-ended JSON request decodes through the
    synthetic table to a tool call (``check_tool_call``); an eos-ended
    menu request emitted exactly one menu sequence. Returns the counts
    of eos-ended requests by grammar."""
    ended = {}
    for h, g, k in zip(rec.pop("handles"), grammars, kinds):
        if g is None:
            continue
        _, eos = walk(g, h.tokens, CONSTRAINED_EOS)
        ended[k] = ended.get(k, 0) + int(eos)
        body = [int(t) for t in h.tokens[:-1]] if eos else None
        if eos and k == "json":
            check_tool_call("".join(toks[t] for t in body))
        if eos and k == "menu" and body not in menu:
            fail(f"an eos-ended menu request emitted {body}, no menu "
                 f"sequence")
    return ended


def run_constrained(torch, kernels, cfg, seed: int, reqs):
    """Phase 3f: grammar-constrained serving under the SLO scheduler at
    ``cfg``'s width and depth, on fresh weights from phase 3's seed,
    with eos id 2.

    Grammars over a seeded synthetic table of ``cfg.vocab_size`` token
    strings (``synthetic_vocab``, ``build_grammars``). Phase 3's
    prompts, 64 new tokens each: requests with ``i % 4`` in (0, 1)
    carry the tool-call JSON grammar, 2 the menu, 3 none; submitted as
    alternating NORMAL and LOW, so that phase 3e's HIGH burst preempts
    JSON requests (and free ones).

    1. The identity gate (bf16 fused, no budget, no burst), in turns: a
       free run on a ``constraints=False`` engine, then each request
       under ``dfa_from_sequences([its own free-run tokens])``,
       synchronous and overlapped, then all requests free on a
       ``constraints=True`` engine, then the free run overlapped: all
       token-identical (masking only excludes; the batches are the
       same). The step ms and tokens/s of these runs compare the cost
       of the constraints at equal work.
    2. Burst runs (budget 384, the HIGH burst after 8 steps): KV bf16
       and int8 fused, synchronous and overlapped, and bf16 unfused
       (B9) synchronous. Each: every constrained request walks its DFA,
       eos-ended JSON parses to the schema, eos-ended menu requests
       emitted one sequence, a constrained request was preempted (and
       so resumed: every request finishes), the allocator balances and
       launches equal the counted forwards (``run_sched``).
    3. An overlapped, sampled (temperature 0.9) run of 8 requests
       (4 JSON, 2 list, a menu and a free one; the JSON ones with
       ``LONG_JSON_NEW`` new tokens, room for the string field to
       close, and at least one must end in eos and parse) with every
       ``decode_dispatch`` and ``prefill_dispatch`` under
       ``set_sync_debug_mode("error")``, the mask uploads included.
    4. ``torch.profiler`` windows of 8 decoding rows (``profile_sched``,
       synchronous), free and then all under the JSON grammar."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine as E
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving import Priority, ServingScheduler as S
    V = cfg.vocab_size
    toks = synthetic_vocab(V, seed + 11)
    grammars, menu, info = build_grammars(serving, toks, V, seed + 12)
    for name, rec in info.items():
        print(f"grammar {name}: " + json.dumps(rec))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    highs = burst_requests(4, V, seed + 7)
    creqs = [(p, CONSTRAINED_NEW) for p, _ in reqs]
    kinds = [("json", "json", "menu", "free")[i % 4]
             for i in range(len(creqs))]
    mixed = [grammars[k] if k != "free" else None for k in kinds]
    runs, out = [], {"grammars": info}

    def one(name, rqs, hs, **kw):
        rec = run_sched(torch, kernels, E, S, Priority, params, cfg, rqs,
                        hs, name, eos=CONSTRAINED_EOS, **kw)
        runs.append(rec)
        return rec

    # 1. the identity gate, in turns
    free = one("free-sync", creqs, None, budget=None)
    print("constrained " + show(free))
    own = [serving.dfa_from_sequences([t], V) for t in free["tokens"]]
    gate = [("own-sync", own, False), ("own-overlap", own, True),
            ("allfree-sync", [None] * len(creqs), False)]
    for name, g, overlap in gate:
        rec = one(name, creqs, None, budget=None, grammars=g,
                  overlap=overlap)
        if g is own:
            check_constrained(rec, own, ["own"] * len(own), toks, menu)
        else:
            rec.pop("handles")
        print("constrained " + show(rec))
        if rec["tokens"] != free["tokens"]:
            fail(f"constrained {name}: not token-identical to the free "
                 f"run, {token_agreement(rec['tokens'], free['tokens'])}")
    rec = one("free-overlap", creqs, None, budget=None, overlap=True)
    print("constrained " + show(rec))
    if rec["tokens"] != free["tokens"]:
        fail("constrained free-overlap: not token-identical to free-sync")
    # 2. burst runs under the budget
    ended = {}
    for kv, fused, overlap in ((None, True, False), (None, True, True),
                               ("int8", True, False), ("int8", True, True),
                               (None, False, False)):
        name = (f"burst-{'int8' if kv else 'bf16'}-"
                f"{'fused' if fused else 'unfused'}-"
                f"{'overlap' if overlap else 'sync'}")
        rec = one(name, creqs, highs, kv=kv, fused=fused, overlap=overlap,
                  grammars=mixed)
        ended[name] = check_constrained(rec, mixed, kinds, toks, menu)
        rec["eos_ended"] = ended[name]
        print("constrained " + show(rec))
        if len(creqs) >= 8 and not rec["constrained_preempted"]:
            fail(f"constrained {name}: no constrained request was "
                 f"preempted by the HIGH burst")
    # 3. every dispatch under the sync debug mode
    k8 = ["json", "list", "json", "menu", "json", "free", "json", "list"]
    r8 = [(p, LONG_JSON_NEW if k == "json" else CONSTRAINED_NEW)
          for (p, _), k in zip(creqs[:8], k8)]
    g8 = [grammars[k] if k != "free" else None for k in k8[:len(r8)]]
    rec = one("nosync-overlap", r8, None, overlap=True, sync_check=True,
              grammars=g8, temperature=0.9)
    rec["eos_ended"] = check_constrained(rec, g8, k8, toks, menu)
    ended["nosync-overlap"] = rec["eos_ended"]
    if len(r8) == 8 and not rec["eos_ended"].get("json"):
        fail("constrained nosync-overlap: no JSON request ended in eos "
             f"within {LONG_JSON_NEW} tokens, so none was parsed")
    calls = rec["dispatch_calls_without_sync"]
    if not (calls["decode_dispatch"] and calls["prefill_dispatch"]
            and rec["mask_uploads"]):
        fail(f"constrained nosync-overlap: a dispatch kind or the mask "
             f"upload did not run under the sync check ({calls}, "
             f"{rec['mask_uploads']} uploads)")
    print("constrained " + show(rec))
    # 4. profiled windows, free and constrained
    profiles = []
    for g in (None, grammars["json"]):
        prof = profile_sched(torch, E, S, params, cfg, creqs, False,
                             grammar=g)
        print("constrained profile " + json.dumps(prof))
        profiles.append(prof)
    out.update(runs=runs, profiles=profiles, eos_ended=ended)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 3g
#: the watchdog of the stall run, and how long its injected stall sleeps
#: (past the watchdog, so the supervisor abandons the step thread)
WATCHDOG_S = 5.0
STALL_S = 6.0


def check_recovery(name, before, journal, final):
    """A recovery's gate, per request: the tokens it had committed when
    the faulted step began (``before``) are a prefix of what the journal
    restored it with (``journal``: a request the failing step committed
    more tokens to before the fault keeps them), and those are a prefix
    of its final tokens. A recovery whose journal lost a committed token
    fails the first half. ``before`` / ``final`` map rid -> tokens;
    ``journal`` maps the live rids to their restored tokens."""
    for rid, toks in journal.items():
        b, f = before.get(rid, []), final[rid]
        if list(toks[:len(b)]) != list(b):
            fail(f"supervised {name}: request {rid}'s journal restored "
                 f"{len(toks)} tokens that do not start with the {len(b)} "
                 f"it had committed before the fault")
        if list(f[:len(toks)]) != list(toks):
            fail(f"supervised {name}: request {rid}'s final tokens do not "
                 f"start with the {len(toks)} its journal restored")


def supervised_run(torch, kernels, serving, obs, Engine, params, cfg, reqs,
                   highs, name, site=None, mode="raise", nth=None,
                   watchdog_s=None, stall_s=None, drain_at=None,
                   sync_check=False, hooks=False, plant_drop=False,
                   count_calls=False, **engine_kw):
    """One ``EngineSupervisor`` run over the serving engine (8 slots,
    pages of 16, 2,048 tokens, 256-token chunks, the fused kernels):
    ``reqs`` submitted as alternating NORMAL and LOW, the ``highs`` (if
    any) as HIGH after ``BURST_AT`` steps, stepped to the end. ``site``
    arms one ``mode`` fault at that site's ``nth`` call (the middle of
    its calls in the uninterrupted run); ``drain_at`` drains to a file
    after that many steps and goes on in a restored supervisor, then
    submits one more request on the shared system prompt, which must
    hit the restored prefix trie. Metrics are on in a fault or drain
    run (the fault must count under its site label), ``hooks`` turns
    metrics and request tracing on for the whole run, ``sync_check``
    runs every dispatch under the sync debug mode
    (``instrument_engine``), ``plant_drop`` makes the recovery's
    journal lose one committed token (``check_recovery`` must reject
    it). The launch counters are zeroed before the first step and read
    after the last; they must equal what the forwards of every engine
    the run built imply. Every request finishes with its count, and
    every engine's allocator balances at the end. ``count_calls``
    records each site's calls over the run (``rec["calls"]``), from
    which a later run picks the middle call to fault."""
    import numpy as np
    engines = []

    def factory():
        eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                     prefill_chunk=256, fused=True, **engine_kw)
        engines.append(eng)
        if sync_check:
            tallies.append(instrument_engine(torch, eng, True))
        return eng

    tallies = []
    P = serving.Priority
    inj = serving.FaultInjector(
        stall_s=stall_s if stall_s is not None else 0.1)
    if site is not None:
        inj.arm(site, mode, nth=nth)
    metrics = hooks or site is not None or drain_at is not None
    obs.REGISTRY.clear()
    if metrics:
        obs.enable()
    if hooks:
        obs.tracing.enable()
    sup = serving.EngineSupervisor(factory, token_budget=SCHED_BUDGET,
                                   watchdog_s=watchdog_s,
                                   sleep=lambda s: None)
    recoveries = []
    state = {"before": None}

    def watch(sup):
        orig = sup._recover

        def recover(sync=True):
            if plant_drop:
                # the planted fault: the journal loses the last token a
                # live request had committed before the faulted step
                sup._sync_journal()
                for e in sup.journal.live_entries():
                    b = state["before"].get(e.rid, [])
                    if b:
                        e.tokens = e.tokens[:len(b) - 1] + e.tokens[len(b):]
                        break
                sync = False
            t0 = time.perf_counter()
            orig(sync=sync)
            torch.cuda.synchronize()
            live = sup.journal.live_entries()
            recoveries.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                sessions=len(live),
                swapped_sessions=sum(e.swapped for e in live),
                replayed_tokens=int(sum(
                    e.prompt.size + max(0, len(e.tokens) - 1)
                    for e in live if e.admitted and not e.swapped)),
                journal={e.rid: list(e.tokens) for e in live},
                before=dict(state["before"])))
        sup._recover = recover

    watch(sup)
    handles = [sup.submit(p, max_new_tokens=m,
                          priority=P.LOW if i % 2 else P.NORMAL)
               for i, (p, m) in enumerate(reqs)]
    drained = None
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    steps = 0
    with inj:
        while True:
            if highs and steps == BURST_AT:
                handles += [sup.submit(p, max_new_tokens=m,
                                       priority=P.HIGH) for p, m in highs]
            if drain_at is not None and steps == drain_at:
                # the drain file holds the trie's page bytes (GBs at 32
                # layers): a git-ignored scratch directory of the
                # checkout, removed again, not the run's record dir
                tmp = os.path.join(REPO, "chip_smoke_tmp")
                os.makedirs(tmp, exist_ok=True)
                path = os.path.join(tmp, "drain.npz")
                t_d = time.perf_counter()
                summary = sup.drain(path)
                drain_ms = (time.perf_counter() - t_d) * 1e3
                committed = {h.rid: list(h.tokens) for h in handles}
                old = sup.engine
                t_r = time.perf_counter()
                sup = serving.EngineSupervisor.restore(
                    factory, path, token_budget=SCHED_BUDGET,
                    sleep=lambda s: None)
                torch.cuda.synchronize()
                restore_ms = (time.perf_counter() - t_r) * 1e3
                # the restore's page scatter, host ms by part: read (the
                # file's arrays into tensors), pin, copy (queued)
                restore_split = {k: v * 1e3 for k, v in
                                 sup.engine.cache.scatter_host_s.items()}
                watch(sup)
                handles = [sup.restored.get(h.rid, h) for h in handles]
                # a fresh HIGH request on the system prompt of reqs[0],
                # admitted before the restored sessions' replays claim
                # pages (the trie's pages could be evicted for them)
                sys_p = np.concatenate([reqs[0][0][:200],
                                        reqs[1][0][:56]])
                hits0 = _metric(obs, "serving_prefix_hit_tokens_total")
                handles.append(sup.submit(sys_p, max_new_tokens=16,
                                          priority=P.HIGH))
                drained = dict(summary, drain_ms=drain_ms,
                               restore_ms=restore_ms,
                               restore_scatter_host_ms=restore_split,
                               committed=committed, old_engine=old,
                               hits0=hits0)
                os.remove(path)
            state["before"] = {h.rid: list(h.tokens) for h in handles}
            more = sup.step()
            steps += 1
            if not more:
                break
            if steps > 5000:
                fail(f"supervised {name}: no end after {steps} steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    prefix_hits = _metric(obs, "serving_prefix_hit_tokens_total")
    fault_count = (_metric(obs, "serving_fault_injected_total",
                           f"site={site},kind={mode}") if site else 0)
    obs.disable()
    obs.tracing.disable()
    obs.REGISTRY.clear()
    final = {h.rid: list(h.tokens) for h in handles}
    for h in handles:
        if not h.done or (len(h.tokens) != h.max_new_tokens
                          and h.finish_reason != "eos"):
            fail(f"supervised {name}: request {h.rid} finished "
                 f"{h.finish_reason} with {len(h.tokens)}/"
                 f"{h.max_new_tokens} tokens")
    f = dict.fromkeys(engines[0].forwards, 0)
    for eng in engines:
        for k, v in eng.forwards.items():
            f[k] += v
    L = cfg.num_layers
    e0 = engines[0]
    Ld = e0.draft_cfg.num_layers if e0.draft_cfg is not None else 0
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    want.update(B10=L * f["decode"] + Ld * f["draft_decode"],
                B11=L * (f["prefill"] + f["verify"])
                + Ld * f["draft_catchup"], **{"B11-tree": L * f["tree"]})
    if counts != want:
        fail(f"supervised {name}: launches {counts} != {want} "
             f"(forwards {f})")
    eng = sup.engine
    eng.cache.prefix.drop_all(eng.cache.allocator)
    alloc = eng.cache.allocator
    if (alloc.num_used or alloc.allocs_total != alloc.frees_total
            or eng.has_inflight()):
        fail(f"supervised {name}: allocator not balanced "
             f"({alloc.stats()})")
    if site is not None:
        if not (inj.fired[site] == 1 and inj.fired_total == 1
                and sup.recoveries == 1 == len(recoveries)
                and sup.injected_faults == 1 and fault_count == 1):
            fail(f"supervised {name}: expected one {mode} fault at {site} "
                 f"and one recovery, got {inj.stats()}, "
                 f"{sup.recoveries} recoveries, counter {fault_count}")
        r = recoveries[0]
        check_recovery(name, r["before"], r["journal"], final)
    st = sup.stats()
    gen_tokens = sum(len(h.tokens) for h in handles)
    rec = dict(run=name, kv="bf16", site=site, mode=mode if site else None,
               spec={k: list(v) if isinstance(v, tuple) else v
                     for k, v in engine_kw.items()},
               requests=len(handles), generated_tokens=gen_tokens,
               wall_s=wall, steps=steps, step_ms_mean=wall * 1e3 / steps,
               tokens_per_s=gen_tokens / wall, forwards=f, launches=counts,
               recoveries=sup.recoveries, engines_built=len(engines),
               degraded_level=sup.degraded_level,
               supervised_steps=st["supervised_steps"])
    if recoveries:
        r = recoveries[0]
        rec.update(recovery_ms=r["ms"], recovered_sessions=r["sessions"],
                   swapped_sessions=r["swapped_sessions"],
                   replayed_tokens=r["replayed_tokens"])
    if site is not None and mode == "stall":
        rec["abandoned_engines_held"] = len(sup._abandoned)
    if tallies:
        calls_ = {}
        for t in tallies:
            for k, v in t["calls"].items():
                calls_[k] = calls_.get(k, 0) + v
        rec["dispatch_calls_without_sync"] = calls_
        rec["dispatch_ms_per_step"] = sum(
            t["dispatch_s"] for t in tallies) * 1e3 / steps
        rec["commit_ms_per_step"] = sum(
            t["commit_s"] for t in tallies) * 1e3 / steps
        rec["other_host_ms_per_step"] = (rec["step_ms_mean"]
                                         - rec["dispatch_ms_per_step"]
                                         - rec["commit_ms_per_step"])
    if drained is not None:
        check_recovery(name, drained["committed"],
                       {rid: t for rid, t in drained["committed"].items()
                        if rid in sup.restored}, final)
        if not prefix_hits - drained["hits0"] >= 192:
            fail(f"supervised {name}: the request on the restored system "
                 f"prompt hit {prefix_hits - drained['hits0']} prefix "
                 f"tokens, not 192 or more")
        old = drained.pop("old_engine")
        old.cache.prefix.drop_all(old.cache.allocator)
        for s in range(old.max_batch):
            if old.cache.active[s]:
                old.cache.release(s)
        oa = old.cache.allocator
        if oa.num_used or oa.allocs_total != oa.frees_total:
            fail(f"supervised {name}: the drained engine's allocator is "
                 f"not balanced ({oa.stats()})")
        drained.pop("committed")
        drained.pop("hits0")
        rec.update(drain=drained, restored_sessions=len(sup.restored),
                   restored_prefix_hit_tokens=prefix_hits)
    rec["tokens"] = [final[h.rid] for h in handles]
    if count_calls:
        rec["calls"] = dict(inj.calls)
    del sup, engines, handles
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _metric(obs, name, labels=""):
    m = obs.REGISTRY.to_json().get(name)
    return 0 if m is None else m["values"].get(labels, 0)


def run_supervised(torch, kernels, cfg, seed: int, reqs):
    """Phase 3g: supervised serving (``EngineSupervisor``) at ``cfg``'s
    width and depth, on fresh weights from phase 3's seed, phase 3e's
    requests and HIGH burst, budget 384. An uninterrupted run; one run
    per engine site with a ``raise`` fault at the middle of that site's
    calls in the uninterrupted run of the same engine (``dispatch`` and
    ``commit`` overlapped, ``verify_step`` under n-gram ``spec_k=4``,
    ``draft_propose`` and ``tree_verify`` on the damped draft-tree
    engine of phase 3, after their own uninterrupted runs); ``corrupt``
    at ``transfer``; a stall past the watchdog at ``decode_step``; a
    drain to a file at the middle of the run and a restore; a run whose
    recovery's journal drops one committed token, which the check must
    reject. Then eight requests overlapped with every dispatch under the
    sync debug mode, hooks off, on, on, off. Each run's share of tokens
    that agree with its engine's uninterrupted run, recovery ms and
    replayed tokens are reported, not gated."""
    import numpy as np  # noqa: F401
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.inference import ContinuousBatchingEngine as E
    from paddle_tpu_torch.models.llama import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    highs = burst_requests(4, cfg.vocab_size, seed + 7)
    runs = []

    def go(name, base=None, **kw):
        rec = supervised_run(torch, kernels, serving, obs, E, params, cfg,
                             kw.pop("reqs", reqs), kw.pop("highs", highs),
                             name, **kw)
        if base is not None:
            rec.update(token_agreement(rec["tokens"], base["tokens"]))
        print("supervised " + show(rec))
        runs.append(rec)
        return rec

    def mid(base, site):
        n = base["calls"].get(site, 0)
        if n < 2:
            fail(f"supervised: site {site} was called {n} times in "
                 f"{base['run']}; a fault cannot go in its middle")
        return n // 2

    plain = go("uninterrupted", count_calls=True)
    for site, kw in (("alloc", {}), ("free", {}), ("decode_step", {}),
                     ("prefill_chunk", {}), ("transfer", {}),
                     ("sched_tick", {}), ("dispatch", {"overlap": True}),
                     ("commit", {"overlap": True})):
        go(f"fault-{site}", plain, site=site, nth=mid(plain, site), **kw)
    go("corrupt-transfer", plain, site="transfer", mode="corrupt",
       nth=mid(plain, "transfer"))
    go("stall-decode_step", plain, site="decode_step", mode="stall",
       nth=mid(plain, "decode_step"), watchdog_s=WATCHDOG_S,
       stall_s=STALL_S)
    go("drain-restore", plain, drain_at=plain["steps"] // 2)
    ngram = go("uninterrupted-ngram", plain, count_calls=True, spec_k=4)
    go("fault-verify_step", ngram, site="verify_step",
       nth=mid(ngram, "verify_step"), spec_k=4)
    # the planted fault: the check must reject a recovery whose journal
    # lost a committed token
    try:
        supervised_run(torch, kernels, serving, obs, E, params, cfg,
                       reqs[:8], None, "planted-drop", site="decode_step",
                       nth=40, plant_drop=True)
    except SystemExit as e:
        if "journal restored" not in str(e):
            raise
        print(f"supervised planted-drop: rejected, as it must be ({e})")
    else:
        fail("supervised: a recovery whose journal dropped a committed "
             "token passed the check")
    obs.disable()
    obs.REGISTRY.clear()
    gc.collect()
    torch.cuda.empty_cache()
    # hooks off and on in turns, every dispatch under the sync check
    hooks = []
    for on in (False, True, True, False):
        hooks.append(go(f"hooks-{'on' if on else 'off'}", reqs=reqs[:8],
                        highs=None, hooks=on, sync_check=True,
                        overlap=True))
        if not all(hooks[-1]["dispatch_calls_without_sync"][k] for k in
                   ("decode_dispatch", "prefill_dispatch")):
            fail(f"supervised hooks: a dispatch kind did not run under "
                 f"the sync check ({hooks[-1]})")
    hooks_ms = {k: [r["step_ms_mean"] for r in hooks
                    if r["run"] == f"hooks-{k}"] for k in ("off", "on")}
    hooks_host = {k: [r["dispatch_ms_per_step"] + r["commit_ms_per_step"]
                      for r in hooks if r["run"] == f"hooks-{k}"]
                  for k in ("off", "on")}
    print("supervised hooks " + json.dumps(
        {"step_ms": hooks_ms, "dispatch_plus_commit_ms": hooks_host}))
    # the draft-tree engine of phase 3, on the damped weights
    draft_layers = max(1, cfg.num_layers // 2)
    damp_draft_tail(params, draft_layers)
    tree_kw = dict(draft_layers=draft_layers, spec_tree=(2, 4))
    tree = go("uninterrupted-tree", None, count_calls=True, **tree_kw)
    for site in ("draft_propose", "tree_verify"):
        go(f"fault-{site}", tree, site=site, nth=mid(tree, site),
           **tree_kw)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for r in runs:
        r.pop("calls", None)
    return {"runs": runs, "hooks_step_ms": hooks_ms,
            "hooks_dispatch_plus_commit_ms": hooks_host}


# --------------------------------------------------------------- phase 3h
RESUME_TOKENS = 600     # the resume turns' victim: about this many tokens
STORE_PREFIX = 192      # system-prompt tokens in full pages of 16


def page_copy(torch, cache, slot, k=None):
    """Device copies of the first ``k`` pages of ``slot`` (all of them
    when None), one tensor per pool array; queued without a sync (the
    ids go up as the cache sends its own)."""
    ids = cache.pages_held(slot)
    idx = cache._ids(ids[:len(ids) if k is None else k])
    return {n: a.index_select(1, idx) for n, a in cache.pool.items()}


def pages_equal(torch, got, want) -> bool:
    """Byte equality of two page copies (``page_copy``)."""
    return set(got) == set(want) and all(
        got[n].shape == want[n].shape
        and torch.equal(got[n].view(torch.uint8), want[n].view(torch.uint8))
        for n in got)


def timed(torch, fn, *a, **k):
    """``fn(*a, **k)`` between two card synchronizations; returns
    (result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def balanced(eng, what):
    """The engine's allocator after a drain: every page back, every
    reference dropped once (the prefix trie's dropped first)."""
    if eng.cache.prefix is not None:
        eng.cache.prefix.drop_all(eng.cache.allocator)
    alloc = eng.cache.allocator
    if (alloc.num_used or alloc.allocs_total != alloc.frees_total
            or eng.has_inflight() or eng.cache.active.any()):
        fail(f"{what}: allocator not balanced ({alloc.stats()})")


def resume_turns(torch, Engine, params, cfg, reqs, kv):
    """One decode-phase victim of about ``RESUME_TOKENS`` tokens among
    eight decoding requests, preempted and resumed in turns: replay,
    swap, swap, replay. A replay turn evicts the pages and resumes
    through the prefill chunks (B11); a swap turn swaps them out to
    pinned host memory and back in by one scatter, and its pages must
    come back byte-equal. Each turn is timed between card
    synchronizations, with the bytes moved, the replayed tokens and
    the swap-in's host time split into read, pin and copy. The prefix
    cache is off, so that a replay resumes every token it held: with
    the trie on, the prompt's pages survive the eviction under the
    trie's references and only the rest replays (the burst runs' case).
    """
    eng = Engine(params, cfg, max_batch=8, page_size=16, max_len=2048,
                 kv_cache_dtype=kv, prefill_chunk=256, fused=True,
                 enable_prefix_cache=False, host_tier=True)
    cands = sorted(reqs, key=lambda r: abs(r[0].size - RESUME_TOKENS))
    hs = [eng.submit(p, max_new_tokens=m) for p, m in cands[:8]]
    victim = hs[0]
    while not all(len(h.tokens) >= 2 for h in hs):
        eng.step()
    cache = eng.cache
    turns = []
    for mode in ("replay", "swap", "swap", "replay"):
        if victim.done or victim.max_new_tokens - len(victim.tokens) < 2:
            fail(f"host tier resume turns: the victim ran out of tokens "
                 f"({len(victim.tokens)}/{victim.max_new_tokens})")
        k = cache.pages_for(int(cache.lengths[victim.slot]))
        before = page_copy(torch, cache, victim.slot, k)
        out0 = cache.swap_out_bytes_total
        split0 = dict(cache.scatter_host_s)
        if mode == "replay":
            eng.swap_candidate = lambda r: False
        try:
            _, out_ms = timed(torch, eng.preempt_request, victim)
        finally:
            eng.__dict__.pop("swap_candidate", None)
        if (mode == "swap") != victim.swapped:
            fail(f"host tier resume turns: a {mode} turn left swapped="
                 f"{victim.swapped}")

        def resume():
            if not eng.admit_request(victim):
                fail("host tier resume turns: no free slot to resume in")
            ent = eng._pending.get(victim.slot)
            if ent is None:
                return 0
            replay = ent[1].size - ent[2]
            while victim.slot in eng._pending:
                eng.prefill_step(victim.slot)
            return replay
        replayed, in_ms = timed(torch, resume)
        turn = dict(mode=mode, tokens=int(cache.lengths[victim.slot]),
                    pages=k, out_ms=out_ms, in_ms=in_ms,
                    replayed_tokens=int(replayed))
        if mode == "swap":
            if replayed or not pages_equal(
                    torch, page_copy(torch, cache, victim.slot, k), before):
                fail("host tier resume turns: the swapped-in pages are not "
                     "byte-equal to the swapped-out ones")
            turn.update(
                bytes=cache.swap_out_bytes_total - out0,
                in_host_ms=cache.swap_in_ms[-1],
                in_scatter_host_ms={
                    n: (cache.scatter_host_s[n] - split0[n]) * 1e3
                    for n in split0})
        elif not replayed:
            fail("host tier resume turns: a replay turn replayed nothing")
        turns.append(turn)
        print(f"host_tier resume {kv or 'bf16'} " + json.dumps(turn))
        eng.step()
    eng.run()
    if not all(h.done for h in hs):
        fail("host tier resume turns: a request did not finish")
    tier = cache.tier_stats()
    if not (tier["swap_outs_total"] == tier["swap_ins_total"] == 2
            and tier["swap_replay_fallbacks"] == 0):
        fail(f"host tier resume turns: swaps not counted once each: {tier}")
    balanced(eng, "host tier resume turns")
    del eng, hs
    gc.collect()
    torch.cuda.empty_cache()
    return turns


def swap_counting(torch, calls):
    """``run_sched`` setup for a host-tier run: count and time the
    cache's swap-outs and swap-ins (``calls``), and keep the first two
    swap-outs' pages on the card to hold their swap-ins against."""
    def setup(eng):
        cache = eng.cache
        out, inn = cache.swap_out, cache.swap_in

        def swap_out(slot, rid, nonblocking=False):
            if len(calls["kept"]) < 2:
                calls["kept"][rid] = page_copy(
                    torch, cache, slot,
                    cache.pages_for(int(cache.lengths[slot])))
            t0 = time.perf_counter()
            freed = out(slot, rid, nonblocking=nonblocking)
            calls["out"] += 1
            calls["out_host_ms"].append((time.perf_counter() - t0) * 1e3)
            return freed

        def swap_in(slot, rid, total_tokens, expect_tokens):
            n = inn(slot, rid, total_tokens, expect_tokens)
            calls["in"] += 1
            kept = calls["kept"].pop(rid, None)
            if n is not None and kept is not None:
                calls["checked"] += 1
                if not pages_equal(torch, page_copy(
                        torch, cache, slot, cache.pages_for(n)), kept):
                    fail(f"host tier: request {rid}'s swapped-in pages are "
                         f"not byte-equal to its swapped-out ones")
            return n
        cache.swap_out, cache.swap_in = swap_out, swap_in
    return setup


def host_sched_run(torch, kernels, obs, serving, E, params, cfg, reqs,
                   highs, name, host, **kw):
    """One phase-3e burst run (``run_sched``), on a host-tier engine
    when ``host``, with metrics on: every swap-out counted once by the
    cache, the hooks and the wrapper, every swapped victim resumed once
    (by swap-in or a counted fallback), the first swap-ins byte-equal."""
    calls = {"out": 0, "in": 0, "checked": 0, "kept": {},
             "out_host_ms": []}
    spec = dict(host_tier=True, host_tier_kw={"persist_prefix": False},
                setup=swap_counting(torch, calls)) if host else {}
    obs.REGISTRY.clear()
    obs.enable()
    try:
        rec = run_sched(torch, kernels, E, serving.ServingScheduler,
                        serving.Priority, params, cfg, reqs, highs, name,
                        **kw, **spec)
        metric = {n: _metric(obs, f"serving_{n}_total")
                  for n in ("swap_outs", "swap_ins",
                            "swap_replay_fallbacks",
                            "resume_replay_tokens")}
        snap = obs.REGISTRY.to_json()
    finally:
        obs.disable()
        obs.REGISTRY.clear()
    rec["host_tier"] = bool(host)
    if host:
        t = rec["tier"]
        if not (t["swap_outs_total"] == metric["swap_outs"] == calls["out"]
                and t["swap_ins_total"] == metric["swap_ins"]
                and t["swap_outs_total"] >= 1
                and t["swap_ins_total"] + t["swap_replay_fallbacks"]
                == t["swap_outs_total"] == calls["in"]
                and calls["checked"] >= 1):
            fail(f"host tier {name}: swaps not counted once each: tier "
                 f"{t}, hooks {metric}, calls {calls}")
        for d in ("out", "in"):
            h = snap.get(f"serving_swap_{d}_ms")
            if h is not None:
                v = next(iter(h["values"].values()))
                rec[f"swap_{d}_ms_mean"] = v["sum"] / max(1, v["count"])
        rec["swap_out_host_ms"] = calls["out_host_ms"]
        rec["swap_in_checked_byte_equal"] = calls["checked"]
    rec["replayed_tokens"] = metric["resume_replay_tokens"]
    print(f"host_tier sched {name}: " + show(rec))
    return rec


def promote_timer(torch, cache, ms):
    """Time every prefix promotion of ``cache`` between card
    synchronizations into ``ms``."""
    promote = cache._promote_prefix

    def timed_promote(prompt):
        n, t = timed(torch, promote, prompt)
        ms.append(t)
        return n
    cache._promote_prefix = timed_promote


def demote_promote(torch, obs, E, params, cfg, reqs, system):
    """Prefix demote and promote on a small pool: the system prompt's
    request registers its chain, then the longest request takes all but
    three of the pool's usable pages (the longest that does not share
    the system prompt), so the chain's pages past its first three are
    evicted under pool pressure (demoted to host), and a new request on
    the system prompt promotes them back and hits its 192 tokens."""
    import numpy as np
    long_p = max((r[0] for r in reqs
                  if not np.array_equal(r[0][:system.size], system)),
                 key=lambda p: p.size)
    pages = -(-(long_p.size + 32) // 16)
    eng = E(params, cfg, max_batch=8, page_size=16, max_len=2048,
            prefill_chunk=256, fused=True, num_pages=pages + 4,
            host_tier=True, host_tier_kw={"persist_prefix": False})
    rs = np.random.RandomState(5)
    p1, p2 = (np.concatenate([system, rs.randint(
        3, cfg.vocab_size, (100,)).astype(np.int32)]) for _ in range(2))
    eng.generate([p1], max_new_tokens=16)
    eng.generate([long_p], max_new_tokens=32)
    demoted = eng.cache.demotions_total
    ms = []
    promote_timer(torch, eng.cache, ms)
    obs.REGISTRY.clear()
    obs.enable()
    try:
        eng.generate([p2], max_new_tokens=16)
        hit = _metric(obs, "serving_prefix_hit_tokens_total")
    finally:
        obs.disable()
        obs.REGISTRY.clear()
    rec = dict(pool_pages=pages + 4, demoted_pages=demoted,
               promoted_pages=eng.cache.promote_hits_total, hit_tokens=hit,
               promote_ms=ms, host_pages=eng.cache.host.pages_resident)
    if not (demoted >= 1 and eng.cache.promote_hits_total >= 1
            and hit >= STORE_PREFIX):
        fail(f"host tier demote/promote: {rec}")
    balanced(eng, "host tier demote/promote")
    print("host_tier demote_promote " + json.dumps(rec))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def standing_store(torch, obs, E, params, cfg, system):
    """A restart on a standing prefix store on local disk: one engine
    serves a request on the system prompt and writes its chain through
    to the store; a second engine on the same directory serves another
    request on it, which must promote the system prompt's 12 full pages
    and hit its 192 tokens."""
    import numpy as np
    import shutil
    d = os.path.join(REPO, "chip_smoke_tmp", "store")
    shutil.rmtree(d, ignore_errors=True)
    rs = np.random.RandomState(6)
    p1, p2 = (np.concatenate([system, rs.randint(
        3, cfg.vocab_size, (100,)).astype(np.int32)]) for _ in range(2))
    kw = dict(max_batch=8, page_size=16, max_len=2048, prefill_chunk=256,
              fused=True, host_tier=True,
              host_tier_kw={"prefix_store_dir": d})
    first = E(params, cfg, **kw)
    _, first_ms = timed(torch, first.generate, [p1], max_new_tokens=16)
    files = len(os.listdir(d))
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    del first
    gc.collect()
    eng = E(params, cfg, **kw)
    ms = []
    promote_timer(torch, eng.cache, ms)
    obs.REGISTRY.clear()
    obs.enable()
    try:
        eng.generate([p2], max_new_tokens=16)
        hit = _metric(obs, "serving_prefix_hit_tokens_total")
    finally:
        obs.disable()
        obs.REGISTRY.clear()
    rec = dict(files=files, store_bytes=nbytes, first_run_ms=first_ms,
               promoted_pages=eng.cache.promote_hits_total, hit_tokens=hit,
               promote_ms=ms, quarantined=eng.cache.host.quarantined_total)
    if not (eng.cache.promote_hits_total == STORE_PREFIX // 16
            and hit >= STORE_PREFIX and rec["quarantined"] == 0):
        fail(f"host tier standing store: {rec}")
    balanced(eng, "host tier standing store")
    shutil.rmtree(d, ignore_errors=True)
    print("host_tier standing_store " + json.dumps(rec))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def handoff_and_defrag(torch, E, params, cfg, reqs):
    """The prefill→decode handoff between two engines on the same
    weights: one request prefilled on the first, handed to the second
    host-staged (``export_prefilled`` → ``import_prefilled``) and page
    to page (``src_engine``); its pages must land byte-equal and its
    tokens equal in-place decode on one engine. Then ``defrag`` on the
    decode engine after cancelling every other of six prefilled
    requests: every live page moves byte-equal, fragmentation goes to
    0, and the requests finish with the tokens of the same script
    without the defrag."""
    p, new = min(reqs, key=lambda r: abs(r[0].size - RESUME_TOKENS))
    kw = dict(max_batch=8, page_size=16, max_len=2048, prefill_chunk=256,
              fused=True)
    ref = E(params, cfg, **kw)
    want = ref.generate([p], max_new_tokens=new)[0].tolist()
    del ref
    src, dst = E(params, cfg, **kw), E(params, cfg, **kw)
    rec = {}
    for direct in (False, True):
        name = "direct" if direct else "staged"
        # the prefill engine's trie from the last round dropped, so that
        # the prompt prefills whole, in the reference's chunks
        balanced(src, "host tier handoff (prefill engine)")
        req = src.submit(p, max_new_tokens=new)
        src._admit()
        while src.pending_prefills():
            src.prefill_step()
        slot = req.slot
        k = src.cache.pages_for(int(src.cache.lengths[slot]))
        before = page_copy(torch, src.cache, slot, k)
        payload, ex_ms = timed(torch, src.export_prefilled, req,
                               with_kv=not direct)
        ok, im_ms = timed(torch, dst.import_prefilled, req, payload,
                          src_engine=src if direct else None)
        if not ok:
            fail("host tier handoff: no free slot on the decode engine")
        src.finish_handoff(req, slot)
        if not pages_equal(torch, page_copy(torch, dst.cache, req.slot, k),
                           before):
            fail(f"host tier handoff ({name}): the imported pages are not "
                 f"byte-equal to the source's")
        dst.run()
        if req.output.tolist() != want:
            fail(f"host tier handoff ({name}): tokens differ from "
                 f"in-place decode")
        rec[name] = dict(export_ms=ex_ms, import_ms=im_ms, pages=k,
                         bytes=src.cache.page_payload_bytes(k))
        print(f"host_tier handoff {name} " + json.dumps(rec[name]))
    balanced(src, "host tier handoff (prefill engine)")
    del src
    six = sorted(reqs, key=lambda r: r[0].size)[:6]
    outs = []
    for do_defrag in (False, True):
        balanced(dst, "host tier defrag")
        hs = [dst.submit(q, max_new_tokens=m) for q, m in six]
        dst._admit()
        while dst.pending_prefills():
            dst.prefill_step()
        for h in hs[::2]:
            dst.cancel_request(h)
        if do_defrag:
            live = {h.slot: page_copy(torch, dst.cache, h.slot)
                    for h in hs[1::2]}
            frag = dst.cache.allocator.fragmentation()
            moves0 = dst.cache.direct_moves_total
            _, ms = timed(torch, dst.cache.defrag)
            if not (frag > 0 and dst.cache.allocator.fragmentation() == 0
                    and dst.cache.direct_moves_total == moves0 + 1):
                fail(f"host tier defrag: fragmentation {frag} -> "
                     f"{dst.cache.allocator.fragmentation()}")
            for slot, pages in live.items():
                if not pages_equal(torch, page_copy(torch, dst.cache, slot),
                                   pages):
                    fail("host tier defrag: a live page moved with other "
                         "bytes")
            rec["defrag"] = dict(ms=ms, fragmentation_before=frag,
                                 live_pages=dst.cache.allocator.num_used)
            print("host_tier defrag " + json.dumps(rec["defrag"]))
        dst.run()
        outs.append([h.output.tolist() for h in hs[1::2]])
    if outs[0] != outs[1]:
        fail("host tier defrag: tokens after the defrag differ from the "
             "same script without it")
    balanced(dst, "host tier defrag")
    del dst
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_host_tier(torch, kernels, cfg, seed: int, reqs):
    """Phase 3h: the host KV tier at ``cfg``'s width and depth, on fresh
    weights from phase 3's seed. Resume turns (``resume_turns``, bf16
    and int8 KV); phase 3e's burst runs (16 requests, four HIGH, budget
    384, fused) without and with the host tier in turns (bf16 off, on,
    on, off; int8 off, on), the host tier overlapped with every dispatch
    and every ``preempt_request`` (where the swap-out is queued) under
    the sync debug mode, and a run whose first swap-in finds a planted
    corrupt payload, which must end in a counted ``corrupt`` fallback to
    replay; demote / promote on a small pool; a restart on a standing
    store; the handoff and ``defrag`` (``handoff_and_defrag``)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.inference import ContinuousBatchingEngine as E
    from paddle_tpu_torch.models.llama import init_params
    import numpy as np
    import zlib
    from paddle_tpu_torch.serving.resilience import payload_checksums
    # the host's CRC32 rate, which a swap pays twice (stamp, check)
    buf = np.random.RandomState(seed).randint(0, 256, 300 << 20).astype(
        np.uint8)
    crc = {}
    for name, fn in (("threaded", lambda: payload_checksums({"a": buf})),
                     ("one_thread", lambda: zlib.crc32(buf))):
        t0 = time.perf_counter()
        fn()
        crc[name] = (time.perf_counter() - t0) * 1e3
    del buf
    print("host_tier crc32_300MiB_ms " + json.dumps(crc))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    highs = burst_requests(4, cfg.vocab_size, seed + 7)
    out = {"resume": {}, "crc32_300MiB_ms": crc}
    for kv in (None, "int8"):
        out["resume"][kv or "bf16"] = resume_turns(torch, E, params, cfg,
                                                   reqs, kv)
    runs = []

    def go(name, host, base=None, **kw):
        rec = host_sched_run(torch, kernels, obs, serving, E, params, cfg,
                             reqs, highs, name, host, **kw)
        if base is not None:
            rec.update(token_agreement(rec["tokens"], base["tokens"]))
            print(f"host_tier agreement {name} vs {base['run']}: "
                  + json.dumps(token_agreement(rec["tokens"],
                                               base["tokens"])))
        runs.append(rec)
        return rec

    base = go("bf16-replay", False)
    for name, host in (("bf16-swap", True), ("bf16-swap-2", True),
                       ("bf16-replay-2", False)):
        go(name, host, base)
    i8 = go("int8-replay", False, kv="int8")
    go("int8-swap", True, i8, kv="int8")
    ov = go("bf16-swap-overlap", True, base, overlap=True, sync_check=True,
            sync_extra=("preempt_request",))
    calls_ = ov["dispatch_calls_without_sync"]
    if not (calls_["preempt_request"] >= 1 and calls_["decode_dispatch"]
            and calls_["prefill_dispatch"]
            and ov["tier"]["swap_outs_total"] >= 1):
        fail(f"host tier overlap: the sync check saw no swap-out or no "
             f"dispatch ({calls_}, {ov['tier']})")
    with serving.FaultInjector() as inj:
        inj.arm_tamper("swap_in", nth=1)
        bad = go("bf16-swap-corrupt", True, base)
    t = bad["tier"]
    if not (inj.fired["swap_in"] == 1
            and t["corruptions_detected_total"] == 1
            and t["swap_replay_fallbacks"] >= 1
            and t["host_quarantined_total"] == 1):
        fail(f"host tier: the planted corrupt payload was not caught and "
             f"replayed ({t}, fired {inj.fired['swap_in']})")
    # supervised recovery on the host tier: a decode fault soon after the
    # burst, while swapped-out victims wait; recovery swaps them in
    # instead of replaying them
    sup = supervised_run(torch, kernels, serving, obs, E, params, cfg, reqs,
                         highs, "host-fault-decode_step", site="decode_step",
                         nth=2 * BURST_AT, host_tier=True,
                         host_tier_kw={"persist_prefix": False})
    sup.update(token_agreement(sup["tokens"], base["tokens"]))
    print("host_tier supervised " + show(sup))
    runs.append(sup)
    out["runs"] = runs
    system = reqs[0][0][:200]
    out["demote_promote"] = demote_promote(torch, obs, E, params, cfg, reqs,
                                           system)
    out["standing_store"] = standing_store(torch, obs, E, params, cfg,
                                           system)
    out.update(handoff_and_defrag(torch, E, params, cfg, reqs))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 3i
ADAPTER_SLOTS, ADAPTER_RANK, ADAPTERS = 4, 16, 6
#: init scale of the random adapters: A and B ~ N(0, 0.04^2) at rank 16
#: and alpha 16 give dW ~ N(0, 0.0064^2) a weight, 41% of a projection's
#: N(0, 1/4096), so an adapter row's tokens part from the base row's and
#: a swapped slot moves the logits past LOGITS_ATOL
ADAPTER_INIT_SCALE = 0.04
ADAPTER_NEW = 48        # new tokens a request in the identity checks
#: gate (c): at least this share of the adapter rows' generated tokens
#: differ from the same prompts' base-row tokens
ADAPTER_DIFFER_SHARE = 0.25
DECODE_TURNS, DECODE_WINDOW = 4, 32     # decode_turns' windows a mode


def adapter_registry(serving, cfg, seed: int):
    """``ADAPTERS`` random q/o adapters of rank ``ADAPTER_RANK`` from
    ``seed`` (``init_lora``, numpy's ``RandomState``)."""
    reg = serving.AdapterRegistry(cfg)
    for aid in range(1, ADAPTERS + 1):
        reg.register(aid, serving.init_lora(
            cfg, ADAPTER_RANK, seed=seed * 100 + aid,
            scale=ADAPTER_INIT_SCALE))
    return reg


def adapter_engine_run(torch, kernels, E, params, cfg, reqs, ids, name, kv,
                       adapters=None):
    """The engine's own FIFO loop over ``reqs`` with the adapter ids
    ``ids`` (fused, bf16 or int8 KV, pool ``adapters`` or none): every
    request finishes, launches equal the counted forwards (B10 per
    decode, B11 per prefill chunk), the allocator and the pins balance
    after the drain."""
    eng = E(params, cfg, max_batch=8, page_size=16, max_len=2048,
            kv_cache_dtype=kv, prefill_chunk=256, fused=True,
            adapters=adapters)
    handles = [eng.submit(p, max_new_tokens=m, adapter_id=a)
               for (p, m), a in zip(reqs, ids)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    f, L = dict(eng.forwards), cfg.num_layers
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    want.update(B10=L * f["decode"], B11=L * f["prefill"])
    if counts != want:
        fail(f"adapters {name}: launches {counts} != {want} (forwards {f})")
    for h in handles:
        if not h.done or len(h.tokens) != h.max_new_tokens:
            fail(f"adapters {name}: request {h.rid} finished "
                 f"{h.finish_reason} with {len(h.tokens)} tokens")
    balanced(eng, f"adapters {name}")
    pool = eng.adapters
    if pool is not None and any(pool._pins.values()):
        fail(f"adapters {name}: pins left after the drain ({pool._pins})")
    rec = dict(run=name, kv=kv or "bf16", wall_s=wall, forwards=f,
               launches=counts, adapter_rows=sum(1 for a in ids if a),
               tokens=[list(h.tokens) for h in handles])
    if pool is not None:
        rec["adapters"] = pool.stats()
    del eng, handles
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def differ_share(got, base) -> float:
    """Share of the generated positions of ``got`` whose token is not
    ``base``'s at the same position."""
    n = sum(len(a) for a in got)
    same = sum(x == y for a, b in zip(got, base) for x, y in zip(a, b))
    return 1.0 - same / max(1, n)


def adapter_logits_check(torch, gen, serving, E, params, cfg, reqs, reg,
                         kv):
    """Gate (b): four rows on adapters 1-4 prefill through B11 with the
    pool's LoRA term (their prompts in the engine's chunks), then take
    one decode step together through B10; each row's prefill logits and
    decode logits must be within LOGITS_ATOL of a kernel-free forward
    (the plain chunk composition) of the same tokens on weights with
    that adapter dense-merged (``merge_lora``). Then the decode step
    again with rows 0 and 1's pool slots swapped, a planted fault both
    rows must fail."""
    eng = E(params, cfg, max_batch=8, page_size=16, max_len=2048,
            kv_cache_dtype=kv, prefill_chunk=256, fused=True,
            adapters=dict(slots=ADAPTER_SLOTS, rank=ADAPTER_RANK,
                          registry=reg))
    cache, pool = eng.cache, eng.adapters
    rows = [(reqs[i][0], i + 1) for i in range(4)]
    slots, pre, first = [], [], []
    for i, (p, aid) in enumerate(rows):
        slots.append(pool.acquire(aid))
        cache.admit(i, p.size + 1)
        lg = chunked_prefill(torch, gen, eng, i, p, True,
                             adapter_slot=slots[-1])[0].float()
        pre.append(lg)
        first.append(int(lg.argmax()))
    B = eng.max_batch
    lengths = torch.zeros(B, dtype=torch.int32)
    last = torch.zeros(B, dtype=torch.int32)
    active = torch.zeros(B, dtype=torch.bool)
    aslot = torch.zeros(B, dtype=torch.int32)
    for i, (p, _) in enumerate(rows):
        lengths[i], last[i], active[i], aslot[i] = p.size, first[i], True, \
            slots[i]
    tables = torch.from_numpy(cache.block_tables.copy()).cuda()

    def decode(slot_ids):
        dec, _ = gen.paged_decode_forward(
            eng.params, last.cuda(), cache.pool, tables, lengths.cuda(),
            cfg, active=active.cuda(), fused=True,
            adapters=pool.arrays, adapter_slots=slot_ids.cuda())
        return dec.float()

    dec = decode(aslot)
    swapped = aslot.clone()
    swapped[0], swapped[1] = aslot[1], aslot[0]
    bad = decode(swapped)
    import numpy as np
    errs = []
    for i, (p, aid) in enumerate(rows):
        merged = serving.merge_lora(params, cfg, reg.get(aid))
        cache.admit(4, p.size + 1)
        ref_pre = chunked_prefill(torch, gen, eng, 4, p, False,
                                  params=merged)[0].float()
        cache.release(4)
        seq = np.concatenate([p, np.asarray([first[i]], np.int32)])
        cache.admit(4, seq.size)
        ref_dec = chunked_prefill(torch, gen, eng, 4, seq, False,
                                  params=merged)[0].float()
        cache.release(4)
        del merged
        errs.append(dict(
            adapter=aid, prefill_err=(pre[i] - ref_pre).abs().max().item(),
            decode_err=(dec[i] - ref_dec).abs().max().item(),
            swapped_decode_err=(bad[i] - ref_dec).abs().max().item(),
            logits_max_abs=ref_dec.abs().max().item()))
    for i in range(4):
        cache.release(i)
        pool.release(rows[i][1])
    rec = dict(kv=kv or "bf16", rows=errs, atol=LOGITS_ATOL)
    for e in errs:
        if not (e["prefill_err"] <= LOGITS_ATOL
                and e["decode_err"] <= LOGITS_ATOL):
            fail(f"adapters logits {kv or 'bf16'}: row off its merged "
                 f"reference: {e}")
    if not all(errs[i]["swapped_decode_err"] > LOGITS_ATOL for i in (0, 1)):
        fail(f"adapters logits {kv or 'bf16'}: the planted fault (rows 0 "
             f"and 1's slots swapped) passed the check: {errs}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def decode_turns(torch, E, params, cfg, reqs, reg):
    """ms a decode step of 8 rows (bf16 KV, fused) in three modes: no
    pool ("none"), a pool with 4 rows on adapters and the port's factor
    gather once a forward ("forward"), and the same with the gather per
    layer, as the JAX scan does ("layer": ``_adapter_prep`` swapped for
    one that gathers the same values a layer at a time). One engine a
    mode, all prefilled
    first; then ``DECODE_TURNS`` turns of a ``DECODE_WINDOW``-step
    window each, the modes in alternating order (none, forward, layer,
    then layer, forward, none), each window between card
    synchronizations; then a ``torch.profiler`` window of 8 steps a mode
    (``device_breakdown``). Also the adapter term alone
    (``_adapter_prep`` and the 2 x L ``_lora_delta`` of one forward at
    the decode shape), 100 forwards between two synchronizations, in µs
    a forward (and the host's enqueue alone), in both gather modes.
    Each window also reports the host ms of the steps' dispatch
    halves."""
    from paddle_tpu_torch.models import generate as gen
    from torch.profiler import ProfilerActivity, profile
    once = gen._adapter_prep

    def per_layer(adapters, adapter_slots, cfg):
        """``_adapter_prep`` gathering each layer's factors when the
        layer runs, as the JAX scan does: the same values."""
        aslot = adapter_slots.to(device=adapters["scale"].device,
                                 dtype=torch.long).reshape(-1)
        asc = adapters["scale"].index_select(0, aslot).to(cfg.dtype)
        return lambda l: tuple(adapters[n][l].index_select(0, aslot)
                               for n in ("aq", "bq", "ao", "bo")) + (asc,)

    def gather(mode):
        gen._adapter_prep = per_layer if mode == "layer" else once
    modes = ("none", "forward", "layer")
    engines = {}
    for mode in modes:
        ids = [0] * 8 if mode == "none" else [1, 0, 2, 0, 3, 0, 4, 0]
        kw = {} if mode == "none" else {"adapters": dict(
            slots=ADAPTER_SLOTS, rank=ADAPTER_RANK, registry=reg)}
        eng = E(params, cfg, max_batch=8, page_size=16, max_len=2048,
                prefill_chunk=256, fused=True, **kw)
        for (p, _), a in zip(reqs[:8], ids):
            eng.submit(p, max_new_tokens=DECODE_TURNS * DECODE_WINDOW + 24,
                       adapter_id=a)
        while eng._queue or eng.pending_prefills():
            eng.step()
        engines[mode] = eng

    def window(mode, n):
        """ms a step and host ms of its dispatch half, over ``n``
        steps."""
        gather(mode)
        eng = engines[mode]
        disp = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            t1 = time.perf_counter()
            eng.decode_dispatch(eng.ready_mask())
            disp += time.perf_counter() - t1
            eng.commit_inflight()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / n, disp * 1e3 / n)

    out = {m: {"step_ms": [], "dispatch_ms": []} for m in modes}
    try:
        for mode in modes:
            window(mode, 4)                 # warm
        for t in range(DECODE_TURNS):
            for mode in (modes if t % 2 == 0 else modes[::-1]):
                step, disp = window(mode, DECODE_WINDOW)
                out[mode]["step_ms"].append(step)
                out[mode]["dispatch_ms"].append(disp)
        for mode in modes:
            gather(mode)
            eng = engines[mode]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    eng.decode_step(eng.ready_mask())
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 8
            out[mode]["profile"] = device_breakdown(torch, prof, 8, wall)
            out[mode]["rows"] = int(eng.ready_mask().sum())
        pool = engines["forward"].adapters
        aslot = torch.from_numpy(engines["forward"]._aslot.copy()).cuda()
        x = torch.randn((8, 1, cfg.hidden_size), dtype=cfg.dtype).cuda()
        for mode in ("forward", "layer"):
            gather(mode)

            def term():
                ad = gen._adapter_prep(pool.arrays, aslot, cfg)
                for l in range(cfg.num_layers):
                    a = ad(l)
                    gen._lora_delta(x, a[0], a[1], a[4])
                    gen._lora_delta(x, a[2], a[3], a[4])
            for _ in range(5):              # warm
                term()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                term()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out[mode]["term_us_per_forward"] = (
                (time.perf_counter() - t0) * 1e6 / 100)
            out[mode]["term_enqueue_us_per_forward"] = (t1 - t0) * 1e6 / 100
    finally:
        gen._adapter_prep = once
    for mode in modes:
        ms = out[mode]["step_ms"]
        out[mode].update(median_ms=statistics.median(ms),
                         spread_ms=max(ms) - min(ms))
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return out


def install_and_promote(torch, serving, cfg, reg):
    """Install, demote and promote timings on a one-slot pool on the
    card: a registry load into the slot, a load that first demotes the
    resident adapter (into a host store with a standing directory),
    the promotion of the demoted one from RAM, and, in a fresh pool and
    store on the same directory with an empty registry, its promotion
    from the standing store (a warm read). Each between card
    synchronizations; the promoted factors must equal the installed
    ones."""
    import shutil
    d = os.path.join(REPO, "chip_smoke_tmp", "adapters")
    shutil.rmtree(d, ignore_errors=True)
    pool = serving.AdapterPool(cfg, slots=1, rank=ADAPTER_RANK,
                               registry=reg, store=serving.HostPageStore(
                                   page_size=16, path=d))
    rec = {}
    _, rec["install_ms"] = timed(torch, pool.acquire, 1)
    rec["install_bytes"] = pool.load_bytes_total
    want = {n: pool.arrays[n][:, 1].clone() for n in
            serving.FACTOR_NAMES}
    pool.release(1)
    _, rec["demote_and_install_ms"] = timed(torch, pool.acquire, 2)
    rec["demote_bytes"] = pool.demote_bytes_total
    pool.release(2)
    _, rec["promote_ram_ms"] = timed(torch, pool.acquire, 1)
    pool2 = serving.AdapterPool(
        cfg, slots=1, rank=ADAPTER_RANK,
        registry=serving.AdapterRegistry(cfg),
        store=serving.HostPageStore(page_size=16, path=d))
    _, rec["promote_store_ms"] = timed(torch, pool2.acquire, 1)
    for p in (pool, pool2):
        if not (p.promotions_total == 1 and p.fallbacks_total == 0
                and all(torch.equal(p.arrays[n][:, 1], want[n])
                        for n in serving.FACTOR_NAMES)):
            fail(f"adapters promote: {p.stats()}")
    rec["store_files"] = len(os.listdir(d))
    shutil.rmtree(d, ignore_errors=True)
    return rec


def pinned_defer(torch, serving, E, params, cfg, reqs, reg):
    """Gate (d)'s all-pinned case: four NORMAL rows pin the pool's four
    slots (adapters 1-4) beside four LOW base rows, then a NORMAL
    request on adapter 5 arrives. It must wait for a retirement with no
    preemption: a base row's eviction frees no adapter slot."""
    eng = E(params, cfg, max_batch=8, page_size=16, max_len=2048,
            prefill_chunk=256, fused=True,
            adapters=dict(slots=ADAPTER_SLOTS, rank=ADAPTER_RANK,
                          registry=reg))
    sched = serving.ServingScheduler(eng, token_budget=SCHED_BUDGET)
    P = serving.Priority
    hs = [sched.submit(p, max_new_tokens=24 + 8 * (i % 2),
                       priority=P.LOW if i % 2 else P.NORMAL,
                       adapter_id=0 if i % 2 else i // 2 + 1)
          for i, (p, _) in enumerate(reqs[:8])]
    while eng.pending_prefills() or any(sched._queues.values()):
        sched.step()
    late = sched.submit(reqs[8][0], max_new_tokens=8, priority=P.NORMAL,
                        adapter_id=5)
    sched.step()
    waited = late.slot is None and not late.tokens
    sched.run()
    rec = dict(waited=waited, preemptions=sched.preemptions_total,
               adapters=eng.adapters.stats())
    if not (waited and sched.preemptions_total == 0 and late.done
            and all(h.done for h in hs)
            and not any(eng.adapters._pins.values())):
        fail(f"adapters all-pinned: {rec}")
    balanced(eng, "adapters all-pinned")
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def corrupt_first_promotion(counter):
    """A ``setup`` for ``run_sched``: the first demoted adapter payload
    the engine pool's store hands out gets one byte flipped after its
    CRC was stamped (in a copy: the payload's arrays view the
    registry's), and every CRC check of a promotion is counted into
    ``counter``."""
    def setup(eng):
        store = eng.adapters.store
        get = store.get

        def bad_get(key, *a, **k):
            entry = get(key, *a, **k)
            if entry is not None and not counter["planted"]:
                arr = entry["arrays"]["bq"].copy()
                arr.reshape(-1)[7] ^= 0xFF
                entry["arrays"]["bq"] = arr
                counter["planted"] = 1
            return entry
        store.get = bad_get
        count_crc(counter)(eng)
    return setup


def count_crc(counter):
    """A ``setup`` for ``run_sched`` that counts the CRC checks of the
    pool's promotions into ``counter["crc_checks"]``."""
    from paddle_tpu_torch.serving import adapters as ad_mod

    def setup(eng):
        verify = ad_mod.verify_checksums

        def counted(*a, **k):
            counter["crc_checks"] += 1
            return verify(*a, **k)
        ad_mod.verify_checksums = counted
        counter["restore"] = lambda: setattr(ad_mod, "verify_checksums",
                                             verify)
    return setup


def sync_checked_installs(torch, counter):
    """A ``setup`` for ``run_sched``: every install into the engine's
    pool runs under ``torch.cuda.set_sync_debug_mode("error")`` and is
    counted into ``counter["installs"]``."""
    def setup(eng):
        pool = eng.adapters
        install = pool._install

        def checked(*a, **k):
            counter["installs"] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return install(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        pool._install = checked
    return setup


def run_adapters(torch, kernels, cfg, seed: int, reqs):
    """Phase 3i: the multi-tenant adapter pool (slots 4, rank 16, six
    adapters from ``seed``) on the engine at ``cfg``'s width and depth,
    fresh weights from phase 3's seed, KV bf16 and int8, fused. Gates:
    (a) base requests served with the pool are token-identical to the
    same requests without it; (b) adapter rows' prefill and decode
    logits within LOGITS_ATOL of a kernel-free forward on merged
    weights, a swapped slot rejected (``adapter_logits_check``); (c)
    adapter rows' tokens differ from the base rows' in at least
    ``ADAPTER_DIFFER_SHARE`` of positions; (d) under the scheduler
    (phase 3e's requests and HIGH burst, on adapters 0-6) LRU reclaim
    demotes and promotes, every promotion CRC-checked, a planted
    corrupt payload falls back once, counted, with the same tokens, and
    an all-pinned pool defers with no base-row victim; (e) launches
    equal the counted forwards (B10, B11 prefill, B11 verify under
    n-gram ``spec_k=4``); (f) pins and allocators balance, and an
    overlapped run's dispatches and pool installs never sync. Reported:
    ms a decode step of 8 rows without a pool, with one (gather a
    forward) and gathered per layer, in turns, with a profile of the
    card's busy time; install, demote and promote ms and bytes."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.inference import ContinuousBatchingEngine as E
    from paddle_tpu_torch.models import generate as gen
    from paddle_tpu_torch.models.llama import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    reg = adapter_registry(serving, cfg, seed)
    pool_kw = dict(slots=ADAPTER_SLOTS, rank=ADAPTER_RANK, registry=reg)
    out = {"identity": {}, "logits": {}}
    runs = []
    sub = [(p, min(m, ADAPTER_NEW)) for p, m in reqs[:8]]
    for kv in (None, "int8"):
        kvn = kv or "bf16"
        plain = adapter_engine_run(torch, kernels, E, params, cfg, sub,
                                   [0] * 8, f"plain-{kvn}", kv)
        base = adapter_engine_run(torch, kernels, E, params, cfg, sub,
                                  [0] * 8, f"pool-base-{kvn}", kv,
                                  dict(pool_kw))
        if base["tokens"] != plain["tokens"]:
            fail(f"adapters (a) {kvn}: base rows with the pool are not "
                 f"token-identical to the engine without it: "
                 f"{token_agreement(base['tokens'], plain['tokens'])}")
        ids = [1, 2, 3, 4, 1, 2, 3, 4]
        mixed = adapter_engine_run(torch, kernels, E, params, cfg, sub,
                                   ids, f"pool-adapters-{kvn}", kv,
                                   dict(pool_kw))
        share = differ_share(mixed["tokens"], plain["tokens"])
        if share < ADAPTER_DIFFER_SHARE:
            fail(f"adapters (c) {kvn}: only {share:.3f} of the adapter "
                 f"rows' tokens differ from the base rows'")
        out["identity"][kvn] = dict(base_identical=True,
                                    adapter_tokens_differ_share=share)
        for r in (plain, base, mixed):
            print("adapters " + show(r))
        runs += [plain, base, mixed]
        out["logits"][kvn] = adapter_logits_check(
            torch, gen, serving, E, params, cfg, reqs, reg, kv)
        print("adapters logits " + json.dumps(out["logits"][kvn]))
    highs = burst_requests(4, cfg.vocab_size, seed + 7)
    ids = [i % (ADAPTERS + 1) for i in range(len(reqs))] + [5, 6, 0, 3]

    def sched(name, kv=None, setup=None, **kw):
        rec = run_sched(torch, kernels, E, serving.ServingScheduler,
                        serving.Priority, params, cfg, reqs, highs, name,
                        kv=kv, setup=setup, adapter_ids=ids,
                        adapters=dict(pool_kw, store=serving.HostPageStore(
                            page_size=16)), **kw)
        print("adapters sched " + show(rec))
        runs.append(rec)
        return rec

    crc = {"crc_checks": 0, "planted": 0}
    lru = sched("lru-bf16", setup=count_crc(crc))
    crc["restore"]()
    st = lru["adapters"]
    if not (st["adapter_demotions_total"] >= 1
            and st["adapter_promotions_total"] >= 1
            and st["adapter_fallbacks_total"] == 0
            and crc["crc_checks"] == st["adapter_promotions_total"]):
        fail(f"adapters (d): LRU reclaim did not demote and promote with "
             f"the CRC checked ({st}, {crc['crc_checks']} checks)")
    lru["crc_checks"] = crc["crc_checks"]
    print(f"adapters lru-bf16 crc_checks {crc['crc_checks']}")
    i8 = sched("lru-int8", kv="int8")
    if i8["adapters"]["adapter_promotions_total"] < 1:
        fail(f"adapters (d) int8: no promotion ({i8['adapters']})")
    bad = {"crc_checks": 0, "planted": 0}
    cor = sched("lru-corrupt-bf16", setup=corrupt_first_promotion(bad))
    bad["restore"]()
    st = cor["adapters"]
    if not (bad["planted"] and st["adapter_fallbacks_total"] == 1
            and cor["tokens"] == lru["tokens"]):
        fail(f"adapters (d): the planted corrupt payload did not fall "
             f"back once with the same tokens ({st}, "
             f"{token_agreement(cor['tokens'], lru['tokens'])})")
    ngram = sched("ngram-bf16", spec_k=4)
    if not ngram["forwards"]["verify"]:
        fail(f"adapters (e): the n-gram run verified nothing "
             f"({ngram['forwards']})")
    checked = {"installs": 0}
    ov = run_sched(torch, kernels, E, serving.ServingScheduler,
                   serving.Priority, params, cfg, reqs[:8], None,
                   "overlap-nosync-bf16", overlap=True, sync_check=True,
                   setup=sync_checked_installs(torch, checked),
                   adapters=dict(pool_kw), adapter_ids=ids[:8])
    calls = ov["dispatch_calls_without_sync"]
    if not (calls["decode_dispatch"] and calls["prefill_dispatch"]
            and checked["installs"] >= 4):
        fail(f"adapters (f): a dispatch kind or no install ran under the "
             f"sync check ({calls}, {checked})")
    ov["installs_without_sync"] = checked["installs"]
    print("adapters sched " + show(ov))
    runs.append(ov)
    out["pinned_defer"] = pinned_defer(torch, serving, E, params, cfg, reqs,
                                       reg)
    print("adapters pinned " + json.dumps(out["pinned_defer"]))
    out["install"] = install_and_promote(torch, serving, cfg, reg)
    print("adapters install " + json.dumps(out["install"]))
    out["decode"] = decode_turns(torch, E, params, cfg, reqs, reg)
    for mode, t in out["decode"].items():
        print(f"adapters decode {mode} " + json.dumps(t))
    out["runs"] = runs
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 3j
#: the engine sites phase 3j kills the process at (``wal_append`` as a
#: torn write: half a frame reaches the file)
WAL_DEATH_SITES = ("decode_step", "prefill_chunk", "commit", "swap_in",
                   "wal_append", "wal_fsync", "checkpoint_write")
WAL_CKPT_EVERY = 16             # gate (d): a checkpoint every 16 steps
WAL_SEGMENT_BYTES = 16 << 10    # gate (d)'s segments: small, so they rotate
WAL_SEGMENT_SMALL = 4 << 10     # gate (c)'s: a mid-log segment to flip
WAL_DIR_BOUND = 1 << 20         # gate (d): the directory stays under 1 MiB
WAL_TURNS = ("journal-off", "group", "commit", "fsync-off")
WAL_TURN_ROUNDS = 2
#: the supervisor's keywords a timing turn adds (None: no log)
WAL_TURN_KW = {"journal-off": None, "group": {"wal_fsync": "group"},
               "commit": {"wal_fsync": "commit"},
               "fsync-off": {"wal_fsync": "off"}}


class ProcessDied(RuntimeError):
    """Phase 3j's simulated ``kill -9``: raised by a supervisor instead
    of its in-process recovery; the object is then dropped without a
    drain and ``recover_from_disk`` rebuilds from the directory."""


def crashy(sup):
    """Make ``sup`` die at its first failed step."""
    def die(err):
        raise ProcessDied(f"{type(err).__name__}: {err}") from err
    sup._on_failure = die
    return sup


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def wal_engine(E, params, cfg, **kw):
    """Phase 3j's engine: phase 3e's geometry, fused, the host tier on."""
    return E(params, cfg, max_batch=8, page_size=16, max_len=2048,
             prefill_chunk=256, fused=True, host_tier=True, **kw)


def wal_run(torch, kernels, serving, obs, E, params, cfg, reqs, highs,
            name, kv=None, wal=True, site=None, nth=None, shots=1,
            tamper=False, plant_drop=False, overlap=False,
            sync_check=False, count_calls=False, stop_at=None,
            watch_dir=False, sup_kw=None):
    """One supervised run of phase 3e's engine (8 slots, pages of 16,
    2,048 tokens, 256-token chunks, fused, ``host_tier=True``): ``reqs``
    as alternating NORMAL and LOW, ``highs`` as HIGH after ``BURST_AT``
    steps. ``wal`` puts a write-ahead log in a fresh temporary directory
    (``sup_kw`` adds the supervisor's log keywords; without them every
    step appends and fsyncs, and a checkpoint lands every
    ``WAL_CKPT_EVERY`` steps). ``site`` makes the supervisor die at that
    site's ``nth`` call (``shots`` consecutive calls, for a site behind
    a retry; ``tamper``: a torn write at the ``nth`` append) and
    recovers it with ``recover_from_disk``: its scan, engine build,
    install and replay timed apart, the torn frames and quarantined
    files of its report, a flight dump counted. ``plant_drop`` drops
    one committed token from one recovered session, which
    ``check_recovery`` must reject. ``stop_at`` abandons the run after
    that many steps and returns its directory (kept); ``watch_dir``
    tracks the
    directory's size after every step. Launch counters are zeroed
    before the first step and must equal the forwards of every engine
    the run built, replays included; allocators balance; every request
    ends with its count, none lost or duplicated."""
    import numpy as np
    from paddle_tpu_torch.serving import wal as wal_mod
    builds, tallies, engines = [], [], []
    dead_fw = dict.fromkeys(("prefill", "decode", "verify", "tree",
                             "draft_catchup", "draft_decode"), 0)

    def factory():
        t = time.perf_counter()
        eng = wal_engine(E, params, cfg, kv_cache_dtype=kv, overlap=overlap)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t) * 1e3)
        engines.append(eng)
        if sync_check:
            tallies.append(instrument_engine(torch, eng, True))
        return eng

    wd = tempfile.mkdtemp(prefix="wal3j-") if wal else None
    skw = dict(token_budget=SCHED_BUDGET, sleep=lambda s: None,
               backoff_s=0.0, circuit_threshold=50)
    if wal:
        skw.update(sup_kw if sup_kw is not None
                   else {"wal_kw": {"group_interval_s": 0.0},
                         "checkpoint_every": WAL_CKPT_EVERY})
    P = serving.Priority
    sup = serving.EngineSupervisor(factory, wal_dir=wd, **skw)
    if site is not None:
        crashy(sup)
    fsync_ms, ckpts, post_ms = [], [], []

    def instrument(s):
        """Time the supervisor's post-step bookkeeping (``_on_success``:
        the journal, and with a log its appends, flush, fsyncs and
        checkpoints), the log's fsyncs and its checkpoints."""
        o0 = s._on_success

        def on_success():
            t = time.perf_counter()
            o0()
            post_ms.append((time.perf_counter() - t) * 1e3)
        s._on_success = on_success
        if s.wal is None:
            return
        w = s.wal
        f0, c0 = w._fsync, w.checkpoint

        def fsync():
            t = time.perf_counter()
            f0()
            fsync_ms.append((time.perf_counter() - t) * 1e3)

        def checkpoint(meta, arrays=None):
            t = time.perf_counter()
            path = c0(meta, arrays)
            ckpts.append(dict(ms=(time.perf_counter() - t) * 1e3,
                              bytes=os.path.getsize(path),
                              step=state["step"],
                              prefix=meta.get("prefix") is not None))
            return path
        w._fsync, w.checkpoint = fsync, checkpoint

    instrument(sup)
    inj = serving.FaultInjector()
    if site is not None:
        if tamper:
            inj.arm_tamper(site, nth=nth)
        else:
            for _ in range(shots):
                inj.arm(site, "raise", nth=nth)
    handles, recoveries = [], []
    # the run's step index (the supervisors count their own steps)
    state = {"sup": sup, "before": {}, "step": 0}
    scans = []
    real_scan = wal_mod.recover_state

    def timed_scan(path, repair=True):
        t = time.perf_counter()
        st = real_scan(path, repair=repair)
        scans.append(((time.perf_counter() - t) * 1e3, st["report"]))
        return st

    def recover():
        old = state["sup"]
        torch.cuda.synchronize()
        for k, v in old.engine.forwards.items():
            dead_fw[k] += v
        engines.remove(old.engine)
        committed = dict(state["before"])
        del old
        state["sup"] = None
        gc.collect()
        t0 = time.perf_counter()
        n_builds = len(builds)
        wal_mod.recover_state = timed_scan
        try:
            new = serving.EngineSupervisor.recover_from_disk(factory, wd,
                                                             **skw)
        finally:
            wal_mod.recover_state = real_scan
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        crashy(new)
        instrument(new)
        if plant_drop:
            # the planted fault: one recovered session resumes with one
            # of its committed tokens dropped
            for rid in sorted(new.restored):
                r = new.restored[rid]
                if len(r.tokens) >= 2:
                    r.tokens = r.tokens[:-2] + r.tokens[-1:]
                    new.journal._entries[rid].tokens = list(r.tokens)
                    break
        scan_ms, report = scans[-1]
        build_ms = sum(builds[n_builds:])
        live = list(new.restored.values())
        recoveries.append(dict(
            ms=total, scan_ms=scan_ms, build_ms=build_ms,
            install_ms=total - scan_ms - build_ms, report=report,
            sessions=len(live),
            replayed_tokens=int(sum(
                r.prompt.size + max(0, len(r.tokens) - 1) for r in live
                if r.finish_reason == "preempted")),
            journal={rid: list(r.tokens) for rid, r in new.restored.items()},
            before=committed, t_replay=time.perf_counter(),
            replay_rids={rid for rid, r in new.restored.items()
                         if r.finish_reason == "preempted"}))
        state["sup"] = new
        for i, h in enumerate(handles):
            handles[i] = new.restored.get(h.rid, h)

    def submit(batch, prio):
        for p, m in batch:
            while True:
                died = False
                try:
                    handles.append(state["sup"].submit(
                        p, max_new_tokens=m, priority=prio(len(handles))))
                    break
                except (serving.InjectedFault, ProcessDied):
                    died = True
                if died:
                    # the write-ahead append died before the ack: the
                    # client got no handle and submits again (recovered
                    # outside the handler, so that its traceback no
                    # longer holds the dead supervisor)
                    recover()

    obs.REGISTRY.clear()
    with inj:
        submit(reqs, lambda i: P.LOW if i % 2 else P.NORMAL)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        steps, step_ms, max_dir = 0, [], 0
        while True:
            if highs and steps == BURST_AT:
                submit(highs, lambda i: P.HIGH)
            state["before"] = {h.rid: list(h.tokens) for h in handles}
            state["step"] = steps
            ts = time.perf_counter()
            died = False
            try:
                more = state["sup"].step()
            except ProcessDied:
                died = True
            if died:
                recover()
                more = True
            step_ms.append((time.perf_counter() - ts) * 1e3)
            steps += 1
            if watch_dir:
                max_dir = max(max_dir, dir_bytes(wd))
            for rec in recoveries:
                if "replay_ms" not in rec and all(
                        state["sup"].restored[r].slot is not None
                        or state["sup"].restored[r].done
                        for r in rec["replay_rids"]) \
                        and not state["sup"].engine.pending_prefills():
                    rec["replay_ms"] = (time.perf_counter()
                                        - rec.pop("t_replay")) * 1e3
            if stop_at is not None and steps == stop_at:
                break
            if not more:
                break
            if steps > 5000:
                fail(f"wal {name}: no end after {steps} steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    sup = state["sup"]
    state.clear()
    if stop_at is not None:
        handles.clear()
        del sup
        gc.collect()
        return wd
    try:
        rec = wal_checks(kernels, cfg, name, kv, site, tamper, inj, sup,
                         handles, recoveries, reqs, highs, engines,
                         dead_fw, counts, wd)
    except SystemExit:
        del sup
        gc.collect()
        shutil.rmtree(wd, ignore_errors=True)
        raise
    rec.update(steps=steps, wall_s=wall, step_ms_mean=wall * 1e3 / steps,
               step_ms_median=float(np.median(step_ms)),
               post_step_ms_per_step=sum(post_ms) / steps,
               tokens_per_s=rec["generated_tokens"] / wall,
               engines_built=len(builds), build_ms=builds)
    if sup.wal is not None:
        st = sup.wal.stats()
        rec.update(wal=st, wal_host_ms_per_step=(
            st["append_ms_total"] + st["fsync_ms_total"]) / steps,
            wal_bytes_per_step=st["bytes_total"] / steps,
            wal_frames_per_step=st["appends_total"] / steps,
            fsync_ms_median=(float(np.median(fsync_ms)) if fsync_ms
                             else None),
            fsync_ms_max=max(fsync_ms) if fsync_ms else None,
            checkpoints=ckpts)
        for c in ckpts:
            # the step a checkpoint landed in against the median step
            c["step_ms"] = step_ms[c["step"]]
            c["stall_ms"] = step_ms[c["step"]] - rec["step_ms_median"]
    if watch_dir:
        segs = [f for f in os.listdir(wd) if f.startswith("wal-")]
        rec.update(max_dir_bytes=max_dir, final_dir_bytes=dir_bytes(wd),
                   final_segments=len(segs))
    if tallies:
        calls = {}
        for t in tallies:
            for k, v in t["calls"].items():
                calls[k] = calls.get(k, 0) + v
        rec["dispatch_calls_without_sync"] = calls
    if count_calls:
        rec["calls"] = dict(inj.calls)
        rec["tamper_calls"] = dict(inj.tamper_calls)
    rec["_sup"] = sup
    if wd is not None:
        rec["_dir"] = wd
    return rec


def wal_checks(kernels, cfg, name, kv, site, tamper, inj, sup, handles,
               recoveries, reqs, highs, engines, dead_fw, counts, wd):
    """``wal_run``'s gates on a finished run; returns the start of its
    record (tokens, forwards, launches, recoveries)."""
    final = {h.rid: list(h.tokens) for h in handles}
    if len(final) != len(handles) or len(handles) != len(reqs) + len(
            highs or ()):
        fail(f"wal {name}: {len(handles)} handles, {len(final)} rids for "
             f"{len(reqs) + len(highs or ())} requests — one was lost or "
             f"doubled")
    for h in handles:
        if not h.done or (len(h.tokens) != h.max_new_tokens
                          and h.finish_reason != "eos"):
            fail(f"wal {name}: request {h.rid} finished {h.finish_reason} "
                 f"with {len(h.tokens)}/{h.max_new_tokens} tokens")
    fw = dict(dead_fw)
    for eng in engines:
        for k, v in eng.forwards.items():
            fw[k] += v
    L = cfg.num_layers
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    want.update(B10=L * fw["decode"], B11=L * (fw["prefill"] + fw["verify"]))
    if counts != want:
        fail(f"wal {name}: launches {counts} != {want} (forwards {fw})")
    balanced(sup.engine, f"wal {name}")
    if site is not None:
        if not (inj.fired[site] >= 1 and len(recoveries) >= 1):
            fail(f"wal {name}: the death at {site} never happened "
                 f"({inj.stats()}, {len(recoveries)} recoveries)")
        for r in recoveries:
            check_recovery(f"wal {name}", r["before"], r["journal"], final)
        dumps = len([f for f in os.listdir(wd) if f.startswith("flight-")])
        if dumps < len(recoveries):
            fail(f"wal {name}: {len(recoveries)} deaths, {dumps} flight "
                 f"dumps")
        if tamper and not recoveries[0]["report"]["torn_tail_truncated"]:
            fail(f"wal {name}: the torn write was not counted "
                 f"({recoveries[0]['report']})")
    rec = dict(run=name, kv=kv or "bf16", site=site, tamper=tamper,
               requests=len(handles),
               generated_tokens=sum(len(t) for t in final.values()),
               forwards=fw, launches=counts)
    if recoveries:
        rec["recoveries"] = [{k: v for k, v in r.items()
                              if k not in ("journal", "before",
                                           "replay_rids")}
                             for r in recoveries]
    rec["tokens"] = [final[h.rid] for h in handles]
    return rec


def release(rec):
    """Drop a run's supervisor and remove its directory."""
    rec.pop("_sup", None)
    wd = rec.pop("_dir", None)
    if wd is not None:
        shutil.rmtree(wd, ignore_errors=True)
    gc.collect()


def damaged_recovery(torch, serving, E, params, cfg, wd, clean_tokens):
    """Gate (c): a copy of an abandoned run's directory with one bit
    flipped in a mid-log segment and a checkpoint that claims an lsn the
    log never reached. ``recover_from_disk`` must quarantine both,
    count them, and install nothing past the flip: each restored
    session's tokens a prefix of the undamaged recovery's, no session
    of the planted checkpoint."""
    import numpy as np
    from paddle_tpu_torch.serving import wal as wal_mod
    bad = wd + "-damaged"
    shutil.copytree(wd, bad)
    segs = sorted(f for f in os.listdir(bad) if f.startswith("wal-"))
    if len(segs) < 3:
        fail(f"wal (c): the abandoned log has {len(segs)} segments; a "
             f"mid-log flip needs three")
    seg = os.path.join(bad, segs[len(segs) // 2])
    data = bytearray(open(seg, "rb").read())
    data[len(data) // 2] ^= 0x10
    open(seg, "wb").write(bytes(data))
    last = wal_mod.scan_segments(wd, repair=False)[1]["last_lsn"]
    meta = {"sessions": [{"rid": 999999, "prompt": [5],
                          "max_new_tokens": 1, "tokens": [7],
                          "admitted": True}],
            "next_rid": 1000000, "wal_lsn": last + 1000, "checksums": {}}
    with open(os.path.join(bad, wal_mod._ckpt_name(last + 1000)),
              "wb") as f:
        np.savez(f, meta=np.frombuffer(json.dumps(meta).encode(),
                                       np.uint8))

    def factory():
        return wal_engine(E, params, cfg)

    # the scan's report as the recovery meets the damage (no repair)
    report = wal_mod.recover_state(bad, repair=False)["report"]
    t0 = time.perf_counter()
    sup = serving.EngineSupervisor.recover_from_disk(
        factory, bad, token_budget=SCHED_BUDGET, sleep=lambda s: None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    files = os.listdir(bad)
    got = {rid: list(r.tokens) for rid, r in sup.restored.items()}
    del sup
    gc.collect()
    shutil.rmtree(bad, ignore_errors=True)
    quarantined = sorted(f for f in files if f.endswith(".quarantined"))
    if 999999 in got:
        fail("wal (c): the planted checkpoint's session was installed")
    if not (report["corrupt_quarantined"] >= 1
            and report["ckpt_quarantined"] >= 1):
        fail(f"wal (c): the flip and the planted checkpoint were not both "
             f"counted ({report})")
    if not (any(f.startswith("wal-") for f in quarantined)
            and any(f.startswith("ckpt-") for f in quarantined)):
        fail(f"wal (c): the flipped segment's suffix and the planted "
             f"checkpoint were not both quarantined ({quarantined})")
    for rid, toks in got.items():
        if rid in clean_tokens and toks != clean_tokens[rid][:len(toks)]:
            fail(f"wal (c): request {rid} was restored with tokens that "
                 f"are not a prefix of the undamaged log's")
    return dict(recovery_ms=ms, quarantined_files=quarantined,
                restored=len(got), clean_restored=len(clean_tokens),
                report=report)


def prefix_checkpoint(torch, serving, obs, E, params, cfg, reqs):
    """Gate (e): ``checkpoint_prefix=True``. Eight requests (two on the
    shared system prompt) run to the end, a checkpoint of the trie's
    pages lands inside one step midway (its ms, bytes and the stall it
    adds to the step), a last one is written at the end, the supervisor
    is dropped and recovered: every prompt's chain in the restored trie
    matches the dead engine's, its pages byte-equal to the checkpointed
    ones, and a new request on the system prompt hits 192 or more
    prefix tokens."""
    import numpy as np
    from paddle_tpu_torch.serving import wal as wal_mod
    wd = tempfile.mkdtemp(prefix="wal3j-prefix-")

    def factory():
        return wal_engine(E, params, cfg)

    kw = dict(token_budget=SCHED_BUDGET, sleep=lambda s: None)
    sup = serving.EngineSupervisor(factory, wal_dir=wd,
                                   checkpoint_prefix=True, **kw)
    P = serving.Priority
    for i, (p, m) in enumerate(reqs):
        sup.submit(p, max_new_tokens=m,
                   priority=P.LOW if i % 2 else P.NORMAL)
    step_ms, mid, steps = [], None, 0
    while True:
        land = steps == 24
        if land:
            sup.checkpoint_every = sup.steps_total + 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = sup.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if land:
            sup.checkpoint_every = None
            mid = step_ms[-1]
        steps += 1
        if not more:
            break
    median = float(np.median(step_ms))
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = sup.checkpoint_now()
    end_ms = (time.perf_counter() - t) * 1e3
    end_bytes = os.path.getsize(path)
    cache = sup.engine.cache
    chains = {i: cache.prefix.match(p)[0] for i, (p, _) in enumerate(reqs)}
    del sup, cache
    gc.collect()
    torch.cuda.empty_cache()
    saved = wal_mod.recover_state(wd, repair=False)["prefix"]
    obs.REGISTRY.clear()
    obs.enable()
    t = time.perf_counter()
    sup = serving.EngineSupervisor.recover_from_disk(factory, wd, **kw)
    torch.cuda.synchronize()
    recover_ms = (time.perf_counter() - t) * 1e3
    cache = sup.engine.cache
    where = {p: i for i, p in enumerate(saved["page_ids"])}
    pages = 0
    for i, (p, _) in enumerate(reqs):
        got = cache.prefix.match(p)[0]
        if len(got) != len(chains[i]):
            fail(f"wal (e): request {i}'s chain has {len(got)} pages after "
                 f"the restart, {len(chains[i])} before")
        if not got:
            continue
        sel = torch.as_tensor(got, dtype=torch.long, device=cache.device)
        for name, arr in cache.pool.items():
            now = arr.index_select(1, sel)
            if now.dtype == torch.bfloat16:
                now = now.view(torch.int16).cpu().numpy().view(np.uint16)
            else:
                now = now.cpu().numpy()
            old = saved["arrays"][name][:, [where[q] for q in chains[i]]]
            if not np.array_equal(now, old):
                fail(f"wal (e): request {i}'s restored {name} pages differ "
                     f"from the checkpointed bytes")
        pages += len(got)
    hits0 = _metric(obs, "serving_prefix_hit_tokens_total")
    sys_p = np.concatenate([reqs[0][0][:200], reqs[1][0][:56]])
    h = sup.submit(sys_p, max_new_tokens=16, priority=P.HIGH)
    sup.run()
    hits = _metric(obs, "serving_prefix_hit_tokens_total") - hits0
    obs.disable()
    obs.REGISTRY.clear()
    if not (h.done and hits >= 192):
        fail(f"wal (e): the request on the restored system prompt hit "
             f"{hits} prefix tokens, not 192 or more")
    balanced(sup.engine, "wal (e)")
    del sup, cache
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(wd, ignore_errors=True)
    return dict(step_ms_median=median, checkpoint_step_ms=mid,
                stall_ms=mid - median, end_checkpoint_ms=end_ms,
                end_checkpoint_bytes=end_bytes,
                trie_pages=len(saved["page_ids"]), pages_compared=pages,
                recover_ms=recover_ms, prefix_hit_tokens=hits)


def run_wal(torch, kernels, cfg, seed: int, reqs):
    """Phase 3j: the write-ahead log under the supervisor, phase 3e's
    engine (fused, ``host_tier=True``) at ``cfg``'s width and depth on
    fresh weights from phase 3's seed, phase 3e's 16 requests and HIGH
    burst. Gates: (a) a simulated process death (the supervisor dropped
    without a drain) at each of ``WAL_DEATH_SITES`` at the middle of
    its calls in the uninterrupted run of the same KV (bf16: all seven;
    int8: ``decode_step`` and the torn ``wal_append``), then
    ``recover_from_disk``: no request lost or duplicated, every token
    on disk at the death kept (``check_recovery``), the torn tail
    counted, a flight dump a death, allocators balanced; (b) a recovery
    whose journal drops a committed token is rejected; (c) a flipped
    bit mid-log and a stale checkpoint are quarantined and counted,
    nothing past them installed (``damaged_recovery``); (d) a
    checkpoint every 16 steps over the run prunes segments and keeps
    the directory under ``WAL_DIR_BOUND``; (e) ``checkpoint_prefix``
    (``prefix_checkpoint``); (f) launches equal the forwards, replays
    included, in every run, and no overlapped dispatch syncs with the
    log on. Reported: ms a step with the journal off, ``"group"``,
    ``"commit"`` and ``"off"`` in turns (``WAL_TURN_ROUNDS`` of them),
    the supervisor's host ms after a step, the log's host ms, bytes and
    frames a step, fsync ms; each recovery's scan, build, install and
    replay ms against resident tokens and replayed records; checkpoint
    ms, bytes and stall with and without the prefix. Token agreement
    with the uninterrupted run is reported, not gated (bf16 near ties;
    it is gated on the CPU in f32)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.inference import ContinuousBatchingEngine as E
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.serving import wal as wal_mod
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    highs = burst_requests(4, cfg.vocab_size, seed + 7)
    runs, out = [], {}

    def go(name, base=None, **kw):
        rec = wal_run(torch, kernels, serving, obs, E, params, cfg,
                      kw.pop("reqs", reqs), kw.pop("highs", highs), name,
                      **kw)
        if base is not None:
            rec.update(token_agreement(rec["tokens"], base["tokens"]))
        print("wal " + show({k: v for k, v in rec.items()
                             if not k.startswith("_") and k not in (
                                 "calls", "tamper_calls")}))
        runs.append(rec)
        return rec

    # (a) deaths at each site, against the same KV's uninterrupted run
    for kv, sites in ((None, WAL_DEATH_SITES),
                      ("int8", ("decode_step", "wal_append"))):
        base = go(f"uninterrupted-{kv or 'bf16'}", kv=kv, count_calls=True)
        for site in sites:
            tamper = site == "wal_append"
            n = (base["tamper_calls"] if tamper else base["calls"]).get(
                site, 0)
            if n < 1:
                fail(f"wal: site {site} was not called in {base['run']}")
            shots = 3 if site == "swap_in" else 1
            rec = go(f"death-{site}-{kv or 'bf16'}", base, kv=kv, site=site,
                     nth=max(1, n // 2), shots=shots, tamper=tamper)
            release(rec)
        base.pop("calls")
        base.pop("tamper_calls")
        release(base)
    # (b) the planted fault: the check must reject a recovery whose
    # journal lost a committed token
    try:
        wal_run(torch, kernels, serving, obs, E, params, cfg, reqs[:8],
                None, "planted-drop", site="decode_step", nth=40,
                plant_drop=True)
    except SystemExit as e:
        if "journal restored" not in str(e):
            raise
        print(f"wal planted-drop: rejected, as it must be ({e})")
    else:
        fail("wal: a recovery whose journal dropped a committed token "
             "passed the check")
    gc.collect()
    # (c) a run abandoned after 40 steps on small segments: its clean
    # recovery against one from a damaged copy
    wd = wal_run(torch, kernels, serving, obs, E, params, cfg, reqs[:8],
                 None, "abandoned", stop_at=40,
                 sup_kw={"wal_kw": {"group_interval_s": 0.0,
                                    "segment_bytes": WAL_SEGMENT_SMALL}})
    clean = {rid: list(s.get("tokens") or ()) for rid, s in
             wal_mod.recover_state(wd, repair=False)["sessions"].items()}
    out["damaged"] = damaged_recovery(torch, serving, E, params, cfg, wd,
                                      clean)
    print("wal damaged " + json.dumps(out["damaged"]))
    shutil.rmtree(wd, ignore_errors=True)
    # (d) a checkpoint every 16 steps keeps the directory bounded
    pr = go("checkpoint-every-16", watch_dir=True,
            sup_kw={"checkpoint_every": WAL_CKPT_EVERY,
                    "wal_kw": {"segment_bytes": WAL_SEGMENT_BYTES}})
    st = pr["wal"]
    if not (st["segments_pruned_total"] >= 1
            and pr["max_dir_bytes"] <= WAL_DIR_BOUND):
        fail(f"wal (d): pruned {st['segments_pruned_total']} segments, the "
             f"directory peaked at {pr['max_dir_bytes']} bytes (bound "
             f"{WAL_DIR_BOUND})")
    release(pr)
    # (e) the trie's pages in a checkpoint, across a cold restart
    out["prefix"] = prefix_checkpoint(torch, serving, obs, E, params, cfg,
                                      reqs[:8])
    print("wal prefix " + json.dumps(out["prefix"]))
    # (f) the log on an overlapped run: no dispatch syncs
    ov = go("overlap-nosync", reqs=reqs[:8], highs=None, overlap=True,
            sync_check=True, sup_kw={"wal_fsync": "group"})
    calls = ov["dispatch_calls_without_sync"]
    if not (calls["decode_dispatch"] and calls["prefill_dispatch"]):
        fail(f"wal (f): a dispatch kind did not run under the sync check "
             f"({calls})")
    release(ov)
    # the journal's cost: off, group, commit, fsync off, in turns
    turns = {m: [] for m in WAL_TURNS}
    for _ in range(WAL_TURN_ROUNDS):
        for mode in WAL_TURNS:
            kw = WAL_TURN_KW[mode]
            rec = go(f"turn-{mode}", wal=kw is not None, sup_kw=kw)
            turns[mode].append({k: rec.get(k) for k in (
                "step_ms_mean", "step_ms_median", "post_step_ms_per_step",
                "wal_host_ms_per_step",
                "wal_bytes_per_step", "wal_frames_per_step",
                "fsync_ms_median", "fsync_ms_max")})
            release(rec)
    out["turns"] = {m: dict(runs=t, step_ms=[r["step_ms_mean"] for r in t],
                            spread_ms=(max(r["step_ms_mean"] for r in t)
                                       - min(r["step_ms_mean"] for r in t)),
                            post_step_ms=[r["post_step_ms_per_step"]
                                          for r in t])
                    for m, t in turns.items()}
    print("wal turns " + json.dumps({m: (t["step_ms"], t["spread_ms"],
                                         t["post_step_ms"])
                                     for m, t in out["turns"].items()}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for r in runs:
        for k in ("calls", "tamper_calls", "tokens"):
            r.pop(k, None)
    out["runs"] = runs
    return out


# --------------------------------------------------------------- phase 3k
CLUSTER_SYSTEM = 192    # each tenant's system prompt: 12 full pages of 16
CLUSTER_TENANTS = 4
CLUSTER_PROFILE_AT = 40         # the cluster step a profiled window starts
CLUSTER_PROFILE_STEPS = 8
#: gate (d)'s trace: 40-60 requests over 6 virtual seconds, one burst
CLUSTER_TRACE = dict(vocab=32000, page_size=16, prefix_pages=12,
                     tenants=CLUSTER_TENANTS, tail_tokens=(32, 256),
                     new_tokens=(16, 64), duration_s=6.0, base_rps=6.0)
CLUSTER_STEP_DT = 0.05          # virtual seconds a cluster step
#: tenant0's rate limit in gate (d): tokens (prompt + new) a 2 s window
CLUSTER_QUOTA = (2500, 2.0)
#: the admission controller's service-rate estimate (tokens a virtual s)
CLUSTER_ADMIT_TPS = 40000.0


def tenant_requests(reqs, vocab: int, seed: int):
    """Phase 3e's requests spread over ``CLUSTER_TENANTS`` tenants:
    request i belongs to tenant i % 4 and its prompt is that tenant's
    ``CLUSTER_SYSTEM``-token system prompt followed by the request's own
    prompt past its first 192 tokens (its first 32 when it is shorter).
    Returns (tenant, prompt, new) triples and the system prompts."""
    import numpy as np
    rs = np.random.RandomState(seed + 19)
    systems = [rs.randint(3, vocab, (CLUSTER_SYSTEM,)).astype(np.int32)
               for _ in range(CLUSTER_TENANTS)]
    out = []
    for i, (p, m) in enumerate(reqs):
        t = i % CLUSTER_TENANTS
        tail = p[CLUSTER_SYSTEM:] if p.size >= CLUSTER_SYSTEM + 32 else p[:32]
        out.append((f"tenant{t}", np.concatenate([systems[t], tail]), m))
    return out, systems


def check_cluster_handles(name, rids, handles, declined=()):
    """Phase 3k's finish gate: the final handles hold each submitted rid
    exactly once (none lost, none doubled), and every one is done with
    its full count of tokens (or an eos); a request that finished with
    one of the ``declined`` reasons owes none and holds none."""
    got = sorted(h.rid for h in handles)
    if got != sorted(rids):
        fail(f"cluster {name}: the handles hold rids {got} for the "
             f"{len(rids)} submitted {sorted(rids)} — one was lost or "
             f"doubled")
    for h in handles:
        if h.finish_reason in declined:
            if h.tokens or not h.done:
                fail(f"cluster {name}: request {h.rid} was declined "
                     f"({h.finish_reason}) but holds {len(h.tokens)} "
                     f"tokens")
        elif not h.done or (len(h.tokens) != h.max_new_tokens
                            and h.finish_reason != "eos"):
            fail(f"cluster {name}: request {h.rid} finished "
                 f"{h.finish_reason} with {len(h.tokens)}/"
                 f"{h.max_new_tokens} tokens")


def check_pages_bytes(name, got, want, what="the exported payload"):
    """Byte equality of two raw page payloads (name -> ``uint8`` array,
    the ``export_request`` form)."""
    import numpy as np
    if set(got) != set(want) or not all(
            np.array_equal(np.asarray(got[n]).reshape(-1).view(np.uint8),
                           np.asarray(want[n]).reshape(-1).view(np.uint8))
            for n in got):
        fail(f"cluster {name}: the first handoff's decode-side pages are "
             f"not byte-equal to {what}")


def watch_first_handoff(cluster):
    """Wrap ``cluster._handoff_one`` so that the first handoff that lands
    records the decode side's pages (``export_request`` of the new
    slot), and, to hold them against, the exported payload (host-staged)
    or the prefill side's pages read just before the handoff (direct).
    The reads sync with the card; later handoffs pass through."""
    seen = {}
    inner = cluster._handoff_one

    def handoff(sup, req, loads):
        if "decode" in seen:
            return inner(sup, req, loads)
        eng = sup.engine
        source = eng.cache.export_request(req.slot)["arrays"]
        export, box = eng.export_prefilled, {}

        def exporting(r, with_kv=True):
            box["payload"] = export(r, with_kv=with_kv)
            return box["payload"]
        eng.export_prefilled = exporting
        n = cluster.handoffs_total
        try:
            return inner(sup, req, loads)
        finally:
            del eng.export_prefilled
            if cluster.handoffs_total > n:
                own = cluster.replicas[cluster._owner[req.rid]]
                kv = box["payload"].get("kv")
                seen.update(
                    rid=req.rid, direct=kv is None,
                    decode=own.engine.cache.export_request(req.slot)[
                        "arrays"],
                    payload=source if kv is None else kv["arrays"])
    cluster._handoff_one = handoff
    return seen


def cluster_factory(torch, E, params, cfg, kv=None, overlap=False,
                    sync_check=False):
    """Phase 3k's replica engines (``wal_engine``: phase 3e's geometry,
    fused, the host tier on), all on one params dict. The box keeps every
    engine the factory built (the launch check counts dead and replaced
    replicas' forwards too), each build's ms, the ``instrument_engine``
    tallies with ``sync_check``, and the prefix tokens each rid's
    prefill admission shared from the trie (``hits``)."""
    box = dict(engines=[], builds=[], tallies=[], hits={})

    def factory():
        t = time.perf_counter()
        eng = wal_engine(E, params, cfg, kv_cache_dtype=kv, overlap=overlap)
        torch.cuda.synchronize()
        box["builds"].append((time.perf_counter() - t) * 1e3)
        box["engines"].append(eng)
        admit = eng.admit_request

        def admit_request(req):
            ok = admit(req)
            if ok and req.slot in eng._pending:
                box["hits"][req.rid] = int(eng._pending[req.slot][2])
            return ok
        eng.admit_request = admit_request
        if sync_check:
            box["tallies"].append(instrument_engine(torch, eng, True))
        return eng
    box["factory"] = factory
    return box


def cluster_launches(kernels, cfg, name, engines, counts):
    """Gate (f): the run's launches equal the forwards of every engine
    it built — B10 a decode, B11 a prefill chunk, per layer."""
    fw = dict.fromkeys(("prefill", "decode", "verify", "tree",
                        "draft_catchup", "draft_decode"), 0)
    for eng in engines:
        for k, v in eng.forwards.items():
            fw[k] += v
    L = cfg.num_layers
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    want.update(B10=L * fw["decode"], B11=L * (fw["prefill"] + fw["verify"]))
    if counts != want:
        fail(f"cluster {name}: launches {counts} != {want} (forwards {fw})")
    return fw


def time_cluster(cluster):
    """Host seconds of the cluster's own work, wrapped per method: the
    router (dispatch, gauges, pruning, the work check), the handoff
    harvest and the autoscaler's tick; the replicas' steps are the
    rest of a cluster step."""
    t = {"router_s": 0.0, "handoff_s": 0.0, "autoscale_s": 0.0}
    for name, key in (("_dispatch", "router_s"), ("_publish", "router_s"),
                      ("_prune_finished", "router_s"),
                      ("_has_work", "router_s"),
                      ("_harvest_handoffs", "handoff_s"),
                      ("_autoscale_tick", "autoscale_s")):
        def wrapped(*a, _fn=getattr(cluster, name), _k=key, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                t[_k] += time.perf_counter() - t0
        setattr(cluster, name, wrapped)
    return t


def serviceable(cluster):
    return [s for s in cluster.replicas
            if s.health != "dead" and not s._draining]


def cluster_drive(torch, cluster, name, on_step=None, prof_at=None,
                  max_steps=5000):
    """Step ``cluster`` until it has no work: ``on_step(i)`` runs before
    step i; every step's host ms is kept (those of a profiled window
    apart); after each step no rid may run on two replicas at once, and
    each rid's replica history (the distinct owners in order) grows.
    ``prof_at``: a ``torch.profiler`` window of ``CLUSTER_PROFILE_STEPS``
    steps from that step, split by ``device_breakdown``."""
    from torch.profiler import ProfilerActivity, profile
    hist, step_ms, out = {}, [], {}
    prof, steps = None, 0
    while True:
        if on_step is not None:
            on_step(steps)
        if prof_at is not None and steps == prof_at:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            tp = time.perf_counter()
        t = time.perf_counter()
        more = cluster.step()
        if prof is None:
            step_ms.append((time.perf_counter() - t) * 1e3)
        steps += 1
        if prof is not None and (steps == prof_at + CLUSTER_PROFILE_STEPS
                                 or not more):
            torch.cuda.synchronize()
            wall = (time.perf_counter() - tp) * 1e3 / (steps - prof_at)
            prof.__exit__(None, None, None)
            out["profile"] = device_breakdown(torch, prof, steps - prof_at,
                                              wall)
            prof = None
        running = [r.rid for s in serviceable(cluster)
                   for r in s.engine.running_requests()]
        if len(running) != len(set(running)):
            fail(f"cluster {name}: a rid runs on two replicas at once "
                 f"({sorted(running)})")
        for rid, idx in cluster._owner.items():
            h = hist.setdefault(rid, [])
            if not h or h[-1] != idx:
                h.append(idx)
        if not more:
            break
        if steps > max_steps:
            fail(f"cluster {name}: no end after {steps} steps")
    torch.cuda.synchronize()
    out.update(steps=steps, step_ms=step_ms, hist=hist)
    return out


def staged_submit(cluster, treqs, handles, tenant_of):
    """An ``on_step`` that submits each tenant's first request at once
    and the rest once every first one holds a token (its prompt's pages
    are then in its replica's trie, so the rest can hit them).
    ``tenant_of`` maps each submitted rid to its tenant."""
    firsts = {}
    for i, (t, p, m) in enumerate(treqs):
        firsts.setdefault(t, i)
    state = {"rest": False}

    def submit(i):
        t, p, m = treqs[i]
        h = cluster.submit(p, max_new_tokens=m, tenant=t)
        handles.append(h)
        tenant_of[h.rid] = t

    for i in sorted(firsts.values()):
        submit(i)

    def on_step(_):
        if state["rest"] or not all(h.tokens for h in handles):
            return
        state["rest"] = True
        for i in range(len(treqs)):
            if i not in firsts.values():
                submit(i)
    return on_step


def cluster_record(name, kv, cluster, box, drive, timers, handles, counts,
                   kernels, cfg, wall):
    """The shared gates and numbers of a phase 3k run: finish, launches
    (gate f), balanced allocators on every serviceable replica."""
    fw = cluster_launches(kernels, cfg, name, box["engines"], counts)
    for s in serviceable(cluster):
        balanced(s.engine, f"cluster {name} (replica {s.replica_id})")
    steps = drive["steps"]
    gen = sum(len(h.tokens) for h in handles)
    ms = drive["step_ms"]
    rec = dict(run=name, kv=kv or "bf16", replicas=len(cluster.replicas),
               requests=len(handles), generated_tokens=gen, steps=steps,
               wall_s=wall, tokens_per_s=gen / wall,
               step_ms_mean=sum(ms) / max(1, len(ms)),
               step_ms_median=sorted(ms)[len(ms) // 2] if ms else None,
               router_ms_per_step=timers["router_s"] * 1e3 / steps,
               handoff_host_ms_per_step=timers["handoff_s"] * 1e3 / steps,
               autoscale_ms_per_step=timers["autoscale_s"] * 1e3 / steps,
               engines_built=len(box["builds"]),
               build_ms_max=max(box["builds"]), forwards=fw,
               launches=counts, handoffs=cluster.handoffs_total,
               router=cluster.router.stats())
    rec["router"].pop("tenant_accounts")
    if "profile" in drive:
        rec["profile"] = drive["profile"]
    rec["tokens"] = [list(map(int, h.tokens)) for h in handles]
    return rec


def cluster_routed(torch, kernels, serving, obs, E, params, cfg, treqs, kv,
                   replicas):
    """Gate (a): ``treqs`` through a ``replicas``-replica cluster (1 is
    the one-engine baseline), each tenant's first request first. Gates:
    finish, launches, balance; with 2, every tenant's later requests on
    its bound replica, each sharing at least ``CLUSTER_SYSTEM`` prefix
    tokens there."""
    box = cluster_factory(torch, E, params, cfg, kv)
    name = f"routed-{replicas}-{kv or 'bf16'}"
    cl = serving.ServingCluster(
        box["factory"], replicas=replicas, token_budget=SCHED_BUDGET,
        supervisor_kw=dict(sleep=lambda s: None, backoff_s=0.0))
    timers = time_cluster(cl)
    handles, tenant_of = [], {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    drive = cluster_drive(torch, cl, name,
                          staged_submit(cl, treqs, handles, tenant_of),
                          prof_at=CLUSTER_PROFILE_AT if kv is None else None)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check_cluster_handles(name, [h.rid for h in handles], handles)
    rec = cluster_record(name, kv, cl, box, drive, timers, handles, counts,
                         kernels, cfg, wall)
    if replicas > 1:
        if len(cl.router.dispatch_by_replica) < 2:
            fail(f"cluster {name}: every request went to one replica "
                 f"({cl.router.dispatch_by_replica})")
        later = {}
        for h in sorted(handles, key=lambda h: h.rid):
            later.setdefault(tenant_of[h.rid], []).append(h)
        for t, hs in later.items():
            bound = cl.router._affinity.get(
                cl.router.affinity_key(hs[0].prompt[0]))
            for h in hs[1:]:
                if (drive["hist"].get(h.rid) != [bound]
                        or box["hits"].get(h.rid, 0) < CLUSTER_SYSTEM):
                    fail(f"cluster {name}: {t}'s request {h.rid} ran on "
                         f"{drive['hist'].get(h.rid)} (bound {bound}) and "
                         f"hit {box['hits'].get(h.rid, 0)} prefix tokens, "
                         f"not {CLUSTER_SYSTEM} or more there")
        rec["prefix_hit_tokens_later"] = sorted(
            box["hits"].get(h.rid, 0) for hs in later.values()
            for h in hs[1:])
    rec["_order"] = [h.rid for h in handles]
    del cl, box
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def cluster_disaggregated(torch, kernels, serving, obs, E, params, cfg,
                          treqs, direct):
    """Gate (b): ``treqs`` through 3 replicas, the first a prefill
    replica, host-staged or ``direct_handoff``, with the hooks on. The
    first handoff's decode-side pages byte-equal the exported payload
    (staged) or the prefill side's pages (direct); the import counter
    equals ``handoffs_total`` and the export counter the exports (each
    handoff counted once); staged, a tampered second export is caught
    by the CRC (``handoff_corruptions_total == 1``) with the request
    still running on its prefill replica, and an armed fault at the
    third import is retried. Every handoff is timed between card
    synchronizations, with its pages and bytes."""
    box = cluster_factory(torch, E, params, cfg)
    name = f"disaggregated-{'direct' if direct else 'staged'}"
    cl = serving.ServingCluster(
        box["factory"], replicas=3, prefill_replicas=1,
        token_budget=SCHED_BUDGET, direct_handoff=direct,
        retry_sleep=lambda s: None,
        supervisor_kw=dict(sleep=lambda s: None, backoff_s=0.0))
    timers = time_cluster(cl)
    seen = watch_first_handoff(cl)
    inner = cl._handoff_one
    handoffs, tally = [], {"exports": 0, "corrupt_rid": None}

    def handoff(sup, req, loads):
        eng = sup.engine
        pages = eng.cache.pages_for(int(eng.cache.lengths[req.slot]))
        n, c = cl.handoffs_total, cl.handoff_corruptions_total
        first = "decode" not in seen
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner(sup, req, loads)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        tally["exports"] += 1
        if cl.handoff_corruptions_total > c:
            tally["corrupt_rid"] = req.rid
            if not (cl._owner.get(req.rid) == 0 and not req.done
                    and eng._slots[req.slot] is req):
                fail(f"cluster {name}: after the corrupt handoff request "
                     f"{req.rid} is not running on its prefill replica")
        elif cl.handoffs_total > n and not first:
            handoffs.append(dict(ms=ms, pages=pages,
                                 bytes=eng.cache.page_payload_bytes(pages)))
    cl._handoff_one = handoff
    inj = serving.FaultInjector()
    if not direct:
        inj.arm_tamper("handoff_export", nth=2)
        inj.arm("handoff_import", "raise", nth=3)
    obs.REGISTRY.clear()
    obs.enable()
    handles, tenant_of = [], {}
    try:
        with inj:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            drive = cluster_drive(torch, cl, name,
                                  staged_submit(cl, treqs, handles,
                                                tenant_of))
            wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        exports = _metric(obs, "serving_handoff_exports_total")
        imports = _metric(obs, "serving_handoff_imports_total")
    finally:
        obs.disable()
        obs.REGISTRY.clear()
    check_cluster_handles(name, [h.rid for h in handles], handles)
    rec = cluster_record(name, None, cl, box, drive, timers, handles, counts,
                         kernels, cfg, wall)
    if "decode" not in seen or seen["direct"] != direct:
        fail(f"cluster {name}: no handoff landed")
    check_pages_bytes(name, seen["decode"], seen["payload"],
                      "the prefill replica's pages" if direct
                      else "the exported payload")
    if not (imports == cl.handoffs_total >= 8
            and exports == tally["exports"]):
        fail(f"cluster {name}: the hooks counted {exports} exports and "
             f"{imports} imports for {tally['exports']} exports and "
             f"{cl.handoffs_total} handoffs")
    if not direct and not (cl.handoff_corruptions_total == 1
                           and tally["corrupt_rid"] is not None
                           and cl.handoff_retries_total >= 1):
        fail(f"cluster {name}: tamper and import fault: corruptions "
             f"{cl.handoff_corruptions_total}, retries "
             f"{cl.handoff_retries_total} ({inj.stats()})")
    rec.update(direct=direct, handoff_corruptions=cl.handoff_corruptions_total,
               handoff_retries=cl.handoff_retries_total,
               exports_counted=exports, imports_counted=imports,
               first_handoff_pages_bytes=int(sum(
                   a.size for a in seen["payload"].values())),
               handoff_ms=[h["ms"] for h in handoffs],
               handoff_pages=[h["pages"] for h in handoffs],
               handoff_bytes=[h["bytes"] for h in handoffs],
               _order=[h.rid for h in handles])
    del cl, box
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def kill_next_step(inj, sup):
    """Arm ``sup.circuit_threshold`` shots at ``sched_tick`` just before
    ``sup``'s next step: its first try and each retry after a recovery
    fail, and its circuit opens inside that step."""
    step = sup.step

    def failing_step():
        sup.step = step
        for _ in range(sup.circuit_threshold):
            inj.arm("sched_tick", "raise", nth=1)
        return step()
    sup.step = failing_step


def cluster_failover(torch, kernels, serving, obs, E, params, cfg, treqs,
                     systems):
    """Gate (c): ``treqs`` through 3 replicas (``circuit_threshold=2``,
    the host tier shared). Once every request holds a token, the replica
    with the most sessions swaps one decode-phase session out (a
    preemption), then its next step fails until its circuit opens: the
    cluster fails over (``failovers_total >= 1``), the swapped session
    swaps in on a survivor with no replay, the rest replay. Ten steps
    later the bound replica of the tenant with the most running
    sessions is retired mid-decode (drain, requeue, trie restored into
    its replacement); when the cluster is idle, a new request of that
    tenant must share ``CLUSTER_SYSTEM`` or more prefix tokens on the
    replacement. Failover ms, the rehomed sessions' replayed tokens and
    retire ms are reported."""
    import numpy as np
    box = cluster_factory(torch, E, params, cfg)
    name = "failover-retire"
    cl = serving.ServingCluster(
        box["factory"], replicas=3, token_budget=SCHED_BUDGET,
        supervisor_kw=dict(sleep=lambda s: None, backoff_s=0.0,
                           circuit_threshold=2, recover_after=4))
    timers = time_cluster(cl)
    inj = serving.FaultInjector()
    out, state = {}, {"phase": 0}
    handles, tenant_of = [], {}
    submit = staged_submit(cl, treqs, handles, tenant_of)
    failover = cl._failover

    def timed_failover(idx):
        dead = cl.replicas[idx]
        entries = dead.journal.live_entries()
        swap0 = sum(e.cache.swap_ins_total for e in box["engines"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        failover(idx)
        torch.cuda.synchronize()
        out.update(
            failover_ms=(time.perf_counter() - t) * 1e3, victim=idx,
            rehomed=len(entries), swap_ins_before=swap0,
            replayed_tokens=int(sum(
                e.req.prompt.size + max(0, len(e.tokens) - 1)
                for e in entries if e.admitted and e.req is not None
                and not getattr(e.req, "swapped", False))))
        state["phase"] = 2
        state["at"] = state["step"]
    cl._failover = timed_failover

    def on_step(i):
        state["step"] = i
        submit(i)
        if state["phase"] == 0 and len(handles) == len(treqs) and all(
                h.tokens for h in handles if not h.done):
            loads = {j: len(s.engine.running_requests())
                     for j, s in enumerate(cl.replicas)}
            v = max(loads, key=lambda j: (loads[j], -j))
            sup = cl.replicas[v]
            live = [r for r in sup.engine.running_requests()
                    if r.tokens and not r.done
                    and sup.engine.swap_candidate(r)]
            if not live:
                return
            r = live[0]
            sup.engine.preempt_request(r)
            sup.scheduler.requeue(r, front=True)
            if not r.swapped:
                fail(f"cluster {name}: the preempted session {r.rid} did "
                     f"not swap out")
            out["swapped_rid"] = r.rid
            kill_next_step(inj, sup)
            state["phase"] = 1
        elif state["phase"] == 2 and i >= state["at"] + 10:
            # the tenant with the most running sessions on its bound
            # replica (a failover drops the dead replica's bindings)
            best = None
            for t in sorted(set(tenant_of.values())):
                idx = cl.router._affinity.get(cl.router.affinity_key(
                    systems[int(t[6:])]))
                if idx is None:
                    continue
                n = sum(1 for r in cl.replicas[idx].engine.running_requests()
                        if tenant_of.get(r.rid) == t)
                if n and (best is None or n > best[0]):
                    best = (n, t, idx)
            if best is None:
                return
            n, t, idx = best
            live = len(cl.replicas[idx].engine.running_requests())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = cl.retire_replica(idx)
            torch.cuda.synchronize()
            out.update(retire_ms=(time.perf_counter() - t0) * 1e3,
                       retired=idx, retired_tenant=t,
                       retire_sessions=live, drain=summary)
            state["phase"] = 3

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with inj:
        drive = cluster_drive(torch, cl, name, on_step)
    wall = time.perf_counter() - t0
    if state["phase"] != 3 or cl.failovers_total < 1:
        fail(f"cluster {name}: the failover and the retirement did not "
             f"both happen (phase {state['phase']}, failovers "
             f"{cl.failovers_total})")
    swap_ins = sum(e.cache.swap_ins_total for e in box["engines"])
    fallbacks = sum(e.cache.swap_replay_fallbacks for e in box["engines"])
    if not (swap_ins > out["swap_ins_before"] and fallbacks == 0):
        fail(f"cluster {name}: the swapped session did not swap in on a "
             f"survivor (swap-ins {out['swap_ins_before']} -> {swap_ins}, "
             f"replay fallbacks {fallbacks})")
    # the retired tenant's next prompt, on the replacement's restored trie
    t = out["retired_tenant"]
    rs = np.random.RandomState(91)
    p = np.concatenate([systems[int(t[6:])],
                        rs.randint(3, cfg.vocab_size, (64,)).astype(np.int32)])
    h = cl.submit(p, max_new_tokens=16, tenant=t)
    handles.append(h)
    tail = cluster_drive(torch, cl, name + " (after)")
    counts = kernels.launch_counts()
    if (tail["hist"].get(h.rid) != [out["retired"]]
            or box["hits"].get(h.rid, 0) < CLUSTER_SYSTEM):
        fail(f"cluster {name}: the retired replica's tenant's next prompt "
             f"ran on {tail['hist'].get(h.rid)} (retired "
             f"{out['retired']}) with {box['hits'].get(h.rid, 0)} prefix "
             f"tokens hit, not {CLUSTER_SYSTEM} or more")
    check_cluster_handles(name, [x.rid for x in handles], handles)
    rec = cluster_record(name, None, cl, box, drive, timers, handles, counts,
                         kernels, cfg, wall)
    rec.update(failovers=cl.failovers_total,
               retirements=cl.retirements_total, swap_ins=swap_ins,
               next_prompt_hit_tokens=box["hits"][h.rid], **out)
    rec["drain"] = {k: v for k, v in out["drain"].items() if k != "path"}
    del cl, box
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def fatal_failures(cluster, name):
    """Make any failed step of any replica, those the cluster builds
    later included, end the run: a run with no fault armed must not
    pass through a recovery (a sync inside a checked dispatch raises)."""
    def fatal(err):
        fail(f"cluster {name}: a replica's step failed: "
             f"{type(err).__name__}: {err}")
    for s in cluster.replicas:
        s._on_failure = fatal
    new = cluster._new_supervisor

    def new_supervisor(idx):
        s = new(idx)
        s._on_failure = fatal
        return s
    cluster._new_supervisor = new_supervisor


def cluster_traffic(torch, kernels, serving, obs, E, params, cfg, seed):
    """Gate (d): ``synth_trace`` (``CLUSTER_TRACE``: four tenants on
    12-page system prompts, one burst) through ``run_trace`` under a
    ``FakeClock`` (``CLUSTER_STEP_DT`` a step), on a cluster of one
    prefill replica and an autoscaled decode tier (1 to 3, the
    thresholds of the reference's traffic tests), an
    ``AdmissionController``, a ``TenantQuota`` on tenant0 and
    ``overlap=True``, every dispatch under the sync debug mode. Gates:
    nothing lost or doubled, at least one scale-up and one scale-down,
    at least one ``rejected_ratelimit``, no replica step failed."""
    box = cluster_factory(torch, E, params, cfg, overlap=True,
                          sync_check=True)
    name = "traffic"
    trace = serving.synth_trace(seed, **dict(CLUSTER_TRACE,
                                             vocab=cfg.vocab_size))
    clock = serving.FakeClock()
    auto = serving.ClusterAutoscaler(
        min_replicas=1, max_replicas=3, up_backlog_per_replica=3.0,
        down_backlog_per_replica=0.5, up_after=1, down_after=4,
        cooldown_ticks=3)
    cl = serving.ServingCluster(
        box["factory"], replicas=2, prefill_replicas=1, clock=clock,
        token_budget=SCHED_BUDGET, autoscaler=auto,
        admission=serving.AdmissionController(tokens_per_s=CLUSTER_ADMIT_TPS),
        quotas={"tenant0": serving.TenantQuota(*CLUSTER_QUOTA)},
        overlap=True, retry_sleep=lambda s: None,
        supervisor_kw=dict(sleep=lambda s: None, backoff_s=0.0))
    fatal_failures(cl, name)
    timers = time_cluster(cl)
    step, step_ms = cl.step, []

    def checked_step():
        t = time.perf_counter()
        more = step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        running = [r.rid for s in serviceable(cl)
                   for r in s.engine.running_requests()]
        if len(running) != len(set(running)):
            fail(f"cluster {name}: a rid runs on two replicas at once")
        return more
    cl.step = checked_step
    handles = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = serving.run_trace(cl, trace, clock, step_dt=CLUSTER_STEP_DT,
                               on_submit=lambda tr, req: handles.append(req))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    declined = serving.traffic.REJECTED_REASONS + ("deadline_exceeded",)
    if len(handles) != len(trace):
        fail(f"cluster {name}: {len(handles)} handles for {len(trace)} "
             f"arrivals")
    check_cluster_handles(name, sorted({h.rid for h in handles}), handles,
                          declined)
    rep = report.as_dict()
    calls = {}
    for t in box["tallies"]:
        for k, v in t["calls"].items():
            calls[k] = calls.get(k, 0) + v
    if not (report.lost == 0 and report.autoscale_up >= 1
            and report.autoscale_down >= 1
            and report.rejected.get("rejected_ratelimit", 0) >= 1
            and calls.get("decode_dispatch")
            and calls.get("prefill_dispatch")):
        fail(f"cluster {name}: lost {report.lost}, scaled up "
             f"{report.autoscale_up} / down {report.autoscale_down}, "
             f"rejected {report.rejected}, dispatches under the sync check "
             f"{calls}")
    drive = dict(steps=report.steps, step_ms=step_ms, hist={})
    rec = cluster_record(name, None, cl, box, drive, timers, handles, counts,
                         kernels, cfg, wall)
    rec.update(trace_requests=len(trace), slo_report=rep,
               dispatch_calls_without_sync=calls,
               handoff_corruptions=cl.handoff_corruptions_total,
               autoscaler=auto.stats())
    del cl, box
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def cluster_restart(torch, kernels, serving, obs, E, params, cfg, treqs):
    """Gate (e): ``treqs`` through 2 replicas with ``wal_dir`` on local
    disk (a checkpoint every 16 steps). Once every request holds a
    token, replica 1's next step fails until its circuit opens: after the
    failover its directory may hold only sessions replica 1 owns now
    (the dead incarnation's were tombstoned as they rehomed). Five
    steps later every replica dies at its next failed step instead of
    recovering (``crashy``) and a ``decode_step`` fault kills the
    process; the cluster object is dropped and ``ServingCluster.
    recover_from_disk`` rebuilds it from the directory. Gates: every
    request finishes once, and the tokens on disk at the death are a
    prefix of the final tokens (``check_recovery``). Reported: the
    restart's ms by part (scan, engine builds, install) against the
    resident tokens, and the run after it."""
    from paddle_tpu_torch.serving import wal as wal_mod
    box = cluster_factory(torch, E, params, cfg)
    name = "cold-restart"
    wd = tempfile.mkdtemp(prefix="cluster3k-")
    kw = dict(token_budget=SCHED_BUDGET, supervisor_kw=dict(
        sleep=lambda s: None, backoff_s=0.0, circuit_threshold=2,
        wal_kw={"group_interval_s": 0.0}, checkpoint_every=16))
    try:
        cl = serving.ServingCluster(box["factory"], replicas=2, wal_dir=wd,
                                    **kw)
        inj = serving.FaultInjector()
        handles = [cl.submit(p, max_new_tokens=m, tenant=t)
                   for t, p, m in treqs]
        out, state = {}, {"phase": 0, "step": 0}
        failover = cl._failover

        def timed_failover(idx):
            torch.cuda.synchronize()
            t = time.perf_counter()
            failover(idx)
            torch.cuda.synchronize()
            out["failover_ms"] = (time.perf_counter() - t) * 1e3
            state.update(phase=2, at=state["step"])
        cl._failover = timed_failover
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with inj:
            while True:
                i = state["step"]
                if state["phase"] == 0 and all(h.tokens for h in handles
                                               if not h.done):
                    kill_next_step(inj, cl.replicas[1])
                    state["phase"] = 1
                elif state["phase"] == 2 and i == state["at"] + 1:
                    sub = cl._replica_wal_dir(1)
                    got = set(wal_mod.recover_state(sub, repair=False)[
                        "sessions"])
                    owned = {r for r, j in cl._owner.items() if j == 1}
                    if not got <= owned:
                        fail(f"cluster {name}: after the failover replica "
                             f"1's directory recovers sessions "
                             f"{sorted(got - owned)} that it does not own")
                    out["failed_over_dir_sessions"] = len(got)
                elif state["phase"] == 2 and i == state["at"] + 5:
                    for s in cl.replicas:
                        crashy(s)
                    inj.arm("decode_step", "raise", nth=1)
                    state["phase"] = 3
                before = {h.rid: list(h.tokens) for h in handles}
                died = False
                try:
                    more = cl.step()
                except ProcessDied:
                    died = True
                if died:
                    break
                state["step"] += 1
                if not more:
                    fail(f"cluster {name}: the run ended before the death "
                         f"(phase {state['phase']})")
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        if cl.failovers_total < 1:
            fail(f"cluster {name}: no failover before the death")
        del cl
        gc.collect()
        scans, real_scan = [], wal_mod.recover_state

        def timed_scan(path, repair=True):
            t = time.perf_counter()
            st = real_scan(path, repair=repair)
            scans.append((time.perf_counter() - t) * 1e3)
            return st
        n_builds = len(box["builds"])
        wal_mod.recover_state = timed_scan
        t1 = time.perf_counter()
        try:
            rec_cl = serving.ServingCluster.recover_from_disk(
                box["factory"], wd, **kw)
        finally:
            wal_mod.recover_state = real_scan
        torch.cuda.synchronize()
        total = (time.perf_counter() - t1) * 1e3
        restored = rec_cl.recovered
        journal = {rid: list(r.tokens) for rid, r in restored.items()}
        resident = int(sum(r.prompt.size + len(r.tokens)
                           for r in restored.values()))
        handles = [restored.get(h.rid, h) for h in handles]
        timers = time_cluster(rec_cl)
        t2 = time.perf_counter()
        drive = cluster_drive(torch, rec_cl, name)
        after = time.perf_counter() - t2
        counts = kernels.launch_counts()
        final = {h.rid: list(h.tokens) for h in handles}
        check_recovery(f"cluster {name}", before, journal, final)
        check_cluster_handles(name, sorted(before), handles)
        build_ms = sum(box["builds"][n_builds:])
        rec = cluster_record(name, None, rec_cl, box, drive, timers, handles,
                             counts, kernels, cfg, t_run + after)
        rec.update(restart_ms=total, scan_ms=sum(scans), build_ms=build_ms,
                   install_ms=total - sum(scans) - build_ms,
                   restored_sessions=len(restored), resident_tokens=resident,
                   run_after_restart_s=after, **out)
        del rec_cl, box
        gc.collect()
        torch.cuda.empty_cache()
        return rec
    finally:
        shutil.rmtree(wd, ignore_errors=True)


def run_cluster(torch, kernels, cfg, seed: int, reqs):
    """Phase 3k: the serving cluster (``ServingCluster``: supervised
    replicas of phase 3e's engine, fused, the host tier on, at ``cfg``'s
    width and depth on one params dict from phase 3's seed; phase 3e's
    16 requests over four tenants, each on its own 192-token system
    prompt). (a) routed over 2 replicas against one (KV bf16 and int8);
    (b) disaggregated, host-staged and direct (``cluster_disaggregated``);
    (c) failover and retirement (``cluster_failover``); (d) trace-driven
    traffic with the autoscaler, admission and a quota
    (``cluster_traffic``); (e) a process death and
    ``recover_from_disk`` (``cluster_restart``); (f) in every run the
    launches equal the forwards of every engine built. Token agreement
    of the routed runs with the one-engine run is reported, not gated
    (bf16 near ties; identity is the CPU tests' gate, in f32)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.inference import ContinuousBatchingEngine as E
    from paddle_tpu_torch.models.llama import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    treqs, systems = tenant_requests(reqs, cfg.vocab_size, seed)
    runs, phase_s = [], {}
    # warm the card (cuBLAS handles, the allocator's first blocks) before
    # the one-replica run that the routed ones are compared with
    warm = wal_engine(E, params, cfg)
    warm.generate([p for _, p, _ in treqs[:2]], max_new_tokens=4)
    del warm
    lap = [time.perf_counter()]

    def keep(part, *recs):
        for rec in recs:
            print("cluster " + show({k: v for k, v in rec.items()
                                     if not k.startswith("_")}))
            runs.append(rec)
        now = time.perf_counter()
        phase_s[part] = now - lap[0]
        lap[0] = now

    for kv in (None, "int8"):
        one = cluster_routed(torch, kernels, serving, obs, E, params, cfg,
                             treqs, kv, 1)
        two = cluster_routed(torch, kernels, serving, obs, E, params, cfg,
                             treqs, kv, 2)
        if one["_order"] != two["_order"]:
            fail("cluster: the routed runs submitted in different orders")
        two.update(token_agreement(two["tokens"], one["tokens"]))
        keep(f"a-{kv or 'bf16'}", one, two)
    for direct in (False, True):
        keep("b-direct" if direct else "b-staged", cluster_disaggregated(
            torch, kernels, serving, obs, E, params, cfg, treqs, direct))
    keep("c", cluster_failover(torch, kernels, serving, obs, E, params, cfg,
                               treqs, systems))
    keep("d", cluster_traffic(torch, kernels, serving, obs, E, params, cfg,
                              seed))
    keep("e", cluster_restart(torch, kernels, serving, obs, E, params, cfg,
                              treqs))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for r in runs:
        r.pop("tokens", None)
        r.pop("_order", None)
    print("cluster parts " + json.dumps(phase_s))
    return {"runs": runs, "part_s": phase_s}


# --------------------------------------------------------------- phase 3c
def dense_tier(torch, kernels, gen, params, cfg, name: str, prompt,
               new: int, fn: str = "generate", b7: bool = True,
               reps: int = 2, **kw):
    """One tier of dense decoding: ``gen.<fn>(params, prompt, cfg,
    max_new_tokens=new, **kw)`` timed ``reps`` times, and as many times
    with one new token (prefill and first token only); decode tokens/s
    is rows * (new - 1) over the difference of the best times, as the
    JAX bench computes it (``bench.py`` ``decode_rate``). The launch
    counters are zeroed just before the timed calls and read just
    after: B7 once per layer and decode step of each full call (none
    for a tier without ``b7``), no other kernel. The output must hold
    the prompt and ``new`` tokens in the vocabulary."""
    rows = prompt.shape[0]

    def run(n):
        return getattr(gen, fn)(params, prompt, cfg, max_new_tokens=n, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    full, one = [], []
    for times, n in ((full, new), (one, 1)):
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run(n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if n == new:
                last = out
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {**dict.fromkeys(kernels.WRAPPERS, 0),
            "B7": cfg.num_layers * (new - 1) * reps if b7 else 0}
    if counts != want:
        fail(f"dense tier {name}: launches {counts} != {want}")
    if (tuple(last.shape) != (rows, prompt.shape[1] + new)
            or not bool(((last >= 0) & (last < cfg.vocab_size)).all())):
        fail(f"dense tier {name}: output {tuple(last.shape)} out of range")
    dt = min(full) - min(one)
    return dict(tier=name, fn=fn, rows=rows, prompt_len=prompt.shape[1],
                new_tokens=new, reps=reps,
                kv="int8" if kw.get("kv_cache_dtype") else "bf16",
                full_s=full, one_s=one,
                decode_tokens_per_s=rows * (new - 1) / dt,
                decode_step_ms=dt / (new - 1) * 1e3, peak_mem_gb=peak,
                launches=counts)


def decode_logits_check(torch, gen, params, cfg, prompt, kv):
    """One dense decode step after the prompt's prefill, through B7 and
    through the plain composition (``use_kernel=False``) from copies of
    the same cache: max |logits difference| (LOGITS_ATOL)."""
    B, S = prompt.shape
    cache = gen.init_cache(cfg, B, S + 1, kv_dtype=kv, device="cuda")
    logits = gen._forward_cached(params, prompt, cache, 0, cfg, S + 1)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    other = {n: c.clone() for n, c in cache.items()}
    a = gen._forward_cached(params, tok, cache, S, cfg, S + 1)
    b = gen._forward_cached(params, tok, other, S, cfg, S + 1,
                            use_kernel=False)
    return dict(logits_max_abs_err=(a - b).abs().max().item(),
                logits_max_abs=b.abs().max().item(),
                argmax_equal_share=(a.argmax(-1) == b.argmax(-1)).float()
                .mean().item())


def profile_dense(torch, tl, gen, params, cfg, prompt, steps: int = 8):
    """``torch.profiler`` over ``steps`` dense decode steps after the
    prompt's prefill and one warm step: the card's time split into the
    attention kernel (B7), matmuls, the weights' dequantization (the
    device time of the kernels launched inside ``_w``, which runs under a
    ``record_function`` span here) and the rest, beside the host's wall
    time per step. Launches made here are not counted on the main
    path."""
    from torch.profiler import ProfilerActivity, profile, record_function
    B, S = prompt.shape
    max_len = S + steps + 2
    cache = gen.init_cache(cfg, B, max_len, device="cuda")
    tok = gen._forward_cached(params, prompt, cache, 0, cfg, max_len)
    tok = tok.argmax(-1).to(torch.int32)
    gen._forward_cached(params, tok[:, None], cache, S, cfg, max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        gen._forward_cached(params, tok[:, None], cache, S + 1 + i, cfg,
                            max_len)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / steps
    w = tl._w

    def spanned(lp, name, dtype):
        with record_function("dequant"):
            return w(lp, name, dtype)

    tl._w = gen._w = spanned
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                gen._forward_cached(params, tok[:, None], cache, S + 1 + i,
                                    cfg, max_len)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        tl._w = gen._w = w
    # the idle share against the unprofiled step: the profiler's own
    # host overhead would inflate it
    rec = device_breakdown(torch, prof, steps, plain_wall,
                           skip=("dequant",))
    rec["profiled_wall_ms_per_call"] = wall
    from torch.autograd import DeviceType
    dq = sum(ev.device_time_total for ev in prof.key_averages()
             if ev.key == "dequant" and ev.device_type == DeviceType.CPU)
    kinds = rec.get("device_ms_per_call_by_kind")
    quantized = "wq_scale" in params["layers"]
    if kinds is not None:
        # unquantized weights launch nothing in _w; quantized ones whose
        # span shows no device time were not measured
        kinds["dequant"] = (dq / 1e3 / steps if dq or not quantized
                            else "not measured")
        if dq:
            kinds["other"] -= kinds["dequant"]
    return rec


def run_dense(torch, np, kernels, tl, gen, cfg, seed: int):
    """Phase 3c: dense decoding at ``cfg``'s width and depth from
    seeded random weights. The JAX bench's decode tier (B = 8, prompt
    128, 64 new, greedy) for weights {bf16, int8, int4} x KV {bf16,
    int8}, each with its decode-step logits check; a long tier (prompt
    1920, 128 new) and its profile; ``beam_search`` (B = 2, 4 beams, 32
    new); a shared 200-token prompt cache; a left-padded batch, whose
    decode steps take the plain composition and so launch no B7; and the
    profiles of the bf16 and int8-weight bench tiers."""
    V = cfg.vocab_size
    t0 = time.perf_counter()
    params = tl.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)

    def tokens(shape):
        return torch.as_tensor(rng.integers(3, V, shape), dtype=torch.int32,
                               device="cuda")

    prompt = tokens((8, 128))
    gen.generate(params, prompt, cfg, max_new_tokens=2)          # warm
    tiers, checks, profiles = [], {}, {}
    for bits in (None, 8, 4):
        wn = f"w{bits}" if bits else "wbf16"
        t0 = time.perf_counter()
        pp = params if bits is None else gen.quantize_weights(params, cfg,
                                                              bits=bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        for kv in (None, "int8"):
            name = f"{wn}-kv{'8' if kv else 'bf16'}"
            rec = dense_tier(torch, kernels, gen, pp, cfg, name, prompt, 64,
                             kv_cache_dtype=kv)
            rec["quantize_s"] = quant_s if bits else 0.0
            checks[name] = decode_logits_check(torch, gen, pp, cfg, prompt,
                                               kv)
            if not checks[name]["logits_max_abs_err"] <= LOGITS_ATOL:
                fail(f"dense tier {name}: B7 decode logits vs the plain "
                     f"composition {checks[name]}")
            rec.update(checks[name])
            print("dense " + json.dumps(rec))
            tiers.append(rec)
        if bits in (None, 8):
            profiles[wn] = profile_dense(torch, tl, gen, pp, cfg, prompt)
            print(f"dense profile {wn} " + json.dumps(profiles[wn]))
        del pp
        gc.collect()
        torch.cuda.empty_cache()
    long_prompt = tokens((8, 1920))
    rec = dense_tier(torch, kernels, gen, params, cfg, "long", long_prompt,
                     128, reps=1)
    print("dense " + json.dumps(rec))
    tiers.append(rec)
    profiles["long"] = profile_dense(torch, tl, gen, params, cfg,
                                     long_prompt)
    print("dense profile long " + json.dumps(profiles["long"]))
    del long_prompt
    gc.collect()
    torch.cuda.empty_cache()
    rec = dense_tier(torch, kernels, gen, params, cfg, "beam",
                     tokens((2, 128)), 32, fn="beam_search", num_beams=4)
    print("dense " + json.dumps(rec))
    tiers.append(rec)
    pc = gen.precompute_prompt_cache(params, tokens((200,)), cfg)
    rec = dense_tier(torch, kernels, gen, params, cfg, "prompt-cache",
                     prompt, 64, prompt_cache=pc)
    print("dense " + json.dumps(rec))
    tiers.append(rec)
    del pc
    padded = prompt.clone()
    for r, n in enumerate((0, 5, 17, 40, 64, 90, 100, 127)):
        padded[r, :n] = 0
    rec = dense_tier(torch, kernels, gen, params, cfg, "left-padded",
                     padded, 64, b7=False, pad_token_id=0)
    print("dense " + json.dumps(rec))
    tiers.append(rec)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, init_s=init_s, tiers=tiers,
                profiles=profiles)


# --------------------------------------------------------------- phase 3d
def paddle_decoder(torch, np, IF, params, cfg, prompt, new: int, cos, sin,
                   *, block_size: int = 64, kv_int8: bool = False,
                   seed: int = 0):
    """A Llama decoder written against the port's Paddle API, the way a
    Paddle serving program calls ``incubate.nn.functional``'s fused ops
    around its projections (``torch.matmul`` here): per layer
    ``fused_rms_norm`` (the residual form after the first), the fused
    qkv projection, ``fused_rotary_position_embedding`` (neox, shared
    tables, q and k: B6), ``block_multihead_attention`` over a paged
    cache (prefill rows through its per-row loop, decode rows through
    B8), the output projection, ``fused_rms_norm(residual=...)``, the
    gate and up projections, ``swiglu`` (B5a) and the down projection;
    then the final norm and the LM head.

    prompt: (B, S) equal-length prompts; ``new`` greedy tokens. One
    batched prefill of the B * S prompt tokens, then ``new - 1`` decode
    steps, every row at one position, so each step passes that
    position's (1, D/2) rows of ``cos``/``sin`` (tables of at least S +
    new rows) with no ``position_ids``. Pages of ``block_size`` tokens,
    each row's scattered through a permutation seeded with ``seed``.
    ``kv_int8``: int8 caches with dynamic (B, HK) quant scales, 127 over
    each row's and head's K and V amax in the prefill. Needs as many kv
    heads as query heads (the op's qkv layout).

    A generator: yields ``(logits, tokens)`` after the prefill and after
    each decode step, logits (B, V) float32 and the greedy tokens (B,)."""
    B, S = prompt.shape
    L, nh, hd, eps = cfg.num_layers, cfg.num_heads, cfg.hd, cfg.rms_eps
    if cfg.num_kv_heads != nh:
        raise ValueError("paddle_decoder: block_multihead_attention's qkv "
                         "layout needs num_kv_heads == num_heads")
    lay = params["layers"]
    dev = params["embed"].device
    wqkv = [torch.cat([lay[n][l] for n in ("wq", "wk", "wv")], dim=-1)
            for l in range(L)]
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    pps = -(-(S + new) // block_size)
    bt = np.random.default_rng(seed).permutation(B * pps).reshape(
        B, pps).astype(np.int32)
    shape = (L, B * pps, nh, block_size, hd)
    kv_dtype = torch.int8 if kv_int8 else cfg.dtype
    kc = torch.zeros(shape, dtype=kv_dtype, device=dev)
    vc = torch.zeros(shape, dtype=kv_dtype, device=dev)
    quant = [dict() for _ in range(L)]

    def amax_scales(t):             # (B, T, nh, hd) -> (B, nh) f32
        a = t.float().abs().amax(dim=(1, 3))
        return 127.0 / torch.clamp(a, min=1e-6)

    def forward(x, T, enc, dec, c, s):
        """x: (B * T, hidden) token batch -> (B, V) logits of each row's
        last token."""
        this = np.full((B,), T, np.int32)
        mlp = None
        for l in range(L):
            if mlp is None:
                h1 = IF.fused_rms_norm(x, norm_weight=lay["attn_norm"][l],
                                       epsilon=eps)._value
            else:
                h1, x = (t._value for t in IF.fused_rms_norm(
                    mlp, norm_weight=lay["attn_norm"][l], epsilon=eps,
                    residual=x))
            qkv = (h1 @ wqkv[l]).unflatten(-1, (3, nh, hd)).unflatten(
                0, (B, T))
            rq, rk, _ = IF.fused_rotary_position_embedding(
                qkv[:, :, 0], qkv[:, :, 1], sin=s, cos=c)
            rq, rk = rq._value, rk._value
            if kv_int8 and T > 1:       # the prefill calibrates the scales
                quant[l] = dict(cache_k_quant_scales=amax_scales(rk),
                                cache_v_quant_scales=amax_scales(
                                    qkv[:, :, 2]),
                                use_dynamic_cachekv_quant=True)
            qkv = torch.stack([rq, rk, qkv[:, :, 2]], dim=2).reshape(
                B * T, 3 * nh * hd)
            o = IF.block_multihead_attention(
                qkv, kc[l], vc[l], enc, dec, this, block_tables=bt,
                block_size=block_size, **quant[l])[0]._value
            h2, x = (t._value for t in IF.fused_rms_norm(
                o @ lay["wo"][l], norm_weight=lay["mlp_norm"][l],
                epsilon=eps, residual=x))
            act = IF.swiglu(h2 @ lay["wg"][l], h2 @ lay["wu"][l])._value
            mlp = act @ lay["wd"][l]
        h = IF.fused_rms_norm(mlp, norm_weight=params["final_norm"],
                              epsilon=eps, residual=x)[0]._value
        return (h.unflatten(0, (B, T))[:, -1] @ head).float()

    zeros = np.zeros((B,), np.int32)
    x = params["embed"][prompt.long()].to(cfg.dtype).flatten(0, 1)
    logits = forward(x, S, np.full((B,), S, np.int32), zeros, cos[:S],
                     sin[:S])
    tok = logits.argmax(-1)
    yield logits, tok
    for i in range(new - 1):
        p = S + i
        x = params["embed"][tok].to(cfg.dtype)
        logits = forward(x, 1, zeros, np.full((B,), p, np.int32),
                         cos[p:p + 1], sin[p:p + 1])
        tok = logits.argmax(-1)
        yield logits, tok


def decoder_reference(torch, gen, params, cfg, prompt, tokens, kv):
    """The port's own dense cached forward (``generate``'s) on the same
    prompts, fed the decoder's tokens: the logits of the prefill and of
    each following step, (new, B, V)."""
    B, S = prompt.shape
    new = tokens.shape[1]
    max_len = S + new
    cache = gen.init_cache(cfg, B, max_len, kv_dtype=kv, device="cuda")
    out = [gen._forward_cached(params, prompt, cache, 0, cfg, max_len)]
    for i in range(new - 1):
        out.append(gen._forward_cached(params, tokens[:, i:i + 1], cache,
                                       S + i, cfg, max_len))
    return torch.stack(out)


def run_paddle_decoder(torch, np, kernels, IF, tl, gen, cfg, seed: int,
                       batch: int = 8, prompt_len: int = 1024,
                       new: int = 64, block_size: int = 64):
    """Phase 3d: the Paddle fused-op decoder (``paddle_decoder``) at
    ``cfg``'s width and depth from fresh seeded weights, KV bf16 and
    int8. Per tier: the launch counters zeroed just before the decode
    steps (after the prefill) and read just after, which must equal what
    the path implies per layer and step (B6 twice, B8 once, B4a twice
    and once more for the final norm, B5a once, nothing else); decode
    tokens/s and ms a step on the host clock; peak memory; each step's
    logits within LOGITS_ATOL of ``generate``'s cached forward on the
    same tokens (same KV dtype), and the share of greedy tokens that
    forward would pick (reported, not gated). Then ``torch.profiler``
    over a few bf16 decode steps."""
    t0 = time.perf_counter()
    params = tl.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed + 3), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.as_tensor(np.random.default_rng(seed + 3).integers(
        3, cfg.vocab_size, (batch, prompt_len)), dtype=torch.int32,
        device="cuda")
    cos, sin = tl.rope_tables(prompt_len + new, cfg.hd, cfg.rope_theta,
                              device="cuda")
    L, steps = cfg.num_layers, new - 1
    want = {**dict.fromkeys(kernels.WRAPPERS, 0), "B6": 2 * L * steps,
            "B8": L * steps, "B4a": (2 * L + 1) * steps, "B5a": L * steps}
    tiers = []
    for kv in (None, "int8"):
        kvn = "int8" if kv else "bf16"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        it = paddle_decoder(torch, np, IF, params, cfg, prompt, new, cos,
                            sin, block_size=block_size,
                            kv_int8=kv is not None, seed=seed)
        t0 = time.perf_counter()
        logits, toks = next(it)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        out_logits, out_toks = [logits], [toks]
        t0 = time.perf_counter()
        for logits, toks in it:
            out_logits.append(logits)
            out_toks.append(toks)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if counts != want:
            fail(f"paddle decoder {kvn}: launches {counts} != {want}")
        got = torch.stack(out_logits)
        tokens = torch.stack(out_toks, dim=1).to(torch.int32)
        if not bool(torch.isfinite(got).all()):
            fail(f"paddle decoder {kvn}: non-finite logits")
        ref = decoder_reference(torch, gen, params, cfg, prompt, tokens, kv)
        err = (got - ref).abs().amax(dim=(1, 2))
        if not float(err.max()) <= LOGITS_ATOL:
            fail(f"paddle decoder {kvn}: logits against generate's cached "
                 f"forward off by {float(err.max())} (> {LOGITS_ATOL})")
        agree = (ref.argmax(-1).T == tokens).float().mean().item()
        rec = dict(tier=kvn, kv=kvn, rows=batch, prompt_len=prompt_len,
                   new_tokens=new, block_size=block_size,
                   prefill_s=prefill_s, decode_s=decode_s,
                   decode_tokens_per_s=batch * steps / decode_s,
                   decode_step_ms=decode_s / steps * 1e3,
                   peak_mem_gb=peak, launches=counts,
                   logits_max_abs_err=float(err.max()),
                   logits_max_abs_err_by_step=err.tolist(),
                   logits_max_abs=float(ref.abs().max()),
                   greedy_agreement_with_generate=agree)
        print("paddle decoder " + json.dumps(
            {k: v for k, v in rec.items()
             if k != "logits_max_abs_err_by_step"}))
        tiers.append(rec)
        del it, got, ref, out_logits
        gc.collect()
        torch.cuda.empty_cache()
    prof = profile_paddle_decoder(torch, np, IF, params, cfg, prompt, cos,
                                  sin, block_size, seed)
    print("paddle decoder profile " + json.dumps(prof))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=L, init_s=init_s, tiers=tiers, profile=prof)


def profile_paddle_decoder(torch, np, IF, params, cfg, prompt, cos, sin,
                           block_size: int, seed: int, steps: int = 4):
    """``torch.profiler`` over ``steps`` bf16 decode steps of the Paddle
    decoder after its prefill and one warm step: the card's time split
    into B6, B8 (the attention kernel), B4a/B5a, matmuls and the rest,
    against the host's wall time of the same steps unprofiled (the idle
    share). Launches made here are not counted on the main path."""
    from torch.profiler import ProfilerActivity, profile
    it = paddle_decoder(torch, np, IF, params, cfg, prompt, 2 * steps + 2,
                        cos, sin, block_size=block_size, seed=seed)
    next(it)
    next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        next(it)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            next(it)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rec = device_breakdown(torch, prof, steps, plain_wall)
    rec["profiled_wall_ms_per_call"] = wall
    return rec


# --------------------------------------------------------------- phase 3b
def train_config(LlamaConfig, layers: int, fused_kernels: str):
    """The JAX bench's training model (``bench.py`` ``pick_config`` for a
    TPU): bf16, remat with policy "nothing"."""
    return LlamaConfig(vocab_size=32000, hidden_size=1536,
                       intermediate_size=4096, num_layers=layers,
                       num_heads=12, num_kv_heads=12, max_seq_len=4096,
                       fused_kernels=fused_kernels)


def run_training(torch, np, kernels, tl, tt, args, fused_kernels: str):
    """2 warm-up and ``args.train_steps`` timed steps on one batch; the
    launch counters are zeroed just before the timed steps and read just
    after."""
    cfg = train_config(tl.LlamaConfig, args.train_layers, fused_kernels)
    seq, batch = 4096, 4               # bench.py's _SWEEP_BASE_BATCH
    t0 = time.perf_counter()
    state = tt.init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)), dtype=torch.int32, device="cuda")
    step = tt.make_train_step(cfg, seq_chunk=512)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    metrics = []
    for _ in range(2):
        state, m = step(state, tokens)
        metrics.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(args.train_steps):
        ts = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        metrics.append(m)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"training: non-finite loss or grad norm {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"training: the loss did not fall: {losses}")
    L, n = cfg.num_layers, args.train_steps
    # per layer: B1 twice (backward recomputes the checkpointed layer),
    # B2 and B3 once; under "auto" B4a four times (two norms, again in
    # the recompute) and once more for the final norm, B4b twice and
    # once, B5a twice, B5b once
    fused = {"B4a": (4 * L + 1) * n, "B4b": (2 * L + 1) * n,
             "B5a": 2 * L * n, "B5b": L * n} if fused_kernels != "xla" else {}
    want = {**dict.fromkeys(kernels.WRAPPERS, 0),
            "B1": 2 * L * n, "B2": L * n, "B3": L * n, **fused}
    if counts != want:
        fail(f"training {fused_kernels}: launches {counts} != {want}")
    tps = n * batch * seq / wall
    rec = dict(fused_kernels=fused_kernels, layers=L, batch=batch, seq=seq,
               seq_chunk=512,
               params=cfg.num_params(), init_s=init_s,
               tokens_per_s=tps, step_ms=step_ms,
               step_ms_mean=sum(step_ms) / n,
               mfu=tps * cfg.flops_per_token(seq) / BF16_FLOPS_PER_S,
               peak_mem_gb=peak, losses=losses, grad_norms=gnorms,
               launches=counts)
    return rec, step, state, tokens


def update_ms(torch, tt, state) -> float:
    """Card time of one ``clip_and_update`` (global norm, clip, AdamW,
    cast back) over the whole state, with zero f32 gradients: the
    optimizer's share of a step."""
    params = tt._leaves(state.params)
    grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return time_ms(torch, lambda: tt.clip_and_update(
        state, params, grads, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
        weight_decay=0.1, grad_clip=1.0), reps=3, warmup=1)


def slice_leaves(fused_kernels: str):
    return ATTN_LEAVES + (FUSED_LEAVES if fused_kernels != "xla" else ())


def leaf_grads(torch, tl, params, tokens, cfg):
    """``loss_fn`` and its gradients of the checked leaves, as f32 on the
    CPU (each a (layers, ...) stack)."""
    ws = [params["layers"][n] for n in slice_leaves(cfg.fused_kernels)]
    for w in ws:
        w.requires_grad_(True)
    try:
        loss = tl.loss_fn(params, tokens, cfg, seq_chunk=512)
        grads = torch.autograd.grad(loss, ws, materialize_grads=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    return loss.item(), [g.float().cpu() for g in grads]


def slice_errors(torch, card, ref, leaves):
    """Relative errors of (loss, grads) ``card`` against ``ref``: the
    loss, and each leaf's gradient per layer (Frobenius norm of the
    difference over the larger of the two norms)."""
    errs = {"loss": abs(card[0] - ref[0]) / abs(ref[0])}
    for n, a, b in zip(leaves, card[1], ref[1]):
        errs[n] = [((x - y).norm() / torch.maximum(x.norm(), y.norm())).item()
                   for x, y in zip(a, b)]
    return errs


def slice_failures(errs) -> list:
    """The entries of ``errs`` over their SLICE_* limits (NaN is over)."""
    lim = {"loss": SLICE_LOSS_RTOL, "grad_norm": SLICE_GNORM_RTOL,
           **dict.fromkeys(ATTN_LEAVES + FUSED_LEAVES, SLICE_LEAF_RTOL)}
    return [k for k, e in errs.items()
            if not max(e if isinstance(e, list) else [e]) <= lim[k]]


def slice_faults(torch, tl, fa, fk, fused_kernels: str):
    """(name, module, attribute, replacement): the faults planted in the
    CPU reference. "xla": two in the attention (its einsum path);
    "auto": one in B4 and one in B5 (their plain versions)."""
    if fused_kernels == "xla":
        def skip_last_tile(q, k, v, causal=True):
            return fa.flash_attention_plain(q, k[:, :-FAULT_TILE],
                                            v[:, :-FAULT_TILE], causal)[0]

        return [("attention output zero", tl, "_attention",
                 lambda q, k, v, causal=True: q * 0.0),
                (f"last {FAULT_TILE} keys skipped", tl, "_attention",
                 skip_last_tile)]
    rms_fwd_plain = fk.rms_norm_fwd_plain

    def eps_x10(x, w, eps):
        return rms_fwd_plain(x, w, 10 * eps)

    def dsilu_sigmoid(g, u, d):
        sig = torch.sigmoid(g.float())
        return ((d.float() * u.float() * sig).to(g.dtype),
                (d.float() * g.float() * sig).to(u.dtype))

    return [("B4a eps ten times too large", fk, "rms_norm_fwd_plain",
             eps_x10),
            ("B5b dsilu = sigmoid(g)", fk, "swiglu_bwd_plain",
             dsilu_sigmoid)]


def whole_slice(torch, np, tl, tt, fa, fk, seed: int, fused_kernels: str):
    """A 2-layer model at full width, B = 1, S = 1024: bf16 with the
    kernels on the card, and from the same parameters in f32 on the CPU
    with the plain versions. Compares ``loss_fn``'s gradients of the
    checked leaves (``slice_leaves``), then one ``make_train_step``
    step's loss and grad norm. Controls: the CPU side with each planted
    fault of ``slice_faults`` must fail the same limits."""
    import dataclasses
    cfg = train_config(tl.LlamaConfig, 2, fused_kernels)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 1024)), dtype=torch.int32)
    card = tt.init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(seed + 1), device="cuda")

    def f32_cpu(tree):
        return {k: f32_cpu(v) if isinstance(v, dict) else v.float().cpu()
                for k, v in tree.items()}

    cpu = tt.TrainState(0, *(f32_cpu(t) for t in (
        card.params, card.master, card.m, card.v)))
    # "auto" is fused only on the card: the CPU reference of the fused
    # mode asks for the fused ops' plain versions with "pallas"
    cpu_cfg = dataclasses.replace(
        cfg, dtype=torch.float32,
        fused_kernels="xla" if fused_kernels == "xla" else "pallas")
    leaves = slice_leaves(fused_kernels)
    t0 = time.perf_counter()
    on_card = leaf_grads(torch, tl, card.params, tokens.cuda(), cfg)
    on_cpu = leaf_grads(torch, tl, cpu.params, tokens, cpu_cfg)
    cpu_s = time.perf_counter() - t0
    errs = slice_errors(torch, on_card, on_cpu, leaves)
    controls = {}
    for name, module, attr, fault in slice_faults(torch, tl, fa, fk,
                                                  fused_kernels):
        kept = getattr(module, attr)
        setattr(module, attr, fault)
        try:
            faulty = leaf_grads(torch, tl, cpu.params, tokens, cpu_cfg)
        finally:
            setattr(module, attr, kept)
        controls[name] = slice_errors(torch, on_card, faulty, leaves)
        if not slice_failures(controls[name]):
            fail(f"whole slice: the check passes the CPU reference with its "
                 f"{name} ({controls[name]})")
    # the step's loss is loss_fn's above; its grad norm covers every leaf
    _, mc = tt.make_train_step(cfg, seq_chunk=512)(card, tokens.cuda())
    _, mh = tt.make_train_step(cpu_cfg, seq_chunk=512)(cpu, tokens)
    rec = {k: {"card_bf16": mc[k].item(), "cpu_f32": mh[k].item()}
           for k in ("loss", "grad_norm")}
    a, b = rec["grad_norm"]["card_bf16"], rec["grad_norm"]["cpu_f32"]
    errs["grad_norm"] = abs(a - b) / abs(b)
    bad = slice_failures(errs)
    if bad:
        fail(f"whole slice: {bad} over their limits: {errs}")
    rec.update(fused_kernels=fused_kernels, rel_err=errs, controls=controls,
               cpu_grads_s=cpu_s)
    return rec


def profile_train(torch, step, state, tokens, step_ms: float):
    """``torch.profiler`` over one training step; the idle share is taken
    against the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rec = device_breakdown(torch, prof, 1, step_ms)
    rec["profiled_wall_ms"] = wall
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="engine depth (Llama-2-7B has 32)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--train-layers", type=int, default=20,
                    help="training model depth (the JAX bench's has 20)")
    ap.add_argument("--train-steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("3h", "3i", "3j", "3k"),
                    help="build, then run this phase alone (3h at "
                         "--layers, 3i, 3j and 3k at a quarter of them) "
                         "and write its record; no kernel line")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import generate as gen
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.models import train as tt
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused as fk
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    record = {"card": card, "kind": kind, "phase_s": {}}
    t_lap = [time.perf_counter()]

    def lap(phase):
        """Print and record the seconds since the previous phase ended."""
        now = time.perf_counter()
        record["phase_s"][phase] = now - t_lap[0]
        print(f"phase {phase}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    # ---- phase 1: build
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({built})")
    for name in _build.SOURCES:
        log = _build.log_path(name)
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    print(f"  ptxas {name}: {line.strip()}")
    record["build_s"] = build_s
    hop = hopper_ptxas(_build.log_path("flash_attention").read_text(
        errors="replace"))
    for r in hop:
        print("ptxas hopper " + json.dumps(r))
    if len(hop) != 6 or any(r.get("registers") != 168 for r in hop):
        fail(f"the six Hopper flash kernels (B1, B2, B3 at D = 64 and 128) "
             f"must enter with 168 registers (setmaxnreg moves them "
             f"between warpgroups): {hop}")
    record["hopper_ptxas"] = hop
    # B8 and B7 in bf16: the split-key kernels of csrc/decode_attention.cu,
    # B7's with the dense addressing (the last template flag); B7's must
    # not spill
    split = ptxas_report(_build.log_path("decode_attention").read_text(
        errors="replace"), r"paged_decode_split_kernel")
    b7 = [r for r in split if r["kernel"].endswith(", true>")]
    b8 = [r for r in split if r not in b7]
    for name, recs in (("B8", b8), ("B7", b7)):
        for r in recs:
            print(f"ptxas {name} " + json.dumps(r))
        if len(recs) != 4 or any("registers" not in r for r in recs):
            fail(f"expected ptxas's report of 4 {name} split kernels, got "
                 f"{recs}")
    if any(r.get("spill_stores") or r.get("spill_loads") for r in b7):
        fail(f"B7's split kernels spill: {b7}")
    record["b8_ptxas"] = b8
    record["b7_ptxas"] = b7
    # B9/B10 in bf16: the same key-split body over token-major pools with
    # per-token int8 scales, {bf16, int8} x D {64, 128} x {B9, B10}
    b910 = ptxas_report(_build.log_path("paged_decode").read_text(
        errors="replace"), r"paged_decode_split_kernel")
    for r in b910:
        print("ptxas B9/B10 " + json.dumps(r))
    if len(b910) != 8 or any("registers" not in r for r in b910):
        fail(f"expected ptxas's report of 8 B9/B10 split kernels, got "
             f"{b910}")
    record["b9_b10_ptxas"] = b910
    # every bf16 B11 instantiation: the prefill (wgmma) and verify
    # (mma.sync, key split) kernels of csrc/flash_chunk.cu
    b11 = ptxas_report(_build.log_path("flash_chunk").read_text(
        errors="replace"), r"chunk_(prefill|verify)_kernel")
    for r in b11:
        print("ptxas B11 " + json.dumps(r))
    if len(b11) != 32 or any("registers" not in r for r in b11):
        fail(f"expected ptxas's report of 32 B11 kernels, got {b11}")
    record["b11_ptxas"] = b11
    lap("1")
    if args.only is not None:
        depth = args.layers if args.only == "3h" else max(1,
                                                          args.layers // 4)
        cfg = LlamaConfig.llama2_7b(num_layers=depth)
        reqs = make_requests(args.requests, cfg.vocab_size, args.seed)
        key, run = {"3h": ("host_tier", run_host_tier),
                    "3i": ("adapters", run_adapters),
                    "3j": ("wal", run_wal),
                    "3k": ("cluster", run_cluster)}[args.only]
        record[key] = run(torch, kernels, cfg, args.seed, reqs)
        lap(args.only)
        for r in record[key]["runs"]:
            r.pop("tokens", None)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out",
                               f"chip_smoke_{args.only}.json"), "w") as f:
            json.dump(record, f, indent=1)
        return 0

    # ---- phase 2: kernels vs plain
    results = {}
    decode_kernel = []
    for fused, name in ((False, "B9"), (True, "B10")):
        for kv_int8 in (False, True):
            r = check_decode(torch, F, kernels, fused, kv_int8,
                             seed=11 if fused else 7, sweep=True)
            torch.cuda.synchronize()
            key = f"{name}-{'int8' if kv_int8 else 'bf16'}"
            results[key] = r
            decode_kernel.append(r)
            print(f"kernel {key}: " + json.dumps(r))
    # B9 and B10 where the key split rule splits: one Llama-2-7B row of
    # 4,096 tokens (B x HK = 32: 8 splits), and Llama-3-8B's GQA (HK = 8)
    # over the ragged rows (64: 4 splits); the rule's choice must beat
    # one split
    for shape, lens, pps, HK in (("single", (4096,), 256, 32),
                                 ("gqa", RAGGED_LENS, 128, 8)):
        for fused, name in ((False, "B9"), (True, "B10")):
            for kv_int8 in (False, True):
                r = check_decode(torch, F, kernels, fused, kv_int8, seed=13,
                                 lens=lens, pps=pps, HK=HK, sweep=True)
                torch.cuda.synchronize()
                print(f"kernel {name} {shape}: " + json.dumps(r))
                if not r["ms"] < 0.9 * r["split_ms"][1]:
                    fail(f"{r['shape']} {shape}: the split rule's choice "
                         f"({r['ms']:.4g} ms) is not 10% faster than one "
                         f"split ({r['split_ms'][1]:.4g} ms)")
                decode_kernel.append(r)
    gc.collect()
    torch.cuda.empty_cache()
    for kv_int8 in (False, True):
        worst, worst_ratio = 0.0, 0.0
        key = f"B11-{'int8' if kv_int8 else 'bf16'}"
        for ctx_cap, ctx_len in ((0, 0), (256, 200), (1024, 1000),
                                 (2048, 1900)):
            r = check_chunk(torch, F, kernels, kv_int8, ctx_cap, ctx_len)
            torch.cuda.synchronize()
            worst = max(worst, r["max_abs_err"])
            worst_ratio = max(worst_ratio, r["row_ratio"])
            print(f"kernel {key} ctx_cap={ctx_cap}: " + json.dumps(r))
            if ctx_cap == 1024:
                results[key] = r
        results[key].update(max_abs_err=worst, row_ratio=worst_ratio)
    # B11 at the speculative verify shapes: linear (n-gram, spec_k = 4)
    # and tree ((2, 4) comb, 9 nodes), B = 8 rows of ragged contexts
    verify = []
    for kv_int8 in (False, True):
        kvn = "int8" if kv_int8 else "bf16"
        for ctx_cap in (1024, 2048):
            r = check_verify(torch, F, kernels, kv_int8, ctx_cap, 5, False)
            verify.append(r)
            print(f"kernel B11-linear-verify-{kvn}: " + json.dumps(r))
        r = check_verify(torch, F, kernels, kv_int8, 2048, 9, True)
        torch.cuda.synchronize()
        verify.append(r)
        print(f"kernel B11-tree-{kvn}: " + json.dumps(r))
        results[f"B11-tree-{kvn}"] = r
    # GQA (H = 32, HK = 8, ctx_cap 2048): the kernels pack the 4 query
    # heads of a kv head into one tile, the prefill chunk and the verify
    gqa = []
    for kv_int8 in (False, True):
        kvn = "int8" if kv_int8 else "bf16"
        for r in (check_chunk(torch, F, kernels, kv_int8, 2048, 1900, HK=8),
                  check_verify(torch, F, kernels, kv_int8, 2048, 5, False,
                               HK=8)):
            torch.cuda.synchronize()
            gqa.append(r)
            print(f"kernel B11-gqa-{kvn}: " + json.dumps(r))
    # B7 at the Llama-2-7B dense decode shape (its row in the kernel
    # line) and at the JAX bench model's (H = 12, prompt 128 + 64 new);
    # then where the key split rule splits: one Llama-2-7B row of 4,096
    # tokens (B x HK = 32: 8 splits) and Llama-3-8B's GQA (HK = 8) over
    # the ragged rows (64: 4 splits), where the rule's choice must beat
    # one split; every shape swept over forced splits
    dense_kernel = []
    for kv_int8 in (False, True):
        kvn = "int8" if kv_int8 else "bf16"
        for name, H, HK, S, lens in (
                ("ragged", 32, 32, 2048, RAGGED_LENS),
                ("bench", 12, 12, 192, (1, 192, 150, 129, 64, 100, 191,
                                        17)),
                ("single", 32, 32, 4096, (4096,)),
                ("gqa", 32, 8, 2048, RAGGED_LENS)):
            r = check_dense_decode(torch, F, kernels, kv_int8, H, S, lens,
                                   seed=300 + H + HK, HK=HK, sweep=True)
            torch.cuda.synchronize()
            dense_kernel.append(r)
            print(f"kernel B7-{kvn} {name}: " + json.dumps(r))
            if name == "ragged":
                results[f"B7-{kvn}"] = r
            if (name in ("single", "gqa")
                    and not r["ms"] < 0.9 * r["split_ms"][1]):
                fail(f"{r['shape']} {name}: the split rule's choice "
                     f"({r['ms']:.4g} ms) is not 10% faster than one "
                     f"split ({r['split_ms'][1]:.4g} ms)")
        gc.collect()
        torch.cuda.empty_cache()
    # the training shape (its row in the kernel line), the same length at
    # D = 64 (the other template), timed; then ragged shapes, lengths
    # that are not multiples of 64 among them
    flash = [check_flash(torch, F, fa, 4, 4096, 4096, 12, 12, 128, True,
                         seed=21, timed=True)]
    gc.collect()
    torch.cuda.empty_cache()
    flash.append(check_flash(torch, F, fa, 4, 4096, 4096, 24, 24, 64, True,
                             seed=23, timed=True))
    gc.collect()
    torch.cuda.empty_cache()
    for B, sq, sk, H, HK, D, causal in ((2, 320, 320, 4, 4, 128, True),
                                        (2, 320, 320, 4, 4, 128, False),
                                        (2, 192, 320, 4, 4, 128, True),
                                        (2, 320, 192, 4, 4, 128, True),
                                        (2, 320, 320, 4, 2, 64, True),
                                        (2, 192, 320, 4, 2, 64, False),
                                        (2, 200, 200, 4, 4, 128, True),
                                        (2, 200, 200, 4, 4, 128, False),
                                        (2, 72, 136, 4, 2, 64, True),
                                        (2, 72, 136, 4, 2, 64, False)):
        flash.append(check_flash(torch, F, fa, B, sq, sk, H, HK, D, causal,
                                 seed=22, timed=False))
    for rec in flash:
        print("kernel flash " + json.dumps(rec))
    for rec in flash[:2]:
        print(f"flash {rec['shape']}: " + "; ".join(
            f"{n} {rec[n]['ms']:.4f} ms, {rec[n]['tflops']:.1f} TFLOP/s, "
            f"{rec[n]['bound_share']:.1%} of its bound, "
            f"{rec[n]['vs_sdpa']:.2f}x SDPA's "
            f"{'forward' if n == 'B1' else 'backward (dQ, dK, dV)'}"
            for n in ("B1", "B2", "B3")))
    for name in ("B1", "B2", "B3"):
        results[name] = dict(
            flash[0][name],
            max_abs_err=max(r["kernel_err"][name] for r in flash),
            row_ratio=max(r["kernel_row_ratio"][name] for r in flash))
    fused = [check_fused(torch, F, fk, 16384, 1536, 4096, torch.bfloat16,
                         seed=31, timed=True)]
    for n, h, i, dt in ((4096, 4096, 11008, torch.bfloat16),
                        (1003, 5120, 13824, torch.float32)):
        fused.append(check_fused(torch, F, fk, n, h, i, dt, seed=32,
                                 timed=False))
    for rec in fused:
        print("kernel fused " + json.dumps(rec))
    for name in ("B4a", "B4b", "B5a", "B5b"):
        results[name] = dict(
            fused[0][name],
            max_abs_err=max(r["max_abs_err"][name] for r in fused),
            row_ratio=max(r["row_ratio"][name] for r in fused))
    gc.collect()
    torch.cuda.empty_cache()
    # B6 at the Llama-2-7B prefill shape (its row in the kernel line) and
    # at a ragged GQA shape in f32
    rope = [check_rope(torch, tl, fk, 8, 1024, 32, 32, 128, torch.bfloat16,
                       seed=41, timed=True),
            check_rope(torch, tl, fk, 2, 1003, 32, 8, 64, torch.float32,
                       seed=42, timed=False)]
    for rec in rope:
        print("kernel B6 " + json.dumps(rec))
    results["B6"] = dict(rope[0], max_abs_err=max(r["max_abs_err"]
                                                  for r in rope),
                         row_ratio=max(r["row_ratio"] for r in rope))
    # B8 at the Llama-2-7B decode shape: bf16, int8 with the (B, HK)
    # scales of the decoder's dynamic quantization (its int8 row) and
    # with (HK,) scales; then at the Paddle decoder's own shape (8 equal
    # rows at the middle of its 63 decode steps, 1,056 tokens, in its
    # 17-page table), bf16 and (B, HK) int8
    paged_hm = []
    for scales in ("bf16", "(B, HK)", "(HK,)"):
        r = check_paged_hm(torch, F, fk, scales, seed=51,
                           sweep=scales != "(HK,)")
        torch.cuda.synchronize()
        paged_hm.append(r)
        print("kernel B8 " + json.dumps(r))
    for scales in ("bf16", "(B, HK)"):
        r = check_paged_hm(torch, F, fk, scales, seed=52, lens=(1056,) * 8,
                           pps=17, sweep=True)
        torch.cuda.synchronize()
        paged_hm.append(r)
        print("kernel B8 decoder " + json.dumps(r))
    # B8 where the split rule splits: one Llama-2-7B row of 4,096 tokens
    # (B x HK = 32: 8 splits), and Llama-3-8B's GQA (HK = 8) over the
    # ragged rows (64: 4 splits); the rule's choice must beat one split
    for name, lens, pps, HK in (
            ("single", (4096,), 64, 32),
            ("gqa", (1, 2048, 1537, 700, 1024, 333, 2000, 64), 32, 8)):
        for scales in ("bf16", "(B, HK)"):
            r = check_paged_hm(torch, F, fk, scales, seed=53, lens=lens,
                               pps=pps, HK=HK, sweep=True)
            torch.cuda.synchronize()
            print(f"kernel B8 {name} " + json.dumps(r))
            if not r["ms"] < 0.9 * r["split_ms"][1]:
                fail(f"B8 {name} {scales}: the split rule's choice "
                     f"({r['ms']:.4g} ms) is not 10% faster than one "
                     f"split ({r['split_ms'][1]:.4g} ms)")
            paged_hm.append(r)
    results["B8-bf16"], results["B8-int8"] = paged_hm[0], paged_hm[1]
    gc.collect()
    torch.cuda.empty_cache()
    record["kernels_phase"] = results
    record["paged_decode_phase"] = decode_kernel
    record["dense_kernel_phase"] = dense_kernel
    record["verify_phase"] = verify
    record["gqa_phase"] = gqa
    record["flash_phase"] = flash
    record["fused_phase"] = fused
    record["rope_phase"] = rope
    record["paged_hm_phase"] = paged_hm
    lap("2")

    # ---- phase 3: the engine, at the engine's width and a quarter of
    # its depth (the script's time limit holds every phase but 3d, at
    # 16, at 8 layers)
    cfg = LlamaConfig.llama2_7b(num_layers=args.layers)
    half = LlamaConfig.llama2_7b(num_layers=max(1, args.layers // 2))
    quarter = LlamaConfig.llama2_7b(num_layers=max(1, args.layers // 4))
    t0 = time.perf_counter()
    params = init_params(quarter, torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    torch.cuda.synchronize()
    print(f"params: {quarter.num_layers} layers, hidden "
          f"{quarter.hidden_size}, "
          f"{time.perf_counter() - t0:.1f} s to init")
    reqs = make_requests(args.requests, cfg.vocab_size, args.seed)
    tiers = []
    for kv in (None, "int8"):
        for fused in (False, True):
            rec = run_tier(torch, kernels, gen, ContinuousBatchingEngine,
                           params, quarter, reqs,
                           f"{'int8' if kv else 'bf16'}-"
                           f"{'fused' if fused else 'unfused'}", kv,
                           fused, check_logits=True)
            tiers.append(rec)
            print("tier " + show(rec))
    prof = profile_tier(torch, ContinuousBatchingEngine, params, quarter,
                        reqs)
    print("profile " + json.dumps(prof))
    record["profile"] = prof
    # speculation: n-gram on the same weights and requests, compared
    # with the bf16 fused tier; then the draft tiers on damped weights
    # and non-repetitive prompts, compared with a plain tier on both
    def spec_tier(name, tier_reqs, kv, ref, **spec):
        rec = run_tier(torch, kernels, gen, ContinuousBatchingEngine,
                       params, quarter, tier_reqs, name, kv, **spec)
        if ref is not None:
            rec.update(token_agreement(rec["tokens"], ref["tokens"]))
        print("tier " + show(rec))
        tiers.append(rec)
        return rec

    spec_tier("ngram", reqs, None, tiers[1], spec_k=4)
    draft_layers = max(1, quarter.num_layers // 2)
    damp_draft_tail(params, draft_layers)
    dreqs = make_distinct_requests(args.requests, cfg.vocab_size,
                                   args.seed + 1)
    for kv in (None, "int8"):
        sfx = "-int8" if kv else ""
        plain = spec_tier("plain-damped" + sfx, dreqs, kv, None)
        spec_tier("draft-tree" + sfx, dreqs, kv, plain,
                  draft_layers=draft_layers, spec_tree=(2, 4))
    # the yardstick for those shares: how far the plain tiers' tokens
    # follow each other when only the attention kernel differs (B9
    # against B10 + B11), i.e. how often bf16 splits a near-tie
    record["plain_fused_vs_unfused"] = {
        t0["kv"]: token_agreement(t1["tokens"], t0["tokens"])
        for t0, t1 in ((tiers[0], tiers[1]), (tiers[2], tiers[3]))}
    print("agreement " + json.dumps(record["plain_fused_vs_unfused"]))
    sprof = profile_spec_tier(torch, ContinuousBatchingEngine, params,
                              quarter, dreqs, draft_layers)
    print("profile " + json.dumps(sprof))
    record["profile_spec"] = sprof
    record["tiers"] = tiers
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("3")

    # ---- phase 3e: the SLO scheduler over the engine, sync and overlap,
    # at the engine's width and a quarter of its depth
    sched = run_scheduler(torch, kernels, quarter, args.seed, reqs,
                          record["plain_fused_vs_unfused"])
    record["scheduler"] = sched
    lap("3e")

    # ---- phase 3f: grammar-constrained serving under the scheduler
    constrained = run_constrained(torch, kernels, quarter, args.seed,
                                  reqs)
    record["constrained"] = constrained
    lap("3f")

    # ---- phase 3i: the multi-tenant adapter pool on the engine, under
    # the scheduler, at the engine's width and a quarter of its depth
    adapters = run_adapters(torch, kernels, quarter, args.seed, reqs)
    record["adapters"] = adapters
    lap("3i")

    # ---- phase 3j: the write-ahead log under the supervisor, process
    # deaths and cold restarts, at a quarter of the depth
    wal = run_wal(torch, kernels, quarter, args.seed, reqs)
    record["wal"] = wal
    lap("3j")

    # ---- phase 3k: the serving cluster (routing, handoff, failover,
    # retirement, traffic, a cold restart) at a quarter of the depth
    cluster = run_cluster(torch, kernels, quarter, args.seed, reqs)
    record["cluster"] = cluster
    lap("3k")

    # ---- phase 3g: supervised serving with faults, drain and restore
    supervised = run_supervised(torch, kernels, quarter, args.seed, reqs)
    record["supervised"] = supervised
    lap("3g")

    # ---- phase 3h: the host KV tier (swap, demote / promote, standing
    # store, handoff, defrag) at the engine's width and a quarter of its
    # depth
    hosttier = run_host_tier(torch, kernels, quarter, args.seed, reqs)
    record["host_tier"] = hosttier
    lap("3h")

    # ---- phase 3c: dense generate / beam_search at the same size
    dense = run_dense(torch, np, kernels, tl, gen, quarter, args.seed)
    record["dense"] = dense
    lap("3c")

    # ---- phase 3d: the Paddle fused-op decoder at the same size
    decoder = run_paddle_decoder(torch, np, kernels, IF, tl, gen, half,
                                 args.seed)
    record["paddle_decoder"] = decoder
    lap("3d")

    # ---- phase 3b: training, "xla" then "auto" (fused RMSNorm, SwiGLU)
    train = {}
    for mode in ("xla", "auto"):
        rec, step, state, tokens = run_training(torch, np, kernels, tl, tt,
                                                args, mode)
        print(f"train {mode} " + json.dumps(rec))
        rec["profile"] = profile_train(torch, step, state, tokens,
                                       rec["step_ms_mean"])
        rec["profile"]["clip_and_update_ms"] = update_ms(torch, tt, state)
        print(f"train {mode} profile " + json.dumps(rec["profile"]))
        del step, state, tokens
        gc.collect()
        torch.cuda.empty_cache()
        train[mode] = rec
    for mode in ("xla", "auto"):
        train[mode]["slice_check"] = whole_slice(torch, np, tl, tt, fa, fk,
                                                 args.seed, mode)
        print(f"train {mode} slice "
              + json.dumps(train[mode]["slice_check"]))
    record["train"] = train
    lap("3b")

    # ---- phase 4: the kernel line
    launches = {k: train["xla"]["launches"][k] for k in ("B1", "B2", "B3")}
    launches.update({k: train["auto"]["launches"][k]
                     for k in ("B4a", "B4b", "B5a", "B5b")})
    for rec in (tiers + sched["runs"] + constrained["runs"]
                + adapters["runs"] + wal["runs"] + cluster["runs"]
                + supervised["runs"]
                + hosttier["runs"]
                + dense["tiers"] + decoder["tiers"]):
        kvn = rec["kv"]
        for k, n in rec["launches"].items():
            if n:
                launches[f"{k}-{kvn}"] = launches.get(f"{k}-{kvn}", 0) + n
    launches["B6"] = sum(r["launches"]["B6"] for r in decoder["tiers"])
    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    fused_src = "paddle_tpu_torch/csrc/fused.cu"
    meta = {
        "B1": ("cuda", flash_src,
               "paddle_tpu/ops/pallas/flash_attention.py:184"),
        "B2": ("cuda", flash_src,
               "paddle_tpu/ops/pallas/flash_attention.py:343"),
        "B3": ("cuda", flash_src,
               "paddle_tpu/ops/pallas/flash_attention.py:370"),
        "B4a": ("cuda", fused_src, "paddle_tpu/ops/pallas/fused.py:53"),
        "B4b": ("cuda", fused_src, "paddle_tpu/ops/pallas/fused.py:99"),
        "B5a": ("cuda", fused_src, "paddle_tpu/ops/pallas/fused.py:164"),
        "B5b": ("cuda", fused_src, "paddle_tpu/ops/pallas/fused.py:188"),
        "B6": ("cuda", "paddle_tpu_torch/csrc/rope.cu",
               "paddle_tpu/ops/pallas/fused.py:237"),
        "B7": ("cuda", "paddle_tpu_torch/csrc/paged_split.cuh",
               "paddle_tpu/ops/pallas/fused.py:444"),
        "B8": ("cuda", "paddle_tpu_torch/csrc/paged_split.cuh",
               "paddle_tpu/ops/pallas/fused.py:564"),
        "B9": ("cuda", "paddle_tpu_torch/csrc/paged_split.cuh",
               "paddle_tpu/ops/pallas/paged_attention.py:250"),
        "B10": ("cuda", "paddle_tpu_torch/csrc/paged_split.cuh",
                "paddle_tpu/ops/pallas/serving_fused.py:257"),
        "B11": ("cuda", "paddle_tpu_torch/csrc/flash_chunk.cu",
                "paddle_tpu/ops/pallas/serving_fused.py:548"),
        "B11-tree": ("cuda", "paddle_tpu_torch/csrc/flash_chunk.cu",
                     "paddle_tpu/ops/pallas/serving_fused.py:548"),
    }
    line = []
    for key, r in results.items():
        kname = (key.rsplit("-", 1)[0] if key.endswith(("-bf16", "-int8"))
                 else key)
        route, src, repl = meta[kname]
        n = launches.get(key, 0)
        if n == 0:
            fail(f"{key} was not launched on the main path")
        line.append({"name": key, "route": route, "source": src,
                     "replaces": repl, "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    record["kernel_line"] = line
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": line}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
