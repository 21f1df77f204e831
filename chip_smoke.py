#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits nonzero):

1. Card: the device's name and the ``nvidia-smi`` name/power-limit line;
   build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed).
2. Kernels: each kernel's wrapper against its plain PyTorch version on the
   same CUDA tensors, at qwen3-0.6b's attention widths (H=16, Hkv=8,
   K=128), float32 and bfloat16, at the tolerances of
   tests/test_kernels.py: |kernel - plain| <= tol + tol*|plain| with
   tol 2e-5 (float32) and 2e-2 (bfloat16). The paged kernels are also
   held bitwise to their dense siblings over the gathered view, and must
   ignore NaN in every page (and int8 scale page) no row owns; rows end
   on both sides of the split body's 64-position edges, and the same live
   prefix must give the same bits at horizons 512 and 2048 (dense W,
   paged nblk * bs). The int8
   kernels take int8 K/V quantised by the model's own quantiser, with
   float32 or bfloat16 queries, at the same split edges and horizons,
   over a ring whose live and dead splits alternate, with NaN scales and
   codes of +-127 in every dead slot (of live splits too). Times each
   (CUDA events) beside the plain
   version and ``scaled_dot_product_attention`` (a yardstick the port
   never calls; over the dequantised view for the int8 kernels); the
   prefill kernel, the four decode kernels, MLA decode and sdpa beside
   each, and the SSD scan, also as device time (calls replayed from a
   CUDA graph). The SSD
   scan at mamba2-2.7b's widths (nh=80, hd=64, ds=128, chunk 256):
   S = 512 and 2048, B = 2, a ragged one-chunk prompt, ng = 2, float32
   and bfloat16, |kernel - plain| <= tol * max|plain| (tol 5e-5 and
   2e-2: the kernel cuts the sequence into 64-position tiles where the
   plain version cuts it at ``chunk``) and, wherever 64 divides S,
   element by element within tol abs + tol rel against the plain version
   cut at 64, timed beside the plain version (no PyTorch call computes
   the scan; one ng = 2 case at nh = 80, and S = 2048 timed beside the
   plain version too). The prefill kernel at the other shapes it takes (K
   = 5, 72, 192, 256, Kv = 16 to 256, Hkv = 1, Sq = 1, queries against
   longer and shorter key runs, whose rows that see no key must read 0),
   and bit for bit the suffix's rows over [context | suffix] against the
   whole prompt's at contexts 256 and 272; at MLA's widths (K = 192, Kv
   = 128, H = Hkv = 16), timed beside the plain version and
   ``scaled_dot_product_attention``. The MLA decode kernel at deepseek-v2-lite's widths
   (H = 16, r = 512, dr = 64): the 4-slot main shape, a ragged S = 1000
   with an all-dead row that must read 0 and whose bits must not move
   with NaN in every dead position, rows live to the 64-position splits'
   edges (1, 63, 64, 65, 127, 128, 129, 2048), and the view gathered from
   16-token latent pages, which must ignore NaN in unowned pages; timed
   beside the plain version and ``scaled_dot_product_attention`` over
   [q_lat | q_rope] and [ckv | k_rope]. RMSNorm at every width the
   port's norms see (D = 128, 512, 1024, 2048, 2560, 5120) and those of
   the families still to come (4096 to 7168), 1 / 37 / 4099 rows, the
   MLA latent slice dkv[..., :512] of 576-wide rows read in place, a
   float32 scale under bfloat16 rows, and widths the 16-byte path does
   not take (1020 / 1022, 20000); bit for bit, a row alone, inside 4099
   rows and in a pair launch, the one-element path (a base or scale off
   16 bytes, a row stride of D + 1) against the 16-byte one, and the q/k
   pair (one launch) against two launches; timed at the block norm of a
   512-token qwen3 prefill beside the plain version and
   ``torch.nn.functional.rms_norm`` (a yardstick the port never calls),
   and at a 4-slot decode step's norms beside ``rms_norm`` and the
   launch floor (an empty kernel), all as device time. The prefill and
   decode kernels at the shapes of phase 14's models, in float32 and
   bfloat16, timed in bfloat16 beside the plain version and
   ``scaled_dot_product_attention`` with each shape's bound:
   ``flash_attention`` at gemma3-27b's local prefill (B 1, S 1300, H 32,
   Hkv 16, K 128, window 1024), ``decode_attention`` at G 2, K 128 over
   a 1024-slot ring written past position 1024, and ``decode_attention``
   and ``paged_decode_attention`` at qwen3-8b's 4-row step (G 4, K 128;
   the paged kernel bit for bit the dense one over the gathered view).
   Those of phase 15's models, the same way (the scan within SSD_TOL of
   max|plain|; library_ms ``F.rms_norm`` for the norms, none for the
   scan): ``flash_attention`` at zamba2-7b's shared attention (B 1, S
   512, H = Hkv = 32, K = Kv = 112, causal), ``decode_attention`` and
   ``paged_decode_attention`` at (G, K) = (1, 112) (H 32) and (6, 128)
   (H 48, Hkv 8) over 4 rows live to 48-544 of 2048 (and the int8 pair
   there: paged bit for bit the dense one, NaN in unowned pages and
   dead slots ignored, sdpa over the dequantised view), ``ssd_scan`` at a
   512-token zamba2 prefill (nh 112, hd 64, ds 64, chunk 256) and
   ``rmsnorm`` at (512, 3584 / 6144 / 7168). Those of phase 16's
   whisper-large-v3 (20 heads of 64, G = 1), the same way but timed in
   the dtype the path runs them in: ``flash_attention`` not causal at the
   encoder (B 1, S 1500) and at the cross attention's prefill (B 4, Sq
   64, Skv 1500), both timed in float32 as the frames run, and causal at
   the decoder's self attention prefill (B 3, Sq = Skv 256), timed in
   bfloat16; ``decode_attention`` through ``ops.decode_cross_attention`` over 4
   rows of a wholly valid 1500-row memory, and ``decode_attention`` and
   ``paged_decode_attention`` over a 448-position horizon with rows live
   to 63, 65, 129 and 448, timed in bfloat16.
3. Model: qwen3-0.6b at full width cut to 2 layers, the 2-layer
   mamba2-2.7b-reduced and the 2-layer deepseek-v2-lite-16b-reduced,
   float32, the port's seeded init: prefill + 8 greedy decode steps on
   the card against the same parameters on the CPU plain path.
4. Main path of the dense cache: ``Router(ThreadBackend(n_containers=2))``
   over full-width qwen3-0.6b (28 layers, bfloat16, random weights from a
   seed), n_slots=4, max_len=2048, 8 requests with ragged 16-512 token
   prompts and max_new=32; the prefill and dense decode kernels must
   launch, and rmsnorm a multiple of the 85 launches of a forward (113
   norms, a layer's q and k norms one pair launch; as on every later
   path, with that model's count). Every engine of every phase serves
   its chunks by replaying a CUDA graph of one chunk step captured on its
   first chunk: the warm-up must leave both engines captured, so the
   timed window only replays; reports each engine's capture seconds and
   pool bytes. Then one engine alone: ``graph_vs_eager`` (a replayed
   chunk against ``Model.decode_chunk`` run eagerly on a clone of the
   cache: tokens, emitted counts, every cache leaf's bytes and the launch
   counts equal), and one steady-state chunk under the profiler, which
   must show no kernel launch, one graph launch a step and two copies.
   Reports one 4-slot decode step's host time, launches, device time and
   the decode attention kernels' part of it, with the norms in plain
   tensor code and through the rmsnorm kernel, and the same step
   replayed from a graph: its wall, the launch calls the profiler sees,
   the host µs to enqueue it and the graph's node count.
5. Dense vs paged: one dense and one paged ``ServingEngine`` (block_size
   16, max_seqs = n_slots = 4, so both decode the same rows) serve the
   same same-bucket request groups; their greedy streams must be
   identical. Each engine then passes ``graph_vs_eager`` on one more
   group (as in 7a and 9b).
6. Main path of the paged cache with prefix sharing:
   ``Router(ThreadBackend(2))`` over paged engines (block_size 16,
   max_seqs 8, the dense footprint of 512 blocks, prefix_cache=True);
   16 requests of a 256-token shared prompt + 16-256-token tail,
   max_new=32, in two waves (2, then 14). Every request completes; wave 2
   hits the prefix; some container has more than n_slots requests in
   flight; the paged and prefill kernels launch, the dense decode kernel
   does not. One engine passes ``graph_vs_eager`` on wave 2's prompts
   again (admissions that hit the shared pages). Wave 2 is also served
   without sharing on one engine and its token agreement printed
   (reported, not checked: other batch shapes).
   c. The sharing gate in the form of JAX's ``_serve_phases``: one paged
      engine with sharing and one without, same block budget, each
      through phase 6's two waves in turn, draining between them. The
      greedy streams and every request's prefill logits must be
      identical bit for bit, and wave 2 must hit the shared prompt (a
      difference fails with a bisect: the prefill kernel over [context |
      suffix] against the whole prompt, one projection at the two modes'
      row counts). The prefill projections on the card of a model that
      can share run in fixed ROW_SLICE-row slices (``models/layers.py``,
      ``Model.prefill``'s ``row_invariant``), so a row's bits do not move
      with its batch (what that costs phases 4 and 6c against another
      checkout: ``scripts/prefill_turns.py``). Then the same gate in
      float32 at full width
      (the same seed's weights in float32, phase 6's whole two waves, 16
      requests): streams and prefill logits must agree bit for bit too.
7. The int8 KV cache (``kv_cache_dtype="int8"``), same weights:
   a. dense vs paged as in phase 5, on int8 caches: identical greedy
      streams, through the two int8 decode kernels only;
   b. ``Router(ThreadBackend(2))`` over paged int8 engines as in phase 6
      (prefix_cache=True, which an int8 cache ignores) serving phase 6's
      14 wave-2 requests: each completes with max_new tokens and no hit
      tokens; the paged int8 kernel launches, no bfloat16 decode kernel
      does. Reports the KV pool's bytes against phase 6's bfloat16 pool
      and the greedy tokens that agree with phase 6 (not checked).
8. The SSM family: ``Router(ThreadBackend(2))`` over full-width
   mamba2-2.7b (64 layers, bfloat16, random weights from a seed),
   n_slots=4, max_len=2048, 8 requests with 64-1024-token prompts,
   max_new=32, each prompt prefilled unpadded through the CUDA SSD scan.
   Every request completes; one request's stream equals that request run
   alone on the model; the scan launches once per layer per prefill; no
   attention kernel launches; one engine passes ``graph_vs_eager`` over
   its state rows. Reports wall, tok/s, ttfc p50, the state
   cache's bytes, and one decode step's host time, kernel launches and
   device time with the norms in plain tensor code and through the
   rmsnorm kernel, in turns.
   b. The paged cache over mamba2's state rows, same weights: one dense
      (n_slots 4) and one paged engine (block_size 16, max_seqs 8) over
      phase 5's groups at lengths the scan's chunk divides; the tree has
      no paged group (the rows stay dense, sized by max_seqs) and the
      block budget bounds admission. Identical greedy streams, the paged
      engine's ``peak_active`` above the dense engine's slots,
      ``graph_vs_eager`` on both; reports the SSM row bytes a sequence.
9. The MoE family with latent attention: ``Router(ThreadBackend(2))``
   over full-width deepseek-v2-lite-16b (27 layers, MLA, 64 routed
   experts top-6 + 2 shared, bfloat16, random weights from a seed, one
   copy for both engines), dense latent cache, n_slots=4, max_len=2048,
   phase 4's 8 requests. Every request completes; the MLA decode and the
   prefill kernel launch a multiple of 27 times, no other kernel does;
   the one request alone in its prefill bucket equals that request run
   alone at the engine's shapes (expert drops depend on the batch).
   Reports wall, tok/s, ttfc p50, the latent cache's bytes and one
   decode step's host time and launches.
   b. Dense vs paged latent caches as in phase 5, same weights: identical
      greedy streams, the MLA decode kernel launching in both engines.

10. Process containers on phase 4's model and requests: 2 threaded
    containers, the same 2 polled in turn, ``Router(ProcessBackend(2))``
    and ``ProcessBackend(1)`` (one pinned process each, the weights
    shared with the children over CUDA IPC). The 2 process containers'
    greedy streams must equal the threaded ones; each child must launch
    the prefill, dense decode and rmsnorm kernels, hold less device
    memory after taking the weights than their bytes, and have imported
    torch only after pinning itself; a kill fault in container 1 after 2
    steps must give a ContainerFailure, RetryEvents, a respawn and the
    fault-free streams; no child outlives the phase. Reports wall, tok/s
    and ttfc p50 of the four, each child's step-graph capture seconds and
    pool bytes (the respawned child's once it has served), and whether
    an MPS control daemon runs.

11. The request contract of the fixed-count path on phase 4's model
    (bf16, n_slots=4, max_len=2048, chunk_tokens=32):
    a. Sampling inside the step graph: ``Router(ThreadBackend(2))`` with
       ``greedy=False, seed=7`` serves 8 requests, each complete; the
       same seed again gives identical streams, seed 8 differs; one
       sampling engine passes ``graph_vs_eager`` (its random stream's
       state cloned; the state after the chunk equal too), and two
       consecutive replays from one slot state sample other tokens while
       the restored stream state gives the first tokens again; a
       per-token engine (``chunked=False``) with the same seed gives the
       chunked engine's sampled streams; the sampler alone, one 16-way
       row repeated 20,000 times in one call, passes chi-square against
       ``softmax`` at p > 1e-3. Reports a 4-row step's replayed device
       time greedy against sampling, in turns, and the sampler's alone.
    b. The per-token baseline, greedy, on one engine: its streams equal
       the chunked engine's; reports wall, tok/s, host reads and kernel
       launches of both.
    c. Deadlines and shedding: ``request_deadline_s=1e-4`` over a paged
       engine fails with kind ``"deadline"``, then an undeadlined request
       completes and every block is back in the pool; ``deadline_s=0.35``
       with max_new=500 fails ``"mid-decode"`` and frees its slot;
       ``max_queue=4`` over 8 submissions gives 4 ``RejectedEvent``s with
       ``retry_after_s`` 0.25 and 4 completions; one capture an engine.
    d. ``ThreadBackend`` supervision: after one warm-up step an engine,
       an ``"error"`` fault in container 1 two steps into phase 10's
       requests gives one ``ContainerFailure(kind="error")``,
       ``RetryEvent``s and a rebuilt engine that captures its own graph,
       with the fault-free streams; ``memory_allocated`` must fall by
       the dead engine's dense cache between the failure and the new
       engine's build, and rise by less than half of it over the run; a
       fault in
       every incarnation trips the breaker and the Router serves on
       container 0 alone. Reports the rebuild's seconds and memory.

12. The online container-count loop on phase 4's model (bf16, n_slots=4,
    max_len=2048, chunk_tokens=32, one request a prefill so a request's
    bits do not depend on its container or batch). Each count's backend
    or pool serves a warm-up request a container first.
    a. ``Router(backend_factory=n -> ThreadBackend(n), feasible_counts=
       card_feasible_counts(..., max_containers=4), window=8,
       epsilon=0.0, objective="energy")`` serves 6 windows of phase 4's
       traffic, drained window by window; per window n, wall,
       ``EnergyProxy`` J, the card's measured J (mean ``nvidia-smi
       power.draw`` sampled every 100 ms by a helper thread, times the
       wall; read and printed only), tok/s and ttfc p50/p95; then the
       scheduler's ``summary()`` and ``choice``. Gates: the bootstrap
       visits every feasible count, each count's backend is built once,
       and every request's greedy tokens equal a fixed
       ``Router(ThreadBackend(1))``'s.
    b. ``AdaptiveServingPool`` (threads) over the same traffic as 6
       waves: the same tokens; its history printed.
    c. One wave through ``ProcessContainerPool(2)`` against
       ``ContainerServingPool(2)``: identical ordered completions; both
       walls and proxy energies printed. No child outlives the phase.

13. Trace replay under SLO classes on phase 4's model (bf16, n_slots=4,
    max_len=2048, chunk_tokens=32, one request a prefill): the first 96
    arrivals of the ``diurnal-bursty`` preset (seed 1), replayed
    open-loop by ``workload.replay`` at time_scale 10, prompts over the
    full vocabulary, classes ``interactive:0.5,batch:8.0``.
    a. ``Router(ThreadBackend(2), slo=..., tenant_quota=8,
       max_queue=32)``, the backend's submit logged beside the Router's
       live backlog. Gates: every request ends in exactly one terminal
       event; done + shed + failed = 96; each dispatch takes the lowest
       (rank, arrival) of the live backlog; every ``RejectedEvent`` has a
       kind in {queue, slo, tenant} and a class of the spec; every
       completed request's greedy tokens equal a plain fixed
       ``Router(ThreadBackend(2))``'s, fed one request at a time.
    b. The adaptive Router over ``card_feasible_counts`` (at most 4),
       ``objective="energy_under_slo"``, window 16, window_s 5, beside the
       same trace through the SLO-blind adaptive Router
       (``objective="energy"``): per window n, wall, proxy J, the card's
       J (phase 12's sampler) and ``per_class``; each report's goodput,
       per-class p95 and attainment, counts visited and final n. Gates:
       both account for all 96; the SLO run's ``per_class`` names spec
       classes only.
    c. ``python -m repro_torch.launch.serve --arch qwen3-0.6b --trace
       bursty --time-scale 10 --priority-classes interactive:0.5,batch:8.0
       --tenant-quota 8 --containers 2 --cache paged --prefix-cache`` as a
       subprocess with a timeout: exit 0, its report line parsed and
       adding up, and its own kernel launches (flash, paged decode,
       rmsnorm) nonzero.

14. The gemma family and the 8B dense configs at full width (bf16,
    random weights from seed 0, n_slots=4, max_len=2048, chunk_tokens=32;
    each model freed before the next, ``memory_allocated`` printed):
    a. qwen3-8b (36 layers, d 4096, 32/8 heads, K 128) and llama3.1-8b
       (32 layers): phase 4's 8 requests through
       ``Router(ThreadBackend(2))`` (every request completes; the prefill
       and dense decode kernels a multiple of the layers), phase 5's
       dense-vs-paged streams identical with ``graph_vs_eager`` on both
       engines, and a 4-row decode step replayed from a graph beside its
       bound (weights and live K/V read once).
    b. gemma3-27b (62 layers: 10 super-blocks of 5 local layers over a
       1024-slot ring and 1 global, then 2 local; d 5376, 32/16 heads, K
       128, vocab 262 144; 56.8 GB), its engines built directly (two dense
       caches beside the weights exceed ``card_feasible_counts``' 0.65
       share): 8 requests of 64, 500, 1000, 1020, 1030, 1300, 1700 and
       1900 tokens (rings that wrap in prefill, in decode, or never),
       max_new=32, through ``Router(ThreadBackend(2))`` over dense
       engines, then one dense engine, then one paged engine
       (``prefix_cache=True``, max_seqs 4: dense rings beside 10 paged
       global layers); identical greedy streams, 0 hit tokens, the paged
       kernel on the global layers only; ``graph_vs_eager`` on both
       engines; a 4-row decode step replayed beside its bound.
    c. reduced gemma (2 super-blocks and a remainder layer, a 16-slot
       ring) in float32: a 40-token prefill and 40 decode steps on the
       card against the CPU within 1e-3, the rings wrapping in both.
    Prints the phase's time.

15. The hybrid family, the vision prefix and mixtral at full width (bf16,
    random weights from seed 0, chunk_tokens=32; each model freed before
    the next; each prints a 4-row decode step replayed from a graph
    beside its bytes bound at 3.35 TB/s):
    a. zamba2-7b, not cut (81 Mamba2 layers, 13 super-blocks of 6 each
       followed by the one weight-shared attention + MLP block, then 3;
       d 3584, 32 heads of 112, SSD 112 heads of 64, state 64; 13.5 GB),
       n_slots=4, max_len=2048: phase 8's 8 requests of 64-1024 tokens
       (lengths the scan's chunk divides) through
       ``Router(ThreadBackend(2))`` (flash, dense decode and the scan a
       multiple of their layers), then phase 8b's groups through a dense
       and a paged engine (13 paged groups beside 81 dense SSM rows):
       identical streams, ``graph_vs_eager`` on both, the paged kernel,
       the scan, flash and rmsnorm launching in the paged engine.
    b. internvl2-26b, not cut (48 layers, d 6144, 48/8 heads of 128, G 6;
       a 3200 -> 6144 -> 6144 image projection; 39.8 GB): 8 requests of
       16-512 tokens, each behind 256 random patch embeddings, through
       ``Router(ThreadBackend(2))`` (``card_feasible_counts`` printed;
       two engines either way); then 4 requests behind one image and one
       256-token system prompt, in phases of 1 and 3, through a dense
       engine, a paged engine with ``prefix_cache`` (the second phase must
       hit) and one without: identical streams.
    c. mixtral-8x22b at full width cut to 8 of its 56 layers (8 experts
       top-2, d_ff 16384, G 6, window 4096; 40.9 GB, the whole model
       281 GB, more than the card): max_len 8192, prompts of 64-1024
       tokens, 4200 and 5000 (rings that wrap in prefill) and 4080 (its
       ring wraps in decode), max_new 32, through
       ``Router(ThreadBackend(2))``, one dense and one paged engine
       (``prefix_cache``; every ring stays dense rows): identical streams.
    d. reduced zamba2, internvl2 (8 image positions) and mixtral in
       float32: prefill and decode steps on the card against the CPU
       within 1e-3.
    e. each of a-c's models on its own weights over int8 caches (G, K =
       1, 112 and 6, 128): a dense and a paged engine (max_len 2048, every
       full-horizon group paged) serve 8 prompts of 33-256 tokens (behind
       images for internvl2), max_new 24, with identical greedy streams,
       the dense and paged int8 kernels launching and no bf16 decode
       kernel; ``graph_vs_eager`` on both; then the three reduced models
       over int8 caches, as registered and at the new head shapes, on the
       card against the CPU within 1e-3.
    Prints the phase's time.

16. Whisper, the audio encoder-decoder, at full width and not cut
    (arXiv:2212.04356; 32 encoder and 32 decoder layers, d 1280, 20 heads
    of 64, d_ff 5120, vocab 51 866, 1500 frames; bf16, random weights
    from seed 0, 3.07 GB), n_slots=4, max_len 448 (its decoder context),
    chunk_tokens=32; each request carries its own 1500 x 1280 float32
    frames (0.1 x N(0, 1) seeded by its id), which the encoder runs in
    float32 against the bf16 weights, as JAX promotes them:
    a. 8 requests of 4-224 decoder tokens, max_new 32, through
       ``Router(ThreadBackend(2))`` over dense engines (flash and dense
       decode a multiple of the 32 layers, no rmsnorm: whisper's norms
       are layernorms), then one dense and one paged engine (block 16,
       max_seqs 4, ``prefix_cache``: its positions shut the gate, 0 hit
       tokens): identical greedy streams; ``graph_vs_eager`` on both
       engines; each engine's prefills (rows, width, wall, the encoder's
       share) and launches; a per-token engine on 2 requests equal to
       the chunked streams; a 4-row decode step replayed over each cache
       beside its bytes bound (the decoder's weights without the cross
       attention's wk/wv, the memory rows and live self K/V).
    b. reduced whisper (2 encoder and 2 decoder layers, 16 frames) in
       float32: prefill and 8 decode steps on the card against the CPU
       within 1e-3.
    Prints the phase's time.

17. The paper's video-detection testbed (``core.testbed.run_split``):
    ``VideoRequestStream``'s 900 frames (30 s at 30 fps) through the
    YOLOv4-tiny-shaped detector (float32, TF32 off in every container),
    batch 8, split among 1, 2, 4 and 8 containers pinned to disjoint
    core sets of the host, every container on the one card: per count
    the wall, per-container seconds, the activity model's W and J, the
    card's J (power.draw; read only), t/t1, E/E1 and max |out - out_1|
    (<= 1e-5); the fitted time and energy models and the scheduler's
    pick; n = 1's first 16 outputs against the detector on the CPU
    within 1e-3; no child left.

18. Training (``training_phase``), float32 in 18a-18e, bfloat16 in 18f
    and 18g: 18a full-width qwen3-0.6b
    (random weights from seed 0), one forward and backward at batch 1,
    seq 64 on the card and on this machine's CPU: loss within 1e-5
    relative, global grad norm within 1e-4, every attention's forward and
    backward and every norm's backward a kernel launch; 18b
    ``launch.train`` over 20 steps at batch 8, seq 512, lr 1e-3, warmup
    10: a finite, falling loss, 28 forward and 28 backward flash launches
    a step and as many ``rmsnorm_bwd`` as ``rmsnorm`` launches, step ms,
    tokens/s, the model's share of the f32 peak and the peak memory; 18c
    reduced deepseek-v2-lite (MLA + MoE + aux loss), gemma3-27b (window),
    whisper-large-v3, mamba2-2.7b and zamba2-7b (the SSD scan forward
    and backward a kernel each a layer, zamba's attention at each
    application of its shared block), 3 steps at lr 1e-3 on the card
    against the CPU (first gradients within 1e-4 of max|CPU leaf|, each
    parameter leaf's difference within 3e-2 of its own move, L2 over the
    leaf); 18d ``make_train_step`` accepts float32 mamba2 and zamba and
    refuses them in bfloat16, naming ``ssd_scan_bwd``, and accepts
    bfloat16 qwen3, gemma3, deepseek, whisper and internvl2 (reduced);
    18e ``launch.train`` over full-width
    mamba2-2.7b in float32, 10 steps at batch 2, seq 512, lr 1e-3: a
    finite, falling loss, 64 ``ssd_scan`` and 64 ``ssd_scan_bwd``
    launches a step, step ms, tokens/s, the model's share of the f32
    peak and the peak memory; 18f full-width qwen3-0.6b in bfloat16
    (``Model.init(seed=0, dtype=torch.bfloat16)``) through
    ``train.loop.train``, 20 steps at batch 8, seq 512, lr 1e-3, warmup
    10: a finite, falling loss, 28 forward and 28 backward flash launches
    a step and as many ``rmsnorm_bwd`` as ``rmsnorm`` launches, step ms
    beside 18b's, tokens/s, the model's share of the bf16 peak (989
    TFLOP/s) and the peak memory; 18g reduced deepseek, gemma3, whisper
    and internvl2 in bfloat16 as 18c, card against CPU: first gradients
    within 5e-2 of max|CPU leaf|, the 3 steps' losses within 1e-3
    relative, the parameters' drift printed, not held. Phase 2 holds the
    three backward kernels against their plain versions at qwen3's training
    batch (B 8, S 512), gemma's local window (S 1300, window 1024),
    MLA's K 192 / Kv 128, whisper's encoder (S 1500, not causal) and a
    ragged S 40 with softcap 5, and ``rmsnorm_bwd`` at (4096, 1024) and
    the q/k pair at (65536, 128) / (32768, 128), within 5e-5 abs + rel
    against max|plain|, bit for bit from run to run, the forward's out
    bit for bit with its lse pointer set and null, the pair's dx and
    dscale bit for bit those of each tensor's own call; timed beside
    their bounds, plain versions and sdpa / ``F.rms_norm`` backward
    through autograd (``F.rms_norm``'s also replayed from a graph); the
    bfloat16 bodies of ``flash_attention_bwd`` and ``rmsnorm_bwd`` at the
    same shapes (the bf16 forward's out bit for bit with its lse pointer
    set and null, its lse within 5e-5; the gradients within 2e-2 of
    max|plain|, bit for bit from run to run, the pair's bit for bit each
    tensor's own call), timed likewise beside their bf16 bounds and the
    library's bf16 backward (with the bf16 forward with its lse); and
    ``ssd_scan_bwd`` at mamba2-2.7b's training widths (B 2, S 512, nh
    80, hd 64, ds 128), zamba2-7b's (nh 112, ds 64) and a ragged S 96
    (ng 2, hd 16, ds 24, chunk 32, its last 64-position cut padded), each
    with and without a gradient of the final state: within 5e-5 abs +
    rel of max|plain| element by element at the kernel's own 64-position
    cut, within 1e-4 of max|plain| at the caller's chunk (256, 32), bit
    for bit from run to run, and once against torch autograd through the
    plain forward; timed at 18e's call beside its bound and the plain
    version (no PyTorch call computes the scan), with the float32
    forward at the same shape; both with the CUDA kernels one call
    launches (3 forward, 5 backward, else the phase fails) and the
    scratch it allocates, read with ``torch.profiler`` and the peak of
    ``memory_allocated``, as the bfloat16 main shape's.

19. The H100 cost model (``cost_model_phase``), on phase 4's model and
    weights (qwen3-0.6b, bf16, n_slots 4, max_len 2048): 19a the wall of
    one steady-state ``ServingEngine.step`` at chunks of 1, 2, 4, 8, 16
    and 32 steps (in rounds, the median of 7 after 2), fitted as a + b n:
    ``core/roofline.DISPATCH_OVERHEAD_S`` must be within 2x of this run's
    a; 19b ``decode_chunk_tokens`` of every registry config at 4 rows,
    dense and paged over 2048 positions, and ``chunk_for`` at n = 1, 2, 4
    with and without a 0.5 s SLO; 19c phase 4's 8 requests through
    ``Router(ThreadBackend(2))`` with the default ``EngineConfig`` (the
    cost model's chunk) and with chunk 32: identical greedy completions,
    wall, ttfc p50, tok/s, host reads and chunks of each; 19d the
    synchronizing calls of 5 steady-state steps of a dense greedy, a dense
    sampling and a paged engine under ``torch.cuda.set_sync_debug_mode``:
    one a chunk, the static host-sync allowance (and a pageable against
    a pinned copy in); 19e ``examples/torch_serve_requests.py`` at full
    width, its completions identical at 1, 2 and 4 containers.

Then a JSON line with each kernel's launches (from the phase of the path
it serves, and by phase, phase 13's three parts and phases 14's, 15's,
16's, 18f's and 19c among them), error and times (eleven kernels: the
eight TPU kernels' and the three backward kernels, from phases 18b and
18e; the bf16 bodies' under "bf16" in their rows), the card's
``nvidia-smi`` line, and the result line ``{"ok": true, "device":
{...}}``.

It needs the checkout's ``src/`` and a CUDA device; without either it
exits nonzero before printing any result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import time

# numpy and torch are imported in main(): phase 10's children are spawned,
# and spawn re-imports this script in each child before the child pins
# itself to its cores, so nothing heavy may load at module scope
np = torch = None

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: dense peaks at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 outside tensor cores
# the float32 flash bodies run every product as three TF32 products (split
# hi / lo): their operations are bounded at a third of the dense TF32 rate
SPLIT_TF32_FLOPS = 494.7e12 / 3
PEAK_BYTES_S = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H, HKV, K = 16, 8, 128
# live depths of the 8 decode rows at the paged main-path shape
PAGED_MAIN_LENGTHS = [280, 300, 330, 360, 400, 440, 480, 520]


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, reps: int = 100, stream=None) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph
    and replayed, so the host's launch rate does not pace a call that is
    shorter than its own Python overhead. ``stream``: warm up and capture
    on it (an autograd backward runs on its forward's stream, so a
    backward is captured on the stream its forward ran on)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def check_close(got, want, dtype_name: str, what: str) -> float:
    tol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: kernel output is not finite")
    err = (g - w).abs()
    if bool((err > tol + tol * w.abs()).any()):
        fail(f"{what}: max abs error {float(err.max()):.3e} over "
             f"tolerance {tol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def prefill_bound(B, Sq, Skv, mask, dtype_name, itemsize):
    pairs = int(mask.sum())
    flops = 2 * B * H * pairs * K * 2            # QK^T and PV
    nbytes = (2 * B * Sq * H * K + 2 * B * Skv * HKV * K) * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def decode_bound(B, W, valid, dtype_name, itemsize, row_bytes=None):
    """Each live key and value row once (``row_bytes`` each: K * itemsize,
    or K + 4 for int8 codes and their scale), q/out and the mask once."""
    live = int(valid.sum())
    row = K * itemsize if row_bytes is None else row_bytes
    nbytes = 2 * live * HKV * row + 2 * B * H * K * itemsize + B * W
    flops = 2 * 2 * live * H * K
    if row_bytes is not None:
        flops += 2 * live * HKV * K              # the dequantising multiplies
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_bound(B, nblk, lengths, dtype_name, itemsize, row_bytes=None):
    """Each live key and value row once, the table and q/out once."""
    live = int(lengths.sum())
    row = K * itemsize if row_bytes is None else row_bytes
    nbytes = (2 * live * HKV * row + 2 * B * H * K * itemsize
              + B * nblk * 4)
    flops = 2 * 2 * live * H * K
    if row_bytes is not None:
        flops += 2 * live * HKV * K
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_case(gen, lengths, *, h, hkv, k, bs, nblk, dtype, share=0):
    """q, a page pool and a block table for rows of ``lengths``: each row
    owns ceil(len / bs) pages drawn at random from a pool twice the
    needed size (so its pages sit between other rows' and unowned ones),
    the rest of its table points at the scratch page (the pool's last),
    and with ``share`` row 1 maps its first ``share`` blocks onto row 0's
    pages, as a prefix hit does. Returns the tensors and the bool mask of
    pages no row owns (scratch included)."""
    dev = torch.device("cuda")
    B = len(lengths)
    n_pages = 2 * B * nblk
    q = torch.randn(B, h, k, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages + 1, bs, hkv, k, generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn(n_pages + 1, bs, hkv, k, generator=gen,
                     device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    table = perm[:B * nblk].reshape(B, nblk).to(torch.int32)
    owned = torch.arange(nblk, device=dev)[None, :] < (
        (torch.tensor(lengths, device=dev)[:, None] + bs - 1) // bs)
    table[~owned] = n_pages
    if share:
        table[1, :share] = table[0, :share]
    unowned = torch.ones(n_pages + 1, dtype=torch.bool, device=dev)
    unowned[table[owned].long()] = False
    return (q, kp, vp, table.contiguous(),
            torch.tensor(lengths, dtype=torch.int32, device=dev), unowned)


def gathered(kp, vp, table, lengths):
    """The dense (B, nblk*bs, Hkv, K) view of a paged cache, and its
    valid mask ``arange < lengths``."""
    B, nblk = table.shape
    W = nblk * kp.shape[1]
    k = kp[table.long()].reshape(B, W, *kp.shape[2:]).contiguous()
    v = vp[table.long()].reshape(B, W, *vp.shape[2:]).contiguous()
    valid = torch.arange(W, device=kp.device)[None, :] < lengths[:, None]
    return k, v, valid


def paged_checks(gen):
    """The paged kernel against its plain version; bitwise against the
    dense kernel over the gathered view; unchanged (and finite) with every
    unowned page and the scratch page filled with NaN. Rows end around
    the split body's split edges too. Then the same live prefix at
    horizons 512 and 2048 (dense W, paged nblk * bs) gives the same bits."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    # (lengths, H, Hkv, K, bs, nblk, softcap, share)
    cases = [([48, 160, 300, 544], H, HKV, K, 16, 128, 0.0, 0),
             ([700, 33, 0, 2048, 17, 1, 1024, 255], H, HKV, K, 16, 128,
              0.0, 2),
             ([48, 160, 300, 544], H, HKV, K, 16, 128, 30.0, 0),
             ([90, 7, 500], 8, 8, 64, 16, 32, 0.0, 0),      # G = 1
             ([90, 7, 500], 16, 4, 64, 16, 32, 0.0, 0),     # G = 4
             ([90, 250, 500], 16, 2, 64, 16, 32, 0.0, 2),   # G = 8
             # rows ending at a 64-position split's edges, both sides
             ([63, 64, 65, 0, 2048, 127, 128, 129], H, HKV, K, 16, 128,
              0.0, 0),
             ([300, 64, 129], 8, 8, 256, 16, 32, 30.0, 0),  # G = 1, K = 256
             ([300, 64, 129], 16, 2, 32, 16, 32, 30.0, 0)]  # G = 8, K = 32
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for lengths, h, hkv, k, bs, nblk, softcap, share in cases:
            q, kp, vp, table, lens, unowned = paged_case(
                gen, lengths, h=h, hkv=hkv, k=k, bs=bs, nblk=nblk,
                dtype=dtype, share=share)
            what = (f"paged_decode_attention {dn} lengths={lengths} H={h} "
                    f"Hkv={hkv} K={k} bs={bs} nblk={nblk} softcap={softcap}")
            got = pa.paged_decode_attention(q, kp, vp, table, lens,
                                            softcap=softcap)
            torch.cuda.synchronize()
            want = ref.paged_decode_attention(q, kp, vp, table, lens,
                                              softcap=softcap)
            err = check_close(got, want, dn, what)
            for b, n in enumerate(lengths):
                if n == 0 and bool(got[b].ne(0).any()):
                    fail(f"{what}: length-0 row {b} is not 0")
            kd, vd, valid = gathered(kp, vp, table, lens)
            dense = da.decode_attention(q, kd, vd, valid, softcap=softcap)
            if not torch.equal(got, dense):
                fail(f"{what}: not bitwise equal to decode_attention over "
                     f"the gathered view (max diff "
                     f"{float((got.float() - dense.float()).abs().max()):.3e})")
            kp[unowned] = float("nan")
            vp[unowned] = float("nan")
            poisoned = pa.paged_decode_attention(q, kp, vp, table, lens,
                                                 softcap=softcap)
            if not (torch.equal(poisoned, got)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"{what}: output moved with NaN in unowned pages")
            print(f"{what}: max_abs_err={err:.3e}, bitwise equal to the "
                  "dense kernel, NaN unowned pages ignored", flush=True)
        lengths = [48, 160, 300, 512, 0]
        q, kp, vp, table, lens, _ = paged_case(
            gen, lengths, h=H, hkv=HKV, k=K, bs=16, nblk=128, dtype=dtype)
        kd, vd, valid = gathered(kp, vp, table, lens)
        outs = [pa.paged_decode_attention(q, kp, vp, table, lens),
                pa.paged_decode_attention(q, kp, vp,
                                          table[:, :32].contiguous(), lens),
                da.decode_attention(q, kd, vd, valid),
                da.decode_attention(q, kd[:, :512].contiguous(),
                                    vd[:, :512].contiguous(),
                                    valid[:, :512].contiguous())]
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            fail(f"decode {dn}: the live prefix {lengths} gives other bits "
                 "at horizon 512 than at 2048")
        print(f"decode {dn} live {lengths}: paged nblk 128 / 32 and dense W "
              "2048 / 512 bit for bit", flush=True)


def quant(x):
    """int8 codes and float32 scales of x, by the model's quantiser."""
    from repro_torch.models.attention import _quant_kv
    return _quant_kv(x)


def int8_checks(gen):
    """The int8 kernels against their plain versions (f32 and bf16 q); the
    paged one bitwise against the dense one over the gathered view, a
    length-0 row 0, and unchanged with NaN in every unowned page, scale
    page and the scratch page (and NaN scales with codes of +-127 in dense
    slots no row reads, the dead slots of live splits included); rows end
    on both sides of the 64-position split edges, and the same live
    prefix gives the same bits at horizons 512 and 2048."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # (B, W, softcap, scattered): scattered rings leave every other
        # 64-position split without a live slot
        for B, W, softcap, scattered in ((4, 2048, 0.0, False),
                                         (3, 300, 30.0, False),
                                         (3, 1000, 0.0, True)):
            q = torch.randn(B, H, K, generator=gen, device=dev).to(dtype)
            kq, ks = quant(torch.randn(B, W, HKV, K, generator=gen,
                                       device=dev))
            vq, vs = quant(torch.randn(B, W, HKV, K, generator=gen,
                                       device=dev))
            valid = torch.rand(B, W, generator=gen, device=dev) < (
                0.3 if scattered else 0.7)
            if scattered:
                valid &= (torch.arange(W, device=dev) // 64 % 2 == 0)[None]
            valid[-1] = False                    # a row with no live slot
            what = (f"decode_attention_int8 {dn} B={B} W={W} "
                    f"softcap={softcap} scattered={scattered}")
            got = da.decode_attention_int8(q, kq, vq, valid, ks, vs,
                                           softcap=softcap)
            torch.cuda.synchronize()
            err = check_close(got, ref.decode_attention(
                q, kq, vq, valid, softcap=softcap, k_scale=ks, v_scale=vs),
                dn, what)
            if bool(got[-1].ne(0).any()):
                fail(f"{what}: all-invalid row is not 0")
            ks[~valid], vs[~valid] = float("nan"), float("nan")
            kq[~valid], vq[~valid] = 127, -127
            poisoned = da.decode_attention_int8(q, kq, vq, valid, ks, vs,
                                                softcap=softcap)
            if not (torch.equal(got, poisoned)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"{what}: output moved with NaN scales in dead slots")
            print(f"{what}: max_abs_err={err:.3e}, dead slots' NaN scales "
                  "ignored", flush=True)
        # (lengths, softcap, share): the main-path shape, the phase-2
        # scattered/shared tables with a length-0 row, softcap, and rows
        # ending at a 64-position split's edges, both sides
        for lengths, softcap, share in (
                (PAGED_MAIN_LENGTHS, 0.0, 0),
                ([700, 33, 0, 2048, 17, 1, 1024, 255], 0.0, 2),
                ([48, 160, 300, 544], 30.0, 0),
                ([63, 64, 65, 0, 2048, 127, 128, 129], 0.0, 0),
                ([1, 2047, 191, 192, 193], 30.0, 0)):
            q, kp, vp, table, lens, unowned = paged_case(
                gen, lengths, h=H, hkv=HKV, k=K, bs=16, nblk=128,
                dtype=torch.float32, share=share)
            q = q.to(dtype)
            kq, ks = quant(kp)
            vq, vs = quant(vp)
            what = (f"paged_decode_attention_int8 {dn} lengths={lengths} "
                    f"softcap={softcap}")
            got = pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table,
                                                 lens, softcap=softcap)
            torch.cuda.synchronize()
            err = check_close(got, ref.paged_decode_attention(
                q, kq, vq, table, lens, softcap=softcap, k_scale_pages=ks,
                v_scale_pages=vs), dn, what)
            for b, n in enumerate(lengths):
                if n == 0 and bool(got[b].ne(0).any()):
                    fail(f"{what}: length-0 row {b} is not 0")
            kd, vd, valid = gathered(kq, vq, table, lens)
            ksd, vsd, _ = gathered(ks, vs, table, lens)
            dense = da.decode_attention_int8(q, kd, vd, valid, ksd, vsd,
                                             softcap=softcap)
            if not torch.equal(got, dense):
                fail(f"{what}: not bitwise equal to decode_attention_int8 "
                     f"over the gathered view (max diff "
                     f"{float((got.float() - dense.float()).abs().max()):.3e})")
            ks[unowned], vs[unowned] = float("nan"), float("nan")
            kq[unowned], vq[unowned] = 127, -127
            poisoned = pa.paged_decode_attention_int8(
                q, kq, vq, ks, vs, table, lens, softcap=softcap)
            if not (torch.equal(poisoned, got)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"{what}: output moved with NaN in unowned pages or "
                     "scale pages")
            print(f"{what}: max_abs_err={err:.3e}, bitwise equal to the "
                  "dense int8 kernel, NaN unowned pages and scale pages "
                  "ignored", flush=True)
        lengths = [48, 160, 300, 512, 0]
        q, kp, vp, table, lens, _ = paged_case(
            gen, lengths, h=H, hkv=HKV, k=K, bs=16, nblk=128,
            dtype=torch.float32)
        q = q.to(dtype)
        kq, ks = quant(kp)
        vq, vs = quant(vp)
        kd, vd, valid = gathered(kq, vq, table, lens)
        ksd, vsd, _ = gathered(ks, vs, table, lens)
        short = table[:, :32].contiguous()
        outs = [pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table,
                                               lens),
                pa.paged_decode_attention_int8(q, kq, vq, ks, vs, short,
                                               lens),
                da.decode_attention_int8(q, kd, vd, valid, ksd, vsd),
                da.decode_attention_int8(
                    q, *(t[:, :512].contiguous()
                         for t in (kd, vd, valid, ksd, vsd)))]
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            fail(f"int8 decode {dn}: the live prefix {lengths} gives other "
                 "bits at horizon 512 than at 2048")
        print(f"int8 decode {dn} live {lengths}: paged nblk 128 / 32 and "
              "dense W 2048 / 512 bit for bit", flush=True)


# the Mamba2 scan: mamba2-2.7b's widths, and the main path's longest
# distinct prefill that fits in one engine's bucket table
SSD_MAIN = dict(B=1, S=512, nh=80, hd=64, ng=1, ds=128, chunk=256)
# |kernel - plain| <= tol * max|plain|: the kernel tiles the sequence by
# 64 where the plain version cuts it at ``chunk``, and the running sums of
# dt*A that set the decays round differently with the cut (~1e-5 of the
# largest output in float32)
SSD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
SSD_TILE = 64   # where the kernel cuts the sequence


def ssd_inputs(gen, B, S, nh, hd, ng, ds, dtype, *, model_like=True):
    """Scan inputs on the card. ``model_like``: as mamba2's init feeds the
    scan — dt = softplus(N(0, 1) + dt_bias) with the init's dt_bias (dt
    0.001-0.1 at 0) and A = -exp(U(0, log 16)); otherwise the JAX suite's
    draw (dt = softplus(N(0, 1)), A = -exp(N(0, 1))). x, B, C ~ N(0, 1),
    D = 1; A and D float32, the rest in ``dtype``."""
    import math

    import torch.nn.functional as F

    from repro_torch.models.ssm import softplus
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    if model_like:
        bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, nh,
                                                    device=dev)))
        dt = softplus(randn(B, S, nh) + bias)
        A = -torch.exp(torch.rand(nh, generator=gen, device=dev)
                       * math.log(16.0))
    else:
        dt, A = F.softplus(randn(B, S, nh)), -torch.exp(randn(nh))
    return (randn(B, S, nh, hd).to(dtype), dt.to(dtype), A,
            randn(B, S, ng, ds).to(dtype), randn(B, S, ng, ds).to(dtype),
            torch.ones(nh, device=dev))


def ssd_bound(B, S, nh, hd, ng, ds, dtype_name, itemsize):
    """Inputs and outputs once each; operations of the chunked form on its
    lower triangles (C.B^T once per group, the quadratic term per head),
    the carried-state term and the state update, at the kernel's own
    64-position cut (both bodies cut there whatever the caller's chunk,
    and a shorter cut has fewer pairs). float32 at the split-TF32 rate its
    body runs (``f32_split_bound``). Returns (ms, what bounds it,
    float32's ms at the CUDA cores' rate, else ms)."""
    nbytes = ((2 * B * S * nh * hd + B * S * nh + 2 * B * S * ng * ds
               + B * nh * hd * ds) * itemsize + 2 * nh * 4)
    pairs = -(-S // SSD_TILE) * SSD_TILE * (SSD_TILE + 1) // 2
    flops = 2 * B * pairs * (ng * ds + nh * hd) + 2 * 2 * B * S * nh * hd * ds
    if dtype_name == "float32":
        return f32_split_bound(flops, nbytes)
    ms, by = bound_ms(flops, nbytes, dtype_name)
    return ms, by, ms


def ssd_checks(gen):
    """The scan kernel against its plain version: the main-path shape in
    float32 and bfloat16, 8 chunks (S = 2048), B = 2, a ragged one-chunk
    prompt, ng = 2 heads-to-groups, and the JAX suite's harsher draw.
    Relative to max|plain| at the caller's chunk, and element by element
    (tol abs + tol rel) against the plain version cut where the kernel
    cuts, at 64 positions, wherever 64 divides S. Returns the largest
    error relative to max|plain| per dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    worst = {}
    m = SSD_MAIN
    cases = [  # (B, S, nh, hd, ng, ds, chunk, model_like)
        (m["B"], m["S"], m["nh"], m["hd"], m["ng"], m["ds"], m["chunk"],
         True),
        (1, 2048, 80, 64, 1, 128, 256, True),
        (2, 512, 80, 64, 1, 128, 256, True),
        (1, 200, 80, 64, 1, 128, 200, True),
        (2, 256, 8, 64, 2, 128, 256, True),
        (1, 512, 80, 64, 2, 128, 256, True),
        (2, 128, 4, 16, 2, 16, 32, False),
        (1, 512, 80, 64, 1, 128, 256, False)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, S, nh, hd, ng, ds, chunk, model_like in cases:
            args = ssd_inputs(gen, B, S, nh, hd, ng, ds, dtype,
                              model_like=model_like)
            what = (f"ssd_scan {dn} B={B} S={S} nh={nh} hd={hd} ng={ng} "
                    f"ds={ds} chunk={chunk} "
                    f"{'model-like' if model_like else 'JAX-suite'} inputs")
            got = ssd.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            want = ref.ssd_scan(*args, chunk=chunk)
            rel = max(ssd_close(g, w, dn, f"{what} {name}")
                      for name, g, w in zip(("y", "state"), got, want))
            worst[dn] = max(worst.get(dn, 0.0), rel)
            tol = SSD_TOL[dn]
            cut = ""
            if S % SSD_TILE == 0:
                want = ref.ssd_scan(*args, chunk=SSD_TILE)
                err = max(ssd_elementwise(g, w, dn, f"{what} {name}")
                          for name, g, w in zip(("y", "state"), got, want))
                cut = (f"; element by element at chunk {SSD_TILE}: max "
                       f"abs error {err:.3e} within {tol} abs + rel")
            ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk), reps=5)
            if dtype == torch.float32 and (B, S, chunk) == (
                    m["B"], m["S"], m["chunk"]) and model_like and ng == 1:
                launched, scratch = ssd_call_footprint(
                    lambda: ssd.ssd_scan(*args, chunk=chunk))
                check_kernels_per_call("ssd_scan float32", launched,
                                       SSD_KERNELS_PER_CALL)
                cut += (f"; one call: {launched} CUDA kernels, {scratch} "
                        "bytes of scratch")
            plain = ""
            if S >= 512:
                plain = " plain_ms={:.4f}".format(time_ms(
                    lambda: ref.ssd_scan(*args, chunk=chunk), reps=3))
            print(f"{what}: max |kernel - plain| / max|plain| = {rel:.3e} "
                  f"(y and state; tolerance {tol}){cut}; kernel_ms="
                  f"{ms:.4f}{plain}", flush=True)
    return worst


def ssd_elementwise(got, want, dtype_name: str, what: str) -> float:
    """|got - want| <= SSD_TOL * (1 + |want|) element by element, against
    the plain version cut at SSD_TILE; returns the max abs error."""
    tol = SSD_TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    over = int((err > tol + tol * w.abs()).sum())
    if over:
        fail(f"{what}: {over} of {w.numel()} elements differ from the plain "
             f"version at chunk {SSD_TILE} by more than {tol} abs + rel "
             f"(max {float(err.max()):.3e})")
    return float(err.max())


def ssd_close(got, want, dtype_name: str, what: str) -> float:
    """|got - want| <= SSD_TOL * max|want|, finite; returns that ratio."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: kernel output is not finite")
    scale = float(w.abs().max())
    rel = float((g - w).abs().max()) / max(scale, 1e-30)
    if rel > SSD_TOL[dtype_name]:
        fail(f"{what}: max |kernel - plain| is {rel:.3e} of max|plain| "
             f"{scale:.3e}, over {SSD_TOL[dtype_name]}")
    return rel


# the scan's CUDA kernels a call (both bodies): chunk states, the pass
# over them, the outputs
SSD_KERNELS_PER_CALL = 3
# the backward's: chunk states with the gradient's own parts, the passes
# (forward and reverse), dx / ddt, dB / dC over runs of heads, the sums
SSD_BWD_KERNELS_PER_CALL = 5


FOOTPRINT_CALLS = 3     # calls a profiler window of ssd_call_footprint


def ssd_call_footprint(call) -> tuple[list, int]:
    """What one ``ssd_scan`` (or ``ssd_scan_bwd``) call does on the card,
    read in this run: the CUDA kernels it launches (name, launches a call:
    its count over FOOTPRINT_CALLS calls in one profiler window, rounded),
    from ``torch.profiler``, and the scratch it allocates beyond its
    outputs, the peak of ``memory_allocated`` during the call less what
    stays after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler can miss the first kernel of its window (one of
        # PyTorch's own goes first and is not counted; a call's first
        # kernel was missed behind it too): a kernel missed once still
        # rounds to its launches a call
        torch.cuda._sleep(1000)
        for _ in range(FOOTPRINT_CALLS):
            call()
        torch.cuda.synchronize()
    kernels = [(e.key, round(e.count / FOOTPRINT_CALLS))
               for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and "spin_kernel" not in e.key]
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del out
    return kernels, scratch


def check_kernels_per_call(what: str, launched: list, want: int) -> int:
    """Fail unless one call launched ``want`` CUDA kernels; returns it."""
    n = sum(c for _, c in launched)
    if n != want:
        fail(f"{what}: one call launched {n} CUDA kernels ({launched}), "
             f"not {want}")
    return n


# absorbed-MLA decode at deepseek-v2-lite's widths: a 4-slot decode step
# over the 2048-position latent cache, rows live to phase 2's depths
MLA_MAIN = dict(B=4, S=2048, H=16, r=512, dr=64)
MLA_DEPTHS = [48, 160, 300, 544]
MLA_SCALE = 192 ** -0.5          # (qk_nope + qk_rope) ** -0.5


def mla_inputs(gen, B, S, dtype, H=16, r=512, dr=64):
    """q_lat, q_rope, ckv, k_rope ~ N(0, 1) on the card, in ``dtype``."""
    return tuple(torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, H, r), (B, H, dr), (B, S, r), (B, S, dr)))


def mla_bound(valid, H, r, dr, dtype_name, itemsize):
    """Each live latent and rope row read once, q, the mask and the
    output once; 2 * H * (2r + dr) operations per live position."""
    B, S = valid.shape
    live = int(valid.sum())
    nbytes = ((live + B * H) * (r + dr) * itemsize + B * S
              + B * H * r * itemsize)
    flops = 2 * H * live * (2 * r + dr)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def mla_checks(gen):
    """The MLA decode kernel against its plain version, float32 and
    bfloat16, each shape timed beside its plain version and its bound:
    the main shape; a ragged S = 1000 with one all-dead row, which must
    read 0 and keep its bits with NaN in every dead position; rows live
    to the split edges; and the logical view gathered from 16-token
    latent pages (the paged cache's path), which must also ignore NaN in
    every page no row owns."""
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    m = MLA_MAIN

    def held(what, dn, args, valid):
        """The kernel against its plain version on ``args``; prints the
        error, the kernel's and the plain version's ms and the bound."""
        got = mla.mla_decode_ctx(*args, valid, scale=MLA_SCALE)
        torch.cuda.synchronize()
        err = check_close(got, ref.mla_decode_ctx(*args, valid,
                                                  scale=MLA_SCALE), dn, what)
        bound, by = mla_bound(valid, m["H"], m["r"], m["dr"], dn,
                              args[0].element_size())
        print(f"{what}: max_abs_err={err:.3e} kernel_ms="
              f"{time_ms(lambda: mla.mla_decode_ctx(*args, valid, scale=MLA_SCALE)):.4f}"
              f" plain_ms="
              f"{time_ms(lambda: ref.mla_decode_ctx(*args, valid, scale=MLA_SCALE), reps=5):.4f}"
              f" bound_ms={bound:.6f} ({by})", flush=True)
        return got

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        valid = (torch.arange(m["S"], device=dev)[None, :]
                 < torch.tensor(MLA_DEPTHS, device=dev)[:, None])
        held(f"mla_decode_ctx {dn} B={m['B']} S={m['S']} live={MLA_DEPTHS}",
             dn, mla_inputs(gen, m["B"], m["S"], dtype), valid)

        B, S = 3, 1000
        valid = torch.rand(B, S, generator=gen, device=dev) < 0.7
        valid[-1] = False                    # a row with no live position
        what = f"mla_decode_ctx {dn} B={B} S={S} ragged, row {B - 1} dead"
        args = mla_inputs(gen, B, S, dtype)
        got = held(what, dn, args, valid)
        if bool(got[-1].ne(0).any()):
            fail(f"{what}: the all-dead row is not 0")
        # dead positions inside live splits are never read
        args[2][~valid] = float("nan")
        args[3][~valid] = float("nan")
        if not torch.equal(mla.mla_decode_ctx(*args, valid,
                                              scale=MLA_SCALE), got):
            fail(f"{what}: output moved with NaN in dead positions")
        print(f"{what}: NaN in dead positions of live splits ignored",
              flush=True)

        # rows live to the 64-position splits' edges and the whole horizon
        edges = [1, 63, 64, 65, 127, 128, 129, m["S"]]
        valid = (torch.arange(m["S"], device=dev)[None, :]
                 < torch.tensor(edges, device=dev)[:, None])
        held(f"mla_decode_ctx {dn} S={m['S']} live={edges}", dn,
             mla_inputs(gen, len(edges), m["S"], dtype), valid)

        # the paged path: pages drawn at random from a pool twice the
        # needed size, the rest of each table on the scratch page
        bs, nblk = 16, m["S"] // 16
        B, n_pages = m["B"], 2 * m["B"] * nblk
        ql, qr, _, _ = mla_inputs(gen, B, 1, dtype)
        ckv_p = torch.randn(n_pages + 1, bs, m["r"], generator=gen,
                            device=dev).to(dtype)
        kr_p = torch.randn(n_pages + 1, bs, m["dr"], generator=gen,
                           device=dev).to(dtype)
        lengths = torch.tensor(MLA_DEPTHS, device=dev)
        table = torch.randperm(n_pages, generator=gen, device=dev)[
            :B * nblk].reshape(B, nblk)
        owned = torch.arange(nblk, device=dev)[None, :] < (
            (lengths[:, None] + bs - 1) // bs)
        table[~owned] = n_pages
        unowned = torch.ones(n_pages + 1, dtype=torch.bool, device=dev)
        unowned[table[owned]] = False
        valid = (torch.arange(m["S"], device=dev)[None, :]
                 < lengths[:, None])

        def view(pages):
            return pages[table].reshape(B, m["S"], pages.shape[-1])
        what = (f"mla_decode_ctx {dn} over 16-token pages, live="
                f"{MLA_DEPTHS}")
        got = held(what, dn, (ql, qr, view(ckv_p), view(kr_p)), valid)
        ckv_p[unowned] = float("nan")
        kr_p[unowned] = float("nan")
        poisoned = mla.mla_decode_ctx(ql, qr, view(ckv_p), view(kr_p),
                                      valid, scale=MLA_SCALE)
        if not (torch.equal(poisoned, got)
                and bool(torch.isfinite(poisoned).all())):
            fail(f"{what}: output moved with NaN in unowned pages")
        print(f"{what}: NaN in unowned pages ignored", flush=True)


def flash_mla_checks(gen):
    """The prefill kernel at MLA's widths (K = 192, Kv = 128, H = Hkv =
    16, causal), float32 and bfloat16; returns the bfloat16 numbers: ms,
    the plain version's, one sdpa call's (never called by the port) and
    the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        q, k = (torch.randn(1, 512, 16, 192, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        v = torch.randn(1, 512, 16, 128, generator=gen,
                        device="cuda").to(dtype)
        what = f"flash_attention {dn} B=1 Sq=Skv=512 H=Hkv=16 K=192 Kv=128"
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = check_close(got, ref.flash_attention(q, k, v), dn, what)
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        print(f"{what}: max_abs_err={err:.3e} kernel_ms={ms:.4f}",
              flush=True)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = ref.attention_mask(512, 512, causal=True, window=0,
                              device=q.device)
    pairs = int(mask.sum())
    flops = 2 * 16 * pairs * (192 + 128)
    nbytes = 512 * 16 * (2 * 192 + 2 * 128) * 2    # q, k, v, out once
    t_ops, t_bytes = flops / PEAK_FLOPS[dn], nbytes / PEAK_BYTES_S
    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    return {"ms": ms, "max_abs_err": err,
            "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v),
                                reps=5),
            "library_ms": time_ms(library),
            "graph_ms": time_graph_ms(lambda: fa.flash_attention(q, k, v)),
            "library_graph_ms": time_graph_ms(library),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "shape": "B=1 Sq=Skv=512 H=Hkv=16 K=192 Kv=128 bf16 causal"}


# the prefill kernel at the other shapes it takes: K padded to the MMA
# depth (72, 5 with rows off 16 bytes), K = 192 / 256, Kv from 16 to 256,
# one KV head, Sq = 1, queries right-aligned against longer and shorter
# key runs (rows that see no key give 0), a window and a softcap
FLASH_SHAPES = [  # (B, Sq, Skv, H, Hkv, K, Kv, window, softcap)
    (1, 100, 100, 4, 2, 72, 64, 0, 0.0),
    (1, 130, 130, 4, 2, 192, 128, 0, 0.0),
    (1, 77, 77, 4, 2, 5, 32, 0, 0.0),
    (2, 70, 70, 4, 2, 64, 16, 0, 0.0),
    (1, 90, 90, 4, 1, 128, 256, 0, 0.0),
    (1, 40, 40, 4, 2, 256, 256, 0, 0.0),
    (1, 96, 96, 8, 1, 128, 128, 0, 0.0),
    (2, 1, 50, 4, 2, 128, 128, 0, 0.0),
    (1, 40, 150, 4, 2, 64, 64, 0, 0.0),
    (1, 80, 50, 4, 2, 64, 64, 0, 0.0),
    (1, 200, 200, 4, 2, 64, 64, 100, 0.0),
    (1, 300, 300, 2, 2, 32, 32, 0, 30.0)]


def flash_shape_checks(gen):
    """The prefill kernel against its plain version at FLASH_SHAPES in
    float32 and bfloat16, and the prefix-sharing property bit for bit: the
    suffix's rows over [context | suffix] equal the whole prompt's, at a
    context of 256 and of 272 (a row at another place in its query
    tile)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, Sq, Skv, h, hkv, k_, kv, window, softcap in FLASH_SHAPES:
            q = randn(B, Sq, h, k_, dtype=dtype)
            k = randn(B, Skv, hkv, k_, dtype=dtype)
            v = randn(B, Skv, hkv, kv, dtype=dtype)
            kw = dict(causal=True, window=window, softcap=softcap)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            what = (f"flash_attention {dn} B={B} Sq={Sq} Skv={Skv} H={h} "
                    f"Hkv={hkv} K={k_} Kv={kv} window={window} "
                    f"softcap={softcap}")
            err = check_close(got, ref.flash_attention(q, k, v, **kw), dn,
                              what)
            if bool(got[:, :max(Sq - Skv, 0)].ne(0).any()):
                fail(f"{what}: a row that sees no key is not 0")
            print(f"{what}: max_abs_err={err:.3e}", flush=True)
        for ctx in (256, 272):
            q, k, v = (randn(2, 512, n, K, dtype=dtype) for n in (H, HKV, HKV))
            full = fa.flash_attention(q, k, v)
            part = fa.flash_attention(q[:, ctx:ctx + 128].contiguous(),
                                      k[:, :ctx + 128].contiguous(),
                                      v[:, :ctx + 128].contiguous())
            if not torch.equal(part[:, :100], full[:, ctx:ctx + 100]):
                fail(f"flash_attention {dn}: the suffix over [context {ctx} "
                     "| suffix] is not the whole prompt's rows bit for bit")
        print(f"flash_attention {dn}: suffix rows over [context | suffix] "
              "equal the whole prompt's bit for bit at contexts 256 and 272",
              flush=True)


# RMSNorm at every width the port's norms see: 128 (qwen3 q/k norms, rows
# B*S*H), 512 (the deepseek latent norm), 1024 / 2048 / 2560 (block norms)
# and 5120 (the mamba2 gated norm), and those of the families still to
# come (4096 to 7168); the main shape is the block norm of a 512-token
# qwen3 prefill
RMS_WIDTHS = (128, 512, 1024, 2048, 2560, 5120)
RMS_LATER = (3584, 4096, 5376, 6144, 7168)
RMS_ROWS = (1, 37, 4099)      # no multiple of the kernel's rows a block
RMS_MAIN = dict(rows=512, D=1024)
RMS_EPS = 1e-6
# widths the 16-byte path does not take (V = 8 bf16 / 4 f32 elements does
# not divide them), and one wider than the registers hold
RMS_ODD = {"float32": (1022, 20000), "bfloat16": (1020, 20000)}
# a 4-slot decode step's norms, bf16: (shape, width read of it)
RMS_DECODE = {"qwen3 block": ((4, 1, 1024), None),
              "mamba2 block": ((4, 1, 2560), None),
              "mamba2 gated": ((4, 1, 5120), None),
              "deepseek block": ((4, 1, 2048), None),
              "deepseek latent": ((4, 1, 576), 512)}
QK_DECODE = ((4, 1, 16, 128), (4, 1, 8, 128))    # qwen3's q and k


def rmsnorm_bound(shapes, dtype_name, itemsize, scale_itemsize):
    """x read once, y written once, scale read once, for each (rows, D) of
    ``shapes`` (one launch may normalise two tensors); ~4 flops an element
    (square, sum, two products)."""
    nbytes = sum(2 * rows * D * itemsize + D * scale_itemsize
                 for rows, D in shapes)
    ops = sum(4 * rows * D for rows, D in shapes)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _copy_at(t, offset=0, pad=0):
    """t (rows, D)'s values in a fresh buffer: ``offset`` elements past its
    16-byte aligned base, and with rows ``pad`` elements wider than t's."""
    rows, D = t.shape
    buf = torch.empty(offset + rows * (D + pad), dtype=t.dtype,
                      device=t.device)
    view = buf[offset:].view(rows, D + pad)[:, :D]
    view.copy_(t)
    return view


def rmsnorm_checks(gen):
    """rmsnorm against its plain version: every width, float32 and
    bfloat16, 1 / 37 / 4099 rows, the MLA latent slice dkv[..., :512] of
    576-wide rows read in place, a float32 scale under bfloat16 rows, and
    widths the 16-byte path does not take. Then bit for bit: a row alone,
    inside 4099 rows and in a pair launch; the same rows with a base one
    element off 16 bytes, a row stride of D + 1 and a scale off 16 bytes
    (the one-element path) as the aligned ones; and a pair launch as two
    single ones, counted once. Returns the worst error by dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        widths = RMS_WIDTHS + RMS_LATER + RMS_ODD[dn]
        cases = [(randn(rows, D).mul_(2).to(dtype),
                  (1 + 0.1 * randn(D)).to(dtype), f"rows={rows} D={D}")
                 for D in widths for rows in RMS_ROWS]
        dkv = randn(4, 512, 576).to(dtype)
        cases.append((dkv[..., :512], (1 + 0.1 * randn(512)).to(dtype),
                      "strided dkv[..., :512] of (4, 512, 576)"))
        cases.append((randn(37, 2048).to(dtype), 1 + 0.1 * randn(2048),
                      "rows=37 D=2048 float32 scale"))
        errs = []
        for x, scale, what in cases:
            got = rn.rmsnorm(x, scale, RMS_EPS)
            torch.cuda.synchronize()
            errs.append(check_close(got, ref.rmsnorm(x, scale, RMS_EPS), dn,
                                    f"rmsnorm {dn} {what}"))
            if x.shape[0] != RMS_ROWS[-1]:
                continue
            # bits: a row alone, inside the rows, in a pair (either side);
            # the one-element path on the same rows
            D = x.shape[-1]
            y, y_scale = randn(37, D).to(dtype), scale.flip(0)
            for r in (0, 5, 2048, x.shape[0] - 1):
                if not torch.equal(rn.rmsnorm(x[r:r + 1], scale,
                                              RMS_EPS)[0], got[r]):
                    fail(f"rmsnorm {dn} D={D}: row {r} alone has other "
                         "bits than inside 4099 rows")
            a, b = rn.rmsnorm_pair(x, scale, y, y_scale, RMS_EPS)
            c, d = rn.rmsnorm_pair(y, y_scale, x[5:6], scale, RMS_EPS)
            if not (torch.equal(a, got) and torch.equal(d[0], got[5])
                    and torch.equal(b, c)
                    and torch.equal(b, rn.rmsnorm(y, y_scale, RMS_EPS))):
                fail(f"rmsnorm {dn} D={D}: rows in a pair launch have "
                     "other bits than alone")
            head = x[:37]
            off_scale = _copy_at(scale[None], offset=1)[0]
            for other, how in ((rn.rmsnorm(_copy_at(head, offset=1), scale,
                                           RMS_EPS), "a base off 16 bytes"),
                               (rn.rmsnorm(_copy_at(head, pad=1), scale,
                                           RMS_EPS), f"row stride {D + 1}"),
                               (rn.rmsnorm(head, off_scale, RMS_EPS),
                                "a scale off 16 bytes")):
                if not torch.equal(other, got[:37]):
                    fail(f"rmsnorm {dn} D={D}: {how} (one element at a "
                         "time) gives other bits than the aligned rows")
        worst[dn] = max(errs)
        # a layer's q and k norms: one launch, the bits of two
        q, k = (randn(*shape).to(dtype) for shape in QK_DECODE)
        qs, ks = ((1 + 0.1 * randn(128)).to(dtype) for _ in range(2))
        before = rn.launches.value
        gq, gk = rn.rmsnorm_pair(q, qs, k, ks, RMS_EPS)
        torch.cuda.synchronize()
        if rn.launches.value != before + 1:
            fail(f"rmsnorm {dn}: a pair took {rn.launches.value - before} "
                 "launches")
        if not (torch.equal(gq, rn.rmsnorm(q, qs, RMS_EPS))
                and torch.equal(gk, rn.rmsnorm(k, ks, RMS_EPS))):
            fail(f"rmsnorm {dn}: the q/k pair is not two single launches "
                 "bit for bit")
        print(f"rmsnorm {dn}: {len(cases)} cases (D {list(widths)} x rows "
              f"{list(RMS_ROWS)}, a strided latent slice, a float32 scale) "
              f"within {TOL[dn]} abs + rel of the plain version, "
              f"max_abs_err={worst[dn]:.3e}; bit for bit: a row alone = "
              "inside 4099 rows = in a pair, one element at a time (base "
              "or scale off 16 bytes, row stride D + 1) = 16-byte loads, "
              "the q/k pair (one launch) = two launches", flush=True)
    return worst


def rmsnorm_decode_calls(gen) -> dict:
    """The norms of a 4-slot decode step at their shapes, bf16: {name:
    {"kernel", "library": zero-argument calls, "bound": (ms, by)}}. The
    q/k norms as two single launches and, where the port has it, as one
    pair launch. The library call is ``torch.nn.functional.rms_norm``
    (one a tensor), which the port never makes."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    dtype = torch.bfloat16

    def case(shape, width=None):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        x = x if width is None else x[..., :width]
        D = x.shape[-1]
        return x, (1 + 0.1 * torch.randn(D, generator=gen,
                                          device=dev)).to(dtype)

    def rows_d(x):
        return x.numel() // x.shape[-1], x.shape[-1]

    calls = {}
    for name, (shape, width) in RMS_DECODE.items():
        x, s = case(shape, width)
        calls[f"{name} {shape}" + (f"[..., :{width}]" if width else "")] = {
            "kernel": lambda x=x, s=s: rn.rmsnorm(x, s, RMS_EPS),
            "library": lambda x=x, s=s: F.rms_norm(x, (x.shape[-1],),
                                                   weight=s, eps=RMS_EPS),
            "bound": rmsnorm_bound([rows_d(x)], "bfloat16", 2, 2)}
    (q, qs), (k, ks) = (case(shape) for shape in QK_DECODE)

    def library():
        return (F.rms_norm(q, (128,), weight=qs, eps=RMS_EPS),
                F.rms_norm(k, (128,), weight=ks, eps=RMS_EPS))
    bound = rmsnorm_bound([rows_d(q), rows_d(k)], "bfloat16", 2, 2)
    qk = f"qwen3 q/k {QK_DECODE[0]} + {QK_DECODE[1]}"
    calls[f"{qk} as two launches"] = {
        "kernel": lambda: (rn.rmsnorm(q, qs, RMS_EPS),
                           rn.rmsnorm(k, ks, RMS_EPS)),
        "library": library, "bound": bound}
    if hasattr(rn, "rmsnorm_pair"):
        calls[f"{qk} as one pair launch"] = {
            "kernel": lambda: rn.rmsnorm_pair(q, qs, k, ks, RMS_EPS),
            "library": library, "bound": bound}
    return calls


def launch_floor_ms() -> float:
    """Device time of an empty kernel (``torch.cuda._sleep(0)``) replayed
    from a CUDA graph: the least any launch takes on this card."""
    return time_graph_ms(lambda: torch.cuda._sleep(0))


def decode_main_calls(gen) -> dict:
    """The four decode kernels and MLA decode at their main-path shapes,
    bfloat16: {name: {"kernel", "plain", "library": zero-argument calls,
    "bound": (ms, by), "shape": text}}. Dense decode: a 4-slot step over
    the 2048-slot ring with rows live to phase 4's depths; paged: phase
    6's 8 rows of 16-token pages
    live to 280-520; int8 at those shapes (int8 K/V from the model's
    quantiser, bf16 queries); MLA at deepseek-v2-lite's widths. The
    library call is one ``scaled_dot_product_attention`` the port never
    makes: masked, over the pre-gathered dense view (paged), over the
    dequantised bf16 view (int8), and over [q_lat | q_rope] against
    [ckv | k_rope] (MLA); gathers, dequantisation and concatenation are
    not timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    dtype, dn, isz = torch.bfloat16, "bfloat16", 2

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def sdpa(q, k, v, valid, **kw):
        """(B, H, K) queries against (B, W, Hkv, K) keys/values."""
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask4 = valid[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, enable_gqa=True, **kw)

    def dequant(codes, scale):
        return (codes.float() * scale[..., None]).to(dtype)

    calls = {}
    B, W = 4, 2048
    depth = torch.tensor([48, 160, 300, 544], device=dev)
    valid = torch.arange(W, device=dev)[None, :] < depth[:, None]
    q, k, v = randn(B, H, K), randn(B, W, HKV, K), randn(B, W, HKV, K)
    calls["decode_attention"] = {
        "kernel": lambda: da.decode_attention(q, k, v, valid),
        "plain": lambda: ref.decode_attention(q, k, v, valid),
        "library": sdpa(q, k, v, valid),
        "bound": decode_bound(B, W, valid, dn, isz),
        "shape": f"B={B} W={W} H={H} Hkv={HKV} K={K} bf16 live="
                 f"{depth.tolist()}"}

    lengths, bs, nblk = PAGED_MAIN_LENGTHS, 16, 128
    pq, kp, vp, table, lens, _ = paged_case(gen, lengths, h=H, hkv=HKV, k=K,
                                            bs=bs, nblk=nblk, dtype=dtype)
    kd, vd, pvalid = gathered(kp, vp, table, lens)
    calls["paged_decode_attention"] = {
        "kernel": lambda: pa.paged_decode_attention(pq, kp, vp, table, lens),
        "plain": lambda: ref.paged_decode_attention(pq, kp, vp, table, lens),
        "library": sdpa(pq, kd, vd, pvalid),
        "bound": paged_bound(len(lengths), nblk, lens, dn, isz),
        "shape": f"B={len(lengths)} bs={bs} nblk={nblk} H={H} Hkv={HKV} "
                 f"K={K} bf16 live={lengths}; library_ms is sdpa over the "
                 "pre-gathered dense view (gather not counted)"}

    qi = randn(B, H, K)
    kq, ks = quant(torch.randn(B, W, HKV, K, generator=gen, device=dev))
    vq, vs = quant(torch.randn(B, W, HKV, K, generator=gen, device=dev))
    calls["decode_attention_int8"] = {
        "kernel": lambda: da.decode_attention_int8(qi, kq, vq, valid, ks, vs),
        "plain": lambda: ref.decode_attention(qi, kq, vq, valid, k_scale=ks,
                                              v_scale=vs),
        "library": sdpa(qi, dequant(kq, ks), dequant(vq, vs), valid),
        "bound": decode_bound(B, W, valid, dn, isz, row_bytes=K + 4),
        "shape": f"B={B} W={W} H={H} Hkv={HKV} K={K} bf16 q, int8 K/V + "
                 f"f32 scales, live={depth.tolist()}; library_ms is sdpa "
                 "over the dequantised bf16 view (dequant not counted)"}

    iq, ikp, ivp, itable, ilens, _ = paged_case(
        gen, lengths, h=H, hkv=HKV, k=K, bs=bs, nblk=nblk,
        dtype=torch.float32)
    iq = iq.to(dtype)
    ikq, iks = quant(ikp)
    ivq, ivs = quant(ivp)
    ikd, ivd, ivalid = gathered(ikq, ivq, itable, ilens)
    iksd, ivsd, _ = gathered(iks, ivs, itable, ilens)
    calls["paged_decode_attention_int8"] = {
        "kernel": lambda: pa.paged_decode_attention_int8(
            iq, ikq, ivq, iks, ivs, itable, ilens),
        "plain": lambda: ref.paged_decode_attention(
            iq, ikq, ivq, itable, ilens, k_scale_pages=iks,
            v_scale_pages=ivs),
        "library": sdpa(iq, dequant(ikd, iksd), dequant(ivd, ivsd), ivalid),
        "bound": paged_bound(len(lengths), nblk, ilens, dn, isz,
                             row_bytes=K + 4),
        "shape": f"B={len(lengths)} bs={bs} nblk={nblk} H={H} Hkv={HKV} "
                 f"K={K} bf16 q, int8 pages + f32 scale pages, live="
                 f"{lengths}; library_ms is sdpa over the pre-gathered, "
                 "dequantised bf16 view (gather and dequant not counted)"}

    m = MLA_MAIN
    args = mla_inputs(gen, m["B"], m["S"], dtype)
    mvalid = (torch.arange(m["S"], device=dev)[None, :]
              < torch.tensor(MLA_DEPTHS, device=dev)[:, None])
    ql, qr, ckv, kr = args
    q4 = torch.cat([ql, qr], dim=-1)[:, :, None]
    k4 = torch.cat([ckv, kr], dim=-1)[:, None]
    mask4 = mvalid[:, None, None, :]
    calls["mla_decode_ctx"] = {
        "kernel": lambda: mla.mla_decode_ctx(*args, mvalid, scale=MLA_SCALE),
        "plain": lambda: ref.mla_decode_ctx(*args, mvalid, scale=MLA_SCALE),
        "library": lambda: F.scaled_dot_product_attention(
            q4, k4, ckv[:, None], attn_mask=mask4, scale=MLA_SCALE,
            enable_gqa=True),
        "bound": mla_bound(mvalid, m["H"], m["r"], m["dr"], dn, isz),
        "shape": f"B={m['B']} S={m['S']} H={m['H']} r={m['r']} "
                 f"dr={m['dr']} bf16 live={MLA_DEPTHS}; library_ms is sdpa "
                 "over q=[q_lat|q_rope], k=[ckv|k_rope] (one kv head), "
                 "v=ckv (concatenation not counted)"}
    return calls


# the served shapes of the gemma family and the 8B dense configs: gemma's
# local prefill (window 1024) and its 1024-slot ring written past
# position 1024 (G = 2, K = 128), and qwen3-8b's 4-row decode step (G = 4,
# K = 128, the widest instantiation) over the dense ring and the pages
GEMMA_FLASH = dict(B=1, S=1300, H=32, Hkv=16, K=128, window=1024)
GEMMA_RING = dict(B=4, W=1024, H=32, Hkv=16, K=128,
                  pos=[1030, 1500, 2047, 700])
G4_DECODE = dict(B=4, W=2048, H=32, Hkv=8, K=128, depth=[48, 160, 300, 544])


def bound_ms(flops, nbytes, dn) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dn], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def f32_split_bound(flops, nbytes) -> tuple[float, str, float]:
    """A float32 kernel's bound where its body runs split TF32 (the flash
    bodies, the scan and its backward): the smaller of its CUDA-core bound
    (operations at 67 TFLOP/s) and its split-TF32 bound (3 x operations at
    494.7 TFLOP/s), each the larger of its operations' and its bytes'
    time, so that no row reads faster than its bound; then the CUDA-core
    bound."""
    cores = bound_ms(flops, nbytes, "float32")
    t_ops, t_bytes = flops / SPLIT_TF32_FLOPS, nbytes / PEAK_BYTES_S
    split = (max(t_ops, t_bytes) * 1e3,
             "operations" if t_ops >= t_bytes else "bytes")
    return (*min(split, cores), cores[0])


def family_shape_checks(gen) -> dict:
    """The prefill, dense decode and paged decode kernels at the shapes
    the gemma family and the 8B dense configs give them (GEMMA_FLASH,
    GEMMA_RING, G4_DECODE), held against their plain versions in float32
    and bfloat16 (the paged kernel also bit for bit against the dense one
    over the gathered view), then in bfloat16 timed (device time from
    graph replays) beside the plain version and
    ``scaled_dot_product_attention``, with the shape's bound. Returns
    {kernel: {label: row}}."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import ring_positions

    dev = torch.device("cuda")

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def sdpa(q, k, v, valid):
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=valid[:, None, None, :], enable_gqa=True)

    out: dict = {}

    def row(name, label, calls, bound, shape):
        """Check in both dtypes (``calls(dtype)`` gives kernel, plain and
        library calls), then time the bfloat16 one."""
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            k_call, p_call, lib = calls(dtype)
            got = k_call()
            torch.cuda.synchronize()
            err = check_close(got, p_call(), dn, f"{name} {label} {dn}")
            print(f"{name} {label} {dn} {shape}: max_abs_err={err:.3e}",
                  flush=True)
        out.setdefault(name, {})[label] = {
            "max_abs_err": err, "ms": time_graph_ms(k_call),
            "plain_ms": time_ms(p_call, reps=5),
            "library_ms": time_graph_ms(lib),
            "bound_ms": bound[0], "bound_by": bound[1],
            "shape": shape + " bf16; ms and library_ms device time (100 "
                     "calls replayed from a CUDA graph), plain_ms launched "
                     "one by one (CUDA events); library_ms is sdpa"}

    f = GEMMA_FLASH
    mask = ref.attention_mask(f["S"], f["S"], causal=True,
                              window=f["window"], device=dev)

    def flash_calls(dtype):
        q = randn(f["B"], f["S"], f["H"], f["K"], dtype=dtype)
        k, v = (randn(f["B"], f["S"], f["Hkv"], f["K"], dtype=dtype)
                for _ in range(2))
        kw = dict(causal=True, window=f["window"])
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return (lambda: fa.flash_attention(q, k, v, **kw),
                lambda: ref.flash_attention(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True))
    pairs = int(mask.sum())
    row("flash_attention", "gemma_local", flash_calls,
        bound_ms(4 * f["B"] * f["H"] * pairs * f["K"],
                 2 * f["B"] * f["S"] * (f["H"] + f["Hkv"]) * f["K"] * 2,
                 "bfloat16"),
        f"B={f['B']} S={f['S']} H={f['H']} Hkv={f['Hkv']} K={f['K']} "
        f"window={f['window']} causal")

    def decode_row(label, B, W, h, hkv, k_, valid, shape):
        def calls(dtype):
            q = randn(B, h, k_, dtype=dtype)
            k, v = (randn(B, W, hkv, k_, dtype=dtype) for _ in range(2))
            return (lambda: da.decode_attention(q, k, v, valid),
                    lambda: ref.decode_attention(q, k, v, valid),
                    sdpa(q, k, v, valid))
        live = int(valid.sum())
        row("decode_attention", label, calls,
            bound_ms(4 * live * h * k_,
                     2 * live * hkv * k_ * 2 + 2 * B * h * k_ * 2 + B * W,
                     "bfloat16"), shape)

    r = GEMMA_RING
    pos = torch.tensor(r["pos"], device=dev)
    decode_row("gemma_ring", r["B"], r["W"], r["H"], r["Hkv"], r["K"],
               (ring_positions(r["W"], pos) >= 0).contiguous(),
               f"B={r['B']} ring W={r['W']} H={r['H']} Hkv={r['Hkv']} "
               f"K={r['K']} written to positions {r['pos']}")
    g = G4_DECODE
    depth = torch.tensor(g["depth"], device=dev)
    decode_row("g4", g["B"], g["W"], g["H"], g["Hkv"], g["K"],
               torch.arange(g["W"], device=dev)[None, :] < depth[:, None],
               f"B={g['B']} W={g['W']} H={g['H']} Hkv={g['Hkv']} "
               f"K={g['K']} live={g['depth']}")

    bs, nblk = 16, g["W"] // 16

    def paged_calls(dtype):
        q, kp, vp, table, lens, _ = paged_case(
            gen, g["depth"], h=g["H"], hkv=g["Hkv"], k=g["K"], bs=bs,
            nblk=nblk, dtype=dtype)
        kd, vd, valid = gathered(kp, vp, table, lens)
        dense = da.decode_attention(q, kd, vd, valid)
        got = pa.paged_decode_attention(q, kp, vp, table, lens)
        if not torch.equal(got, dense):
            fail(f"paged_decode_attention G=4 {dtype}: not bitwise the "
                 "dense kernel over the gathered view")
        return (lambda: pa.paged_decode_attention(q, kp, vp, table, lens),
                lambda: ref.paged_decode_attention(q, kp, vp, table, lens),
                sdpa(q, kd, vd, valid))
    live = sum(g["depth"])
    row("paged_decode_attention", "g4", paged_calls,
        bound_ms(4 * live * g["H"] * g["K"],
                 2 * live * g["Hkv"] * g["K"] * 2
                 + 2 * g["B"] * g["H"] * g["K"] * 2 + g["B"] * nblk * 4,
                 "bfloat16"),
        f"B={g['B']} bs={bs} nblk={nblk} H={g['H']} Hkv={g['Hkv']} "
        f"K={g['K']} live={g['depth']} (bitwise the dense kernel over the "
        "gathered view)")
    return out


# the shapes the hybrid, vision and windowed-MoE families give the kernels
# (phase 15's): zamba2-7b's shared attention (H = Hkv = 32, K = Kv = 112)
# in a 512-token prefill and a 4-row decode step, mixtral-8x22b's and
# internvl2-26b's 4-row step (G = 6: H 48, Hkv 8, K 128), zamba2's SSD
# scan over a 512-token prefill and the norms of the three at 512 rows
ZAMBA_FLASH = dict(B=1, S=512, H=32, Hkv=32, K=112)
NEW_DECODE = {"zamba_k112": dict(H=32, Hkv=32, K=112),
              "g6": dict(H=48, Hkv=8, K=128)}
ZAMBA_SSD = dict(B=1, S=512, nh=112, hd=64, ng=1, ds=64, chunk=256)
NEW_NORMS = {"zamba block (512, 3584)": 3584,
             "internvl2/mixtral block (512, 6144)": 6144,
             "zamba gated (512, 7168)": 7168}


def later_shape_checks(gen) -> dict:
    """The prefill, dense and paged decode (bf16/f32 K/V and int8 codes),
    SSD scan and rmsnorm kernels at the shapes of phase 15's models
    (ZAMBA_FLASH, NEW_DECODE at G4_DECODE's 4 rows live to 48-544 of 2048,
    ZAMBA_SSD, NEW_NORMS), each held against its plain version in float32
    (2e-5) and bfloat16 (2e-2; the scan at SSD_TOL of max|plain|; the
    int8 pair with f32 / bf16 queries), the paged kernels bit for bit the
    dense ones over the gathered view (the int8 ones also unmoved by NaN
    in unowned pages and scale pages, the dense int8 one by NaN scales in
    dead slots), then in bfloat16 timed as device
    time (100 calls replayed from a CUDA graph) beside the plain version
    and the library call (sdpa; F.rms_norm; none for the scan), with the
    shape's bound. Returns {kernel: {label: row}}."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def sdpa(q, k, v, valid):
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=valid[:, None, None, :], enable_gqa=True)

    out: dict = {}

    def row(name, label, calls, bound, shape, close=check_close,
            library="sdpa"):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            k_call, p_call, lib = calls(dtype)
            got = k_call()
            torch.cuda.synchronize()
            err = close(got, p_call(), dn, f"{name} {label} {dn}")
            print(f"{name} {label} {dn} {shape}: max_abs_err={err:.3e}",
                  flush=True)
        out.setdefault(name, {})[label] = {
            "max_abs_err": err, "ms": time_graph_ms(k_call),
            "plain_ms": time_ms(p_call, reps=5),
            "library_ms": time_graph_ms(lib) if lib else None,
            "bound_ms": bound[0], "bound_by": bound[1],
            "shape": shape + " bf16; ms and library_ms device time (100 "
                     "calls replayed from a CUDA graph), plain_ms launched "
                     f"one by one (CUDA events); library_ms is {library}"}

    f = ZAMBA_FLASH
    mask = ref.attention_mask(f["S"], f["S"], causal=True, window=0,
                              device=dev)

    def flash_calls(dtype):
        q = randn(f["B"], f["S"], f["H"], f["K"], dtype=dtype)
        k, v = (randn(f["B"], f["S"], f["Hkv"], f["K"], dtype=dtype)
                for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return (lambda: fa.flash_attention(q, k, v),
                lambda: ref.flash_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
    row("flash_attention", "zamba_k112", flash_calls,
        bound_ms(4 * f["B"] * f["H"] * int(mask.sum()) * f["K"],
                 2 * f["B"] * f["S"] * (f["H"] + f["Hkv"]) * f["K"] * 2,
                 "bfloat16"),
        f"B={f['B']} S={f['S']} H={f['H']} Hkv={f['Hkv']} K=Kv={f['K']} "
        "causal")

    g = G4_DECODE
    B, W, depth = g["B"], g["W"], g["depth"]
    valid = (torch.arange(W, device=dev)[None, :]
             < torch.tensor(depth, device=dev)[:, None])
    live = sum(depth)
    bs, nblk = 16, W // 16
    for label, d in NEW_DECODE.items():
        h, hkv, k_ = d["H"], d["Hkv"], d["K"]

        def dense_calls(dtype):
            q = randn(B, h, k_, dtype=dtype)
            k, v = (randn(B, W, hkv, k_, dtype=dtype) for _ in range(2))
            return (lambda: da.decode_attention(q, k, v, valid),
                    lambda: ref.decode_attention(q, k, v, valid),
                    sdpa(q, k, v, valid))
        shape = f"B={B} W={W} H={h} Hkv={hkv} K={k_} live={depth}"
        row("decode_attention", label, dense_calls,
            bound_ms(4 * live * h * k_,
                     2 * live * hkv * k_ * 2 + 2 * B * h * k_ * 2 + B * W,
                     "bfloat16"), shape)

        def paged_calls(dtype):
            q, kp, vp, table, lens, _ = paged_case(
                gen, depth, h=h, hkv=hkv, k=k_, bs=bs, nblk=nblk,
                dtype=dtype)
            kd, vd, vmask = gathered(kp, vp, table, lens)
            dense = da.decode_attention(q, kd, vd, vmask)
            got = pa.paged_decode_attention(q, kp, vp, table, lens)
            if not torch.equal(got, dense):
                fail(f"paged_decode_attention {label} {dtype}: not bitwise "
                     "the dense kernel over the gathered view")
            return (lambda: pa.paged_decode_attention(q, kp, vp, table,
                                                      lens),
                    lambda: ref.paged_decode_attention(q, kp, vp, table,
                                                       lens),
                    sdpa(q, kd, vd, vmask))
        row("paged_decode_attention", label, paged_calls,
            bound_ms(4 * live * h * k_,
                     2 * live * hkv * k_ * 2 + 2 * B * h * k_ * 2
                     + B * nblk * 4, "bfloat16"),
            f"B={B} bs={bs} nblk={nblk} H={h} Hkv={hkv} K={k_} live={depth}"
            " (bitwise the dense kernel over the gathered view)")

        # the int8 pair at the same shape: int8 codes and float32 scales
        # by the model's quantiser under q in f32 / bf16; the yardstick
        # is sdpa over the dequantised view in q's dtype
        def dense8_calls(dtype):
            q = randn(B, h, k_, dtype=dtype)
            kq, ks = quant(randn(B, W, hkv, k_, dtype=torch.float32))
            vq, vs = quant(randn(B, W, hkv, k_, dtype=torch.float32))
            got = da.decode_attention_int8(q, kq, vq, valid, ks, vs)
            kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
            ks2[~valid], vs2[~valid] = float("nan"), float("nan")
            kq2[~valid], vq2[~valid] = 127, -127
            poisoned = da.decode_attention_int8(q, kq2, vq2, valid, ks2, vs2)
            if not (torch.equal(got, poisoned)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"decode_attention_int8 {label} {dtype}: output moved "
                     "with NaN scales in dead slots")
            kf = (kq.float() * ks[..., None]).to(dtype)
            vf = (vq.float() * vs[..., None]).to(dtype)
            return (lambda: da.decode_attention_int8(q, kq, vq, valid, ks,
                                                     vs),
                    lambda: ref.decode_attention(q, kq, vq, valid,
                                                 k_scale=ks, v_scale=vs),
                    sdpa(q, kf, vf, valid))
        row("decode_attention_int8", label, dense8_calls,
            bound_ms(4 * live * h * k_ + 2 * live * hkv * k_,
                     2 * live * hkv * (k_ + 4) + 2 * B * h * k_ * 2 + B * W,
                     "bfloat16"),
            shape + " int8 K/V (dead slots' NaN scales ignored)",
            library="sdpa over the dequantised view")

        def paged8_calls(dtype):
            q, kp, vp, table, lens, unowned = paged_case(
                gen, depth, h=h, hkv=hkv, k=k_, bs=bs, nblk=nblk,
                dtype=torch.float32)
            q = q.to(dtype)
            kq, ks = quant(kp)
            vq, vs = quant(vp)
            kd, vd, vmask = gathered(kq, vq, table, lens)
            ksd, vsd, _ = gathered(ks, vs, table, lens)
            got = pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table,
                                                 lens)
            if not torch.equal(got, da.decode_attention_int8(
                    q, kd, vd, vmask, ksd, vsd)):
                fail(f"paged_decode_attention_int8 {label} {dtype}: not "
                     "bitwise the dense int8 kernel over the gathered view")
            kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
            ks2[unowned], vs2[unowned] = float("nan"), float("nan")
            kq2[unowned], vq2[unowned] = 127, -127
            poisoned = pa.paged_decode_attention_int8(q, kq2, vq2, ks2, vs2,
                                                      table, lens)
            if not (torch.equal(got, poisoned)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"paged_decode_attention_int8 {label} {dtype}: output "
                     "moved with NaN in unowned pages or scale pages")
            kf = (kd.float() * ksd[..., None]).to(dtype)
            vf = (vd.float() * vsd[..., None]).to(dtype)
            return (lambda: pa.paged_decode_attention_int8(
                        q, kq, vq, ks, vs, table, lens),
                    lambda: ref.paged_decode_attention(
                        q, kq, vq, table, lens, k_scale_pages=ks,
                        v_scale_pages=vs),
                    sdpa(q, kf, vf, vmask))
        row("paged_decode_attention_int8", label, paged8_calls,
            bound_ms(4 * live * h * k_ + 2 * live * hkv * k_,
                     2 * live * hkv * (k_ + 4) + 2 * B * h * k_ * 2
                     + B * nblk * 4, "bfloat16"),
            f"B={B} bs={bs} nblk={nblk} H={h} Hkv={hkv} K={k_} live={depth}"
            " int8 pages (bitwise the dense int8 kernel over the gathered "
            "view; NaN in unowned pages and scale pages ignored)",
            library="sdpa over the dequantised view")

    m = ZAMBA_SSD

    def ssd_calls(dtype):
        args = ssd_inputs(gen, m["B"], m["S"], m["nh"], m["hd"], m["ng"],
                          m["ds"], dtype)
        return (lambda: ssd.ssd_scan(*args, chunk=m["chunk"]),
                lambda: ref.ssd_scan(*args, chunk=m["chunk"]), None)

    def ssd_both(got, want, dn, what):
        return max(ssd_close(a, b, dn, f"{what} {n}")
                   for n, a, b in zip(("y", "state"), got, want))
    dn = "bfloat16"
    row("ssd_scan", "zamba", ssd_calls,
        ssd_bound(*(m[k] for k in ("B", "S", "nh", "hd", "ng", "ds")),
                  dn, 2),
        f"B={m['B']} S={m['S']} nh={m['nh']} hd={m['hd']} ng={m['ng']} "
        f"ds={m['ds']} chunk={m['chunk']} (max_abs_err: max |kernel - "
        "plain| / max|plain| over y and the state)", close=ssd_both,
        library="none: no PyTorch call computes the SSD scan")

    for label, D in NEW_NORMS.items():
        def norm_calls(dtype, D=D):
            x = randn(1, 512, D, dtype=dtype)
            scale = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)
                     ).to(dtype)
            return (lambda: rn.rmsnorm(x, scale, RMS_EPS),
                    lambda: ref.rmsnorm(x, scale, RMS_EPS),
                    lambda: F.rms_norm(x, (D,), weight=scale, eps=RMS_EPS))
        row("rmsnorm", label, norm_calls,
            rmsnorm_bound([(512, D)], dn, 2, 2),
            f"x=(1, 512, {D}), scale ({D},)", library="F.rms_norm")
    return out


# whisper-large-v3's shapes (phase 16; 20 heads of 64, G = 1): the
# encoder's self attention over its 1500 frames and the cross attention at
# prefill (a 64-token bucket of 4 prompts against the 1500-row memory),
# both not causal and run in float32 as the frames are; the decoder's
# causal self attention at prefill (3 prompts in a 256-token bucket) in
# the model's dtype; the cross decode of 4 rows over the wholly valid
# memory (23 splits of 64 and one of 28); the self decode over the
# 448-position horizon, rows live on both sides of the 64-position split
# edges, over the dense ring and the pages
WHISPER_FLASH = {
    "whisper_encoder": dict(B=1, Sq=1500, Skv=1500, causal=False,
                            timed="float32"),
    "whisper_cross_prefill": dict(B=4, Sq=64, Skv=1500, causal=False,
                                  timed="float32"),
    "whisper_self_prefill": dict(B=3, Sq=256, Skv=256, causal=True,
                                 timed="bfloat16")}
WHISPER_HEADS = dict(H=20, Hkv=20, K=64)
WHISPER_MEM = dict(B=4, W=1500)
WHISPER_SELF = dict(W=448, depth=[63, 65, 129, 448])


def whisper_shape_checks(gen) -> dict:
    """The prefill, dense and paged decode kernels at whisper-large-v3's
    shapes (WHISPER_FLASH, WHISPER_MEM, WHISPER_SELF at WHISPER_HEADS),
    each held against its plain version in float32 (2e-5) and bfloat16
    (2e-2), the paged kernel bit for bit the dense one over the gathered
    view; then timed in the dtype the path runs them in (float32 for the
    encoder and the cross prefill, bfloat16 for the decoder's causal
    prefill and for decode) as device time (100 calls
    replayed from a CUDA graph) beside the plain version and sdpa, with
    the shape's bound. Returns {kernel: {label: row}}."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    h, hkv, k_ = (WHISPER_HEADS[n] for n in ("H", "Hkv", "K"))

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def sdpa(q, k, v, valid):
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=valid[:, None, None, :], enable_gqa=True)

    out: dict = {}

    def row(name, label, calls, bound, shape, timed):
        """``calls(dtype)`` gives (kernel, plain, library); ``bound(dn)``
        the bound; timed in ``timed``."""
        errs, times = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            k_call, p_call, lib = calls(dtype)
            got = k_call()
            torch.cuda.synchronize()
            errs[dn] = check_close(got, p_call(), dn, f"{name} {label} {dn}")
            print(f"{name} {label} {dn} {shape}: max_abs_err="
                  f"{errs[dn]:.3e}", flush=True)
            if dtype == timed:
                b = bound(dn)
                times = {"ms": time_graph_ms(k_call),
                         "plain_ms": time_ms(p_call, reps=3),
                         "library_ms": time_graph_ms(lib),
                         "bound_ms": b[0], "bound_by": b[1]}
                if len(b) > 2:
                    times["bound_cuda_cores_ms"] = b[2]
        tn = str(timed).split(".")[1]
        out.setdefault(name, {})[label] = {
            "max_abs_err": errs[tn], "max_abs_err_by_dtype": errs, **times,
            "shape": f"{shape}; timed in {tn}: ms and library_ms device "
                     "time (100 calls replayed from a CUDA graph), plain_ms "
                     "launched one by one (CUDA events); library_ms is sdpa"}

    for label, f in WHISPER_FLASH.items():
        B, Sq, Skv, causal = f["B"], f["Sq"], f["Skv"], f["causal"]
        # query-key pairs the mask keeps
        pairs = (int(ref.attention_mask(Sq, Skv, causal=True, window=0,
                                        device=dev).sum())
                 if causal else Sq * Skv)

        def flash_calls(dtype, B=B, Sq=Sq, Skv=Skv, causal=causal):
            q = randn(B, Sq, h, k_, dtype=dtype)
            k, v = (randn(B, Skv, hkv, k_, dtype=dtype) for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            return (lambda: fa.flash_attention(q, k, v, causal=causal),
                    lambda: ref.flash_attention(q, k, v, causal=causal),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal))

        def flash_bound(dn, B=B, Sq=Sq, Skv=Skv, pairs=pairs):
            isz = 4 if dn == "float32" else 2
            flops = 4 * B * h * pairs * k_
            nbytes = 2 * B * (Sq * h + Skv * hkv) * k_ * isz
            if dn == "float32":
                return f32_split_bound(flops, nbytes)
            return bound_ms(flops, nbytes, dn)
        row("flash_attention", label, flash_calls, flash_bound,
            f"B={B} Sq={Sq} Skv={Skv} H={h} Hkv={hkv} K=Kv={k_} "
            + ("causal" if causal else "not causal"),
            getattr(torch, f["timed"]))

    B, W = WHISPER_MEM["B"], WHISPER_MEM["W"]

    def cross_calls(dtype):
        q = randn(B, h, k_, dtype=dtype)
        k, v = (randn(B, W, hkv, k_, dtype=dtype) for _ in range(2))
        valid = torch.ones(B, W, dtype=torch.bool, device=dev)
        return (lambda: ops.decode_cross_attention(q, k, v, valid),
                lambda: ref.decode_attention(q, k, v, valid),
                sdpa(q, k, v, valid))

    def cross_bound(dn):
        return bound_ms(4 * B * W * h * k_,
                        2 * B * W * hkv * k_ * 2 + 2 * B * h * k_ * 2 + B * W,
                        dn)
    row("decode_attention", "whisper_cross", cross_calls, cross_bound,
        f"B={B} W={W} H={h} Hkv={hkv} K={k_} all valid "
        "(ops.decode_cross_attention)", torch.bfloat16)

    W, depth = WHISPER_SELF["W"], WHISPER_SELF["depth"]
    B, live, bs = len(depth), sum(depth), 16
    nblk = W // bs
    valid = (torch.arange(W, device=dev)[None, :]
             < torch.tensor(depth, device=dev)[:, None])

    def self_calls(dtype):
        q = randn(B, h, k_, dtype=dtype)
        k, v = (randn(B, W, hkv, k_, dtype=dtype) for _ in range(2))
        return (lambda: da.decode_attention(q, k, v, valid),
                lambda: ref.decode_attention(q, k, v, valid),
                sdpa(q, k, v, valid))

    def self_bound(dn, table_bytes=B * W):
        return bound_ms(4 * live * h * k_,
                        2 * live * hkv * k_ * 2 + 2 * B * h * k_ * 2
                        + table_bytes, dn)
    shape = f"B={B} W={W} H={h} Hkv={hkv} K={k_} live={depth}"
    row("decode_attention", "whisper_self", self_calls, self_bound, shape,
        torch.bfloat16)

    def paged_calls(dtype):
        q, kp, vp, table, lens, _ = paged_case(
            gen, depth, h=h, hkv=hkv, k=k_, bs=bs, nblk=nblk, dtype=dtype)
        kd, vd, vmask = gathered(kp, vp, table, lens)
        if not torch.equal(pa.paged_decode_attention(q, kp, vp, table, lens),
                           da.decode_attention(q, kd, vd, vmask)):
            fail(f"paged_decode_attention whisper_self {dtype}: not bitwise "
                 "the dense kernel over the gathered view")
        return (lambda: pa.paged_decode_attention(q, kp, vp, table, lens),
                lambda: ref.paged_decode_attention(q, kp, vp, table, lens),
                sdpa(q, kd, vd, vmask))
    row("paged_decode_attention", "whisper_self", paged_calls,
        lambda dn: self_bound(dn, B * nblk * 4), f"B={B} bs={bs} nblk={nblk}"
        f" H={h} Hkv={hkv} K={k_} live={depth} (bitwise the dense kernel "
        "over the gathered view)", torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# phase 2: the backward kernels (training), float32
# ---------------------------------------------------------------------------
BWD_TOL = 5e-5      # tests/test_kernels.py's grad tolerance, abs + rel
# (name, B, S, H, Hkv, K, Kv, causal, window, softcap): qwen3-0.6b's
# training batch (the line's shape), gemma3-27b's local window, MLA's
# K 192 / Kv 128, whisper's encoder, a ragged softcapped tail
FLASH_BWD = [("qwen3_train", 8, 512, 16, 8, 128, 128, True, 0, 0.0),
             ("gemma_local", 1, 1300, 32, 16, 128, 128, True, 1024, 0.0),
             ("mla", 1, 512, 16, 16, 192, 128, True, 0, 0.0),
             ("whisper_encoder", 1, 1500, 20, 20, 64, 64, False, 0, 0.0),
             ("ragged_softcap", 2, 40, 16, 8, 128, 128, True, 0, 5.0)]
# (rows, D): qwen3-0.6b's block norm over a 4096-token batch; its q/k
# norms over the same batch as one pair launch
RMS_BWD_MAIN = (4096, 1024)
RMS_BWD_PAIR = ((4096 * 16, 128), (4096 * 8, 128))


def check_bwd(got, want, what: str, dtype_name: str = "float32") -> float:
    """float32: |got - want| <= tol + tol * max|want| with tol BWD_TOL (a
    gradient's scale is its tensor's, so the relative part is against
    the largest element); bfloat16: |got - want| <= TOL * max|want| (the
    outputs' bf16 rounding, every sum float32)."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: kernel output is not finite")
    err = float((g - w).abs().max())
    scale = float(w.abs().max())
    bound = (BWD_TOL + BWD_TOL * scale if dtype_name == "float32"
             else TOL[dtype_name] * scale)
    if err > bound:
        fail(f"{what}: max abs error {err:.3e} over {bound:.3e}")
    return err


def _sdpa_call(q, k, v, causal, window, softcap, grad):
    """sdpa on (q, k, v)'s values in its own layout, with the flash
    kernels' mask, and the (B, H, S, .) inputs; None where sdpa cannot
    compute the same function (a softcap)."""
    import torch.nn.functional as F
    if softcap:
        return None, None
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(grad)
                  for t in (q, k, v))
    mask = None
    if window:
        from repro_torch.kernels import ref
        mask = ref.attention_mask(q.shape[1], k.shape[1], causal=causal,
                                  window=window, device=q.device)

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=q.shape[2] != k.shape[2])
    return call, (qt, kt, vt)


def sdpa_forward(q, k, v, causal, window, softcap):
    """One ``scaled_dot_product_attention`` forward on the same inputs, or
    None with the reason where sdpa cannot compute the same function. A
    yardstick only: the port never calls sdpa."""
    call, _ = _sdpa_call(q, k, v, causal, window, softcap, False)
    if call is None:
        return None, "sdpa has no softcap"
    try:
        call()
    except RuntimeError as e:
        return None, f"sdpa refused: {str(e).splitlines()[0][:120]}"
    return call, f"sdpa forward ({str(q.dtype).split('.')[1]})"


def sdpa_backward(q, k, v, dout, causal, window, softcap):
    """One ``scaled_dot_product_attention`` backward through autograd on
    the same inputs (the forward run once before timing), or None with
    the reason where sdpa cannot compute the same function (a softcap).
    A yardstick only: the port never calls sdpa."""
    call, leaves = _sdpa_call(q, k, v, causal, window, softcap, True)
    if call is None:
        return None, "sdpa has no softcap"
    dt = dout.transpose(1, 2).contiguous()
    try:
        out = call()
        fn = lambda: torch.autograd.grad(out, leaves, dt,  # noqa: E731
                                         retain_graph=True)
        fn()
    except RuntimeError as e:
        return None, f"sdpa refused: {str(e).splitlines()[0][:120]}"
    return fn, "sdpa backward (autograd, forward excluded)"


def rms_norm_backward(xs, scales, grads):
    """``torch.nn.functional.rms_norm``'s backward through autograd on each
    (x, scale, output gradient), a yardstick the port never calls: the
    forwards run once here on a stream of their own, where the backwards
    then run and are captured. Returns (call, stream)."""
    import torch.nn.functional as F
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        done = []
        for x, s, g in zip(xs, scales, grads):
            xr = x.clone().requires_grad_(True)
            sr = s.clone().requires_grad_(True)
            done.append((F.rms_norm(xr, (x.shape[1],), weight=sr,
                                    eps=RMS_EPS), (xr, sr), g))

    def call():
        return [torch.autograd.grad(y, leaves, g, retain_graph=True)
                for y, leaves, g in done]
    return call, stream


def backward_checks(gen, dtype=None) -> dict:
    """The two backward kernels against their plain versions on the card,
    in ``dtype`` (float32 by default; bfloat16 takes the bf16 bodies):
    ``flash_attention_bwd`` at FLASH_BWD (with the forward's lse;
    the forward's out bit for bit with its lse pointer set and null) and
    ``rmsnorm_bwd`` at RMS_BWD_MAIN and the RMS_BWD_PAIR pair (one
    call; each tensor's dx and dscale bit for bit its own call's), at
    ``check_bwd``'s tolerance. Each
    timed launched one by one (card ms) and replayed from a CUDA graph
    (device ms), beside its bound, its plain version and the library's
    backward through autograd (for the norm also from a graph, captured
    on its forward's stream). The forward with its lse
    (what training runs) is timed at each FLASH_BWD shape too, as device
    ms beside its bound and sdpa's forward. Returns the line's
    rows, the forward's under "flash_attention_train_forward"."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    dtype = dtype or torch.float32
    dn = str(dtype).split(".")[1]
    isz = dtype.itemsize
    tag = "f32" if dn == "float32" else "bf16"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def bounds(flops, nbytes):
        """(bound_ms, bound_by, the CUDA cores' bound or None): float32
        runs its products as split TF32, bfloat16 on the tensor cores at
        the bf16 peak"""
        if dn == "float32":
            return f32_split_bound(flops, nbytes)
        return (*bound_ms(flops, nbytes, dn), None)

    rows, forward = {}, {}
    for name, B, S, H_, Hkv, K_, Kv, causal, window, cap in FLASH_BWD:
        q, k, v = randn(B, S, H_, K_), randn(B, S, Hkv, K_), randn(B, S, Hkv, Kv)
        dout = randn(B, S, H_, Kv)
        kw = dict(causal=causal, window=window, softcap=cap)
        served = fa.flash_attention(q, k, v, **kw)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        if not torch.equal(served, out):
            fail(f"flash_attention {name}: out differs with the lse pointer "
                 "set")
        ro, rl = ref.flash_attention_lse(q, k, v, **kw)
        what = f"flash_attention_bwd {name}"
        fwd_err = check_close(out, ro, dn, f"{what} {tag} forward")
        check_bwd(lse, rl, f"{what} {tag} lse")
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_bwd(q, k, v, ro, rl, dout, **kw)
        err = max(check_bwd(g, w, f"{what} {tag} {n}", dn)
                  for g, w, n in zip(got, want, ("dq", "dk", "dv")))
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{what} {tag}: two calls gave other bits")
        pairs = B * H_ * int(ref.attention_mask(S, S, causal=causal,
                                                window=window,
                                                device=dev).sum())
        nbytes = (isz * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                         + 2 * out.numel()) + 4 * lse.numel())
        bound, by, cores = bounds(2 * pairs * (3 * K_ + 2 * Kv), nbytes)
        del want, again, ro, rl

        # the forward with its lse: q, k, v read, out and lse written
        f_bound, f_by, f_cores = bounds(
            2 * pairs * (K_ + Kv),
            isz * (q.numel() + k.numel() + v.numel() + out.numel())
            + 4 * lse.numel())
        lib_f, lib_f_note = sdpa_forward(q, k, v, **kw)
        fkey = f"train_{name}" if dn == "float32" else f"train_bf16_{name}"
        forward[fkey] = {
            "max_abs_err": fwd_err,
            "ms": time_graph_ms(lambda: fa.flash_attention(
                q, k, v, return_lse=True, **kw), reps=20),
            "bound_ms": f_bound, "bound_by": f_by,
            "bound_cuda_cores_ms": f_cores,
            "library_ms": None if lib_f is None else time_graph_ms(
                lib_f, reps=20),
            "library": lib_f_note,
            "shape": f"B={B} S={S} H={H_} Hkv={Hkv} K={K_} Kv={Kv} "
                     f"causal={causal} window={window} softcap={cap} {tag} "
                     "with its lse (training's forward); ms and library_ms "
                     "device time (replayed from a CUDA graph)"}
        print(f"flash_attention train forward {name} {tag}: "
              f"{forward[fkey]}", flush=True)

        def kernel():
            return fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)

        def plain():
            return ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        lib, lib_note = sdpa_backward(q, k, v, dout, **kw)
        row = {"max_abs_err": err, "ms": time_ms(kernel, reps=10),
               "graph_ms": time_graph_ms(kernel, reps=10),
               "plain_ms": time_ms(plain, reps=2),
               "bound_ms": bound, "bound_by": by,
               "bound_cuda_cores_ms": cores,
               "library_ms": None if lib is None else time_ms(lib, reps=10),
               "library": lib_note,
               "shape": f"B={B} S={S} H={H_} Hkv={Hkv} K={K_} Kv={Kv} "
                        f"causal={causal} window={window} softcap={cap} "
                        f"{tag}"}
        rows[name] = row
        print(f"{what} {tag}: {row}", flush=True)
        del q, k, v, dout, out, lse, got, served
        torch.cuda.empty_cache()
    flash = dict(rows.pop("qwen3_train"))
    flash["shapes"] = rows
    flash["shape"] += (
        "; ms and library_ms launched one by one (CUDA events), graph_ms "
        "replayed from a CUDA graph; bound 2 * visible pairs * (3K + 2Kv) "
        "operations at the split-TF32 rate (3 x operations at 494.7 "
        "TFLOP/s), bound_cuda_cores_ms at 67 TFLOP/s f32"
        if dn == "float32" else
        "; ms and library_ms launched one by one (CUDA events), graph_ms "
        "replayed from a CUDA graph; bound the larger of 2 * visible pairs "
        "* (3K + 2Kv) operations at 989 TFLOP/s and the bytes (q, k, v, "
        "out, dout, lse read, dq, dk, dv written) at 3.35 TB/s")

    def rms_case(shapes):
        xs = [randn(r, D) for r, D in shapes]
        ss = [1 + 0.1 * randn(D) for _, D in shapes]
        gs = [randn(r, D) for r, D in shapes]
        return xs, ss, gs

    results = {}
    (x,), (sc,), (g,) = rms_case([RMS_BWD_MAIN])
    dx, ds = rn.rmsnorm_bwd(x, sc, g, RMS_EPS)
    torch.cuda.synchronize()
    rx, rs = ref.rmsnorm_bwd(x, sc, g, RMS_EPS)
    err = max(check_bwd(dx, rx, f"rmsnorm_bwd {tag} dx", dn),
              check_bwd(ds, rs, f"rmsnorm_bwd {tag} dscale", dn))
    again = rn.rmsnorm_bwd(x, sc, g, RMS_EPS)
    if not (torch.equal(dx, again[0]) and torch.equal(ds, again[1])):
        fail(f"rmsnorm_bwd {tag}: two calls gave other bits")

    def kernel():
        return rn.rmsnorm_bwd(x, sc, g, RMS_EPS)
    library, lib_stream = rms_norm_backward([x], [sc], [g])
    rows_, D = RMS_BWD_MAIN
    bound, by = bound_ms(6 * rows_ * D, isz * (3 * rows_ * D + 2 * D), dn)
    results["rmsnorm_bwd"] = {
        "max_abs_err": err, "ms": time_ms(kernel, reps=20),
        "graph_ms": time_graph_ms(kernel, reps=20),
        "plain_ms": time_ms(lambda: ref.rmsnorm_bwd(x, sc, g, RMS_EPS),
                            reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(library, reps=20),
        "library_graph_ms": time_graph_ms(library, reps=20,
                                          stream=lib_stream),
        "shape": f"x=({rows_}, {D}) {tag}, scale ({D},) {tag}: "
                 "qwen3-0.6b's block norm over a 4096-token batch; library is "
                 "torch.nn.functional.rms_norm's backward (autograd, "
                 "forward excluded); graph_ms and library_graph_ms "
                 "replayed from a CUDA graph"}
    xs, ss, gs = rms_case(RMS_BWD_PAIR)
    (dq, dsq), (dk, dsk) = rn.rmsnorm_pair_bwd(xs[0], ss[0], gs[0], xs[1],
                                               ss[1], gs[1], RMS_EPS)
    torch.cuda.synchronize()
    err = 0.0
    for got, (x_, s_, g_), n in (((dq, dsq), (xs[0], ss[0], gs[0]), "q"),
                                 ((dk, dsk), (xs[1], ss[1], gs[1]), "k")):
        want = ref.rmsnorm_bwd(x_, s_, g_, RMS_EPS)
        solo = rn.rmsnorm_bwd(x_, s_, g_, RMS_EPS)
        err = max(err,
                  check_bwd(got[0], want[0], f"rmsnorm_bwd {tag} pair d{n}",
                            dn),
                  check_bwd(got[1], want[1],
                            f"rmsnorm_bwd {tag} pair ds{n}", dn))
        if not torch.equal(got[0], solo[0]):
            fail(f"rmsnorm_bwd {tag} pair: {n}'s dx differs from its own "
                 "launch")
        if not torch.equal(got[1], solo[1]):
            fail(f"rmsnorm_bwd {tag} pair: {n}'s dscale differs from its "
                 "own launch")
    n_el = sum(r * D_ for r, D_ in RMS_BWD_PAIR)

    def pair():
        return rn.rmsnorm_pair_bwd(xs[0], ss[0], gs[0], xs[1], ss[1], gs[1],
                                   RMS_EPS)
    library, lib_stream = rms_norm_backward(xs, ss, gs)
    bound, by = bound_ms(6 * n_el, isz * (3 * n_el + 4 * 128), dn)
    results["rmsnorm_bwd"]["pair"] = {
        "max_abs_err": err, "ms": time_ms(pair, reps=20),
        "graph_ms": time_graph_ms(pair, reps=20), "bound_ms": bound,
        "bound_by": by, "library_ms": time_ms(library, reps=20),
        "library_graph_ms": time_graph_ms(library, reps=20,
                                          stream=lib_stream),
        "shape": f"q {RMS_BWD_PAIR[0]} and k {RMS_BWD_PAIR[1]} {tag}, one "
                 "call (qwen3-0.6b's q/k norms over a 4096-token batch); "
                 "the library backward once for each tensor"}
    results["flash_attention_bwd"] = flash
    results["flash_attention_train_forward"] = forward
    print(f"rmsnorm_bwd {tag}: {results['rmsnorm_bwd']}", flush=True)
    return results


# the SSD scan's backward (float32): (name, B, S, nh, hd, ng, ds, chunk) at
# mamba2-2.7b's training widths (the line's shape: phase 18e's batch, the
# caller's chunk 256), zamba2-7b's, and a ragged case whose last 64-position
# cut is padded (S 96) with two groups, 16 head rows and ds 24
SSD_BWD = [("mamba2_train", 2, 512, 80, 64, 1, 128, 256),
           ("zamba2", 1, 512, 112, 64, 1, 64, 256),
           ("ragged", 2, 96, 4, 16, 2, 24, 32)]
# each gradient within this share of its max|plain| at the caller's chunk
# (the cut moves where the decays' running sums round, as the forward's
# SSD_TOL notes); element by element, BWD_TOL abs + rel, at the kernel's
# own 64-position cut
SSD_BWD_CUT_TOL = 1e-4
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def ssd_bwd_bound(B, S, nh, hd, ng, ds, with_state: bool):
    """x, dy, dt, B and C (and dstate) read once, dx, ddt, dB and dC
    written once (A, D, dA, dD: nh each); the operations of the backward
    at the kernel's 64-position cut: per batch row and cut, C.B^T on the
    lower triangle once per group; per head, dy.x^T and the three
    quadratic products (dx, dB, dC) on it, and five (hd x ds) products a
    position (the state recomputed, dS.B, x^T.dS, dy^T.S_c, the dS
    update). Operations at the split-TF32 rate the kernels run them
    (``f32_split_bound``); returns (ms, what bounds it, ms at the CUDA
    cores' 67 TFLOP/s)."""
    nc = -(-S // SSD_TILE)
    pairs = SSD_TILE * (SSD_TILE + 1) // 2
    per_head = 4 * pairs * hd + 4 * pairs * ds + 10 * SSD_TILE * hd * ds
    flops = B * nc * (nh * per_head + ng * 2 * pairs * ds)
    nbytes = 4 * (3 * B * S * nh * hd + 2 * B * S * nh + 4 * B * S * ng * ds
                  + 4 * nh + (B * nh * hd * ds if with_state else 0))
    return f32_split_bound(flops, nbytes)


def ssd_bwd_checks(gen) -> dict:
    """``ssd_scan_bwd`` against ``ref.ssd_scan_bwd`` on the card at
    SSD_BWD, each with and without a gradient of the final state: every
    gradient element by element within BWD_TOL abs + rel of max|plain| at
    the kernel's own 64-position cut (where 64 divides S), within
    SSD_BWD_CUT_TOL of max|plain| at the caller's chunk, finite, and bit
    for bit from run to run; once against torch autograd through
    ``ref.ssd_scan`` (what the plain path would train through), at the
    same tolerance. Timed at the line's shape (no dstate, as training
    calls it) launched one by one and replayed from a CUDA graph, beside
    its bound and the plain version (no library: no PyTorch call computes
    the scan); the float32 forward it trains beside, at the same shape,
    the same way. Returns the line's row, the forward's under
    "ssd_scan_train_forward"."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")
    f32 = torch.float32
    worst = {"cut": 0.0, "chunk": 0.0}
    row = forward = None
    for name, B, S, nh, hd, ng, ds, chunk in SSD_BWD:
        args = ssd_inputs(gen, B, S, nh, hd, ng, ds, f32)
        dy = torch.randn(B, S, nh, hd, generator=gen, device=dev)
        dstate = torch.randn(B, nh, hd, ds, generator=gen, device=dev)
        for st in (dstate, None):
            what = (f"ssd_scan_bwd {name} B={B} S={S} nh={nh} hd={hd} "
                    f"ng={ng} ds={ds} chunk={chunk} "
                    f"{'with' if st is not None else 'without'} dstate")
            got = ssd.ssd_scan_bwd(*args, dy, st, chunk=chunk)
            torch.cuda.synchronize()
            again = ssd.ssd_scan_bwd(*args, dy, st, chunk=chunk)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{what}: two calls gave other bits")
            del again
            cut = ""
            if S % SSD_TILE == 0:
                want = ref.ssd_scan_bwd(*args, dy, st, chunk=SSD_TILE)
                err = max(check_bwd(g, w, f"{what} {n} at chunk {SSD_TILE}")
                          / max(float(w.abs().max()), 1e-30)
                          for g, w, n in zip(got, want, SSD_GRADS))
                worst["cut"] = max(worst["cut"], err)
                cut = (f"element by element at chunk {SSD_TILE}: max abs "
                       f"error / max|plain| {err:.3e} (within {BWD_TOL} abs "
                       "+ rel); ")
            want = ref.ssd_scan_bwd(*args, dy, st, chunk=chunk)
            rel = {}
            for g, w, n in zip(got, want, SSD_GRADS):
                if not bool(torch.isfinite(g).all()):
                    fail(f"{what}: {n} is not finite")
                rel[n] = float((g - w).abs().max()) / max(
                    float(w.abs().max()), 1e-30)
                if rel[n] > SSD_BWD_CUT_TOL:
                    fail(f"{what}: {n} differs from the plain version at "
                         f"chunk {chunk} by {rel[n]:.3e} of max|plain|, "
                         f"over {SSD_BWD_CUT_TOL}")
            worst["chunk"] = max(worst["chunk"], *rel.values())
            print(f"{what}: {cut}at chunk {chunk} max|err| / max|plain| "
                  + " ".join(f"{n} {e:.3e}" for n, e in rel.items())
                  + "; bit for bit run to run", flush=True)
            if name == "mamba2_train" and st is None:
                bound, by, cores = ssd_bwd_bound(B, S, nh, hd, ng, ds,
                                                 False)

                def kernel():
                    return ssd.ssd_scan_bwd(*args, dy, None, chunk=chunk)
                launched, scratch = ssd_call_footprint(kernel)
                check_kernels_per_call("ssd_scan_bwd", launched,
                                       SSD_BWD_KERNELS_PER_CALL)
                f_launched, f_scratch = ssd_call_footprint(
                    lambda: ssd.ssd_scan(*args, chunk=chunk))
                check_kernels_per_call("ssd_scan float32", f_launched,
                                       SSD_KERNELS_PER_CALL)
                row = {"max_abs_err": max(float((g - w).abs().max())
                                          for g, w in zip(got, want)),
                       "cuda_kernels": launched, "scratch_bytes": scratch,
                       "ms": time_ms(kernel, reps=10),
                       "graph_ms": time_graph_ms(kernel, reps=10),
                       "plain_ms": time_ms(lambda: ref.ssd_scan_bwd(
                           *args, dy, None, chunk=chunk), reps=2),
                       "bound_ms": bound, "bound_by": by,
                       "bound_cuda_cores_ms": cores, "library_ms": None}
                f_bound, f_by, f_cores = ssd_bound(B, S, nh, hd, ng, ds,
                                                   "float32", 4)
                fwd = ref.ssd_scan(*args, chunk=chunk)
                forward = {
                    "max_abs_err": max(
                        float((g - w).abs().max()) for g, w in
                        zip(ssd.ssd_scan(*args, chunk=chunk), fwd)),
                    "ms": time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk),
                                  reps=10),
                    "graph_ms": time_graph_ms(
                        lambda: ssd.ssd_scan(*args, chunk=chunk), reps=10),
                    "plain_ms": time_ms(lambda: ref.ssd_scan(
                        *args, chunk=chunk), reps=2),
                    "bound_ms": f_bound, "bound_by": f_by,
                    "bound_cuda_cores_ms": f_cores,
                    "cuda_kernels": f_launched, "scratch_bytes": f_scratch,
                    "shape": f"B={B} S={S} nh={nh} hd={hd} ng={ng} ds={ds} "
                             f"chunk={chunk} f32 (model-like dt, A): the "
                             "forward phase 18e trains through; ms launched "
                             "one by one, graph_ms replayed from a CUDA "
                             "graph"}
                del fwd
            del got, want
        del args, dy, dstate
        torch.cuda.empty_cache()

    # once against torch autograd through the plain forward
    B, S, nh, hd, ng, ds, chunk = 2, 256, 16, 64, 1, 128, 128
    args = ssd_inputs(gen, B, S, nh, hd, ng, ds, f32)
    dy = torch.randn(B, S, nh, hd, generator=gen, device=dev)
    dstate = torch.randn(B, nh, hd, ds, generator=gen, device=dev)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, state = ref.ssd_scan(*leaves, chunk=chunk)
    want = torch.autograd.grad([y, state], leaves, [dy, dstate])
    got = ssd.ssd_scan_bwd(*args, dy, dstate, chunk=chunk)
    err = 0.0
    for g, w, n in zip(got, want, SSD_GRADS):
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if not bool(torch.isfinite(g).all()) or rel > SSD_BWD_CUT_TOL:
            fail(f"ssd_scan_bwd against autograd of ref.ssd_scan: {n} "
                 f"differs by {rel:.3e} of max|autograd| (over "
                 f"{SSD_BWD_CUT_TOL}?)")
        err = max(err, rel)
    print(f"ssd_scan_bwd B={B} S={S} nh={nh} hd={hd} ds={ds} chunk={chunk} "
          f"against torch autograd of ref.ssd_scan: max|err| / "
          f"max|autograd| {err:.3e}", flush=True)
    m = SSD_BWD[0]
    row["shape"] = (f"B={m[1]} S={m[2]} nh={m[3]} hd={m[4]} ng={m[5]} "
                    f"ds={m[6]} chunk={m[7]} f32, no dstate (phase 18e's "
                    "call; model-like dt, A); worst over the phase-2 cases: "
                    f"element by element at chunk 64 {worst['cut']:.3e}, at "
                    f"the caller's chunk {worst['chunk']:.3e} of max|plain|, "
                    f"against autograd {err:.3e}; ms launched one by one "
                    "(CUDA events), graph_ms replayed from a CUDA graph; "
                    "bound by ssd_bwd_bound (split TF32; "
                    "bound_cuda_cores_ms at 67 TFLOP/s); cuda_kernels and "
                    "scratch_bytes: one call's, read on the card; "
                    "library_ms null: no PyTorch "
                    "call computes the SSD scan")
    print(f"ssd_scan_bwd: {row}", flush=True)
    print(f"ssd_scan train forward: {forward}", flush=True)
    return {"ssd_scan_bwd": row, "ssd_scan_train_forward": forward}


def kernel_phase():
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # (B, Sq, Skv, window, softcap)
        for B, Sq, Skv, window, softcap in [
                (1, 16, 16, 0, 0.0), (2, 100, 100, 0, 0.0),
                (1, 512, 512, 0, 0.0), (1, 2048, 2048, 0, 0.0),
                (1, 128, 640, 0, 0.0), (1, 512, 512, 128, 0.0),
                (1, 512, 512, 0, 30.0)]:
            q = randn(B, Sq, H, K, dtype=dtype)
            k = randn(B, Skv, HKV, K, dtype=dtype)
            v = randn(B, Skv, HKV, K, dtype=dtype)
            kw = dict(causal=True, window=window, softcap=softcap)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, **kw)
            what = (f"flash_attention {dn} B={B} Sq={Sq} Skv={Skv} "
                    f"window={window} softcap={softcap}")
            err = check_close(got, want, dn, what)
            ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
            plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, **kw),
                               reps=5)
            print(f"{what}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}", flush=True)
        for B in (1, 4):
            W = 2048
            q = randn(B, H, K, dtype=dtype)
            k = randn(B, W, HKV, K, dtype=dtype)
            v = randn(B, W, HKV, K, dtype=dtype)
            valid = torch.rand(B, W, generator=gen, device=dev) < 0.7
            if B > 1:
                valid[-1] = False            # a row with no live slot
            got = da.decode_attention(q, k, v, valid)
            torch.cuda.synchronize()
            want = ref.decode_attention(q, k, v, valid)
            what = f"decode_attention {dn} B={B} W={W}"
            err = check_close(got, want, dn, what)
            if B > 1 and bool(got[-1].ne(0).any()):
                fail(f"{what}: all-invalid row is not 0")
            ms = time_ms(lambda: da.decode_attention(q, k, v, valid))
            plain_ms = time_ms(
                lambda: ref.decode_attention(q, k, v, valid), reps=5)
            print(f"{what}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}", flush=True)

    flash_shape_checks(gen)
    paged_checks(gen)

    # the line's numbers: one main-path shape per kernel, bfloat16 —
    # the largest prefill bucket the main path admits (one 512-token
    # prompt) and a 4-slot decode over the 2048-slot ring with each row
    # live up to a main-path depth
    dtype, dn, isz = torch.bfloat16, "bfloat16", 2
    B, S = 1, 512
    q = randn(B, S, H, K, dtype=dtype)
    k = randn(B, S, HKV, K, dtype=dtype)
    v = randn(B, S, HKV, K, dtype=dtype)
    err = check_close(fa.flash_attention(q, k, v),
                      ref.flash_attention(q, k, v), dn, "flash main shape")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound, by = prefill_bound(
        B, S, S, ref.attention_mask(S, S, causal=True, window=0,
                                    device=dev), dn, isz)
    def kernel():
        return fa.flash_attention(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    results["flash_attention"] = {
        "max_abs_err": err,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v), reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(library),
        # device time: 100 calls replayed from a CUDA graph, so the host's
        # launch rate does not pace them
        "graph_ms": time_graph_ms(kernel),
        "library_graph_ms": time_graph_ms(library),
        "shape": f"B={B} Sq=Skv={S} H={H} Hkv={HKV} K={K} bf16 causal; ms "
                 "and library_ms launched one by one (CUDA events), "
                 "graph_ms and library_graph_ms replayed from a CUDA graph"}

    # the decode kernels and MLA decode at their main-path shapes: checked
    # against their plain versions first, then one row each
    int8_checks(gen)
    mla_checks(gen)
    for name, row in decode_main_calls(gen).items():
        results[name] = {
            "max_abs_err": check_close(row["kernel"](), row["plain"](), dn,
                                       f"{name} main shape"),
            "ms": time_ms(row["kernel"]),
            "plain_ms": time_ms(row["plain"], reps=5),
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": time_ms(row["library"]),
            # device time, as for the prefill kernel
            "graph_ms": time_graph_ms(row["kernel"]),
            "library_graph_ms": time_graph_ms(row["library"]),
            "shape": row["shape"] + "; ms and library_ms launched one by "
                     "one (CUDA events), graph_ms and library_graph_ms "
                     "replayed from a CUDA graph"}
        print(f"{name} main shape: {results[name]}", flush=True)

    # the SSD scan at the main path's 512-token prefill, bf16; no PyTorch
    # call computes the scan, so there is no library yardstick
    from repro_torch.kernels import ssd_scan as ssd
    worst = ssd_checks(gen)
    m = SSD_MAIN
    args = ssd_inputs(gen, m["B"], m["S"], m["nh"], m["hd"], m["ng"],
                      m["ds"], dtype)
    got = ssd.ssd_scan(*args, chunk=m["chunk"])
    want = ref.ssd_scan(*args, chunk=m["chunk"])
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    rel = max(ssd_close(g, w, dn, "ssd main shape")
              for g, w in zip(got, want))
    bound, by, _ = ssd_bound(*(m[k] for k in ("B", "S", "nh", "hd", "ng",
                                              "ds")), dn, isz)
    launched, scratch = ssd_call_footprint(
        lambda: ssd.ssd_scan(*args, chunk=m["chunk"]))
    n_launched = check_kernels_per_call("ssd_scan bfloat16", launched,
                                        SSD_KERNELS_PER_CALL)
    results["ssd_scan"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ssd.ssd_scan(*args, chunk=m["chunk"])),
        "graph_ms": time_graph_ms(lambda: ssd.ssd_scan(*args,
                                                       chunk=m["chunk"])),
        "plain_ms": time_ms(lambda: ref.ssd_scan(*args, chunk=m["chunk"]),
                            reps=5),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        # one bf16 call's CUDA kernels and float32 scratch, read on the card
        "cuda_kernels_per_call": n_launched,
        "cuda_kernels": launched,
        "scratch_bytes": scratch,
        "shape": f"B={m['B']} S={m['S']} nh={m['nh']} hd={m['hd']} "
                 f"ng={m['ng']} ds={m['ds']} chunk={m['chunk']} bf16 "
                 f"(model-like dt, A); max |err| / max|plain| {rel:.3e}, "
                 f"worst over the phase-2 cases f32 {worst['float32']:.3e} "
                 f"bf16 {worst['bfloat16']:.3e}; library_ms null: no "
                 "PyTorch call computes the SSD scan"}
    args = ssd_inputs(gen, 1, 2048, m["nh"], m["hd"], m["ng"], m["ds"],
                      dtype)
    bound, by, _ = ssd_bound(1, 2048, *(m[k] for k in ("nh", "hd", "ng",
                                                      "ds")), dn, isz)
    results["ssd_scan"]["s2048"] = {
        "ms": time_ms(lambda: ssd.ssd_scan(*args, chunk=m["chunk"])),
        "graph_ms": time_graph_ms(lambda: ssd.ssd_scan(*args,
                                                       chunk=m["chunk"])),
        "plain_ms": time_ms(lambda: ref.ssd_scan(*args, chunk=m["chunk"]),
                            reps=3),
        "bound_ms": bound, "bound_by": by}
    print(f"ssd_scan main shape: {results['ssd_scan']}", flush=True)

    # MLA prefill's shape of the flash kernel
    results["flash_attention"]["mla_prefill_shape"] = flash_mla_checks(gen)

    # RMSNorm at the block norm of a 512-token qwen3 prefill (bf16 rows
    # and scale); the yardstick is torch.nn.functional.rms_norm, which the
    # port never calls
    from repro_torch.kernels import rmsnorm as rn
    worst = rmsnorm_checks(gen)
    rows, D = RMS_MAIN["rows"], RMS_MAIN["D"]
    x = randn(1, rows, D, dtype=dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dtype)
    err = check_close(rn.rmsnorm(x, scale, RMS_EPS),
                      ref.rmsnorm(x, scale, RMS_EPS), dn, "rmsnorm main shape")
    bound, by = rmsnorm_bound([(rows, D)], dn, isz, isz)

    def kernel():
        return rn.rmsnorm(x, scale, RMS_EPS)

    def plain():
        return ref.rmsnorm(x, scale, RMS_EPS)

    def library():
        return F.rms_norm(x, (D,), weight=scale, eps=RMS_EPS)
    results["rmsnorm"] = {
        "max_abs_err": err,
        "ms": time_graph_ms(kernel),
        "plain_ms": time_graph_ms(plain),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_graph_ms(library),
        "eager_ms": {"kernel": time_ms(kernel, reps=100),
                     "plain": time_ms(plain, reps=20),
                     "library": time_ms(library, reps=100)},
        "decode_shapes": {
            name: {"ms": time_graph_ms(c["kernel"]),
                   "library_ms": time_graph_ms(c["library"]),
                   "bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
            for name, c in rmsnorm_decode_calls(gen).items()},
        "launch_floor_ms": launch_floor_ms(),
        "shape": f"x=(1, {rows}, {D}) bf16, scale ({D},) bf16; worst over "
                 f"the phase-2 cases f32 {worst['float32']:.3e} bf16 "
                 f"{worst['bfloat16']:.3e}; library_ms is "
                 "torch.nn.functional.rms_norm; ms, plain_ms and "
                 "library_ms replay 100 calls captured in a CUDA graph "
                 "(device time), eager_ms times them launched one by one; "
                 "decode_shapes are a 4-slot decode step's norms (graph); "
                 "launch_floor_ms is torch.cuda._sleep(0) (graph)"}
    print(f"rmsnorm main shape: {results['rmsnorm']}", flush=True)

    # the gemma family's and the 8B configs' shapes (phase 14's), then the
    # hybrid, vision and windowed-MoE families' (phase 15's)
    for name, rows in family_shape_checks(gen).items():
        results[name]["family_shapes"] = rows
        print(f"{name} family shapes: {rows}", flush=True)
    for name, rows in later_shape_checks(gen).items():
        results[name].setdefault("family_shapes", {}).update(rows)
        print(f"{name} phase 15 shapes: {rows}", flush=True)
    for name, rows in whisper_shape_checks(gen).items():
        results[name].setdefault("family_shapes", {}).update(rows)
        print(f"{name} phase 16 shapes: {rows}", flush=True)
    backward = backward_checks(gen)
    results["flash_attention"]["family_shapes"].update(
        backward.pop("flash_attention_train_forward"))
    results.update(backward)
    # the bf16 bodies at the same shapes (bf16 training), under "bf16" in
    # their kernels' rows
    t_bf16 = time.perf_counter()
    backward = backward_checks(gen, torch.bfloat16)
    results["flash_attention"]["family_shapes"].update(
        backward.pop("flash_attention_train_forward"))
    for name, row in backward.items():
        results[name]["bf16"] = row
    print(f"phase 2 bf16 backward bodies: "
          f"{time.perf_counter() - t_bf16:.1f} s", flush=True)
    ssd_backward = ssd_bwd_checks(gen)
    results["ssd_scan"]["train_forward_f32"] = ssd_backward.pop(
        "ssd_scan_train_forward")
    results.update(ssd_backward)
    return results


# ---------------------------------------------------------------------------
# phase 3: the model on the card against the CPU plain path
# ---------------------------------------------------------------------------
LOGIT_TOL = 1e-3


def model_phase(cfg, last: list[int], S: int = 64, steps: int = 8):
    """``cfg`` on the card against the CPU plain path: a 2-row, S-token
    prefill with logits at ``last`` per row, then ``steps`` greedy decode
    steps."""
    from repro_torch.models.model import Model

    cpu_model = Model(cfg, device="cpu")
    gpu_model = Model(cfg, device="cuda")
    cpu_params = cpu_model.init(seed=0)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.to("cuda")
    gpu_params = to_cuda(cpu_params)

    rng = np.random.default_rng(0)
    B, max_len = 2, 128
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32))
    last = torch.tensor(last)
    cc, gc = cpu_model.init_cache(B, max_len), gpu_model.init_cache(B, max_len)
    worst, agree, rows = 0.0, 0, 0
    img = {}
    if cfg.n_vision_tokens:   # an image ahead of each prompt (last counts it)
        img["vision_embeds"] = torch.from_numpy((0.1 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.vision_embed_dim))).astype(
                np.float32))
    if cfg.n_encoder_layers:  # whisper: each prompt's frames
        img["audio_frames"] = torch.from_numpy((0.1 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32))
    cl = cpu_model.prefill(cpu_params, toks, cc, logits_at=last, **img)
    gl = gpu_model.prefill(gpu_params, toks.cuda(), gc,
                           logits_at=last.cuda(),
                           **{k: v.cuda() for k, v in img.items()}).cpu()
    pos = last + 1
    for step in range(steps + 1):
        err = float((gl - cl).abs().max())
        worst = max(worst, err)
        if err > LOGIT_TOL + LOGIT_TOL * float(cl.abs().max()):
            fail(f"model: step {step} logits differ by {err:.3e}")
        nxt = cl.argmax(-1)
        agree += int((gl.argmax(-1) == nxt).sum())
        rows += B
        if step == steps:
            break
        tok = nxt.to(torch.int32)[:, None]
        cl = cpu_model.decode_step(cpu_params, tok, cc, pos)
        gl = gpu_model.decode_step(gpu_params, tok.cuda(), gc,
                                   pos.cuda()).cpu()
        pos = pos + 1
    if not np.isfinite(cl.numpy()).all():
        fail("model: CPU logits are not finite")
    print(f"model {cfg.name} ({cfg.n_layers} layers, f32, G="
          f"{cfg.n_heads // max(cfg.n_kv_heads, 1)} K={cfg.head_dim} "
          f"kv_cache_dtype={cfg.kv_cache_dtype}): {S}-token "
          f"prefill + {steps} greedy decode steps, max |logit diff| card vs "
          f"CPU = {worst:.3e} (tolerance {LOGIT_TOL} abs + rel), token "
          f"agreement {agree}/{rows}", flush=True)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def main_path_phase(card: str):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("qwen3-0.6b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                          chunk_tokens=32)
    rng = np.random.default_rng(1)
    plens = [16, 512, 37, 200, 96, 333, 64, 480]
    max_new = 32
    backend = ThreadBackend(model, params, 2, config=config)
    engines = list(backend.engines)
    with Router(backend) as router:
        # warm-up: first cuBLAS handles and allocations, not counted; it
        # leaves both engines' step graphs captured
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, cfg.vocab_size, (n,), dtype=np.int32), 4))
                for i, n in enumerate((20, 300))]:
            h.result()
        torch.cuda.synchronize()
        if any(e.graph_capture_s is None for e in engines):
            fail("main path: the warm-up left an engine without its step "
                 "graph")
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                        dtype=np.int32), max_new)
                for i, n in enumerate(plens)]
        ops.reset_launch_counts()
        replays = [(e.graph_replays, e.chunks) for e in engines]
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        replays = [(e.graph_replays - r, e.chunks - c)
                   for e, (r, c) in zip(engines, replays)]
    for r, c, h in zip(reqs, comps, handles):
        if c.rid != r.rid or len(c.tokens) != max_new:
            fail(f"main path: request {r.rid} gave {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"main path: request {r.rid} has out-of-range tokens")
        if h.ttfc_s is None:
            fail(f"main path: request {r.rid} has no first chunk")
    for name in ("flash_attention", "decode_attention"):
        if launches[name] <= 0:
            fail(f"main path: kernel {name} was never launched")
    check_norm_launches(cfg, launches, "main path")
    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"main path: qwen3-0.6b 28 layers bf16, Router(ThreadBackend(2)) "
          f"n_slots=4 max_len=2048, 8 requests prompts {plens} "
          f"max_new={max_new}: wall_s={wall:.4f} tok_per_s="
          f"{n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} launches="
          f"{launches} [card: {card}]", flush=True)
    print(f"main path, the engines' step graphs (captured in the warm-up's "
          f"first chunks, not timed): capture_s="
          f"{[round(e.graph_capture_s, 4) for e in engines]} pool_bytes="
          f"{[e.graph_pool_bytes for e in engines]}; in the timed window "
          f"(replays, chunks) per engine {replays} [card: {card}]",
          flush=True)

    # one engine alone: a replayed chunk against the eager chunk, then
    # one chunk's host calls (no kernel launched from Python)
    eng = engines[0]
    eng.on_event = None
    eng.submit_many([Request(2000 + i, rng.integers(
        0, cfg.vocab_size, (n,), dtype=np.int32), 80)
        for i, n in enumerate((48, 160, 300, 544))])
    eng.step()
    graph_vs_eager(eng, "phase 4, dense bf16 cache", card)
    prof = chunk_launch_profile(eng)
    if (prof["kernel_launches"] or prof["memcpy_calls"] != 2
            or prof["graph_launches"] != prof["n_tokens"]):
        fail(f"main path: a steady-state chunk made {prof}; want no "
             "kernel launch, one graph launch a step and two copies")
    eng.run()
    print(f"main path, one steady-state chunk of a 4-row engine under the "
          f"profiler: {prof['n_tokens']} steps, {prof['graph_launches']} "
          f"graph launches, {prof['kernel_launches']} kernel launches, "
          f"{prof['memcpy_calls']} copies, wall_ms={prof['wall_ms']:.3f} "
          f"(profiled) [card: {card}]", flush=True)
    del eng, engines, backend

    # one 4-slot decode step at main-path depths, its norms through the
    # plain version (as before the rmsnorm kernel) and through the kernel
    cache = model.init_cache(4, config.max_len, config.dtype)
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor([48, 160, 300, 544], dtype=torch.int32,
                       device="cuda")
    ops.reset_launch_counts()
    model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    norms = ops.launch_counts()["rmsnorm"]
    turns = norms_in_turns(
        lambda: decode_step_profile(model, params, tok, cache, pos))
    fmt = STEP_FMT
    print(f"main path, one 4-slot decode step (rows live to 48/160/300/544), "
          f"in turns plain, kernel, kernel, plain: norms in plain tensor "
          f"code {fmt(*turns[0])} / {fmt(*turns[3])}; norms through the "
          f"rmsnorm kernel ({norms} a step) {fmt(*turns[1])} / "
          f"{fmt(*turns[2])} [card: {card}]", flush=True)
    del cache
    return launches


def norms_in_turns(step) -> list:
    """``step()`` four times, in turns with the models' norms in plain
    tensor code on the card tensors (what they ran before the rmsnorm
    kernel: ``ops.rmsnorm`` and ``ops.rmsnorm_pair`` patched) and through
    the kernel: plain, kernel, kernel, plain (the decode-step readings of
    phases 4, 8 and 9 only)."""
    from repro_torch.kernels import ops, ref
    kernel = ops.rmsnorm, ops.rmsnorm_pair
    plain = ref.rmsnorm, lambda x, xs, y, ys, eps=1e-6: (
        ref.rmsnorm(x, xs, eps), ref.rmsnorm(y, ys, eps))
    turns = []
    for use_kernel in (False, True, True, False):
        ops.rmsnorm, ops.rmsnorm_pair = kernel if use_kernel else plain
        try:
            turns.append(step())
        finally:
            ops.rmsnorm, ops.rmsnorm_pair = kernel
    return turns


def norms_per_forward(cfg) -> int:
    """rmsnorm launches in one forward (a prefill batch or a decode step):
    per layer the block norms (two, one for an SSM block) plus the q/k
    norms (one pair launch), the MLA latent norm or the mamba2 gated norm
    (for zamba, each SSM layer's and each application of the shared
    block's); then the final norm. A layernorm model (whisper) runs no
    rmsnorm."""
    if cfg.norm_type == "layernorm":
        return 0
    attn = 2 + (1 if cfg.qk_norm else 0) + (1 if cfg.mla else 0)
    if cfg.arch_type == "hybrid":
        # every SSM layer, then each application of the shared block
        return (cfg.n_layers * 2
                + cfg.n_layers // cfg.shared_attn_every * attn + 1)
    return cfg.n_layers * (2 if cfg.is_ssm else attn) + 1


def check_norm_launches(cfg, launches: dict, what: str) -> None:
    """Every norm of the model runs the rmsnorm kernel: a positive
    multiple of the norms of one forward (none for a layernorm model)."""
    n, per = launches["rmsnorm"], norms_per_forward(cfg)
    if per == 0:
        if n:
            fail(f"{what}: {n} rmsnorm launches from {cfg.name}, whose "
                 "norms are layernorms; need none")
    elif n <= 0 or n % per:
        fail(f"{what}: {n} rmsnorm launches; need a positive multiple of "
             f"{per} (the norms of one {cfg.name} forward)")


# ---------------------------------------------------------------------------
# the decode chunk as a captured CUDA graph, on every engine
# ---------------------------------------------------------------------------
def tree_clone(tree):
    """A copy of a cache tree (lists and dicts of tensors, a whisper
    layer's nested self group too) with every tensor cloned."""
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_clone(v) for v in tree]
    return tree.clone()


def tree_leaves(tree, path: str = ""):
    """(path, tensor) of every tensor of a cache tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def graph_vs_eager(engine, what: str, card: str) -> int:
    """The engine's next chunk, replayed from its captured step graph,
    against ``Model.decode_chunk`` run eagerly from the same slot state on
    a clone of its cache taken just before: the token block, the emitted
    counts, every cache leaf's bytes and the kernel launch counts must be
    equal. Needs requests admitted and the graph captured; the engine's
    own bookkeeping runs as in any chunk, so it serves on afterwards.
    Returns the chunk's steps."""
    from repro_torch.kernels import ops

    active = [i for i, s in enumerate(engine.slots) if s.active]
    if not active or engine.graph_capture_s is None:
        fail(f"graph vs eager ({what}): {len(active)} active rows, capture "
             f"{engine.graph_capture_s}")
    torch.cuda.synchronize()
    clone = tree_clone(engine.cache_backend.tree)
    seen = {}
    run = engine._run_chunk

    def spy(state, n):
        seen["state"], seen["n"] = state.copy(), n
        seen["draw"] = engine.draws
        seen["out"] = run(state, n)
        return seen["out"]
    engine._run_chunk = spy
    replays = engine.graph_replays
    before = ops.launch_counts()
    try:
        with engine._on_stream():
            engine._decode_chunk(active)
    finally:
        del engine._run_chunk
    torch.cuda.synchronize()
    mid = ops.launch_counts()
    n = seen["n"]
    if engine.graph_replays != replays + n:
        fail(f"graph vs eager ({what}): {engine.graph_replays - replays} "
             f"replays for a {n}-step chunk")
    st = torch.from_numpy(seen["state"]).cuda()
    state = {"tokens": st[0], "pos": st[1], "remaining": st[2],
             "active": st[3].bool()}
    kw, key = {}, ""
    if not engine.greedy:
        # the random stream's state as the chunk found it, cloned
        from repro_torch.models.sampling import new_key
        state["key"], kw["greedy"] = new_key(
            engine.config.seed, seen["draw"], "cuda"), False
    block, emitted, new = engine.model.decode_chunk(
        engine.params, clone, state, n, max_len=engine.max_len, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    if not (np.array_equal(block.cpu().numpy(), seen["out"][0])
            and np.array_equal(emitted.cpu().numpy(), seen["out"][1])):
        fail(f"graph vs eager ({what}): tokens or emitted counts differ")
    if not engine.greedy:
        want = new_key(engine.config.seed, seen["draw"] + n).tolist()
        got = engine._buf["key"].tolist()
        if new["key"].tolist() != want or got != want or \
                engine.draws != want[1]:
            fail(f"graph vs eager ({what}): the random stream after the "
                 f"chunk: replayed {got}, eager {new['key'].tolist()}, "
                 f"want {want}, engine draws {engine.draws}")
        key = f", the random stream [seed, draw] {want} after both"
    leaves = 0
    for (path, t), (_, c) in zip(tree_leaves(engine.cache_backend.tree),
                                 tree_leaves(clone)):
        leaves += 1
        if not torch.equal(t.view(torch.uint8), c.view(torch.uint8)):
            where = ""
            if path.endswith("_pages"):
                rows = (t.view(torch.uint8) != c.view(torch.uint8)).flatten(
                    1).any(1).nonzero().flatten().tolist()
                where = (f" in pages {rows[:16]} (the scratch page is "
                         f"{t.shape[0] - 1})")
            fail(f"graph vs eager ({what}): cache leaf {path} differs"
                 f"{where}")
    replayed = {k: mid[k] - before[k] for k in mid}
    eager = {k: after[k] - mid[k] for k in mid}
    if replayed != eager or not sum(replayed.values()):
        fail(f"graph vs eager ({what}): launches replayed {replayed}, eager "
             f"{eager}")
    print(f"graph vs eager ({what}): a {n}-step chunk over {len(active)} "
          f"active rows replayed from the engine's step graph equals "
          f"Model.decode_chunk run eagerly on a clone of its cache: tokens, "
          f"emitted counts, {leaves} cache leaves bit for bit{key}, "
          f"launches { {k: v for k, v in replayed.items() if v} }; the "
          f"engine's "
          f"capture {engine.graph_capture_s:.4f} s, pool "
          f"{engine.graph_pool_bytes} B, replays {engine.graph_replays} "
          f"[card: {card}]", flush=True)
    return n


def engine_graph_check(engine, reqs, what: str, card: str) -> None:
    """Serve ``reqs`` on ``engine`` alone (its stream events dropped):
    admission and a chunk, then ``graph_vs_eager``, then to completion."""
    engine.on_event = None
    engine.submit_many(reqs)
    engine.step()
    graph_vs_eager(engine, what, card)
    engine.run()


KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernelEx")


def chunk_launch_profile(engine) -> dict:
    """One chunk of ``engine`` (requests admitted, its graph captured, the
    queue empty) under ``torch.profiler``: the host calls it makes, by
    kind. In steady state a chunk launches no kernel from Python: one
    state copy in, ``n_tokens`` graph launches, one copy out."""
    from torch.profiler import ProfilerActivity, profile
    if engine.queue or engine.graph_capture_s is None:
        fail("chunk profile: needs an empty queue and a captured graph")
    replays = engine.graph_replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()

    def calls(*keys):
        return sum(e.count for e in events if e.key in keys)
    return {"n_tokens": engine.graph_replays - replays,
            "kernel_launches": calls(*KERNEL_LAUNCH_CALLS),
            "graph_launches": calls("cudaGraphLaunch", "cuGraphLaunch"),
            "memcpy_calls": calls("cudaMemcpyAsync", "cudaMemcpy",
                                  "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2",
                                  "cuMemcpyDtoHAsync_v2"),
            "wall_ms": wall * 1e3}


def graph_nodes(graph):
    """Nodes of a captured graph kept with ``keep_graph=True``, from
    ``libcuda``'s ``cuGraphGetNodes``; None where ``libcuda`` cannot be
    loaded or refuses."""
    import ctypes
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                  None, ctypes.byref(n))
    return n.value if err == 0 else None


STEP_FMT = ("host_ms={:.3f} kernel_launches={} device_ms={:.3f} "
            "attention_device_ms={:.4f}; replayed from a graph: wall_ms={:.3f} "
            "profiler_launches={} enqueue_us={:.1f} graph_nodes={}").format


def replayed_step_profile(model, params, tok, cache, pos) -> tuple:
    """The decode step as a serving engine replays it: one
    ``decode_chunk_step`` over the rows of ``tok`` / ``pos`` (inactive, so
    their positions hold) captured on a side stream after one eager step
    there, then: the wall of one replay ending in a synchronize (mean of
    10), the launch calls the profiler sees in one replay, the host µs
    that enqueuing one replay onto an idle card takes (mean of 10; replays
    enqueued back to back wait for room in the card's launch queue), and
    the graph's node count (None where it cannot be read). A checkout
    whose model has no chunk step gives Nones."""
    from torch.profiler import ProfilerActivity, profile
    if not hasattr(model, "decode_chunk_step"):
        return None, None, None, None
    from repro_torch.kernels.build import capture_tally
    buf = model.chunk_buffers(tok.shape[0], 16)
    buf["tokens"].copy_(tok[:, 0])
    buf["pos"].copy_(pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def step():   # no row is active, so the horizon gates nothing
        model.decode_chunk_step(params, cache, buf, max_len=2048)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side):
        step()
        with capture_tally():
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                step()
    nodes = graph_nodes(graph)
    graph.instantiate()
    torch.cuda.current_stream().wait_stream(side)

    def replays(n):
        buf["col"].zero_()
        for _ in range(n):
            graph.replay()
    replays(3)
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        replays(1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    buf["col"].zero_()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        *KERNEL_LAUNCH_CALLS, "cudaGraphLaunch", "cuGraphLaunch"))
    enqueue = []
    buf["col"].zero_()
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return (sum(walls) / len(walls) * 1e3, launches,
            sum(enqueue) / len(enqueue) * 1e6, nodes)


# ---------------------------------------------------------------------------
# phase 5: dense vs paged greedy streams on the card
# ---------------------------------------------------------------------------
# same-bucket groups of at most n_slots, in queue order, one budget per
# group: the dense engine (head + same-bucket requests) and the paged one
# (run of consecutive heads with one key) then admit the same prefill
# batches, and max_seqs = n_slots gives both decodes the same rows
PARITY_GROUPS = [((150, 200, 256, 180), 24), ((40, 50, 64, 33), 32),
                 ((300, 400, 512), 16)]


def parity_phase(model, params, config, card: str, groups=PARITY_GROUPS,
                 peaks: list | None = None):
    """Serve the same requests through one dense and one paged engine
    (``config`` with cache="paged"); their greedy streams must be
    identical. Then each engine serves one more group with a chunk held to
    the eager chunk (``engine_graph_check``). Returns each engine's kernel
    launches of the compared streams (dense, paged); each engine's
    ``peak_active`` over them goes into ``peaks`` when given."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(5)
    reqs = []
    for plens, max_new in groups:
        for n in plens:
            reqs.append(Request(len(reqs), rng.integers(
                0, model.cfg.vocab_size, (n,), dtype=np.int32), max_new))
    streams, walls, launches = [], [], []
    for cache in ("dense", "paged"):
        eng = ServingEngine(model, params,
                            dataclasses.replace(config, cache=cache),
                            device=model.device)
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        before = ops.launch_counts()
        t0 = time.perf_counter()
        comps = eng.run()
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append({k: n - before[k]
                         for k, n in ops.launch_counts().items()})
        streams.append({c.rid: list(c.tokens) for c in comps})
        if peaks is not None:
            peaks.append(eng.peak_active)
        if model.device.type == "cuda":
            engine_graph_check(eng, [
                Request(1000 + j, rng.integers(0, model.cfg.vocab_size, (n,),
                                               dtype=np.int32), 40)
                for j, n in enumerate(groups[0][0])],
                f"{model.cfg.name} kv_cache_dtype={model.cfg.kv_cache_dtype}"
                f" {cache} cache", card)
        del eng
    dense, paged = streams
    if len(dense) != len(reqs):
        fail(f"dense vs paged: {len(dense)} of {len(reqs)} completed")
    for r in reqs:
        if dense[r.rid] != paged.get(r.rid):
            fail(f"dense vs paged: request {r.rid} streams differ: "
                 f"{dense[r.rid][:8]}... vs {paged.get(r.rid, [])[:8]}...")
    n_tok = sum(len(t) for t in dense.values())
    print(f"dense vs paged: {model.cfg.name} {model.cfg.n_layers} layers "
          f"{str(config.dtype).split('.')[1]}, kv_cache_dtype="
          f"{model.cfg.kv_cache_dtype}, n_slots={config.n_slots} "
          f"max_seqs={config.max_seqs} block_size={config.block_size} "
          f"max_len={config.max_len}, {len(reqs)} requests in groups "
          f"{[list(g) for g, _ in groups]}: {n_tok} greedy tokens "
          f"identical; wall_s dense={walls[0]:.4f} paged={walls[1]:.4f} "
          f"[card: {card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: this slice's main path — paged cache with prefix sharing
# ---------------------------------------------------------------------------
SYSTEM_PROMPT = 256
TAILS = (16, 256)
WAVES = (2, 14)


def shared_prefix_requests(cfg, seed=3):
    """Two waves of requests that share one SYSTEM_PROMPT-token prefix
    (16 full blocks) followed by a 16-256-token private tail."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (SYSTEM_PROMPT,), dtype=np.int32)
    waves, rid = [], 0
    for n in WAVES:
        wave = []
        for _ in range(n):
            tail = rng.integers(0, cfg.vocab_size,
                                (int(rng.integers(TAILS[0], TAILS[1] + 1)),),
                                dtype=np.int32)
            wave.append((rid, np.concatenate([prefix, tail])))
            rid += 1
        waves.append(wave)
    return waves


def prefix_phase(model, params, config, card: str, n_containers: int = 2,
                 max_new: int = 32):
    """Router(ThreadBackend) over paged, prefix-sharing engines: wave 1
    seeds the prefix index, wave 2 must hit it; more sequences than
    n_slots must be in flight at once in the dense footprint; the paged
    kernel and the prefill kernel must launch, the dense decode kernel
    must not. Returns the launch counts of this phase, the wave-2 tokens
    by request and one engine's KV pool bytes."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router import Router

    cfg, dev = model.cfg, model.device
    waves = shared_prefix_requests(cfg)
    results, per_wave = {}, []
    backend = ThreadBackend(model, params, n_containers, config=config,
                            device=dev)
    engines = list(backend.engines)
    with Router(backend, device=dev) as router:
        ops.reset_launch_counts()
        for wave in waves:
            engines = backend.engines
            pre0 = sum(e.prefill_tokens_executed for e in engines)
            t0 = time.perf_counter()
            handles = [router.submit(Request(rid, prompt, max_new))
                       for rid, prompt in wave]
            comps = [h.result() for h in handles]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per_wave.append({
                "wall": wall,
                "tokens": sum(len(c.tokens) for c in comps),
                "ttfc_p50": float(np.percentile([h.ttfc_s for h in handles],
                                                50)),
                "hits": sum(c.prefix_hit_tokens for c in comps),
                "prefill": sum(e.prefill_tokens_executed for e in engines)
                - pre0})
            for c in comps:
                results[c.rid] = c
        launches = ops.launch_counts()
        peak = [e.peak_active for e in backend.engines]
        pool = kv_pool_bytes(backend.engines[0])
    for wave in waves:
        for rid, _ in wave:
            c = results.get(rid)
            if c is None or len(c.tokens) != max_new:
                fail(f"prefix path: request {rid} gave "
                     f"{None if c is None else len(c.tokens)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in c.tokens):
                fail(f"prefix path: request {rid} has out-of-range tokens")
    if per_wave[1]["hits"] <= 0:
        fail("prefix path: wave 2 had no prefix hits")
    if max(peak) <= config.n_slots:
        fail(f"prefix path: peak in-flight {peak} never exceeded "
             f"n_slots={config.n_slots}")
    if dev.type == "cuda":
        for name in ("paged_decode_attention", "flash_attention"):
            if launches[name] <= 0:
                fail(f"prefix path: kernel {name} was never launched")
        check_norm_launches(cfg, launches, "prefix path")
        if launches["decode_attention"] != 0:
            fail(f"prefix path: the dense decode kernel launched "
                 f"{launches['decode_attention']} times")
    for i, w in enumerate(per_wave, 1):
        print(f"prefix path wave {i}: {cfg.name} {cfg.n_layers} layers, "
              f"Router(ThreadBackend({n_containers})) paged block_size="
              f"{config.block_size} max_seqs={config.max_seqs} "
              f"max_len={config.max_len} prefix_cache=True, "
              f"{len(waves[i - 1])} requests ({SYSTEM_PROMPT}-token shared "
              f"prompt + {TAILS[0]}-{TAILS[1]}-token tails) max_new="
              f"{max_new}: wall_s={w['wall']:.4f} tok_per_s="
              f"{w['tokens'] / w['wall']:.2f} ttfc_p50_s={w['ttfc_p50']:.4f} "
              f"hit_tokens={w['hits']} prefill_tokens_executed="
              f"{w['prefill']} [card: {card}]", flush=True)
    print(f"prefix path: peak_active per container {peak} (n_slots="
          f"{config.n_slots}), launches={launches} [card: {card}]",
          flush=True)
    if dev.type == "cuda":
        # wave 2's first prompts again on one engine: admissions that hit
        # the shared prompt's pages and rewrite the block table
        hits = engines[0].prefix_hit_tokens_total
        engine_graph_check(engines[0], [
            Request(3000 + rid, prompt, max_new)
            for rid, prompt in waves[1][:4]],
            "phase 6, paged cache with prefix sharing", card)
        if engines[0].prefix_hit_tokens_total <= hits:
            fail("prefix path: the graph check's admissions hit nothing")
    del engines

    # report only: wave 2 again on one engine without sharing (other
    # batch shapes, so the card need not give the same bits)
    eng = ServingEngine(model, params,
                        dataclasses.replace(config, prefix_cache=False),
                        device=dev)
    eng.submit_many([Request(rid, prompt, max_new)
                     for rid, prompt in waves[0]])
    eng.run()
    pre0 = eng.prefill_tokens_executed
    eng.submit_many([Request(rid, prompt, max_new)
                     for rid, prompt in waves[1]])
    off = {c.rid: list(c.tokens) for c in eng.run()}
    agree = sum(int(a == b) for rid, _ in waves[1]
                for a, b in zip(off[rid], results[rid].tokens))
    print(f"prefix path, wave 2 with prefix_cache=False on one engine: "
          f"prefill_tokens_executed={eng.prefill_tokens_executed - pre0} "
          f"(with sharing {per_wave[1]['prefill']}), token agreement with "
          f"the sharing run {agree}/{len(waves[1]) * max_new} "
          f"[card: {card}]", flush=True)
    del eng
    return launches, {rid: results[rid].tokens for rid, _ in waves[1]}, pool


# ---------------------------------------------------------------------------
# phase 6c: prefix sharing on == off at equal phases (JAX's _serve_phases)
# ---------------------------------------------------------------------------
class PrefillLogits:
    """While open, records the prefill logits row (float32, on the host) of
    every request ``engine`` admits, by request id: a tap on the engine's
    admission and on its model's two prefill calls, removed on exit."""

    def __init__(self, engine):
        self.engine, self.rows = engine, {}

    def __enter__(self):
        eng, model = self.engine, self.engine.model
        admit, cur = eng._admit_batch, []

        def tapped_admit(slot_ids, reqs, plans=None):
            cur[:] = [r.rid for r in reqs]
            return admit(slot_ids, reqs, plans)

        def tap(fn):
            def call(*args, **kw):
                logits = fn(*args, **kw)
                for rid, row in zip(cur, logits.float().cpu()):
                    self.rows[rid] = row
                return logits
            return call
        eng._admit_batch = tapped_admit
        model.prefill = tap(model.prefill)
        model.prefill_suffix = tap(model.prefill_suffix)
        return self

    def __exit__(self, *exc):
        del self.engine._admit_batch
        del self.engine.model.prefill
        del self.engine.model.prefill_suffix


def sharing_bisect(model, params):
    """Where sharing on and off can part in the last bits: (a) the prefill
    kernel over [cached context | suffix] against the whole prompt on the
    same keys and values (bitwise: the kernel walks keys in the same tiles
    from position 0), and (b) one q projection of the same rows at the two
    row counts the two modes prefill (a 128-token suffix batch against
    eight 512-token prompts; cuBLAS picks its algorithm by shape, so a
    prefill slices its products). Returns (flash_bitwise,
    projection_bitwise)."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import prefill_products, project

    dev, dt = model.device, params["embed"]["table"].dtype
    gen = torch.Generator(device=dev).manual_seed(6)
    ctx, sb, whole, n = SYSTEM_PROMPT, 128, 512, 100
    q, k, v = (torch.randn(2, whole, h, K, generator=gen, device=dev).to(dt)
               for h in (H, HKV, HKV))
    full = ops.flash_attention(q, k, v)
    part = ops.flash_attention(q[:, ctx:ctx + sb].contiguous(),
                               k[:, :ctx + sb].contiguous(),
                               v[:, :ctx + sb].contiguous())
    flash_bitwise = torch.equal(part[:, :n], full[:, ctx:ctx + n])
    w = params["layers"][0]["attn"]["wq"]
    w = w.reshape(w.shape[0], -1)
    x = torch.randn(8 * whole, w.shape[0], generator=gen, device=dev).to(dt)
    with prefill_products(every_dtype=True):
        proj_bitwise = torch.equal(project(x[:sb], w), project(x, w)[:sb])
    return flash_bitwise, proj_bitwise


def sharing_gate_phase(model, params, config, card: str, max_new: int = 32):
    """6c: one paged engine with prefix sharing and one without, at the
    same block budget, each driven through phase 6's two waves in turn,
    draining between them. Wave 2 must hit the shared prompt, the greedy
    streams must be identical and each request's prefill logits equal bit
    for bit between the modes. On a difference the failure carries the
    bisect: the prefill kernel over [context | suffix] against the whole
    prompt, and a q projection at the two modes' row counts. Returns the
    launch counts of the two engines' runs."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    waves = shared_prefix_requests(model.cfg)
    streams, logits, hits, prefill = [], [], [], []
    ops.reset_launch_counts()
    for share in (True, False):
        eng = ServingEngine(model, params,
                            dataclasses.replace(config, prefix_cache=share),
                            device=model.device)
        got = {}
        with PrefillLogits(eng) as tap:
            for wave in waves:
                eng.submit_many([Request(rid, prompt, max_new)
                                 for rid, prompt in wave])
                for c in eng.run():
                    got[c.rid] = list(c.tokens)
        streams.append(got)
        logits.append(tap.rows)
        hits.append(eng.prefix_hit_tokens_total)
        prefill.append(eng.prefill_tokens_executed)
        del eng
    launches = ops.launch_counts()
    on, off = streams
    rids = [rid for wave in waves for rid, _ in wave]
    if sorted(on) != rids or sorted(off) != rids:
        fail(f"sharing gate: completed {len(on)} / {len(off)} of {len(rids)}")
    wave2 = [rid for rid, _ in waves[1]]
    if hits[0] != SYSTEM_PROMPT * len(wave2) or hits[1] != 0:
        fail(f"sharing gate: hit tokens {hits}, want "
             f"{SYSTEM_PROMPT * len(wave2)} with sharing and 0 without")
    differ = [rid for rid in rids if on[rid] != off[rid]]
    unequal = [rid for rid in rids
               if not torch.equal(logits[0][rid], logits[1][rid])]
    if differ or unequal:
        worst = max(float((logits[0][r] - logits[1][r]).abs().max())
                    for r in unequal) if unequal else 0.0
        flash_bitwise, proj_bitwise = sharing_bisect(model, params)
        fail(f"sharing gate: greedy streams differ for {differ}, prefill "
             f"logits of {unequal} (max {worst:.3e}); bisect: prefill "
             f"kernel over [context | suffix] bitwise={flash_bitwise}, q "
             f"projection at 128 vs 4096 rows bitwise={proj_bitwise}")
    print(f"sharing gate (6c): {model.cfg.name} {model.cfg.n_layers} layers "
          f"{str(config.dtype).split('.')[1]}, paged block_size="
          f"{config.block_size} max_seqs={config.max_seqs} max_len="
          f"{config.max_len} max_blocks={config.resolved_max_blocks}, "
          f"phase 6's waves {[len(w) for w in waves]} through one engine "
          f"per mode, drained between: "
          f"{sum(len(t) for t in on.values())} greedy tokens and "
          f"{len(rids)} prefill logit rows identical bit for bit with "
          f"sharing on and off; hit_tokens on={hits[0]} off={hits[1]} "
          f"prefill_tokens_executed on={prefill[0]} off={prefill[1]}; "
          f"launches={launches} [card: {card}]", flush=True)
    return launches


def kv_pool_bytes(engine) -> int:
    """Bytes of an engine's KV cache tensors (pages and scale pages, or
    dense rows and scales; the block table left out)."""
    return sum(t.nbytes for g in engine.cache_backend.tree
               for name, t in g.items() if name != "table")


# ---------------------------------------------------------------------------
# phase 7: the int8 KV cache
# ---------------------------------------------------------------------------
def int8_path_phase(model, params, config, card: str, bf16_tokens: dict,
                    bf16_pool: int, n_containers: int = 2,
                    max_new: int = 32):
    """Router(ThreadBackend) over paged int8 engines serving phase 6's
    wave 2 (prefix_cache=True, which the int8 cache must ignore): every
    request completes with ``max_new`` tokens and no hit tokens, the paged
    int8 kernel launches and no bfloat16 decode kernel does. Returns the
    launch counts of this phase."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import Request
    from repro_torch.serving.router import Router

    cfg, dev = model.cfg, model.device
    wave = shared_prefix_requests(cfg)[1]
    backend = ThreadBackend(model, params, n_containers, config=config,
                            device=dev)
    with Router(backend, device=dev) as router:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(Request(rid, prompt, max_new))
                   for rid, prompt in wave]
        comps = {h.rid: h.result() for h in handles}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = [e.peak_active for e in backend.engines]
        hits = sum(e.prefix_hit_tokens_total for e in backend.engines)
        pool = kv_pool_bytes(backend.engines[0])
    for rid, _ in wave:
        c = comps[rid]
        if len(c.tokens) != max_new:
            fail(f"int8 path: request {rid} gave {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"int8 path: request {rid} has out-of-range tokens")
    if hits != 0:
        fail(f"int8 path: {hits} prefix hit tokens on an int8 cache")
    if dev.type == "cuda" and launches["paged_decode_attention_int8"] <= 0:
        fail("int8 path: paged_decode_attention_int8 was never launched")
    if dev.type == "cuda":
        check_norm_launches(cfg, launches, "int8 path")
    bf16 = {k: launches[k] for k in ("decode_attention",
                                     "paged_decode_attention")}
    if any(bf16.values()):
        fail(f"int8 path: bfloat16 decode kernels launched {bf16}")
    n_tok = sum(len(c.tokens) for c in comps.values())
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    agree = sum(int(a == b) for rid, _ in wave
                for a, b in zip(comps[rid].tokens, bf16_tokens[rid]))
    wdt = str(params["embed"]["table"].dtype).split(".")[1]
    print(f"int8 path: {cfg.name} {cfg.n_layers} layers {wdt} weights, int8 "
          f"KV, Router(ThreadBackend({n_containers})) paged block_size="
          f"{config.block_size} max_seqs={config.max_seqs} max_len="
          f"{config.max_len} prefix_cache=True, phase 6 wave 2 ({len(wave)} "
          f"requests) max_new={max_new}: wall_s={wall:.4f} tok_per_s="
          f"{n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} hit_tokens={hits} "
          f"peak_active={peak} kv_pool_bytes int8={pool} bf16={bf16_pool} "
          f"({pool / bf16_pool:.4f}x); greedy tokens agreeing with the "
          f"bf16 run (phase 6, not checked): {agree}/{n_tok}; launches="
          f"{launches} [card: {card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the SSM family's main path — mamba2-2.7b
# ---------------------------------------------------------------------------
SSM_PLENS = [64, 64, 128, 200, 256, 256, 512, 1024]
ATTENTION_KERNELS = ("flash_attention", "decode_attention",
                     "paged_decode_attention", "decode_attention_int8",
                     "paged_decode_attention_int8")


def ssm_path_phase(model, params, card: str, n_containers: int = 2,
                   max_new: int = 32):
    """Router(ThreadBackend(2)) over full-width mamba2-2.7b (64 layers,
    bf16, random weights from seed 0: ``full_width_ssm``), n_slots=4,
    max_len=2048: 8
    requests with 64-1024-token prompts, each a length the scan's chunk
    (min(256, S)) divides. Every request completes with ``max_new``
    tokens; the 200-token request's stream equals that request run alone
    on the model; ``ssd_scan`` launches a multiple of 64 (one per layer per
    prefill) and at least once per layer per distinct length; no
    attention kernel launches. Returns the launch counts of the run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = model.cfg
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                    dtype=np.int32), max_new)
            for i, n in enumerate(SSM_PLENS)]
    backend = ThreadBackend(model, params, n_containers, config=config)
    engines = list(backend.engines)
    with Router(backend) as router:
        # warm-up: first cuBLAS handles and allocations, not counted
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, cfg.vocab_size, (n,), dtype=np.int32), 4))
                for i, n in enumerate((32, 256))]:
            h.result()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        state_bytes = sum(t.nbytes for g in backend.engines[0].cache_backend
                          .tree for t in g.values())
    for r, c, h in zip(reqs, comps, handles):
        if c.rid != r.rid or len(c.tokens) != max_new:
            fail(f"ssm path: request {r.rid} gave {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"ssm path: request {r.rid} has out-of-range tokens")
        if h.ttfc_s is None:
            fail(f"ssm path: request {r.rid} has no first chunk")
    n_ssd = launches["ssd_scan"]
    if n_ssd % cfg.n_layers or n_ssd < cfg.n_layers * len(set(SSM_PLENS)):
        fail(f"ssm path: {n_ssd} ssd_scan launches; need a multiple of "
             f"{cfg.n_layers}, at least {cfg.n_layers * len(set(SSM_PLENS))}")
    if any(launches[k] for k in ATTENTION_KERNELS):
        fail(f"ssm path: attention kernels launched: {launches}")
    check_norm_launches(cfg, launches, "ssm path")
    engine_graph_check(engines[0], [
        Request(2000 + i, rng.integers(0, cfg.vocab_size, (n,),
                                       dtype=np.int32), 40)
        for i, n in enumerate((64, 128, 256, 512))],
        "phase 8, mamba2 state rows", card)
    del engines

    # the 200-token request alone: a one-row prefill, then decode steps in
    # a batch as wide as the engine's slots with the other rows empty, so
    # every product has the engine's shapes (a row's bits do not depend
    # on the other rows')
    rid = SSM_PLENS.index(200)
    prompt = torch.from_numpy(reqs[rid].prompt).cuda()[None]
    one = model.init_cache(1, config.max_len, config.dtype)
    logits = model.prefill(params, prompt, one)
    cache = model.init_cache(config.n_slots, config.max_len, config.dtype)
    for dst, src in zip(cache, one):
        for name, t in dst.items():
            t[:1].copy_(src[name])
    tok = torch.zeros((config.n_slots, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((config.n_slots,), dtype=torch.int32, device="cuda")
    alone = [int(torch.argmax(logits[0]))]
    for _ in range(max_new - 1):
        tok[0, 0] = alone[-1]
        logits = model.decode_step(params, tok, cache, pos)
        alone.append(int(torch.argmax(logits[0])))
    if alone != list(comps[rid].tokens):
        fail(f"ssm path: request {rid} served {list(comps[rid].tokens)[:8]}"
             f"... but alone gives {alone[:8]}...")

    # the decode step in turns plain, kernel, kernel, plain norms (as
    # phase 4's): what the rmsnorm kernel moves on this family's step
    turns = norms_in_turns(
        lambda: decode_step_profile(model, params, tok, cache, pos))
    fmt = STEP_FMT

    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"ssm path: {cfg.name} {cfg.n_layers} layers bf16, Router("
          f"ThreadBackend({n_containers})) n_slots={config.n_slots} max_len="
          f"{config.max_len} chunk_tokens={config.chunk_tokens}, 8 requests "
          f"prompts {SSM_PLENS} max_new={max_new}: wall_s={wall:.4f} "
          f"tok_per_s={n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} "
          f"state_cache_bytes={state_bytes} (one engine); request {rid}'s "
          f"stream equals the model run alone; one {config.n_slots}-slot "
          f"decode step in turns plain, kernel, kernel, plain: norms in "
          f"plain tensor code {fmt(*turns[0])} / {fmt(*turns[3])}; norms "
          f"through the rmsnorm kernel {fmt(*turns[1])} / {fmt(*turns[2])}"
          f"; launches={launches} [card: {card}]",
          flush=True)
    return launches


# the device-side kernels of the decode attention bodies (the bf16/f32
# split pass and the merge both split bodies share; the int8 split pass)
# and of MLA decode, by the profiler's kernel names
DECODE_KERNEL_NAMES = ("decode_split_detail::", "decode_int8_detail::",
                       "mla_partial_kernel", "mla_merge_kernel")


def decode_step_profile(model, params, tok, cache, pos):
    """One decode step's host wall (mean of 10, each ending in a
    synchronize, after 3 unmeasured), its kernel launches (profiler count
    of launch calls), its device ms (the profiler's self device time of
    every kernel and copy of the step; 0 where the profiler sees no
    device) and the
    part of it in the decode attention kernels (``DECODE_KERNEL_NAMES``);
    then the same step replayed from a CUDA graph as an engine replays it
    (``replayed_step_profile``: wall ms, the launch calls the profiler
    sees, host µs to enqueue a replay, graph nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, tok, cache, pos)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in KERNEL_LAUNCH_CALLS)
    # device-side entries only: a host operation's device column repeats
    # the time of the kernels it launched
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    attention_ms = sum(e.self_device_time_total for e in on_card
                       if any(n in e.key for n in DECODE_KERNEL_NAMES)) / 1e3
    return (step_ms, launches, device_ms, attention_ms,
            *replayed_step_profile(model, params, tok, cache, pos))


# ---------------------------------------------------------------------------
# phase 9: the MoE family with latent attention — deepseek-v2-lite-16b
# ---------------------------------------------------------------------------
MAIN_PLENS = [16, 512, 37, 200, 96, 333, 64, 480]   # phase 4's prompts


def deepseek_path_phase(card: str, n_containers: int = 2,
                        max_new: int = 32):
    """Router(ThreadBackend(2)) over full-width deepseek-v2-lite-16b (27
    layers: MLA + dense MLP, then 26 of MLA + 64 routed experts top-6 and
    2 shared; bf16, random weights from seed 0, one copy shared by both
    engines), dense latent cache, n_slots=4, max_len=2048: phase 4's 8
    requests. Every request completes with ``max_new`` in-range tokens
    and a first chunk; ``mla_decode_ctx`` and ``flash_attention`` launch
    a positive multiple of 27 times (once per layer per decode step or
    prefill), no other kernel launches. The 200-token request, alone in
    its 256-token bucket, equals that request run alone at the engine's
    shapes (expert capacity drops depend on the batch). Then phase 9b on
    the same weights. Returns the launch counts of the Router run and of
    9b's dense and paged engines."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request, _bucket
    from repro_torch.serving.router import Router

    cfg = get_config("deepseek-v2-lite-16b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    backend = ThreadBackend(model, params, n_containers, config=config)
    with Router(backend) as router:
        # warm-up: first cuBLAS handles and allocations, not counted
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, cfg.vocab_size, (n,), dtype=np.int32), 4))
                for i, n in enumerate((20, 300))]:
            h.result()
        torch.cuda.synchronize()
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                        dtype=np.int32), max_new)
                for i, n in enumerate(MAIN_PLENS)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        cache_bytes = sum(t.nbytes for g in backend.engines[0].cache_backend
                          .tree for t in g.values())
    for r, c, h in zip(reqs, comps, handles):
        if c.rid != r.rid or len(c.tokens) != max_new:
            fail(f"deepseek path: request {r.rid} gave {len(c.tokens)} "
                 "tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"deepseek path: request {r.rid} has out-of-range tokens")
        if h.ttfc_s is None:
            fail(f"deepseek path: request {r.rid} has no first chunk")
    for name in ("mla_decode_ctx", "flash_attention"):
        if launches[name] <= 0 or launches[name] % cfg.n_layers:
            fail(f"deepseek path: {launches[name]} {name} launches; need a "
                 f"positive multiple of {cfg.n_layers}")
    others = {k: n for k, n in launches.items()
              if k not in ("mla_decode_ctx", "flash_attention", "rmsnorm")
              and n}
    if others:
        fail(f"deepseek path: other kernels launched: {others}")
    check_norm_launches(cfg, launches, "deepseek path")

    # the 200-token request alone: a one-row prefill padded to its
    # bucket, then decode steps as wide as the engine's slots with the
    # other rows empty, so every product has the engine's shapes (the
    # expert groups of a decode step are one token each)
    rid = MAIN_PLENS.index(200)
    n = len(reqs[rid].prompt)
    padded = torch.zeros((1, _bucket(n)), dtype=torch.int32, device="cuda")
    padded[0, :n] = torch.from_numpy(reqs[rid].prompt).cuda()
    one = model.init_cache(1, config.max_len, config.dtype)
    logits = model.prefill(params, padded, one,
                           logits_at=torch.tensor([n - 1], device="cuda"))
    cache = model.init_cache(config.n_slots, config.max_len, config.dtype)
    for dst, src in zip(cache, one):
        for name, t in dst.items():
            t[:1].copy_(src[name])
    tok = torch.zeros((config.n_slots, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((config.n_slots,), dtype=torch.int32, device="cuda")
    alone = [int(torch.argmax(logits[0]))]
    for i in range(max_new - 1):
        tok[0, 0], pos[0] = alone[-1], n + i
        logits = model.decode_step(params, tok, cache, pos)
        alone.append(int(torch.argmax(logits[0])))
    if alone != list(comps[rid].tokens):
        fail(f"deepseek path: request {rid} served "
             f"{list(comps[rid].tokens)[:8]}... but alone gives "
             f"{alone[:8]}...")
    # the decode step in turns plain, kernel, kernel, plain norms (as
    # phase 4's): what the rmsnorm kernel moves on this family's step
    turns = norms_in_turns(
        lambda: decode_step_profile(model, params, tok, cache, pos))
    fmt = STEP_FMT
    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"deepseek path: {cfg.name} {cfg.n_layers} layers bf16, Router("
          f"ThreadBackend({n_containers})) dense latent cache n_slots="
          f"{config.n_slots} max_len={config.max_len} chunk_tokens="
          f"{config.chunk_tokens}, 8 requests prompts {MAIN_PLENS} "
          f"max_new={max_new}: wall_s={wall:.4f} tok_per_s="
          f"{n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} "
          f"latent_cache_bytes={cache_bytes} (one engine); request {rid}'s "
          f"stream equals the model run alone; one {config.n_slots}-slot "
          f"decode step in turns plain, kernel, kernel, plain: norms in "
          f"plain tensor code {fmt(*turns[0])} / {fmt(*turns[3])}; norms "
          f"through the rmsnorm kernel {fmt(*turns[1])} / {fmt(*turns[2])}"
          f"; launches={launches} [card: {card}]",
          flush=True)
    del one, cache, backend
    torch.cuda.empty_cache()

    # 9b: dense against paged latent caches, phase 5's form
    paged = dataclasses.replace(config, cache="paged", block_size=16,
                                max_seqs=4)
    parity = parity_phase(model, params, paged, card)
    for which, counts in zip(("dense", "paged"), parity):
        if counts["mla_decode_ctx"] <= 0:
            fail(f"deepseek dense vs paged: mla_decode_ctx never launched "
                 f"on the {which} engine: {counts}")
    print(f"deepseek dense vs paged: launches dense={parity[0]} "
          f"paged={parity[1]} [card: {card}]", flush=True)
    return launches, parity


# ---------------------------------------------------------------------------
# phase 10: process containers — Router(ProcessBackend) on one card
# ---------------------------------------------------------------------------
def mps_running() -> bool:
    """Whether an MPS control daemon runs on this host (without it, the
    children's CUDA contexts time-slice the card)."""
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                with open(f"/proc/{pid}/comm") as f:
                    if f.read().startswith("nvidia-cuda-mps"):
                        return True
            except OSError:
                continue
    return False


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.nbytes


def serve_timed(router, reqs):
    """Submit every request before the first poll, wait for all; (tokens by
    rid, (wall s, tok/s, ttfc p50 s), events by rid)."""
    t0 = time.perf_counter()
    handles = [router.submit(dataclasses.replace(r)) for r in reqs]
    events = {h.rid: list(h.stream()) for h in handles}
    if router.backend.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = {h.rid: list(h.completion.tokens) for h in handles}
    n_tok = sum(len(t) for t in tokens.values())
    ttfc = float(np.percentile([h.ttfc_s for h in handles], 50))
    return tokens, (wall, n_tok / wall, ttfc), events


def warm_up(router, cfg, rng):
    """First cuBLAS handles, allocations and kernel loads: two requests,
    not counted."""
    from repro_torch.serving.engine import Request
    for h in [router.submit(Request(1000 + i, rng.integers(
            0, cfg.vocab_size, (n,), dtype=np.int32), 4))
            for i, n in enumerate((20, 300))]:
        h.result()
    if router.backend.device.type == "cuda":
        torch.cuda.synchronize()


def process_phase(model, params, card: str, max_new: int = 32):
    """Phase 4's 8 requests on full-width qwen3-0.6b (bf16, n_slots=4,
    max_len=2048, chunk_tokens=32) served four ways: 2 threaded
    containers, the same 2 polled in turn, 2 process containers and 1
    process container (Router(ProcessBackend), the weights shared with
    the children over CUDA IPC). Gates: every request completes; the 2
    process containers' greedy streams equal the 2 threaded containers'
    (all requests submitted before the first poll); each child launched
    flash_attention, decode_attention and rmsnorm; each child's
    memory_allocated after taking the weights is below their bytes (one
    copy on the card) and it imported torch only after pinning itself; a
    kill fault in container 1 after 2 steps gives a ContainerFailure
    with the kill's exit code, RetryEvents for its requests, a respawn,
    and streams equal to the fault-free run. Returns the children's
    summed launch counts of the 2-process run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ProcessBackend, ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.events import RetryEvent
    from repro_torch.serving.faults import EXIT_FAULT_KILL, Fault, FaultPlan
    from repro_torch.serving.router import Router

    cfg, dev = model.cfg, model.device
    on_card = dev.type == "cuda"
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=params["embed"]["table"].dtype)
    rng = np.random.default_rng(10)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                    dtype=np.int32), max_new)
            for i, n in enumerate(MAIN_PLENS)]
    weights = tree_bytes(params)
    readings, streams = {}, {}

    for name, concurrent in (("2 threaded", True), ("2 in turn", False)):
        with Router(ThreadBackend(model, params, 2, config,
                                  concurrent=concurrent, device=dev),
                    device=dev) as router:
            warm_up(router, cfg, rng)
            ops.reset_launch_counts()
            streams[name], readings[name], _ = serve_timed(router, reqs)
            if on_card:
                check_norm_launches(cfg, ops.launch_counts(),
                                    f"phase 10 {name}")

    children = {}
    for n in (2, 1):
        name = f"{n} process"
        backend = ProcessBackend(cfg, n, config, params=params,
                                 device=dev, allow_shared_cores=True,
                                 start_timeout_s=300)
        with Router(backend, device=dev) as router:
            t0 = time.perf_counter()
            backend.warm()
            start_s = time.perf_counter() - t0
            warm_up(router, cfg, rng)
            backend.child_stats(reset=True)
            streams[name], readings[name], _ = serve_timed(router, reqs)
            stats = backend.child_stats()
            for cid, (info, (counts, memory)) in enumerate(
                    zip(backend.child_info, stats)):
                if info["torch_preloaded"]:
                    fail(f"phase 10: child {cid} had torch imported "
                         "before it pinned itself")
                if info["weight_bytes"] != weights:
                    fail(f"phase 10: child {cid} took {info['weight_bytes']}"
                         f" weight bytes of {weights}")
                if info["memory_allocated"] >= weights:
                    fail(f"phase 10: child {cid} allocated "
                         f"{info['memory_allocated']} B after taking the "
                         f"weights ({weights} B): a copy of its own")
                if not on_card:
                    continue
                for k in ("flash_attention", "decode_attention", "rmsnorm"):
                    if counts.get(k, 0) <= 0:
                        fail(f"phase 10: child {cid} never launched {k}: "
                             f"{counts}")
                check_norm_launches(cfg, counts, f"phase 10 child {cid}")
            children[name] = (stats, [i["memory_allocated"]
                                      for i in backend.child_info],
                              backend.reported_core_sets, start_s)
    for name, got in streams.items():
        if sorted(got) != [r.rid for r in reqs] or any(
                len(t) != max_new for t in got.values()):
            fail(f"phase 10 {name}: not every request completed")
    for name in ("2 in turn", "2 process"):
        if streams[name] != streams["2 threaded"]:
            bad = [r for r in streams[name]
                   if streams[name][r] != streams["2 threaded"][r]]
            fail(f"phase 10: {name} streams differ from the threaded "
                 f"containers' for requests {bad}")

    # a kill fault in container 1 after 2 steps, mid-stream
    plan = FaultPlan((Fault("kill", container_id=1, after_steps=2),))
    backend = ProcessBackend(cfg, 2, config, params=params, device=dev,
                             allow_shared_cores=True, start_timeout_s=300,
                             fault_plan=plan, respawn_backoff_s=0.05)
    with Router(backend, max_retries=2, device=dev) as router:
        backend.warm()
        got, (kill_wall, _, _), events = serve_timed(router, reqs)
        fails = router.container_failures
        if len(fails) != 1 or fails[0].container_id != 1 \
                or fails[0].exitcode != EXIT_FAULT_KILL:
            fail(f"phase 10 kill: failures {fails}")
        retried = {rid for rid, evs in events.items()
                   if any(isinstance(e, RetryEvent) for e in evs)}
        if not retried or retried != set(fails[0].lost_rids):
            fail(f"phase 10 kill: retried {sorted(retried)}, lost "
                 f"{fails[0].lost_rids}")
        if got != streams["2 process"]:
            bad = [r for r in got if got[r] != streams["2 process"][r]]
            fail(f"phase 10 kill: retried streams differ for {bad}")
        t0 = time.perf_counter()
        while not backend.alive(1):
            if time.perf_counter() - t0 > 300:
                fail("phase 10 kill: the respawn never landed")
            router.poll()
            time.sleep(0.02)
        respawn_s = time.perf_counter() - fails[0].time_s
        info = backend.child_info[1]
        if info["torch_preloaded"] or info["memory_allocated"] >= weights:
            fail(f"phase 10 kill: respawned child {info}")
        # the respawned child captures its step graph at its first chunk
        for h in [router.submit(dataclasses.replace(r, rid=5000 + r.rid))
                  for r in reqs[:4]]:
            h.result()
        respawned = backend.child_stats()[1][1]

    dn = str(config.dtype).split(".")[1]
    for name, (wall, tok_s, ttfc) in readings.items():
        print(f"process containers (10): {cfg.name} {cfg.n_layers} layers "
              f"{dn} n_slots={config.n_slots} max_len={config.max_len} "
              f"chunk_tokens={config.chunk_tokens}, 8 requests prompts "
              f"{MAIN_PLENS} max_new={max_new}, {name}: wall_s={wall:.4f} "
              f"tok_per_s={tok_s:.2f} ttfc_p50_s={ttfc:.4f} [card: {card}]",
              flush=True)
    for name, (stats, mem, cores, start_s) in children.items():
        print(f"process containers (10), {name}: spawn + handshake "
              f"{start_s:.2f} s, cores {[sorted(c) for c in cores]}, "
              f"memory_allocated after taking the weights {mem} B (weights "
              f"{weights} B), per child launches "
              f"{[c for c, _ in stats]}, memory {[m for _, m in stats]} "
              f"[card: {card}]", flush=True)
    first_line = fails[0].message.splitlines()[0]
    print(f"process containers (10): streams of 2 process containers == 2 "
          f"threaded == 2 in turn, bit for bit; kill fault in container 1 "
          f"after 2 steps: {fails[0].kind} ({first_line}), "
          f"{len(retried)} requests retried with a RetryEvent, streams "
          f"equal to the fault-free run, wall_s={kill_wall:.4f}, respawn landed "
          f"{respawn_s:.2f} s after the failure (the respawned child "
          f"captures its step graph at its first chunk, after that: "
          f"capture_s={respawned.get('graph_capture_s')} pool_bytes="
          f"{respawned.get('graph_pool_bytes')}); MPS control daemon "
          f"running: {mps_running()} [card: {card}]", flush=True)
    total: dict = {}
    for counts, _ in children["2 process"][0]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# phase 11: the request contract of the fixed-count serving path
# ---------------------------------------------------------------------------
# one fixed 16-way logits row, the sampler's chi-square gate
LOGITS16 = [2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25,
            3.0, -2.0, 0.75, -0.25, 1.25, 0.1, -1.5, 2.5]
CACHE_BYTES = 28 * 2 * 4 * 2048 * 8 * 128 * 2   # qwen3's dense bf16 cache


def noise_advances(engine) -> int:
    """The step graph of a sampling engine (captured, requests active)
    replayed three times from the same slot state: the second replay
    keeps the random stream as the first replay advanced it and must
    sample another token in some active row; the third restores the
    first's stream and must give its tokens again. Each replay advances
    the draw by one. Returns the rows that differ. Leaves the engine
    unfit to serve on (its stream state on the card is rewritten)."""
    from repro_torch.models.sampling import new_key
    active = [i for i, s in enumerate(engine.slots) if s.active]
    if engine.greedy or engine._graph is None or not active:
        fail("noise check: needs a sampling engine with its graph and "
             "active rows")
    B = len(engine.slots)
    head = np.zeros(5 * B + 6, np.int32)
    for i in active:
        s = engine.slots[i]
        head[[i, B + i, 2 * B + i, 3 * B + i]] = (
            s.generated[-1], s.pos, s.remaining, 1)
    draw = engine.draws
    head[4 * B + 2:4 * B + 6].view(np.int64)[:] = new_key(
        engine.config.seed, draw).numpy()
    buf = engine._buf
    picks, keys = [], []
    with engine._on_stream():
        for restore_key in (True, False, True):
            part = head if restore_key else head[:4 * B + 2]
            buf["head"][:len(part)].copy_(torch.from_numpy(part))
            engine._graph.replay()
            picks.append(buf["block"][:, 0].cpu().numpy()[active])
            keys.append(buf["key"].tolist()[1])
    torch.cuda.synchronize()
    if keys != [draw + 1, draw + 2, draw + 1]:
        fail(f"noise check: draws after each replay {keys}, want "
             f"{[draw + 1, draw + 2, draw + 1]}")
    if not np.array_equal(picks[0], picks[2]):
        fail("noise check: the same stream state sampled other tokens")
    differ = int((picks[0] != picks[1]).sum())
    if not differ:
        fail("noise check: two consecutive replays drew the same tokens "
             "in every active row (the noise did not advance)")
    return differ


def step_replay_ms(model, params, greedy: bool, reps: int = 50) -> float:
    """Device ms of one 4-row qwen3 chunk step replayed from a CUDA graph
    (rows live to 48/160/300/544 and inactive, so their positions hold),
    greedy or sampling: ``reps`` replays back to back between two CUDA
    events."""
    cache = model.init_cache(4, 2048, torch.bfloat16)
    buf = model.chunk_buffers(4, reps + 8)   # a block column a step run
    buf["pos"].copy_(torch.tensor([48, 160, 300, 544], dtype=torch.int32))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def step():
        model.decode_chunk_step(params, cache, buf, max_len=2048,
                                greedy=greedy)
    from repro_torch.kernels.build import capture_tally
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()
        with capture_tally():
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, cache, buf
    return start.elapsed_time(end) / reps


def watch_rebuilds(backend) -> list:
    """Wrap a ThreadBackend's failure handling: for each rebuild from now
    on, ``(cid, incarnation, memory_allocated as the failure is handled,
    once the dead engine is dropped, once the new engine is built)``.
    Taken there, no other allocation falls between the readings; over a
    longer window cuBLAS adds a 32 MiB workspace for each new pair of a
    worker thread's handle and an engine's stream."""
    seen, entry = [], []
    fail, build = backend._fail_container, backend._build_engine

    def fail_container(cid, message):
        entry.append(torch.cuda.memory_allocated())
        fail(cid, message)

    def build_engine(cid, incarnation):
        dropped = torch.cuda.memory_allocated()
        eng = build(cid, incarnation)
        seen.append((cid, incarnation, entry[-1], dropped,
                     torch.cuda.memory_allocated()))
        return eng
    backend._fail_container = fail_container
    backend._build_engine = build_engine
    return seen


def count_captures(backend) -> list:
    """Wrap each engine's capture so the calls are counted per engine."""
    counts = []
    for eng in backend.engines:
        n = [0]
        real = eng._capture

        def capture(real=real, n=n):
            n[0] += 1
            real()
        eng._capture = capture
        counts.append(n)
    return counts


def request_contract_phase(model, params, card: str, max_new: int = 32):
    """Phase 11 on full-width qwen3-0.6b (bf16, phase 4's seeded weights,
    n_slots=4, max_len=2048, chunk_tokens=32): sampling inside the step
    graph (11a), the per-token baseline (11b), deadlines and shedding
    (11c) and ThreadBackend supervision (11d). Returns the phase's kernel
    launch counts."""
    import scipy.stats

    from repro_torch.kernels import ops
    from repro_torch.models.sampling import gumbel_argmax, new_key
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    from repro_torch.serving.events import (ContainerFailure, FailedEvent,
                                            RejectedEvent, RetryEvent)
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.router import (RequestFailed, RequestRejected,
                                            Router)

    cfg = model.cfg
    base = dict(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                chunk_tokens=32)
    rng = np.random.default_rng(11)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                    dtype=np.int32), max_new)
            for i, n in enumerate(MAIN_PLENS)]
    phase_t0 = time.perf_counter()
    ops.reset_launch_counts()
    parts = {}

    def complete(tokens, what):
        if sorted(tokens) != [r.rid for r in reqs] or any(
                len(t) != max_new or not all(0 <= x < cfg.vocab_size
                                             for x in t)
                for t in tokens.values()):
            fail(f"phase 11 {what}: not every request completed with "
                 f"{max_new} tokens")

    # -- 11a: sampling inside the step graph ---------------------------
    t0 = time.perf_counter()
    sampled = {}
    for seed in (7, 7, 8):
        config = EngineConfig(greedy=False, seed=seed, **base)
        with Router(ThreadBackend(model, params, 2, config)) as router:
            tokens, _, _ = serve_timed(router, reqs)
        complete(tokens, f"11a seed {seed}")
        sampled.setdefault(seed, []).append(tokens)
    if sampled[7][0] != sampled[7][1]:
        fail("phase 11a: the same seed sampled other streams")
    if sampled[8][0] == sampled[7][0]:
        fail("phase 11a: seed 8 sampled seed 7's streams")
    n_diff = sum(a != b for r in sampled[7][0] for a, b in
                 zip(sampled[7][0][r], sampled[8][0][r]))
    # one sampling engine: the replayed chunk against the eager chunk,
    # then consecutive replays against each other
    eng = ServingEngine(model, params,
                        EngineConfig(greedy=False, seed=7, **base))
    eng.submit_many([dataclasses.replace(r) for r in reqs[:4]])
    eng.step()
    graph_vs_eager(eng, "phase 11a, sampling, dense bf16 cache", card)
    differ = noise_advances(eng)
    del eng
    # chunked and per-token engines with one seed, one engine each
    streams = {}
    for chunked in (True, False):
        eng = ServingEngine(model, params, EngineConfig(
            greedy=False, seed=7, chunked=chunked, **base))
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        streams[chunked] = {c.rid: list(c.tokens) for c in eng.run()}
        complete(streams[chunked], f"11a chunked={chunked}")
        if chunked:
            draws = eng.draws
        elif eng.draws != draws:
            fail(f"phase 11a: per-token engine took {eng.draws} draws, "
                 f"the chunked one {draws}")
        del eng
    if streams[True] != streams[False]:
        bad = [r for r in streams[True] if streams[True][r] !=
               streams[False][r]]
        fail(f"phase 11a: sampled per-token streams differ from the "
             f"chunked engine's for requests {bad}")
    # the sampler alone: one 16-way row repeated 20,000 times, one call
    n = 20_000
    row = torch.tensor(LOGITS16, dtype=torch.float64)
    p = torch.softmax(row, 0).numpy()
    logits = row.float().cuda().repeat(n, 1)
    picks = gumbel_argmax(logits, new_key(7, 0, "cuda")).cpu().numpy()
    chi = scipy.stats.chisquare(np.bincount(picks, minlength=16), p * n)
    if not chi.pvalue > 1e-3:
        fail(f"phase 11a: sampler frequencies fail chi-square against "
             f"softmax (p = {chi.pvalue:.3e})")
    # a 4-row step replayed, greedy against sampling, in turns; and the
    # sampler alone over a step's logits
    walls = [step_replay_ms(model, params, g)
             for g in (True, False, False, True)]
    step_logits = torch.randn(4, cfg.vocab_size, device="cuda").to(
        torch.bfloat16)
    key = new_key(7, 0, "cuda")
    sampler_ms = time_graph_ms(lambda: gumbel_argmax(step_logits, key))
    parts["11a"] = time.perf_counter() - t0
    print(f"request contract (11a), sampling: Router(ThreadBackend(2)) "
          f"greedy=False seed=7 served {len(reqs)} requests prompts "
          f"{MAIN_PLENS} max_new={max_new}, every request complete; seed 7 "
          f"twice gives identical streams, seed 8 differs in {n_diff} of "
          f"{len(reqs) * max_new} tokens; per-token (chunked=False) == "
          f"chunked sampled streams ({draws} draws each); two consecutive "
          f"replays from one slot state sampled other tokens in {differ} "
          f"of 4 rows, the restored stream state the same tokens; sampler "
          f"chi-square over {n} draws of a 16-way row p={chi.pvalue:.4f} "
          f"[card: {card}]", flush=True)
    print(f"request contract (11a), a 4-row qwen3 step replayed from a "
          f"graph (rows live to 48/160/300/544), device ms in turns greedy "
          f"{walls[0]:.4f} / sampling {walls[1]:.4f} / sampling "
          f"{walls[2]:.4f} / greedy {walls[3]:.4f}; the sampler alone over "
          f"4 x {cfg.vocab_size} bf16 logits {sampler_ms:.5f} ms (graph "
          f"replay) [card: {card}]", flush=True)

    # -- 11b: the per-token baseline -----------------------------------
    t0 = time.perf_counter()
    readings, greedy = {}, {}
    for chunked in (True, False):
        eng = ServingEngine(model, params,
                            EngineConfig(chunked=chunked, **base))
        eng.submit_many([Request(900, reqs[0].prompt, 4)])
        eng.run()                      # warm-up (and the capture)
        torch.cuda.synchronize()
        reads, before = eng.host_reads, ops.launch_counts()
        t1 = time.perf_counter()
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        greedy[chunked] = {c.rid: list(c.tokens) for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        after = ops.launch_counts()
        complete(greedy[chunked], f"11b chunked={chunked}")
        n_tok = sum(len(t) for t in greedy[chunked].values())
        readings[chunked] = (wall, n_tok / wall, eng.host_reads - reads,
                             sum(after.values()) - sum(before.values()))
        del eng
    if greedy[True] != greedy[False]:
        bad = [r for r in greedy[True] if greedy[True][r] != greedy[False][r]]
        fail(f"phase 11b: per-token greedy streams differ from the chunked "
             f"engine's for requests {bad}")
    parts["11b"] = time.perf_counter() - t0
    fmt = "wall_s={:.4f} tok_per_s={:.2f} host_reads={} kernel_launches={}"
    print(f"request contract (11b), one engine, {len(reqs)} requests "
          f"prompts {MAIN_PLENS} max_new={max_new}, greedy: per-token "
          f"(chunked=False) {fmt.format(*readings[False])}; chunked "
          f"{fmt.format(*readings[True])}; speedup "
          f"{readings[True][1] / readings[False][1]:.2f}x; streams equal "
          f"[card: {card}]", flush=True)

    # -- 11c: deadlines and shedding -----------------------------------
    t0 = time.perf_counter()
    paged = EngineConfig(cache="paged", block_size=16, max_seqs=4, **base)
    backend = ThreadBackend(model, params, 1, paged)
    captures = count_captures(backend)
    with Router(backend, request_deadline_s=1e-4) as router:
        h = router.submit(Request(0, reqs[1].prompt, 300))
        try:
            h.result()
            fail("phase 11c: a 1e-4 s deadline did not fail")
        except RequestFailed as e:
            if not isinstance(e.event, FailedEvent) or \
                    e.event.kind != "deadline":
                fail(f"phase 11c: deadline failure {e.event}")
            first_reason = e.event.reason
        router.request_deadline_s = None
        ok = router.submit(Request(1, reqs[1].prompt, max_new)).tokens()
        eng = backend.engines[0]
        cb = eng.cache_backend
        cb.flush()
        if len(ok) != max_new or eng.has_work or cb.n_live_blocks or \
                cb.allocator.n_free != cb.layout.max_blocks:
            fail(f"phase 11c: after the deadline, {len(ok)} tokens, work "
                 f"{eng.has_work}, {cb.n_live_blocks} live blocks, "
                 f"{cb.allocator.n_free} of {cb.layout.max_blocks} free")
        paged_replays = eng.graph_replays
    backend = ThreadBackend(model, params, 1, EngineConfig(**base))
    captures += count_captures(backend)
    with Router(backend, deadline_grace_s=60.0, max_queue=4) as router:
        eng = backend.engines[0]
        h = router.submit(Request(2, reqs[0].prompt, 500, deadline_s=0.35))
        t1 = time.perf_counter()
        try:
            h.result()
            fail("phase 11c: the mid-decode deadline did not fail")
        except RequestFailed as e:
            if e.event.kind != "deadline" or \
                    "mid-decode" not in e.event.reason:
                fail(f"phase 11c: mid-decode failure {e.event}")
            mid_reason, mid_s = e.event.reason, time.perf_counter() - t1
        if eng.has_work:
            fail("phase 11c: the expired request kept its slot")
        replays0 = eng.graph_replays
        handles = [router.submit(dataclasses.replace(r, rid=100 + r.rid))
                   for r in reqs]
        rejected = [h for h in handles if isinstance(h.failure,
                                                     RejectedEvent)]
        hints = {h.failure.retry_after_s for h in rejected}
        for h in rejected:
            try:
                h.result()
                fail("phase 11c: a shed request completed")
            except RequestRejected:
                pass
        served = [h for h in handles if h not in rejected]
        lens = [len(h.tokens()) for h in served]
        if len(rejected) != 4 or hints != {0.25} or \
                router.shed_total != 4 or lens != [max_new] * 4:
            fail(f"phase 11c: max_queue=4 over 8 submissions: "
                 f"{len(rejected)} rejected, hints {hints}, shed_total "
                 f"{router.shed_total}, served lengths {lens}")
        if eng.graph_replays <= replays0:
            fail("phase 11c: the served requests replayed no graph")
    if [c[0] for c in captures] != [1, 1]:
        fail(f"phase 11c: captures per engine {[c[0] for c in captures]}")
    parts["11c"] = time.perf_counter() - t0
    print(f"request contract (11c): request_deadline_s=1e-4 over a paged "
          f"engine fails typed ('{first_reason}'), then an undeadlined "
          f"request completes and all blocks are back in the pool "
          f"({paged_replays} replays); deadline_s=0.35 max_new=500 fails "
          f"after {mid_s:.3f} s ('{mid_reason}') and frees its slot; "
          f"max_queue=4 over 8 submissions: 4 RejectedEvent (retry_after_s "
          f"0.25), 4 complete; one capture an engine [card: {card}]",
          flush=True)

    # -- 11d: ThreadBackend supervision --------------------------------
    t0 = time.perf_counter()
    rng10 = np.random.default_rng(10)      # phase 10's requests
    reqs10 = [Request(i, rng10.integers(0, cfg.vocab_size, (n,),
                                        dtype=np.int32), max_new)
              for i, n in enumerate(MAIN_PLENS)]
    config = EngineConfig(**base)
    with Router(ThreadBackend(model, params, 2, config)) as router:
        want, _, _ = serve_timed(router, reqs10)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # one warm-up step an engine (its graph, its stream's cuBLAS
    # workspace), then the error two steps into phase 10's requests
    plan = FaultPlan((Fault("error", container_id=1, after_steps=3),))
    backend = ThreadBackend(model, params, 2, config, fault_plan=plan)
    with Router(backend, max_retries=2) as router:
        for h in [router.submit(Request(1000 + i, reqs10[i].prompt, 2))
                  for i in range(2)]:
            h.result()
        if any(e._graph is None for e in backend.engines):
            fail("phase 11d: the warm-up left an engine without its graph")
        rebuilds = watch_rebuilds(backend)
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        got, (fault_wall, _, _), events = serve_timed(router, reqs10)
        fails = router.container_failures
        if len(fails) != 1 or not isinstance(fails[0], ContainerFailure) \
                or fails[0].kind != "error" or fails[0].container_id != 1:
            fail(f"phase 11d: failures {fails}")
        retried = {rid for rid, evs in events.items()
                   if any(isinstance(e, RetryEvent) for e in evs)}
        if not retried or retried != set(fails[0].lost_rids):
            fail(f"phase 11d: retried {sorted(retried)}, lost "
                 f"{fails[0].lost_rids}")
        if got != want:
            bad = [r for r in got if got[r] != want[r]]
            fail(f"phase 11d: streams after the rebuild differ from the "
                 f"fault-free run for {bad}")
        new = backend.engines[1]
        if new.graph_capture_s is None:
            # the rebuilt engine captures at its first chunk
            for h in [router.submit(dataclasses.replace(r, rid=500 + r.rid))
                      for r in reqs10[:2]]:
                h.result()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        rebuild_s, capture_s = backend.rebuild_s[1], new.graph_capture_s
        if capture_s is None or not backend.alive(1):
            fail("phase 11d: the rebuilt engine never captured its graph")
        if len(rebuilds) != 1:
            fail(f"phase 11d: rebuilds {rebuilds}")
        _, _, mem_failed, mem_dropped, mem_built = rebuilds[0]
        # the dead engine's cache is gone before the new one allocates;
        # over the whole run only cuBLAS workspaces may add
        if mem_failed - mem_dropped < CACHE_BYTES or \
                mem_after - mem_before >= CACHE_BYTES // 2:
            fail(f"phase 11d: memory_allocated {mem_before} B before the "
                 f"run, {mem_failed} B at the failure, {mem_dropped} B once "
                 f"the dead engine was dropped, {mem_after} B after the "
                 f"rebuild: the dead engine's {CACHE_BYTES} B cache stayed "
                 f"allocated")
    del backend, new
    torch.cuda.empty_cache()
    plan = FaultPlan((Fault("error", container_id=1, after_steps=1,
                            incarnation=None),))
    backend = ThreadBackend(model, params, 2, config, fault_plan=plan,
                            max_respawns=1)
    with Router(backend, max_retries=3) as router:
        broken, _, _ = serve_timed(router, reqs10)
        complete(broken, "11d breaker")
        if backend.alive(1) or len(router.container_failures) != 2:
            fail(f"phase 11d: breaker: alive {backend.alive(1)}, failures "
                 f"{len(router.container_failures)}")
        after = [router.submit(dataclasses.replace(r, rid=700 + r.rid))
                 for r in reqs10[:4]]
        if any(h.container_id != 0 for h in after) or any(
                len(h.tokens()) != max_new for h in after):
            fail("phase 11d: after the breaker the Router did not serve "
                 "on container 0 alone")
    del backend
    torch.cuda.empty_cache()
    parts["11d"] = time.perf_counter() - t0
    print(f"request contract (11d): an error fault in container 1 two "
          f"steps into the run (after a warm-up step): one "
          f"ContainerFailure(kind='error'), {len(retried)} "
          f"requests retried with a RetryEvent, streams equal to the "
          f"fault-free run (wall_s={fault_wall:.4f}); the rebuild took "
          f"{rebuild_s:.4f} s (engine and cache) + {capture_s:.4f} s (its "
          f"graph capture at its first chunk); memory_allocated "
          f"{mem_before} B before the run, {mem_failed} B at the failure, "
          f"{mem_dropped} B once the dead engine was dropped, {mem_built} B "
          f"with the new engine built, {mem_after} B after the rebuild "
          f"served (the dead engine's cache is {CACHE_BYTES} B); a fault "
          f"in every incarnation trips the breaker after 1 respawn and "
          f"the Router serves on container 0 alone [card: {card}]",
          flush=True)
    launches = ops.launch_counts()
    print(f"request contract (11): parts in s "
          f"{ {k: round(v, 2) for k, v in parts.items()} }, whole phase "
          f"{time.perf_counter() - phase_t0:.2f} s, launches {launches} "
          f"[card: {card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8b: the paged cache over mamba2's state rows
# ---------------------------------------------------------------------------
# phase 5's groups at lengths mamba2's scan chunk (min(256, S)) divides:
# every prompt of at most 256 tokens, then multiples of 256
SSM_PARITY_GROUPS = [((150, 200, 256, 180), 24), ((40, 50, 64, 33), 32),
                     ((512, 768, 1024), 16)]


def full_width_ssm():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    model = Model(get_config("mamba2-2.7b"))
    return model, model.init(seed=0, dtype=torch.bfloat16)


def ssm_paged_phase(model, params, card: str):
    """Phase 8b: one dense (n_slots 4) and one paged engine (block_size 16,
    max_seqs 8, the dense footprint of 512 blocks) over full-width
    mamba2-2.7b serve ``SSM_PARITY_GROUPS``: identical greedy streams, the
    paged engine with more sequences in flight than the dense one has
    slots, and ``graph_vs_eager`` on both (``parity_phase``). The paged
    tree has no paged group: the conv and state rows stay dense, sized by
    max_seqs. Returns the two engines' summed launches."""
    from repro_torch.serving.engine import EngineConfig

    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16, block_size=16, max_seqs=8)
    peaks: list[int] = []
    dense, paged = parity_phase(model, params, config, card,
                                groups=SSM_PARITY_GROUPS, peaks=peaks)
    if peaks[1] <= config.n_slots:
        fail(f"phase 8b: the paged engine peaked at {peaks[1]} sequences, "
             f"not more than the dense engine's {config.n_slots} slots")
    if dense["ssd_scan"] <= 0 or paged["ssd_scan"] != dense["ssd_scan"]:
        fail(f"phase 8b: ssd_scan launches dense {dense['ssd_scan']}, "
             f"paged {paged['ssd_scan']}")
    if any(dense[k] or paged[k] for k in ATTENTION_KERNELS):
        fail(f"phase 8b: attention kernels launched: {dense} {paged}")
    row = tree_bytes(model.init_cache(1, config.max_len, config.dtype))
    print(f"paged ssm (8b): peak_active dense {peaks[0]}, paged {peaks[1]} "
          f"(max_seqs {config.max_seqs}, max_blocks "
          f"{config.resolved_max_blocks}); SSM row bytes per sequence "
          f"{row} (conv tails + states, {model.cfg.n_layers} layers), "
          f"{row * config.max_seqs} B for the paged engine's rows "
          f"[card: {card}]", flush=True)
    return {k: n + paged[k] for k, n in dense.items()}


# ---------------------------------------------------------------------------
# phase 12: the online container-count loop
# ---------------------------------------------------------------------------
ONLINE_WINDOWS = 6


class PowerMeter:
    """The card's draw from ``nvidia-smi --query-gpu=power.draw`` every
    ``interval_ms`` (100 ms unless given), read by a helper thread: ``joules(t0, t1, wall)`` is the mean
    draw of the samples stamped in [t0, t1] times ``wall``. Read and
    printed only; nothing steers by it."""

    def __init__(self, interval_ms: int = 100):
        import threading

        self.samples: list[tuple[float, float]] = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", str(interval_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                watts = float(line.strip())
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), watts))

    def joules(self, t0: float, t1: float, wall: float):
        """(joules, samples), or (None, 0) with no sample in [t0, t1]."""
        got = [w for t, w in list(self.samples) if t0 <= t <= t1]
        if not got:
            return None, 0
        return sum(got) / len(got) * wall, len(got)

    def close(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.thread.join(timeout=10)


def measured(meter, t0, t1, wall) -> str:
    joules, n = meter.joules(t0, t1, wall)
    if joules is None:
        return "measured_j=not measured (no power.draw sample)"
    return f"measured_j={joules:.4f} ({n} power.draw samples)"


def online_requests(cfg, seed: int, max_new: int = 32) -> list:
    """ONLINE_WINDOWS windows of phase 4's 8 prompt lengths, each with
    tokens of its own, max_new 32."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [[Request(w * 8 + i, rng.integers(0, cfg.vocab_size, (n,),
                                             dtype=np.int32), max_new)
             for i, n in enumerate(MAIN_PLENS)]
            for w in range(ONLINE_WINDOWS)]


def warm_backend(backend, cfg, rng) -> None:
    """Every container of ``backend`` admits a request and decodes: its
    first cuBLAS calls, its allocations and its graph capture, before any
    window's clock."""
    from repro_torch.serving.engine import Request

    for cid in range(backend.capacity):
        backend.submit(cid, Request(9000 + cid, rng.integers(
            0, cfg.vocab_size, (20,), dtype=np.int32), 4))
    while any(backend.load(cid) for cid in range(backend.capacity)):
        backend.poll()
    backend.poll()
    torch.cuda.synchronize()


def online_loop_phase(model, params, card: str):
    """Phase 12 on full-width qwen3-0.6b (bf16, phase 4's seeded weights,
    n_slots=4, max_len=2048, chunk_tokens=32, one request a prefill so a
    request's bits do not depend on which container, or which batch, it
    landed in; written when cuBLAS gave a bf16 prefill row other bits at
    other batch sizes, before bf16 prefill products were sliced, see
    ``ROW_SLICE`` in ``models/layers.py``):

    a. ``Router(backend_factory=n -> ThreadBackend(n), feasible_counts=
       card_feasible_counts(..., max_containers=4), window=8, epsilon=0,
       objective="energy")`` serves 6 windows of phase 4's traffic,
       drained window by window. Per window: n, wall, EnergyProxy J, the
       card's measured J, tok/s, ttfc p50/p95. Gates: the bootstrap visits
       every feasible count, each count's backend is built once, and every
       request's greedy tokens equal a fixed Router(ThreadBackend(1))'s.
    b. ``AdaptiveServingPool`` (threads) over the same traffic as 6 waves:
       the same tokens, its history printed.
    c. One wave through ``ProcessContainerPool(2)`` (pinned children, the
       weights over CUDA IPC) against ``ContainerServingPool(2)``:
       identical ordered completions; walls and proxy energies printed.

    Each count's backend or pool serves a warm-up request a container
    before the loop, so no window pays a graph capture. Returns 12a's
    kernel launches."""
    from repro_torch.core.containers import card_feasible_counts
    from repro_torch.kernels import ops
    from repro_torch.serving.adaptive import AdaptiveServingPool
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.pool import ContainerServingPool
    from repro_torch.serving.process_pool import ProcessContainerPool
    from repro_torch.serving.router import Router

    cfg = model.cfg
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16, batch_admit=False)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    counts = card_feasible_counts(cfg, config, card_bytes=card_bytes,
                                  max_containers=4)
    if len(counts) < 2:
        fail(f"phase 12: feasible counts {counts} on {card_bytes} B")
    windows = online_requests(cfg, seed=12)
    flat = [r for w in windows for r in w]
    rng = np.random.default_rng(13)
    phase_t0 = time.perf_counter()

    # the reference: one container, fixed
    with Router(ThreadBackend(model, params, 1, config)) as fixed:
        warm_backend(fixed.backend, cfg, rng)
        want = {h.rid: h.tokens() for h in [
            fixed.submit(dataclasses.replace(r)) for r in flat]}

    meter = PowerMeter()
    try:
        # 12a: the adaptive Router
        warm = {}
        for n in counts:
            warm[n] = ThreadBackend(model, params, n, config)
            warm_backend(warm[n], cfg, rng)
        built: list[int] = []

        def factory(n):
            built.append(n)
            return warm[n]
        got = {}
        ops.reset_launch_counts()
        with Router(backend_factory=factory, feasible_counts=counts,
                    window=8, epsilon=0.0, objective="energy") as router:
            for w, reqs in enumerate(windows):
                t0 = time.perf_counter()
                handles = [router.submit(dataclasses.replace(r))
                           for r in reqs]
                router.drain()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got.update({h.rid: list(h.completion.tokens)
                            for h in handles})
                if len(router.history) != w + 1:
                    fail(f"phase 12a: {len(router.history)} windows after "
                         f"{w + 1} drained")
                ws = router.history[-1]
                print(f"online loop (12a) window {w}: n={ws.n_containers} "
                      f"wall_s={ws.wall_s:.4f} proxy_j={ws.energy_j:.4f} "
                      f"{measured(meter, t0, t1, ws.wall_s)} "
                      f"tok_per_s={ws.tokens_per_s:.2f} ttfc_p50_s="
                      f"{ws.ttfc_p50_s:.4f} ttfc_p95_s={ws.ttfc_p95_s:.4f} "
                      f"[card: {card}]", flush=True)
            launches = ops.launch_counts()
            summary, choice = router.scheduler.summary(), router.choice
            history = list(router.history)
        print(f"online loop (12a): feasible counts {counts} from "
              f"card_feasible_counts on {card_bytes} B, counts by window "
              f"{[w.n_containers for w in history]}, scheduler summary "
              f"{summary}, choice {choice}, backends built {built}; "
              f"launches {launches} [card: {card}]", flush=True)
        if {w.n_containers for w in history[:len(counts)]} != set(counts):
            fail(f"phase 12a: the bootstrap visited "
                 f"{[w.n_containers for w in history]}, not every count of "
                 f"{counts}")
        if len(built) != len(set(built)):
            fail(f"phase 12a: backends built {built}: a count twice")
        if got != want:
            bad = [rid for rid in want if got.get(rid) != want[rid]]
            fail(f"phase 12a: requests {bad} differ from the fixed "
                 "Router(ThreadBackend(1))'s greedy tokens")
        for k in ("flash_attention", "decode_attention"):
            if launches[k] <= 0:
                fail(f"phase 12a: {k} never launched: {launches}")
        check_norm_launches(cfg, launches, "phase 12a")
        del warm
        torch.cuda.empty_cache()

        # 12b: the adaptive pool over waves
        def pool_factory(n):
            pool = ContainerServingPool(model, params, n, config)
            warm_backend(pool.backend, cfg, rng)
            return pool
        apool = AdaptiveServingPool(model, params, counts,
                                    objective="energy", config=config,
                                    pool_factory=pool_factory)
        got = {}
        for w, reqs in enumerate(windows):
            t0 = time.perf_counter()
            out = apool.serve_wave([dataclasses.replace(r) for r in reqs])
            t1 = time.perf_counter()
            if [c.rid for c in out] != [r.rid for r in reqs]:
                fail(f"phase 12b: wave {w} came back out of order")
            got.update({c.rid: list(c.tokens) for c in out})
            h = apool.history[-1]
            print(f"adaptive pool (12b) wave {w}: n={h.n_containers} "
                  f"wall_s={h.wall_s:.4f} proxy_j={h.energy_j:.4f} "
                  f"{measured(meter, t0, t1, h.wall_s)} "
                  f"tok_per_s={h.tokens_per_s:.2f} latency_p50_s="
                  f"{h.latency_p50_s:.4f} latency_p95_s="
                  f"{h.latency_p95_s:.4f} [card: {card}]", flush=True)
        print(f"adaptive pool (12b): counts by wave "
              f"{[h.n_containers for h in apool.history]}, choice "
              f"{apool.choice} [card: {card}]", flush=True)
        apool.close()
        torch.cuda.empty_cache()
        if got != want:
            bad = [rid for rid in want if got.get(rid) != want[rid]]
            fail(f"phase 12b: requests {bad} differ from the fixed "
                 "Router(ThreadBackend(1))'s greedy tokens")

        # 12c: one wave in pinned processes against the same in threads
        wave = windows[0]
        out = {}
        for name, pool in (
                ("2 threaded", ContainerServingPool(model, params, 2,
                                                    config)),
                ("2 process", ProcessContainerPool(cfg, 2, config,
                                                   params=params,
                                                   allow_shared_cores=True,
                                                   start_timeout_s=300))):
            try:
                # warm-up wave: spawn, first cuBLAS calls, graph captures
                pool.serve_timed([dataclasses.replace(r, rid=r.rid + 500)
                                  for r in wave])
                t0 = time.perf_counter()
                ordered, _, wall, energy = pool.serve_timed(
                    [dataclasses.replace(r) for r in wave])
                t1 = time.perf_counter()
            finally:
                pool.close()
            out[name] = [(c.rid, list(c.tokens)) for c in ordered]
            print(f"process pool (12c) {name}: one wave of 8, wall_s="
                  f"{wall:.4f} proxy_j={energy:.4f} "
                  f"{measured(meter, t0, t1, wall)} [card: {card}]",
                  flush=True)
        if out["2 process"] != out["2 threaded"]:
            fail("phase 12c: the process pool's ordered completions differ "
                 "from the thread pool's")
        if [t for _, t in out["2 threaded"]] != [want[r.rid] for r in wave]:
            fail("phase 12c: the pools' tokens differ from the fixed "
                 "Router(ThreadBackend(1))'s")
    finally:
        meter.close()
    if multiprocessing.active_children():
        fail(f"phase 12 left processes running: "
             f"{multiprocessing.active_children()}")
    print(f"online loop (12): whole phase "
          f"{time.perf_counter() - phase_t0:.2f} s [card: {card}]",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: trace replay and SLO classes
# ---------------------------------------------------------------------------
# the diurnal-bursty preset at the benchmark's trace seed, its first 96
# arrivals, replayed open-loop 10x compressed under two classes
SLO13 = "interactive:0.5,batch:8.0"
TRACE13_SEED = 1
TRACE13_N = 96
TIME_SCALE13 = 10.0
CLI13 = ["--arch", "qwen3-0.6b", "--trace", "bursty", "--time-scale", "10",
         "--priority-classes", SLO13, "--tenant-quota", "8",
         "--containers", "2", "--cache", "paged", "--prefix-cache"]
CLI13_TIMEOUT_S = 400
REPORT13 = (r"^trace (\S+) \(seed (\d+), time_scale ([\d.]+)\): (\d+)/(\d+) "
            r"done, (\d+) shed, (\d+) failed in ([\d.]+)s$")


def trace13(n: int = TRACE13_N):
    """The phase's trace: diurnal-bursty, seed 1, its first ``n``
    arrivals."""
    from repro_torch.workload.traces import get_preset, synthesize

    trace = synthesize(get_preset("diurnal-bursty"), seed=TRACE13_SEED)
    return dataclasses.replace(trace, requests=trace.requests[:n])


def slo_replay(router, trace, vocab_size: int):
    """Replay ``trace`` open-loop through an SLO ``router``, logging each
    dispatch beside the backlog still live at that moment: (dispatched
    (rank, rid), the lowest live (rank, rid) or None). Returns (report,
    handles, log)."""
    from repro_torch.workload.replay import replay

    backend, slo = router.backend, router.slo
    log, handles = [], []
    submit_backend, submit_router = backend.submit, router.submit

    def logged(cid, req):
        live = [(rank, rid) for rank, _, rid in router._backlog
                if rid in router._handles and rid not in router._rid_cid]
        log.append(((slo.cls(req.priority).rank, req.rid),
                    min(live) if live else None))
        submit_backend(cid, req)

    def kept(req):
        h = submit_router(req)
        handles.append(h)
        return h
    backend.submit = logged
    router.submit = kept
    report = replay(trace, router, time_scale=TIME_SCALE13,
                    vocab_size=vocab_size)
    return report, handles, log


def check_slo_run(report, handles, log, slo, n: int, what: str) -> dict:
    """The SLO run's gates: one terminal a request, every request counted,
    dispatch in (rank, arrival) order of the live backlog, every
    rejection typed with its class. Returns the completed tokens by
    rid."""
    from repro_torch.serving.events import (DoneEvent, FailedEvent,
                                            RejectedEvent)
    from repro_torch.serving.router import RequestFailed

    if report.n_done + report.n_shed + report.n_failed != n \
            or report.n_requests != n or len(handles) != n:
        fail(f"{what}: {report.n_done} done + {report.n_shed} shed + "
             f"{report.n_failed} failed of {report.n_requests} "
             f"({len(handles)} handles), not {n}")
    done = {}
    for h in handles:
        terminals = []
        try:
            for ev in h.stream():
                if isinstance(ev, (DoneEvent, FailedEvent, RejectedEvent)):
                    terminals.append(ev)
        except RequestFailed:
            pass
        if len(terminals) != 1:
            fail(f"{what}: request {h.rid} ended in {len(terminals)} "
                 "terminal events")
        ev = terminals[0]
        if isinstance(ev, RejectedEvent):
            if ev.kind not in ("queue", "slo", "tenant") \
                    or ev.priority not in slo.names():
                fail(f"{what}: request {h.rid} rejected with kind "
                     f"{ev.kind!r}, class {ev.priority!r}")
        elif isinstance(ev, DoneEvent):
            done[h.rid] = list(h.completion.tokens)
    for got, lowest in log:
        if lowest is not None and got > lowest:
            fail(f"{what}: dispatched (rank, rid) {got} while {lowest} "
                 "waited in the backlog")
    return done


def print_report(report, what: str, card: str) -> None:
    classes = "; ".join(
        f"{name}: done {cw.n_done} shed {cw.n_shed} failed {cw.n_failed} "
        f"ttfc_p95_s={cw.ttfc_p95_s:.4f} attained {cw.attained}"
        for name, cw in sorted(report.per_class.items()))
    print(f"{what}: {report.n_done}/{report.n_requests} done, "
          f"{report.n_shed} shed, {report.n_failed} failed, duration_s="
          f"{report.duration_s:.4f} goodput_rps={report.goodput_rps:.4f} "
          f"ttfc_p95_s={report.ttfc_p95_s:.4f} proxy_j={report.energy_j:.4f}"
          f" counts_visited {list(report.counts_visited)} final_n "
          f"{report.final_n}; {classes} [card: {card}]", flush=True)


def slo_trace_phase(model, params, card: str):
    """Phase 13 on full-width qwen3-0.6b (bf16, phase 4's seeded weights,
    n_slots=4, max_len=2048, chunk_tokens=32, one request a prefill):
    the first 96 arrivals of diurnal-bursty (seed 1), replayed open-loop
    at time_scale 10, prompts over the full vocabulary, under
    ``interactive:0.5,batch:8.0``.

    a. ``Router(ThreadBackend(2), slo, tenant_quota=8, max_queue=32)``
       through ``workload.replay``. Gates: one terminal a request, 96
       accounted, each dispatch the lowest (rank, arrival) of the live
       backlog, rejections typed with their class, and every completed
       request's greedy tokens those of a fixed Router(ThreadBackend(2))
       without an SLO, fed one request at a time.
    b. The adaptive Router over ``card_feasible_counts`` (at most 4),
       ``objective="energy_under_slo"``, window 16, window_s 5, beside
       the SLO-blind adaptive Router (``objective="energy"``): per window
       n, wall, proxy J, the card's J and ``per_class``; each report's
       goodput, per-class p95 and attainment, counts visited, final n.
       Gates: both account for the 96, per_class names spec classes only.
    c. The launcher, ``python -m repro_torch.launch.serve`` in the trace
       mode on paged engines with prefix sharing, as a subprocess: exit 0
       and its report line parsed. Its kernel launches are its own.

    Returns the launches of 13a, 13b (both runs) and 13c."""
    from repro_torch.core.containers import card_feasible_counts
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.router import Router
    from repro_torch.workload.replay import build_request, replay
    from repro_torch.workload.slo import SLOSpec

    cfg = model.cfg
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16, batch_admit=False)
    slo = SLOSpec.parse(SLO13)
    trace = trace13()
    rng = np.random.default_rng(14)
    phase_t0 = time.perf_counter()

    # 13a: the fixed SLO Router
    backend = ThreadBackend(model, params, 2, config)
    warm_backend(backend, cfg, rng)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with Router(backend, slo=slo, tenant_quota=8, max_queue=32) as router:
        report, handles, log = slo_replay(router, trace, cfg.vocab_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_a = ops.launch_counts()
        done = check_slo_run(report, handles, log, slo, TRACE13_N,
                             "phase 13a")
    print_report(report, f"slo replay (13a) wall_s={wall:.4f}", card)
    print(f"slo replay (13a): {len(log)} dispatches, "
          f"{sum(1 for _, low in log if low is not None)} with a live "
          f"backlog; launches {launches_a} [card: {card}]", flush=True)
    by_rid = {tr.rid: tr for tr in trace.requests}
    t0 = time.perf_counter()
    with Router(ThreadBackend(model, params, 2, config)) as plain:
        want = {rid: plain.submit(build_request(
            by_rid[rid], vocab_size=cfg.vocab_size)).tokens()
                for rid in sorted(done)}
    print(f"slo replay (13a): the plain Router's {len(want)} requests one "
          f"at a time in {time.perf_counter() - t0:.4f} s [card: {card}]",
          flush=True)
    if done != want:
        bad = [rid for rid in want if done.get(rid) != want[rid]]
        fail(f"phase 13a: requests {bad} differ from the plain fixed "
             "Router's greedy tokens")
    for k in ("flash_attention", "decode_attention"):
        if launches_a[k] <= 0:
            fail(f"phase 13a: {k} never launched: {launches_a}")
    check_norm_launches(cfg, launches_a, "phase 13a")
    torch.cuda.empty_cache()

    # 13b: the adaptive Router, with the SLO and without
    counts = card_feasible_counts(
        cfg, config, max_containers=4,
        card_bytes=torch.cuda.get_device_properties(0).total_memory)
    launches_b = {k: 0 for k in ops.COUNTERS}
    meter = PowerMeter()
    try:
        for name, kw in (("slo", dict(slo=slo, tenant_quota=8,
                                      max_queue=32,
                                      objective="energy_under_slo")),
                         ("blind", dict(max_queue=32,
                                        objective="energy"))):
            warm = {}
            for n in counts:
                warm[n] = ThreadBackend(model, params, n, config)
                warm_backend(warm[n], cfg, rng)
            stamps = []
            ops.reset_launch_counts()
            with Router(backend_factory=warm.__getitem__,
                        feasible_counts=counts, window=16, window_s=5.0,
                        epsilon=0.0, **kw) as router:
                observe = router._observe_window

                def stamped(repick=True, router=router, observe=observe):
                    t_open = router._window_t0
                    observe(repick)
                    stamps.append((t_open, time.perf_counter()))
                router._observe_window = stamped
                report = replay(trace, router, time_scale=TIME_SCALE13,
                                vocab_size=cfg.vocab_size)
                torch.cuda.synchronize()
                history = list(router.history)
                summary = router.scheduler.summary()
            for n in warm:
                warm[n].close()
            for k, v in ops.launch_counts().items():
                launches_b[k] += v
            for w, (t_open, t_close) in zip(history, stamps):
                classes = "; ".join(
                    f"{c}: done {cw.n_done} shed {cw.n_shed} failed "
                    f"{cw.n_failed} ttfc_p95_s={cw.ttfc_p95_s:.4f} "
                    f"attained {cw.attained}"
                    for c, cw in sorted(w.per_class.items()))
                print(f"online slo (13b, {name}) window {w.window}: "
                      f"n={w.n_containers} requests={w.n_requests} wall_s="
                      f"{w.wall_s:.4f} proxy_j={w.energy_j:.4f} "
                      f"{measured(meter, t_open, t_close, w.wall_s)} "
                      f"ttfc_p95_s={w.ttfc_p95_s:.4f} shed {w.n_shed} "
                      f"per_class [{classes}] [card: {card}]", flush=True)
            print_report(report, f"online slo (13b, {name})", card)
            print(f"online slo (13b, {name}): scheduler summary {summary}"
                  f" [card: {card}]", flush=True)
            if report.n_done + report.n_shed + report.n_failed \
                    != TRACE13_N:
                fail(f"phase 13b ({name}): {report.n_done} + "
                     f"{report.n_shed} + {report.n_failed} != "
                     f"{TRACE13_N}")
            named = {c for w in history for c in w.per_class}
            if name == "slo" and not named <= set(slo.names()):
                fail(f"phase 13b: per_class names {named} outside "
                     f"{slo.names()}")
            if name == "blind" and named:
                fail(f"phase 13b: the SLO-blind Router kept per_class "
                     f"{named}")
            del warm
            torch.cuda.empty_cache()
    finally:
        meter.close()

    # 13c: the launcher in the trace mode, its own process
    import re
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *CLI13],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
            capture_output=True, text=True, timeout=CLI13_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"phase 13c: the launcher ran past {CLI13_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    m = re.search(REPORT13, out.stdout, re.M)
    if out.returncode != 0 or m is None:
        fail(f"phase 13c: launcher exit {out.returncode}, report line "
             f"{'found' if m else 'missing'}\n{out.stdout[-3000:]}\n"
             f"{out.stderr[-3000:]}")
    n_done, total, n_shed, n_failed = (int(m.group(i)) for i in (4, 5, 6, 7))
    if n_done + n_shed + n_failed != total or total == 0:
        fail(f"phase 13c: report line {m.group(0)!r} does not add up")
    lm = re.search(r"^kernel launches: (\{.*\})$", out.stdout, re.M)
    launches_c = json.loads(lm.group(1)) if lm else {}
    for k in ("flash_attention", "paged_decode_attention", "rmsnorm"):
        if launches_c.get(k, 0) <= 0:
            fail(f"phase 13c: the launcher's {k} never launched: "
                 f"{launches_c}")
    for line in out.stdout.splitlines():
        if line.startswith(("trace ", "goodput ", "  [")):
            print(f"launcher (13c): {line}", flush=True)
    print(f"launcher (13c): exit 0 in {wall:.2f} s (process start, model "
          f"init, replay); launches {launches_c} [card: {card}]",
          flush=True)
    if multiprocessing.active_children():
        fail(f"phase 13 left processes running: "
             f"{multiprocessing.active_children()}")
    print(f"slo replay (13): whole phase "
          f"{time.perf_counter() - phase_t0:.2f} s [card: {card}]",
          flush=True)
    return launches_a, launches_b, launches_c


# ---------------------------------------------------------------------------
# phase 14: the gemma family and the 8B dense configs at full width
# ---------------------------------------------------------------------------
# prompts below the 1024-token window, ones that wrap the local rings in
# decode (1000 and 1020 + 32 new tokens) and ones that wrap them in prefill
GEMMA_PLENS = [64, 500, 1000, 1020, 1030, 1300, 1700, 1900]


def seeded_requests(cfg, plens, seed: int, max_new: int = 32,
                    start: int = 0) -> list:
    """One request a prompt length, ids from ``start``, prompts drawn over
    the vocabulary from ``seed``."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(start + i, rng.integers(0, cfg.vocab_size, (n,),
                                            dtype=np.int32), max_new)
            for i, n in enumerate(plens)]


def with_images(cfg, reqs, seed: int) -> list:
    """``reqs`` with an image each for a vision model (``vision_embeds``
    (n_vision_tokens, vision_embed_dim) float32, 0.1 x N(0, 1) from
    ``seed``), with frames each for whisper (``audio_frames``
    (encoder_seq, d_model) float32, 0.1 x N(0, 1) seeded by the request's
    id); unchanged for any other model."""
    if cfg.n_encoder_layers:
        for r in reqs:
            r.extras = {"audio_frames": (0.1 * np.random.default_rng(
                r.rid).standard_normal((cfg.encoder_seq, cfg.d_model))
            ).astype(np.float32)}
        return reqs
    if not cfg.n_vision_tokens:
        return reqs
    rng = np.random.default_rng(seed)
    for r in reqs:
        r.extras = {"vision_embeds": (0.1 * rng.standard_normal(
            (cfg.n_vision_tokens, cfg.vision_embed_dim))).astype(
                np.float32)}
    return reqs


def serve_router(model, params, config, reqs, what: str,
                 card: str) -> tuple[dict, dict]:
    """``Router(ThreadBackend(2))`` over ``model``: a warm-up request a
    container (first cuBLAS handles, the step graphs' captures; not
    counted), then ``reqs``, each of which must complete with its
    ``max_new_tokens`` in-range tokens and a first chunk. Returns the
    streams and the kernel launches of the timed run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.router import Router

    cfg = model.cfg
    backend = ThreadBackend(model, params, 2, config=config)
    with Router(backend) as router:
        for h in [router.submit(r) for r in with_images(cfg, seeded_requests(
                cfg, (20, 40), 99, max_new=4, start=1000), 98)]:
            h.result()
        torch.cuda.synchronize()
        reqs = [dataclasses.replace(r) for r in reqs]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        captures = [e.graph_capture_s for e in backend.engines]
    for r, c, h in zip(reqs, comps, handles):
        if c.rid != r.rid or len(c.tokens) != r.max_new_tokens:
            fail(f"{what}: request {r.rid} gave {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"{what}: request {r.rid} has out-of-range tokens")
        if h.ttfc_s is None:
            fail(f"{what}: request {r.rid} has no first chunk")
    n_attn = model.kinds.count("attn")
    for name in ("flash_attention", "decode_attention"):
        if launches[name] <= 0 or launches[name] % n_attn:
            fail(f"{what}: {launches[name]} {name} launches; need a positive "
                 f"multiple of {n_attn}")
    if model.fam == "zamba" and (launches["ssd_scan"] <= 0
                                 or launches["ssd_scan"] % cfg.n_layers):
        fail(f"{what}: {launches['ssd_scan']} ssd_scan launches; need a "
             f"positive multiple of {cfg.n_layers}")
    if launches["paged_decode_attention"]:
        fail(f"{what}: the paged kernel launched on dense engines")
    check_norm_launches(cfg, launches, what)
    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"{what}: {cfg.name} {cfg.n_layers} layers bf16, Router("
          f"ThreadBackend(2)) dense cache n_slots={config.n_slots} max_len="
          f"{config.max_len} chunk_tokens={config.chunk_tokens}, "
          f"{len(reqs)} requests prompts {[len(r.prompt) for r in reqs]} "
          f"max_new={reqs[0].max_new_tokens}: "
          f"wall_s={wall:.4f} tok_per_s={n_tok / wall:.2f} ttfc_p50_s="
          f"{ttfc_p50:.4f} capture_s={[round(c, 4) for c in captures]} "
          f"launches={ {k: v for k, v in launches.items() if v} } "
          f"[card: {card}]", flush=True)
    del backend
    torch.cuda.empty_cache()
    return {c.rid: list(c.tokens) for c in comps}, launches


def decode_step_ms(model, params, pos: list, weight_bytes: int,
                   reps: int = 20, max_len: int = 2048,
                   paged: bool = False) -> dict:
    """A 4-row bf16 decode step as an engine replays it, over a fresh
    cache (``max_len`` positions) written to ``pos``: one
    ``decode_chunk_step`` captured in a CUDA graph (rows inactive, so
    positions hold) after one eager step, then ``reps`` replays back to
    back between CUDA events: the step's ms. Its bound: the weights
    (``weight_bytes``) and each layer's live keys and values (the ring's
    slots up to ``pos``; for whisper also its memory rows) read once over
    3.35 TB/s. With ``paged`` the full-horizon groups are pages of 16
    positions over a table that gives each row its own pages."""
    from repro_torch.models.cache import PagedLayout, groups, is_paged_group

    B = len(pos)
    layout = PagedLayout(16, B * max_len // 16) if paged else None
    cache = model.init_cache(B, max_len, torch.bfloat16, layout=layout)
    for g in groups(cache):
        if is_paged_group(g):      # one table, shared by every group
            g["table"].copy_(torch.arange(
                B * max_len // 16, dtype=torch.int32).view(B, -1))
            break
    buf = model.chunk_buffers(B, reps + 1)
    buf["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        model.decode_chunk_step(params, cache, buf, max_len=max_len)
        with torch.cuda.graph(graph, stream=side):
            model.decode_chunk_step(params, cache, buf, max_len=max_len)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        buf["col"].zero_()
        graph.replay()
    buf["col"].zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    cfg = model.cfg
    row = 2 * cfg.n_kv_heads * cfg.head_dim * 2          # k and v, bf16
    # live K/V read once; an SSM layer's conv tail and state read and
    # written once; a whisper layer's memory rows read once

    def group_bytes(g, p):
        if "self" in g:
            return ((g["mem_k"].nbytes + g["mem_v"].nbytes) // B
                    + group_bytes(g["self"], p))
        if "k" in g:
            return min(p + 1, g["k"].shape[1]) * row
        if "k_pages" in g:
            return min(p + 1, max_len) * row
        return 2 * sum(t.nbytes for t in g.values()) // B
    kv = sum(group_bytes(g, p) for g in cache for p in pos)
    del cache, graph
    return {"ms": start.elapsed_time(end) / reps,
            "bound_ms": (weight_bytes + kv) / PEAK_BYTES_S * 1e3,
            "bound_by": "bytes", "positions": list(pos),
            **({"cache": "paged"} if paged else {})}


def dense_8b_phase(name: str, card: str) -> dict:
    """14a: full-width ``name`` (bf16, random weights from seed 0): phase
    4's 8 requests through ``Router(ThreadBackend(2))``, then phase 5's
    dense-vs-paged streams (with ``graph_vs_eager`` on both engines).
    Frees the model. Returns the launches of the Router run and of the
    paged engine's compared streams."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig

    t0 = time.perf_counter()
    cfg = get_config(name)
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    weight_bytes = tree_bytes(params)
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    _, launches = serve_router(model, params, config,
                               seeded_requests(cfg, MAIN_PLENS, 1),
                               f"14a {name}", card)
    _, paged = parity_phase(
        model, params, dataclasses.replace(config, cache="paged",
                                           block_size=16, max_seqs=4), card)
    if not paged["paged_decode_attention"]:
        fail(f"14a {name}: the paged engine never launched the paged kernel")
    step = decode_step_ms(model, params, [48, 160, 300, 544], weight_bytes)
    print(f"14a {name}: a 4-row decode step replayed {step} [card: {card}]",
          flush=True)
    del model, params
    torch.cuda.empty_cache()
    print(f"14a {name}: {cfg.n_layers} layers d={cfg.d_model} H={cfg.n_heads}"
          f" Hkv={cfg.n_kv_heads} K={cfg.head_dim} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} G parameters, "
          f"weights {weight_bytes} B; {time.perf_counter() - t0:.1f} s; "
          f"after freeing it memory_allocated="
          f"{torch.cuda.memory_allocated()} B [card: {card}]", flush=True)
    return {"router": launches, "paged": paged}


def gemma_phase(card: str, max_new: int = 32) -> dict:
    """14b: full-width gemma3-27b (62 layers, bf16, random weights from
    seed 0, one copy for every engine), n_slots 4, max_len 2048: the 8
    GEMMA_PLENS requests through ``Router(ThreadBackend(2))`` over dense
    engines, then through one dense engine and one paged engine
    (``prefix_cache=True``, ``max_seqs`` 4: the 52 local rings stay dense
    rows beside the 10 paged global layers). The three give identical
    greedy streams, the paged engine no hit token; ``graph_vs_eager``
    holds on both engines. The engines are built directly: two dense
    caches beside the weights pass ``card_feasible_counts``' 0.65 share.
    Frees the model. Returns the launches of the Router run and of each
    engine."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.containers import card_feasible_counts
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    t0 = time.perf_counter()
    cfg = get_config("gemma3-27b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    feasible = card_feasible_counts(
        cfg, config, card_bytes=torch.cuda.get_device_properties(0)
        .total_memory, max_containers=4)
    print(f"14b gemma3-27b: {cfg.n_layers} layers (windows "
          f"{model.windows.count(cfg.sliding_window)} x "
          f"{cfg.sliding_window}, {model.windows.count(0)} global) d="
          f"{cfg.d_model} H={cfg.n_heads} Hkv={cfg.n_kv_heads} K="
          f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}, "
          f"{cfg.param_count() / 1e9:.2f} G parameters, weights "
          f"{weight_bytes} B in {time.perf_counter() - t0:.1f} s; "
          f"card_feasible_counts={feasible}; memory_allocated="
          f"{torch.cuda.memory_allocated()} B [card: {card}]", flush=True)
    reqs = seeded_requests(cfg, GEMMA_PLENS, 7, max_new)
    streams, router = serve_router(model, params, config, reqs,
                                   "14b gemma3-27b", card)
    rng = np.random.default_rng(8)
    out, launches = {"router": streams}, {"router": router}
    for cache in ("dense", "paged"):
        conf = (dataclasses.replace(config, cache="paged", block_size=16,
                                    max_seqs=4, prefix_cache=True)
                if cache == "paged" else config)
        eng = ServingEngine(model, params, conf)
        cache_bytes = tree_bytes(eng.cache_backend.tree)
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches[cache] = ops.launch_counts()
        out[cache] = {c.rid: list(c.tokens) for c in comps}
        hits = sum(c.prefix_hit_tokens for c in comps)
        if hits or eng.prefix_hit_tokens_total:
            fail(f"14b gemma3-27b {cache}: {hits} prefix hit tokens under a "
                 "window")
        print(f"14b gemma3-27b {cache} engine: {len(comps)} requests in "
              f"{wall:.4f} s, cache {cache_bytes} B, prefix hit tokens "
              f"{hits}, launches "
              f"{ {k: v for k, v in launches[cache].items() if v} } "
              f"[card: {card}]", flush=True)
        engine_graph_check(eng, [
            Request(2000 + j, rng.integers(0, cfg.vocab_size, (n,),
                                           dtype=np.int32), 40)
            for j, n in enumerate((1020, 300))],
            f"gemma3-27b {cache} cache", card)
        del eng
        torch.cuda.empty_cache()
    if not launches["paged"]["paged_decode_attention"]:
        fail("14b gemma3-27b: the paged engine never launched the paged "
             "kernel")
    step = decode_step_ms(model, params, [1030, 1500, 2047, 700],
                          weight_bytes)
    print(f"14b gemma3-27b: a 4-row decode step replayed {step} "
          f"[card: {card}]", flush=True)
    for r in reqs:
        got = [out[k].get(r.rid) for k in ("router", "dense", "paged")]
        if not got[0] == got[1] == got[2]:
            fail(f"14b gemma3-27b: request {r.rid} ({len(r.prompt)} tokens) "
                 f"streams differ: router {got[0][:6]}... dense "
                 f"{(got[1] or [])[:6]}... paged {(got[2] or [])[:6]}...")
    del model, params
    torch.cuda.empty_cache()
    print(f"14b gemma3-27b: {len(reqs)} requests, identical greedy streams "
          f"through the Router, the dense and the paged engine; "
          f"{time.perf_counter() - t0:.1f} s; after freeing it "
          f"memory_allocated={torch.cuda.memory_allocated()} B "
          f"[card: {card}]", flush=True)
    return launches


def family_phase(card: str) -> dict:
    """Phase 14: 14a qwen3-8b and llama3.1-8b, 14b gemma3-27b, 14c the
    ring against the CPU. Returns the launches by part."""
    from repro_torch.configs.base import reduce_config
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    launches = {}
    for name in ("qwen3-8b", "llama3.1-8b"):
        launches[name] = dense_8b_phase(name, card)
    launches["gemma3-27b"] = gemma_phase(card)
    # 14c: 2 super-blocks and a remainder layer, a 16-slot ring that wraps
    # in the 40-token prefill and over the 40 decode steps
    model_phase(reduce_config(get_config("gemma3-27b"), n_layers=5,
                              sliding_window=16), [39, 39], S=40, steps=40)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s [card: {card}]",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 15: the hybrid family, the vision prefix and mixtral at full width
# ---------------------------------------------------------------------------
# internvl2's prompts behind their images (256 positions each)
VLM_PLENS = [16, 40, 100, 200, 256, 300, 450, 512]
# mixtral's: below the 4096-slot window; two whose rings wrap in prefill,
# and one (the last) whose ring wraps in decode
MIXTRAL_PLENS = [64, 200, 333, 512, 800, 1024, 4200, 5000, 4080]
MIXTRAL_LAYERS = 8
VLM_SYSTEM, VLM_TAIL = 256, 64


def distinct_bytes(tree) -> int:
    """Bytes of the distinct tensors of a tree (zamba's shared block, which
    every super-block refers to, once)."""
    seen = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            seen[t.data_ptr()] = t.nbytes
    walk(tree)
    return sum(seen.values())


def phase15_header(what: str, model, params, t0: float, card: str,
                   extra: str = "") -> int:
    """Print the model's shape and weights; returns the weights' distinct
    bytes."""
    cfg = model.cfg
    weights = distinct_bytes(params)
    print(f"{what}: {cfg.n_layers} layers (kinds {model.kinds.count('ssm')} "
          f"ssm, {model.kinds.count('attn')} attention) d={cfg.d_model} "
          f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} K={cfg.head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} "
          f"G parameters, weights {weights} B in {time.perf_counter() - t0:.1f}"
          f" s{extra}; memory_allocated={torch.cuda.memory_allocated()} B "
          f"[card: {card}]", flush=True)
    return weights


def phase15_step(what: str, model, params, weights: int, card: str) -> dict:
    """A 4-row decode step replayed from its graph beside its bytes bound:
    the distinct weights (and, for zamba, also every application's read
    of the shared block), live K/V and SSM rows at 3.35 TB/s."""
    vis = distinct_bytes(params.get("vis_proj", {}))
    step = decode_step_ms(model, params, [48, 160, 300, 544], weights - vis)
    reads = tree_bytes({k: v for k, v in params.items() if k != "vis_proj"})
    step["bound_reads_ms"] = (step["bound_ms"] + (reads - weights + vis)
                              / PEAK_BYTES_S * 1e3)
    print(f"{what}: a 4-row decode step replayed {step} (bound_ms: distinct "
          "weights read once, the image projection left out; "
          "bound_reads_ms: every layer's weights as the step reads them) "
          f"[card: {card}]", flush=True)
    return step


# 15e: prompts of at most 256 tokens (zamba's scan takes any length up to
# its 256-token chunk), two of them on a 64-position split edge
INT8_FAMILY_PLENS = [150, 200, 256, 180, 40, 50, 64, 33]
# the reduced forms at the new head shapes (G, K) = (1, 112) and (6, 128)
INT8_REDUCED = (("zamba2-7b-reduced", [63, 40], dict(head_dim=112)),
                ("internvl2-26b-reduced", [71, 48],
                 dict(n_heads=6, n_kv_heads=1, head_dim=128)),
                ("mixtral-8x22b-reduced", [63, 40],
                 dict(n_heads=6, n_kv_heads=1, head_dim=128)))


def int8_family_check(model, params, what: str, card: str) -> dict:
    """15e: ``model``'s weights (not made again) over int8 caches
    (``kv_cache_dtype="int8"``): one dense and one paged engine (block 16,
    max_seqs 4, max_len 2048, so every full-horizon group pages, mixtral's
    4096-slot window included) serve INT8_FAMILY_PLENS (behind an image
    each for a vision model), max_new 24, with identical greedy streams;
    the dense engine launches the dense int8 kernel, the paged one the
    paged int8 kernel, neither a bf16/f32 decode kernel; then each engine
    holds a replayed chunk against the eager chunk (``graph_vs_eager``).
    Returns each engine's launches of the compared streams."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg = dataclasses.replace(model.cfg, kv_cache_dtype="int8")
    model8 = Model(cfg)
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    reqs = with_images(cfg, seeded_requests(cfg, INT8_FAMILY_PLENS, 31,
                                            max_new=24), 32)
    # as many as the engine has rows, so no row idles through the compared
    # chunk (idle rows all write to the scratch page)
    more = with_images(cfg, seeded_requests(cfg, (40, 64, 33, 50), 33,
                                            max_new=40, start=100), 34)
    out, launches = {}, {}
    for cache in ("dense", "paged"):
        conf = (config if cache == "dense" else dataclasses.replace(
            config, cache="paged", block_size=16, max_seqs=4))
        eng = ServingEngine(model8, params, conf)
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches[cache] = ops.launch_counts()
        out[cache] = {c.rid: list(c.tokens) for c in comps}
        print(f"{what} int8 {cache} engine: {len(comps)} requests (prompts "
              f"{INT8_FAMILY_PLENS}, max_new 24) in {wall:.4f} s, cache "
              f"{tree_bytes(eng.cache_backend.tree)} B, launches "
              f"{ {k: v for k, v in launches[cache].items() if v} } "
              f"[card: {card}]", flush=True)
        engine_graph_check(eng, [dataclasses.replace(r) for r in more],
                           f"{what} int8 {cache} cache", card)
        del eng
        torch.cuda.empty_cache()
    for r in reqs:
        got = [out[k].get(r.rid) for k in ("dense", "paged")]
        if got[0] is None or len(got[0]) != r.max_new_tokens:
            fail(f"{what} int8: request {r.rid} gave {got[0]}")
        if not all(0 <= t < cfg.vocab_size for t in got[0]):
            fail(f"{what} int8: request {r.rid} has out-of-range tokens")
        if got[0] != got[1]:
            fail(f"{what} int8: request {r.rid} ({len(r.prompt)} tokens) "
                 f"streams differ: dense {got[0][:6]}... paged "
                 f"{(got[1] or [])[:6]}...")
    for cache, kernel in (("dense", "decode_attention_int8"),
                          ("paged", "paged_decode_attention_int8")):
        if launches[cache][kernel] <= 0:
            fail(f"{what} int8 {cache}: {kernel} never launched")
        bf16 = {k: launches[cache][k] for k in ("decode_attention",
                                                "paged_decode_attention")}
        if any(bf16.values()):
            fail(f"{what} int8 {cache}: bf16/f32 decode kernels launched "
                 f"{bf16}")
    print(f"{what} int8: G={cfg.n_heads // cfg.n_kv_heads} K={cfg.head_dim}"
          f", {len(reqs)} requests, identical greedy streams through the "
          f"dense and the paged int8 engine [card: {card}]", flush=True)
    return launches


def zamba_phase(card: str) -> dict:
    """15a: full-width zamba2-7b (81 SSM layers, 13 applications of one
    shared attention + MLP block, bf16, random weights from seed 0):
    SSM_PLENS through ``Router(ThreadBackend(2))``, then phase 8b's groups
    through a dense and a paged engine (``parity_phase``: identical
    streams, ``graph_vs_eager`` on both; the paged engine's 13 attention
    groups paged beside 81 dense SSM rows). Frees the model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig

    t0 = time.perf_counter()
    cfg = get_config("zamba2-7b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights = phase15_header("15a zamba2-7b", model, params, t0, card)
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    _, router = serve_router(model, params, config,
                             seeded_requests(cfg, SSM_PLENS, 1),
                             "15a zamba2-7b", card)
    dense, paged = parity_phase(
        model, params, dataclasses.replace(config, cache="paged",
                                           block_size=16, max_seqs=4),
        card, groups=SSM_PARITY_GROUPS)
    for k in ("paged_decode_attention", "ssd_scan", "flash_attention",
              "rmsnorm"):
        if not paged[k]:
            fail(f"15a zamba2-7b: the paged engine never launched {k}")
    step = phase15_step("15a zamba2-7b", model, params, weights, card)
    int8 = int8_family_check(model, params, "15e zamba2-7b", card)
    del model, params
    torch.cuda.empty_cache()
    print(f"15a zamba2-7b: {time.perf_counter() - t0:.1f} s; after freeing "
          f"it memory_allocated={torch.cuda.memory_allocated()} B "
          f"[card: {card}]", flush=True)
    return {"router": router, "dense": dense, "paged": paged, "step": step,
            "int8": int8}


def vlm_sharing(model, params, config, card: str, rng) -> dict:
    """15b's sharing check: 4 requests behind one image and one
    VLM_SYSTEM-token system prompt (tails of VLM_TAIL tokens), in JAX's
    ``_serve_phases`` form (one request, drained, then three) through a
    dense engine, a paged engine with ``prefix_cache`` and one without.
    The three give identical greedy streams; the sharing engine's second
    phase hits (prefix-hit tokens > 0), the others never. Returns each
    engine's launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = model.cfg
    system = rng.integers(0, cfg.vocab_size, (VLM_SYSTEM,), dtype=np.int32)
    image = (0.1 * rng.standard_normal(
        (cfg.n_vision_tokens, cfg.vision_embed_dim))).astype(np.float32)
    reqs = [Request(3000 + i, np.concatenate([system, rng.integers(
        0, cfg.vocab_size, (VLM_TAIL,), dtype=np.int32)]), 32,
        extras={"vision_embeds": image}) for i in range(4)]
    phases = [reqs[:1], reqs[1:]]
    paged = dataclasses.replace(config, cache="paged", block_size=16,
                                max_seqs=4)
    confs = {"dense": config,
             "paged_sharing": dataclasses.replace(paged, prefix_cache=True),
             "paged": paged}
    out, launches = {}, {}
    for name, conf in confs.items():
        eng = ServingEngine(model, params, conf)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        got, hits = {}, {}
        for ph in phases:
            eng.submit_many([dataclasses.replace(r) for r in ph])
            for c in eng.run():
                got[c.rid], hits[c.rid] = list(c.tokens), c.prefix_hit_tokens
        torch.cuda.synchronize()
        launches[name] = ops.launch_counts()
        out[name] = got
        print(f"15b internvl2-26b sharing, {name} engine: {len(got)} "
              f"requests (image + {VLM_SYSTEM}-token system prompt + "
              f"{VLM_TAIL}-token tails, max_new 32, phases of 1 and 3) in "
              f"{time.perf_counter() - t1:.4f} s, prefix hit tokens "
              f"{hits}, prefill_tokens_executed "
              f"{eng.prefill_tokens_executed}, launches "
              f"{ {k: v for k, v in launches[name].items() if v} } "
              f"[card: {card}]", flush=True)
        want_hit = name == "paged_sharing"
        if want_hit != (sum(hits.values()) > 0):
            fail(f"15b internvl2-26b {name}: prefix hit tokens {hits}")
        del eng
        torch.cuda.empty_cache()
    for r in reqs:
        got = [out[k].get(r.rid) for k in confs]
        if not got[0] == got[1] == got[2]:
            fail(f"15b internvl2-26b sharing: request {r.rid} streams "
                 f"differ: dense {got[0][:6]}... sharing "
                 f"{(got[1] or [])[:6]}... paged {(got[2] or [])[:6]}...")
    return launches


def vlm_phase(card: str) -> dict:
    """15b: full-width internvl2-26b (48 layers, G = 6, bf16, random
    weights from seed 0; requests carry 256 random patch embeddings of
    width 3200 from a seed): VLM_PLENS behind their images through
    ``Router(ThreadBackend(2))``, then ``vlm_sharing``. Frees the
    model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.containers import card_feasible_counts
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig

    t0 = time.perf_counter()
    cfg = get_config("internvl2-26b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    feasible = card_feasible_counts(
        cfg, config, card_bytes=torch.cuda.get_device_properties(0)
        .total_memory, max_containers=4)
    weights = phase15_header(
        "15b internvl2-26b", model, params, t0, card,
        f"; card_feasible_counts={feasible}"
        + ("" if 2 in feasible else " (two engines built all the same)"))
    reqs = with_images(cfg, seeded_requests(cfg, VLM_PLENS, 11), 12)
    _, router = serve_router(model, params, config, reqs,
                             "15b internvl2-26b", card)
    sharing = vlm_sharing(model, params, config, card,
                          np.random.default_rng(13))
    if not sharing["paged_sharing"]["paged_decode_attention"]:
        fail("15b internvl2-26b: the sharing engine never launched the "
             "paged kernel")
    step = phase15_step("15b internvl2-26b", model, params, weights, card)
    int8 = int8_family_check(model, params, "15e internvl2-26b", card)
    del model, params
    torch.cuda.empty_cache()
    print(f"15b internvl2-26b: {time.perf_counter() - t0:.1f} s; after "
          f"freeing it memory_allocated={torch.cuda.memory_allocated()} B "
          f"[card: {card}]", flush=True)
    return {"router": router, **sharing, "step": step, "int8": int8}


def mixtral_phase(card: str, max_new: int = 32) -> dict:
    """15c: mixtral-8x22b at full width cut to MIXTRAL_LAYERS of its 56
    layers (8 experts top-2 of d_ff 16384, G = 6, window 4096; bf16,
    random weights from seed 0), max_len 8192: MIXTRAL_PLENS through
    ``Router(ThreadBackend(2))``, then through one dense and one paged
    engine (``prefix_cache``: the window shuts it; every layer's
    4096-slot ring stays dense rows, so no group pages). Identical greedy
    streams through the three. Frees the model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    t0 = time.perf_counter()
    full = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights = phase15_header(
        f"15c mixtral-8x22b cut to {MIXTRAL_LAYERS} of {full.n_layers} "
        "layers", model, params, t0, card,
        f"; the whole model's {full.param_count() / 1e9:.2f} G parameters "
        f"are {full.param_count() * 2} B of bf16, more than the card's "
        f"{torch.cuda.get_device_properties(0).total_memory} B")
    config = EngineConfig(n_slots=4, max_len=8192, chunk_tokens=32,
                          dtype=torch.bfloat16)
    reqs = seeded_requests(cfg, MIXTRAL_PLENS, 21, max_new)
    streams, router = serve_router(model, params, config, reqs,
                                   "15c mixtral-8x22b", card)
    out, launches = {"router": streams}, {"router": router}
    for cache in ("dense", "paged"):
        conf = (dataclasses.replace(config, cache="paged", block_size=16,
                                    max_seqs=4, prefix_cache=True)
                if cache == "paged" else config)
        eng = ServingEngine(model, params, conf)
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        launches[cache] = ops.launch_counts()
        out[cache] = {c.rid: list(c.tokens) for c in comps}
        hits = sum(c.prefix_hit_tokens for c in comps)
        if hits:
            fail(f"15c mixtral {cache}: {hits} prefix hit tokens under a "
                 "window")
        print(f"15c mixtral-8x22b {cache} engine: {len(comps)} requests in "
              f"{time.perf_counter() - t1:.4f} s, cache "
              f"{tree_bytes(eng.cache_backend.tree)} B, launches "
              f"{ {k: v for k, v in launches[cache].items() if v} } "
              f"[card: {card}]", flush=True)
        del eng
        torch.cuda.empty_cache()
    for r in reqs:
        got = [out[k].get(r.rid) for k in ("router", "dense", "paged")]
        if not got[0] == got[1] == got[2]:
            fail(f"15c mixtral-8x22b: request {r.rid} ({len(r.prompt)} "
                 f"tokens) streams differ: router {got[0][:6]}... dense "
                 f"{(got[1] or [])[:6]}... paged {(got[2] or [])[:6]}...")
    step = phase15_step("15c mixtral-8x22b", model, params, weights, card)
    int8 = int8_family_check(model, params, "15e mixtral-8x22b", card)
    del model, params
    torch.cuda.empty_cache()
    print(f"15c mixtral-8x22b: {len(reqs)} requests (prompts "
          f"{MIXTRAL_PLENS}), identical greedy streams through the Router, "
          f"the dense and the paged engine; {time.perf_counter() - t0:.1f} "
          f"s; after freeing it memory_allocated="
          f"{torch.cuda.memory_allocated()} B [card: {card}]", flush=True)
    return {**launches, "step": step, "int8": int8}


def later_family_phase(card: str) -> dict:
    """Phase 15: 15a zamba2-7b, 15b internvl2-26b, 15c mixtral-8x22b cut
    to 8 layers, 15d the three reduced models against the CPU; 15e each of
    the three over int8 caches (its 15a-c weights) and their reduced
    forms over int8 caches against the CPU. Returns the launches by
    part."""
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    out = {"zamba2-7b": zamba_phase(card)}
    out["internvl2-26b"] = vlm_phase(card)
    out["mixtral-8x22b"] = mixtral_phase(card)
    # 15d: reduced zamba (2 SSM layers, each followed by the shared block),
    # internvl2 (8 image positions ahead of the 64-token prompt) and
    # mixtral (a 64-slot ring that decode wraps)
    model_phase(get_config("zamba2-7b-reduced"), [63, 40])
    model_phase(get_config("internvl2-26b-reduced"), [71, 48])
    model_phase(get_config("mixtral-8x22b-reduced"), [63, 40], steps=16)
    # 15e's reduced forms over int8 caches: as registered, then at the new
    # head shapes (1, 112) and (6, 128)
    for name, last, shape in INT8_REDUCED:
        cfg = dataclasses.replace(get_config(name), kv_cache_dtype="int8")
        steps = 16 if cfg.sliding_window else 8
        model_phase(cfg, last, steps=steps)
        model_phase(dataclasses.replace(cfg, **shape), last, steps=steps)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s [card: {card}]",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: whisper, the audio encoder-decoder, at full width
# ---------------------------------------------------------------------------
# decoder prompts of 4-224 tokens (buckets 16-256), within whisper's
# 448-token decoder context (n_text_ctx, arXiv:2212.04356)
WHISPER_PLENS = [4, 12, 30, 48, 100, 150, 200, 224]
WHISPER_MAX_LEN = 448


class PrefillTimer:
    """Wraps ``model.prefill`` and ``model._encode`` on the instance:
    each call's wall time between two device synchronisations, and the
    encoder's part of it. ``close()`` restores the methods."""

    def __init__(self, model):
        self.model, self.rows = model, []
        prefill, encode = model.prefill, model._encode
        enc = []

        def timed_encode(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = encode(*a, **k)
            torch.cuda.synchronize()
            enc.append(time.perf_counter() - t0)
            return out

        def timed_prefill(params, tokens, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prefill(params, tokens, *a, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            self.rows.append({"rows": tokens.shape[0],
                              "width": tokens.shape[1],
                              "wall_s": round(wall, 5),
                              "encoder_share": round(sum(enc) / wall, 4)})
            enc.clear()
            return out
        model.prefill, model._encode = timed_prefill, timed_encode

    def close(self):
        del self.model.prefill, self.model._encode


def whisper_phase(card: str, max_new: int = 32) -> dict:
    """16a: full-width whisper-large-v3 (32 encoder and 32 decoder layers,
    d 1280, 20 heads of 64, vocab 51 866; bf16, random weights from seed
    0), n_slots 4, max_len 448, chunk 32; each request with its own 1500
    x 1280 float32 frames: WHISPER_PLENS through
    ``Router(ThreadBackend(2))`` over dense engines, then through one
    dense and one paged engine (block 16, max_seqs 4, ``prefix_cache``:
    learned positions shut it, 0 hit tokens): identical greedy streams;
    ``graph_vs_eager`` on both engines; each engine's prefill walls and
    the encoder's share; a per-token engine on two requests equal to the
    chunked streams; a 4-row step replayed beside its bytes bound. Frees
    the model. Returns the launches of the Router run and each engine."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.containers import card_feasible_counts
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    t0 = time.perf_counter()
    cfg = get_config("whisper-large-v3")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    config = EngineConfig(n_slots=4, max_len=WHISPER_MAX_LEN,
                          chunk_tokens=32, dtype=torch.bfloat16)
    feasible = card_feasible_counts(
        cfg, config, card_bytes=torch.cuda.get_device_properties(0)
        .total_memory, max_containers=4)
    weights = phase15_header(
        "16a whisper-large-v3", model, params, t0, card,
        f"; {cfg.n_encoder_layers} encoder layers over {cfg.encoder_seq} "
        f"frames; card_feasible_counts={feasible}")
    reqs = with_images(cfg, seeded_requests(cfg, WHISPER_PLENS, 31,
                                            max_new), 0)
    streams, router = serve_router(model, params, config, reqs,
                                   "16a whisper-large-v3", card)
    out, launches, prefills = {"router": streams}, {"router": router}, {}
    for cache in ("dense", "paged"):
        conf = (dataclasses.replace(config, cache="paged", block_size=16,
                                    max_seqs=4, prefix_cache=True)
                if cache == "paged" else config)
        eng = ServingEngine(model, params, conf)
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        timer = PrefillTimer(model)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            comps = eng.run()
            torch.cuda.synchronize()
        finally:
            timer.close()
        wall = time.perf_counter() - t1
        launches[cache] = ops.launch_counts()
        prefills[cache] = timer.rows
        out[cache] = {c.rid: list(c.tokens) for c in comps}
        hits = sum(c.prefix_hit_tokens for c in comps)
        if hits or eng.prefix_hit_tokens_total or eng._share:
            fail(f"16a whisper {cache}: {hits} prefix hit tokens")
        print(f"16a whisper-large-v3 {cache} engine: {len(comps)} requests "
              f"in {wall:.4f} s, cache {tree_bytes(eng.cache_backend.tree)}"
              f" B, prefix hit tokens {hits}, prefills {timer.rows}, "
              f"launches { {k: v for k, v in launches[cache].items() if v} }"
              f" [card: {card}]", flush=True)
        engine_graph_check(eng, with_images(cfg, seeded_requests(
            cfg, (224, 40), 33, 40, start=2000), 0),
            f"whisper-large-v3 {cache} cache", card)
        del eng
        torch.cuda.empty_cache()
    if not launches["paged"]["paged_decode_attention"]:
        fail("16a whisper: the paged engine never launched the paged kernel")
    for name in ("flash_attention", "decode_attention"):
        if not launches["paged"][name]:
            fail(f"16a whisper: the paged engine never launched {name}")
    for r in reqs:
        got = [out[k].get(r.rid) for k in ("router", "dense", "paged")]
        if not got[0] == got[1] == got[2]:
            fail(f"16a whisper-large-v3: request {r.rid} ({len(r.prompt)} "
                 f"tokens) streams differ: router {got[0][:6]}... dense "
                 f"{(got[1] or [])[:6]}... paged {(got[2] or [])[:6]}...")
    # the per-token baseline on two requests
    eng = ServingEngine(model, params, dataclasses.replace(
        config, chunked=False))
    eng.submit_many([dataclasses.replace(r) for r in reqs[:2]])
    per_token = {c.rid: list(c.tokens) for c in eng.run()}
    if per_token != {r.rid: out["dense"][r.rid] for r in reqs[:2]}:
        fail("16a whisper-large-v3: per-token streams differ from chunked")
    del eng
    torch.cuda.empty_cache()
    # the step reads the decoder's weights (the tied table as the head),
    # not the encoder's nor the cross attention's wk/wv (prefill only)
    cross_kv = sum(p["cross_attn"][n].nbytes for p in params["layers"]
                   for n in ("wk", "wv"))
    step_weights = distinct_bytes({k: v for k, v in params.items()
                                   if k not in ("enc_layers", "enc_norm")
                                   }) - cross_kv
    step = {cache: decode_step_ms(model, params, [48, 160, 300, 447],
                                  step_weights, max_len=WHISPER_MAX_LEN,
                                  paged=cache == "paged")
            for cache in ("dense", "paged")}
    print(f"16a whisper-large-v3: a 4-row decode step replayed over each "
          f"cache {step} (bound_ms: the decoder's weights without the cross "
          f"attention's wk/wv, {step_weights} B, the memory rows and live "
          f"self K/V read once at 3.35 TB/s) [card: {card}]", flush=True)
    del model, params
    torch.cuda.empty_cache()
    print(f"16a whisper-large-v3: {len(reqs)} requests (prompts "
          f"{WHISPER_PLENS}), identical greedy streams through the Router, "
          f"the dense and the paged engine, per-token = chunked on 2; "
          f"weights {weights} B; {time.perf_counter() - t0:.1f} s; after "
          f"freeing it memory_allocated={torch.cuda.memory_allocated()} B "
          f"[card: {card}]", flush=True)
    return {**launches, "step": step, "prefills": prefills}


def audio_phase(card: str) -> dict:
    """Phase 16: 16a whisper-large-v3 at full width, 16b reduced whisper
    (2 encoder and 2 decoder layers, 16 frames) against the CPU in
    float32. Returns 16a's launches."""
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    out = whisper_phase(card)
    model_phase(get_config("whisper-large-v3-reduced"), [63, 40])
    print(f"phase 16: {time.perf_counter() - t0:.1f} s [card: {card}]",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: the paper's video-detection testbed on the card
# ---------------------------------------------------------------------------
TESTBED_COUNTS = (1, 2, 4, 8)
TESTBED_BATCH = 8
TESTBED_CPU_FRAMES = 16
# a run takes 0.05-0.15 s on an H100 80GB HBM3 at 700 W: sample the draw
# faster
TESTBED_METER_MS = 20


def testbed_phase(card: str) -> dict:
    """17: ``core.testbed.run_split`` over ``VideoRequestStream``'s 900
    frames (30 s at 30 fps), batch TESTBED_BATCH, at TESTBED_COUNTS
    containers pinned over the host's cores, every container on the one
    card. Per count: n, cores each, wall, per-container seconds, the
    activity model's W and J, the card's J (``PowerMeter``: the mean
    power.draw of the samples in the call's last wall seconds times the
    wall; read, not used), t/t1, E/E1 and max |out - out_1|, which must
    be <= 1e-5. Then the fitted time and energy models and the
    scheduler's pick. n = 1's first TESTBED_CPU_FRAMES outputs must match
    the detector on the CPU within 1e-3, and no child may outlive the
    phase. Returns the rows."""
    import multiprocessing as mp

    from repro_torch.core import testbed as tb
    from repro_torch.core.energy_model import fit_best
    from repro_torch.core.scheduler import DivideAndSaveScheduler
    from repro_torch.data.pipeline import VideoRequestStream

    t_phase = time.perf_counter()
    frames = VideoRequestStream().frames()
    cores = len(tb.available_cores())
    shared = cores < max(TESTBED_COUNTS)
    print(f"17 testbed: {len(frames)} frames {frames.shape[1:]} float32, "
          f"batch {TESTBED_BATCH}, counts {TESTBED_COUNTS} over {cores} "
          f"host cores{' (shared: more containers than cores)' if shared else ''}"
          f", every container on the card [card: {card}]", flush=True)
    rows, base = [], None
    meter = PowerMeter(TESTBED_METER_MS)
    try:
        for n in TESTBED_COUNTS:
            r = tb.run_split(frames, n, batch=TESTBED_BATCH,
                             allow_shared=shared)
            t_ret = time.perf_counter()
            if r.outputs.shape != (len(frames), 18) or not bool(
                    np.isfinite(r.outputs).all()):
                fail(f"17 testbed n={n}: outputs {r.outputs.shape} are not "
                     "finite (900, 18)")
            if base is None:
                base = r
            diff = float(np.abs(r.outputs - base.outputs).max())
            if diff > 1e-5:
                fail(f"17 testbed n={n}: outputs differ from n=1's by "
                     f"{diff:.3e} > 1e-5")
            joules, samples = meter.joules(t_ret - r.wall_s, t_ret, r.wall_s)
            row = {"n": n, "cores_each": r.cores_per_container,
                   "wall_s": r.wall_s, "per_container_s": r.per_container_s,
                   "model_w": r.avg_power_w, "model_j": r.energy_j,
                   "card_j": joules, "card_samples": samples,
                   "t_over_t1": r.wall_s / base.wall_s,
                   "e_over_e1": r.energy_j / base.energy_j,
                   "max_diff_vs_n1": diff}
            rows.append(row)
            card_j = ("not measured (no power.draw sample)" if joules is None
                      else f"{joules:.4f} ({samples} samples)")
            print(f"17 testbed n={n}: cores_each={r.cores_per_container} "
                  f"wall_s={r.wall_s:.4f} per_container_s="
                  f"{[round(t, 4) for t in r.per_container_s]} "
                  f"model_w={r.avg_power_w:.4f} model_j={r.energy_j:.4f} "
                  f"card_j={card_j} t/t1={row['t_over_t1']:.4f} "
                  f"E/E1={row['e_over_e1']:.4f} max|out-out1|={diff:.3e} "
                  f"[card: {card}]", flush=True)
            if mp.active_children():
                fail(f"17 testbed n={n}: children left running: "
                     f"{mp.active_children()}")
    finally:
        meter.close()
    cpu = tb.detector_forward(
        [torch.from_numpy(w) for w in tb.detector_weights(0)],
        torch.from_numpy(frames[:TESTBED_CPU_FRAMES])).numpy()
    err = float(np.abs(base.outputs[:TESTBED_CPU_FRAMES] - cpu).max())
    if not err <= 1e-3 + 1e-3 * float(np.abs(cpu).max()):
        fail(f"17 testbed: the card's first {TESTBED_CPU_FRAMES} outputs "
             f"differ from the CPU detector's by {err:.3e}")
    ns = np.array([r["n"] for r in rows], float)
    tfit = fit_best(ns, np.array([r["t_over_t1"] for r in rows]))
    efit = fit_best(ns, np.array([r["e_over_e1"] for r in rows]))
    sched = DivideAndSaveScheduler(list(TESTBED_COUNTS), objective="energy",
                                   epsilon=0.0)
    for r in rows:
        sched.observe(r["n"], r["wall_s"], r["model_j"])
    pick = sched.pick()
    print(f"17 testbed: fitted time model {tfit.kind} "
          f"{tuple(float(c) for c in tfit.coef)} rmse {tfit.rmse:.4f}; "
          f"fitted energy model {efit.kind} "
          f"{tuple(float(c) for c in efit.coef)} rmse {efit.rmse:.4f}; "
          f"scheduler picks n={pick} (energy objective); n=1's first "
          f"{TESTBED_CPU_FRAMES} outputs vs the CPU detector max|diff|="
          f"{err:.3e}; {time.perf_counter() - t_phase:.1f} s "
          f"[card: {card}]", flush=True)
    return {"rows": rows, "pick": pick}


# ---------------------------------------------------------------------------
# phase 18: training on the card
# ---------------------------------------------------------------------------
TRAIN_ARGS = ["--steps", "20", "--batch", "8", "--seq", "512", "--lr",
              "1e-3"]
TRAIN_FLOPS_F32 = 67e12      # H100 SXM f32 outside the tensor cores
TRAIN_REDUCED = ("deepseek-v2-lite-16b-reduced", "gemma3-27b-reduced",
                 "whisper-large-v3-reduced", "mamba2-2.7b-reduced",
                 "zamba2-7b-reduced")
# 18f: full-width qwen3-0.6b in bfloat16 through train.loop.train, 18b's
# batch, steps and schedule
BF16_TRAIN = dict(steps=20, batch=8, seq=512, lr=1e-3, warmup=10)
# 18g: the attention families in bfloat16, card against CPU: each first
# gradient leaf within BF16_GRAD_TOL of max|CPU leaf|, the 3 steps' losses
# within BF16_LOSS_TOL relative (bfloat16 rounds at other places on the
# two; tests/test_torch_train_bf16.py holds the port's CPU path to JAX's
# at the same bounds)
BF16_REDUCED = ("deepseek-v2-lite-16b-reduced", "gemma3-27b-reduced",
                "whisper-large-v3-reduced", "internvl2-26b-reduced")
BF16_GRAD_TOL = 5e-2
BF16_LOSS_TOL = 1e-3
# 18d: what make_train_step must accept on the card in bfloat16
BF16_FAMILIES = ("qwen3-0.6b-reduced", "gemma3-27b-reduced",
                 "deepseek-v2-lite-16b-reduced", "whisper-large-v3-reduced",
                 "internvl2-26b-reduced")
# 18e: full-width mamba2-2.7b through launch.train, float32
SSM_TRAIN_ARGS = ["--arch", "mamba2-2.7b", "--steps", "10", "--batch", "2",
                  "--seq", "512", "--lr", "1e-3"]
# 18c's schedule: lr 1e-3 from the first step, so every parameter moves
# about lr a step and a wrong or skipped update shows in every leaf
TRAIN_REDUCED_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 3}
# 18c's bound on ||p_card - p_cpu|| / ||p3 - p0||, leaf by leaf (L2 over
# the leaf). Card and CPU round differently, and AdamW scales each
# element's step by its own gradient: an error small against the leaf's
# largest gradient is a large share of a small element's step, so the
# largest |difference| reaches a share of the leaf's largest move that
# no fixed bound holds (gradient noise of 1e-6 of max|g| on the CPU gives
# up to 1.15), and a norm over the leaf is held instead. On the CPU that
# noise gives up to 1.5e-2, lr off by 5 % gives 5.5e-2 or more
# (scripts/train_drift.py); a skipped update gives 1.
TRAIN_DRIFT_TOL = 3e-2


def _train_batch(cfg, seed: int, B: int, S: int) -> dict:
    from repro_torch.data.pipeline import LmTokenStream
    batch = LmTokenStream(cfg.vocab_size, S, B, seed).batch(0)
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        batch["audio_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.vision_embed_dim)).astype(
                np.float32)
    return batch


def _grads(model, params, batch):
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.train.optimizer import unique_leaves
    loss, _, grads = loss_and_grads(model, params, batch)
    return loss, [grads[id(t)] for t in unique_leaves(params)]


def training_phase(card: str) -> dict:
    """18: training through the port's entry points. 18a: full-width
    qwen3-0.6b, random float32 weights from seed 0, one forward and
    backward at batch 1, seq 64 on the card and on this machine's CPU:
    loss within 1e-5 relative, global grad norm within 1e-4; 28 forward
    and 28 backward flash launches, norms' backward launches = forward.
    18b: ``launch.train`` at TRAIN_ARGS (warmup 10): a finite loss whose
    last value is below its first, 28 forward and 28 backward flash
    launches a step and the norms' backward launches equal to their
    forward ones; step ms (median of steps 5-20), tokens/s, the model
    share 6·N·tokens / step / 67 TFLOP/s and the peak
    ``memory_allocated``. 18c: ``train_reduced_check`` of each
    TRAIN_REDUCED model (MLA + MoE with its aux loss, a window, whisper's
    encoder-decoder, and mamba2-2.7b and zamba2-7b through the SSD
    scan's backward kernel).
    18d: ``make_train_step`` on the card accepts float32 mamba2 and zamba
    and refuses them in bfloat16, naming ``ssd_scan_bwd``, and accepts
    BF16_FAMILIES in bfloat16. 18e: ``ssm_training``. 18f:
    ``bf16_training``. 18g: ``train_reduced_check`` of each BF16_REDUCED
    model in bfloat16. Returns 18b's report, with 18e's under "ssm" and
    18f's under "bf16"."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.model import Model
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.train.optimizer import map_tree

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    layers = cfg.n_layers
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.float32)
    batch = _train_batch(cfg, 0, 1, 64)
    ops.reset_launch_counts()
    loss, grads = _grads(model, params, batch)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    gnorm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))
    del grads
    cpu_model = Model(cfg, device="cpu")
    cpu_params = map_tree(lambda t: t.detach().cpu(), params)
    cpu_loss, cpu_grads = _grads(cpu_model, cpu_params, batch)
    cpu_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                    for g in cpu_grads)))
    del cpu_grads, cpu_params, params
    rel_loss = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    rel_norm = abs(gnorm - cpu_norm) / cpu_norm
    print(f"18a qwen3-0.6b f32 full width, B 1 S 64: loss card "
          f"{float(loss):.7f} cpu {float(cpu_loss):.7f} (rel {rel_loss:.3e}); "
          f"grad norm card {gnorm:.7f} cpu {cpu_norm:.7f} (rel "
          f"{rel_norm:.3e}); launches {got} [card: {card}]", flush=True)
    if not rel_loss <= 1e-5 or not rel_norm <= 1e-4:
        fail(f"18a: card vs CPU loss rel {rel_loss:.3e} (> 1e-5?) or grad "
             f"norm rel {rel_norm:.3e} (> 1e-4?)")
    check_train_launches(got, layers, 1, "18a")
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    report = launch.main(TRAIN_ARGS)
    launches = ops.launch_counts()
    losses = report["loss"]
    steps = len(losses)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"18b: losses {losses} are not finite or do not fall")
    check_train_launches(launches, layers, steps, "18b")
    step_s = float(np.median(report["step_s"][4:]))
    tokens = 8 * 512
    share = 6 * report["params"] * tokens / step_s / TRAIN_FLOPS_F32
    print(f"18b launch.train {' '.join(TRAIN_ARGS)} (qwen3-0.6b f32 full "
          f"width, {report['params']:,} params): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step_ms median(steps 5-20)={step_s * 1e3:.2f} "
          f"(first {report['step_s'][0] * 1e3:.1f}); tokens/s="
          f"{tokens / step_s:.1f}; model share 6*N*tokens/step/67 TFLOP/s="
          f"{share:.4f}; peak memory_allocated={report['peak_bytes']:,} B; "
          f"launches {launches} [card: {card}]", flush=True)
    torch.cuda.empty_cache()

    for name in TRAIN_REDUCED:
        train_reduced_check(name, card)

    # 18d: float32 ssm and zamba models train on the card; bfloat16 ones
    # are refused, naming the float32-only scan backward; the attention
    # families train in bfloat16
    for name in ("mamba2-2.7b-reduced", "zamba2-7b-reduced"):
        m = Model(get_config(name))
        make_train_step(m, TrainConfig(), m.init(seed=0, dtype=torch.float32))
        print(f"18d {name} float32: make_train_step accepts it", flush=True)
        try:
            make_train_step(m, TrainConfig(),
                            m.init(seed=0, dtype=torch.bfloat16))
        except NotImplementedError as e:
            if "ssd_scan_bwd" not in str(e):
                fail(f"18d {name}: the bfloat16 refusal does not name "
                     f"ssd_scan_bwd: {e}")
            print(f"18d {name} bfloat16: refused: {e}", flush=True)
        else:
            fail(f"18d {name} bfloat16: make_train_step did not refuse")
    for name in BF16_FAMILIES:
        m = Model(get_config(name))
        make_train_step(m, TrainConfig(),
                        m.init(seed=0, dtype=torch.bfloat16))
        print(f"18d {name} bfloat16: make_train_step accepts it", flush=True)
    del m
    torch.cuda.empty_cache()
    ssm = ssm_training(card)
    torch.cuda.empty_cache()
    bf16 = bf16_training(card, step_s * 1e3)
    t_g = time.perf_counter()
    for name in BF16_REDUCED:
        train_reduced_check(name, card, torch.bfloat16)
    print(f"18g: {time.perf_counter() - t_g:.1f} s [card: {card}]",
          flush=True)
    print(f"18 training: {time.perf_counter() - t_phase:.1f} s "
          f"[card: {card}]", flush=True)
    return {"launches": launches, "step_ms": step_s * 1e3,
            "tokens_s": tokens / step_s, "model_share": share,
            "peak_bytes": report["peak_bytes"], "losses": losses,
            "ssm": ssm, "bf16": bf16}


def bf16_training(card: str, f32_step_ms: float) -> dict:
    """18f: full-width qwen3-0.6b in bfloat16 (``Model.init(seed=0,
    dtype=torch.bfloat16)``, random weights) through ``train.loop.train``
    at BF16_TRAIN (``LmTokenStream`` batches, AdamW with float32 moments,
    warmup 10): a finite loss whose last value is below its first, 28
    forward and 28 backward flash launches a step and as many
    ``rmsnorm_bwd`` as ``rmsnorm`` launches; step ms (median of steps
    5-20, each step's wall ending in a read of its loss) beside 18b's
    float32 step, tokens/s, the model share 6·N·tokens / step / 989
    TFLOP/s and the peak ``memory_allocated``. Returns its report."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import LmTokenStream
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import AdamWConfig

    t0 = time.perf_counter()
    gc.collect()
    before = torch.cuda.memory_allocated()   # what earlier phases left
    a = BF16_TRAIN
    cfg = get_config("qwen3-0.6b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    tcfg = TrainConfig(opt=AdamWConfig(lr=a["lr"], warmup_steps=a["warmup"],
                                       total_steps=a["steps"]))
    stream = LmTokenStream(cfg.vocab_size, seq_len=a["seq"],
                           batch_size=a["batch"])
    walls, mark = [], [0.0]

    def logger(step, metrics):
        now = time.perf_counter()
        walls.append(now - mark[0])
        mark[0] = now
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mark[0] = time.perf_counter()
    params, _, hist = train(model, tcfg, stream.batches(), a["steps"],
                            params=params, log_every=1, logger=logger)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    if params["embed"]["table"].dtype != torch.bfloat16:
        fail("18f: the parameters left bfloat16")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"18f: losses {losses} are not finite or do not fall")
    check_train_launches(launches, cfg.n_layers, a["steps"], "18f")
    step_s = float(np.median(walls[4:]))
    tokens = a["batch"] * a["seq"]
    share = 6 * cfg.param_count() * tokens / step_s / PEAK_FLOPS["bfloat16"]
    print(f"18f train.loop.train qwen3-0.6b bf16 full width "
          f"({cfg.param_count():,} params), {a}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} ({losses}); step_ms median(steps 5-"
          f"{a['steps']})={step_s * 1e3:.2f} (first {walls[0] * 1e3:.1f}; "
          f"18b's float32 step {f32_step_ms:.2f}); tokens/s="
          f"{tokens / step_s:.1f}; model share 6*N*tokens/step/989 TFLOP/s="
          f"{share:.4f}; peak memory_allocated={peak:,} B ({before:,} B "
          f"allocated before the model was built); launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s [card: {card}]",
          flush=True)
    del params, model
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_s * 1e3,
            "tokens_s": tokens / step_s, "model_share": share,
            "peak_bytes": peak, "bytes_before": before, "losses": losses}


def ssm_training(card: str) -> dict:
    """18e: ``launch.train`` at SSM_TRAIN_ARGS, full-width mamba2-2.7b in
    float32 (random weights from seed 0, warmup 10): a finite loss whose
    last value is below its first, 64 ``ssd_scan`` and 64
    ``ssd_scan_bwd`` launches a step (one of each a layer), no attention,
    the norms' backward launches equal to their forward ones; step ms
    (median of steps 3-10), tokens/s, the model share 6·N·tokens / step
    / 67 TFLOP/s and the peak ``memory_allocated``. Returns its report."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    t0 = time.perf_counter()
    layers = get_config("mamba2-2.7b").n_layers
    ops.reset_launch_counts()
    report = launch.main(SSM_TRAIN_ARGS)
    launches = ops.launch_counts()
    losses = report["loss"]
    steps = len(losses)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"18e: losses {losses} are not finite or do not fall")
    check_train_launches(launches, 0, steps, "18e", layers)
    step_s = float(np.median(report["step_s"][2:]))
    B, S = (int(SSM_TRAIN_ARGS[SSM_TRAIN_ARGS.index(f) + 1])
            for f in ("--batch", "--seq"))
    tokens = B * S
    share = 6 * report["params"] * tokens / step_s / TRAIN_FLOPS_F32
    print(f"18e launch.train {' '.join(SSM_TRAIN_ARGS)} (mamba2-2.7b f32 "
          f"full width, {report['params']:,} params): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ({losses}); step_ms "
          f"median(steps 3-{steps})={step_s * 1e3:.2f} (first "
          f"{report['step_s'][0] * 1e3:.1f}); tokens/s="
          f"{tokens / step_s:.1f}; model share 6*N*tokens/step/67 TFLOP/s="
          f"{share:.4f}; peak memory_allocated={report['peak_bytes']:,} B; "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s "
          f"[card: {card}]", flush=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_s * 1e3,
            "tokens_s": tokens / step_s, "model_share": share,
            "peak_bytes": report["peak_bytes"], "losses": losses}


def train_reduced_check(name: str, card: str, dtype=None) -> None:
    """18c (float32, the default ``dtype``) or 18g (bfloat16) for one
    reduced config: the first batch's gradients and then 3 steps of
    ``train`` at TRAIN_REDUCED_OPT on the card and on the CPU from the
    same weights (seed 0, in ``dtype``). float32: every gradient leaf
    within 1e-4 of its max|CPU leaf|, and every parameter leaf's
    difference within TRAIN_DRIFT_TOL of the leaf's own move (L2 norms
    over the leaf). bfloat16: every gradient leaf within BF16_GRAD_TOL of
    its max|CPU leaf| and each step's loss within BF16_LOSS_TOL relative;
    the parameters' drift is printed, not held (bfloat16's rounding of
    each update moves a leaf by a share of its own step). Prints beside
    them the first gradients' sign disagreements and the largest |g|
    among them, and the largest |difference| against the leaf's largest
    move and against max|leaf|."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import (AdamWConfig, map_tree,
                                             unique_leaves)

    dtype = dtype or torch.float32
    f32 = dtype == torch.float32
    what = "18c" if f32 else "18g"
    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_REDUCED_OPT))
    rcfg = get_config(name)
    if rcfg.is_moe and not rcfg.router_aux_loss_coef:
        rcfg = dataclasses.replace(rcfg, router_aux_loss_coef=0.003)
    init = Model(rcfg, device="cpu").init(seed=0, dtype=dtype)
    out = {}
    for dev in ("cuda", "cpu"):
        m = Model(rcfg, device=dev)
        p = map_tree(lambda t: t.to(m.device, copy=True), init)
        ops.reset_launch_counts()
        _, g1 = _grads(m, p, _train_batch(rcfg, 0, 4, 64))
        batches = (_train_batch(rcfg, i, 4, 64) for i in range(3))
        p, _, hist = train(m, tcfg, batches, 3, params=p, log_every=1)
        out[dev] = ([t.detach().cpu().float() for t in unique_leaves(p)],
                    [g.cpu().float() for g in g1],
                    [h["loss"] for h in hist], ops.launch_counts())
    (p_gpu, g_gpu, l_gpu, n_gpu), (p_cpu, g_cpu, l_cpu, _) = \
        out["cuda"], out["cpu"]

    def ratio(a, b):
        return float(a) / max(float(b), 1e-30)
    g_rel = max(ratio((a - b).abs().max(), b.abs().max())
                for a, b in zip(g_gpu, g_cpu))
    flips = [(torch.sign(a) != torch.sign(b), b) for a, b in
             zip(g_gpu, g_cpu)]
    n_flip = sum(int(f.sum()) for f, _ in flips)
    flip_g = max([ratio(b[f].abs().max(), b.abs().max())
                  for f, b in flips if f.any()], default=0.0)
    moves = [b - z.float() for b, z in zip(p_cpu, unique_leaves(init))]
    drift = max(ratio((a - b).norm(), mv.norm())
                for a, b, mv in zip(p_gpu, p_cpu, moves))
    peak = max(ratio((a - b).abs().max(), mv.abs().max())
               for a, b, mv in zip(p_gpu, p_cpu, moves))
    of_leaf = max(ratio((a - b).abs().max(), b.abs().max())
                  for a, b in zip(p_gpu, p_cpu))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    kinds = Model(rcfg, device="cpu").kinds
    n_ssm = kinds.count("ssm")
    # zamba's attention runs at each application of its shared block
    n_attn = (rcfg.n_layers * 2 + rcfg.n_encoder_layers
              if rcfg.arch_type == "audio" else len(kinds) - n_ssm)
    print(f"{what} {name} {str(dtype).split('.')[1]}: 3 steps at "
          f"{TRAIN_REDUCED_OPT} card vs CPU, losses {l_gpu} / {l_cpu} "
          f"(worst rel {loss_rel:.3e}); first gradients: worst |diff| / "
          f"max|CPU leaf| {g_rel:.3e}, {n_flip} elements of another "
          f"sign, the largest of them {flip_g:.3e} of max|g|; "
          f"parameters: worst ||diff|| / ||move|| {drift:.3e}"
          f"{f' (bound {TRAIN_DRIFT_TOL})' if f32 else ' (not held)'}, "
          f"max|diff| / max|move| {peak:.3e}, "
          f"max|diff| / max|CPU leaf| {of_leaf:.3e}; card launches "
          f"{n_gpu} [card: {card}]", flush=True)
    if f32 and (not g_rel <= 1e-4 or not drift <= TRAIN_DRIFT_TOL):
        fail(f"18c {name}: gradients differ by {g_rel:.3e} of max|leaf| "
             f"(> 1e-4?) or parameters by {drift:.3e} of their move "
             f"(> {TRAIN_DRIFT_TOL}?)")
    if not f32 and (not g_rel <= BF16_GRAD_TOL
                    or not loss_rel <= BF16_LOSS_TOL):
        fail(f"18g {name}: gradients differ by {g_rel:.3e} of max|leaf| "
             f"(> {BF16_GRAD_TOL}?) or losses by {loss_rel:.3e} relative "
             f"(> {BF16_LOSS_TOL}?)")
    check_train_launches(n_gpu, n_attn, 4, f"{what} {name}", n_ssm)


def check_train_launches(got: dict, attn_layers: int, steps: int,
                         what: str, ssm_layers: int = 0) -> None:
    """Every attention ran forward and backward as a kernel
    (``attn_layers`` flash launches each a step), every SSD scan too
    (``ssm_layers`` ssd_scan and ssd_scan_bwd launches each a step) and
    every norm's backward as one (as many rmsnorm_bwd launches as rmsnorm
    ones)."""
    want = attn_layers * steps
    if got["flash_attention"] != want or got["flash_attention_bwd"] != want:
        fail(f"{what}: flash launches {got['flash_attention']} forward, "
             f"{got['flash_attention_bwd']} backward; expected {want} each")
    want = ssm_layers * steps
    if got["ssd_scan"] != want or got["ssd_scan_bwd"] != want:
        fail(f"{what}: SSD scan launches {got['ssd_scan']} forward, "
             f"{got['ssd_scan_bwd']} backward; expected {want} each")
    if got["rmsnorm_bwd"] != got["rmsnorm"]:
        fail(f"{what}: {got['rmsnorm_bwd']} rmsnorm_bwd launches against "
             f"{got['rmsnorm']} rmsnorm")


COST_NS = (1, 2, 4, 8, 16, 32)     # phase 19a's chunk lengths
COST_WARM = 2                      # rounds not timed
COST_REPS = 7                      # timed rounds: a median of 7 a length
COST_PLENS = (48, 160, 300, 544)
COST_SLO_S = 0.5
SYNC_STEPS = 5                     # phase 19d's steady-state steps


def cost_engine(model, params, **kw):
    """A 4-row qwen3 engine (phase 4's EngineConfig unless ``kw`` says
    otherwise) with four requests admitted and its step graph captured:
    budgets long enough that no row finishes in what follows."""
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    conf = dict(n_slots=4, max_len=2048, dtype=torch.bfloat16)
    engine = ServingEngine(model, params, EngineConfig(**{**conf, **kw}),
                           device=model.device)
    rng = np.random.default_rng(19)
    budget = 64 + (COST_WARM + COST_REPS) * sum(COST_NS)
    engine.submit_many([Request(3000 + i, rng.integers(
        0, model.cfg.vocab_size, (n,), dtype=np.int32), budget)
        for i, n in enumerate(COST_PLENS)])
    engine.step()
    torch.cuda.synchronize()
    if engine.queue or (engine.graph_capture_s is None
                        and engine.device.type == "cuda"):
        fail("cost engine: requests left queued or no step graph")
    return engine


def chunk_cost_fit(model, params, card: str) -> dict:
    """19a: the wall of one steady-state ``ServingEngine.step`` (a chunk
    of n steps: the slot state's copy in, the replays, the read-back that
    drains the stream, the host bookkeeping) at each n of COST_NS, in
    rounds over the lengths, the median of COST_REPS rounds after
    COST_WARM; fit wall = a + b n. Fails if ``roofline.DISPATCH_OVERHEAD_S``
    is not within 2x of this run's a."""
    from repro_torch.core import roofline
    engine = cost_engine(model, params, chunk_tokens=max(COST_NS))
    walls = {n: [] for n in COST_NS}
    for rnd in range(COST_WARM + COST_REPS):
        for n in COST_NS:
            engine.chunk_tokens = n        # the engine's resolved chunk
            replays, chunks = engine.graph_replays, engine.chunks
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.step()
            wall = time.perf_counter() - t0
            if (engine.graph_replays - replays, engine.chunks - chunks) \
                    != (n, 1):
                fail(f"19a: a {n}-step chunk made "
                     f"{engine.graph_replays - replays} replays in "
                     f"{engine.chunks - chunks} chunks")
            if rnd >= COST_WARM:
                walls[n].append(wall)
    ns = np.array(COST_NS, float)
    med = np.array([float(np.median(walls[n])) for n in COST_NS])
    b, a = np.polyfit(ns, med, 1)
    resid = float(np.sqrt(np.mean((med - (a + b * ns)) ** 2)))
    del engine
    torch.cuda.empty_cache()
    ratio = roofline.DISPATCH_OVERHEAD_S / a if a > 0 else float("inf")
    print(f"phase 19a, a chunk's wall through ServingEngine.step (qwen3-0.6b "
          f"bf16, 4 rows live from {list(COST_PLENS)}, max_len 2048), median "
          f"of {COST_REPS} after {COST_WARM} rounds, ms by steps: "
          f"{ {n: round(m * 1e3, 4) for n, m in zip(COST_NS, med)} }; fit "
          f"wall = a + b*n: a_ms={a * 1e3:.4f} b_ms={b * 1e3:.4f} "
          f"residual_ms={resid * 1e3:.4f}; roofline.DISPATCH_OVERHEAD_S_ms="
          f"{roofline.DISPATCH_OVERHEAD_S * 1e3:.4f} ({ratio:.3f}x a) "
          f"[card: {card}]", flush=True)
    if not 0.5 <= ratio <= 2.0:
        fail(f"19a: DISPATCH_OVERHEAD_S {roofline.DISPATCH_OVERHEAD_S} s is "
             f"not within 2x of this run's per-chunk cost a = {a} s")
    return {"a_s": float(a), "b_s": float(b), "residual_s": resid,
            "median_s": dict(zip(COST_NS, med.tolist()))}


def cost_model_table(a_s: float, card: str) -> None:
    """19b: the cost model's chunk for every registry config at 4 rows,
    dense and paged over 2048 positions (the constant's, and this run's
    a's), and ``chunk_for`` at n = 1, 2, 4 for 8 requests in flight, dense
    and over 2048 positions, without and with a 0.5 s ttfc SLO."""
    from repro_torch.configs.registry import ARCH_NAMES, get_config
    from repro_torch.core import roofline
    from repro_torch.core.scheduler import DivideAndSaveScheduler
    plain = DivideAndSaveScheduler([1, 2, 4])
    slo = DivideAndSaveScheduler([1, 2, 4], objective="energy_under_slo",
                                 slo_ttfc_p95_s=COST_SLO_S)
    table = {}
    for name in ARCH_NAMES:
        cfg = get_config(name)
        row = {
            "t_tok_ms": [round(roofline.decode_step_seconds(
                cfg, 4, context_tokens=c) * 1e3, 4) for c in (0, 2048)],
            "dense": roofline.decode_chunk_tokens(cfg, 4),
            "paged": roofline.decode_chunk_tokens(cfg, 4,
                                                  context_tokens=2048),
            "dense_at_a": roofline.decode_chunk_tokens(cfg, 4,
                                                       overhead_s=a_s),
            "paged_at_a": roofline.decode_chunk_tokens(
                cfg, 4, overhead_s=a_s, context_tokens=2048),
            "chunk_for": [plain.chunk_for(cfg, n, batch=8, context_tokens=c)
                          for c in (0, 2048) for n in (1, 2, 4)],
            "chunk_for_slo": [slo.chunk_for(cfg, n, batch=8,
                                            context_tokens=c)
                              for c in (0, 2048) for n in (1, 2, 4)]}
        table[name] = row
        print(f"phase 19b, {name}: {row} [card: {card}]", flush=True)
    if not all(1 <= r[k] <= 32 for r in table.values()
               for k in ("dense", "paged")):
        fail(f"19b: a chunk outside [1, 32]: {table}")


def default_chunk_router(model, params, card: str) -> dict:
    """19c: phase 4's 8 requests through Router(ThreadBackend(2)) with the
    default EngineConfig (the cost model's chunk), then with chunk 32:
    identical greedy completions; wall, ttfc p50, tok/s, host reads and
    chunks of each (a reading, not a claim)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router
    cfg = model.cfg
    out, launches = {}, None
    for label, kw in (("default", {}), ("chunk32", {"chunk_tokens": 32})):
        rng = np.random.default_rng(1)
        config = EngineConfig(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                              **kw)
        backend = ThreadBackend(model, params, 2, config=config,
                                device=model.device)
        with Router(backend, device=model.device) as router:
            warm_up(router, cfg, rng)
            reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                            dtype=np.int32), 32)
                    for i, n in enumerate(MAIN_PLENS)]
            before = [(e.host_reads, e.chunks) for e in backend.engines]
            ops.reset_launch_counts()
            tokens, (wall, tps, ttfc), _ = serve_timed(router, reqs)
            if label == "default":
                launches = ops.launch_counts()
            reads = sum(e.host_reads - r for e, (r, _) in
                        zip(backend.engines, before))
            chunks = sum(e.chunks - c for e, (_, c) in
                         zip(backend.engines, before))
            chunk = backend.engines[0].chunk_tokens
        out[label] = tokens
        print(f"phase 19c, Router(ThreadBackend(2)) over qwen3-0.6b bf16, "
              f"phase 4's 8 requests, {label} EngineConfig (chunk_tokens="
              f"{config.chunk_tokens} -> {chunk}): wall_s={wall:.4f} "
              f"ttfc_p50_s={ttfc:.4f} tok_per_s={tps:.2f} host_reads={reads} "
              f"chunks={chunks} [card: {card}]", flush=True)
        del backend
        torch.cuda.empty_cache()
    if out["default"] != out["chunk32"]:
        fail("19c: the default chunk's completions differ from chunk 32's")
    for name in ("flash_attention", "decode_attention", "rmsnorm"):
        if launches[name] <= 0:
            fail(f"19c: kernel {name} was never launched")
    print("phase 19c: greedy completions identical at the default chunk and "
          f"at 32 [card: {card}]", flush=True)
    return launches


def sync_count(fn) -> tuple[int, dict]:
    """The synchronizing CUDA calls ``fn()`` makes, by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings, and where each
    was made (the Python file:line that called into torch)."""
    import collections
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # only the per-call warning: the first switch into the mode also warns
    # once that the mode is a prototype
    syncs = [w for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    where = collections.Counter(
        f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in syncs)
    return len(syncs), dict(where)


def host_sync_phase(model, params, card: str) -> None:
    """19d: steady-state steps of a dense greedy, a dense sampling and a
    paged engine (default chunk) under the sync debug mode: each step's
    synchronizing calls must equal the static host-sync allowance, one
    device-to-host read a chunk (the slot state goes in from a pinned
    buffer, queued on the stream); a copy in from pageable memory is
    counted beside them."""
    from repro_torch.analysis import host_sync
    allow = host_sync.CHUNK_ALLOWANCES["_run_chunk"]["d2h"]
    for label, kw in (("dense greedy", {}),
                      ("dense sampling", {"greedy": False, "seed": 7}),
                      ("paged greedy", {"cache": "paged", "max_seqs": 4})):
        engine = cost_engine(model, params, **kw)
        engine.step()                       # one steady chunk, untimed
        chunks = engine.chunks
        n, where = sync_count(
            lambda: [engine.step() for _ in range(SYNC_STEPS)])
        steps = engine.chunks - chunks
        print(f"phase 19d, {label} engine (chunk {engine.chunk_tokens}): "
              f"{n} synchronizing calls in {SYNC_STEPS} steady-state steps "
              f"({steps} chunks), at {where}; allowance {allow} a chunk "
              f"[card: {card}]", flush=True)
        if steps != SYNC_STEPS or n != allow * steps:
            fail(f"19d ({label}): {n} synchronizing calls in {steps} chunks; "
                 f"the contract allows {allow} a chunk")
        del engine
        torch.cuda.empty_cache()
    dst = torch.zeros(64, dtype=torch.int32, device="cuda")
    src = torch.zeros(64, dtype=torch.int32)
    pinned = src.pin_memory()
    pageable, _ = sync_count(lambda: dst.copy_(src))
    queued, _ = sync_count(lambda: dst.copy_(pinned, non_blocking=True))
    print(f"phase 19d, one host-to-device copy_: from pageable memory "
          f"{pageable} synchronizing call(s), from pinned memory with "
          f"non_blocking {queued} [card: {card}]", flush=True)


def serving_example_phase(card: str) -> dict:
    """19e: examples/torch_serve_requests.py at full width (qwen3-0.6b,
    bf16, random weights from seed 0): its completions identical at 1, 2
    and 4 containers, its walls and EnergyProxy joules."""
    import importlib.util
    path = ROOT / "examples" / "torch_serve_requests.py"
    spec = importlib.util.spec_from_file_location("torch_serve_requests",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    res = example.main(["--device", "cuda"])
    if [r["n"] for r in res["rows"]] != [1, 2, 4] or not all(
            r["identical"] for r in res["rows"]):
        fail(f"19e: the serving example's rows {res['rows']}")
    print(f"phase 19e, examples/torch_serve_requests.py full width: "
          f"{json.dumps(res['rows'])} [card: {card}]", flush=True)
    torch.cuda.empty_cache()
    return res


def cost_model_phase(model, params, card: str) -> dict:
    """Phase 19 on phase 4's model and weights: 19a-19e."""
    t0 = time.perf_counter()
    fit = chunk_cost_fit(model, params, card)
    cost_model_table(fit["a_s"], card)
    launches = default_chunk_router(model, params, card)
    host_sync_phase(model, params, card)
    serving_example_phase(card)
    print(f"phase 19 done in {time.perf_counter() - t0:.1f} s "
          f"[card: {card}]", flush=True)
    return {"fit": fit, "launches": launches}


def full_width_model(dtype):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    model = Model(get_config("qwen3-0.6b"))
    return model, model.init(seed=0, dtype=dtype)


def main() -> int:
    global np, torch
    import numpy
    import torch as _torch
    np, torch = numpy, _torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import ops
    from repro_torch.kernels.build import extension
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig

    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}", flush=True)
    t0 = time.perf_counter()
    extension()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = kernel_phase()
    from repro_torch.configs.registry import get_config
    model_phase(dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2),
                [63, 40])
    model_phase(get_config("mamba2-2.7b-reduced"), [63, 63])
    model_phase(get_config("deepseek-v2-lite-16b-reduced"), [63, 40])
    launches = main_path_phase(card)

    model, params = full_width_model(torch.bfloat16)
    base = dict(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                chunk_tokens=32, cache="paged", block_size=16)
    parity_phase(model, params, EngineConfig(max_seqs=4, **base), card)
    torch.cuda.empty_cache()
    paged_launches, bf16_tokens, bf16_pool = prefix_phase(
        model, params, EngineConfig(max_seqs=8, prefix_cache=True, **base),
        card)
    torch.cuda.empty_cache()
    sharing_launches = sharing_gate_phase(
        model, params, EngineConfig(max_seqs=8, **base), card)
    # 6c again in float32 at full width (its own weights from the same
    # seed), phase 6's whole two waves: the float32 projections run in
    # fixed ROW_SLICE-row slices on the card, so sharing on == off bit for
    # bit
    torch.cuda.empty_cache()
    model32, params32 = full_width_model(torch.float32)
    sharing_launches_f32 = sharing_gate_phase(
        model32, params32,
        EngineConfig(max_seqs=8, **{**base, "dtype": torch.float32}), card)
    del model32, params32

    # the same weights over int8 caches
    torch.cuda.empty_cache()
    model8 = Model(dataclasses.replace(model.cfg, kv_cache_dtype="int8"))
    dense8, paged8 = parity_phase(model8, params,
                                  EngineConfig(max_seqs=4, **base), card)
    parity8 = {k: n + paged8[k] for k, n in dense8.items()}
    for k in ("decode_attention", "paged_decode_attention"):
        if parity8[k] or not parity8[f"{k}_int8"]:
            fail(f"int8 dense vs paged: launches {parity8}")
    torch.cuda.empty_cache()
    int8_launches = int8_path_phase(
        model8, params, EngineConfig(max_seqs=8, prefix_cache=True, **base),
        card, bf16_tokens, bf16_pool)

    # process containers on the same weights
    torch.cuda.empty_cache()
    process_launches = process_phase(model, params, card)
    if multiprocessing.active_children():
        fail(f"phase 10 left processes running: "
             f"{multiprocessing.active_children()}")

    # the request contract of the fixed-count path on the same weights
    torch.cuda.empty_cache()
    contract_launches = request_contract_phase(model, params, card)

    # the online container-count loop on the same weights
    torch.cuda.empty_cache()
    online_launches = online_loop_phase(model, params, card)

    # trace replay under SLO classes on the same weights, and the launcher
    torch.cuda.empty_cache()
    slo_launches = slo_trace_phase(model, params, card)

    # the H100 cost model on the same weights: the per-chunk cost, the
    # chunk per config, the default chunk, the host-sync contract at run
    # time and the serving example
    torch.cuda.empty_cache()
    cost = cost_model_phase(model, params, card)

    # the SSM family, once the qwen3 weights and caches are released, on
    # the dense and on the paged cache
    del model, model8, params
    torch.cuda.empty_cache()
    ssm_model, ssm_params = full_width_ssm()
    ssm_launches = ssm_path_phase(ssm_model, ssm_params, card)
    torch.cuda.empty_cache()
    ssm_paged_launches = ssm_paged_phase(ssm_model, ssm_params, card)
    del ssm_model, ssm_params

    # the MoE family with latent attention, once mamba2's weights are
    # released
    torch.cuda.empty_cache()
    mla_launches, mla_parity = deepseek_path_phase(card)

    # the gemma family and the 8B dense configs, once deepseek's weights
    # are released
    torch.cuda.empty_cache()
    family = family_phase(card)

    # the hybrid family, the vision prefix and mixtral
    torch.cuda.empty_cache()
    later = later_family_phase(card)

    # whisper, the audio encoder-decoder
    torch.cuda.empty_cache()
    audio = audio_phase(card)

    # the paper's video-detection testbed: n pinned containers on the card
    torch.cuda.empty_cache()
    testbed_phase(card)

    # training: full-width qwen3-0.6b through launch.train, float32
    torch.cuda.empty_cache()
    training = training_phase(card)

    # each kernel's launches come from the path it serves: phase 4 (dense
    # cache) for the prefill and dense decode kernels, phase 6 (paged
    # cache with prefix sharing) for the paged decode kernel, phase 7a
    # (dense and paged int8 engines) for the dense int8 kernel, 7b
    # (the int8 Router path) for the paged int8 kernel, 8 (mamba2) for
    # the SSD scan and 9 (deepseek) for the MLA decode kernel; rmsnorm
    # runs on every path, counted from phase 4; phase 10 sums the process
    # containers' own counts; phase 8b sums mamba2's dense and paged
    # engines, phase 12 is the adaptive Router's run (12a); phase 13a the
    # fixed SLO Router's replay, 13b both adaptive replays, 13c the
    # launcher's own process (paged engines); phase 14a each 8B model's
    # Router run and its paged engine's compared streams, 14b gemma's
    # Router run and its dense and paged engines; phase 15a zamba's Router
    # run and its dense and paged engines, 15b internvl2's Router run and
    # its sharing engine, 15c mixtral's Router run and its paged engine;
    # phase 15e each of the three models' dense and paged int8 engines;
    # phase 16a whisper's Router run and its dense and paged engines
    by_phase = {"phase4": launches, "phase6": paged_launches,
                "phase6c": sharing_launches,
                "phase6c_f32": sharing_launches_f32,
                "phase7a": parity8, "phase7b": int8_launches,
                "phase8": ssm_launches, "phase9": mla_launches,
                "phase9b_dense": mla_parity[0],
                "phase9b_paged": mla_parity[1],
                "phase8b": ssm_paged_launches,
                "phase10": process_launches,
                "phase11": contract_launches,
                "phase12": online_launches,
                "phase13a": slo_launches[0], "phase13b": slo_launches[1],
                "phase13c": slo_launches[2],
                "phase14a_qwen3-8b": family["qwen3-8b"]["router"],
                "phase14a_qwen3-8b_paged": family["qwen3-8b"]["paged"],
                "phase14a_llama3.1-8b": family["llama3.1-8b"]["router"],
                "phase14a_llama3.1-8b_paged": family["llama3.1-8b"]["paged"],
                "phase14b": family["gemma3-27b"]["router"],
                "phase14b_dense": family["gemma3-27b"]["dense"],
                "phase14b_paged": family["gemma3-27b"]["paged"],
                "phase15a_zamba2-7b": later["zamba2-7b"]["router"],
                "phase15a_zamba2-7b_dense": later["zamba2-7b"]["dense"],
                "phase15a_zamba2-7b_paged": later["zamba2-7b"]["paged"],
                "phase15b_internvl2-26b": later["internvl2-26b"]["router"],
                "phase15b_internvl2-26b_sharing":
                    later["internvl2-26b"]["paged_sharing"],
                "phase15c_mixtral-8x22b": later["mixtral-8x22b"]["router"],
                "phase15c_mixtral-8x22b_paged":
                    later["mixtral-8x22b"]["paged"],
                **{f"phase15e_{m}_int8_{c}": later[m]["int8"][c]
                   for m in ("zamba2-7b", "internvl2-26b", "mixtral-8x22b")
                   for c in ("dense", "paged")},
                "phase16a_whisper-large-v3": audio["router"],
                "phase16a_whisper-large-v3_dense": audio["dense"],
                "phase16a_whisper-large-v3_paged": audio["paged"],
                "phase18b": training["launches"],
                "phase18e": training["ssm"]["launches"],
                "phase18f": training["bf16"]["launches"],
                "phase19c": cost["launches"]}
    main_phase = {"flash_attention": "phase4", "decode_attention": "phase4",
                  "paged_decode_attention": "phase6",
                  "decode_attention_int8": "phase7a",
                  "paged_decode_attention_int8": "phase7b",
                  "ssd_scan": "phase8", "mla_decode_ctx": "phase9",
                  "rmsnorm": "phase4", "flash_attention_bwd": "phase18b",
                  "rmsnorm_bwd": "phase18b", "ssd_scan_bwd": "phase18e"}
    replaces = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:98"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:167"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:156"),
        "decode_attention_int8": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:124"),
        "paged_decode_attention_int8": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:211"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:100"),
        "mla_decode_ctx": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                           "src/repro/kernels/mla_decode.py:77"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:33"),
        # no Pallas kernel: JAX's custom VJP of its jnp flash path, and
        # autodiff of its plain RMSNorm
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_ref.py:126"),
        "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                        "src/repro/models/layers.py:59"),
        # no Pallas kernel: jax.grad through the jnp oracle of the scan
        "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                         "src/repro/kernels/ref.py:291"),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": replaces[k][0],
         "replaces": replaces[k][1],
         "launches": by_phase[main_phase[k]][k],
         "launches_by_phase": {ph: c.get(k, 0) for ph, c in by_phase.items()},
         **{f: v for f, v in kernels[k].items()}}
        for k in replaces]}
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
