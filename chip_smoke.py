#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --only distributed   # phase 1, then the distributed phase
    python3 chip_smoke.py --only cards         # phase 1, then its ranks on every card
    python3 chip_smoke.py --only train         # phase 1, then the trainer
    python3 chip_smoke.py --only moe           # phase 1, then the MoE family
    python3 chip_smoke.py --only ssm           # phase 1, then the SSM and hybrid families
    python3 chip_smoke.py --only encdec        # phase 1, then the encoder-decoder and VLM
    python3 chip_smoke.py --only tp            # phase 1, then the model (TP) axis
    python3 chip_smoke.py --only grid          # phase 1, then the K x M grid
    python3 chip_smoke.py --only tpfam         # phase 1, then the families split over ranks
    python3 chip_smoke.py --only tpfamcards    # phase 1, then the families on every card
    python3 chip_smoke.py --only tpcards       # phase 1, then the model axis on every card
    python3 chip_smoke.py --only many          # phase 1, then K > 32, CFL-100 and DFL-100

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero (and
prints no result) without them or outside a checkout of the repository.
With ``--only distributed`` it builds the kernels, runs the distributed
phase alone and prints that phase's launches, errors and times as one
JSON line instead of the kernels line and the ok line; with ``--only
cards`` it runs that phase's round, scan and engine parts on one ``nccl``
rank per visible card (2 or more), the deployment sharding is for; with
``--only train`` the training part alone, as one JSON line; with ``--only
moe`` the MoE part alone, with ``--only ssm`` the SSM part alone, with
``--only encdec`` the encoder-decoder and VLM part alone, and with ``--only
tp`` the model-axis part alone, and with ``--only many`` the checks of
kernels 4, 5 and 6 at more than 32 candidates and of kernels 1, 2 and 3 at
more than 32 neighbours, the CFL server over 100 clients and the DFL run
over 100 nodes alone, each as one JSON line.  ``--only cards``
also runs the model-axis part on one ``nccl`` rank per card (and, on four,
StableLM-3B uncut at M = 4).
Phases, each of which fails the run:

  1. the card's name and power limit; build the seven kernel libraries of
     the port from the sources in the checkout, one ``nvcc`` each, all
     started together (timed; ptxas registers and spills printed per
     kernel and template, kernel 8's bf16 tensor-core kernel per head dim
     among them; kernel 5 is a node axis on kernel 4's source, the
     per-edge variants are kernels 1 and 2, kernel 8 is ``flash_attn.cu``)
     and the thread-block cluster size (CTAs per node) of kernels 1 and 2;
     and, for kernels 4 and 5 at their timed shapes, the stages of the
     ``cp.async`` ring, the tile width, the CTAs per SM and per node and
     the network's width (at K > 32 the wide path's tile and sort width);
     kernel 6's output tiles and splits of D at K > 32; and kernel 3's plan (nodes a CTA, tile, stages,
     shared memory and CTAs at its timed and checked shapes);
  2. hold each kernel against its plain PyTorch version on the card (a
     mask of kernel 1 or 2 that differs from the plain version's must be a
     near-tie by phase 3's rule, ``NEAR_TIE``: within 1e-4, relative, of a
     WFAgg-T band edge or the distance filter's or WFAgg-C's keep boundary, reported
     with its filter and margin; on its node the masks and weights are
     ``derive_trust_weights`` of the kernel's own statistics and ``out``
     their combine):
     - the gossip round (``wfagg_round.cu``) at the paper's round shape
       (N=20, K=8, d=44,426) and on irregular slates with a degree-0 row
       at K=16 and K=32 (masks bit-equal, ``out`` within 3e-5);
     - the single-matrix statistics (``robust_stats.cu``) at the CFL
       server's shape (K=20, d=44,426, two bit-identical rows) with and
       without ``prev`` and the centers, and at K=7 and K=32 (median
       bit-equal, trimmed mean within rtol 1e-5, statistics within rtol
       1e-4 / atol 1e-3, WFAgg-D/C masks bit-equal, identical rows with
       identical sums);
     - the Gram (``pairwise_gram.cu``) at K=20, d=44,426 (D % 4 = 2), at
       K=32, D=2^22 and at K=7 and K=32 with D=37, less than a tile (within
       rtol 1e-4, exactly symmetric, norm2 its diagonal, Multi-Krum and
       Clustering masks bit-equal; two bit-identical rows a, b with
       bit-identical Gram rows, G[a,a] == G[a,b] == G[b,b] and squared
       distance exactly 0);
     - the combine (``weighted_agg.cu``, kernel 7) bit for bit (NaN in the
       same places) at the CFL shape (K=20, d=44,426), K=32 d=20,011, K=32
       D=2^22, on views 1-3 floats off a 16-byte boundary at D % 4 = 1 and
       3, K=40 with a NaN row of weight 0, and K=1;
       exactly ``local`` with all-zero weights;
     - the round kernel's Gram variant (Alt-WFAgg) on the paper's ring and
       on irregular slates with a degree-0 row at K=8/16/20/32 (K=20 at
       d=44,426, K=32 at d=20,011), each with two
       bit-identical rows (G[a,a] == G[a,b] == G[b,b]): masks and weights equal to
       ``derive_trust_weights`` of the kernel's own statistics and Gram and
       bit-equal to the plain version, the Gram exactly symmetric and within
       rtol 1e-4, ``out`` within 3e-5;
     - the gather-free statistics (``robust_stats_indexed.cu``) on the same
       slates with and without ``prev`` and the Gram (within rtol 1e-4,
       Gram exactly symmetric, identical rows tied, masks bit-equal) and
       the gather-free combine (``weighted_agg_indexed.cu``, kernel 3: bit for
       bit, NaN in the same places, exactly ``local`` with zero weights and
       on a degree-0 row), also at N=64 K=16 d=2^20, at d % 4 = 1 and 3 on
       misaligned views with a NaN row of weight 0, on the paper's stacked
       chaos matrix with ``local`` a view of the matrix itself, and on a
       stacked chaos matrix from ``apply_transport`` with a ring of 12 past
       matrices, whose rows split the nodes into groups (G < N); the
       combine wrappers at d % 4 = 2 allocate their output and O(N K)
       coefficients only (peak memory); kernels 1 and 5 on unpadded rows
       at d = 50,890 and 44,426 (d % 32 = 10) bit for bit the launch on
       rows padded to 32 floats (kernel 1 plain and Gram, kernel 5 with
       and without the centers), their wrappers allocating their outputs
       only (peak memory);
     then time each kernel, its plain version, its bound and, where one
     PyTorch call computes the same function, that call, with CUDA
     events: the round at N=64, K=16, d=2^20; the CFL kernels at the CFL
     shape and at K=32, D=2^22 (512 MiB per matrix); the Gram round and
     the two-launch kernels at the paper's shape and at N=64, K=16,
     d=2^20 (kernels 1 and 2 in every variant at both shapes, printed in
     one table beside their bounds, plain versions and their times before
     their redesign onto one phase-0 body; kernels 3 and 7 at both shapes
     beside their times before this redesign); the Gram variant's cost by
     difference at N=64, K=32, d=8192;
     and the gossip aggregation on ``fused`` against ``fused_two_launch``
     at N=64, K=16, d=2^20;
     then the ``prev_idx`` variants of the round kernel (plain and Gram)
     and of the gather-free statistics (with and without the Gram) on
     stacked chaos matrices built by the port's own ``apply_transport``:
     the paper's shape under ``churn`` + ``chaos`` (a degree-0 row, a
     corrupt row, ``prev_idx`` != the table on most edges) and irregular
     slates at K=16 and K=32 (masks bit-equal, ``out`` within 3e-5,
     statistics within rtol 1e-4, the Gram within 1e-4 of its
     Cauchy-Schwarz scale; with ``prev_idx`` = the table, bit-identical
     to the launch without it), timed at N=64, K=16, d=2^20 and at the
     paper's shape (L=3, C=4); a candidate row whose squared norm
     overflows float32 (+-inf statistics exactly where the plain version
     has them, no NaN); kernels 1 and 2 bit for bit against
     ``ref.robust_stats_indexed_kernel_order`` (the emulation of their
     summation order that the CPU tests hold against the JAX package) on
     the Gram-round slates at K=8/16/20/32, and kernel 1's statistics
     bit-identical to kernel 2's;
     then kernel 5, the gathered statistics (``robust_stats.cu``'s node
     axis), at the paper's gathered round (N=20, K=8, d=44,426, per-edge
     prev) and at N=64, K=16, d=2^20 with per-edge prev and without prev
     with the centers, each with two bit-identical rows per node and a NaN
     row (median bit-equal with NaN in the same places, the NaN node's
     median all NaN, sums within rtol 1e-4, tied rows tied, WFAgg-D/C
     masks bit-equal), each timed; kernels 4 and 5 bit for bit against
     ``ref.robust_stats_kernel_order`` (the emulation of their order that
     the CPU tests hold against the JAX package; the number of values
     compared printed) at their timed shapes, at D % 4 = 2 (kernel 4 at
     K=20 d=44,426, kernel 5 unpadded at N=20 K=8 d=44,426) and with the
     centers, NaN in the same places; and the per-edge (N, K, d) ``prev``
     variants of kernels 1 and 2 on the same slates as the Gram round
     (with ``prev[idx]`` bit-identical to the matrix-prev launch; with a
     per-edge prev of their own, masks bit-equal to the plain versions),
     timed at N=64, K=16, d=2^20 and at the paper's shape;
     then more than 32 candidates (``check_many_candidates``): kernel 4's
     wide path at K = 33, 64, 100 and 1,024, at d = 50,890 (with and
     without prev and the centers) and 44,426 (D % 4 = 2), two
     bit-identical rows and a NaN row; kernel 5 at N=8, K=48 with per-edge
     prev; kernel 6's output tiles at K = 33, 100, 1,024 (d = 50,890) and
     D = 37; by the bounds above (the Gram also exactly symmetric, twin rows
     at distance 0, Multi-Krum and Clustering masks bit-equal), then kernels
     4, 6 and 7 timed at K = 100 and 1,024 (d = 50,890) and K = 64, D =
     2^22 beside their bounds, plain versions and ``torch.mm`` /
     ``addmv``, and kernel 5 at its shape; kernels 4 and 5 bit for bit
     against ``ref.robust_stats_kernel_order`` at K = 33, 100 and 48 too;
     then more than 32 neighbours (``check_many_neighbours``): kernels 1,
     2 and 3 on ``MANY_NB``'s slates (K = 33, 48, 100; d = 50,890 and
     44,426; regular and irregular with a degree-0 row; two tied rows),
     the WFAgg round with matrix prev and bands, the Alt-WFAgg round,
     kernel 2 with and without prev and the Gram, kernel 3 bit for bit;
     the ``prev_idx`` variants on a chaos stack and the per-edge variants
     at N=100, K=48; N=8 nodes of K=1,024 over 1,100 rows (kernel 3's
     direct route); K=1,025 refused on the card; kernels 1 and 2 bit for
     bit against ``ref.robust_stats_indexed_kernel_order`` on the wide
     route (K = 33 and 100); kernel 1 at N=1, K=64, D=2^22 through
     ``robust_allreduce_stacked(backend="fused")`` against the reference
     backend over three rounds (``check_stacked_many``); kernels 1, 2, 3
     timed at N=100 K=48, N=8 K=1,024 and N=1 K=64 D=2^22
     (``time_many_neighbours``, kernel 3 beside the gather and
     ``torch.baddbmm``);
     then kernel 8, flash attention (``flash_attn.cu``: bf16 on the tensor
     cores, f32 on the CUDA cores), each case twice: through the wrapper
     the prefill calls (``ops.flash_attention`` on (B, H, S, hd) views) and
     at kernel level on inputs padded to the reference's blocks: the six
     cases of ``tests/test_kernels.py:209-216``, a case with Sq > Sk (rows
     with no live key), hd 80 and 128 with ragged padding, the same
     branches in bf16 (hd 32 ragged, Sq > Sk, Sk not a multiple of 64, hd
     128 non-causal), and the prefill's attention at Qwen1.5-0.5B width
     (B=2, 16 heads of 64, S=8192) in bf16 and in f32 (o, m and l within
     2e-5 in f32; in bf16 o within one rounding of its plain version,
     rtol 2^-7 and atol 1e-5, and m and l, which are f32, within 2e-5;
     rows with no live key exactly o = 0, m = -1e30, l = 0; every bf16
     call on the tensor-core kernel; bf16 o a step off the plain version
     counted beside the same count for the plain version's emulation of
     the split of p); a misaligned bf16 pointer and an hd without a
     kernel raise without a launch; timed at the prefill's shape beside
     its bound (bf16 tensor-core rate in bf16, f32 CUDA-core rate in f32),
     the plain version and ``F.scaled_dot_product_attention``;
  3. the main paths, each with every kernel's launch count set to 0 just
     before and read just after:
     - DFL: ``run_experiment`` at the paper's configuration (LeNet-5,
       20-node 8-regular ring, 2 Byzantine nodes placed close, IPM-100,
       6 rounds): WFAgg and Alt-WFAgg on the single-launch backend (one
       round-kernel launch per round), Alt-WFAgg and WFAgg on the
       two-launch backend (one statistics and one combine launch per
       round), the mean baseline beside them, each replayed round by
       round against the reference backend on the card, and the paper's
       IPM-100 claim (WFAgg and Alt-WFAgg each > 0.9 and > mean + 0.2;
       Multi-Krum and Clustering printed beside them) on the MLP, read
       from Table I: all 12 aggregators in DFL and in CFL
       (``run_experiment``, MLP, 4 rounds; kernels launched only under
       WFAgg and Alt-WFAgg, exactly as counted; accuracies and round times
       printed);
     - CFL (``centralized=True``, the same topology and attack): WFAgg
       (one statistics and one combine launch per round, no Gram) and
       Alt-WFAgg (one of each of the three), each replayed round by round
       against the reference backend on the card, and the centralized
       IPM-100 claim (WFAgg and Alt-WFAgg each > mean + 0.2) on the MLP,
       from Table I; then a CFL server over 100 clients (``run_cfl_many``:
       MLP, ``make_topology(100, 4, 10, "ring")``, IPM-100 from the 10
       Byzantine clients, 4 rounds each of WFAgg, Alt-WFAgg, Multi-Krum and
       the mean; one launch of kernel 4 (its wide path, K = 100) and one of
       kernel 7 a round, plus one of kernel 6 under Alt-WFAgg; every robust
       run replayed round by round against the reference backend; the
       steady round's ms and the final accuracies against the paper's CFL
       claim printed, the claim reported, not enforced); then a DFL run
       over 100 nodes at a degree above 32 (``run_dfl_many``: MLP, 10
       Byzantine under IPM-100, 4 rounds on a 48-regular ring and an
       Erdős–Rényi graph of padded degree 53; WFAgg and Alt-WFAgg on
       ``fused``, one kernel-1 launch a round, WFAgg on
       ``fused_two_launch``, one each of kernels 2 and 3 a round, the mean;
       every robust run replayed against the reference backend; the
       accuracies against the paper's claim reported, not enforced);
     - dynamic topologies and chaos transport (``run_dynamic_experiment``,
       the same model, topology and attack, 6 rounds): WFAgg on ``fused``
       under ``churn`` (6 round-kernel launches, none of the ``prev_idx``
       variant); under ``churn`` + ``chaos`` at intensity 0.4 WFAgg and
       Alt-WFAgg on ``fused`` (6 round-kernel launches, all ``prev_idx``),
       WFAgg on ``fused_two_launch`` (6 + 6, the statistics all
       ``prev_idx``) and the mean (none); each WFAgg run replayed round by
       round against the reference backend; one round of each under
       ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
       round); kill-and-resume (stop after 3, checkpoint, resume:
       ``torch.equal`` final carry); the padded baselines (median and
       Multi-Krum under ``churn`` and under ``churn`` + ``chaos``, no
       kernel); every series finite under ``corrupt`` at 0.5 for WFAgg,
       the mean and the median (MLP); benign accuracy under chaos printed;
     - the adaptive adversaries and the audit plane: the reference's
       gate grid (``GATE_GRID``: {none, IPM-100, band_rider, min_max} x
       {static, eclipse} x {mean, Multi-Krum, WFAgg on ``fused``}, MLP,
       the 20-node close-placement ring, 6 rounds; one round-kernel
       launch per WFAgg round, none otherwise), each cell's final_acc and
       final_r2 printed beside ``benchmarks/BENCH_robustness.json`` with
       the gate's one-sided comparator (reported only: the committed
       cells come from the JAX package's data), the gate's two structural
       claims and WFAgg > mean under IPM-100 on the port's own cells
       (each failing the run); ``band_rider|eclipse`` and
       ``min_max|static`` replayed round by round against the reference
       backend (the ``NEAR_TIE`` rule; each round's ride and every
       near-tie's distance from the band_rider target printed); backend
       parity under band_rider, min_max and ipm (N=8: fused, two-launch
       and reference within the reference test's tolerances); band_rider
       on the chaos round under the sync check and kill-and-resume; the
       flight run (``repro_torch.obs.report.main`` with its defaults:
       8 round-kernel launches, the event log valid against ``SCHEMA``
       in strict mode, the audit's last rounds, the ``profile`` event and
       the top device kernels of the median steady round from the
       ``torch.profiler`` capture with the device's busy share); CFL
       under min_max (MLP, 4 rounds: 4 + 4 launches of kernels 4 and 7);
     - the gathered ``wfagg_batch`` (``neighbor_idx`` None) with per-edge
       WFAgg-T state over 6 rounds of the paper's DFL configuration
       (LeNet-5, IPM-100; each node's 8 received models gathered from the
       round's trained and attacked matrix, the output the next round's
       models), WFAgg and Alt-WFAgg on ``fused``: one kernel-5 launch per
       round; every round also on the gathered ``reference`` backend (no
       kernel) and on the indexed ``fused`` (one per-edge round-kernel
       launch) and ``fused_two_launch`` (one per-edge statistics and one
       combine launch) paths fed the same per-edge state, masks equal (or
       reported with filter and margin), outputs within 3e-5, nodes that
       received a non-finite row compared with ``equal_nan`` against the
       gathered reference and reported;
     - serving Qwen1.5-0.5B at full width and depth (24 layers, d_model
       1024, vocab 151,936; the port's own init, seed 0): ``build_prefill``
       on 2 prompts of 8192 tokens (warm once, then timed: ms, prompt
       tokens/s, peak memory; 24 kernel-8 launches a call, all on the bf16
       tensor-core kernel), the same
       prompts with ``flash=False`` (the chunked online softmax; the
       logits of each prompt's last 256 positions compared),
       ``build_decode_step`` at batch 4 against a cache of 32,768
       positions (a 64-token prompt, then 32 greedy tokens: ms a step, no
       kernel launch), and the 96 stepped logits against one prefill of
       the same tokens.  Both logit comparisons hold a relative rms within
       2e-2 and a largest difference within 0.125, and top-1 equal except
       at near-ties (top-2 margin below 0.25), which are reported;
     - distributed (``repro_torch.distributed``): kernels 2 and 3 at the
       per-shard shapes (N=64, K=16, d/S=131,072; N=20, K=8 at the
       paper's shard widths 5,554 and 6,362, d/S = 2 mod 4) against their
       plain versions and timed; 8 ``gloo`` ranks spawned on the one card
       (the kernels built by this process first), each running the
       sharded round of WFAgg and Alt-WFAgg at N=64, K=16, d=2^20 over 4
       rounds with the WFAgg-T state carried (kernel 2 and kernel 3 once a
       round on every rank, kernel 1 never), the sharded scan over 3
       churned rounds, and the DFL engine with ``mesh_model_shards=8``
       (LeNet-5 and the MLP, IPM-100, the 20-node ring: a static run of 6
       rounds and 2 ``churn`` rounds); rank 0 holds every round to the
       one-process emulation (``spmd.wfagg_batch_sharded_emulated``) bit
       for bit and to the unsharded ``fused_two_launch`` round or engine
       replayed from the same state (masks bit-equal or near-ties by
       ``NEAR_TIE``; weights 1e-6, ``out`` and ``prev`` 2e-4, ``hist_s``
       1e-4, engine models 3e-4: ``tests/_spmd_parity_main.py``), every
       rank's results are hashed and must be equal, and a rank that fails
       or passes the deadline (``DIST_TIMEOUT_S``) fails the run (the rest
       are killed); S=1 on ``nccl`` in this process, bit for bit the
       unsharded round; the stacked all-reduce (``robust_allreduce_
       stacked``) over K=8 candidates shaped as Qwen1.5-0.5B's parameter
       dict at full width and depth (the port's seed-0 init plus seeded
       perturbations, 2 under ``ipm_100``; K*P = 3.7e9 > 2^31), 2 rounds
       with WFAgg-T state, WFAgg, Alt-WFAgg, Multi-Krum, median and mean
       on ``reference``, ``fused_two_launch`` and ``fused`` (kernel 1 at
       N=1 with ``mean_fallback`` on ``fused`` WFAgg and Alt-WFAgg; kernel
       4, and kernel 6 for the Gram rules, on the two-launch route; exact
       launch counts; weights within 3e-5, outputs within rtol 1e-4 /
       atol 3e-5, masks bit-equal or near-ties reported with their margin,
       a route at a near-tie holding its output to the combine of its own
       weights; peak memory printed); kernels 1, 4 and 6 at (8, P) against
       their plain versions computed in column chunks (kernel 6 against
       the Gram summed in float64), timed beside their bounds (kernel 1
       beside the two-launch route); kernel 1's ``mean_fallback`` branch
       with every candidate rejected (the uniform mean);
     - training (``repro_torch.train.trainer``): Qwen1.5-0.5B at full
       width, ``TRAIN_LAYERS`` of its 24 layers (the port's seed-0 init)
       with K=8 candidate workers of one batch row each at S=1025 (two
       whole loss chunks of 512), 2 of them under IPM-100, AdamW at lr
       1e-3: ``TRAIN_STEPS`` steps each of WFAgg and Alt-WFAgg on
       ``fused``, every step's all-reduce also run
       on ``fused_two_launch`` and ``reference`` from the step's state
       (its prev, their own history) and held by ``hold_stacked_route``
       (exact launches: kernel 1 once a step, kernel 4 once a step from
       the hold, kernel 6 once a step for Alt-WFAgg; both attackers at
       weight 0 in every step), and the mean beside them (WFAgg's last
       loss below its first and below the mean's); ms per phase
       (candidate gradients, attack, all-reduce, optimizer), tokens/s and
       peak memory per run; one step's peak memory reading the (K, P)
       buffers and with the two (K, P) copies; under ``--only train``
       the flat layout on 4 ``gloo`` ranks on the one card (depth cut to
       2, ALIE on 1, the
       sketch WFAgg-T; every rank's parameters hashed after each step,
       rank 0 holding each all-reduce to the one-process emulation:
       weights within 1e-6, out within 2e-4, masks equal); the launcher
       (``launch.train.main``, 2 steps at full width and
       ``TRAIN_LAYERS`` layers, a checkpoint, 2
       launches of kernel 1).  ``--only train`` runs phase 1 and this part
       alone;
     - the MoE family, on the port's seed-0 init, each model freed before
       the next, every run's peak memory printed: kernel 8 at the MoE
       prefills' shapes (hd 128 at B=2, H=16, S=8192 through
       ``compare_flash``; 64 heads of which 8 all-zero, as
       ``pad_heads_to`` makes them, their o exactly 0; both timed beside
       SDPA); DeepSeek-V2-Lite uncut (MLA + MoE), prefill 1 x 4096 (MLA
       never takes kernel 8: 0 launches), Moonlight cut to 16 layers,
       prefill 2 x 8192 with exactly 16 kernel-8 launches a call on the
       tensor-core kernel, held against ``flash=False``, and Arctic cut to
       2 layers (bf16 parameters, 56 heads padded to 64), prefill 1 x 8192
       with 2 launches a call, held against ``flash=False``; each model's
       decode at batch 2 against a cache of 32,768 positions (96 steps,
       Arctic 8), held against one prefill of the same tokens at a
       capacity that drops no pick, then 8 greedy steps timed.  bf16
       routing is discontinuous and the deep models amplify bf16
       rounding, so each hold has a truth route (``MOE_TRUTH``: f32
       activations where the parameters are f32) whose routing the other
       routes replay (``RouteRecorder``: their own probabilities as
       gates); the f32 decode is held to it by ``check_logits``, and each
       bf16 route under test may add at most that rule's error to the
       bf16 route it stands for (``hold_against_truth``; Arctic's bf16
       routes are held to each other); every route's own routing is held
       by ``routing_diff``: every pick that differs is a near-tie of the
       routes' probabilities.  Then DeepSeek-V2-Lite cut to 2 layers (1
       dense prefix + 1 MoE, P = 1,026,698,240) on the stacked robust-DP
       trainer, K=6 at S=1025, 2 under IPM-100, 2 steps each of WFAgg and
       Alt-WFAgg on ``fused`` (held as above) and the mean, with the
       training part's checks and candidate 0's ce and aux per step.
       ``--only moe`` runs phase 1 and this part alone;
     - the SSM and hybrid families, on the port's seed-0 init, each model
       freed before the next: kernel 8 at Zamba2's prefill shape (B=2,
       H=32, S=8192, hd=64, bf16) through ``compare_flash``, timed beside
       SDPA; Falcon-Mamba-7B at full width cut to 4 of its 64 Mamba-1
       layers (the whole script's time limit), prefill 2 x 8192 (0 kernel
       launches), and Zamba2-1.2B at full width cut to 8 of its 38
       Mamba-2 layers (4 groups, the shared block once a group), prefill
       2 x 8192 with exactly 4 kernel-8 launches a call on the
       tensor-core kernel, held against
       ``flash=False``; each prefill timed with its peak memory and traced
       (the top device kernels); Falcon-Mamba's decode at batch 4 through
       a 24-token prompt (12 tokens in one stateful call, then a token a
       step), Zamba2's at batch 2 against a cache of 32,768 positions over
       16 prompt and 8 greedy steps, each held against one prefill of
       the same tokens, then 8 greedy steps timed.  The two bf16 routes
       of a hold are held to each other by the dense rule, or, where they
       differ past it, each against the f32 route beside its counterpart
       (``SSM_TRUTH``); the f32 decode is held to the f32 prefill by the
       dense rule.  Then Zamba2 cut to 4 layers (2 groups, P =
       309,967,616) on the stacked robust-DP trainer, as the MoE's.
       ``--only ssm`` runs phase 1 and this part alone;
     - the encoder-decoder and VLM families, on the port's seed-0 init,
       each model freed before the next (``ENCDEC_SERVE``):
       SeamlessM4T-medium uncut (12 + 12 layers), prefill 2 x 8192 (frames
       and tokens) with exactly 12 kernel-8 launches a call (the decoder's
       causal self-attention; the encoder's non-causal self-attention and
       the cross-attention take the chunked online softmax), held against
       ``flash=False`` by the dense rule; LLaVA-NeXT-34B at full width cut
       to 6 of 60 layers, prefill 1 x 8192 (576 patch embeddings through
       the projector and 7,616 tokens) with one launch a layer at 64
       padded heads, held as the SSM part's; each prefill timed with its
       peak memory and traced.  Each decode at batch 2 against a cache of
       32,768 positions (Seamless's ``enc_out``: ``_encode``'s output of
       4,096 frames) over 16 prompt and 8 greedy steps, held against one
       prefill of the same frames and tokens (LLaVA: text only) as the SSM
       part's, then 8 greedy steps timed.  Then Seamless cut to 2 + 2
       layers on the stacked robust-DP trainer, frames
       beside the tokens, as the MoE's.  ``--only encdec`` runs phase 1 and
       this part alone.  Last, the model (tensor-parallel) axis: Qwen1.5-0.5B
       uncut split over two ``gloo`` ranks sharing the card (each rank's
       H/M heads, ff/M columns and V/M vocabulary rows; every all-reduce
       gathered and added in rank order, through host memory): prefill 2 x
       8192 with 24 kernel-8 launches a call on each rank, the gathered
       last 256 positions held to the M = 1 prefill and decode at batch 4
       against 32,768 slots over ``TP_PROMPT`` + ``TP_NEW_TOKENS`` tokens
       held to a prefill, by the dense rule; then K = 8 training at
       ``TP_TRAIN_LAYERS`` of the 24 layers, WFAgg on
       ``fused`` and ``fused_two_launch``, Alt-WFAgg and the mean (the
       steps of ``TP_RUNS``) under IPM-100, then ``TP_FLAT_RUNS``: the
       flat layout's WFAgg and mean (no kernel launch; each step held to
       the one-process flat route on the whole candidates gathered on rank
       0, ``FlatObserver``) and one stacked step under min_max with
       gather_dtype bfloat16 and Adafactor (its update held to one
       process's, ``hold_adafactor``), with the
       planned launches of kernels 4, 6 and 7 on every rank every step (0
       of kernel 1), the step-1 candidates held to M = 1's gradients
       (relative rms ``TP_GRAD_RMS``) and every step's aggregation to the
       reference backend's model-axis route on the same candidates (masks
       bit-equal or near-ties, weights and blocks within 3e-5), the
       activation all-reduces and ``psum_stats`` timed apart.  ``--only
       tp`` runs phase 1 and this part alone.  Last, the data axis as
       processes: Qwen1.5-0.5B at ``GRID_LAYERS`` of 24 layers on a K = 4 x
       M = 2 grid of ``gloo`` ranks sharing the card (``launch.mesh.make_grid``), each rank
       holding the FSDP blocks of its model block: a prefill of 4 x 8192,
       one row a data rank, each layer's weights gathered over the data
       group just before it, with 24 kernel-8 launches on each rank, and
       decode at batch 4 against 32,768 slots over ``GRID_DECODE``
       teacher-forced tokens, both gathered and held by the dense rule to
       one process's logits of the same tokens; then K = 4 training with
       ``fsdp_params``, one candidate a data rank (WFAgg 2 steps,
       Alt-WFAgg 1, the mean 2; then the flat layout's WFAgg, 2 steps, its
       first held as the model axis's), IPM-100 on one, with each rank's planned
       launches of kernels 4, 6 and 7 every step (0 of kernel 1), the
       step-1 candidate held to one process's gradient (relative rms
       ``GRID_GRAD_RMS``) and every step's aggregation to the reference
       backend's data-axis route on the same column block (masks bit-equal
       or near-ties, weights and blocks within 3e-5), the param all-gather,
       the exchange, ``psum_stats`` and the activation all-reduces timed
       apart; then kernels 4, 6, 7 and 8 at a rank's shapes held against
       their plain versions and timed.  ``--only grid`` runs phase 1 and
       this part alone; ``--only cards`` on four cards adds StableLM-3B
       uncut at K = 4 x M = 1 and Qwen at K = 2 x M = 2 on ``nccl``.  Last,
       the other families split over ranks (``FAM_JOBS``):
       one process's references first (prompts, prefill tails, decode
       logits, every MoE call's routing, an f32 truth where the parameters
       are f32, candidate 0's step-1 gradient with its routing), then two
       ``gloo`` ranks sharing the card serve DeepSeek-V2-Lite (2 layers,
       MLA and the MoE, 2 x 4096, no kernel 8), Zamba2-1.2B (2 layers, 2 x
       8192, kernel 8 on each rank's 16 heads once a group), Falcon-Mamba-7B
       (2 layers), Arctic (1 layer, bf16, 28 live heads a rank padded to
       32, kernel 8 at hd 128), SeamlessM4T-medium (2 + 2 layers, 2 x 8192
       frames and tokens, kernel 8 in the decoder's causal self-attention
       only, its decode caches holding the rank's encoding of
       ``ENC_LEN_DECODE`` frames) and LLaVA-NeXT-34B (1 layer, 576 patches
       through the split projector, 28 live heads a rank padded to 32) with
       the reference's routing replayed and the gathered logits held by the
       dense rule or ``SSM_TRUTH``'s, routing flips as near-ties, decode
       over ``FAM_DECODE`` teacher-forced tokens likewise; and train
       DeepSeek, Zamba2, Falcon-Mamba and Seamless at K = 4 (IPM-100 on
       one, WFAgg f = 1; Seamless's candidates on their rows of the frames)
       with ``TP_RUNS``' holds (an MoE's step-1 candidate through the
       reference's routing); then Zamba2 and Seamless (2 layers) on the 4
       x 2 grid, one rank group, with the grid part's holds
       (``SSM_TRUTH`` where the dense rule does not hold); then kernels 4,
       6, 7 and 8 at the new shapes held against their plain versions and
       timed.  ``--only tpfam`` runs
       phase 1 and this part alone; ``--only cards`` on four cards adds
       Moonlight uncut served and DeepSeek-V2-Lite (6 layers) and
       Falcon-Mamba-7B (32 layers) trained at M = 4 on ``nccl``, which
       ``--only tpfamcards`` runs alone.  Then bf16 parameters and pad head
       slots (``run_bf16_path``): the reduced Arctic in bf16 with Adafactor
       at M = 1 (kernel 1), on 2 ``gloo`` ranks (kernels 4, 6, 7) and the 2
       x 2 grid, both layouts, and the 7-of-8-head config on 4 ranks, each
       step's gathered candidates through the one-process route, the pad
       slots exactly 0; ``--only bf16`` runs phase 1 and this part alone.
       ``--only tpcards`` on four cards first trains LLaVA-NeXT-34B at 1
       of 60 layers, full width, Adafactor, stacked, M = 4, K = 6
       (``run_llava_cards``: served at 1 x 8192 beside it, its peak a card
       printed against ``LLAVA_CARDS_PREDICTED_GIB``), then Arctic at 1 of
       35 layers, full width, bf16, Adafactor, flat, M = 4
       (``run_arctic_cards``).

Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.
"""
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
if __name__ in ("__main__", "__mp_main__") and (ROOT / "src" / "repro_torch").is_dir():
    # A Python that writes no bytecode compiles every module it imports in
    # every process: torch (~11 s on the H100 machine) and torch._dynamo,
    # which torch.utils.checkpoint imports at its first call (~13 s), in
    # each rank this script spawns.  Cache the bytecode in the checkout's
    # build directory instead, for this process and its ranks ("spawn" runs
    # this file again as __mp_main__).
    sys.pycache_prefix = str(ROOT / "src" / "repro_torch" / "kernels" / "_build" / "pycache")
    sys.dont_write_bytecode = False

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
OUT_TOL = 3e-5                   # tests/test_one_launch.py:20
STAT_RTOL, STAT_ATOL = 1e-4, 1e-3   # statistics: sums in another order
CFL_K, CFL_D = 20, 44426         # the CFL server: N = 20 LeNet-5 models
BIG_K, BIG_D = 32, 1 << 22       # 512 MiB per (K, D) matrix
ROUNDS = 6

# name -> (kernel module, counter attribute, source, the Pallas launch it replaces)
KERNELS = {
    "wfagg_round_indexed": ("repro_torch.kernels.robust_stats.kernel", "launches",
                            "src/repro_torch/kernels/robust_stats/csrc/wfagg_round.cu",
                            "src/repro/kernels/robust_stats/kernel.py:511"),
    "robust_stats": ("repro_torch.kernels.robust_stats.kernel", "robust_stats_launches",
                     "src/repro_torch/kernels/robust_stats/csrc/robust_stats.cu",
                     "src/repro/kernels/robust_stats/kernel.py:136"),
    "pairwise_gram": ("repro_torch.kernels.pairwise_dist.kernel", "launches",
                      "src/repro_torch/kernels/pairwise_dist/csrc/pairwise_gram.cu",
                      "src/repro/kernels/pairwise_dist/kernel.py:29"),
    "weighted_agg": ("repro_torch.kernels.weighted_agg.kernel", "launches",
                     "src/repro_torch/kernels/weighted_agg/csrc/weighted_agg.cu",
                     "src/repro/kernels/weighted_agg/kernel.py:88"),
    "robust_stats_indexed": ("repro_torch.kernels.robust_stats.kernel", "indexed_launches",
                             "src/repro_torch/kernels/robust_stats/csrc/"
                             "robust_stats_indexed.cu",
                             "src/repro/kernels/robust_stats/kernel.py:271"),
    "weighted_agg_indexed": ("repro_torch.kernels.weighted_agg.kernel", "indexed_launches",
                             "src/repro_torch/kernels/weighted_agg/csrc/"
                             "weighted_agg_indexed.cu",
                             "src/repro/kernels/weighted_agg/kernel.py:56"),
    # the prev_idx variants (chaos transport): the same sources and kernels,
    # counted apart as well
    "wfagg_round_indexed[prev_idx]": ("repro_torch.kernels.robust_stats.kernel",
                                      "prev_idx_launches",
                                      "src/repro_torch/kernels/robust_stats/csrc/"
                                      "wfagg_round.cu",
                                      "src/repro/kernels/robust_stats/kernel.py:511"),
    "robust_stats_indexed[prev_idx]": ("repro_torch.kernels.robust_stats.kernel",
                                       "indexed_prev_idx_launches",
                                       "src/repro_torch/kernels/robust_stats/csrc/"
                                       "robust_stats_indexed.cu",
                                       "src/repro/kernels/robust_stats/kernel.py:271"),
    # kernel 5: the gathered statistics, a node axis on kernel 4's source
    "robust_stats_batch": ("repro_torch.kernels.robust_stats.kernel", "batch_launches",
                           "src/repro_torch/kernels/robust_stats/csrc/robust_stats.cu",
                           "src/repro/kernels/robust_stats/kernel.py:652"),
    # the per-edge (N, K, D) prev variants: the prev_idx launches over the
    # per-edge tensor, counted apart
    "wfagg_round_indexed[per_edge_prev]": ("repro_torch.kernels.robust_stats.kernel",
                                           "per_edge_launches",
                                           "src/repro_torch/kernels/robust_stats/csrc/"
                                           "wfagg_round.cu",
                                           "src/repro/kernels/robust_stats/kernel.py:511"),
    "robust_stats_indexed[per_edge_prev]": ("repro_torch.kernels.robust_stats.kernel",
                                            "indexed_per_edge_launches",
                                            "src/repro_torch/kernels/robust_stats/csrc/"
                                            "robust_stats_indexed.cu",
                                            "src/repro/kernels/robust_stats/kernel.py:271"),
    # kernel 8: the LM's prefill attention
    "flash_attention": ("repro_torch.kernels.flash_attn.kernel", "launches",
                        "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn/kernel.py:81"),
}


def _module(name):
    import importlib
    return importlib.import_module(KERNELS[name][0])


def zero_counts() -> None:
    for name, (_, attr, _, _) in KERNELS.items():
        setattr(_module(name), attr, 0)
    # kernel 8's bf16 tensor-core launches, also counted in its ``launches``
    _module("flash_attention").launches_tc = 0


def read_counts() -> dict:
    return {name: getattr(_module(name), attr) for name, (_, attr, _, _) in KERNELS.items()}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def irregular_slate(N, K, seed):
    """Padded (idx, valid) with per-node degrees in [1, K], padded slots
    pointing at the node itself, and node 1's slate empty (degree 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = np.repeat(np.arange(N, dtype=np.int32)[:, None], K, axis=1)
    valid = np.zeros((N, K), bool)
    for n in range(N):
        v = 0 if n == 1 else int(rng.integers(1, K + 1))
        idx[n, :v] = rng.choice([i for i in range(N) if i != n], size=v, replace=False)
        valid[n, :v] = True
    return idx, valid


def round_inputs(torch, N, K, d, idx, valid, seed, dup=None, M=None):
    """Models (M rows, N by default), prev and bands on the card; bands
    built around this round's own temporal metrics so the WFAgg-T test
    accepts some edges and rejects others.  ``dup`` makes two rows
    bit-identical (two attackers sending one model)."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    M = N if M is None else M
    models = torch.randn((M, d), generator=g, device="cuda") + 0.3
    prev = models + 0.2 * torch.randn((M, d), generator=g, device="cuda")
    if dup is not None:
        models[dup[1]] = models[dup[0]] = -100.0 * models.mean(0)
    idx_t = torch.as_tensor(idx, device="cuda")
    valid_t = None if valid is None else torch.as_tensor(valid, device="cuda")
    cfg = WFAggConfig(transient=3)
    tbands = jittered_bands(torch, robust_stats_indexed_ref(models, idx_t, valid_t, prev),
                            g, cfg)
    return models, prev, idx_t, valid_t, tbands, cfg


def jittered_bands(torch, st, g, cfg):
    """WFAgg-T bands from a history of each edge's own temporal metrics in
    ``st``, each entry jittered by 5%: some edges pass, others fail."""
    from repro_torch.core import trust

    N, K = st.prev_dist2.shape
    jitter = lambda x: x[:, None, :] * (1 + 0.05 * torch.randn(  # noqa: E731
        (N, cfg.window, K), generator=g, device="cuda"))
    return trust.temporal_bands(
        jitter(st.prev_dist2), jitter(st.cosine_to_prev()),
        torch.full((N,), 3, device="cuda"), torch.full((N,), 5, device="cuda"), cfg)


def assert_stats_close(torch, got, want, fields) -> float:
    """Statistics ``fields`` of a kernel within rtol 1e-4 / atol 1e-3 of its
    plain version's (a NaN fails); returns the largest difference."""
    for name in fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=STAT_RTOL, atol=STAT_ATOL)
    return max(float((getattr(got, n) - getattr(want, n)).abs().max()) for n in fields)


def hold_masks(torch, label, got, want, st, v, tb, cfg) -> "torch.Tensor":
    """A kernel's masks ``got`` (mask_d, mask_c[, mask_t]) against its plain
    version's ``want``: bit-equal, or each differing edge a near-tie by the
    rule of phase 3 (``near_ties_only``: within NEAR_TIE, relative, of a
    WFAgg-T band edge or of the distance filter's or WFAgg-C's keep
    boundary, measured on the plain version's own statistics ``st``),
    reported with its filter and margin.  A Clustering flip has no margin
    and fails.  Returns the (N,) nodes holding such an edge."""
    flips = [(n, k, bit) for bit, (g, w) in enumerate(zip(got, want))
             for n, k in (g != w).nonzero().tolist()]
    off = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    if not flips:
        return off
    report = flip_margins(torch, st, v, tb, cfg, flips)
    print(f"  {label}: masks differ from the plain version at (node, slot, filter, "
          f"margin) {report}")
    if not near_ties_only(report):
        raise AssertionError(f"{label}: masks differ from the plain version away from "
                             "any edge")
    off[[n for n, _, _ in flips]] = True
    return off


def hold_round(torch, label, got, want, v, tb, cfg, local, models, idx) -> tuple:
    """A round kernel's outputs (out, w, mask_d, mask_c, mask_t, stats)
    against its plain version's: masks as ``hold_masks``; weights within
    atol 1e-6 and ``out`` within 3e-5 of the plain version's; on a node
    with a near-tie, the masks and weights those of ``derive_trust_weights``
    of the kernel's own statistics and ``out`` within 3e-5 of the plain
    combine of its own weights.  Returns (largest ``out`` error, near-ties)."""
    from repro_torch.core import trust
    from repro_torch.kernels.weighted_agg.ops import weighted_agg_indexed_plain

    off = hold_masks(torch, label, got[2:5], want[2:5], want[5], v, tb, cfg)
    keep = ~off
    torch.testing.assert_close(got[1][keep], want[1][keep], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[0][keep], want[0][keep], rtol=OUT_TOL, atol=OUT_TOL)
    err = float((got[0][keep] - want[0][keep]).abs().max()) if keep.any() else 0.0
    if off.any():
        own = trust.derive_trust_weights(got[5], v, tb, cfg)
        for name, g, o in zip(("mask_d", "mask_c", "mask_t"), got[2:5], own):
            if not torch.equal(g[off], o[off]):
                raise AssertionError(f"{label}: {name} at a near-tie is not "
                                     "derive_trust_weights' of the kernel's own stats")
        torch.testing.assert_close(got[1][off], own[3][off], rtol=0, atol=1e-6)
        mine = weighted_agg_indexed_plain(*trust.combine_coefficients(got[1], cfg.alpha),
                                          local, models, idx)
        torch.testing.assert_close(got[0][off], mine[off], rtol=OUT_TOL, atol=OUT_TOL)
        err = max(err, float((got[0][off] - mine[off]).abs().max()))
    return err, int(off.sum())


def tie_note(n_ties: int) -> str:
    return f" but for the near-ties of {n_ties} nodes reported above" if n_ties else ""


def compare_kernel(torch, label, N, K, d, idx, valid, seed, dup=None, M=None) -> float:
    """The round kernel (WFAgg, matrix prev and bands) against its plain
    version on an (M, d) model matrix, the first N rows the local models."""
    from repro_torch.kernels.robust_stats import ops

    models, prev, idx_t, valid_t, tbands, cfg = round_inputs(
        torch, N, K, d, idx, valid, seed, dup, M)
    local = models[:N]
    got = ops.wfagg_round_indexed(local, models, idx_t, valid_t, cfg,
                                  prev=prev, tbands=tbands)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    want = ops.wfagg_round_indexed_plain(local, models, idx_t, v, cfg, prev, tbands)
    torch.cuda.synchronize()
    err, n_ties = hold_round(torch, label, got, want, v, tbands, cfg, local, models, idx_t)
    assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
    if dup is not None:
        # bit-identical rows got bit-identical statistics (on valid slots:
        # a padded slot reads the node's own row)
        a, b = (idx_t == dup[0]) & v, (idx_t == dup[1]) & v
        both = a.any(1) & b.any(1)
        da = torch.where(a, got[5].dist2, 0).sum(1)[both]
        db = torch.where(b, got[5].dist2, 0).sum(1)[both]
        if not torch.equal(da, db):
            raise AssertionError(f"{label}: identical rows got different dist2")
    mask_t_on = int(got[4].sum())
    print(f"  {label}: masks bit-equal{tie_note(n_ties)} (mask_t on "
          f"{mask_t_on} of {int(v.sum())} edges), out max|err| {err:.3g}")
    if mask_t_on == 0:
        raise AssertionError(f"{label}: the temporal band test never fired")
    return err


def time_cuda(torch, fn, warmup, reps) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between its
    own pair of CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_round(torch, N, K, d, seed):
    """Kernel (through its ``*_cuda`` wrapper, as every variant is timed) and
    plain times at one shape, with the kernel's bound."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tbands, cfg = round_inputs(torch, N, K, d, idx, None, seed)
    local = models.clone()
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    ms = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
        local, models, i32, v, prev, tbands, cfg, cfg.alpha, False), 3, 25)
    plain_ms = time_cuda(torch, lambda: ops.wfagg_round_indexed_plain(
        local, models, idx_t, v, cfg, prev, tbands), 1, 5)
    # least work: read models, prev, local once and write out once; about
    # 16 flops per candidate coordinate (six statistics and the combine),
    # not counting the median's comparisons
    byte_ms = 4.0 * (models.numel() + prev.numel() + local.numel() + N * d) \
        / HBM_BYTES_PER_S * 1e3
    op_ms = 16.0 * N * K * d / FP32_OPS_PER_S * 1e3
    return ms, plain_ms, max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


# ---------------------------------------------------------------------------
# phase 2: the single-matrix kernels of the CFL server
# ---------------------------------------------------------------------------

def cfl_candidates(torch, K, D, seed):
    """A CFL server's inputs on the card: K benign models near a common one,
    two attacker rows (0 and ``dup``) holding one bit-identical model, and
    each row's previous-round model (identical for the two attackers)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn((D,), generator=g, device="cuda")
    u = base + 0.1 * torch.randn((K, D), generator=g, device="cuda")
    prev = u + 0.05 * torch.randn((K, D), generator=g, device="cuda")
    dup = max(1, K // 5)
    u[0] = u[dup] = -3.0 * base
    prev[dup] = prev[0]
    return u, prev, dup


def compare_robust_stats(torch, K, D, seed, with_prev, need_center,
                         candidates=cfl_candidates) -> float:
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops

    u, prev, dup = candidates(torch, K, D, seed)
    p = prev if with_prev else None
    got = ops.robust_stats(u, p, need_center=need_center)
    want = ops.robust_stats_plain(u, p, need_center=need_center)
    torch.cuda.synchronize()
    label = f"robust_stats K={K} D={D} prev={with_prev} centers={need_center}"
    errs = []
    if need_center:
        if not torch.equal(got.med, want.med):
            raise AssertionError(f"{label}: median differs from the plain version")
        torch.testing.assert_close(got.trim, want.trim, rtol=1e-5, atol=1e-6)
        errs.append(float((got.trim - want.trim).abs().max()))
    elif got.med is not None or got.trim is not None:
        raise AssertionError(f"{label}: centers returned without need_center")
    for name in ("dist2", "dotmed", "norm2", "mednorm2") + (
            ("prev_dist2", "prev_dot", "prev_norm2") if with_prev else ()):
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, rtol=STAT_RTOL, atol=STAT_ATOL)
        errs.append(float((g - w).abs().max()))
        if g.ndim and not torch.equal(g[0], g[dup]):
            raise AssertionError(f"{label}: identical rows got different {name}")
    cfg = WFAggConfig()
    for fn in (trust.fused_distance_mask, trust.fused_similarity_mask):
        if not torch.equal(fn(got, None, cfg), fn(want, None, cfg)):
            raise AssertionError(f"{label}: {fn.__name__} differs from the plain version")
    print(f"  {label}: median bit-equal, masks bit-equal, identical rows tied, "
          f"max|err| {max(errs):.3g}")
    return max(errs)


def compare_gram(torch, K, D, seed, candidates=cfl_candidates) -> float:
    from repro_torch.core import trust
    from repro_torch.core.wfagg import alt_wfagg_config
    from repro_torch.kernels.pairwise_dist import ops
    from repro_torch.kernels.robust_stats.ops import robust_stats_plain

    u, _, dup = candidates(torch, K, D, seed)
    gram, norm2 = ops.pairwise_gram(u)
    gp, np_ = ops.pairwise_gram_plain(u)
    torch.cuda.synchronize()
    label = f"pairwise_gram K={K} D={D}"
    # sums of D products of order 1: atol scales with D
    torch.testing.assert_close(gram, gp, rtol=1e-4, atol=1e-6 * D)
    torch.testing.assert_close(norm2, np_, rtol=1e-4, atol=1e-6 * D)
    if not torch.equal(gram, gram.T):
        raise AssertionError(f"{label}: Gram not exactly symmetric")
    if not torch.equal(norm2, torch.diagonal(gram)):
        raise AssertionError(f"{label}: norm2 is not the Gram's diagonal")
    # the tie invariant: the twins' Gram rows bit-identical, their own
    # block of four entries one value, their distance exactly 0
    others = [j for j in range(K) if j not in (0, dup)]
    if not torch.equal(gram[0, others], gram[dup, others]):
        raise AssertionError(f"{label}: identical rows got different Gram rows")
    tie = {float(gram[a, b]) for a in (0, dup) for b in (0, dup)}
    if len(tie) != 1:
        raise AssertionError(f"{label}: G[a,a], G[a,b], G[b,b] of twin rows differ: {tie}")
    d2 = trust.sq_dists_from_gram(gram)
    if float(d2[0, dup]) != 0.0 or float(d2[dup, 0]) != 0.0:
        raise AssertionError(f"{label}: twin rows at squared distance {float(d2[0, dup])}")
    stats = robust_stats_plain(u, need_center=False)
    cfg = alt_wfagg_config(multi_krum_m=max(1, int(0.25 * K)))
    for fn in (trust.fused_distance_mask, trust.fused_similarity_mask):
        if not torch.equal(fn(stats, gram, cfg), fn(stats, gp, cfg)):
            raise AssertionError(f"{label}: {fn.__name__} differs with the plain Gram")
    err = float((gram - gp).abs().max())
    print(f"  {label}: symmetric, Multi-Krum and Clustering masks bit-equal, "
          f"identical rows tied (G[a,a] == G[a,b] == G[b,b], distance 0), max|err| "
          f"{err:.3g}")
    return err


def misaligned(torch, shape, offset, g):
    """A contiguous float32 view of ``shape`` on the card whose first element
    sits ``offset`` floats past a 16-byte boundary (standard normal)."""
    import math

    n = math.prod(shape)
    return torch.randn((n + 4,), generator=g, device="cuda")[offset:offset + n].view(shape)


def compare_weighted_agg(torch, label, K, D, seed, offset=0, nan_row=None) -> float:
    """Kernel 7 through ``ops.weighted_agg`` against its plain version, bit
    for bit: the CFL server's candidates (two bit-identical attacker rows,
    weights 0 on them) at ``offset`` = 0, else a view ``offset`` floats off
    a 16-byte boundary; ``nan_row`` holds a NaN and weight 0, so its
    coordinate is NaN in both.  All-zero weights give ``local``: NaN
    exactly where a row holds one, ``local``'s values everywhere else."""
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.weighted_agg import ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    if offset == 0:
        u, _, dup = cfl_candidates(torch, K, D, seed)
        local = u[1:].mean(0) if K > 1 else u[0] + 0.5
    else:
        u, local, dup = misaligned(torch, (K, D), offset, g), misaligned(torch, (D,), offset, g), 0
    w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8)
    if K > 1:
        w[0] = w[dup] = 0.0
    if nan_row is not None:
        u[nan_row, D // 2] = float("nan")
        w[nan_row] = 0.0
    got = ops.weighted_agg(local, u, w, alpha=0.8)
    want = ops.weighted_agg_plain(*combine_coefficients(w, 0.8), local, u)
    zero = ops.weighted_agg(local, u, torch.zeros_like(w), alpha=0.8)
    torch.cuda.synchronize()
    if got.shape != (D,) or not got.is_contiguous():
        raise AssertionError(f"{label}: out has shape {tuple(got.shape)}, contiguous "
                             f"{got.is_contiguous()}")
    if not bit_equal(torch, got, want):
        raise AssertionError(f"{label}: weighted_agg differs from its plain version, max|err| "
                             f"{float((got - want).nan_to_num().abs().max()):.3g}")
    nan_at = combine_nan_places(torch, local[None], u, torch.arange(K, device="cuda")[None])[0]
    if not keeps_local(torch, zero, local, nan_at):
        raise AssertionError(f"{label}: all-zero weights did not keep local")
    n_nan = int(torch.isnan(got).sum())
    print(f"  {label}: bit for bit ({D} values, {n_nan} NaN where the plain version has "
          f"them), zero weights give local exactly")
    return float((got - want).nan_to_num().abs().max())


# kernel 7's phase-2 cases: (label, K, D, seed, offset, nan_row); D % 4 = 2, 3,
# 0, 1, 3, 1
COMBINE_CASES = (
    ("weighted_agg CFL K=20 d=44426", CFL_K, CFL_D, 10, 0, None),
    ("weighted_agg K=32 d=20011", 32, 20011, 10, 0, None),
    ("weighted_agg K=32 D=2^22", BIG_K, BIG_D, 10, 0, None),
    ("weighted_agg K=7 d=4097, 1 float off 16 bytes", 7, 4097, 13, 1, None),
    ("weighted_agg K=40 d=44427, 2 floats off, a NaN row of weight 0", 40, 44427, 14,
     2, 3),
    ("weighted_agg K=1 d=37, 3 floats off", 1, 37, 15, 3, None),
)


# ---------------------------------------------------------------------------
# phase 2: the Gram round and the two-launch kernels of the gossip round
# ---------------------------------------------------------------------------

def alt_config(K):
    """Alt-WFAgg at candidate count K as the DFL engine configures it
    (Multi-Krum m = max(1, int(0.25 K)), Clustering), with the bands of
    ``round_inputs``."""
    from repro_torch.core.wfagg import alt_wfagg_config

    return alt_wfagg_config(transient=3, multi_krum_m=max(1, int(0.25 * K)))


def tied_nodes(torch, idx_t, valid_t, dup):
    """Nodes whose valid slate holds both bit-identical rows (their
    previous-round rows differ), and the two slots of each."""
    v = (torch.ones(idx_t.shape, dtype=torch.bool, device=idx_t.device)
         if valid_t is None else valid_t)
    a, b = (idx_t == dup[0]) & v, (idx_t == dup[1]) & v
    both = torch.nonzero(a.any(1) & b.any(1)).flatten()
    return [(int(n), int(a[n].nonzero()[0]), int(b[n].nonzero()[0])) for n in both]


def tie_mask(torch, ties, N, K):
    """(N, K, K) bool: the slot pairs of ``tied_nodes``."""
    m = torch.zeros((N, K, K), dtype=torch.bool, device="cuda")
    for n, ka, kb in ties:
        m[n, ka, kb] = m[n, kb, ka] = True
    return m


def check_ties(torch, label, stats, ties, fields):
    """Identical rows got bit-identical statistics and Gram rows, and a
    squared distance of exactly 0 to each other."""
    from repro_torch.core import trust

    for n, ka, kb in ties:
        for name in fields:
            x = getattr(stats, name)
            if x is not None and not torch.equal(x[n, ka], x[n, kb]):
                raise AssertionError(f"{label}: identical rows got different {name}")
        if stats.gram is not None:
            g = stats.gram[n]
            others = [j for j in range(g.shape[0]) if j not in (ka, kb)]
            if not (torch.equal(g[ka, others], g[kb, others])
                    and torch.equal(g[ka, ka], g[kb, kb])
                    and torch.equal(g[ka, ka], g[ka, kb])):
                raise AssertionError(f"{label}: identical rows got different Gram rows "
                                     "(or G[a,a], G[a,b], G[b,b] not all equal)")
            if trust.sq_dists_from_gram(g)[ka, kb] != 0:
                raise AssertionError(f"{label}: identical rows at a squared distance "
                                     "other than 0")


def compare_gram_round(torch, label, N, K, d, idx, valid, seed, dup, M=None) -> float:
    """The round kernel's Gram variant (Alt-WFAgg) against its plain
    version, and its epilogue against ``derive_trust_weights`` of its own
    statistics and Gram; on an (M, d) model matrix, the first N rows the
    local models."""
    from repro_torch.core import trust
    from repro_torch.kernels.robust_stats import ops

    models, prev, idx_t, valid_t, tbands, _ = round_inputs(
        torch, N, K, d, idx, valid, seed, dup, M)
    local = models[:N]
    cfg = alt_config(K)
    got = ops.wfagg_round_indexed(local, models, idx_t, valid_t, cfg,
                                  prev=prev, tbands=tbands)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    want = ops.wfagg_round_indexed_plain(local, models, idx_t, v, cfg, prev, tbands)
    own = trust.derive_trust_weights(got[5], v, tbands, cfg)
    torch.cuda.synchronize()
    for name, g, o in zip(("mask_d", "mask_c", "mask_t"), got[2:5], own):
        if not torch.equal(g, o):
            raise AssertionError(f"{label}: the epilogue's {name} differs from "
                                 f"derive_trust_weights of its own stats at "
                                 f"{int((g != o).sum())} edges")
    if not torch.equal(got[1], own[3]):
        raise AssertionError(f"{label}: the epilogue's weights differ from "
                             "derive_trust_weights of its own stats")
    gram, gp = got[5].gram, want[5].gram
    if not torch.equal(gram, gram.transpose(1, 2)):
        raise AssertionError(f"{label}: Gram not exactly symmetric")
    torch.testing.assert_close(gram, gp, rtol=1e-4, atol=1e-6 * d)
    err, n_ties = hold_round(torch, label, got, want, v, tbands, cfg, local, models, idx_t)
    assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
    ties = tied_nodes(torch, idx_t, valid_t, dup)
    check_ties(torch, label, got[5], ties, ("dist2", "dotmed", "norm2"))
    check_twins(torch, f"{label} (plain)", gp, tie_mask(torch, ties, N, K))
    print(f"  {label}: masks bit-equal to the plain version{tie_note(n_ties)} and to "
          f"derive_trust_weights of the kernel's own stats and Gram (mask_d on "
          f"{int(got[2].sum())}, mask_c on {int(got[3].sum())}, mask_t on "
          f"{int(got[4].sum())} of {int(v.sum())} edges); Gram symmetric, max|err| "
          f"{float((gram - gp).abs().max()):.3g}; {len(ties)} nodes with the tied "
          f"rows; out max|err| {err:.3g}")
    return err


def compare_indexed_stats(torch, label, N, K, d, idx, valid, seed, dup,
                          with_prev, need_gram, M=None) -> float:
    """Kernel 2 against ``ref.robust_stats_indexed_ref``: statistics within
    rtol 1e-4, Gram exactly symmetric, identical rows tied, and the masks
    from its statistics bit-equal to those from the plain statistics."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    models, prev, idx_t, valid_t, _, _ = round_inputs(torch, N, K, d, idx, valid,
                                                      seed, dup, M)
    p = prev if with_prev else None
    got = ops.robust_stats_indexed(models, idx_t, valid_t, p, need_gram=need_gram)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    want = robust_stats_indexed_ref(models, idx_t, v, p, need_gram=need_gram)
    torch.cuda.synchronize()
    label = f"{label} prev={with_prev} gram={need_gram}"
    fields = ("dist2", "dotmed", "norm2", "mednorm2") + (
        ("prev_dist2", "prev_dot", "prev_norm2") if with_prev else ())
    errs = [assert_stats_close(torch, got, want, fields)]
    if not with_prev and got.prev_dist2 is not None:
        raise AssertionError(f"{label}: a temporal tail without prev")
    if need_gram:
        if not torch.equal(got.gram, got.gram.transpose(1, 2)):
            raise AssertionError(f"{label}: Gram not exactly symmetric")
        torch.testing.assert_close(got.gram, want.gram, rtol=1e-4, atol=1e-6 * d)
        errs.append(float((got.gram - want.gram).abs().max()))
    elif got.gram is not None:
        raise AssertionError(f"{label}: a Gram without need_gram")
    ties = tied_nodes(torch, idx_t, valid_t, dup)
    check_ties(torch, label, got, ties, fields[:3])
    if need_gram:
        check_twins(torch, f"{label} (plain)", want.gram, tie_mask(torch, ties, N, K))
    cfgs = [WFAggConfig()] + ([alt_config(K)] if need_gram else [])
    for cfg in cfgs:
        mk = lambda st: trust.derive_trust_weights(st, v, None, cfg)[:2]  # noqa: E731
        hold_masks(torch, f"{label} masks from the statistics ({cfg.distance_filter})",
                   mk(got), mk(want), want, v, None, cfg)
    print(f"  {label}: statistics within rtol {STAT_RTOL}, masks bit-equal, "
          f"{len(ties)} nodes with the tied rows tied, max|err| {max(errs):.3g}")
    return max(errs)


def compare_weighted_agg_indexed(torch, label, N, K, d, idx, valid, seed, models=None,
                                 local=None, offset=0, nan_row=None) -> float:
    """Kernel 3 through ``ops.weighted_agg_indexed`` against its plain version,
    bit for bit: random (N, d) models (or the given matrix and local: a
    stacked chaos matrix), views ``offset`` floats off a 16-byte boundary
    where ``offset`` > 0, 30% of the weights 0; ``nan_row`` (a row the
    table reaches) holds a NaN at one coordinate, and the slots that read
    it weight 0, so every node reading it has a NaN there.  All-zero
    weights give ``local``, and a degree-0 row keeps its local model: NaN
    exactly where the inputs put it (``combine_nan_places``), ``local``'s
    values everywhere else."""
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    if models is None:
        models = misaligned(torch, (N, d), offset, g).add_(0.3)
        local = misaligned(torch, (N, d), offset, g)
    idx_t = torch.as_tensor(idx, device="cuda")
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid is None
         else torch.as_tensor(valid, device="cuda"))
    w = torch.where(torch.rand((N, K), generator=g, device="cuda") < 0.3, 0.0, 0.8)
    w = torch.where(v, w, 0.0)
    if nan_row is not None:
        models[nan_row, d // 2] = float("nan")
        w = torch.where(idx_t == nan_row, 0.0, w)
    got = ops.weighted_agg_indexed(local, models, idx_t, w, alpha=0.8)
    want = ops.weighted_agg_indexed_plain(*combine_coefficients(w, 0.8), local, models,
                                          idx_t)
    zero = ops.weighted_agg_indexed(local, models, idx_t, torch.zeros_like(w), alpha=0.8)
    torch.cuda.synchronize()
    if got.shape != (N, d) or not got.is_contiguous():
        raise AssertionError(f"{label}: out has shape {tuple(got.shape)}, contiguous "
                             f"{got.is_contiguous()}")
    if not bit_equal(torch, got, want):
        raise AssertionError(f"{label}: weighted_agg_indexed differs from its plain "
                             f"version, max|err| "
                             f"{float((got - want).nan_to_num().abs().max()):.3g}")
    nan_at = combine_nan_places(torch, local, models, idx_t)
    if not keeps_local(torch, zero, local, nan_at):
        raise AssertionError(f"{label}: all-zero weights did not keep local")
    deg0 = ~v.any(1)
    if not keeps_local(torch, got[deg0], local[deg0], nan_at[deg0]):
        raise AssertionError(f"{label}: a degree-0 row did not keep its local model")
    plan = wk.combine_plan(models.shape[0], N, K, d, "cuda")
    print(f"  {label}: bit for bit ({N * d} values, {int(torch.isnan(got).sum())} NaN "
          f"where the plain version has them), zero weights give local exactly, "
          f"{int(deg0.sum())} degree-0 rows keep local; M={models.shape[0]}, G="
          f"{plan['group']} ({plan['n_groups']} groups), T={plan['tile']}")
    return float((got - want).nan_to_num().abs().max())


def combine_nan_places(torch, local, models, idx):
    """(N, d) bool: where a combine of ``local`` (N, d) and the rows of
    ``models`` that the table ``idx`` (N, K) reaches is NaN whatever its
    weights: a NaN in ``local``, or a value that is not finite in a row that
    any slot reaches (no slot is skipped, and 0 * inf is NaN)."""
    out = torch.isnan(local)
    cols = torch.nonzero((~torch.isfinite(models)).any(0)).flatten()
    if cols.numel():
        out[:, cols] |= (~torch.isfinite(models[:, cols]))[idx.long()].any(1)
    return out


def keeps_local(torch, out, local, nan_at) -> bool:
    """``out`` is NaN exactly at ``nan_at`` and equals ``local`` elsewhere."""
    return torch.equal(torch.isnan(out), nan_at) and torch.equal(out[~nan_at], local[~nan_at])


def check_combine_indexed_extra(torch) -> list:
    """Kernel 3 beyond the Gram-round slates: at its timed shape, at d % 4 = 1
    and 3 on misaligned views with a NaN row of weight 0, on the paper's
    stacked chaos matrix with ``local`` a view of the matrix itself (its
    rows then staged once with the table's), and on a stacked chaos matrix
    deep enough (a ring of 12 past matrices) that the plan splits the nodes
    into groups."""
    from repro_torch.dfl import faults as flt
    from repro_torch.kernels.weighted_agg import kernel as wk

    ring = [[(n + o) % 64 for o in range(1, 17)] for n in range(64)]
    errs = [compare_weighted_agg_indexed(torch, "weighted_agg_indexed ring N=64 K=16 d=2^20",
                                         64, 16, 1 << 20, ring, None, 61)]
    for N, K, d, off, seed in ((20, 8, 44425, 1, 62), (40, 16, 44427, 3, 63)):
        idx, valid = irregular_slate(N, K, seed)
        errs.append(compare_weighted_agg_indexed(
            torch, f"weighted_agg_indexed irregular N={N} K={K} d={d} (degree 0), {off} "
            f"floats off 16 bytes, a NaN row of weight 0", N, K, d, idx, valid, seed,
            offset=off, nan_row=int(idx[0, 0])))
    r, flat, tout = paper_chaos_stack(torch, 44426)
    errs.append(compare_weighted_agg_indexed(
        torch, f"weighted_agg_indexed paper churn+chaos round {r}, local = the matrix's "
        f"first rows", 20, 8, 44426, tout.eff_idx, tout.eff_valid, 64, models=tout.full,
        local=tout.full[:20]))
    N, K, d = 48, 32, 20011
    idx, valid = irregular_slate(N, K, 65)
    flat, tout = chaos_stack(torch, N, K, d, idx, valid, 65,
                             fcfg=flt.FaultConfig(ring_depth=12))
    errs.append(compare_weighted_agg_indexed(
        torch, f"weighted_agg_indexed irregular N={N} K={K} d={d} churn+chaos, ring depth "
        f"12", N, K, d, tout.eff_idx, tout.eff_valid, 65, models=tout.full, local=flat))
    if wk.combine_plan(tout.full.shape[0], N, K, d)["group"] >= N:
        raise AssertionError("the deep chaos stack did not split the nodes into groups")
    return errs


def peak_bytes(torch, call) -> int:
    """The peak allocation of ``call()`` above what was held before it
    (after one warm call)."""
    call()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    del out
    return peak


def check_wrapper_memory(torch, label, call, out_bytes, slack) -> None:
    """A wrapper allocates its outputs and ``slack`` bytes of small
    buffers at most: nothing at the width of its input rows."""
    peak = peak_bytes(torch, call)
    if peak > out_bytes + slack:
        raise AssertionError(f"{label}: {peak} bytes allocated at the peak, for "
                             f"outputs of {out_bytes}")
    print(f"  {label}: {peak} bytes allocated at the peak, the outputs {out_bytes} "
          "(no copy of the rows)")


def check_combine_memory(torch) -> None:
    """The combine wrappers at d % 4 = 2 allocate their output and O(N K)
    coefficients, nothing at the width of the rows: the peak allocation
    above what was held before the call, against the output's bytes."""
    from repro_torch.kernels.weighted_agg import ops

    g = torch.Generator(device="cuda").manual_seed(66)
    N, K, d = 20, 8, 44426
    models = torch.randn((N, d), generator=g, device="cuda")
    local = torch.randn((N, d), generator=g, device="cuda")
    idx = torch.as_tensor([[(n + o) % N for o in range(1, K + 1)] for n in range(N)],
                          device="cuda")
    w = torch.rand((N, K), generator=g, device="cuda")
    slack = 64 << 10                     # the O(N K) coefficients, in 512-byte blocks
    check_wrapper_memory(torch, f"weighted_agg_indexed N={N} K={K} d={d}",
                         lambda: ops.weighted_agg_indexed(local, models, idx, w),
                         4 * N * d, slack)
    check_wrapper_memory(torch, f"weighted_agg N={N} K={K} d={d}",
                         lambda: ops.weighted_agg(local[0], models[:K], w[0]), 4 * d, slack)


# the MLP's and LeNet-5's d: 10 mod 32, 2 mod 4
UNPADDED_D = (50890, 44426)


def pad32(torch, x):
    """``x`` zero-padded on its last axis to a multiple of 32 floats, as the
    wrappers of kernels 1 and 5 padded every row before they took unpadded
    rows (zero columns are exact: they add nothing to any sum)."""
    pad = (-x.shape[-1]) % 32
    return torch.nn.functional.pad(x, (0, pad)).contiguous()


def check_unpadded_rows(torch) -> None:
    """Kernels 1 and 5 take unpadded rows (ROADMAP queue 2, item A): at the
    MLP's and LeNet-5's widths, the ops wrappers (unpadded) are bit for
    bit the kernels launched on the rows padded to 32 floats, every output
    and statistic (raw float32 bits; kernel 1 with prev and bands, plain
    and Gram; kernel 5 with per-edge prev, with and without the centers),
    and each wrapper allocates its outputs only (peak memory)."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops

    N, K = 20, 8
    ring = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    slack = 256 << 10                    # O(N K) statistics and per-CTA partials
    for d in UNPADDED_D:
        models, prev, idx_t, _, tbands, cfg = round_inputs(torch, N, K, d, ring, None,
                                                           seed=d % 97, dup=(0, 4))
        v = torch.ones((N, K), dtype=torch.bool, device="cuda")
        for label, c in (("WFAgg", cfg), ("Alt-WFAgg (Gram)", alt_config(K))):
            got = ops.wfagg_round_indexed(models, models, idx_t, None, c, prev=prev,
                                          tbands=tbands)
            mp = pad32(torch, models)
            want = rk.wfagg_round_indexed_cuda(mp, mp, idx_t.to(torch.int32), v,
                                               pad32(torch, prev), tbands, c, c.alpha,
                                               False)
            same = [bit_equal(torch, got[0], want[0][:, :d].contiguous()),
                    bit_equal(torch, got[1], want[1])] + [
                torch.equal(a, b) for a, b in zip(got[2:5], want[2:5])] + [
                bit_equal(torch, getattr(got[5], f), getattr(want[5], f))
                for f in STAT_FIELDS + (("gram",) if got[5].gram is not None else ())]
            if not all(same):
                raise AssertionError(f"kernel 1 {label} d={d}: the unpadded launch "
                                     f"differs from the padded one ({same})")
            print(f"  wfagg_round_indexed {label} N={N} K={K} d={d} (d % 32 = "
                  f"{d % 32}): unpadded == padded launch bit for bit (out, weights, "
                  f"masks, {len(same) - 5} statistics)")
        out_bytes = 4 * N * d + 4 * 8 * N * K
        check_wrapper_memory(torch, f"wfagg_round_indexed N={N} K={K} d={d}",
                             lambda: ops.wfagg_round_indexed(models, models, idx_t, None,
                                                             cfg, prev=prev, tbands=tbands),
                             out_bytes, slack)
        del models, prev
        u, uprev, _ = gathered_candidates(torch, N, K, d, seed=d % 89)
        for centers in (True, False):
            got = ops.robust_stats_batch(u, uprev, need_center=centers)
            want = rk.robust_stats_batch_cuda(pad32(torch, u), pad32(torch, uprev), 0.1,
                                              centers)
            fields = STAT_FIELDS + (("med", "trim") if centers else ())
            same = {f: bit_equal(torch, getattr(got, f),
                                 getattr(want, f)[..., :d].contiguous()
                                 if f in ("med", "trim") else getattr(want, f))
                    for f in fields}
            if not all(same.values()):
                raise AssertionError(f"kernel 5 d={d} centers={centers}: the unpadded "
                                     f"launch differs from the padded one ({same})")
            print(f"  robust_stats_batch N={N} K={K} d={d} per-edge prev "
                  f"centers={centers}: unpadded == padded launch bit for bit "
                  f"({len(fields)} fields)")
        check_wrapper_memory(torch, f"robust_stats_batch N={N} K={K} d={d} centers",
                             lambda: ops.robust_stats_batch(u, uprev, need_center=True),
                             8 * N * d, slack)
        del u, uprev
        torch.cuda.empty_cache()


def time_dfl_kernels(torch, N, K, d, seed) -> dict:
    """The round kernel's Gram variant and kernel 2 (with Gram and prev)
    through their ``*_cuda`` wrappers on a ring slate, their plain versions
    and bounds.  Returns name -> {ms, plain_ms, bound_ms, bound_by,
    library_ms}."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tbands, _ = round_inputs(torch, N, K, d, idx, None, seed)
    cfg = alt_config(K)
    local = models.clone()
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    out = {}
    # statistics (16 flops per candidate coordinate, as for the round) and
    # the Gram's K(K+1) per node coordinate
    n_ops = (16.0 * K + K * (K + 1.0)) * N * d
    b = bound(4.0 * (3 * N * d + N * d), n_ops)   # models, prev, local, out
    out["wfagg_round_indexed_gram"] = dict(
        ms=time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            local, models, i32, v, prev, tbands, cfg, cfg.alpha, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.wfagg_round_indexed_plain(
            local, models, idx_t, v, cfg, prev, tbands), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    b = bound(4.0 * 2 * N * d, 16.0 * K * N * d)  # models and prev once
    out["robust_stats_indexed_no_gram"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            models, i32, v, prev, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            models, idx_t, v, prev), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    b = bound(4.0 * 2 * N * d, n_ops)             # models and prev once
    out["robust_stats_indexed"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            models, i32, v, prev, True), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            models, idx_t, v, prev, need_gram=True), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    for name, t in out.items():
        name = name.replace("_no_gram", " (prev, without the Gram)")
        print(f"  {name} N={N} K={K} d={d}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}), library none")
    return out


def combine_indexed_inputs(torch, N, K, d, seed):
    """Kernel 3's timed inputs: random models and a local matrix of their
    own, a ring slate, weights that accept someone on every node (so lcoef
    is one number, the beta of ``baddbmm``), and the coefficients."""
    from repro_torch.core.trust import combine_coefficients

    g = torch.Generator(device="cuda").manual_seed(seed)
    models = torch.randn((N, d), generator=g, device="cuda") + 0.3
    local = torch.randn((N, d), generator=g, device="cuda")
    idx = torch.as_tensor([[(n + o) % N for o in range(1, K + 1)] for n in range(N)],
                          dtype=torch.int32, device="cuda")
    w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8).expand(N, K)
    wvec, lcoef = combine_coefficients(w.contiguous(), 0.8)
    return models, local, idx, w.contiguous(), wvec, lcoef


def time_combine_indexed(torch, N, K, d, seed) -> dict:
    """Kernel 3 through its ``*_cuda`` wrapper on a ring slate (every input
    read once: models, local; out written once), its plain version, its
    bound and the library calls (the gather, then one batched matrix
    product), beside the ops-level wrapper as the main path calls it."""
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    models, local, idx, w, wvec, lcoef = combine_indexed_inputs(torch, N, K, d, seed)
    lc = float(lcoef[0])
    b = bound(4.0 * 3 * N * d, 2.0 * N * K * d)
    t = dict(
        ms=time_cuda(torch, lambda: wk.weighted_agg_indexed_cuda(
            wvec, lcoef, local, models, idx), 3, 25),
        plain_ms=time_cuda(torch, lambda: wops.weighted_agg_indexed_plain(
            wvec, lcoef, local, models, idx), 1, 5),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_cuda(torch, lambda: torch.baddbmm(
            local[:, None], wvec[:, None], models[idx.long()], beta=lc), 3, 25))
    ops_ms = time_cuda(torch, lambda: wops.weighted_agg_indexed(local, models, idx, w), 3, 25)
    print(f"  weighted_agg_indexed N={N} K={K} d={d}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
          f"library {t['library_ms']:.4f} ms (models[idx] + torch.baddbmm); "
          f"ops.weighted_agg_indexed {ops_ms:.4f} ms")
    return t


def time_gram_epilogue(torch, N, K, d, seed) -> None:
    """What the Gram variant costs in the round kernel, by difference at a
    short d where the epilogue shows: WFAgg (no Gram), Multi-Krum + WFAgg-C
    (the Gram and the Krum scores) and Alt-WFAgg (also the Clustering
    loop's K - 2 merge steps)."""
    import dataclasses

    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import kernel as rk

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tbands, _ = round_inputs(torch, N, K, d, idx, None, seed)
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    alt = alt_config(K)
    ms = {}
    for name, cfg in (("wfagg", WFAggConfig(transient=3)),
                      ("multi_krum+wfagg_c", dataclasses.replace(
                          alt, similarity_filter="wfagg_c")),
                      ("alt_wfagg", alt)):
        ms[name] = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            models, models, i32, v, prev, tbands, cfg, cfg.alpha, False), 3, 25)
    print(f"  round kernel N={N} K={K} d={d}: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in ms.items()) + " (the Gram and Krum: "
        f"{ms['multi_krum+wfagg_c'] - ms['wfagg']:.4f} ms, the Clustering loop: "
        f"{ms['alt_wfagg'] - ms['multi_krum+wfagg_c']:.4f} ms)")


def time_dfl_backends(torch, N, K, d, seed, aggregators=("wfagg", "alt_wfagg")) -> dict:
    """The gossip round's aggregation (``wfagg_batch``, host work included)
    on ``fused`` (one launch) against ``fused_two_launch`` (two launches
    and the host scoring stage), for WFAgg and Alt-WFAgg, on a ring slate
    with live temporal state; in turns: fused, two-launch, two-launch,
    fused.  Returns aggregator -> backend -> [ms, ms]."""
    import dataclasses

    from repro_torch.core import wfagg as wf

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, _, _ = round_inputs(torch, N, K, d, idx, None, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    hist = lambda: 1 + 0.1 * torch.rand((N, 3, K), generator=g, device="cuda")  # noqa: E731
    state = wf.TemporalState(prev=prev, hist_s=hist(), hist_b=hist(),
                             count=torch.full((N,), 3, dtype=torch.int32, device="cuda"),
                             t=torch.full((N,), 5, dtype=torch.int32, device="cuda"))
    out = {}
    for name in aggregators:
        base = wf.WFAggConfig() if name == "wfagg" else alt_config(K)
        ms = out[name] = {}
        for backend in ("fused", "fused_two_launch", "fused_two_launch", "fused"):
            cfg = dataclasses.replace(base, backend=backend)
            ms.setdefault(backend, []).append(time_cuda(torch, lambda: wf.wfagg_batch(
                models, models, state, cfg, neighbor_idx=idx_t), 2, 10))
        print(f"  {name} aggregation N={N} K={K} d={d} (wfagg_batch, median ms of "
              f"10, two turns each): fused {ms['fused']}, fused_two_launch "
              f"{ms['fused_two_launch']}")
    return out


# kernels 1 and 2 before their redesign onto one phase-0 body, and kernels
# 3 and 7 before theirs, in ms by (entry, shape), as PERF.md section 6
# records them; "big" is N=64, K=16, d=2^20 for kernels 1-3 and
# K=32, D=2^22 for kernel 7, "paper" N=20, K=8, d=44,426
BEFORE_MS = {
    ("weighted_agg_indexed", "big"): 0.6620,
    ("weighted_agg", "big"): 0.2660,
    ("wfagg_round_indexed", "big"): 25.63,
    ("wfagg_round_indexed[prev_idx]", "big"): 31.32,
    ("wfagg_round_indexed[per_edge_prev]", "big"): 37.50,
    ("robust_stats_indexed", "big"): 14.04,
    ("robust_stats_indexed[prev_idx]", "big"): 6.03,
    ("robust_stats_indexed[per_edge_prev]", "big"): 7.18,
    ("wfagg_round_indexed", "paper"): 0.62,
    ("robust_stats_indexed", "paper"): 0.10,
}

# (label, entry of the timings at N=64 K=16 d=2^20, entry at the paper's shape)
ROUND_KERNEL_VARIANTS = (
    ("kernel 1, WFAgg, matrix prev", "wfagg_round_indexed", "wfagg_round_indexed"),
    ("kernel 1, Gram (Alt-WFAgg), matrix prev", "wfagg_round_indexed.gram_variant",
     "wfagg_round_indexed_gram"),
    ("kernel 1, prev_idx", "wfagg_round_indexed[prev_idx]",
     "wfagg_round_indexed[prev_idx]"),
    ("kernel 1, per-edge prev", "wfagg_round_indexed[per_edge_prev]",
     "wfagg_round_indexed[per_edge_prev]"),
    ("kernel 2, prev + Gram", "robust_stats_indexed", "robust_stats_indexed"),
    ("kernel 2, prev, no Gram", "robust_stats_indexed_no_gram",
     "robust_stats_indexed_no_gram"),
    ("kernel 2, prev_idx", "robust_stats_indexed[prev_idx]",
     "robust_stats_indexed[prev_idx]"),
    ("kernel 2, per-edge prev", "robust_stats_indexed[per_edge_prev]",
     "robust_stats_indexed[per_edge_prev]"),
)


def print_cluster_sizes() -> None:
    """The thread-block cluster size (CTAs per node) kernels 1 and 2 take at
    the timed shapes."""
    from repro_torch.kernels.robust_stats import kernel as rk

    print("    kernels 1 and 2, CTAs per node (cluster size): " + ", ".join(
        f"{rk.cluster_size(d)} at d={d}" for d in (44426, 1 << 20, 20011, 37)))


# kernels 4 and 5 at their timed shapes: (label, N, K, D, prev, centers);
# kernel 5's d is padded to a multiple of 32 (ops.robust_stats_batch)
STATS_SHAPES = (
    ("kernel 4, K=20 d=44426, prev", 1, CFL_K, CFL_D, True, False),
    ("kernel 4, K=32 D=2^22, prev", 1, BIG_K, BIG_D, True, False),
    ("kernel 4, K=33 d=50890, prev", 1, 33, 50890, True, False),
    ("kernel 4, K=100 d=50890, prev (the CFL-100 server)", 1, 100, 50890, True, False),
    ("kernel 4, K=1024 d=50890, prev + centers", 1, 1024, 50890, True, True),
    ("kernel 4, K=64 D=2^22, prev", 1, 64, 1 << 22, True, False),
    ("kernel 5, N=8 K=48 d=50890, per-edge prev", 8, 48, 50890, True, False),
    ("kernel 5, N=20 K=8 d=44448, per-edge prev", 20, 8, 44448, True, False),
    ("kernel 5, N=64 K=16 d=2^20, per-edge prev", 64, 16, 1 << 20, True, False),
    ("kernel 5, N=64 K=16 d=2^20, centers", 64, 16, 1 << 20, False, True),
)


def print_combine_plans() -> None:
    """How kernel 3 runs at its timed and checked shapes: its group of nodes
    a CTA, tile, stages, shared memory and CTAs (``kernel.combine_plan``)."""
    from repro_torch.kernels.weighted_agg import kernel as wk

    for label, M, N, K, d in (("ring", 64, 64, 16, 1 << 20), ("paper ring", 20, 20, 8, 44426),
                              ("paper chaos stack", 84, 20, 8, 44426),
                              ("chaos stack", 260, 64, 16, 1 << 20),
                              ("chaos stack, ring depth 12", 628, 48, 32, 20011)):
        p = wk.combine_plan(M, N, K, d, "cuda")
        print(f"    kernel 3, {label} M={M} N={N} K={K} d={d}: G={p['group']} "
              f"({p['n_groups']} groups), {p['rows']} rows a stage, T={p['tile']}, "
              f"{p['stages']} stages, {p['smem']} bytes, {p['ctas_per_sm']} CTAs per SM, "
              f"{p['blocks']} CTAs per group")


def print_combine_times(timed: dict) -> None:
    """Kernels 3 and 7 at their timed shapes and the paper's: time, bound,
    plain version, library call, and the time before their redesign."""
    for name, big in (("weighted_agg_indexed", "N=64 K=16 d=2^20"),
                      ("weighted_agg", "K=32 D=2^22")):
        for where, t in ((big, timed[name]), ("paper shape", timed[name]["paper_shape"])):
            before = BEFORE_MS.get((name, "big")) if where == big else None
            was = f"{before} ms (PERF.md)" if before else "not recorded"
            print(f"    {name:21s} {where:17s} {t['ms']:8.4f} / {t['bound_ms']:.5f} "
                  f"({t['bound_by']}) / {t['plain_ms']:8.4f} / {t['library_ms']:.4f}; "
                  f"before: {was}")


def print_stats_plans() -> None:
    """How ``robust_stats.cu`` (kernels 4 and 5) runs at the timed shapes:
    the stages of its ``cp.async`` ring, the tile width, the CTAs an SM
    holds (the instance's occupancy) and the CTAs per node; and how
    ``pairwise_gram.cu`` (kernel 6) tiles the Gram above K = 32."""
    import torch

    from repro_torch.kernels.pairwise_dist import kernel as pk
    from repro_torch.kernels.robust_stats import kernel as rk

    for label, N, K, D, with_prev, centers in STATS_SHAPES:
        p = rk.stats_plan(N, K, D, with_prev, centers, "cuda")
        if p["path"] == "wide":
            print(f"    {label}: wide path, {p['tile']}-coordinate tiles sorted by a "
                  f"bitonic network of {p['kp']} wires (64-rank runs in registers), "
                  f"{p['ctas_per_sm']} CTAs per SM, {p['blocks']} CTAs per node")
            continue
        net = f"network width {p['kp']}" + (", specialised on K" if p["specialised"]
                                           else ", +inf padding")
        print(f"    {label}: {p['stages']} stages of {p['tile']}-coordinate tiles, "
              f"{p['ctas_per_sm']} CTAs per SM, {p['blocks']} CTAs per node, {net}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for K, D in MANY_GRAM + tuple(t for t in MANY_TIMED if t not in MANY_GRAM):
        p = pk.gram_plan(K, D, sms)
        print(f"    kernel 6, K={K} D={D}: {p['tile_pairs']} pairs of 64 x 64 output tiles x "
              f"{p['blocks']} splits of D, partials {p['blocks'] * K * K * 4 / 2**20:.2f} MiB")


def print_round_kernel_times(big: dict, paper: dict) -> None:
    """Kernels 1 and 2 in every variant at both shapes: time, bound, plain
    version, and the time before the redesign where PERF.md recorded one."""
    def get(table, key):
        name, _, sub = key.partition(".")
        return table[name][sub] if sub else table[name]

    print("  kernels 1 and 2 (one phase-0 body, a cluster per node), kernel ms / bound "
          "ms / plain ms, and before that redesign:")
    for label, kb, kp in ROUND_KERNEL_VARIANTS:
        for shape, table, key in (("big", big, kb), ("paper", paper, kp)):
            t = get(table, key)
            before = BEFORE_MS.get((key, shape))
            was = f"{before} ms (PERF.md)" if before else "not recorded"
            where = "N=64 K=16 d=2^20" if shape == "big" else "N=20 K=8 d=44426"
            print(f"    {label:42s} {where:17s} {t['ms']:9.4f} / {t['bound_ms']:.5f} "
                  f"({t['bound_by']}) / {t['plain_ms']:9.4f}; before: {was}")


def network_compare_exchanges(K: int) -> int:
    """Compare-exchanges of robust_stats.cu's median network on K wires: at
    K <= 32 the odd-even merge sort on 8, 16 or 32 wires less those that
    touch a wire past K (``ref.network_pairs``, counted here so that the
    timers also run on a tree without it); above, the wide path's bitonic
    sort of KP = K rounded up to a power of two wires, KP/2 a stage over
    log2(KP) (log2(KP) + 1) / 2 stages."""
    if K > 32:
        kp = 1 << (K - 1).bit_length()
        lg = kp.bit_length() - 1
        return kp // 2 * lg * (lg + 1) // 2
    kp = 8 if K <= 8 else 16 if K <= 16 else 32
    lg = kp.bit_length() - 1
    return sum(lo >= k % p and (lo - k % p) % (2 * k) < k and lo + k < K
               and lo // (2 * p) == (lo + k) // (2 * p)
               for p, k in ((1 << a, 1 << b) for a in range(lg) for b in range(a + 1))
               for lo in range(kp))


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / ops_per_s * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def time_robust_stats(torch, u, prev) -> dict:
    """Kernel 4's wrapper (``robust_stats_cuda``) as the CFL server calls
    it, with the temporal tail and no centers, beside its plain version and
    its bound: read u and prev once; 2 ops per compare-exchange, 8 flops
    per candidate coordinate for dist2 / dotmed / norm2 and 7 for the
    tail."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops

    K, D = u.shape
    b = bound(4.0 * 2 * K * D, D * (2.0 * network_compare_exchanges(K) + 15.0 * K))
    return dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_cuda(u, prev, 0.1, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.robust_stats_plain(
            u, prev, need_center=False), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)


def time_cfl_kernels(torch, K, D, seed) -> dict:
    """Each single-matrix kernel's wrapper (``*_cuda``, the call that
    launches it) as the CFL server calls it, its plain version, its bound
    and, where one exists, the one PyTorch call that computes the same
    function.  Returns name -> {ms, plain_ms, bound_ms, bound_by,
    library_ms}."""
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.pairwise_dist import kernel as pk
    from repro_torch.kernels.pairwise_dist import ops as pops
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    u, prev, dup = cfl_candidates(torch, K, D, seed)
    out = {"robust_stats": time_robust_stats(torch, u, prev)}
    b = bound(4.0 * K * D, float(K * (K + 1)) * D)
    out["pairwise_gram"] = dict(
        ms=time_cuda(torch, lambda: pk.pairwise_gram_cuda(u), 3, 25),
        plain_ms=time_cuda(torch, lambda: pops.pairwise_gram_plain(u), 1, 5),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_cuda(torch, lambda: torch.mm(u, u.t()), 3, 25))
    w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8)
    w[0] = w[dup] = 0.0
    wvec, lcoef = combine_coefficients(w, 0.8)
    lcoef = lcoef.reshape(1)
    local = u[1:].mean(0)
    lc = float(lcoef)
    b = bound(4.0 * (K + 2) * D, 2.0 * K * D)
    out["weighted_agg"] = dict(
        ms=time_cuda(torch, lambda: wk.weighted_agg_cuda(wvec, lcoef, local, u), 3, 25),
        plain_ms=time_cuda(torch, lambda: wops.weighted_agg_plain(
            wvec, lcoef, local, u), 1, 5),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_cuda(torch, lambda: torch.addmv(local, u.t(), wvec, beta=lc),
                             3, 25))
    # the ops-level wrappers as the main path calls them (the coefficients)
    wrap = (time_cuda(torch, lambda: rops.robust_stats(u, prev, need_center=False), 3, 25),
            time_cuda(torch, lambda: pops.pairwise_gram(u), 3, 25),
            time_cuda(torch, lambda: wops.weighted_agg(local, u, w, alpha=0.8), 3, 25))
    for name, t in out.items():
        lib = ("none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms")
        print(f"  {name} K={K} D={D}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
              f"library {lib}")
    print(f"  ops-level wrappers at K={K} D={D}: robust_stats {wrap[0]:.4f} ms, "
          f"pairwise_gram {wrap[1]:.4f} ms, weighted_agg {wrap[2]:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 2: the prev_idx variants of kernels 1 and 2 (chaos transport)
# ---------------------------------------------------------------------------

def chaos_stack(torch, N, K, d, idx, valid, seed, fault_round=None, rnd=3, dup=(0, 4),
                fcfg=None):
    """One round's stacked chaos matrix, built by the port's own
    ``apply_transport`` on the card: models with two bit-identical attacker
    rows, a ring of earlier matrices (three, or ``fcfg.ring_depth``), a
    random served-lag table and a fault round (``fault_round``: numpy
    (drop, lag, dup, corrupt, down); random by default, with no crashed
    node).  Returns ``(flat, tout)``."""
    import numpy as np

    from repro_torch.dfl import faults as flt

    fcfg = fcfg or flt.FaultConfig()
    g = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randn((N, d), generator=g, device="cuda") + 0.3
    flat[dup[1]] = flat[dup[0]] = -100.0 * flat.mean(0)
    ring = flat + 0.2 * torch.randn((fcfg.ring_depth, N, d), generator=g, device="cuda")
    rng = np.random.default_rng(seed)
    served = rng.integers(0, 3, (N, K)).astype(np.int32)
    if fault_round is None:
        fault_round = (rng.random((N, K)) < 0.2, rng.integers(0, 3, (N, K)).astype(np.int32),
                       rng.random((N, K)) < 0.1, rng.random((N, K)) < 0.3,
                       np.zeros(N, bool))
    up = lambda x: torch.as_tensor(np.asarray(x), device="cuda")  # noqa: E731
    tout = flt.apply_transport(flat, flt.TransportState(ring, up(served)), up(idx),
                               up(valid), flt.FaultRound(*map(up, fault_round)), fcfg, rnd)
    return flat, tout


def chaos_bands(torch, tout, seed):
    """WFAgg-T bands around the round's own temporal metrics (prev read
    through ``prev_idx``), so the band test both accepts and rejects; the
    additive term keeps a band of width > 0 where an edge was served last
    round's payload again (s_t = b_t = 0; ``zero_width_bands`` holds that
    case)."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    N, K = tout.eff_idx.shape
    st = robust_stats_indexed_ref(tout.full, tout.eff_idx, tout.eff_valid, tout.full,
                                  prev_idx=tout.prev_idx)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda: torch.randn((N, 3, K), generator=g, device="cuda")  # noqa: E731
    jitter = lambda x: x[:, None, :] * (1 + 0.05 * rnd()) + 1e-3 * rnd()  # noqa: E731
    return trust.temporal_bands(jitter(st.prev_dist2), jitter(st.cosine_to_prev()),
                                torch.full((N,), 3, device="cuda"),
                                torch.full((N,), 5, device="cuda"), WFAggConfig(transient=3))


def zero_width_bands(torch, N, K):
    """WFAgg-T bands from a metric history of zeros, what the no-delivery
    hygiene leaves on an edge re-served its last payload round after
    round: zero width, at 0, on every edge.  A re-served payload has
    s_t = b_t = 0 exactly, on both edges of the band; the reference
    accepts it (``lo <= x <= hi``)."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig

    z = torch.zeros((N, 3, K), device="cuda")
    return trust.temporal_bands(z, z, torch.full((N,), 3, device="cuda"),
                                torch.full((N,), 5, device="cuda"),
                                WFAggConfig(transient=3))


def twin_slots(torch, models, idx, v):
    """(N, K, K) bool: pairs of distinct valid slots of a node that read
    bit-identical nonzero rows (one row read twice, or two equal rows)."""
    u = models[idx.long()]
    K = idx.shape[1]
    same = torch.stack([(x[:, None] == x[None]).all(-1) for x in u])
    ok = v & (u != 0).any(-1)
    eye = torch.eye(K, dtype=torch.bool, device=u.device)
    return same & ok[:, :, None] & ok[:, None, :] & ~eye


def check_twins(torch, label, gram, twins) -> None:
    """Two slots that read bit-identical rows are at squared distance
    exactly 0 in the distances Multi-Krum reads from ``gram``."""
    from repro_torch.core import trust

    d2 = trust.sq_dists_from_gram(gram)[twins]
    if (d2 != 0).any():
        raise AssertionError(f"{label}: {int((d2 != 0).sum())} pairs of bit-identical "
                             f"candidates at a squared distance other than 0 "
                             f"(max {float(d2.max()):.3g})")


STAT_FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
               "prev_norm2")


def same_outputs(torch, a, b) -> bool:
    """Bit-identical round or statistics outputs (tensors, RobustStats)."""
    if isinstance(a, tuple):
        return all(same_outputs(torch, x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return torch.equal(a, b)


def check_gram(torch, label, gram, want, d) -> None:
    """A Gram of the stacked chaos matrix against the plain one: exactly
    symmetric, and each entry within 1e-4 of its Cauchy-Schwarz scale
    sqrt(G_ii G_jj) (+ 1e-6 d).  On the diagonal that is rtol 1e-4, as for
    the clean slates; off it, a finite corrupt row (norm ~1e3 sqrt(d)) and
    a plain one (~sqrt(d)) are nearly orthogonal, so their entry is a sum
    that cancels, and float32 sums in another order differ by a small
    fraction of the scale but more than 1e-4 of the entry."""
    if not torch.equal(gram, gram.transpose(1, 2)):
        raise AssertionError(f"{label}: Gram not exactly symmetric")
    diag = torch.diagonal(want, dim1=1, dim2=2).clamp(min=0)
    scale = torch.sqrt(diag[:, :, None] * diag[:, None, :])
    excess = (gram - want).abs() - (1e-4 * scale + 1e-6 * d)
    if (excess > 0).any():
        raise AssertionError(f"{label}: Gram off the plain one by more than 1e-4 of "
                             f"its scale at {int((excess > 0).sum())} entries")


def compare_prev_idx(torch, label, flat, tout, seed) -> dict:
    """Kernels 1 and 2 with ``prev_idx`` against their plain versions on one
    stacked chaos matrix (masks bit-equal, ``out`` within 3e-5, statistics
    within rtol 1e-4), for WFAgg and Alt-WFAgg (the Gram variant) and with
    and without the Gram; bit-identical candidates at squared distance
    exactly 0 in every Gram; under zero-width bands at 0, WFAgg-T accepting
    exactly the valid edges re-served their last payload, as the plain
    version does; and, with ``prev_idx = neighbor_idx``, every output
    bit-identical to the launch without ``prev_idx``.  Returns the max
    errors by kernel variant."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    full, idx, v, pidx = tout.full, tout.eff_idx, tout.eff_valid, tout.prev_idx
    N, K = idx.shape
    d = full.shape[1]
    tb = chaos_bands(torch, tout, seed)
    zb = zero_width_bands(torch, N, K)
    # s_t = 0 exactly: the edge reads last round's payload again
    reserved = v & (full[idx] == full[pidx]).all(-1)
    if not reserved.any():
        raise AssertionError(f"{label}: no valid edge was re-served its last payload")
    twins = twin_slots(torch, full, idx, v)
    errs = {"wfagg_round_indexed[prev_idx]": [], "robust_stats_indexed[prev_idx]": []}
    fired = []
    for cfg in (WFAggConfig(transient=3), alt_config(K)):
        name = f"{label} {cfg.distance_filter}"
        zk = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=zb,
                                     prev_idx=pidx)[4]
        zp = ops.wfagg_round_indexed_plain(flat, full, idx, v, cfg, full, zb,
                                           prev_idx=pidx)[4]
        if not (torch.equal(zk, zp) and torch.equal(zp, reserved)):
            raise AssertionError(f"{name}: under zero-width bands mask_t is not the set "
                                 "of re-served edges in kernel and plain version")
        got = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=tb,
                                      prev_idx=pidx)
        want = ops.wfagg_round_indexed_plain(flat, full, idx, v, cfg, full, tb,
                                             prev_idx=pidx)
        same = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=tb,
                                       prev_idx=idx)
        old = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=tb)
        torch.cuda.synchronize()
        err, _ = hold_round(torch, name, got, want, v, tb, cfg, flat, full, idx)
        assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
        if got[5].gram is not None:
            check_gram(torch, name, got[5].gram, want[5].gram, d)
            check_twins(torch, name, got[5].gram, twins)
            check_twins(torch, f"{name} (plain)", want[5].gram, twins)
        if not same_outputs(torch, same, old):
            raise AssertionError(f"{name}: prev_idx = neighbor_idx is not bit-identical "
                                 "to the launch without prev_idx")
        errs["wfagg_round_indexed[prev_idx]"].append(err)
        fired.append(int(got[4].sum()))
    for need_gram in (False, True):
        got = ops.robust_stats_indexed(full, idx, v, full, need_gram=need_gram,
                                       prev_idx=pidx)
        want = robust_stats_indexed_ref(full, idx, v, full, need_gram=need_gram,
                                        prev_idx=pidx)
        same = ops.robust_stats_indexed(full, idx, v, full, need_gram=need_gram,
                                        prev_idx=idx)
        old = ops.robust_stats_indexed(full, idx, v, full, need_gram=need_gram)
        torch.cuda.synchronize()
        e = [assert_stats_close(torch, got, want, STAT_FIELDS)]
        if need_gram:
            check_gram(torch, f"{label} robust_stats_indexed", got.gram, want.gram, d)
            check_twins(torch, f"{label} robust_stats_indexed", got.gram, twins)
            check_twins(torch, f"{label} robust_stats_indexed (plain)", want.gram, twins)
        for cfg in (WFAggConfig(transient=3),) + ((alt_config(K),) if need_gram else ()):
            mk = lambda st: trust.derive_trust_weights(st, v, tb, cfg)[:3]  # noqa: E731
            hold_masks(torch, f"{label} robust_stats_indexed ({cfg.distance_filter})",
                       mk(got), mk(want), want, v, tb, cfg)
            if not torch.equal(trust.derive_trust_weights(got, v, zb, cfg)[2], reserved):
                raise AssertionError(f"{label} robust_stats_indexed: under zero-width "
                                     "bands mask_t is not the set of re-served edges")
        if not same_outputs(torch, tuple(same), tuple(old)):
            raise AssertionError(f"{label} robust_stats_indexed gram={need_gram}: prev_idx "
                                 "= neighbor_idx is not bit-identical to the launch "
                                 "without prev_idx")
        errs["robust_stats_indexed[prev_idx]"].append(max(e))
    print(f"  {label}: masks bit-equal for WFAgg and Alt-WFAgg (mask_t on {fired} of "
          f"{int(v.sum())} valid edges; under zero-width bands at 0 on the "
          f"{int(reserved.sum())} re-served edges exactly), {int(twins.sum()) // 2} pairs "
          f"of bit-identical candidates at squared distance 0 in every Gram, "
          f"{int((~v.any(1)).sum())} degree-0 rows, "
          f"prev_idx != neighbor_idx on {float((pidx != idx).float().mean()):.2f} of "
          f"the edges; with prev_idx = neighbor_idx both kernels bit-identical to the "
          f"launch without it; out max|err| "
          f"{max(errs['wfagg_round_indexed[prev_idx]']):.3g}, statistics max|err| "
          f"{max(errs['robust_stats_indexed[prev_idx]']):.3g}")
    return errs


def check_overflow_row(torch) -> None:
    """Kernels 1 and 2 on the paper's ring with one candidate row whose
    squared norm overflows float32 (a corrupt payload): +-inf statistics
    exactly where the plain version has them (their float32 terms overflow
    as the plain version's do, so none turns NaN), the rest
    within rtol 1e-4 / atol 1e-3 of it; the round's masks as
    ``hold_masks``."""
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    topo = make_topology(20, 8, 2, "ring", placement="close")
    models, prev, idx_t, _, tb, _ = round_inputs(torch, 20, 8, 44426,
                                                 topo.neighbor_indices, None, seed=61)
    models[3] = 3e19
    v = torch.ones((20, 8), dtype=torch.bool, device="cuda")
    got = ops.robust_stats_indexed(models, idx_t, v, prev, need_gram=True)
    want = robust_stats_indexed_ref(models, idx_t, v, prev, need_gram=True)
    rnd = ops.wfagg_round_indexed(models, models, idx_t, v, alt_config(8), prev=prev,
                                  tbands=tb)
    rwant = ops.wfagg_round_indexed_plain(models, models, idx_t, v, alt_config(8), prev, tb)
    torch.cuda.synchronize()
    for label, st in (("robust_stats_indexed", got), ("wfagg_round_indexed", rnd[5])):
        for name in STAT_FIELDS:
            g, w = getattr(st, name), getattr(want, name)
            big = ~torch.isfinite(w)
            if not (torch.equal(g[big], w[big]) and torch.isfinite(g[~big]).all()):
                raise AssertionError(f"overflow row, {label}: {name} is not +-inf exactly "
                                     "where the plain version's is")
            torch.testing.assert_close(g[~big], w[~big], rtol=STAT_RTOL, atol=STAT_ATOL)
    hold_masks(torch, "overflow row, wfagg_round_indexed", rnd[2:5], rwant[2:5], rwant[5],
               v, tb, alt_config(8))
    n_inf = int((~torch.isfinite(want.norm2)).sum())
    print(f"  overflow row (|x| = 3e19, d=44426) on the paper ring: +-inf statistics at "
          f"the same {n_inf} slots' norm2 as the plain version in both kernels, no NaN; "
          "the rest within tolerance, round masks as the plain version's")


def check_kernel_order(torch, slates) -> None:
    """Kernels 1 and 2 against ``ref.robust_stats_indexed_kernel_order``, the
    plain emulation of their summation order that the CPU tests hold
    against the JAX package: every statistic and Gram entry bit-equal (the
    emulation's float64 ``fma`` could round twice and show a 1-ulp
    difference; these seeded inputs have none), at the cluster size the
    kernels take; and kernel 1's statistics bit-identical to kernel 2's
    (one phase-0 body).  Matrix prev, and a per-edge prev at K=20 and, on
    the wide route, K=100."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_kernel_order

    n_vals = 0
    for label, N, K, d, idx, valid, seed in slates:
        models, prev, idx_t, valid_t, _, _ = round_inputs(torch, N, K, d, idx, valid, seed,
                                                          (0, 4))
        v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
             else valid_t)
        p = prev[idx_t.long()] if K in (20, 100) else prev
        got = ops.robust_stats_indexed(models, idx_t, v, p, need_gram=True)
        rnd = ops.wfagg_round_indexed(models, models, idx_t, valid_t, alt_config(K), prev=p)
        emu = robust_stats_indexed_kernel_order(models, idx_t, v, p, True,
                                                cluster=rk.cluster_size(d))
        torch.cuda.synchronize()
        for name in STAT_FIELDS + ("gram",):
            g, e, r = getattr(got, name), getattr(emu, name), getattr(rnd[5], name)
            if not torch.equal(g, e):
                raise AssertionError(f"kernel order {label}: {name} differs from the "
                                     f"emulation at {int((g != e).sum())} of {g.numel()}")
            if not torch.equal(r, g):
                raise AssertionError(f"kernel order {label}: the round kernel's {name} "
                                     "differs from the statistics kernel's")
            n_vals += g.numel()
    print(f"  kernels 1 and 2 == ref.robust_stats_indexed_kernel_order bit for bit "
          f"({n_vals} statistics and Gram entries on {len(slates)} slates), and "
          "kernel 1's statistics == kernel 2's")


def paper_chaos_stack(torch, d):
    """The paper's round shape (N=20, K=8) under ``churn`` + ``chaos``: the
    first round of the schedule that has a degree-0 row and a finite
    corrupt (bank) row among the valid edges."""
    from repro_torch.core.topology import make_topology
    from repro_torch.dfl.dynamics import make_faulty_schedule

    topo = make_topology(20, 8, 2, "ring", placement="close")
    sched, fs = make_faulty_schedule("churn", topo, 8, fault="chaos", intensity=0.4,
                                     seed=3, fault_seed=3)
    M = topo.n_nodes
    for r in range(sched.rounds):
        fr = [x[r] for x in (fs.drop, fs.lag, fs.dup, fs.corrupt, fs.down)]
        flat, tout = chaos_stack(torch, M, sched.width, d, sched.neighbor_idx[r],
                                 sched.valid[r], seed=31, fault_round=fr)
        bank_rows = tout.eff_idx >= tout.full.shape[0] - fs.config.bank_size
        if (~tout.eff_valid.any(1)).any() and (bank_rows & tout.eff_valid).any():
            return r, flat, tout
    raise AssertionError("no round of the schedule has a degree-0 row and a corrupt row")


def time_prev_idx_kernels(torch, N, K, d, seed) -> dict:
    """Kernels 1 and 2 with ``prev_idx`` through their ``*_cuda`` wrappers on a
    stacked chaos matrix (L=3, C=4: (L+1)·N + C rows) read through a ring
    slate, beside the same launch without ``prev_idx``, their plain
    versions and bounds.  The bound reads the distinct rows that the two
    tables reach once (and, for the round, ``local`` once and ``out``)."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    flat, tout = chaos_stack(torch, N, K, d, idx, [[True] * K] * N, seed)
    full, v = tout.full, tout.eff_valid
    i32, p32 = tout.eff_idx.to(torch.int32), tout.prev_idx.to(torch.int32)
    tb = chaos_bands(torch, tout, seed)
    cfg = WFAggConfig(transient=3)
    rows = int(torch.unique(torch.cat([tout.eff_idx.flatten(),
                                       tout.prev_idx.flatten()])).numel())
    out = {}
    base = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
        flat, full, i32, v, full, tb, cfg, cfg.alpha, False), 3, 25)
    b = bound(4.0 * d * (rows + 2 * N), 16.0 * N * K * d)
    out["wfagg_round_indexed[prev_idx]"] = dict(
        ms=time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            flat, full, i32, v, full, tb, cfg, cfg.alpha, False, prev_idx=p32), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.wfagg_round_indexed_plain(
            flat, full, tout.eff_idx, v, cfg, full, tb, prev_idx=tout.prev_idx), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    base2 = time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
        full, i32, v, full, False), 3, 25)
    b = bound(4.0 * d * rows, 16.0 * N * K * d)
    out["robust_stats_indexed[prev_idx]"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            full, i32, v, full, False, prev_idx=p32), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            full, tout.eff_idx, v, full, prev_idx=tout.prev_idx), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    print(f"  stacked chaos matrix N={N} K={K} d={d}: {full.shape[0]} rows, the two "
          f"tables reach {rows} distinct rows; without prev_idx (prev through the "
          f"neighbour table) the round kernel takes {base:.4f} ms and the statistics "
          f"kernel {base2:.4f} ms")
    for name, t in out.items():
        print(f"  {name} N={N} K={K} d={d}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}); "
              "no single PyTorch call computes this function")
    return out


# ---------------------------------------------------------------------------
# phase 2: kernel 5 (the gathered statistics) and the per-edge variants of
# kernels 1 and 2
# ---------------------------------------------------------------------------

def gathered_candidates(torch, N, K, d, seed, nan_node=None):
    """A gathered (N, K, d) tensor on the card and its per-edge ``prev``:
    every node's rows near a model of its own, row k at a noise scale of
    0.05 (k + 1) (so the filters' scores are apart by more than float32
    sums in another order can move them), rows 0 and ``K // 2`` one
    bit-identical attacker model (their prev rows identical too), and with
    ``nan_node`` a NaN row in that node's slot 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn((N, 1, d), generator=g, device="cuda")
    scale = 0.05 * torch.arange(1, K + 1, device="cuda", dtype=torch.float32)
    u = torch.randn((N, K, d), generator=g, device="cuda").mul_(scale[:, None]).add_(base)
    prev = torch.randn((N, K, d), generator=g, device="cuda").mul_(0.05).add_(u)
    tie = K // 2
    u[:, 0] = -3.0 * base[:, 0]
    u[:, tie] = u[:, 0]
    prev[:, tie] = prev[:, 0]
    if nan_node is not None:
        u[nan_node, 1] = float("nan")
    return u, prev, tie


def same_bits(torch, a, b) -> bool:
    """Equal values, NaN in the same places."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def bit_equal(torch, a, b) -> bool:
    """The same float32 bits everywhere: the sign of a zero, an infinity
    and a NaN's payload included."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def compare_robust_stats_batch(torch, label, u, prev, tie, nan_node, need_center) -> float:
    """Kernel 5 against its plain version (``ref.robust_stats_batch_ref``):
    the median bit-equal with its NaN in the same places (the NaN node's
    median all NaN), the trimmed mean within rtol 1e-5, the statistics
    within rtol 1e-4 / atol 1e-3 with NaN in the same places, the tied rows
    bit-equal sums, and the WFAgg-D/C masks of every finite node bit-equal."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_batch_ref

    N = u.shape[0]
    got = ops.robust_stats_batch(u, prev, need_center=need_center)
    want = robust_stats_batch_ref(u, prev, need_center=need_center)
    torch.cuda.synchronize()
    errs = []
    if need_center:
        if not same_bits(torch, got.med, want.med):
            raise AssertionError(f"{label}: median differs from the plain version")
        torch.testing.assert_close(got.trim, want.trim, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
        fin = torch.isfinite(want.trim)
        errs.append(float((got.trim - want.trim)[fin].abs().max()))
        if nan_node is not None and not torch.isnan(got.med[nan_node]).all():
            raise AssertionError(f"{label}: the NaN row left a finite median")
    elif got.med is not None or got.trim is not None:
        raise AssertionError(f"{label}: centers returned without need_center")
    fields = STAT_FIELDS if prev is not None else STAT_FIELDS[:4]
    keep = torch.arange(N, device="cuda") != (-1 if nan_node is None else nan_node)
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, rtol=STAT_RTOL, atol=STAT_ATOL, equal_nan=True)
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{label}: {name} NaN in other places than the plain")
        fin = torch.isfinite(w)
        errs.append(float((g - w)[fin].abs().max()))
        if g.ndim == 2 and not torch.equal(g[keep, 0], g[keep, tie]):
            raise AssertionError(f"{label}: identical rows got different {name}")
    if nan_node is not None and not torch.isnan(got.dist2[nan_node]).all():
        raise AssertionError(f"{label}: the NaN row left finite distances")
    cfg = WFAggConfig()
    for fn in (trust.fused_distance_mask, trust.fused_similarity_mask):
        if not torch.equal(fn(got, None, cfg)[keep], fn(want, None, cfg)[keep]):
            raise AssertionError(f"{label}: {fn.__name__} differs from the plain version")
    print(f"  {label}: median bit-equal, NaN in the same places"
          f"{'' if nan_node is None else f' (node {nan_node} all NaN)'}, masks "
          f"bit-equal, tied rows tied, max|err| {max(errs):.3g}")
    return max(errs)


def time_robust_stats_batch(torch, u, prev, need_center) -> dict:
    """Kernel 5's wrapper (``robust_stats_batch_cuda``) on the unpadded
    tensor the main path hands it, its plain version and its bound: read
    the candidates (and prev) once, write the centers; 2 ops per
    compare-exchange, 8 flops per candidate coordinate for dist2 / dotmed /
    norm2 and 7 for the temporal tail."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats.ref import robust_stats_batch_ref

    N, K, d = u.shape
    nbytes = 4.0 * N * K * d * (2 if prev is not None else 1) + (
        8.0 * N * d if need_center else 0.0)
    ops = N * d * (2.0 * network_compare_exchanges(K) + (15.0 if prev is not None
                                                         else 8.0) * K)
    b = bound(nbytes, ops)
    t = dict(ms=time_cuda(torch, lambda: rk.robust_stats_batch_cuda(u, prev, 0.1,
                                                                    need_center), 3, 25),
             plain_ms=time_cuda(torch, lambda: robust_stats_batch_ref(
                 u, prev, need_center=need_center), 1, 5),
             bound_ms=b[0], bound_by=b[1], library_ms=None)
    print(f"  robust_stats_batch N={N} K={K} d={d} prev={prev is not None} "
          f"centers={need_center}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}); no single PyTorch call "
          "computes these statistics")
    return t


def check_kernel5(torch) -> tuple:
    """Kernel 5 at the three shapes of PERF.md: the paper's gathered DFL
    round (N=20, K=8, d=44,426, per-edge prev, no centers) and N=64, K=16,
    d=2^20 with per-edge prev and no centers, and without prev with the
    centers; each with tied rows and a NaN row, then timed.  Returns the
    max errors and the times by shape."""
    errs, times = [], {}
    for N, K, d, with_prev, centers, seed in ((20, 8, 44426, True, False, 51),
                                              (64, 16, 1 << 20, True, False, 52),
                                              (64, 16, 1 << 20, False, True, 53)):
        u, prev, tie = gathered_candidates(torch, N, K, d, seed, nan_node=3)
        p = prev if with_prev else None
        label = f"robust_stats_batch N={N} K={K} d={d} prev={with_prev} centers={centers}"
        errs.append(compare_robust_stats_batch(torch, label, u, p, tie, 3, centers))
        u[3, 1] = u[3, 2]     # time finite inputs
        times[(N, K, d, with_prev, centers)] = time_robust_stats_batch(torch, u, p, centers)
        del u, prev, p
        torch.cuda.empty_cache()
    return errs, times


def check_stats_kernel_order(torch) -> None:
    """Kernels 4 and 5 (``robust_stats.cu``) bit for bit against
    ``ref.robust_stats_kernel_order``, the plain emulation of their order
    that the CPU tests hold against the JAX package, at the CTAs per node
    the wrappers take: every center and statistic equal, NaN in the same
    places.  Kernel 4 at its timed shapes (K=20 d=44,426, where D % 4 = 2
    and the copies are 8 bytes; K=32 D=2^22) with prev, and with the
    centers at K=20 and K=7, and on the wide path at K=33 and K=100 (d =
    50,890 and 44,426, with and without prev and the centers); kernel 5 at
    its timed shapes (N=20 K=8 d padded to 44,448; N=64 K=16 d=2^20 with
    per-edge prev, and without prev with the centers), unpadded at
    d=44,426 and on the wide path at N=8 K=48 d=50,890, each with a NaN
    row (node 3) and tied rows."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats.ref import robust_stats_kernel_order

    def hold(label, got, emu, blocks) -> int:
        n = 0
        for name in ("med", "trim") + STAT_FIELDS:
            g, e = getattr(got, name), getattr(emu, name)
            if (g is None) != (e is None):
                raise AssertionError(f"kernel order {label}: {name} present in only one")
            if g is None:
                continue
            if not same_bits(torch, g, e):
                raise AssertionError(
                    f"kernel order {label} ({blocks} CTAs per node): {name} differs from "
                    f"the emulation at {int((g != e).sum())} of {g.numel()}")
            n += g.numel()
        return n

    n_vals, n_cases = 0, 0
    for K, D, with_prev, centers, seed in ((CFL_K, CFL_D, True, False, 71),
                                           (CFL_K, CFL_D, True, True, 72),
                                           (BIG_K, BIG_D, True, False, 73),
                                           (7, 20011, False, True, 74),
                                           (33, 50890, True, True, 79),
                                           (33, 44426, False, False, 80),
                                           (100, 50890, True, False, 81),
                                           (100, 44426, True, True, 82)):
        u, prev, _ = cfl_candidates(torch, K, D, seed)
        p = prev if with_prev else None
        blocks = rk.stats_plan(1, K, D, with_prev, centers, "cuda")["blocks"]
        got = rk.robust_stats_cuda(u, p, 0.1, centers)
        emu = robust_stats_kernel_order(u, p, 0.1, centers, blocks=blocks)
        torch.cuda.synchronize()
        n_vals += hold(f"kernel 4 K={K} D={D} prev={with_prev} centers={centers}", got,
                       emu, blocks)
        n_cases += 1
        del u, prev, p, got, emu
    for N, K, d, with_prev, centers, seed in ((20, 8, 44448, True, False, 75),
                                              (20, 8, 44426, True, True, 76),
                                              (64, 16, 1 << 20, True, False, 77),
                                              (64, 16, 1 << 20, False, True, 78),
                                              (*MANY_BATCH, True, True, 83)):
        u, prev, _ = gathered_candidates(torch, N, K, d, seed, nan_node=3)
        p = prev if with_prev else None
        blocks = rk.stats_plan(N, K, d, with_prev, centers, "cuda")["blocks"]
        got = rk.robust_stats_batch_cuda(u, p, 0.1, centers)
        emu = robust_stats_kernel_order(u, p, 0.1, centers, blocks=blocks)
        torch.cuda.synchronize()
        n_vals += hold(f"kernel 5 N={N} K={K} d={d} prev={with_prev} centers={centers}",
                       got, emu, blocks)
        n_cases += 1
        del u, prev, p, got, emu
        torch.cuda.empty_cache()
    print(f"  kernels 4 and 5 == ref.robust_stats_kernel_order bit for bit ({n_vals} "
          f"centers and statistics in {n_cases} launches, NaN in the same places)")

# ---------------------------------------------------------------------------
# phase 2: more than 32 candidates (kernels 4 and 5's wide path, kernel 6's
# output tiles)
# ---------------------------------------------------------------------------

MANY_K = (33, 64, 100, 1024)        # kernel 4 on the wide path
MANY_D = (50890, 44426)             # the Table I MLP; LeNet-5, D % 4 = 2
MANY_GRAM = ((33, 50890), (100, 50890), (1024, 50890), (33, 37), (100, 37))
MANY_TIMED = ((100, 50890), (1024, 50890), (64, 1 << 22))
MANY_BATCH = (8, 48, 50890)         # kernel 5: N, K, d with per-edge prev


def many_candidates(torch, K, D, seed):
    """A server's K > 32 received models on the card, spread so that the
    filters' scores sit apart by more than float32 sums in another order
    can move them: row k near a common model at a noise scale of 0.05 (1 +
    k / 8), two bit-identical attacker rows (0 and ``dup``) sending -3 x
    the model, and each row's previous model (the attackers' identical)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn((D,), generator=g, device="cuda")
    scale = 0.05 * (1 + torch.arange(K, device="cuda", dtype=torch.float32) / 8)
    u = torch.randn((K, D), generator=g, device="cuda").mul_(scale[:, None]).add_(base)
    prev = u + 0.05 * torch.randn((K, D), generator=g, device="cuda")
    dup = max(1, K // 5)
    u[0] = u[dup] = -3.0 * base
    prev[dup] = prev[0]
    return u, prev, dup


def compare_nan_row(torch, K, D, seed) -> float:
    """Kernel 4 with a NaN in row 1, column 7: the median and trimmed mean
    NaN in that column alone and the plain version's elsewhere (the median
    bit-equal), every distance to the median NaN as in the plain version,
    the other sums within the statistics' tolerance, NaN in the same
    places."""
    from repro_torch.kernels.robust_stats import ops

    u, prev, _ = many_candidates(torch, K, D, seed)
    u[1, 7] = float("nan")
    got = ops.robust_stats(u, prev)
    want = ops.robust_stats_plain(u, prev)
    torch.cuda.synchronize()
    label = f"robust_stats K={K} D={D} with a NaN row"
    if not same_bits(torch, got.med, want.med) or int(torch.isnan(got.med).sum()) != 1:
        raise AssertionError(f"{label}: median differs from the plain version")
    torch.testing.assert_close(got.trim, want.trim, rtol=1e-5, atol=1e-6, equal_nan=True)
    errs = []
    for name in STAT_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, rtol=STAT_RTOL, atol=STAT_ATOL, equal_nan=True)
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{label}: {name} NaN in other places than the plain")
        fin = torch.isfinite(w)
        if fin.any():
            errs.append(float((g - w)[fin].abs().max()))
    if not torch.isnan(got.dist2).all():
        raise AssertionError(f"{label}: the NaN row left a finite distance")
    print(f"  {label}: median bit-equal (column 7 NaN alone), NaN in the same places, "
          f"max|err| {max(errs):.3g}")
    return max(errs)


def check_many_candidates(torch) -> tuple:
    """Kernels 4, 5 and 6 at K > 32 against their plain versions, then
    timed.  Kernel 4 at every K of ``MANY_K`` and d of ``MANY_D``, with and
    without prev and the centers (at D % 4 = 2 the two extremes), and with
    a NaN row; kernel 5 at N=8, K=48 with per-edge prev (a NaN row and tied
    rows, with and without the centers); kernel 6 at ``MANY_GRAM``; each
    held by the bounds of the K <= 32 checks (the median bit-equal, the
    trimmed mean rtol 1e-5, the statistics rtol 1e-4 / atol 1e-3, the Gram
    rtol 1e-4 and exactly symmetric, WFAgg-D/C, Multi-Krum and Clustering
    masks bit-equal, twin rows tied).  Kernels 4 and 6 (and 7 beside them)
    then timed at ``MANY_TIMED`` and kernel 5 at its shape.  Returns (max
    errors by kernel, times by kernel and shape)."""
    errs = {"robust_stats": [], "robust_stats_batch": [], "pairwise_gram": []}
    for K in MANY_K:
        for D in MANY_D:
            combos = (((True, True), (True, False), (False, True), (False, False))
                      if D == MANY_D[0] else ((True, True), (False, False)))
            errs["robust_stats"] += [compare_robust_stats(
                torch, K, D, 90 + K, with_prev, centers, candidates=many_candidates)
                for with_prev, centers in combos]
        errs["robust_stats"].append(compare_nan_row(torch, K, MANY_D[0], 91 + K))
    Nb, Kb, db = MANY_BATCH
    for centers in (False, True):
        u, prev, tie = gathered_candidates(torch, Nb, Kb, db, 92 + centers, nan_node=3)
        errs["robust_stats_batch"].append(compare_robust_stats_batch(
            torch, f"robust_stats_batch N={Nb} K={Kb} d={db} prev=True centers={centers}",
            u, prev, tie, 3, centers))
    for K, D in MANY_GRAM:
        errs["pairwise_gram"].append(compare_gram(torch, K, D, 93 + K,
                                                  candidates=many_candidates))
    timed = {"robust_stats": {}, "pairwise_gram": {}, "weighted_agg": {}}
    for K, D in MANY_TIMED:
        for name, t in time_cfl_kernels(torch, K, D, seed=94 + K).items():
            timed[name][f"K={K} D={D}"] = t
        torch.cuda.empty_cache()
    u, prev, _ = gathered_candidates(torch, Nb, Kb, db, 95)
    timed["robust_stats_batch"] = {
        f"N={Nb} K={Kb} d={db} per-edge prev": time_robust_stats_batch(torch, u, prev, False)}
    return errs, timed


# ---------------------------------------------------------------------------
# phase 2: more than 32 neighbours (kernels 1 and 2's wide route, kernel 3
# at any K)
# ---------------------------------------------------------------------------

# (N, K, d, slate) of the K > 32 checks: N = 100 up to K = 100 (101 for an
# irregular slate of 100, whose rows are other nodes')
MANY_NB = ((100, 33, 44426, "irregular"), (100, 48, 50890, "ring"),
           (101, 100, 50890, "irregular"), (100, 100, 44426, "ring"))
MANY_NB_WIDE = (8, 1024, 50890, 1100)     # N, K, d, model rows
MANY_NB_CHAOS = (100, 48, 50890)          # the prev_idx and per-edge checks
MANY_NB_TIMED = ((100, 48, 50890, 100), (8, 1024, 50890, 1100), (1, 64, 1 << 22, 64))
MANY_NB_ORDER = ((40, 33, 44426), (101, 100, 20011))   # check_kernel_order's slates
STACK_MANY = (64, 1 << 22, 3)   # the stacked fused route: K candidates, D, rounds


def ring_idx(N, K):
    return [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]


def wide_slate(N, K, M, seed, full=False):
    """Padded (idx, valid) of N nodes over M >= K model rows: degrees in [K
    / 2, K] (``full``: K), node 1's slate empty unless ``full``, padded slots
    the node's own row, and every non-empty slate reading rows 0 and 4
    first and no row twice."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = np.repeat(np.arange(N, dtype=np.int32)[:, None], K, axis=1)
    valid = np.zeros((N, K), bool)
    for n in range(N):
        v = K if full else 0 if n == 1 else int(rng.integers(K // 2, K + 1))
        if v:
            idx[n, :v] = np.concatenate([[0, 4], rng.choice(
                np.setdiff1d(np.arange(M), [0, 4]), size=v - 2, replace=False)])
        valid[n, :v] = True
    return idx, valid


def check_many_neighbours(torch) -> dict:
    """Kernels 1, 2 and 3 above 32 neighbours against their plain versions,
    by the rules of the K <= 32 checks (masks bit-equal save near-ties by
    ``NEAR_TIE``, reported; statistics within rtol 1e-4 / atol 1e-3; ``out``
    within 3e-5; kernel 3 bit for bit; tied rows tied): on each slate of
    ``MANY_NB`` (regular and irregular, degree-0 rows, the tied rows 0 and
    4), the WFAgg round with matrix prev and bands, the Alt-WFAgg round
    (Multi-Krum, Clustering), kernel 2 with and without prev and the Gram,
    kernel 3; the ``prev_idx`` variants on a chaos stack and the per-edge
    variants at ``MANY_NB_CHAOS``; then N = 8 nodes of K = 1,024 over 1,100
    model rows (kernel 3's direct route), and K = 1,025 refused on the card.
    Returns the max errors by kernel name."""
    errs = {n: [] for n in ("wfagg_round_indexed", "robust_stats_indexed",
                            "weighted_agg_indexed", "wfagg_round_indexed[prev_idx]",
                            "robust_stats_indexed[prev_idx]",
                            "wfagg_round_indexed[per_edge_prev]",
                            "robust_stats_indexed[per_edge_prev]")}
    slates = []
    for i, (N, K, d, kind) in enumerate(MANY_NB):
        if kind == "ring":
            slates.append((f"ring N={N} K={K} d={d}", N, K, d, ring_idx(N, K), None,
                           300 + i, None))
        else:
            idx, valid = irregular_slate(N, K, 300 + i)
            slates.append((f"irregular N={N} K={K} d={d} (degree 0)", N, K, d, idx, valid,
                           300 + i, None))
    N, K, d, M = MANY_NB_WIDE
    idx, valid = wide_slate(N, K, M, 320)
    slates.append((f"N={N} K={K} d={d} over {M} rows (degree 0)", N, K, d, idx, valid, 320,
                   M))
    for label, N, K, d, idx, valid, seed, M in slates:
        errs["wfagg_round_indexed"].append(compare_kernel(
            torch, f"K>32 round {label}", N, K, d, idx, valid, seed, dup=(0, 4), M=M))
        errs["wfagg_round_indexed"].append(compare_gram_round(
            torch, f"K>32 Gram round {label}", N, K, d, idx, valid, seed, (0, 4), M=M))
        errs["robust_stats_indexed"] += [compare_indexed_stats(
            torch, f"K>32 robust_stats_indexed {label}", N, K, d, idx, valid, seed, (0, 4),
            with_prev, need_gram, M=M) for with_prev, need_gram in ((False, False),
                                                                    (True, True))]
        models = local = None
        if M is not None:
            g = torch.Generator(device="cuda").manual_seed(seed + 1)
            models = torch.randn((M, d), generator=g, device="cuda").add_(0.3)
            local = torch.randn((N, d), generator=g, device="cuda")
        errs["weighted_agg_indexed"].append(compare_weighted_agg_indexed(
            torch, f"K>32 weighted_agg_indexed {label}", N, K, d, idx, valid, seed,
            models=models, local=local))
        torch.cuda.empty_cache()
    N, K, d = MANY_NB_CHAOS
    idx, valid = irregular_slate(N, K, 310)
    flat, tout = chaos_stack(torch, N, K, d, idx, valid, 310)
    for name, e in compare_prev_idx(torch, f"K>32 irregular N={N} K={K} d={d} chaos round",
                                    flat, tout, 310).items():
        errs[name] += e
    del flat, tout
    for name, e in compare_per_edge(torch, f"K>32 per-edge prev irregular N={N} K={K} "
                                           f"d={d}", N, K, d, idx, valid, 311, (0, 4)).items():
        errs[name] += e
    torch.cuda.empty_cache()
    check_refusals_1025(torch)
    return errs


def many_order_slates() -> list:
    """``check_kernel_order``'s slates on the wide route (``MANY_NB_ORDER``):
    irregular, with a degree-0 row."""
    out = []
    for i, (N, K, d) in enumerate(MANY_NB_ORDER):
        idx, valid = irregular_slate(N, K, 340 + i)
        out.append((f"irregular N={N} K={K} d={d} (degree 0)", N, K, d, idx, valid, 340 + i))
    return out


def check_refusals_1025(torch) -> None:
    """Kernels 1, 2 and 3 refuse 1,025 neighbours on the card, through the
    wrappers the main path calls, naming where the limit is lifted next."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.weighted_agg import ops as wops

    m = torch.zeros((4, 8), device="cuda")
    idx = torch.zeros((1, 1025), dtype=torch.int32, device="cuda")
    v = torch.ones((1, 1025), dtype=torch.bool, device="cuda")
    for name, call in (
            ("robust_stats_indexed", lambda: ops.robust_stats_indexed(m, idx, v)),
            ("wfagg_round_indexed", lambda: ops.wfagg_round_indexed(m[:1], m, idx, v,
                                                                    WFAggConfig())),
            ("weighted_agg_indexed", lambda: wops.weighted_agg_indexed(
                m[:1], m, idx, v.to(torch.float32)))):
        try:
            call()
        except ValueError as e:
            if "ROADMAP queue 2, item E" not in str(e):
                raise AssertionError(f"{name} at K = 1,025: {e}") from e
        else:
            raise AssertionError(f"{name} took K = 1,025 on the card")
    print("  kernels 1, 2 and 3 refuse K = 1,025 on the card, naming ROADMAP queue 2, item E")


def check_stacked_many(torch) -> tuple:
    """Kernel 1 at N = 1 on its wide route: ``robust_allreduce_stacked(
    backend="fused")`` over ``STACK_MANY`` (K = 64 candidates of D = 2^22, four
    of them attackers sending -3 times the common model) against the
    ``reference`` backend over three rounds with WFAgg-T state, WFAgg and
    Alt-WFAgg, by ``hold_stacked_route`` (masks bit-equal or near-ties,
    weights within 3e-5, outputs within rtol 1e-4 / atol 3e-5); exactly one
    kernel-1 launch a fused call.  Returns (largest output difference,
    launches)."""
    from repro_torch.distributed import robust_allreduce as ra

    K, D, R = STACK_MANY
    g = torch.Generator(device="cuda").manual_seed(9300)
    base = torch.randn((D,), generator=g, device="cuda")
    scale = 0.05 * (1 + torch.arange(K, device="cuda", dtype=torch.float32) / 8)
    noise = torch.randn((K, D), generator=g, device="cuda").mul_(scale[:, None])
    masks = lambda info: {m: info[m] for m in MASKS if m in info}  # noqa: E731
    errs, launches = [], 0
    for method in ("wfagg", "alt_wfagg"):
        cf, cr = stack_cfg(method, "fused"), stack_cfg(method, "reference")
        sf = ra.init_tree_agg_state(cf, K, {"w": base})
        sr = ra.init_tree_agg_state(cr, K, {"w": base})
        for r in range(R):
            cands = {"w": noise.mul(1.0 + 0.1 * r).add_(base)}
            cands["w"][[3, 11, 19, 27]] = -3.0 * base
            zero_counts()
            of, sf_next, i_f = ra.robust_allreduce_stacked(cands, cf, sf)
            torch.cuda.synchronize()
            counts = read_counts()
            if counts != dict(dict.fromkeys(KERNELS, 0), wfagg_round_indexed=1):
                raise AssertionError(f"stacked fused K={K} {method}: launches {counts}")
            launches += 1
            o_r, sr_next, i_r = ra.robust_allreduce_stacked(cands, cr, sr)
            label = f"stacked fused K={K} D=2^22 {method} round {r + 1}"
            rep, err = hold_stacked_route(torch, label, cr, cands, sr,
                                          (of, i_f["weights"], masks(i_f)),
                                          (o_r, i_r["weights"], masks(i_r)))
            if err is not None:
                errs.append(err)
            sf, sr = sf_next, sr_next
            del cands, of, o_r
        print(f"  {method}: {R} rounds of kernel 1 at N=1, K={K}, D=2^22 == the reference "
              f"backend (largest output difference {max(errs):.3g})")
    torch.cuda.empty_cache()
    return max(errs), launches


def time_many_neighbours(torch) -> dict:
    """Kernels 1, 2 and 3 on their K > 32 routes through their ``*_cuda``
    wrappers at ``MANY_NB_TIMED`` (a ring of 100 nodes at K = 48, 8 nodes of
    K = 1,024 over 1,100 rows, the stacked route's N = 1, K = 64, D = 2^22),
    beside their plain versions, bounds and, for kernel 3, the library calls
    (the gather, then ``torch.baddbmm``).  Bounds: each distinct row the
    table reaches read once with its prev row (the round: local read and out
    written once too); 2 operations a compare-exchange of the bitonic sort of
    K' wires per node coordinate, and 16 flops per candidate coordinate (the
    statistics alone: 15); kernel 3 reads the distinct rows and local and
    writes out once, 2 N K d flops.  Returns name -> shape -> times."""
    import numpy as np

    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref, wide_tile
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    out = {n: {} for n in ("wfagg_round_indexed", "robust_stats_indexed",
                           "weighted_agg_indexed")}
    for N, K, d, M in MANY_NB_TIMED:
        if N == 1:
            idx = np.arange(K, dtype=np.int32)[None]
        elif M == N:
            idx = ring_idx(N, K)
        else:
            idx = wide_slate(N, K, M, 330, full=True)[0]
        models, prev, idx_t, _, tb, cfg = round_inputs(torch, N, K, d, idx, None, 330 + K,
                                                       M=M)
        local = models[:N].clone()
        v = torch.ones((N, K), dtype=torch.bool, device="cuda")
        i32 = idx_t.to(torch.int32)
        rows = int(torch.unique(idx_t).numel())
        cex = network_compare_exchanges(K)
        fallback = N == 1          # the stacked route's convention
        shape = f"N={N} K={K} d={d}" + (f" M={M}" if M != N else "")
        b = bound(4.0 * d * (2 * rows + 2 * N), N * d * (2.0 * cex + 16.0 * K))
        out["wfagg_round_indexed"][shape] = dict(
            ms=time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
                local, models, i32, v, prev, tb, cfg, cfg.alpha, fallback), 2, 10),
            plain_ms=time_cuda(torch, lambda: rops.wfagg_round_indexed_plain(
                local, models, idx_t, v, cfg, prev, tb, mean_fallback=fallback), 1, 3),
            bound_ms=b[0], bound_by=b[1], library_ms=None)
        b = bound(4.0 * d * 2 * rows, N * d * (2.0 * cex + 15.0 * K))
        out["robust_stats_indexed"][shape] = dict(
            ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
                models, i32, v, prev, False), 2, 10),
            plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
                models, idx_t, v, prev), 1, 3),
            bound_ms=b[0], bound_by=b[1], library_ms=None)
        w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8).expand(N, K)
        wvec, lcoef = combine_coefficients(w.contiguous(), 0.8)
        lc = float(lcoef[0])
        b = bound(4.0 * d * (rows + 2 * N), 2.0 * N * K * d)
        out["weighted_agg_indexed"][shape] = dict(
            ms=time_cuda(torch, lambda: wk.weighted_agg_indexed_cuda(
                wvec, lcoef, local, models, i32), 2, 10),
            plain_ms=time_cuda(torch, lambda: wops.weighted_agg_indexed_plain(
                wvec, lcoef, local, models, idx_t), 1, 3),
            bound_ms=b[0], bound_by=b[1],
            library_ms=time_cuda(torch, lambda: torch.baddbmm(
                local[:, None], wvec[:, None], models[idx_t.long()], beta=lc), 2, 10))
        plan = wk.combine_plan(M, N, K, d, "cuda")
        for name in out:
            t = out[name][shape]
            lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            print(f"  {name} {shape}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}), library {lib}")
        print(f"    kernel 3's plan there: {plan['route']}, G={plan['group']}, "
              f"T={plan['tile']}, {plan['blocks']} CTAs a group; kernels 1 and 2: "
              f"{rk.cluster_size(d)} CTAs a node, tiles of {wide_tile(K)}")
        del models, prev, local
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: a CFL server over 100 clients
# ---------------------------------------------------------------------------

CFL_MANY = (100, 4, 10)        # clients (K = N at the server), ring degree, Byzantine
CFL_MANY_ROUNDS = 4
CFL_MANY_RULES = ("wfagg", "alt_wfagg", "multi_krum", "mean")


def run_cfl_many(torch) -> tuple:
    """The paper's centralised column at the field's usual round size
    (FedAvg samples 100 clients): ``run_experiment(centralized=True)``,
    MLP, ``make_topology(100, 4, 10, "ring")``, IPM-100 from the 10
    Byzantine clients, ``CFL_MANY_ROUNDS`` rounds of each of
    ``CFL_MANY_RULES``, each with the launch counts set to 0 just before and
    read just after: exactly one launch of kernel 4 and one of kernel 7 a
    round under WFAgg and Alt-WFAgg (kernel 4's wide path, K = 100), plus
    one of kernel 6 under Alt-WFAgg, none under Multi-Krum and the mean.
    Every robust run is replayed round by round against the reference
    backend (``check_cfl_against_reference``).  Prints each run's benign
    accuracy per round, round ms and steady round ms (the median of rounds
    2..R), and the final accuracies against the paper's CFL claim (> mean +
    0.2), which is reported, not enforced.  Returns (launches by kernel,
    final benign accuracy by rule)."""
    import numpy as np

    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.engine import DFLConfig, run_experiment

    N, degree, n_mal = CFL_MANY
    topo, data = make_topology(N, degree, n_mal, "ring"), SyntheticImages()
    total, accs = dict.fromkeys(KERNELS, 0), {}
    for agg in CFL_MANY_RULES:
        cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="mlp", centralized=True)
        zero_counts()
        o = run_experiment(cfg, topo, data, rounds=CFL_MANY_ROUNDS)
        counts = read_counts()
        want = dict.fromkeys(KERNELS, 0)
        if agg in ("wfagg", "alt_wfagg"):
            want["robust_stats"] = want["weighted_agg"] = CFL_MANY_ROUNDS
            want["pairwise_gram"] = CFL_MANY_ROUNDS if agg == "alt_wfagg" else 0
        if counts != want:
            raise AssertionError(f"CFL-{N} {agg}: launches {counts}, expected {want}")
        if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
            raise AssertionError(f"CFL-{N} {agg}: non-finite accuracy")
        for k in KERNELS:
            total[k] += counts[k]
        s = o["series"]
        accs[agg] = o["final"]["acc_benign_mean"]
        print(f"  CFL-{N} {agg:10s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}, steady round "
              f"{1e3 * statistics.median(s['round_seconds'][1:]):.2f} ms; launches "
              f"{dict((k, v) for k, v in counts.items() if v)}")
        if agg != "mean":
            check_cfl_against_reference(torch, cfg, topo, data, CFL_MANY_ROUNDS)
    held = {agg: accs[agg] > accs["mean"] + 0.2 for agg in ("wfagg", "alt_wfagg")}
    print(f"  CFL-{N} IPM-100 claim (> mean + 0.2; reported): " + ", ".join(
        f"{agg} {a:.4f}" for agg, a in accs.items()) + "; " + ", ".join(
        f"{agg} {'holds' if h else 'MISSES'}" for agg, h in held.items()))
    return total, accs


# ---------------------------------------------------------------------------
# phase 3: a DFL run over 100 nodes at a degree above 32
# ---------------------------------------------------------------------------

DFL_MANY = (100, 10, 4)        # nodes, Byzantine, rounds
# (kind, degree, seed): a 48-regular ring; an Erdős–Rényi graph of mean
# degree 40, padded to its largest degree
DFL_MANY_GRAPHS = (("ring", 48, 0), ("erdos_renyi", 40, 7))
DFL_MANY_RUNS = (("wfagg", "fused"), ("alt_wfagg", "fused"), ("wfagg", "fused_two_launch"),
                 ("mean", "fused"))


def run_dfl_many(torch) -> tuple:
    """The paper's decentralised experiment over 100 nodes at a degree
    above 32: ``run_experiment``, MLP, IPM-100 from 10 Byzantine nodes,
    ``DFL_MANY`` rounds on each graph of ``DFL_MANY_GRAPHS`` of each run of
    ``DFL_MANY_RUNS``, the launch counts set to 0 just before and read just
    after each run: exactly one launch of kernel 1 a round on ``fused`` and
    one each of kernels 2 and 3 on ``fused_two_launch`` (their wide routes),
    none under the mean.  Every robust run is replayed round by round
    against the reference backend (``check_against_reference``; WFAgg-T is
    not active before round 5, the paper's transient).  Prints the padded
    degree, each run's benign accuracy per round, round ms and steady round
    ms (the median of rounds 2..R), and the final accuracies against the
    paper's claim (> mean + 0.2), reported, not enforced.  Returns
    (launches by kernel, final benign accuracy by graph and run)."""
    import numpy as np

    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.engine import DFLConfig, run_experiment

    N, n_mal, R = DFL_MANY
    data = SyntheticImages()
    total, accs = dict.fromkeys(KERNELS, 0), {}
    for kind, degree, seed in DFL_MANY_GRAPHS:
        topo = (make_topology(N, degree, n_mal, kind) if kind == "ring"
                else make_topology(N, degree, n_mal, kind, seed=seed))
        K = topo.neighbor_indices.shape[1]
        deg = topo.neighbor_valid.sum(1)
        print(f"  DFL-{N} {kind}: padded degree K = {K}, degrees {int(deg.min())}.."
              f"{int(deg.max())}, regular {topo.is_regular}")
        if K <= 32:
            raise AssertionError(f"DFL-{N} {kind}: padded degree {K} is not above 32")
        for agg, backend in DFL_MANY_RUNS:
            cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="mlp",
                            wfagg_backend=backend)
            zero_counts()
            o = run_experiment(cfg, topo, data, rounds=R)
            counts = read_counts()
            want = dict.fromkeys(KERNELS, 0)
            if agg != "mean" and backend == "fused":
                want["wfagg_round_indexed"] = R
            elif agg != "mean":
                want["robust_stats_indexed"] = want["weighted_agg_indexed"] = R
            if counts != want:
                raise AssertionError(f"DFL-{N} {kind} {agg} on {backend}: launches "
                                     f"{counts}, expected {want}")
            if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
                raise AssertionError(f"DFL-{N} {kind} {agg} on {backend}: non-finite "
                                     "accuracy")
            for k in KERNELS:
                total[k] += counts[k]
            s = o["series"]
            accs[(kind, agg, backend)] = o["final"]["acc_benign_mean"]
            print(f"  DFL-{N} {kind} {agg:9s} {backend:16s} benign acc per round "
                  f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
                  f"{[round(1e3 * t, 2) for t in s['round_seconds']]}, steady round "
                  f"{1e3 * statistics.median(s['round_seconds'][1:]):.2f} ms; launches "
                  f"{dict((k, v) for k, v in counts.items() if v)}")
            if agg != "mean":
                check_against_reference(torch, cfg, topo, data, R)
        mean = accs[(kind, "mean", "fused")]
        print(f"  DFL-{N} {kind} IPM-100 claim (> mean {mean:.4f} + 0.2; reported): " +
              ", ".join(f"{agg} on {be} {accs[(kind, agg, be)]:.4f} "
                        f"{'holds' if accs[(kind, agg, be)] > mean + 0.2 else 'MISSES'}"
                        for agg, be in DFL_MANY_RUNS if agg != "mean"))
    return total, accs


def compare_per_edge(torch, label, N, K, d, idx, valid, seed, dup) -> dict:
    """Kernels 1 and 2 with a per-edge (N, K, d) ``prev``: with ``prev[idx]``
    of a matrix, bit-identical to the launch that reads that matrix through
    the neighbour table; with a per-edge prev no matrix gives, against
    their plain versions (masks bit-equal, ``out`` within 3e-5, statistics
    within rtol 1e-4, the Gram within 1e-4 of its scale), for WFAgg and
    Alt-WFAgg and with and without the Gram.  Returns the max errors."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    models, prev, idx_t, valid_t, tb, _ = round_inputs(torch, N, K, d, idx, valid,
                                                       seed, dup)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    edge = prev[idx_t.long()]
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    own = edge + 0.01 * torch.randn(edge.shape, generator=g, device="cuda")
    # bands around the own prev's metrics (the matrix-prev pair reads ``tb``)
    otb = jittered_bands(torch, robust_stats_indexed_ref(models, idx_t, valid_t, own), g,
                         WFAggConfig(transient=3))
    errs = {"wfagg_round_indexed[per_edge_prev]": [],
            "robust_stats_indexed[per_edge_prev]": []}
    for cfg in (WFAggConfig(transient=3), alt_config(K)):
        name = f"{label} {cfg.distance_filter}"
        same = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg, prev=edge,
                                       tbands=tb)
        old = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg, prev=prev,
                                      tbands=tb)
        got = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg, prev=own,
                                      tbands=otb)
        want = ops.wfagg_round_indexed_plain(models, models, idx_t, v, cfg, own, otb)
        torch.cuda.synchronize()
        if not same_outputs(torch, same, old):
            raise AssertionError(f"{name}: per-edge prev = prev[idx] is not bit-identical "
                                 "to the matrix-prev launch")
        err, _ = hold_round(torch, name, got, want, v, otb, cfg, models, models, idx_t)
        assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
        if got[5].gram is not None:
            check_gram(torch, name, got[5].gram, want[5].gram, d)
        errs["wfagg_round_indexed[per_edge_prev]"].append(err)
    for need_gram in (False, True):
        same = ops.robust_stats_indexed(models, idx_t, valid_t, edge, need_gram=need_gram)
        old = ops.robust_stats_indexed(models, idx_t, valid_t, prev, need_gram=need_gram)
        got = ops.robust_stats_indexed(models, idx_t, valid_t, own, need_gram=need_gram)
        want = robust_stats_indexed_ref(models, idx_t, v, own, need_gram=need_gram)
        torch.cuda.synchronize()
        if not same_outputs(torch, tuple(same), tuple(old)):
            raise AssertionError(f"{label} robust_stats_indexed gram={need_gram}: "
                                 "per-edge prev = prev[idx] is not bit-identical to the "
                                 "matrix-prev launch")
        e = [assert_stats_close(torch, got, want, STAT_FIELDS)]
        if need_gram:
            check_gram(torch, f"{label} robust_stats_indexed", got.gram, want.gram, d)
        for cfg in (WFAggConfig(transient=3),) + ((alt_config(K),) if need_gram else ()):
            mk = lambda st: trust.derive_trust_weights(st, v, otb, cfg)[:3]  # noqa: E731
            hold_masks(torch, f"{label} robust_stats_indexed ({cfg.distance_filter})",
                       mk(got), mk(want), want, v, otb, cfg)
        errs["robust_stats_indexed[per_edge_prev]"].append(max(e))
    print(f"  {label}: per-edge prev = prev[idx] bit-identical to the matrix-prev launch "
          f"(round kernel, WFAgg and Alt-WFAgg; statistics, with and without the Gram); "
          f"an own per-edge prev: masks bit-equal to the plain versions, out max|err| "
          f"{max(errs['wfagg_round_indexed[per_edge_prev]']):.3g}, statistics max|err| "
          f"{max(errs['robust_stats_indexed[per_edge_prev]']):.3g}")
    return errs


def time_per_edge_kernels(torch, N, K, d, seed) -> dict:
    """Kernels 1 and 2 with a per-edge prev through their ``*_cuda``
    wrappers on a ring slate, beside the matrix-prev launch, their plain
    versions and bounds: the model rows the table reaches and the per-edge
    prev read once (and, for the round, ``local`` once and ``out``)."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tb, _ = round_inputs(torch, N, K, d, idx, None, seed)
    cfg = WFAggConfig(transient=3)
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    edge = prev[idx_t.long()]
    rows = int(torch.unique(idx_t).numel())
    out = {}
    base = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
        models, models, i32, v, prev, tb, cfg, cfg.alpha, False), 3, 25)
    b = bound(4.0 * d * (rows + N * K + 2 * N), 16.0 * N * K * d)
    out["wfagg_round_indexed[per_edge_prev]"] = dict(
        ms=time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            models, models, i32, v, edge, tb, cfg, cfg.alpha, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.wfagg_round_indexed_plain(
            models, models, idx_t, v, cfg, edge, tb), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    base2 = time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
        models, i32, v, prev, False), 3, 25)
    b = bound(4.0 * d * (rows + N * K), 16.0 * N * K * d)
    out["robust_stats_indexed[per_edge_prev]"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            models, i32, v, edge, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            models, idx_t, v, edge), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    print(f"  per-edge prev N={N} K={K} d={d} ({4 * N * K * d / 2**30:.1f} GiB): with "
          f"the matrix prev read through the table the round kernel takes {base:.4f} ms "
          f"and the statistics kernel {base2:.4f} ms")
    for name, t in out.items():
        print(f"  {name} N={N} K={K} d={d}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}); "
              "no single PyTorch call computes this function")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

def check_against_reference(torch, cfg, topo, data, rounds, against="reference"):
    """Replay a DFL run round by round: from each of its states, one round
    on the run's backend and one on the ``against`` backend (deterministic
    cuDNN, so local training is identical) must give bit-equal verdicts and
    models within 3e-5.  A round whose verdicts differ only where a float32
    value sits within 1e-4 (relative) of a WFAgg-T band edge or of the
    distance filter's or WFAgg-C's keep boundary is reported with the filter and the
    margin, and the replay goes on from the run's state; any other
    difference fails.  A run past the paper's transient (WFAgg-T decides
    from round ``transient`` + 2 on) must have seen the band test accept an
    edge."""
    import dataclasses

    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    ref_cfg = dataclasses.replace(cfg, wfagg_backend=against)
    fused = engine.build_round_fn(cfg, topo, data, telemetry=True)
    ref = engine.build_round_fn(ref_cfg, topo, data, telemetry=True)
    state = engine.init_dfl_state(cfg, topo)
    benign = torch.as_tensor(~topo.malicious, device="cuda")
    label = f"{cfg.aggregator} on {cfg.wfagg_backend}"
    vs = f"the {against} backend"
    torch.backends.cudnn.deterministic = True
    try:
        t_fired, nonfinite, edge_rounds = 0, [], []
        for r in range(rounds):
            nxt, rec = fused(state)
            alt, rec_ref = ref(state)
            flat = ravel(nxt.node_params)
            # an attacker's own model may go non-finite (the reference's
            # attack math carries it); every benign model must not
            finite = torch.isfinite(flat).all(1)
            if not finite[benign].all():
                raise AssertionError(f"{label} round {r + 1}: a benign model is not finite")
            nonfinite.append(torch.nonzero(~finite).flatten().tolist())
            if not torch.equal(rec.verdict, rec_ref.verdict):
                report = explain_dfl_round(torch, cfg, topo, data, state, rec, rec_ref)
                print(f"  {label} round {r + 1}: verdicts differ from {vs}: "
                      f"(node, slot, filter, margin) {report}")
                if not near_ties_only(report):
                    raise AssertionError(f"{label} round {r + 1}: verdicts differ from "
                                         f"{vs} away from any edge")
                edge_rounds.append((r + 1, report))
            else:
                torch.testing.assert_close(flat, ravel(alt.node_params), rtol=OUT_TOL,
                                           atol=OUT_TOL, equal_nan=True)
            t_fired += int(((rec.verdict >> 2) & 1).sum())
            state = nxt
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  {label} == {vs} on the card, {rounds} rounds: verdicts "
          f"bit-equal and models within {OUT_TOL} in {rounds - len(edge_rounds)} rounds "
          f"(rounds on an edge: {edge_rounds}); WFAgg-T accepted {t_fired} edges; "
          f"non-finite (attacker) rows per round {nonfinite}")
    if rounds > cfg.paper.transient + 1 and t_fired == 0:
        raise AssertionError(f"{label}: the WFAgg-T band test never fired")
    return edge_rounds


def explain_dfl_round(torch, cfg, topo, data, state, rec, rec_ref):
    """On differing verdicts: for each differing (node, slot, filter), the
    relative margin by which the reference's own float32 value clears the
    decision: the nearest WFAgg-T band edge, or the gap between the last
    kept and the first dropped score of the distance filter or of WFAgg-C;
    None where no margin is defined (Clustering)."""
    from repro_torch.dfl import engine

    mal = torch.as_tensor(topo.malicious, device="cuda")
    idx = torch.as_tensor(topo.neighbor_indices, device="cuda").long()
    wcfg = engine._wfagg_full_config(cfg, idx.shape[1])
    valid = torch.as_tensor(topo.neighbor_valid, device="cuda")
    return decision_margins(torch, wcfg, *aggregation_inputs(
        torch, cfg, data, state, idx, valid, mal), state.temporal, rec, rec_ref)


# A decision that differs from the reference's is a near-tie, and is
# reported, where the reference's own float32 value lies within this
# (relative) of a WFAgg-T band edge or of the distance filter's or WFAgg-C's
# keep boundary (both keep the v - f - 1 smallest scores); Clustering's
# decision has no such margin.  Phases 2 and 3 apply this one rule.
NEAR_TIE = 1e-4


def near_ties_only(report) -> bool:
    """Whether every (node, slot, filter, margin) of ``report`` is a
    near-tie (a margin of None or NaN is not)."""
    return bool(report) and all(m is not None and m <= NEAR_TIE for _, _, _, m in report)


def decision_margins(torch, wcfg, models, idx, v, prev, prev_idx, ts, rec, rec_ref):
    """For each differing (node, slot, filter) of a round that aggregated
    ``models`` through the table ``idx`` (valid ``v``), with WFAgg-T ``prev``
    read through ``prev_idx`` (None: through ``idx``) and the pre-round
    temporal state ``ts``: the relative margin of the reference's own
    float32 value to the decision (see ``explain_dfl_round``)."""
    from repro_torch.core import trust
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    st = robust_stats_indexed_ref(models, idx, v, prev, need_gram=True,
                                  prev_idx=prev_idx)
    tb = trust.temporal_bands(ts.hist_s, ts.hist_b, ts.count, ts.t, wcfg)
    flips = []
    for n, k in torch.nonzero(rec.verdict != rec_ref.verdict).tolist():
        diff = int(rec.verdict[n, k] ^ rec_ref.verdict[n, k])
        flips += [(n, k, bit) for bit in range(3) if (diff >> bit) & 1]
    return flip_margins(torch, st, v, tb, wcfg, flips)


def flip_margins(torch, st, v, tb, wcfg, flips):
    """(node, slot, filter, margin) for each (node, slot, bit) of ``flips``
    (bit 0 the distance filter, 1 the similarity filter, 2 WFAgg-T): the
    relative margin of the reference's own float32 statistics ``st`` to the
    decision under the WFAgg-T bands ``tb`` (N, 4K), valid slots ``v``;
    WFAgg-C, which keeps the v - f - 1 smallest cosine distances to the
    median as WFAgg-D keeps distances, by the same gap between the last
    kept and the first dropped value (as ``margins_of`` for the stacked
    round); None where no margin is defined (Clustering)."""
    from repro_torch.core import aggregators as agg
    from repro_torch.core import trust

    K = v.shape[1]
    rel = lambda x, e: float(((x - e).abs() / x.abs().clamp(min=1e-30)).item())  # noqa: E731
    if wcfg.distance_filter == "multi_krum":
        d2 = trust.sq_dists_from_gram(st.gram)
        vp = v[:, :, None] & v[:, None, :]
        scores = agg.krum_scores_from_sq_dists_dyn(torch.where(vp, d2, torch.inf),
                                                   wcfg.f, v.sum(-1))
        keep = torch.clamp(v.sum(-1), max=trust.multi_krum_m(wcfg, K))
    else:
        scores, keep = st.dist2, v.sum(-1) - wcfg.f - 1
    scores = torch.where(v, scores, torch.inf)
    keep_c = v.sum(-1) - wcfg.f - 1
    report = []
    for n, k, bit in flips:
        margin = None
        if bit == 2:
            s_t, b_t = st.prev_dist2[n, k], st.cosine_to_prev()[n, k]
            margin = min(rel(s_t, tb[n, k]), rel(s_t, tb[n, K + k]),
                         rel(b_t, tb[n, 2 * K + k]), rel(b_t, tb[n, 3 * K + k]))
        elif bit == 0 and 0 < int(keep[n]) < int(v[n].sum()):
            srt = torch.sort(scores[n]).values
            margin = rel(srt[int(keep[n])], srt[int(keep[n]) - 1])
        elif (bit == 1 and wcfg.similarity_filter == "wfagg_c"
              and 0 < int(keep_c[n]) < int(v[n].sum())):
            cos_d = torch.where(v[n], st.cosine_to_median()[n], torch.inf)
            srt = torch.sort(cos_d).values
            margin = rel(srt[int(keep_c[n])], srt[int(keep_c[n]) - 1])
        report.append((n, k, ("distance", "similarity", "WFAgg-T")[bit], margin))
    return report


def check_cfl_against_reference(torch, cfg, topo, data, rounds):
    """Replay a CFL run round by round: from each of its states, one fused
    and one reference round (deterministic cuDNN, so local training is
    identical) must give the same global model within 3e-5."""
    import dataclasses

    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    fused = engine.build_round_fn(cfg, topo, data)
    ref = engine.build_round_fn(dataclasses.replace(cfg, wfagg_backend="reference"),
                                topo, data)
    state = engine.init_dfl_state(cfg, topo)
    torch.backends.cudnn.deterministic = True
    try:
        errs = []
        for r in range(rounds):
            nxt, alt = fused(state), ref(state)
            flat, want = ravel(nxt.node_params)[0], ravel(alt.node_params)[0]
            if not torch.isfinite(flat).all():
                raise AssertionError(f"{cfg.aggregator} round {r + 1}: global model "
                                     "not finite")
            err = float((flat - want).abs().max())
            if not torch.allclose(flat, want, rtol=OUT_TOL, atol=OUT_TOL):
                explain_cfl_round(torch, cfg, topo, data, state)
                raise AssertionError(f"{cfg.aggregator} round {r + 1}: fused and "
                                     f"reference global models differ by {err:.3g}")
            errs.append(err)
            state = nxt
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  {cfg.aggregator}: fused == reference backend on the card, {rounds} "
          f"rounds, global model max|err| per round {[f'{e:.3g}' for e in errs]}")


def explain_cfl_round(torch, cfg, topo, data, state):
    """On a failed replay: the server's masks under both backends, from the
    same received models."""
    from repro_torch.core import wfagg as wf
    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    mal = torch.as_tensor(topo.malicious, device="cuda")
    anchor = ravel({k: v[:1] for k, v in state.node_params.items()})[0]
    params, _ = engine._local_train(cfg, data, mal, state.node_params,
                                    state.node_momentum, state.rnd)
    flat = engine._apply_attacks(cfg, mal, ravel(params), state.rnd)
    t0 = wf.TemporalState(*(x[0] for x in state.temporal))
    for backend in ("fused", "reference"):
        wcfg = engine._wfagg_full_config(cfg, flat.shape[0], backend=backend)
        _, _, info = wf.wfagg(anchor, flat, t0, wcfg)
        print(f"    {backend:9s} " + " ".join(
            f"{m}={''.join(str(int(x)) for x in info[m].tolist())}"
            for m in ("mask_d", "mask_c", "mask_t")))


# ---------------------------------------------------------------------------
# phase 3: dynamic topologies and chaos transport
# ---------------------------------------------------------------------------

def upload_schedule(torch, sched, fs=None):
    """The schedule's stacks on the card: (idx, valid, malicious[, drop, lag,
    dup, corrupt, down])."""
    import numpy as np

    xs = tuple(torch.as_tensor(np.asarray(a), device="cuda")
               for a in (sched.neighbor_idx, sched.valid, sched.malicious))
    return xs + (fs.xs("cuda") if fs is not None else ())


def aggregation_inputs(torch, cfg, data, state, idx, val, mal, ts=None, fr=None,
                       fcfg=None):
    """What a round (a chaos round with ``ts``/``fr``) hands the WFAgg
    aggregation after its sanitizer, from the engine's own steps before
    it: ``(models, table, valid, prev, prev_idx)``."""
    from repro_torch.core import wfagg as wf
    from repro_torch.dfl import engine

    if ts is None:
        _, _, flat = engine._trained(cfg, data, state, mal, neighbor_idx=idx, valid=val)
        models, v = wf.sanitize_rows(flat, idx.long(), val)
        return models, idx.long(), v, state.temporal.prev, None
    tout = engine.chaos_inputs(cfg, data, fcfg, state, idx, val, mal, ts, fr).tout
    models, v = wf.sanitize_rows(tout.full, tout.eff_idx, tout.eff_valid)
    return models, tout.eff_idx, v, models, tout.prev_idx


def check_dynamic_against_reference(torch, cfg, topo, data, sched, fs=None,
                                    on_round=None):
    """Replay a dynamic (with ``fs``, chaos) run round by round: from each
    of its states, realigned to the round's slate, one round on the run's
    backend and one on the reference backend (deterministic cuDNN) must
    give bit-equal verdicts and models within 3e-5; a differing verdict
    within 1e-4 (relative) of a band edge or keep boundary is reported
    with its margin, any other difference fails (as
    ``check_against_reference``).  ``on_round(r, state, idx, val, mal, rec,
    report)`` sees each round's pre-round state, slate, the run's record
    and the near-tie report (None where the verdicts are equal)."""
    import dataclasses

    from repro_torch.dfl import engine
    from repro_torch.dfl import faults as flt
    from repro_torch.models.lenet import ravel

    fcfg = fs.config if fs is not None else None
    fns = [engine.build_round_fn(c, topo, data, dynamic=True, telemetry=True,
                                 faults=fcfg, device="cuda")
           for c in (cfg, dataclasses.replace(cfg, wfagg_backend="reference"))]
    state = engine.init_dfl_state(cfg, topo, degree=sched.width, device="cuda")
    xs = upload_schedule(torch, sched, fs)
    ts = (flt.init_transport_state(fcfg, topo.n_nodes, sched.width,
                                   ravel(state.node_params).shape[1], device="cuda")
          if fs is not None else None)
    label = f"{cfg.aggregator} on {cfg.wfagg_backend}" + (" under chaos" if fs else "")
    prev = (xs[0][0], xs[1][0])
    torch.backends.cudnn.deterministic = True
    try:
        edge_rounds, t_fired = [], 0
        for r in range(sched.rounds):
            idx, val, mal = (x[r] for x in xs[:3])
            state, ts = engine.realign_to_slate(state, ts, *prev, idx, val)
            fr = flt.FaultRound(*(x[r] for x in xs[3:])) if fs is not None else None
            args = (state, idx, val, mal) + ((ts, fr) if fs is not None else ())
            (nxt, *rest), (alt, *rest_ref) = fns[0](*args), fns[1](*args)
            rec, rec_ref = rest[-1], rest_ref[-1]
            report = None
            flat = ravel(nxt.node_params)
            if not torch.isfinite(flat[torch.as_tensor(~sched.malicious.any(0),
                                                       device="cuda")]).all():
                raise AssertionError(f"{label} round {r + 1}: a benign model is not finite")
            if not torch.equal(rec.verdict, rec_ref.verdict):
                inputs = aggregation_inputs(torch, cfg, data, state, idx, val, mal, ts,
                                            fr, fcfg)
                wcfg = engine._wfagg_full_config(cfg, sched.width)
                report = decision_margins(torch, wcfg, *inputs, state.temporal, rec,
                                          rec_ref)
                print(f"  {label} round {r + 1}: verdicts differ from the reference "
                      f"backend: (node, slot, filter, margin) {report}")
                if not near_ties_only(report):
                    raise AssertionError(f"{label} round {r + 1}: verdicts differ from the "
                                         "reference backend away from any edge")
                edge_rounds.append((r + 1, report))
            else:
                torch.testing.assert_close(flat, ravel(alt.node_params), rtol=OUT_TOL,
                                           atol=OUT_TOL, equal_nan=True)
            t_fired += int(((rec.verdict >> 2) & 1).sum())
            if on_round is not None:
                on_round(r, state, idx, val, mal, rec, report)
            state, ts = nxt, (rest[0] if fs is not None else None)
            prev = (idx, val)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  {label} == the reference backend on the card, {sched.rounds} rounds: "
          f"verdicts bit-equal and models within {OUT_TOL} in "
          f"{sched.rounds - len(edge_rounds)} rounds (rounds on an edge: {edge_rounds}); "
          f"WFAgg-T accepted {t_fired} edges")
    return edge_rounds


def check_no_host_sync(torch, cfg, topo, data, sched, fs=None):
    """One dynamic (with ``fs``, chaos) round, re-keying included, under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation that makes
    the host wait on the card raises."""
    from repro_torch.dfl import engine
    from repro_torch.dfl import faults as flt
    from repro_torch.models.lenet import ravel

    fcfg = fs.config if fs is not None else None
    fn = engine.build_round_fn(cfg, topo, data, dynamic=True, faults=fcfg, device="cuda")
    state = engine.init_dfl_state(cfg, topo, degree=sched.width, device="cuda")
    xs = upload_schedule(torch, sched, fs)
    ts = (flt.init_transport_state(fcfg, topo.n_nodes, sched.width,
                                   ravel(state.node_params).shape[1], device="cuda")
          if fs is not None else None)
    prev = (xs[0][0], xs[1][0])
    for r in range(2):       # round 0 warms up (kernel libraries, allocator)
        torch.cuda.synchronize()
        if r == 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            idx, val, mal = (x[r] for x in xs[:3])
            state, ts = engine.realign_to_slate(state, ts, *prev, idx, val)
            if fs is None:
                state = fn(state, idx, val, mal)
            else:
                state, ts = fn(state, idx, val, mal, ts,
                               flt.FaultRound(*(x[r] for x in xs[3:])))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prev = (idx, val)
    torch.cuda.synchronize()
    print(f"  {cfg.aggregator} on {cfg.wfagg_backend}" + (" under chaos" if fs else "")
          + ": one round ran under set_sync_debug_mode('error') with no host sync")


def check_kill_and_resume(torch, cfg, topo, data, sched, fs, stop):
    """Stop a chaos run after ``stop`` rounds, checkpoint, resume, finish:
    every array of the final carry (models, momentum, the WFAgg-T ring
    buffers and prev, the transport ring and served-lag table, the slate,
    the round counter) and the schedules are ``torch.equal`` to those of
    the uninterrupted run, and so are the accuracy series."""
    import tempfile

    import numpy as np

    from repro_torch.dfl.engine import run_dynamic_experiment

    run = lambda **kw: run_dynamic_experiment(cfg, topo, data, sched, faults=fs,  # noqa: E731
                                              device="cuda", **kw)
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            full = run(checkpoint_dir=f"{tmp}/full")
            part = run(stop_after=stop, checkpoint_dir=f"{tmp}/snap")
            resumed = run(resume_from=f"{tmp}/snap", checkpoint_dir=f"{tmp}/resumed")
            with np.load(f"{tmp}/full/chaos.npz") as a, \
                    np.load(f"{tmp}/resumed/chaos.npz") as b:
                if sorted(a.files) != sorted(b.files):
                    raise AssertionError("kill-and-resume: the carries differ in structure")
                differ = [k for k in a.files
                          if not torch.equal(torch.from_numpy(a[k]), torch.from_numpy(b[k]))]
                keys = a.files
    finally:
        torch.backends.cudnn.deterministic = False
    if differ:
        raise AssertionError(f"kill-and-resume: {differ} differ from the uninterrupted run")
    series = part["series"]["acc_benign_mean"] + resumed["series"]["acc_benign_mean"]
    if series != full["series"]["acc_benign_mean"] or \
            resumed["rounds_run"] != [stop, sched.rounds]:
        raise AssertionError("kill-and-resume: the stitched series differ")
    ring = [k for k in keys if "ring" in k or "served_lag" in k or "hist" in k]
    print(f"  kill-and-resume ({cfg.aggregator}, {cfg.attack}, stop after {stop} of "
          f"{sched.rounds} rounds): all {len(keys)} arrays of the final carry and "
          f"schedules torch.equal to the uninterrupted run's (among them {ring}); "
          "stitched accuracy series equal")


def run_dynamic_paths(torch, topo, data) -> dict:
    """Phase 3's dynamic and chaos paths: each run with every launch count
    set to 0 just before and read just after, replayed against the
    reference backend; a round under the sync check; kill-and-resume;
    finite series under corruption; benign accuracy under chaos (printed
    only).  Returns the launches of the runs by kernel."""
    import numpy as np

    from repro_torch.core.topology import paper_topology
    from repro_torch.dfl.dynamics import make_faulty_schedule, make_schedule
    from repro_torch.dfl.engine import DFLConfig, run_dynamic_experiment

    total = dict.fromkeys(KERNELS, 0)
    sched = make_schedule("churn", topo, ROUNDS, seed=1)
    fsched, fs = make_faulty_schedule("churn", topo, ROUNDS, fault="chaos", intensity=0.4)
    print(f"  churn: degree min/mean/max per round "
          f"{[[round(float(x), 2) for x in row] for row in sched.degree_stats()]}; chaos "
          f"schedule {fs.summary()}")
    runs = [("wfagg", "fused", None), ("wfagg", "fused", fs), ("alt_wfagg", "fused", fs),
            ("wfagg", "fused_two_launch", fs), ("mean", "fused", fs),
            ("median", "fused", None), ("multi_krum", "fused", None),
            ("median", "fused", fs), ("multi_krum", "fused", fs)]
    for agg, backend, faults in runs:
        cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="lenet",
                        wfagg_backend=backend)
        s = fsched if faults is not None else sched
        zero_counts()
        o = run_dynamic_experiment(cfg, topo, data, s, faults=faults)
        counts = read_counts()
        want = dict.fromkeys(KERNELS, 0)
        wfagg = agg in ("wfagg", "alt_wfagg")
        if wfagg and backend == "fused":
            want["wfagg_round_indexed"] = ROUNDS
            want["wfagg_round_indexed[prev_idx]"] = ROUNDS if faults is not None else 0
        elif wfagg:
            want["robust_stats_indexed"] = want["weighted_agg_indexed"] = ROUNDS
            want["robust_stats_indexed[prev_idx]"] = ROUNDS
        label = (f"{agg} on {backend}" if wfagg else agg) + (
            " under chaos" if faults is not None else " under churn")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
            raise AssertionError(f"{label}: non-finite accuracy")
        print(f"  {label}: launches {dict((k, v) for k, v in counts.items() if v)}; "
              f"benign acc per round {[round(a, 4) for a in o['series']['acc_benign_mean']]}"
              f", round ms {[round(1e3 * t, 2) for t in o['series']['round_seconds']]}")
        for name in KERNELS:
            total[name] += counts[name]
        if wfagg:
            check_dynamic_against_reference(torch, cfg, topo, data, s, faults)
    for agg, backend, faults in runs[:2] + runs[3:4]:
        check_no_host_sync(torch, DFLConfig(aggregator=agg, attack="ipm_100",
                                            model="lenet", wfagg_backend=backend),
                           topo, data, fsched if faults is not None else sched, faults)
    check_kill_and_resume(torch, DFLConfig(aggregator="wfagg", attack="alie",
                                           model="lenet"), topo, data, fsched, fs, stop=3)

    mlp_topo = paper_topology()
    csched, cfs = make_faulty_schedule("churn", mlp_topo, 3, fault="corrupt",
                                       intensity=0.5, seed=1, fault_seed=2)
    for agg in ("wfagg", "mean", "median"):
        o = run_dynamic_experiment(DFLConfig(aggregator=agg, attack="none", model="mlp"),
                                   mlp_topo, data, csched, faults=cfs)
        s = o["series"]
        if not (np.isfinite(s["acc_benign_mean"]).all() and np.isfinite(s["r_squared"]).all()
                and np.isfinite(o["final"]["acc_benign_mean"])):
            raise AssertionError(f"{agg} under corrupt@0.5: a series is not finite")
        print(f"  {agg} under corrupt@0.5 (MLP, 3 rounds, corrupt rate "
              f"{o['faults']['corrupt_rate']:.3f}): every series finite, benign acc "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}")
    asched, afs = make_faulty_schedule("churn", mlp_topo, ROUNDS, fault="chaos",
                                       intensity=0.4)
    for agg in ("wfagg", "mean"):
        o = run_dynamic_experiment(DFLConfig(aggregator=agg, attack="ipm_100", model="mlp"),
                                   mlp_topo, data, asched, faults=afs)
        print(f"  {agg} under churn + chaos@0.4, IPM-100 (MLP, {ROUNDS} rounds; printed "
              f"only, the reference states no claim): benign acc per round "
              f"{[round(a, 4) for a in o['series']['acc_benign_mean']]}")
    return total


# ---------------------------------------------------------------------------
# phase 3: the adaptive adversaries and the audit plane
# ---------------------------------------------------------------------------

# the reference's gated robustness grid (benchmarks/robustness_matrix.py:60-64;
# the committed cells are benchmarks/BENCH_robustness.json, read as JSON)
GATE_GRID = dict(
    attacks=("none", "ipm_100", "band_rider", "min_max"),
    scenarios=("static", "eclipse"),
    aggregators=("mean", "multi_krum", "wfagg"),
    rounds=6, nodes=20, degree=8, malicious=2, topology="ring",
    placement="close", backend="fused", model="mlp", seed=0, n_test=256,
)
# scripts/robustness_gate.py:68-69 (per cell, reported) and :73, :76 (the
# two structural claims, enforced on the port's own numbers)
TOL_ACC, TOL_R2 = 0.06, 0.15
DEGRADE_MIN, WFAGG_STATIC_TOL = 0.08, 0.06
GATE_BASELINES = ("mean", "median", "trimmed_mean", "krum", "multi_krum", "clustering")


def run_gate_grid(torch, topo, data, scheds) -> tuple:
    """The 24 cells of ``GATE_GRID`` through ``run_dynamic_experiment`` on
    the card, each with every launch count set to 0 just before and read
    just after (a wfagg cell: one round-kernel launch per round; mean and
    Multi-Krum: none), the wfagg cells with telemetry (their filter
    attribution).  Prints each cell beside the committed one with the
    gate's one-sided comparator (reported: the committed cells come from
    the JAX package's data).  Returns (cells, launches, wall seconds)."""
    import numpy as np

    from repro_torch.dfl.engine import DFLConfig, run_dynamic_experiment
    from repro_torch.obs import report

    g = GATE_GRID
    committed = json.loads((ROOT / "benchmarks" / "BENCH_robustness.json").read_text())
    cells, launches = {}, dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    for scenario in g["scenarios"]:
        for agg in g["aggregators"]:
            for attack in g["attacks"]:
                cfg = DFLConfig(aggregator=agg, attack=attack, model=g["model"],
                                seed=g["seed"], wfagg_backend=g["backend"])
                zero_counts()
                out = run_dynamic_experiment(cfg, topo, data, scheds[scenario],
                                             n_test=g["n_test"], telemetry=agg == "wfagg")
                counts = read_counts()
                want = dict.fromkeys(KERNELS, 0)
                if agg == "wfagg":
                    want["wfagg_round_indexed"] = g["rounds"]
                key = f"{attack}|{scenario}|{agg}"
                if counts != want:
                    raise AssertionError(f"gate cell {key}: launches {counts}, expected "
                                         f"{want}")
                for name in KERNELS:
                    launches[name] += counts[name]
                acc = out["series"]["acc_benign_mean"]
                cells[key] = dict(final_acc=out["final"]["acc_benign_mean"],
                                  final_r2=out["final"]["r_squared"], min_acc=min(acc))
                if not all(np.isfinite(v) for v in cells[key].values()):
                    raise AssertionError(f"gate cell {key}: a non-finite result")
                if agg == "wfagg":
                    cells[key]["carried_by"] = report.attribution(
                        report.telemetry_rates(out["telemetry"]))["carried_by"]
    wall = time.perf_counter() - t0
    print(f"  the {len(cells)} cells in {wall:.1f} s on the card (the committed grid: "
          f"wall_s {committed['meta']['wall_s']}, a CPU run of the JAX package); cell: "
          "final_acc (committed) final_r2 (committed) gate comparator [carried by]")
    for key, cell in cells.items():
        base = committed["cells"][key]
        ok = (cell["final_acc"] >= base["final_acc"] - TOL_ACC
              and cell["final_r2"] >= base["final_r2"] - TOL_R2)
        print(f"    {key:28s} {cell['final_acc']:.4f} ({base['final_acc']:.4f}) "
              f"{cell['final_r2']:.4f} ({base['final_r2']:.4f}) "
              f"{'within' if ok else 'OUTSIDE'} TOL_ACC={TOL_ACC}/TOL_R2={TOL_R2}"
              + (f" [{cell['carried_by']}]" if "carried_by" in cell else ""))
    return cells, launches, wall


def check_gate_claims(cells) -> None:
    """The gate's structural claims (``scripts/robustness_gate.py:120-150``)
    on the port's own cells, and WFAgg > mean under IPM-100 on both
    scenarios; any of them failing fails the run."""
    from repro_torch.core.attacks import ADAPTIVE_ATTACKS

    g = GATE_GRID
    cell = lambda a, s, agg: cells[f"{a}|{s}|{agg}"]["final_acc"]  # noqa: E731
    for attack in g["attacks"]:
        if attack not in ADAPTIVE_ATTACKS:
            continue
        drops = {(s, agg): cell("none", s, agg) - cell(attack, s, agg)
                 for s in g["scenarios"] for agg in g["aggregators"]
                 if agg in GATE_BASELINES}
        bites = [k for k, v in drops.items() if v > DEGRADE_MIN]
        print(f"  claim 1, {attack} degrades a baseline by > {DEGRADE_MIN}: "
              f"{'holds' if bites else 'FAILS'} (drops "
              f"{ {f'{s}|{a}': round(v, 4) for (s, a), v in drops.items()} })")
        if not bites:
            raise AssertionError(f"adaptive attack {attack!r} degrades no baseline "
                                 f"aggregator by > {DEGRADE_MIN}")
    clean = cell("none", "static", "wfagg")
    for attack in g["attacks"]:
        slack = cell(attack, "static", "wfagg") - (clean - WFAGG_STATIC_TOL)
        print(f"  claim 2, wfagg static under {attack}: {cell(attack, 'static', 'wfagg'):.4f}"
              f" against {clean:.4f} - {WFAGG_STATIC_TOL} (slack {slack:+.4f})")
        if slack < 0:
            raise AssertionError(f"wfagg static under {attack!r} falls more than "
                                 f"{WFAGG_STATIC_TOL} below its attack-free cell")
    for s in g["scenarios"]:
        w, m = cell("ipm_100", s, "wfagg"), cell("ipm_100", s, "mean")
        print(f"  ipm_100 on {s}: wfagg {w:.4f} > mean {m:.4f}")
        if not w > m:
            raise AssertionError(f"ipm_100 on {s}: wfagg {w} does not beat mean {m}")


def ride_report(torch, cfg, data, state, idx, val, mal, fused_rec):
    """How close band_rider puts its candidates to the WFAgg-T band edges
    this round, on the reference's own float32 statistics: over the valid
    (benign receiver, malicious sender) edges with an active band, the
    count, the count WFAgg-T accepted (the kernel's verdict), and the
    smallest relative distance of s_t to the band's upper edge.  Also
    returns each malicious sender's distance target ``s*`` (NaN where it
    rides no band)."""
    from repro_torch.core import attacks as atk
    from repro_torch.dfl import engine
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    models, tidx, v, prev, _ = aggregation_inputs(torch, cfg, data, state, idx, val, mal)
    st = robust_stats_indexed_ref(models, tidx, v, prev)
    view = engine._defense_view(cfg, state, idx, val)
    N, K = tidx.shape
    lo_d, hi_d = atk._sender_band_limits(view, mal, N)[:2]
    lo_s = lo_d.clamp(min=0.0)
    s_tgt = lo_s + (1.0 - cfg.attack_params.adaptive_margin) * (hi_d - lo_s).clamp(min=0.0)
    s_tgt = torch.where(torch.isfinite(hi_d) & (lo_d <= hi_d) & mal, s_tgt, torch.nan)
    tb = view.tbands.reshape(N, 4, K)
    edge = v & ~mal[:, None] & mal[tidx] & torch.isfinite(tb[:, 1])
    n = int(edge.sum())
    if n == 0:
        return dict(edges=0), s_tgt
    rel = ((tb[:, 1] - st.prev_dist2).abs() / tb[:, 1].abs().clamp(min=1e-30))[edge]
    accepted = int((((fused_rec.verdict >> 2) & 1).bool() & edge).sum())
    return dict(edges=n, t_accepted=accepted, min_rel_to_hi_d=float(rel.min())), s_tgt


def check_adaptive_replays(torch, topo, data, scheds) -> None:
    """``band_rider|eclipse|wfagg`` and ``min_max|static|wfagg`` replayed
    round by round on ``fused`` against the ``reference`` backend
    (``check_dynamic_against_reference``, its ``NEAR_TIE`` rule unchanged),
    over all 6 rounds of the gate's schedule (WFAgg-T's bands first hold at
    round 5, transient 3).  Under band_rider, each round's ride is printed
    (``ride_report``), and every near-tie with its distance from the
    attacker's band_rider target."""
    from repro_torch.dfl.engine import DFLConfig

    for attack, scenario in (("band_rider", "eclipse"), ("min_max", "static")):
        cfg = DFLConfig(aggregator="wfagg", attack=attack, model="mlp",
                        seed=GATE_GRID["seed"], wfagg_backend="fused")
        label = f"{attack}|{scenario}"
        ties = []

        def rides(r, state, idx, val, mal, rec, report):
            rep, s_tgt = ride_report(torch, cfg, data, state, idx, val, mal, rec)
            print(f"    {label} round {r + 1}: ride {rep}")
            for n, k, filt, margin in report or []:
                j = int(idx[n, k])
                ties.append((r + 1, n, k))
                print(f"      near-tie (node {n}, slot {k}, {filt}, margin {margin:.3g}): "
                      f"sender {j}{' (malicious)' if bool(mal[j]) else ''}, its "
                      f"band_rider target s* {float(s_tgt[j]):.6g}")

        print(f"  {label}|wfagg, fused replayed against the reference backend:")
        check_dynamic_against_reference(torch, cfg, topo, data, scheds[scenario],
                                        on_round=rides if attack == "band_rider" else None)
        if attack == "band_rider" and not ties:
            print(f"    {label}: no near-tie in {scheds[scenario].rounds} rounds")


def check_adaptive_backends(torch) -> dict:
    """``tests/test_adaptive_robustness.py:213`` on the card: under each
    adaptive attack and ``ipm``, WFAgg on ``fused`` (kernel 1),
    ``fused_two_launch`` (kernels 2 and 3) and ``reference`` over the
    test's eclipse schedule (N=8, K=4, MLP, 3 rounds): final accuracies
    within 3e-5 (fused vs two-launch) and 1e-3 (vs reference), as the test
    holds them.  Returns the launches, each run counted from 0."""
    import numpy as np

    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.dynamics import make_schedule
    from repro_torch.dfl.engine import DFLConfig, run_dynamic_experiment

    topo = make_topology(n_nodes=8, degree=4, n_malicious=2, kind="ring", seed=0,
                         placement="close")
    data = SyntheticImages(seed=0)
    sched = make_schedule("eclipse", topo, 3, seed=2)
    launches = dict.fromkeys(KERNELS, 0)
    for attack in ("band_rider", "min_max", "ipm"):
        finals = {}
        for backend in ("fused", "fused_two_launch", "reference"):
            cfg = DFLConfig(aggregator="wfagg", attack=attack, model="mlp", seed=0,
                            batches_per_round=1, wfagg_backend=backend)
            zero_counts()
            out = run_dynamic_experiment(cfg, topo, data, sched, n_test=64)
            counts = read_counts()
            want = dict.fromkeys(KERNELS, 0)
            if backend == "fused":
                want["wfagg_round_indexed"] = 3
            elif backend == "fused_two_launch":
                want["robust_stats_indexed"] = want["weighted_agg_indexed"] = 3
            if counts != want:
                raise AssertionError(f"{attack} on {backend}: launches {counts}, "
                                     f"expected {want}")
            for name in KERNELS:
                launches[name] += counts[name]
            finals[backend] = np.asarray(out["final"]["acc_all"])
        d_two = float(np.abs(finals["fused"] - finals["fused_two_launch"]).max())
        d_ref = float(np.abs(finals["fused"] - finals["reference"]).max())
        print(f"  backend parity under {attack} (N=8 K=4 eclipse, 3 rounds): fused vs "
              f"fused_two_launch {d_two:.3g} (<= {OUT_TOL}), vs reference {d_ref:.3g} "
              "(<= 1e-3)")
        if d_two > OUT_TOL or d_ref > 1e-3:
            raise AssertionError(f"backend parity under {attack} broke")
    return launches


def trace_round(torch, path, span, top=5) -> dict:
    """From a ``torch.profiler`` Chrome trace: the device kernels that ran
    inside the ``record_function`` span ``span`` (e.g. "round 5"), summed
    by name, the ``top`` with their share of the span's wall time, and the
    device's busy share of the span.  Returns the span's wall and busy ms
    and the top kernels' ms."""
    trace = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    spans = [e for e in trace if e.get("name") == span
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise AssertionError(f"the capture holds no span {span!r}")
    t0, t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    kernels = [e for e in trace if e.get("cat") == "kernel" and t0 <= e["ts"] < t1]
    if not kernels:
        raise AssertionError(f"the capture holds no device kernel inside {span!r}")
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy = sum(by_name.values())
    wall = t1 - t0
    print(f"  {span} in the torch.profiler capture: wall {wall / 1e3:.3f} ms, "
          f"{len(kernels)} kernel launches, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall:.1f}% of the span; idle {100 - 100 * busy / wall:.1f}%)")
    ranked = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    for name, us in ranked:
        print(f"    {us / 1e3:8.3f} ms {100 * us / wall:5.1f}%  {name[:100]}")
    return dict(wall_ms=wall / 1e3, busy_ms=busy / 1e3, launches=len(kernels),
                top={name[:100]: us / 1e3 for name, us in ranked})


def run_flight(torch) -> dict:
    """``python -m repro_torch.obs.report`` with its defaults (the
    acceptance scenario: 20-node ring, eclipse, band_rider, WFAgg on
    ``fused``, 8 MLP rounds) on the card, with ``--out-events``,
    ``--out-trace`` and ``--capture-dir`` in a temporary directory: one
    round-kernel launch per round, the event log strictly valid against
    ``SCHEMA``, both trace files written; prints the audit's last rounds
    and attribution, the ``profile`` event and the top device kernels of a
    steady round from the capture.  Returns the launches."""
    import contextlib
    import io
    import tempfile

    from repro_torch.obs import profile, recorder, report

    with tempfile.TemporaryDirectory() as tmp:
        ev, tr, cap = f"{tmp}/flight.jsonl", f"{tmp}/trace.json", f"{tmp}/capture"
        buf = io.StringIO()
        zero_counts()
        with contextlib.redirect_stdout(buf):
            rc = report.main(["--out-events", ev, "--out-trace", tr, "--capture-dir", cap])
        counts = read_counts()
        rounds = 8
        want = dict(dict.fromkeys(KERNELS, 0), wfagg_round_indexed=rounds)
        if rc != 0 or counts != want:
            raise AssertionError(f"the flight run: rc {rc}, launches {counts}, expected "
                                 f"{want}")
        events = recorder.read_events(ev)
        recorder.validate_events(events, strict=True)
        if len([e for e in events if e["type"] == "round_decision"]) != rounds:
            raise AssertionError("the flight log does not hold one decision per round")
        if not json.loads(pathlib.Path(tr).read_text())["traceEvents"]:
            raise AssertionError("the flight's Perfetto trace is empty")
        lines = buf.getvalue().splitlines()
        head = next(i for i, l in enumerate(lines) if l.strip().startswith("round"))
        print("\n".join(f"  | {l}" for l in lines[:head + 1]))
        print("\n".join(f"  | {l}" for l in lines[head + 1 + rounds - 3:]))
        prof = next(e for e in events if e["type"] == "profile")
        print(f"  flight log: {len(events)} events valid against SCHEMA (strict); profile: "
              f"compile {prof['compile_s']:.4f} s, steady median "
              f"{1e3 * prof['steady_s_median']:.3f} ms/round, "
              f"{prof['bytes_per_round']:.0f} B/round (memory_passes), achieved "
              f"{prof['achieved_bytes_per_s'] / 1e9:.3f} GB/s")
        walls = {e["round"]: e["wall_s"] for e in events if e["type"] == "round_timing"}
        steady = sorted(range(2, rounds + 1), key=lambda r: walls[r])[(rounds - 1) // 2]
        print(f"  the steady round (the median's, round {steady}):")
        trace_round(torch, f"{cap}/{profile.TRACE_FILE}", f"round {steady}")
    return counts


def run_cfl_min_max(torch, topo, data) -> dict:
    """CFL under min_max (``run_experiment(centralized=True)``, MLP, 4
    rounds): no view, the attack's benign-radius caps only; kernels 4 and
    7 once a round each.  Returns the launches."""
    import numpy as np

    from repro_torch.dfl.engine import DFLConfig, run_experiment

    cfg = DFLConfig(aggregator="wfagg", attack="min_max", model="mlp", centralized=True)
    zero_counts()
    out = run_experiment(cfg, topo, data, rounds=4)
    counts = read_counts()
    want = dict(dict.fromkeys(KERNELS, 0), robust_stats=4, weighted_agg=4)
    if counts != want:
        raise AssertionError(f"CFL under min_max: launches {counts}, expected {want}")
    acc = out["series"]["acc_benign_mean"]
    if not np.isfinite(acc).all():
        raise AssertionError("CFL under min_max: a non-finite accuracy")
    print(f"  CFL wfagg under min_max (MLP, 4 rounds): launches "
          f"{dict((k, v) for k, v in counts.items() if v)}; benign acc per round "
          f"{[round(a, 4) for a in acc]}")
    return counts


def run_adaptive_paths(torch) -> dict:
    """Phase 3's adaptive adversaries and audit plane; returns the launches
    of every run that counts, by kernel."""
    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.dynamics import make_faulty_schedule, make_schedule
    from repro_torch.dfl.engine import DFLConfig

    g = GATE_GRID
    topo = make_topology(n_nodes=g["nodes"], degree=g["degree"], n_malicious=g["malicious"],
                         kind=g["topology"], placement=g["placement"], seed=g["seed"])
    data = SyntheticImages(seed=g["seed"])
    scheds = {s: make_schedule(s, topo, g["rounds"], seed=g["seed"])
              for s in g["scenarios"]}
    cells, total, _ = run_gate_grid(torch, topo, data, scheds)
    check_gate_claims(cells)
    check_adaptive_replays(torch, topo, data, scheds)
    for name, n in check_adaptive_backends(torch).items():
        total[name] += n
    fsched, fs = make_faulty_schedule("churn", topo, ROUNDS, fault="chaos", intensity=0.4)
    cfg = DFLConfig(aggregator="wfagg", attack="band_rider", model="mlp")
    check_no_host_sync(torch, cfg, topo, data, fsched, fs)
    check_kill_and_resume(torch, cfg, topo, data, fsched, fs, stop=3)
    print("[3] the flight run: python -m repro_torch.obs.report (defaults) on the card")
    for name, n in run_flight(torch).items():
        total[name] += n
    for name, n in run_cfl_min_max(torch, topo, data).items():
        total[name] += n
    return total


# ---------------------------------------------------------------------------
# phase 3: the gathered wfagg_batch, Table I, the padded baselines
# ---------------------------------------------------------------------------

def verdicts(torch, info):
    """The per-edge verdict bits of ``obs.decision`` from a ``wfagg_batch``
    info dict: distance, similarity, WFAgg-T."""
    import types

    bits = (info["mask_d"].to(torch.int32) | (info["mask_c"].to(torch.int32) << 1)
            | (info["mask_t"].to(torch.int32) << 2))
    return types.SimpleNamespace(verdict=bits)


def run_gathered_path(torch, topo, data) -> dict:
    """The gathered ``wfagg_batch`` over the paper's DFL rounds (LeNet-5,
    IPM-100, ``ROUNDS`` rounds), WFAgg and Alt-WFAgg on ``fused`` with the
    per-edge WFAgg-T state carried round to round: each round's input is
    each node's K received models gathered from the round's trained and
    attacked matrix (``engine._trained`` on the engine's own state, which
    the engine's round then advances, as ``aggregation_inputs`` builds
    it).  Every round also runs, from the same models and state, the
    gathered ``reference`` backend and the indexed ``fused`` and
    ``fused_two_launch`` paths fed the per-edge state; each call has its
    launch counts set to 0 just before and read just after (exactly one
    kernel-5 launch on the gathered ``fused`` call; the per-edge variants
    of kernels 1 and 2 on the indexed calls; none on the reference).  Masks
    must be equal, or the round is reported with its filter and margin (as
    ``check_against_reference``); outputs within 3e-5.  A node that
    received a non-finite row (the attackers' rows, once their own models
    diverge; the gathered form has no sanitizer, as in the reference) is
    compared with ``equal_nan`` against the gathered reference and
    reported; the indexed paths, which sanitize, are held to the finite
    nodes.  Returns the launches by kernel."""
    import dataclasses

    from repro_torch.core import wfagg as wf
    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    idx = torch.as_tensor(topo.neighbor_indices, device="cuda").long()
    N, K = idx.shape
    mal = torch.as_tensor(topo.malicious, device="cuda")
    total = dict.fromkeys(KERNELS, 0)
    for agg in ("wfagg", "alt_wfagg"):
        cfg = engine.DFLConfig(aggregator=agg, attack="ipm_100", model="lenet")
        wcfg = engine._wfagg_full_config(cfg, K, backend="fused")
        ref, two = (dataclasses.replace(wcfg, backend=b)
                    for b in ("reference", "fused_two_launch"))
        state = engine.init_dfl_state(cfg, topo)
        advance = engine.build_round_fn(cfg, topo, data)
        d = ravel(state.node_params).shape[1]
        ts = wf.TemporalState(
            prev=torch.zeros((N, K, d), device="cuda"),
            hist_s=torch.zeros((N, wcfg.window, K), device="cuda"),
            hist_b=torch.zeros((N, wcfg.window, K), device="cuda"),
            count=torch.zeros((N,), dtype=torch.int32, device="cuda"),
            t=torch.zeros((N,), dtype=torch.int32, device="cuda"))
        # name -> (call on (flat, gathered, state), its exact launches)
        calls = {
            "gathered fused": (lambda flat, u, st: wf.wfagg_batch(flat, u, st, wcfg),
                               {"robust_stats_batch": 1}),
            "gathered reference": (lambda flat, u, st: wf.wfagg_batch(flat, u, st, ref),
                                   {}),
            "indexed fused": (lambda flat, u, st: wf.wfagg_batch(
                flat, flat, st, wcfg, neighbor_idx=idx),
                {"wfagg_round_indexed": 1, "wfagg_round_indexed[per_edge_prev]": 1}),
            "indexed fused_two_launch": (lambda flat, u, st: wf.wfagg_batch(
                flat, flat, st, two, neighbor_idx=idx),
                {"robust_stats_indexed": 1, "robust_stats_indexed[per_edge_prev]": 1,
                 "weighted_agg_indexed": 1}),
        }
        seconds, edges, nonfinite, t_fired = [], [], [], 0
        for r in range(ROUNDS):
            flat = engine._trained(cfg, data, state, mal)[2]
            u = flat[idx]
            res = {}
            for name, (fn, want) in calls.items():
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[name] = fn(flat, u, ts)
                torch.cuda.synchronize()
                if name == "gathered fused":
                    seconds.append(time.perf_counter() - t0)
                counts = read_counts()
                want = dict(dict.fromkeys(KERNELS, 0), **want)
                if counts != want:
                    raise AssertionError(f"gathered path {agg} round {r + 1} {name}: "
                                         f"launches {counts}, expected {want}")
                for k in KERNELS:
                    total[k] += counts[k]
            out, nts, info = res["gathered fused"]
            bad = ~(torch.isfinite(u).all(-1).all(-1) & torch.isfinite(ts.prev).all(-1).all(-1))
            nonfinite.append(torch.nonzero(bad).flatten().tolist())
            rec = verdicts(torch, info)
            for name in ("gathered reference", "indexed fused", "indexed fused_two_launch"):
                o, st, inf = res[name]
                rec_ref = verdicts(torch, inf)
                differ = rec.verdict != rec_ref.verdict
                if name != "gathered reference":
                    differ &= ~bad[:, None]       # the sanitizer acts on these nodes
                if differ.any():
                    report = decision_margins(
                        torch, wcfg, flat, idx, torch.ones((N, K), dtype=torch.bool,
                                                          device="cuda"),
                        ts.prev, None, ts, rec, rec_ref)
                    report = [x for x in report if bool(differ[x[0], x[1]])]
                    print(f"  gathered {agg} round {r + 1}: verdicts differ from the "
                          f"{name} path: (node, slot, filter, margin) {report}")
                    if not near_ties_only(report):
                        raise AssertionError(f"gathered {agg} round {r + 1}: verdicts "
                                             f"differ from the {name} path away from "
                                             "any edge")
                    edges.append((r + 1, name, report))
                    continue
                if name == "gathered reference":
                    torch.testing.assert_close(out, o, rtol=OUT_TOL, atol=OUT_TOL,
                                               equal_nan=True)
                else:
                    torch.testing.assert_close(out[~bad], o[~bad], rtol=OUT_TOL,
                                               atol=OUT_TOL)
                    if not torch.equal(st.prev[~bad], u[~bad]):
                        raise AssertionError(f"gathered {agg} round {r + 1}: the {name} "
                                             "path's per-edge state is not models[idx]")
            if not same_bits(torch, nts.prev, u):
                raise AssertionError(f"gathered {agg}: the new per-edge state is not "
                                     "the round's gathered tensor")
            t_fired += int(info["mask_t"][~bad].sum())
            ts = nts
            state = advance(state)
        print(f"  gathered {agg} on fused, {ROUNDS} rounds: verdicts equal to the gathered "
              f"reference and the indexed fused / fused_two_launch paths with per-edge "
              f"state, outputs within {OUT_TOL} (rounds on an edge: {edges}); WFAgg-T "
              f"accepted {t_fired} edges of finite nodes; nodes with a non-finite "
              f"candidate or prev per round {nonfinite}; gathered fused aggregation ms "
              f"{[round(1e3 * s_, 3) for s_ in seconds]}")
        if t_fired == 0:
            raise AssertionError(f"gathered {agg}: the WFAgg-T band test never fired")
    return total


def run_table1(torch, data) -> tuple:
    """Table I on the MLP (paper topology, IPM-100, 4 rounds): all 12
    aggregators in DFL and in CFL through ``run_experiment``, each with
    the launch counts set to 0 just before and read just after (the kernels
    run only under WFAgg and Alt-WFAgg: one round kernel per DFL round; one
    statistics and one combine launch, and for Alt-WFAgg one Gram, per CFL
    round).  Returns (final benign accuracy by (aggregator, centralized),
    launches by kernel)."""
    import numpy as np

    from repro_torch.core.topology import paper_topology
    from repro_torch.dfl.engine import AGGREGATORS, DFLConfig, run_experiment

    accs, total, rows = {}, dict.fromkeys(KERNELS, 0), []
    for centralized in (False, True):
        for agg in AGGREGATORS:
            cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="mlp",
                            centralized=centralized)
            zero_counts()
            o = run_experiment(cfg, paper_topology(), data, rounds=4, eval_every=4)
            counts = read_counts()
            want = dict.fromkeys(KERNELS, 0)
            if agg in ("wfagg", "alt_wfagg") and not centralized:
                want["wfagg_round_indexed"] = 4
            elif agg in ("wfagg", "alt_wfagg"):
                want["robust_stats"] = want["weighted_agg"] = 4
                want["pairwise_gram"] = 4 if agg == "alt_wfagg" else 0
            label = f"{'CFL' if centralized else 'DFL'} {agg}"
            if counts != want:
                raise AssertionError(f"Table I {label}: launches {counts}, expected {want}")
            if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
                raise AssertionError(f"Table I {label}: non-finite accuracy")
            for k in KERNELS:
                total[k] += counts[k]
            accs[(agg, centralized)] = o["final"]["acc_benign_mean"]
            ms = "/".join(str(round(1e3 * t, 1)) for t in o["series"]["round_seconds"])
            rows.append(f"{agg} {accs[(agg, centralized)]:.4f} ({ms} ms)")
        print(f"  Table I, {'CFL' if centralized else 'DFL'} (MLP, IPM-100, 4 rounds; "
              f"final benign acc, round ms): " + "; ".join(rows))
        rows = []
    return accs, total


# ---------------------------------------------------------------------------
# phase 2: kernel 8, flash attention

FLASH_F32_TOL = 2e-5   # tests/test_kernels.py:230
# kernel 8's bf16 o against its plain version: both accumulate in f32 and
# round o once, so they differ by at most one bf16 step (2^-8 to 2^-7 of
# the value); m and l are f32 in both, held at the f32 tolerance.  The
# reference's 2e-2 was set at Sk <= 384, where |o| ~ 0.1 and more; at
# Sk = 8192 a typical |o| is 0.02-0.03, and 2e-2 would pass almost anything
O_BF16_RTOL, O_BF16_ATOL = 2.0 ** -7, 1e-5
# logits (bf16, |logit| up to ~4 on the seed-0 init) of two routes of the
# same model: relative rms and largest difference (8 bf16 steps at 2-4).
# A top-1 that differs where the top-2 margin is 2 * LOGIT_ATOL or more
# cannot come from differences within LOGIT_ATOL
LOGIT_RMS, LOGIT_ATOL = 2e-2, 0.125
PREFILL_TAIL = 256   # positions of each prompt whose logits are compared
# (B, H, Sq, Sk, hd, causal, dtype, block): the six cases of
# tests/test_kernels.py:209-216 (block 64, as there), Sq > Sk (rows with no
# live key), hd 80 and 128 with ragged padding; the same branches of the bf16
# tensor-core kernel (hd 32 ragged, Sq > Sk, Sk not a multiple of its 64-key
# tile, hd 128 non-causal); then the prefill's attention at Qwen1.5-0.5B width
# (2 prompts of 8192 tokens, 16 heads of 64)
FLASH_CASES = [
    (1, 2, 128, 128, 64, True, "float32", 64),
    (2, 1, 256, 256, 32, True, "float32", 64),
    (1, 1, 128, 384, 64, True, "float32", 64),
    (1, 2, 130, 200, 32, True, "float32", 64),
    (1, 1, 128, 256, 64, False, "float32", 64),
    (1, 2, 128, 128, 64, True, "bfloat16", 64),
    (1, 2, 256, 128, 64, True, "float32", 128),
    (1, 2, 256, 100, 80, True, "bfloat16", 128),
    (2, 3, 300, 300, 80, True, "float32", 128),
    (2, 2, 200, 333, 128, False, "float32", 128),
    (1, 4, 256, 512, 128, True, "bfloat16", 128),
    (1, 2, 130, 200, 32, True, "bfloat16", 64),
    (1, 2, 256, 128, 64, True, "bfloat16", 128),
    (2, 3, 300, 300, 80, True, "bfloat16", 128),
    (2, 2, 200, 333, 128, False, "bfloat16", 128),
    (1, 1, 128, 256, 64, False, "bfloat16", 64),
    (2, 16, 8192, 8192, 64, True, "bfloat16", 128),
    (2, 16, 8192, 8192, 64, True, "float32", 128),
]
SERVE_ARCH = "qwen1.5-0.5b"
PREFILL_B, PREFILL_S, PREFILL_REPS = 2, 8192, 3
DECODE_B, PROMPT, NEW_TOKENS = 4, 64, 32


def flash_inputs(torch, BH, Sq, Sk, hd, dtype, seed):
    """Unit-normal q (BH, Sq, hd), k and v (BH, Sk, hd) in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((BH, S, hd), generator=g, device="cuda").to(getattr(torch, dtype))
                 for S in (Sq, Sk, Sk))


def _hold(label, name, got, want, dtype) -> tuple:
    """One output of kernel 8 against its plain version: o in bf16 within
    one rounding, o in f32 and m and l (f32) within 2e-5.  Returns the
    largest absolute and the relative rms difference."""
    import torch

    a, b = got.float(), want.float()
    if name == "o" and dtype == "bfloat16":
        rtol, atol = O_BF16_RTOL, O_BF16_ATOL
    else:
        rtol = atol = FLASH_F32_TOL
    err = float((a - b).abs().max())
    rel = float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-30))
    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        raise AssertionError(f"flash_attention {label}: {name} differs from the plain "
                             f"version by {err} (rtol {rtol}, atol {atol})")
    return err, rel


def compare_flash(torch, B, H, Sq, Sk, hd, causal, dtype, block, seed) -> float:
    """Kernel 8 against its plain version, twice: through the wrapper the
    prefill calls (``ops.flash_attention`` on (B, H, S, hd) views, which
    passes ``sk_valid = Sk`` and ``q_offset = Sk - Sq``), o only; and at
    kernel level on the reference's layout, Sq and Sk padded to ``block``
    (the padding masked through ``sk_valid``), o, m and l.  The rows with
    no live key are exactly o = 0, m = -1e30, l = 0 in both.  Returns o's
    largest absolute difference."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn.ref import NEG_INF, flash_attention_plain

    q, k, v = flash_inputs(torch, B * H, Sq, Sk, hd, dtype, seed)
    args = (float(1.0 / hd ** 0.5), causal, Sk, Sk - Sq)
    tc_before = fk.launches_tc
    label = f"B={B} H={H} Sq={Sq} Sk={Sk} hd={hd} causal={causal} {dtype}"
    want = flash_attention_plain(q, k, v, *args)
    o4 = fops.flash_attention(q.view(B, H, Sq, hd), k.view(B, H, Sk, hd),
                              v.view(B, H, Sk, hd), args[0], causal)
    wrapper = _hold(label + " (ops.flash_attention)", "o", o4.reshape(B * H, Sq, hd),
                    want[0], dtype)
    pq, pk = (-Sq) % block, (-Sk) % block
    if pq or pk:
        q = F.pad(q, (0, 0, 0, pq))
        k, v = (F.pad(t, (0, 0, 0, pk)) for t in (k, v))
        want = flash_attention_plain(q, k, v, *args)
    got = fk.flash_attention_cuda(q, k, v, *args)
    torch.cuda.synchronize()
    tc = fk.launches_tc - tc_before
    if tc != (2 if dtype == "bfloat16" else 0):
        raise AssertionError(f"flash_attention {label}: {tc} tensor-core launches of 2 calls")
    errs = {name: _hold(label, name, a, b, dtype) for name, a, b in zip("oml", got, want)}
    dead = torch.arange(q.shape[1], device="cuda") + (Sk - Sq) < 0
    if not causal:
        dead[:] = False
    for o, m, l in (got, want):
        if not (bool((o[:, dead] == 0).all()) and bool((m[:, dead] == NEG_INF).all())
                and bool((l[:, dead] == 0).all())):
            raise AssertionError(f"flash_attention {label}: a row with no live key is "
                                 "not exactly o = 0, m = -1e30, l = 0")
    steps = ""
    if dtype == "bfloat16":
        # elements of o a bf16 step or more off the plain version, beside
        # the same count for the kernel's arithmetic emulated in plain
        # PyTorch (p as P_TERMS bf16 terms, exact products summed in f32)
        emu = flash_attention_plain(q, k, v, *args, p_terms=fk.P_TERMS)[0]
        steps = (f", {int((got[0] != want[0]).sum())} of {got[0].numel()} bf16 o differ "
                 f"(the {fk.P_TERMS}-term emulation: {int((emu != want[0]).sum())})")
        del emu
    print(f"  flash_attention {label}: through ops.flash_attention max |o - plain| "
          f"{wrapper[0]:.3g} (relative rms {wrapper[1]:.3g}); padded to {block}: max |o - "
          f"plain| {errs['o'][0]:.3g} (relative rms {errs['o'][1]:.3g}), m "
          f"{errs['m'][0]:.3g}, l {errs['l'][0]:.3g}{steps}; {int(dead.sum())} rows with no "
          "live key, exact")
    return max(wrapper[0], errs["o"][0])


def time_flash(torch, B, H, S, hd, seed) -> dict:
    """Kernel 8 at the prefill's attention shape (causal, Sq = Sk = S) in
    bf16, the main path's type (the tensor-core kernel; and in f32, the
    CUDA-core kernel, printed): kernel, plain version, bound and
    ``F.scaled_dot_product_attention``.  The bound counts 4*hd operations
    per live pair at the type's rate: bf16 on the tensor cores (whose
    products are exact in f32, as the reference's), f32 on the CUDA cores
    (TF32 off)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain

    scale = float(1.0 / hd ** 0.5)
    live = B * H * S * (S + 1) / 2          # causal (query, key) pairs
    out = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = flash_inputs(torch, B * H, S, S, hd, dtype, seed)
        size = q.element_size()
        b = bound(4.0 * B * H * S * hd * size + 8.0 * B * H * S, 4.0 * hd * live,
                  BF16_TC_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S)
        q4, k4, v4 = (t.view(B, H, S, hd) for t in (q, k, v))
        out[dtype] = dict(
            ms=time_cuda(torch, lambda: fk.flash_attention_cuda(q, k, v, scale, True, S, 0),
                         2, 10),
            plain_ms=time_cuda(torch, lambda: flash_attention_plain(q, k, v, scale, True,
                                                                    S, 0), 1, 3),
            bound_ms=b[0], bound_by=b[1],
            library_ms=time_cuda(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 3, 20))
        t = out[dtype]
        print(f"  flash_attention B={B} H={H} S={S} hd={hd} causal {dtype}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), F.scaled_dot_product_attention {t['library_ms']:.4f} ms; "
              f"{4.0 * hd * live / t['ms'] / 1e9:.2f} TFLOP/s")
    return dict(out["bfloat16"], shape=f"B={B} H={H} S={S} hd={hd} causal bf16",
                f32=out["float32"])


def check_flash_refusals(torch) -> None:
    """No fallback on the card: a bf16 call the tensor-core kernel cannot
    take (a pointer off 16 bytes, a head dim it has no instance for)
    raises before any launch; it is never copied or sent to the f32 kernel
    or the plain version."""
    from repro_torch.kernels.flash_attn import kernel as fk

    before = (fk.launches, fk.launches_tc)
    q = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(2, 64, 64)
    for label, args in (("misaligned q", (q, q.clone(), q.clone())),
                        ("hd 48", (torch.zeros((2, 64, 48), dtype=torch.bfloat16,
                                               device="cuda"),) * 3)):
        try:
            fk.flash_attention_cuda(*args, 0.125, True, 64, 0)
        except ValueError as e:
            print(f"  flash_attention bf16 {label}: refused ({e})")
        else:
            raise AssertionError(f"flash_attention bf16 {label}: ran instead of raising")
    if (fk.launches, fk.launches_tc) != before:
        raise AssertionError("a refused flash_attention call launched a kernel")


def check_flash(torch) -> tuple:
    """Phase 2 for kernel 8: every case of ``FLASH_CASES``, the refusals,
    then the times at the prefill's shape.  Returns (o's errors, times)."""
    errs = [compare_flash(torch, *case, seed=60 + i) for i, case in enumerate(FLASH_CASES)]
    check_flash_refusals(torch)
    return errs, time_flash(torch, PREFILL_B, 16, PREFILL_S, 64, seed=80)


# ---------------------------------------------------------------------------
# phase 3: serving Qwen1.5-0.5B (prefill through kernel 8, KV-cache decode)


def check_logits(torch, label, got, want) -> None:
    """Two logit sets (..., V) of one model on two routes: relative rms
    within ``LOGIT_RMS``, largest difference within ``LOGIT_ATOL``, and
    top-1 tokens equal except at near-ties, positions whose top-2 margin
    in ``want`` is below 2 * ``LOGIT_ATOL`` (the most that differences
    within ``LOGIT_ATOL`` can flip), reported with their margin."""
    d = got - want
    rel = float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    biggest = float(d.abs().max())
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = got.argmax(-1) != want.argmax(-1)
    print(f"  {label}: largest logit difference {biggest:.4g} (logits up to "
          f"{float(want.abs().max()):.4g}), relative rms {rel:.3g}; top-1 differs at "
          f"{int(differ.sum())} of {differ.numel()} positions")
    if rel > LOGIT_RMS or biggest > LOGIT_ATOL:
        raise AssertionError(f"{label}: relative rms {rel} (bound {LOGIT_RMS}), largest "
                             f"difference {biggest} (bound {LOGIT_ATOL})")
    if bool((differ & (margin >= 2 * LOGIT_ATOL)).any()):
        raise AssertionError(f"{label}: top-1 differs where the top-2 margin is "
                             f"{2 * LOGIT_ATOL} or more")
    for i in differ.nonzero().tolist()[:8]:
        print(f"  {label}: near-tie at {i}: top-2 margin {float(margin[tuple(i)]):.4g}")


def run_serve_path(torch) -> dict:
    """Phase 3's serving path at full Qwen1.5-0.5B width and depth on the
    port's own init (seed 0): ``build_prefill`` on 2 prompts x 8192 tokens
    (warm once, then timed; 24 kernel-8 launches per call), the same
    prompts with ``flash=False``, ``build_decode_step`` at batch 4 against
    a cache of ``decode_32k``'s 32,768 positions (a 64-token prompt, then
    32 greedy tokens; no kernel), and the stepped logits against one
    prefill of the same 96 tokens.  Returns launches by kernel, and kernel
    8's on the bf16 tensor-core kernel as ``flash_attention[tensor_core]``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train.serve import build_decode_step, build_prefill

    cfg = get_config(SERVE_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} f32 "
          f"parameters, initialised in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=g,
                            device="cuda", dtype=torch.int32)

    # 1. prefill through kernel 8, warm once, then timed
    prefill = build_prefill(cfg)
    zero_counts()
    logits = prefill(params, {"tokens": prompts})
    if logits.shape != (PREFILL_B, PREFILL_S, cfg.vocab_size) or logits.dtype != torch.bfloat16:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    del logits
    torch.cuda.reset_peak_memory_stats()   # the timed calls' peak, not the checks'
    times = []
    for _ in range(PREFILL_REPS):
        logits = None
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    tail = logits[:, -PREFILL_TAIL:].float()   # the last timed call's, compared below
    del logits
    counts = read_counts()
    calls = 1 + PREFILL_REPS
    want = dict(dict.fromkeys(KERNELS, 0), flash_attention=cfg.n_layers * calls)
    if counts != want:
        raise AssertionError(f"prefill launches {counts}, expected {want}")
    tc = _module("flash_attention").launches_tc
    if tc != cfg.n_layers * calls:
        raise AssertionError(f"{tc} of the prefill's {cfg.n_layers * calls} kernel-8 launches "
                             "went to the bf16 tensor-core kernel")
    launches = dict(counts, **{"flash_attention[tensor_core]": tc})
    ms = 1e3 * statistics.median(times)
    print(f"  prefill {PREFILL_B} x {PREFILL_S} tokens: {ms:.2f} ms (median of "
          f"{PREFILL_REPS}; {[round(1e3 * t, 2) for t in times]}), "
          f"{PREFILL_B * PREFILL_S / ms * 1e3:.0f} prompt tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; kernel 8 launches {counts['flash_attention']} in "
          f"{calls} calls ({cfg.n_layers} a call), {tc} of them on the bf16 tensor-core "
          "kernel")

    # 2. the same prompts on the reference's second route (flash=False)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = build_prefill(cfg, flash=False)(params, {"tokens": prompts})
    torch.cuda.synchronize()
    chunked_ms = 1e3 * (time.perf_counter() - t)
    ref_tail = logits[:, -PREFILL_TAIL:].float()
    del logits
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"flash=False launched {read_counts()}")
    print(f"  prefill with flash=False (chunked online softmax): {chunked_ms:.2f} ms; top-1 "
          f"at each prompt's last position {tail[:, -1].argmax(-1).tolist()} vs "
          f"{ref_tail[:, -1].argmax(-1).tolist()}")
    check_logits(torch, f"prefill flash vs flash=False, each prompt's last {PREFILL_TAIL} "
                 "positions", tail, ref_tail)
    del tail, ref_tail

    # 3. decode against a 32k cache: a 64-token prompt, then 32 greedy tokens
    cache = M.init_cache(cfg, DECODE_B, DECODE_32K.seq_len)
    cache_gib = sum(t.numel() * t.element_size() for t in cache["layers"].values()) / 2**30
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT), generator=g, device="cuda",
                           dtype=torch.int32)
    step = build_decode_step(cfg)
    zero_counts()
    stepped = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(PROMPT):
        lg, cache = step(params, cache, prompt[:, i:i + 1])
        stepped.append(lg)
    torch.cuda.synchronize()
    prompt_ms = 1e3 * (time.perf_counter() - t) / PROMPT
    gen = []
    t = time.perf_counter()
    for _ in range(NEW_TOKENS):
        gen.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
        lg, cache = step(params, cache, gen[-1])
        stepped.append(lg)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / NEW_TOKENS
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"decode launched {read_counts()}")
    if cache["idx"] != PROMPT + NEW_TOKENS:
        raise AssertionError(f"cache idx {cache['idx']}")
    print(f"  decode batch {DECODE_B}, cache of {DECODE_32K.seq_len} positions "
          f"({cache_gib:.2f} GiB bf16): {prompt_ms:.3f} ms a step through the prompt, "
          f"{step_ms:.3f} ms a step over {NEW_TOKENS} greedy tokens "
          f"({DECODE_B / step_ms * 1e3:.1f} tokens/s); kernel 8 launches 0")
    # two parts of a step, timed alone on its shapes: one layer's dense
    # attention over the whole cache (the reference's mask over the
    # capacity), and the casts of every f32 weight to bf16
    kc, vc = cache["layers"]["k"][0], cache["layers"]["v"][0]
    qd = torch.randn((DECODE_B, cfg.n_heads, 1, cfg.head_dim_), generator=g,
                     device="cuda").to(torch.bfloat16)
    live = (torch.arange(kc.shape[2], device="cuda") < cache["idx"])[None, None, None, :]
    scale = 1.0 / cfg.head_dim_ ** 0.5
    attn_ms = time_cuda(torch, lambda: L._sdpa(qd, kc, vc, live, scale), 3, 20)
    cast_ms = time_cuda(torch, lambda: [p.to(torch.bfloat16) for p in params.parameters()],
                        2, 5)
    print(f"  of a decode step: attention over the cache {attn_ms:.3f} ms a layer "
          f"({cfg.n_layers * attn_ms:.2f} ms for {cfg.n_layers}), the weights' casts "
          f"{cast_ms:.3f} ms")

    # 4. the stepped logits against one prefill of the same 96 tokens
    seq = torch.cat([prompt] + gen, dim=1)
    zero_counts()
    pf = prefill(params, {"tokens": seq}).float()
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"a prefill of {seq.shape[1]} tokens launched {read_counts()}")
    st = torch.cat(stepped, dim=1).float()
    if not bool(torch.isfinite(st).all()):
        raise AssertionError("non-finite decode logits")
    check_logits(torch, f"decode vs one prefill of the same {seq.shape[1]} tokens", st, pf)
    del cache, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3: the distributed paths (distributed/spmd.py, robust_allreduce.py)
# ---------------------------------------------------------------------------

SHARDS = 8                                   # gloo ranks, all on the one card
SHARD_N, SHARD_K, SHARD_D = 64, 16, 1 << 20  # the sharded round: d/S = 131,072
SHARD_ROUNDS = 4                             # WFAgg-T active from the third
SHARD_BYZ = (3, 17, 40, 55)                  # rows scaled 40x
DIST_TIMEOUT_S = 420                         # the ranks' deadline, all parts
# the paper's widths split 8 ways (zero-padded to a multiple of 8)
SHARD_WIDTHS = {"lenet": 5554, "mlp": 6362}
STACK_ARCH = "qwen1.5-0.5b"
STACK_K = 8
# 3 rounds before the families' part; 2 still run WFAgg-T (transient 1)
STACK_ROUNDS = 2
STACK_MALICIOUS = (2, 5)                     # under ipm_100
STACK_METHODS = ("wfagg", "alt_wfagg", "multi_krum", "median", "mean")
# the fused routes first: the reference pass compares against both and,
# on a differing mask, measures the margin on its own statistics
STACK_BACKENDS = ("fused", "fused_two_launch", "reference")
STACK_W_TOL = 3e-5                           # tests/test_one_launch.py:20, 280-310
STACK_RTOL, STACK_ATOL = 1e-4, 3e-5
PLAIN_CHUNK = 1 << 25                        # columns a chunk of the plain versions


def shard_cfgs():
    """The sharded round's WFAgg and Alt-WFAgg (the DFL engine's Multi-Krum
    m at K = 16), WFAgg-T active after one round, on the two-launch
    backend the unsharded comparison runs."""
    import dataclasses

    from repro_torch.core import wfagg as wf

    base = wf.WFAggConfig(backend="fused_two_launch", window=3, transient=1)
    return {"wfagg": base,
            "alt_wfagg": dataclasses.replace(
                base, distance_filter="multi_krum", similarity_filter="clustering",
                multi_krum_m=max(1, int(0.25 * SHARD_K)))}


def shard_table(torch):
    """(N, K) table: K distinct other nodes each, from a fixed seed."""
    import numpy as np

    rng = np.random.default_rng(61)
    idx = np.stack([rng.choice(np.delete(np.arange(SHARD_N), n), SHARD_K, replace=False)
                    for n in range(SHARD_N)])
    return torch.as_tensor(idx, dtype=torch.int64, device="cuda")


def shard_models(torch, r):
    """Round r's (N, d) model matrix, drawn on the card from fixed seeds (so
    every rank draws the same): a common centre moving 0.05 a round, unit
    spread, the Byzantine rows scaled 40x."""
    g = torch.Generator(device="cuda").manual_seed(62)
    centre = torch.randn((1, SHARD_D), generator=g, device="cuda")
    g.manual_seed(6200 + r)
    m = centre + 0.05 * r + torch.randn((SHARD_N, SHARD_D), generator=g, device="cuda")
    m[list(SHARD_BYZ)] *= 40.0
    return m


def shard_state(torch, cfg, prev):
    from repro_torch.distributed import spmd

    return spmd.batched_matrix_state(SHARD_N, SHARD_K, SHARD_D, cfg.window,
                                     device="cuda")._replace(prev=prev)


def digest(torch, *xs) -> str:
    """A hash of the raw bytes of tensors (or of a state's fields)."""
    import hashlib

    h = hashlib.sha256()
    for x in xs:
        for t in (x if isinstance(x, tuple) else (x,)):
            if t is not None:
                h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def same_on_ranks(torch, dist, label, value) -> None:
    """Every rank's ``value`` (a digest) equal to rank 0's, checked on rank 0."""
    vals = [None] * dist.get_world_size()
    dist.all_gather_object(vals, value)
    if dist.get_rank() == 0 and len(set(vals)) != 1:
        raise AssertionError(f"{label}: the ranks' results differ: {vals}")


def only_counts(**want) -> dict:
    """``want`` (kernel name -> launches) for those kernels, 0 for the rest."""
    return dict(dict.fromkeys(KERNELS, 0), **want)


def hold_sharded(torch, label, got, want, models, idx, v, st, cfg):
    """A sharded round's ``(out, state, info)`` against the unsharded
    two-launch round's from the same pre-round state ``st``: masks
    bit-equal, or each differing edge a near-tie by ``NEAR_TIE``
    (reported); weights within 1e-6, ``out`` and ``prev`` within 2e-4 and
    ``hist_s`` within 1e-4 (``tests/_spmd_parity_main.py:65-69, 86-90``)
    on the other nodes.  Returns (largest ``out`` difference, near-tie
    nodes)."""
    from repro_torch.core import trust
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    (o, ns, info), (o_ref, ns_ref, info_ref) = got, want
    masks = ("mask_d", "mask_c", "mask_t")
    flips = [(n, k, bit) for bit, m in enumerate(masks)
             for n, k in (info[m] != info_ref[m]).nonzero().tolist()]
    off = torch.zeros(idx.shape[0], dtype=torch.bool, device="cuda")
    if flips:
        stats = robust_stats_indexed_ref(models, idx, v, st.prev,
                                         need_gram=trust.needs_gram(cfg))
        tb = trust.temporal_bands(st.hist_s, st.hist_b, st.count, st.t, cfg)
        report = flip_margins(torch, stats, v, tb, cfg, flips)
        print(f"  {label}: masks differ from the unsharded round at (node, slot, "
              f"filter, margin) {report}")
        if not near_ties_only(report):
            raise AssertionError(f"{label}: masks differ from the unsharded round away "
                                 "from any edge")
        off[[n for n, _, _ in flips]] = True
    keep = ~off
    torch.testing.assert_close(info["weights"][keep], info_ref["weights"][keep], rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(o[keep], o_ref[keep], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(ns.prev, ns_ref.prev, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(ns.hist_s, ns_ref.hist_s, rtol=2e-4, atol=1e-4)
    return float((o[keep] - o_ref[keep]).abs().max()), int(off.sum())


def hold_emulated(torch, label, got, emu) -> None:
    """A rank's sharded round against the one-process emulation: every
    output bit for bit."""
    (o, ns, info), (o_e, ns_e, info_e) = got, emu
    pairs = [("out", o, o_e)] + [(k, info[k], info_e[k]) for k in
                                 ("weights", "mask_d", "mask_c", "mask_t")]
    if ns is not None:
        pairs += [(k, getattr(ns, k), getattr(ns_e, k)) for k in ns._fields]
    for name, a, b in pairs:
        same = bit_equal(torch, a, b) if a.dtype == torch.float32 else torch.equal(a, b)
        if not same:
            raise AssertionError(f"{label}: {name} differs from the one-process "
                                 "emulation")


def dist_round_part(torch, dist, group, report) -> dict:
    """Every rank: ``SHARD_ROUNDS`` sharded rounds of WFAgg and Alt-WFAgg
    at N=64, K=16, d=2^20 with the state carried (prev of round 0 is 0.97
    of its models).  Each round's launches are counted alone (kernel 2
    once, kernel 3 once, nothing else); rank 0 holds each round to the
    emulation (bit for bit) and to the unsharded two-launch round from
    the same state; every rank's outputs are the same bits."""
    from repro_torch.core import wfagg as wf
    from repro_torch.distributed import spmd

    rank, S = dist.get_rank(), dist.get_world_size(group)
    idx = shard_table(torch)
    totals = dict.fromkeys(KERNELS, 0)
    for name, cfg in shard_cfgs().items():
        st = shard_state(torch, cfg, 0.97 * shard_models(torch, 0))
        ms, ms_ref, ties, errs, fired = [], [], 0, [], [0, 0, 0]
        for r in range(SHARD_ROUNDS):
            m = shard_models(torch, r)
            dist.barrier(group)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            got = spmd.wfagg_batch_sharded(m, m, st, cfg, idx, group=group)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            counts = read_counts()
            want = only_counts(robust_stats_indexed=1, weighted_agg_indexed=1)
            if counts != want:
                raise AssertionError(f"rank {rank} {name} round {r}: launches {counts}")
            for k in KERNELS:
                totals[k] += counts[k]
            same_on_ranks(torch, dist, f"sharded {name} round {r}", digest(
                torch, got[0], got[1], *(got[2][k] for k in ("weights", "mask_d",
                                                             "mask_c", "mask_t"))))
            if rank == 0:
                label = f"sharded {name} N={SHARD_N} K={SHARD_K} d=2^20 S={S} round {r}"
                hold_emulated(torch, label, got, spmd.wfagg_batch_sharded_emulated(
                    m, m, st, cfg, idx, n_shards=S))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = wf.wfagg_batch(m, m, st, cfg, neighbor_idx=idx)
                torch.cuda.synchronize()
                ms_ref.append(1e3 * (time.perf_counter() - t0))
                v = torch.ones(idx.shape, dtype=torch.bool, device="cuda")
                err, n_ties = hold_sharded(torch, label, got, ref, m, idx, v, st, cfg)
                errs.append(err)
                ties += n_ties
                for i, k in enumerate(("mask_d", "mask_c", "mask_t")):
                    fired[i] += int(got[2][k].sum())
            st = got[1]
        if rank == 0:
            if not all(0 < f < SHARD_ROUNDS * SHARD_N * SHARD_K for f in fired):
                raise AssertionError(f"sharded {name}: a filter accepted every edge or "
                                     f"none over the rounds: {fired}")
            report[f"round_{name}"] = dict(
                ms=ms, unsharded_ms=ms_ref, max_out_err=max(errs), near_tie_nodes=ties,
                accepted_d_c_t=fired)
    # the round's two collectives alone: the O(N·K) partials (with prev and
    # the Gram) and the gathered out shards, both staged through the host
    F = 6 * SHARD_K + 1 + SHARD_K * SHARD_K
    for key, shape in (("psum_ms", (SHARD_N, F)), ("out_gather_ms",
                                                    (SHARD_N, SHARD_D // S))):
        x = torch.zeros(shape, device="cuda")
        times = []
        for _ in range(3):
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spmd.all_gather_in_rank_order(x, group)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        report[key] = statistics.median(times)
    return totals


def churned_schedule(torch, R):
    """``_spmd_parity_main.py:44-57`` at the sharded round's shape: the table
    rolled one slot a round, one slot per node dropped in later rounds."""
    idx = shard_table(torch)
    sched_idx = torch.stack([torch.roll(idx, r, dims=1) for r in range(R)])
    sched_valid = torch.ones((R, SHARD_N, SHARD_K), dtype=torch.bool, device="cuda")
    n = torch.arange(SHARD_N, device="cuda")
    for r in range(1, R):
        sched_valid[r, n, (n + r) % SHARD_K] = False
    return sched_idx, sched_valid


def dist_scan_part(torch, dist, group, report) -> dict:
    """Every rank: ``wfagg_scan_sharded`` over three churned rounds (kernel 2
    and kernel 3 three times each); rank 0 gathers the shards and holds
    them to the one-process emulation loop (bit for bit) and to the loop
    of realign + the unsharded two-launch round (2e-4; hist_s 1e-4)."""
    from repro_torch.core import wfagg as wf
    from repro_torch.distributed import spmd

    R, S = 3, dist.get_world_size(group)
    cfg = shard_cfgs()["wfagg"]
    sched_idx, sched_valid = churned_schedule(torch, R)
    models = shard_models(torch, 0)
    st0 = shard_state(torch, cfg, models)
    dist.barrier(group)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    m_sh, st_sh = spmd.wfagg_scan_sharded(models, st0, cfg, sched_idx, sched_valid,
                                          group=group)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    if counts != only_counts(robust_stats_indexed=R, weighted_agg_indexed=R):
        raise AssertionError(f"rank {dist.get_rank()} scan: launches {counts}")
    full = torch.cat(spmd.all_gather_in_rank_order(m_sh, group), dim=1)
    prev = torch.cat(spmd.all_gather_in_rank_order(st_sh.prev, group), dim=1)
    same_on_ranks(torch, dist, "scan", digest(torch, full, prev, st_sh.hist_s,
                                              st_sh.hist_b))
    if dist.get_rank() == 0:
        m_e, st_e = models, st0
        m_r, st_r = models, st0
        prev_idx, prev_val = sched_idx[0], torch.ones_like(sched_valid[0])
        for r in range(R):
            i, v = sched_idx[r], sched_valid[r]
            st_e = wf.realign_temporal_history(st_e, prev_idx, prev_val, i, v)
            m_e, st_e, _ = spmd.wfagg_batch_sharded_emulated(m_e, m_e, st_e, cfg, i, v,
                                                             n_shards=S)
            st_r = wf.realign_temporal_history(st_r, prev_idx, prev_val, i, v)
            m_r, st_r, _ = wf.wfagg_batch(m_r, m_r, st_r, cfg, neighbor_idx=i, valid=v)
            prev_idx, prev_val = i, v
        if not (bit_equal(torch, full, m_e) and bit_equal(torch, st_sh.hist_s, st_e.hist_s)
                and bit_equal(torch, prev, st_e.prev)):
            raise AssertionError("scan: differs from the one-process emulation loop")
        torch.testing.assert_close(full, m_r, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(prev, st_r.prev, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st_sh.hist_s, st_r.hist_s, rtol=2e-4, atol=1e-4)
        report["scan"] = dict(ms=ms, max_models_err=float((full - m_r).abs().max()))
    return counts


def engine_replay_report(torch, cfg, topo, data, pre, rec, rec_ref, slate=None):
    """Margins of the differing verdicts of a sharded engine round and its
    unsharded replay (``decision_margins`` on the round's own inputs)."""
    from repro_torch.dfl import engine

    if slate is None:
        return explain_dfl_round(torch, cfg, topo, data, pre, rec, rec_ref)
    idx, val, mal = slate
    wcfg = engine._wfagg_full_config(cfg, idx.shape[1])
    return decision_margins(torch, wcfg, *aggregation_inputs(
        torch, cfg, data, pre, idx, val, mal), pre.temporal, rec, rec_ref)


def dist_engine_part(torch, dist, group, report) -> dict:
    """Every rank: the DFL engine with ``mesh_model_shards = 8`` (WFAgg,
    IPM-100, the paper's 20-node ring): a static run of ``ROUNDS`` rounds
    and two dynamic ``churn`` rounds, LeNet-5 and the MLP.  Each round:
    kernel 2 and kernel 3 once on every rank, every rank's models,
    momentum, WFAgg-T state and verdicts the same bits (rank 0 trains and
    broadcasts); rank 0 replays each round from the same state on the
    unsharded two-launch engine (models within 3e-4,
    ``_spmd_parity_main.py:175-182``; verdicts bit-equal or near-ties).
    The final evaluation is the same on every rank."""
    import dataclasses

    import numpy as np

    from repro_torch.core import wfagg as wf
    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl import dynamics as dyn
    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    rank, S = dist.get_rank(), dist.get_world_size(group)
    topo = make_topology(20, 8, 2, "ring", placement="close")
    data = SyntheticImages()
    totals = dict.fromkeys(KERNELS, 0)
    sched = dyn.churn_schedule(topo, 2, seed=1)
    xs = upload_schedule(torch, sched)
    for model in ("lenet", "mlp"):
        cfg = engine.DFLConfig(aggregator="wfagg", attack="ipm_100", model=model,
                               wfagg_backend="fused_two_launch",
                               mesh_model_shards=S)
        ref_cfg = dataclasses.replace(cfg, mesh_model_shards=0)
        runs = (("static", engine.build_round_fn(cfg, topo, data, telemetry=True),
                 engine.build_round_fn(ref_cfg, topo, data, telemetry=True), ROUNDS,
                 None),
                ("churn", engine.build_round_fn(cfg, topo, data, dynamic=True,
                                                telemetry=True),
                 engine.build_round_fn(ref_cfg, topo, data, dynamic=True, telemetry=True),
                 2, sched.width))
        for kind, fn, ref_fn, R, width in runs:
            state = engine.init_dfl_state(cfg, topo, degree=width)
            errs, edges, ms = [], [], []
            prev = (xs[0][0], xs[1][0])
            for r in range(R):
                slate = None
                if width is not None:
                    slate = tuple(x[r] for x in xs[:3])
                    state = state._replace(temporal=wf.realign_temporal_history(
                        state.temporal, *prev, *slate[:2]))
                    prev = slate[:2]
                pre = state
                dist.barrier(group)
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                state, rec = fn(state) if slate is None else fn(state, *slate)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                counts = read_counts()
                if counts != only_counts(robust_stats_indexed=1,
                                         weighted_agg_indexed=1):
                    raise AssertionError(f"rank {rank} engine {model} {kind} round {r}: "
                                         f"launches {counts}")
                for k in KERNELS:
                    totals[k] += counts[k]
                flat = ravel(state.node_params)
                same_on_ranks(torch, dist, f"engine {model} {kind} round {r}", digest(
                    torch, flat, ravel(state.node_momentum), tuple(state.temporal),
                    rec.verdict))
                if rank == 0:
                    alt, rec_ref = ref_fn(pre) if slate is None else ref_fn(pre, *slate)
                    if not torch.equal(rec.verdict, rec_ref.verdict):
                        rep = engine_replay_report(torch, ref_cfg, topo, data, pre, rec,
                                                   rec_ref, slate)
                        print(f"  engine {model} {kind} round {r + 1}: verdicts differ "
                              f"from the unsharded engine at (node, slot, filter, "
                              f"margin) {rep}")
                        if not near_ties_only(rep):
                            raise AssertionError(f"engine {model} {kind} round {r + 1}: "
                                                 "verdicts differ away from any edge")
                        edges.append((r + 1, rep))
                    else:
                        ref_flat = ravel(alt.node_params)
                        torch.testing.assert_close(flat, ref_flat, rtol=3e-4, atol=3e-4,
                                                   equal_nan=True)
                        errs.append(float((flat - ref_flat).nan_to_num().abs().max()))
            ev = engine.evaluate(cfg, topo, data, state)
            same_on_ranks(torch, dist, f"engine {model} {kind} evaluation",
                          digest(torch, torch.as_tensor(np.asarray(ev["acc_all"]))))
            if rank == 0:
                report[f"engine_{model}_{kind}"] = dict(
                    ms=ms, max_models_err=max(errs) if errs else None,
                    rounds_on_an_edge=edges, acc_benign=ev["acc_benign_mean"])
    return totals


def dist_child(rank, S, store_path, out_dir, backend) -> None:
    """One rank of the distributed phase: joins the ``backend`` group of S
    ranks through the file store (on card ``rank`` modulo the cards), runs
    the round, scan and engine parts, and writes its launch counts (and on
    rank 0 the comparisons' report) as JSON."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    # the replays retrain rank 0's round: deterministic cuDNN, as phase 3's
    torch.backends.cudnn.deterministic = True
    res = {"rank": rank}
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path, S), rank=rank,
                                world_size=S)
        group = dist.group.WORLD
        report = {}
        try:
            res["launches"] = {
                "round": dist_round_part(torch, dist, group, report),
                "scan": dist_scan_part(torch, dist, group, report),
                "engine": dist_engine_part(torch, dist, group, report)}
        finally:
            dist.destroy_process_group()
        res["report"] = report
    except Exception:   # noqa: BLE001 - the parent fails the run on it
        import traceback
        res["error"] = traceback.format_exc()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def run_ranks(torch, backend, S, child=None, tmp=None, timeout=DIST_TIMEOUT_S) -> list:
    """Spawn S processes, each a ``backend`` rank running ``child`` (the
    distributed phase's ``dist_child`` by default; ``gloo``: all on the one
    card; ``nccl``: one card each) with ``tmp`` (default: a new directory)
    for its files; wait for all of them within ``timeout`` seconds (the
    stragglers are killed and the run fails).  Returns each rank's JSON."""
    import multiprocessing as mp
    import tempfile

    import torch._dynamo  # noqa: F401 - cached here once, not compiled in every rank

    ctx = mp.get_context("spawn")
    tmp = tmp or tempfile.mkdtemp(prefix="chip_smoke_dist_")
    store = str(pathlib.Path(tmp, "store"))
    procs = [ctx.Process(target=child or dist_child, args=(r, S, store, tmp, backend))
             for r in range(S)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise AssertionError(f"distributed: ranks {hung} passed the {timeout} s "
                             "deadline and were killed")
    results = []
    for r, p in enumerate(procs):
        path = pathlib.Path(tmp, f"rank{r}.json")
        if p.exitcode != 0 or not path.exists():
            raise AssertionError(f"distributed: rank {r} exited with {p.exitcode}")
        res = json.loads(path.read_text())
        if "error" in res:
            raise AssertionError(f"distributed: rank {r} failed:\n{res['error']}")
        results.append(res)
    return results


def report_ranks(ranks, S, backend) -> tuple:
    """Print the ranks' parts (rank 0's report) and check that every rank
    launched the same kernels; returns (launches summed over the ranks,
    rank 0's report)."""
    launches = dict.fromkeys(KERNELS, 0)
    per_rank = []
    for res in ranks:
        mine = dict.fromkeys(KERNELS, 0)
        for counts in res["launches"].values():
            for k, c in counts.items():
                mine[k] += c
        per_rank.append({k: c for k, c in mine.items() if c})
        for k in KERNELS:
            launches[k] += mine[k]
    if any(r != per_rank[0] for r in per_rank):
        raise AssertionError(f"the ranks launched differently: {per_rank}")
    print(f"  launches on each rank (round, scan and engine parts): {per_rank[0]}")
    rep = ranks[0]["report"]
    for name in ("wfagg", "alt_wfagg"):
        r = rep[f"round_{name}"]
        print(f"  sharded {name} N={SHARD_N} K={SHARD_K} d=2^20 S={S} on {backend}: "
              f"{SHARD_ROUNDS} rounds bit-equal to the one-process emulation and "
              f"on every rank, within the harness's tolerances of the unsharded "
              f"round (out max|diff| {r['max_out_err']:.3g}, near-tie nodes "
              f"{r['near_tie_nodes']}; accepted edges D/C/T {r['accepted_d_c_t']}); "
              f"round ms {[round(t, 2) for t in r['ms']]}, unsharded "
              f"{[round(t, 2) for t in r['unsharded_ms']]}")
    print(f"  the round's collectives alone (median of 3; gloo stages through the "
          f"host): the partials {rep['psum_ms']:.3f} ms, the out gather "
          f"{rep['out_gather_ms']:.3f} ms")
    print(f"  scan (3 churned rounds): {rep['scan']['ms']:.2f} ms, bit-equal to the "
          f"emulation loop, models within 2e-4 of the unsharded loop (max|diff| "
          f"{rep['scan']['max_models_err']:.3g})")
    for key, r in rep.items():
        if key.startswith("engine_"):
            print(f"  {key}: every rank bit-equal each round, models within 3e-4 of "
                  f"the unsharded engine (max|diff| {r['max_models_err']}; rounds on an "
                  f"edge {r['rounds_on_an_edge']}), benign acc {r['acc_benign']:.4f}, "
                  f"round ms {[round(t, 2) for t in r['ms']]}")
    return launches, rep


def run_cards(torch) -> dict:
    """The round, scan and engine parts on one ``nccl`` rank per visible
    card (``--only cards``, at least 2 cards): the deployment the port's
    sharding is for, where the collectives stay on the devices."""
    S = torch.cuda.device_count()
    if S < 2:
        raise AssertionError(f"--only cards needs at least 2 cards, found {S}")
    t0 = time.perf_counter()
    ranks = run_ranks(torch, "nccl", S)
    print(f"  {S} nccl ranks, one card each, done in {time.perf_counter() - t0:.1f} s")
    launches, rep = report_ranks(ranks, S, "nccl")
    return {"launches": launches, "report": rep}


def run_nccl_one_rank(torch) -> dict:
    """S=1 on ``nccl`` in this process (a world-size-1 group: the backend a
    run over several cards would use): ``SHARD_ROUNDS`` sharded rounds of
    WFAgg and Alt-WFAgg equal the unsharded two-launch round bit for bit
    (every output, from the same state).  Returns the launches."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import wfagg as wf
    from repro_torch.distributed import spmd

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(pathlib.Path(tmp, "s")), 1),
                            rank=0, world_size=1)
    totals = dict.fromkeys(KERNELS, 0)
    try:
        idx = shard_table(torch)
        for name, cfg in shard_cfgs().items():
            st = shard_state(torch, cfg, 0.97 * shard_models(torch, 0))
            for r in range(SHARD_ROUNDS):
                m = shard_models(torch, r)
                zero_counts()
                got = spmd.wfagg_batch_sharded(m, m, st, cfg, idx)
                torch.cuda.synchronize()
                counts = read_counts()
                if counts != only_counts(robust_stats_indexed=1,
                                         weighted_agg_indexed=1):
                    raise AssertionError(f"nccl S=1 {name} round {r}: launches {counts}")
                for k in KERNELS:
                    totals[k] += counts[k]
                hold_emulated(torch, f"nccl S=1 {name} round {r} vs the unsharded round",
                              got, wf.wfagg_batch(m, m, st, cfg, neighbor_idx=idx))
                st = got[1]
        print(f"  S=1 on nccl: {SHARD_ROUNDS} rounds each of WFAgg and Alt-WFAgg at "
              f"N={SHARD_N} K={SHARD_K} d=2^20 equal the unsharded fused_two_launch "
              "round bit for bit (out, weights, masks, prev, hist_s, hist_b, count, t)")
    finally:
        dist.destroy_process_group()
    return totals


def time_shard_kernels(torch) -> dict:
    """Kernels 2 and 3 at the per-shard launch shape (M=N=64 rows, K=16,
    d/S=131,072; kernel 2 with prev, with and without the Gram), their
    plain versions, bounds and (kernel 3) the library call; and kernel 2 at
    the paper's shard widths of the engine (N=20, K=8)."""
    out = time_dfl_kernels(torch, SHARD_N, SHARD_K, SHARD_D // SHARDS, seed=71)
    out.pop("wfagg_round_indexed_gram")
    out["weighted_agg_indexed"] = time_combine_indexed(torch, SHARD_N, SHARD_K,
                                                       SHARD_D // SHARDS, seed=72)
    for model, w in SHARD_WIDTHS.items():
        out[f"robust_stats_indexed_{model}"] = time_dfl_kernels(
            torch, 20, 8, w, seed=73)["robust_stats_indexed_no_gram"]
        out[f"weighted_agg_indexed_{model}"] = time_combine_indexed(torch, 20, 8, w,
                                                                    seed=74)
    return out


def check_shard_kernels(torch) -> dict:
    """Kernels 2 and 3 against their plain versions at the per-shard shapes:
    N=64 K=16 d/S=131,072 and the paper's shard widths at N=20 K=8 (d/S
    = 5,554 and 6,362: 2 mod 4), with and without prev and the Gram."""
    from repro_torch.core.topology import make_topology

    errs = {"robust_stats_indexed": [], "weighted_agg_indexed": []}
    ring = make_topology(20, 8, 2, "ring", placement="close").neighbor_indices
    big = shard_table(torch).cpu().numpy()
    for label, N, K, d, idx in (("shard N=64 K=16 d/S=131072", SHARD_N, SHARD_K,
                                 SHARD_D // SHARDS, big),
                                *((f"{m} shard N=20 K=8 d/S={w}", 20, 8, w, ring)
                                  for m, w in SHARD_WIDTHS.items())):
        for with_prev, need_gram in ((True, False), (True, True)):
            errs["robust_stats_indexed"].append(compare_indexed_stats(
                torch, label, N, K, d, idx, None, 75, (0, 4), with_prev, need_gram))
        errs["weighted_agg_indexed"].append(compare_weighted_agg_indexed(
            torch, f"weighted_agg_indexed {label}", N, K, d, idx, None, 76))
    return errs


# ---- the stacked robust all-reduce over Qwen1.5-0.5B-shaped candidates ------

def stack_base(torch) -> dict:
    """Qwen1.5-0.5B's parameter dict at full width and depth, the port's
    own init (seed 0 on the card), as the candidates' common base."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_params

    model = init_params(get_config(STACK_ARCH))
    return {k: v.detach() for k, v in model.named_parameters()}


def stack_candidates(torch, base, r) -> dict:
    """Round r's K candidates: the base plus seeded perturbations (0.1 of
    each leaf's spread, 0.01 where it has none), then ``ipm_100`` on
    ``STACK_MALICIOUS`` through ``apply_stacked_attack``."""
    from repro_torch.distributed.robust_allreduce import apply_stacked_attack

    g = torch.Generator(device="cuda").manual_seed(7100 + r)
    cands = {}
    for k in sorted(base):
        b = base[k]
        s = 0.1 * float(b.std()) if b.numel() > 1 else 0.0
        z = torch.randn((STACK_K,) + tuple(b.shape), generator=g, device="cuda")
        cands[k] = z.mul_(s or 0.01).add_(b)
    mal = torch.zeros(STACK_K, dtype=torch.bool, device="cuda")
    mal[list(STACK_MALICIOUS)] = True
    return apply_stacked_attack(cands, mal, "ipm_100")


def stack_cfg(method, backend):
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.distributed.robust_allreduce import RobustAggConfig

    return RobustAggConfig(method=method, layout="stacked", backend=backend,
                           wfagg=WFAggConfig(window=3, transient=1))


def flat_of(torch, tree):
    from repro_torch.distributed.robust_allreduce import _leaves

    return torch.cat([leaf.reshape(-1) for leaf in _leaves(tree)])


def close_leafwise(torch, a, b, rtol, atol) -> float:
    """``torch.testing.assert_close`` of two outputs, each one flat vector
    or a tree of leaves in ravel order, leaf by leaf (no flat copy of a
    tree that a flat vector does not force); returns the largest absolute
    difference."""
    from repro_torch.distributed.robust_allreduce import _leaves

    if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
        a, b = (x if isinstance(x, torch.Tensor) else flat_of(torch, x) for x in (a, b))
    la, lb = ([x] if isinstance(x, torch.Tensor) else _leaves(x) for x in (a, b))
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} leaves against {len(lb)}")
    err = 0.0
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol)
        err = max(err, float((x - y).abs().max()))
    return err


def stacked_margins(torch, cfg, cands, state, flips):
    """(candidate, filter, margin) of each differing (k, bit) decision of the
    stacked round, on the reference route's own statistics (``margins_of``;
    Clustering has none)."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import alt_wfagg_config
    from repro_torch.distributed import robust_allreduce as ra

    K = ra._leaves(cands)[0].shape[0]
    cs = ra._stacked_stats(cands, cfg)
    if cfg.method == "multi_krum":
        wcfg = alt_wfagg_config(f=cfg.wfagg.f, multi_krum_m=cfg.multi_krum_m or K // 4)
    else:
        wcfg = ra._effective_wfagg_config(cfg, K)
    s = b = tb = None
    if state is not None:
        s, b = ra._stacked_temporal_metrics(cands, state.prev)
        tb = trust.temporal_bands(state.hist_s, state.hist_b, state.count, state.t,
                                  wcfg)[None]
    return margins_of(torch, wcfg, cs.dist2_med, cs.gram, cs.dot_med, cs.med2, s, b, tb,
                      flips)


def margins_of(torch, wcfg, dist2, gram, dot_med, med2, s, b, tb, flips):
    """(candidate, filter, margin) of each differing (k, bit) decision from
    a stacked round's statistics (the temporal ``s``, ``b`` and bands ``tb``
    None without WFAgg-T): the distance filter and WFAgg-T as
    ``flip_margins``; WFAgg-C, which keeps the K - f - 1 smallest cosine
    distances to the median as WFAgg-D keeps distances, by the same
    relative gap between the last kept and the first dropped value."""
    from types import SimpleNamespace

    K = dist2.shape[0]
    st = SimpleNamespace(dist2=dist2[None], gram=gram[None],
                         prev_dist2=None if s is None else s[None],
                         cosine_to_prev=lambda: b[None])
    v = torch.ones((1, K), dtype=torch.bool, device=dist2.device)
    rep = []
    for k, bit in flips:
        if bit == 1 and wcfg.similarity_filter == "wfagg_c":
            cos_d = 1.0 - dot_med / torch.sqrt(torch.clamp(torch.diagonal(gram) * med2,
                                                           min=1e-24))
            srt = torch.sort(cos_d).values
            keep = K - wcfg.f - 1
            rep.append((k, "WFAgg-C", float((srt[keep] - srt[keep - 1]).abs()
                                            / srt[keep].abs().clamp(min=1e-30))))
        else:
            rep += [(k, f, m) for _, _, f, m in flip_margins(torch, st, v, tb, wcfg,
                                                             [(0, k, bit)])]
    return rep


def combine_of(torch, cands, w):
    """The stacked all-reduce's combine of ``cands`` under weights ``w``, as
    a tree like one candidate: the trust-normalized sum, the uniform mean
    if every weight is 0 (the reference's ``tensordot``)."""
    from repro_torch.distributed.robust_allreduce import _map

    K = w.shape[0]
    wn = w / w.sum() if float(w.sum()) > 0 else torch.full((K,), 1.0 / K, device=w.device)
    return _map(lambda v: torch.tensordot(wn, v, dims=([0], [0])), cands)


def hold_stacked_route(torch, label, cfg, cands, state, route, ref) -> tuple:
    """One stacked all-reduce route's (out, weights, masks) against the
    reference route's on the same candidates and state: masks bit-equal (or
    for Multi-Krum the weights), or each differing decision a near-tie by
    ``NEAR_TIE`` on the reference route's statistics (reported; the route's
    output then the combine of its own weights); the other candidates'
    weights within ``STACK_W_TOL``; without a near-tie the outputs within
    rtol ``STACK_RTOL`` / atol ``STACK_ATOL``.  ``cfg`` is the reference
    route's; the outputs are flat vectors or trees (``close_leafwise``).
    Returns (the near-ties' (candidate, filter, margin) list, the largest
    output difference or None at a near-tie)."""
    o2, w2, m2 = route
    o, w, masks = ref
    flips = [(k, bit) for bit, name in enumerate(("mask_d", "mask_c", "mask_t"))
             if name in masks for k in (masks[name] != m2[name]).nonzero().flatten().tolist()]
    if cfg.method == "multi_krum":
        flips = [(k, 0) for k in (w != w2).nonzero().flatten().tolist()]
    keep = torch.ones(w.shape[0], dtype=torch.bool, device="cuda")
    rep = []
    if flips:
        rep = stacked_margins(torch, cfg, cands, state, flips)
        print(f"  {label}: decisions differ at (candidate, filter, margin) {rep}")
        if not all(m is not None and m <= NEAR_TIE for _, _, m in rep):
            raise AssertionError(f"{label}: decisions differ away from any edge")
        keep[[k for k, _ in flips]] = False
        # the route's output is the combine of its own weights
        close_leafwise(torch, o2, combine_of(torch, cands, w2), STACK_RTOL, STACK_ATOL)
    torch.testing.assert_close(w2[keep], w[keep], rtol=0, atol=STACK_W_TOL)
    if flips:
        return rep, None
    return rep, close_leafwise(torch, o2, o, STACK_RTOL, STACK_ATOL)


def run_stacked_path(torch) -> tuple:
    """``robust_allreduce_stacked`` over K=8 Qwen1.5-0.5B-shaped candidates
    (2 under IPM-100), ``STACK_ROUNDS`` rounds with WFAgg-T state, for each method on
    each backend.  Counts each backend's launches over its rounds (the
    main path: kernel 1 on ``fused`` wfagg/alt_wfagg, kernel 4 (+ kernel 6
    where a rule reads the Gram) on the two-launch route), and holds the
    backends to each other: weights within 3e-5, outputs within rtol 1e-4 /
    atol 3e-5, masks bit-equal or near-ties with their margins.  Returns
    (launches, report, the base parameters)."""
    from repro_torch.distributed import robust_allreduce as ra

    base = stack_base(torch)
    P = sum(v.numel() for v in base.values())
    print(f"  {STACK_ARCH}: P = {P} parameters in {len(base)} leaves, K = {STACK_K}: "
          f"K*P = {STACK_K * P} (2^31 = {2 ** 31})")
    if STACK_K * P <= 2 ** 31:
        raise AssertionError("the stacked candidates hold no more than 2^31 values")
    launches = dict.fromkeys(KERNELS, 0)
    report = {"P": P}
    for method in STACK_METHODS:
        kept = {}       # backend -> round -> (host out, weights, masks)
        for backend in STACK_BACKENDS:
            cfg = stack_cfg(method, backend)
            state = (ra.init_tree_agg_state(cfg, STACK_K, base)
                     if method in ("wfagg", "alt_wfagg") else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, counts_total, flips_seen = [], dict.fromkeys(KERNELS, 0), []
            for r in range(STACK_ROUNDS):
                cands = stack_candidates(torch, base, r)
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                out, new_state, info = ra.robust_allreduce_stacked(cands, cfg, state)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                for k, c in read_counts().items():
                    counts_total[k] += c
                o = flat_of(torch, out)
                if not torch.isfinite(o).all():
                    raise AssertionError(f"stacked {method} {backend} round {r}: "
                                         "non-finite output")
                masks = {k: info[k] for k in ("mask_d", "mask_c", "mask_t") if k in info}
                if backend != "reference":
                    kept.setdefault(backend, {})[r] = (o.cpu(), info["weights"], masks)
                else:
                    for other, rounds in kept.items():
                        o2, w2, m2 = rounds[r]
                        rep, err = hold_stacked_route(
                            torch, f"stacked {method} round {r} {other} vs reference",
                            cfg, cands, state, (o2.to("cuda"), w2, m2),
                            (o, info["weights"], masks))
                        if rep:
                            flips_seen.append((r, other, rep))
                        if err is not None:
                            report[f"max_out_err_{method}"] = max(
                                report.get(f"max_out_err_{method}", 0.0), err)
                state, new_state = new_state, None
                del cands, out, o, info
            peak = torch.cuda.max_memory_allocated()
            want = dict.fromkeys(KERNELS, 0)
            if backend == "fused" and method in ("wfagg", "alt_wfagg"):
                want["wfagg_round_indexed"] = STACK_ROUNDS
            elif backend != "reference" and method in ("wfagg", "alt_wfagg", "multi_krum"):
                want["robust_stats"] = STACK_ROUNDS
                if method != "wfagg":
                    want["pairwise_gram"] = STACK_ROUNDS
            if counts_total != want:
                raise AssertionError(f"stacked {method} on {backend}: launches "
                                     f"{counts_total}, expected {want}")
            for k in KERNELS:
                launches[k] += counts_total[k]
            report[f"{method}/{backend}"] = dict(ms=ms, peak_gib=peak / 2 ** 30,
                                                 near_ties=flips_seen)
            print(f"  stacked {method:10s} {backend:16s}: ms per round "
                  f"{[round(t, 1) for t in ms]}, peak {peak / 2 ** 30:.2f} GiB, "
                  f"launches {({k: c for k, c in counts_total.items() if c})}")
            del state
            torch.cuda.empty_cache()
        print(f"  stacked {method}: fused and fused_two_launch == reference over "
              f"{STACK_ROUNDS} rounds (weights within {STACK_W_TOL}, outputs within rtol "
              f"{STACK_RTOL} / atol {STACK_ATOL}, masks bit-equal but the near-ties "
              "above)")
    return launches, report, base


def chunked_plain_stats(torch, flat, prev):
    """Kernel 4's plain version over (K, P) in column chunks (the sums of
    the chunks' sums): the unchunked plain version would sort all of it at
    once, more than the card holds beside its inputs."""
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import RobustStats

    tot = None
    for a in range(0, flat.shape[1], PLAIN_CHUNK):
        st = rops.robust_stats_plain(flat[:, a:a + PLAIN_CHUNK], prev[:, a:a + PLAIN_CHUNK],
                                     need_center=False)
        f = [st.dist2, st.dotmed, st.norm2, st.mednorm2, st.prev_dist2, st.prev_dot,
             st.prev_norm2]
        tot = f if tot is None else [x + y for x, y in zip(tot, f)]
    return RobustStats(None, None, *tot)


def chunked_plain_round(torch, local, flat, prev, nidx, v, tb, cfg):
    """Kernel 1's plain version at N=1 over (K, P) in column chunks: the
    indexed statistics summed chunk by chunk, the scoring stage, the
    ``mean_fallback`` coefficients and the slot-order combine per chunk."""
    from repro_torch.core import trust
    from repro_torch.kernels.robust_stats.ref import RobustStats, robust_stats_indexed_ref
    from repro_torch.kernels.weighted_agg.ops import weighted_agg_indexed_plain

    tot = None
    for a in range(0, flat.shape[1], PLAIN_CHUNK):
        st = robust_stats_indexed_ref(flat[:, a:a + PLAIN_CHUNK].contiguous(), nidx, v,
                                      prev[:, a:a + PLAIN_CHUNK].contiguous())
        f = [st.dist2, st.dotmed, st.norm2, st.mednorm2, st.prev_dist2, st.prev_dot,
             st.prev_norm2]
        tot = f if tot is None else [x + y for x, y in zip(tot, f)]
    stats = RobustStats(None, None, *tot)
    md, mc, mt, w = trust.derive_trust_weights(stats, v, tb, cfg)
    wcomb, lcoef = trust.combine_coefficients(w, 1.0, v, True)
    out = torch.cat([weighted_agg_indexed_plain(
        wcomb, lcoef, local[:, a:a + PLAIN_CHUNK], flat[:, a:a + PLAIN_CHUNK], nidx)
        for a in range(0, flat.shape[1], PLAIN_CHUNK)], dim=1)
    return out, w, md, mc, mt, stats


def check_stacked_kernels(torch, base) -> tuple:
    """Kernels 1, 4 and 6 at the stacked all-reduce's launch shape, (K=8,
    P) with K*P > 2^31, against their plain versions (computed in column
    chunks) on rounds 1 and 2's candidates (``prev`` round 1's), then
    timed with their bounds: kernel 1 at N=1 on the identity slate with
    ``alpha=1`` and ``mean_fallback`` (the bands jittered around the
    candidates' own temporal metrics, so WFAgg-T accepts some and rejects
    others) beside the two-launch route (kernel 4 + the contraction);
    kernel 4 with prev; kernel 6 beside ``torch.mm``.  Then the
    ``mean_fallback`` branch: every candidate rejected gives the uniform
    mean, equal to the plain version.  Returns (errs, timed)."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.kernels.pairwise_dist import kernel as pk
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats.ref import RobustStats

    K = STACK_K
    pflat = ra._concat_candidates(stack_candidates(torch, base, 1))
    flat = ra._concat_candidates(stack_candidates(torch, base, 2))
    P = flat.shape[1]
    errs, timed = {}, {}
    # kernel 4 with prev
    got = rk.robust_stats_cuda(flat, pflat, 0.1, False)
    t0 = time.perf_counter()
    want = chunked_plain_stats(torch, flat, pflat)
    torch.cuda.synchronize()
    plain4 = 1e3 * (time.perf_counter() - t0)
    errs["robust_stats"] = assert_stats_close(torch, got, want, STAT_FIELDS)
    # kernel 6
    gram, norm2 = pk.pairwise_gram_cuda(flat)
    t0 = time.perf_counter()
    gram_p = flat @ flat.T
    torch.cuda.synchronize()
    plain6 = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(gram, gram.T) or not torch.equal(torch.diagonal(gram), norm2):
        raise AssertionError("pairwise_gram at (8, P): not exactly symmetric, or norm2 "
                             "not its diagonal")
    # float32 sums over 4.6e8 coordinates: both the kernel and cuBLAS are
    # held to the Gram summed in float64 (chunk by chunk)
    gram64 = sum(flat[:, a:a + PLAIN_CHUNK].double() @ flat[:, a:a + PLAIN_CHUNK].double().T
                 for a in range(0, P, PLAIN_CHUNK))
    rel = lambda g: float(((g.double() - gram64).abs() / gram64.abs()).max())  # noqa: E731
    print(f"  kernel 6 at (8, P): largest relative difference from the float64 Gram "
          f"{rel(gram):.3g} (flat @ flat.T in float32: {rel(gram_p):.3g})")
    torch.testing.assert_close(gram.double(), gram64, rtol=1e-4, atol=1e-6 * P)
    errs["pairwise_gram"] = float((gram.double() - gram64).abs().max())
    # kernel 1 at N = 1: the bands jittered around the candidates' own
    # temporal metrics (kernel 4's plain statistics, as one node's)
    cfg = WFAggConfig(window=3, transient=1, alpha=1.0)
    nidx = torch.arange(K, device="cuda")[None]
    v = torch.ones((1, K), dtype=torch.bool, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(81)
    one = RobustStats(None, None, *(getattr(want, f)[None] for f in STAT_FIELDS))
    tb = jittered_bands(torch, one, g, cfg)
    local = torch.zeros((1, P), device="cuda")
    got = rk.wfagg_round_indexed_cuda(local, flat, nidx.int(), v, pflat, tb, cfg, 1.0, True)
    t0 = time.perf_counter()
    want1 = chunked_plain_round(torch, local, flat, pflat, nidx, v, tb, cfg)
    torch.cuda.synchronize()
    plain1 = 1e3 * (time.perf_counter() - t0)
    err, n_ties = hold_round(torch, "kernel 1 N=1 K=8 D=P (Qwen1.5-0.5B)", got, want1, v,
                             tb, cfg, local, flat, nidx)
    errs["wfagg_round_indexed"] = err
    print(f"  kernel 1 at N=1, K=8, D={P} (K*D = {K * P}), alpha=1, mean_fallback: masks "
          f"{[int(m.sum()) for m in got[2:5]]} accepted (D, C, T) bit-equal"
          f"{tie_note(n_ties)}, out max|err| {err:.3g}; kernel 4 with prev: sums within "
          f"rtol {STAT_RTOL}, max|err| {errs['robust_stats']:.3g}; kernel 6: exactly "
          f"symmetric, within rtol 1e-4 of the float64 Gram, max|err| "
          f"{errs['pairwise_gram']:.3g}")
    # times (CUDA events), bounds
    i32 = nidx.int()
    ms1 = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
        local, flat, i32, v, pflat, tb, cfg, 1.0, True), 1, 3)
    ms4 = time_cuda(torch, lambda: rk.robust_stats_cuda(flat, pflat, 0.1, False), 1, 3)
    w = got[1][0] / got[1][0].sum().clamp(min=1e-12)
    ms_mv = time_cuda(torch, lambda: w @ flat, 1, 3)
    ms6 = time_cuda(torch, lambda: pk.pairwise_gram_cuda(flat), 1, 3)
    lib6 = time_cuda(torch, lambda: torch.mm(flat, flat.t()), 1, 3)
    b1 = bound(4.0 * (2 * K * P + 2 * P), 16.0 * K * P)
    b4 = bound(4.0 * 2 * K * P, P * (2.0 * network_compare_exchanges(K) + 15.0 * K))
    b6 = bound(4.0 * K * P, float(K * (K + 1)) * P)
    shape = f"N=1 K={K} D={P}"
    timed["wfagg_round_indexed"] = dict(shape=shape, ms=ms1, plain_ms=plain1,
                                        bound_ms=b1[0], bound_by=b1[1], library_ms=None,
                                        two_launch_ms=ms4 + ms_mv)
    timed["robust_stats"] = dict(shape=f"K={K} D={P} prev", ms=ms4, plain_ms=plain4,
                                 bound_ms=b4[0], bound_by=b4[1], library_ms=None)
    timed["pairwise_gram"] = dict(shape=f"K={K} D={P}", ms=ms6, plain_ms=plain6,
                                  bound_ms=b6[0], bound_by=b6[1], library_ms=lib6)
    for name, t in timed.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.3f} ms"
        print(f"  {name} {t['shape']}: kernel {t['ms']:.3f} ms, plain (chunked) "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}), "
              f"library {lib}")
    print(f"  the stacked round at N=1: one launch of kernel 1 {ms1:.3f} ms against the "
          f"two-launch route {ms4 + ms_mv:.3f} ms (kernel 4 {ms4:.3f} ms + the "
          f"contraction {ms_mv:.3f} ms)")
    del flat, pflat, got, want1, local
    torch.cuda.empty_cache()
    errs["wfagg_round_indexed"] = max(errs["wfagg_round_indexed"],
                                      check_mean_fallback(torch))
    return errs, timed


def check_mean_fallback(torch) -> float:
    """Kernel 1's ``mean_fallback`` branch at N=1, K=8, D=2^22: WFAgg-D and
    WFAgg-C keep one candidate each (f = K - 2), not the same one, and
    WFAgg-T has no prev, so every candidate is rejected; the output must be
    the uniform mean of the candidates and equal the plain version."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops

    K, D = STACK_K, 1 << 22
    g = torch.Generator(device="cuda").manual_seed(82)
    m0 = torch.randn((D,), generator=g, device="cuda")
    noise = lambda s: m0 + s * torch.randn((D,), generator=g, device="cuda")  # noqa: E731
    u = torch.stack([noise(0.3), 3.0 * m0] + [noise(2.0) for _ in range(K - 2)])
    cfg = WFAggConfig(f=K - 2, alpha=1.0)
    nidx = torch.arange(K, device="cuda")[None]
    v = torch.ones((1, K), dtype=torch.bool, device="cuda")
    local = torch.zeros((1, D), device="cuda")
    before = rk.launches
    got = ops.wfagg_round_indexed(local, u, nidx, v, cfg, alpha=1.0, mean_fallback=True)
    want = ops.wfagg_round_indexed_plain(local, u, nidx, v, cfg, alpha=1.0,
                                         mean_fallback=True)
    torch.cuda.synchronize()
    if rk.launches != before + 1:
        raise AssertionError("mean_fallback: the round kernel did not launch")
    md, mc = got[2][0], got[3][0]
    if float(got[1].sum()) != 0.0 or not (md.any() and mc.any()) or (md & mc).any():
        raise AssertionError(f"mean_fallback: not every candidate rejected: weights "
                             f"{got[1].tolist()}, mask_d {md.tolist()}, mask_c {mc.tolist()}")
    for a, b in zip(got[1:5], want[1:5]):
        if not torch.equal(a, b):
            raise AssertionError("mean_fallback: masks or weights differ from the plain "
                                 "version")
    torch.testing.assert_close(got[0], want[0], rtol=OUT_TOL, atol=OUT_TOL)
    torch.testing.assert_close(got[0][0], u.mean(0), rtol=1e-6, atol=1e-6)
    err = float((got[0] - want[0]).abs().max())
    print(f"  kernel 1 mean_fallback at N=1 K={K} D=2^22: every candidate rejected "
          f"(WFAgg-D keeps {md.nonzero().flatten().tolist()}, WFAgg-C "
          f"{mc.nonzero().flatten().tolist()}), out the uniform mean within 1e-6 and "
          f"within {OUT_TOL} of the plain version, max|err| {err:.3g}")
    return err


def run_distributed(torch) -> tuple:
    """The distributed phase: kernels 2 and 3 at the per-shard shapes
    against their plain versions and timed; the ``gloo`` ranks (round,
    scan, engine); S=1 on ``nccl``; the stacked all-reduce over
    Qwen1.5-0.5B-shaped candidates; kernels 1, 4 and 6 at its shape.
    Returns (launches on the distributed main paths, errs, timed)."""
    errs = check_shard_kernels(torch)
    shard_timed = time_shard_kernels(torch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(torch, "gloo", SHARDS)
    print(f"  {SHARDS} gloo ranks on the one card done in "
          f"{time.perf_counter() - t0:.1f} s (spawn, CUDA start and all parts)")
    launches, rep = report_ranks(ranks, SHARDS, "gloo")
    for k, c in run_nccl_one_rank(torch).items():
        launches[k] += c
    torch.cuda.empty_cache()
    print(f"  the stacked all-reduce: {STACK_ARCH} at full width and depth, K={STACK_K} "
          f"candidates ({len(STACK_MALICIOUS)} under ipm_100), {STACK_ROUNDS} rounds, "
          f"methods {STACK_METHODS} on {STACK_BACKENDS}")
    stack_launches, stack_report, base = run_stacked_path(torch)
    for k in KERNELS:
        launches[k] += stack_launches[k]
    stack_errs, stack_timed = check_stacked_kernels(torch, base)
    del base
    torch.cuda.empty_cache()
    for k, e in stack_errs.items():
        errs.setdefault(k, []).append(e)
    timed = {k: dict(t, launches=stack_launches[k]) for k, t in stack_timed.items()}
    n2 = launches["robust_stats_indexed"]
    timed["robust_stats_indexed"] = dict(
        shard_timed["robust_stats_indexed"], shape=f"M=N={SHARD_N} K={SHARD_K} "
        f"d/S={SHARD_D // SHARDS} prev + Gram", launches=n2,
        without_gram=shard_timed["robust_stats_indexed_no_gram"],
        paper_shards={m: shard_timed[f"robust_stats_indexed_{m}"] for m in SHARD_WIDTHS},
        round_ms={n: rep[f"round_{n}"]["ms"] for n in ("wfagg", "alt_wfagg")},
        psum_ms=rep["psum_ms"], out_gather_ms=rep["out_gather_ms"],
        unsharded_round_ms={n: rep[f"round_{n}"]["unsharded_ms"]
                            for n in ("wfagg", "alt_wfagg")})
    timed["weighted_agg_indexed"] = dict(
        shard_timed["weighted_agg_indexed"], shape=f"N={SHARD_N} K={SHARD_K} "
        f"d/S={SHARD_D // SHARDS}", launches=launches["weighted_agg_indexed"],
        paper_shards={m: shard_timed[f"weighted_agg_indexed_{m}"] for m in SHARD_WIDTHS})
    timed["stacked"] = stack_report
    return launches, errs, timed


# ---------------------------------------------------------------------------
# phase 3: the robust-DP trainer (train/trainer.py, launch/train.py)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
# the one-card trainer's depth: 4 of Qwen's 24 layers at full width (uncut
# until the bf16 / pad-slot part, then 12, then 4, the whole script's time;
# the launcher and serving stay uncut)
TRAIN_LAYERS = 4
TRAIN_K = 8                      # candidate workers, one batch row each
TRAIN_SEQ = 1025                 # S - 1 = 1024: two whole loss chunks of 512
# 5 steps before the families' model-axis part, then 4: every block is
# rematerialised since (a second forward a candidate); 3, then 2 beside the
# bf16 / pad-slot part, the whole script's time
TRAIN_STEPS = 2
# the families' one-card training runs (run_lm_train): cut from 5 steps to 2
# beside the families' model-axis part, the whole script's time
LM_TRAIN_STEPS = 2
TRAIN_LR = 1e-3
TRAIN_MALICIOUS = 2              # spaced_malicious(8, 2): candidates 2 and 6
TRAIN_ATTACK = "ipm_100"
FLAT_LAYERS = 2                  # the flat layout: Qwen width, depth cut to 2
FLAT_K = 4                       # gloo ranks on the one card
FLAT_STEPS = 3
FLAT_W_TOL, FLAT_OUT_TOL = 1e-6, 2e-4   # tests/_spmd_parity_main.py


def train_config(method, layout="stacked", **kw):
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.distributed.robust_allreduce import RobustAggConfig
    from repro_torch.train.trainer import TrainConfig

    wfagg = kw.pop("wfagg", WFAggConfig(f=2, transient=3, window=3))
    return TrainConfig(agg=RobustAggConfig(method=method, layout=layout, backend="fused",
                                           wfagg=wfagg),
                       lr=TRAIN_LR, warmup=0, total_steps=TRAIN_STEPS, **kw)


class TrainObserver:
    """The trainer's ``observe`` hook on the card: each phase's ms (host
    clock between ``torch.cuda.synchronize()`` calls) and, when ``hold``,
    the stacked all-reduce's other backends at every step: after the
    attack, ``fused_two_launch`` and ``reference`` aggregate the same
    candidates from the step's state (its ``prev``, their own copies of
    the history); after the all-reduce, both are held to each other and
    the trajectory's ``fused`` route by ``hold_stacked_route``.  The
    hold's own time is left out of every phase."""

    ROUTES = ("fused_two_launch", "reference")

    def __init__(self, torch, tc, agg_state, hold):
        self.torch, self.tc, self.hold = torch, tc, hold
        self.hist = ({b: tuple(getattr(agg_state, f).clone() for f in
                               ("hist_s", "hist_b", "count", "t")) for b in self.ROUTES}
                     if hold else None)
        self.steps, self.peaks, self.near_ties, self.max_err = [], [], [], 0.0

    def start(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self.cur = {}
        self.t = time.perf_counter()

    def __call__(self, phase, **v):
        torch = self.torch
        torch.cuda.synchronize()
        self.cur[phase] = 1e3 * (time.perf_counter() - self.t)
        if phase == "optimizer":
            self.steps.append(self.cur)
            self.peaks.append(round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
        elif self.hold and phase == "attack":
            self.routes(v["candidates"], v["agg_state"])
        elif self.hold and phase == "allreduce":
            self.compare(v["grads"], v["info"])
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def routes(self, cands, state):
        import dataclasses

        from repro_torch.distributed import robust_allreduce as ra

        self.cands, self.state, self.out = cands, state, {}
        for b in self.ROUTES:
            st = ra.TreeAggState(state.prev, *self.hist[b])
            o, ns, info = ra.robust_allreduce_stacked(
                cands, dataclasses.replace(self.tc.agg, backend=b), st)
            self.hist[b] = (ns.hist_s, ns.hist_b, ns.count, ns.t)
            self.out[b] = (o, info["weights"],
                           {k: info[k] for k in ("mask_d", "mask_c", "mask_t")})
            del o

    def compare(self, grads, info):
        import dataclasses

        step = len(self.steps)
        ref = self.out.pop("reference")
        routes = dict(self.out, fused=(grads, info["weights"],
                                       {k: info[k] for k in ("mask_d", "mask_c", "mask_t")}))
        cfg = dataclasses.replace(self.tc.agg, backend="reference")
        for name, route in routes.items():
            rep, err = hold_stacked_route(
                self.torch, f"train {cfg.method} step {step + 1} {name} vs reference", cfg,
                self.cands, self.state, route, ref)
            if rep:
                self.near_ties.append((step + 1, name, rep))
            if err is not None:
                self.max_err = max(self.max_err, err)
        self.out, self.cands, self.state = {}, None, None


def train_run(torch, cfg, tc, mesh, batches, hold, probe=None) -> dict:
    """``TRAIN_STEPS`` steps of ``build_train_step`` from the seed-0 state,
    the launches counted from 0 over them; returns the run's losses,
    weights, ms per phase, tokens/s, peak memory and the hold's findings
    (and ``probe(state, batch)`` before each step, untimed, as ``probes``)."""
    from repro_torch.train import trainer as tr

    state = tr.init_train_state(cfg, tc, torch.Generator(device="cuda").manual_seed(0),
                                mesh)
    obs = TrainObserver(torch, tc, state.agg_state, hold)
    step = tr.build_train_step(cfg, tc, mesh, observe=obs)
    losses, weights, probes = [], [], []
    zero_counts()
    for batch in batches:
        if probe is not None:
            probes.append(probe(state, batch))
        obs.start()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        weights.append([round(float(w), 4) for w in m["weights"]])
    counts = read_counts()
    ms = [{k: round(v, 2) for k, v in s.items()} for s in obs.steps]
    tokens = batches[0]["tokens"].numel()
    del state, step
    torch.cuda.empty_cache()
    return dict(losses=losses, weights=weights, ms=ms,
                tokens_per_s=[round(1e3 * tokens / sum(s.values()), 1) for s in obs.steps],
                peak_gib=obs.peaks, launches={k: c for k, c in counts.items() if c},
                counts=counts, near_ties=obs.near_ties, max_out_err=obs.max_err,
                **({"probes": probes} if probe is not None else {}))


def train_peak_memory(torch, cfg, mesh, batch) -> dict:
    """Peak memory of one ``fused`` WFAgg step (no hold) with the candidates
    and ``prev`` read as one (K, P) matrix, and with the two (K, P) copies
    the fused route made before (``_one_matrix`` patched to find none)."""
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.train import trainer as tr

    tc = train_config("wfagg", attack=TRAIN_ATTACK, n_malicious=TRAIN_MALICIOUS)
    out = {}
    one_matrix = ra._one_matrix
    try:
        for name in ("views", "copies"):
            ra._one_matrix = one_matrix if name == "views" else (lambda leaves: None)
            state = tr.init_train_state(cfg, tc, torch.Generator(device="cuda").manual_seed(0),
                                        mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, _ = tr.build_train_step(cfg, tc, mesh)(state, batch)
            torch.cuda.synchronize()
            out[name] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
            del state
            torch.cuda.empty_cache()
    finally:
        ra._one_matrix = one_matrix
    return out


def train_trace(torch, cfg, mesh, batches) -> dict:
    """One steady ``fused`` WFAgg step (the second, no hold) under a
    ``torch.profiler`` capture: its device kernels summed by name, the top
    eight, and the device's busy share of the step."""
    import tempfile

    from repro_torch.obs import profile
    from repro_torch.train import trainer as tr

    tc = train_config("wfagg", attack=TRAIN_ATTACK, n_malicious=TRAIN_MALICIOUS)
    state = tr.init_train_state(cfg, tc, torch.Generator(device="cuda").manual_seed(0), mesh)
    step = tr.build_train_step(cfg, tc, mesh)
    state, _ = step(state, batches[0])
    with tempfile.TemporaryDirectory() as tmp:
        with profile.capture(tmp):
            with profile.annotate("train step 2"):
                state, _ = step(state, batches[1])
                torch.cuda.synchronize()
        out = trace_round(torch, f"{tmp}/{profile.TRACE_FILE}", "train step 2", top=8)
    del state, step
    torch.cuda.empty_cache()
    return out


def train_flat_child(rank, S, store_path, out_dir, backend) -> None:
    """One rank of the flat layout's training run: ``FLAT_STEPS`` steps of
    the flat robust-DP step on the ``gloo`` group of S ranks (this rank's
    candidate, its batch row), every rank's parameters hashed after each
    step and compared; rank 0 also steps the one-process emulation
    (``Emulated(S)``) from the same start and holds each step's all-reduce
    to it (weights within 1e-6, the aggregated gradient within 2e-4)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flatten import flat_buffer
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import trainer as tr

    torch.cuda.set_device(0)
    res = {"rank": rank}
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path, S), rank=rank,
                                world_size=S)
        try:
            cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=FLAT_LAYERS)
            tc = train_config("wfagg", layout="flat", attack="alie", n_malicious=1,
                              wfagg=WFAggConfig(f=1, transient=1, window=2))
            runs = [(make_test_mesh(data=S, group=dist.group.WORLD), {})]
            if rank == 0:
                runs.append((make_test_mesh(data=S), {}))
            steps = []
            for mesh, seen in runs:
                state = tr.init_train_state(
                    cfg, tc, torch.Generator(device="cuda").manual_seed(0), mesh)
                fn = tr.build_train_step(cfg, tc, mesh,
                                         observe=lambda p, seen=seen, **v: seen.update({p: v}))
                steps.append([state, fn, seen])
            stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, S)
            ms, report = [], []
            for i in range(FLAT_STEPS):
                batch = stream.batch(i, device="cuda")
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[0][0], m = steps[0][1](steps[0][0], batch)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                same_on_ranks(torch, dist, f"flat step {i + 1} parameters",
                              digest(torch, flat_buffer(steps[0][0].params)))
                if rank == 0:
                    steps[1][0], m_e = steps[1][1](steps[1][0], batch)
                    got, emu = steps[0][2]["allreduce"], steps[1][2]["allreduce"]
                    for k in ("mask_d", "mask_c", "mask_t"):
                        if not torch.equal(got["info"][k], emu["info"][k]):
                            raise AssertionError(f"flat step {i + 1}: {k} differs from the "
                                                 "emulation")
                    torch.testing.assert_close(got["info"]["weights"], emu["info"]["weights"],
                                               rtol=0, atol=FLAT_W_TOL)
                    torch.testing.assert_close(got["grads"], emu["grads"], rtol=FLAT_OUT_TOL,
                                               atol=FLAT_OUT_TOL)
                    report.append(dict(
                        loss=float(m["loss"]), loss_emulated=float(m_e["loss"]),
                        weights=[round(float(w), 4) for w in m["weights"]],
                        max_out_err=float((got["grads"] - emu["grads"]).abs().max()),
                        masks_dct=[int(got["info"][k].sum()) for k in
                                   ("mask_d", "mask_c", "mask_t")]))
            res.update(ms=ms, report=report, P=flat_buffer(steps[0][0].params).numel())
        finally:
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 - the parent fails the run on it
        import traceback
        res["error"] = traceback.format_exc()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def run_launcher(torch) -> dict:
    """``repro_torch.launch.train.main`` at full width, ``TRAIN_LAYERS``
    layers (uncut until the bf16 / pad-slot part): 8 candidates, the
    ``fused`` backend, 2 steps at S = 1025 under IPM-100, a checkpoint into
    a temporary directory; its printed lines checked.  Returns its
    launches and output."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train as launcher

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    buf = io.StringIO()
    try:
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            launcher.main(["--arch", TRAIN_ARCH, "--n-layers", str(TRAIN_LAYERS),
                           "--candidates", str(TRAIN_K),
                           "--agg-backend", "fused", "--steps", "2",
                           "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_K),
                           "--attack", TRAIN_ATTACK, "--n-malicious", str(TRAIN_MALICIOUS),
                           "--log-every", "1", "--ckpt-dir", tmp, "--ckpt-every", "2"])
        secs = time.perf_counter() - t0
        counts = read_counts()
        out = buf.getvalue()
        lines = out.strip().splitlines()
        ckpt = pathlib.Path(tmp, "step_2.npz")
        if not (lines[0].startswith(f"arch={TRAIN_ARCH}") and "step     2" in out
                and lines[-1].startswith("done: 2 steps") and ckpt.exists()):
            raise AssertionError(f"launcher: unexpected output or no checkpoint:\n{out}")
        ckpt_gib = ckpt.stat().st_size / 2 ** 30
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if counts != only_counts(wfagg_round_indexed=2):
        raise AssertionError(f"launcher: launches {counts}, expected 2 of kernel 1")
    for line in lines:
        print(f"    | {line}")
    print(f"  launcher: {secs:.1f} s with set-up, checkpoint step_2.npz "
          f"{ckpt_gib:.2f} GiB, launches {({k: c for k, c in counts.items() if c})}")
    return dict(counts=counts, seconds=secs, lines=lines)


def run_train_path(torch, flat_ranks=True) -> tuple:
    """The trainer on the card: stacked WFAgg and Alt-WFAgg at full width
    (the backends held at every step), the mean beside them, the peak
    memory with and without the (K, P) views, the flat layout on ``gloo``
    ranks (with ``flat_ranks``), the launcher.  Returns (launches on the
    main paths, report)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.topology import spaced_malicious
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import make_test_mesh

    import dataclasses

    card = gpu_line()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    mesh = make_test_mesh(data=TRAIN_K)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_K)
    batches = [stream.batch(i, device="cuda") for i in range(TRAIN_STEPS)]
    bad = spaced_malicious(TRAIN_K, TRAIN_MALICIOUS).nonzero()[0].tolist()
    launches = dict.fromkeys(KERNELS, 0)
    report = {"card": card}
    print(f"  {card}: {TRAIN_ARCH} at {TRAIN_LAYERS} of 24 layers (d_model 1024, vocab 151,936; "
          "seed 0), "
          f"K={TRAIN_K} candidates of one row at S={TRAIN_SEQ}, candidates {bad} under "
          f"{TRAIN_ATTACK}, AdamW lr {TRAIN_LR}, warmup 0, {TRAIN_STEPS} steps")
    for method in ("wfagg", "alt_wfagg", "mean"):
        tc = train_config(method, attack=TRAIN_ATTACK, n_malicious=TRAIN_MALICIOUS)
        hold = method != "mean"
        r = train_run(torch, cfg, tc, mesh, batches, hold)
        want = only_counts() if not hold else only_counts(
            wfagg_round_indexed=TRAIN_STEPS, robust_stats=TRAIN_STEPS,
            pairwise_gram=TRAIN_STEPS if method == "alt_wfagg" else 0)
        if r["counts"] != want:
            raise AssertionError(f"train {method}: launches {r['counts']}, expected {want}")
        for k in KERNELS:
            launches[k] += r["counts"][k]
        if not all(map(math.isfinite, r["losses"])):
            raise AssertionError(f"train {method}: non-finite loss {r['losses']}")
        if hold and any(w[k] != 0.0 for w in r["weights"] for k in bad):
            raise AssertionError(f"train {method}: an attacker got weight: {r['weights']}")
        del r["counts"]
        report[method] = r
        print(f"  stacked {method:9s}: loss per step {[round(x, 4) for x in r['losses']]}, "
              f"weights {r['weights']}")
        phases = [[s.get(p) for p in ("grads", "attack", "allreduce", "optimizer")]
                  for s in r["ms"]]
        print(f"    ms per step (grads / attack / all-reduce / optimizer): {phases}"
              f"; tokens/s {r['tokens_per_s']}; peak GiB per step {r['peak_gib']} (the "
              f"hold's included); "
              f"launches {r['launches']}")
        if hold:
            print(f"    fused and fused_two_launch held to reference at every step (weights "
                  f"within {STACK_W_TOL}, outputs within rtol {STACK_RTOL} / atol "
                  f"{STACK_ATOL}, max|diff| {r['max_out_err']:.3g}); near-ties "
                  f"{r['near_ties'] or 'none'}")
    w, mean = report["wfagg"]["losses"], report["mean"]["losses"]
    if not (w[-1] < w[0] and w[-1] < mean[-1]):
        raise AssertionError(f"train: WFAgg's step-{TRAIN_STEPS} loss {w[-1]} is not below "
                             f"its first {w[0]} and the mean's {mean[-1]}")
    print(f"  the paper's claim at trainer scale: WFAgg's loss {w[0]:.4f} -> {w[-1]:.4f}, "
          f"the mean's {mean[0]:.4f} -> {mean[-1]:.4f} under {TRAIN_ATTACK}")
    report["trace"] = train_trace(torch, cfg, mesh, batches)
    report["peak_gib_one_step"] = train_peak_memory(torch, cfg, mesh, batches[0])
    print(f"  peak memory of one fused WFAgg step: {report['peak_gib_one_step']['views']} GiB "
          f"reading the (K, P) buffers, {report['peak_gib_one_step']['copies']} GiB with "
          "the two (K, P) copies")
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    if flat_ranks:
        print(f"  before the flat layout's ranks this process holds "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
              f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved)")
        report["flat"] = run_flat_ranks(torch)
    r = run_launcher(torch)
    for k in KERNELS:
        launches[k] += r["counts"][k]
    report["launcher"] = dict(seconds=r["seconds"], lines=r["lines"])
    return launches, report


def run_flat_ranks(torch) -> dict:
    """The flat layout on ``FLAT_K`` ``gloo`` ranks (``train_flat_child``);
    returns rank 0's times and steps."""
    t0 = time.perf_counter()
    ranks = run_ranks(torch, "gloo", FLAT_K, child=train_flat_child)
    r0 = ranks[0]
    flat = dict(ms=r0["ms"], steps=r0["report"], P=r0["P"], seconds=time.perf_counter() - t0)
    print(f"  flat layout: {TRAIN_ARCH} width, depth cut to {FLAT_LAYERS} (P = {r0['P']}), "
          f"{FLAT_K} gloo ranks on the one card, wfagg with the sketch WFAgg-T, 1 of "
          f"{FLAT_K} under alie, {FLAT_STEPS} steps: parameters bit-equal on every rank "
          f"after each step, each all-reduce within weights {FLAT_W_TOL} / out "
          f"{FLAT_OUT_TOL} of the one-process emulation (max|diff| "
          f"{[round(s['max_out_err'], 9) for s in r0['report']]}), masks equal; loss "
          f"{[round(s['loss'], 4) for s in r0['report']]}, weights "
          f"{[s['weights'] for s in r0['report']]}; ms per step (rank 0) "
          f"{[round(t, 1) for t in r0['ms']]}; {flat['seconds']:.1f} s in all")
    return flat


# ---------------------------------------------------------------------------
# phase 3: the MoE family (serving DeepSeek-V2-Lite, Moonlight and Arctic;
# training an MoE through kernels 1, 4 and 6)
# ---------------------------------------------------------------------------

# (arch, depth kept or None for uncut, prefill (B, S), kernel-8 launches a
# prefill, decode steps at batch MOE_DECODE_B (prompt, greedy), hold the
# flash prefill against flash=False).  The decodes keep their 64 + 32 held
# steps: DeepSeek-V2-Lite's hold against the truth compares two largest
# differences of ~0.8, and over 16 + 8 steps its bf16 decode's came out 0.014
# past the rule (the bf16 prefill's fewer positions gave a smaller largest
# difference; PERF.md §6)
MOE_SERVE = (
    ("deepseek-v2-lite-16b", None, (1, 4096), 0, (64, 32), False),   # arXiv:2405.04434
    ("moonshot-v1-16b-a3b", 16, (2, 8192), 16, (64, 32), True),      # 1 dense + 15 MoE
    ("arctic-480b", 2, (1, 8192), 2, (8, 0), True),                  # 64 padded heads, bf16
)
MOE_DECODE_B = 2
MOE_PREFILL_REPS = 2
MOE_DECODE_TIMED = 8           # greedy steps timed after the held ones, no recorder (16
                               # until the bf16 / pad-slot part, the whole script's time)
MOE_TRAIN_ARCH = "deepseek-v2-lite-16b"
MOE_TRAIN_LAYERS = 2           # 1 dense prefix + 1 MoE block, P = 1,026,698,240
MOE_TRAIN_K = 6                # candidate workers, one batch row each


# MOE_TRUTH: bf16 routing is discontinuous and a deep MoE on the reference's
# init (expert fan-in 1/sqrt(E)) amplifies bf16 rounding: both bf16 routes of
# DeepSeek-V2-Lite uncut sit ~13% (relative rms of the logits) from the f32
# computation, each, and so ~12% from each other (PERF.md §6, an H100),
# far past the dense rule's 2e-2 that holds two routes of Qwen1.5-0.5B.  So a
# route under test is held against the f32 truth (the model in f32
# activations, routing recorded and replayed into every other route) beside
# the route it stands for: it may add at most the dense rule to that route's
# own bf16 error (``hold_against_truth``), and the f32 routes of the same
# function are held by the dense rule itself (``check_logits``).  Where the
# parameters are bf16 (Arctic) there is no f32 truth that fits beside them,
# and the bf16 routes are held to each other by the dense rule.


def logit_gap(torch, label, got, want) -> tuple:
    """Relative rms and largest difference of two logit sets, printed."""
    d = got - want
    rel = float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    big = float(d.abs().max())
    top = float((got.argmax(-1) != want.argmax(-1)).float().mean())
    print(f"  {label}: relative rms {rel:.4g}, largest difference {big:.4g}, top-1 differs "
          f"at {top:.3g} of the positions")
    return rel, big


def hold_against_truth(torch, label, got, ref_label, ref, truth) -> dict:
    """``MOE_TRUTH``'s rule: a bf16 route ``got`` of a model whose bf16
    error is large is held against the f32 truth beside a second bf16
    route ``ref`` of the same model: its relative rms and largest
    difference from the truth may exceed the second route's by at most
    the dense rule's ``LOGIT_RMS`` and ``LOGIT_ATOL``."""
    eg, mg = logit_gap(torch, f"{label} vs the truth", got, truth)
    er, mr = logit_gap(torch, f"{ref_label} vs the truth", ref, truth)
    if not (eg <= er + LOGIT_RMS and mg <= mr + LOGIT_ATOL):
        raise AssertionError(f"{label}: relative rms {eg} / largest {mg} against the truth, "
                             f"more than {LOGIT_RMS} / {LOGIT_ATOL} past {ref_label}'s "
                             f"{er} / {mr}")
    print(f"  {label}: within {LOGIT_RMS} / {LOGIT_ATOL} of {ref_label}'s own distance from "
          f"the truth (relative rms {eg:.4g} vs {er:.4g}, largest {mg:.4g} vs {mr:.4g})")
    return dict(rms=eg, largest=mg, ref_rms=er, ref_largest=mr)


class RouteRecorder:
    """While active, ``layers.moe_route`` (the router of every ``moe_fwd``
    call) is wrapped to record each call's router probabilities (B, S, E)
    and picks (B, S, k) in rank order.  With ``replay`` (one (B, S, k)
    picks tensor per call, in call order) each call routes to the given
    picks instead, its gates its own probabilities at them: the route then
    follows another route's routing decisions, so what differs between the
    two is continuous, while its own picks are recorded for
    ``routing_diff``.  Calls come in layer order (a decode step calls
    every MoE layer once)."""

    def __init__(self, replay=None):
        self.calls = []
        self.replay = None if replay is None else list(replay)

    def __enter__(self):
        from repro_torch.models import layers as L

        self.L, self.orig = L, L.moe_route

        def routed(cfg, p, x):
            probs, top, idx = self.orig(cfg, p, x)
            self.calls.append((probs, idx))
            if self.replay is None:
                return probs, top, idx
            forced = self.replay.pop(0)
            return probs, probs.gather(-1, forced), forced

        L.moe_route = routed
        return self

    def __exit__(self, *exc):
        self.L.moe_route = self.orig
        if exc[0] is None and self.replay:
            raise AssertionError(f"{len(self.replay)} replayed routings left unused")

    def per_layer(self, torch, n_moe):
        """One (probs, picks) per MoE layer, the calls of that layer joined
        along S (decode steps in order)."""
        return rec_per_layer(torch, self.calls, n_moe)


def routing_diff(torch, label, rec_a, rec_b, replayed=True) -> dict:
    """Where two routes of one model route a token differently in some MoE
    layer (route b's own picks, before a replay overrode them): each
    difference must be a near-tie.  At the first rank j where the picks
    differ, route a's gap between its j-th and (j+1)-th probabilities is at
    most twice the largest difference of the two routes' probabilities at
    that position, or no difference of the router's inputs that small
    could reorder them.  Counts set flips (another expert in the top k)
    and order swaps (the same k in another order).  ``replayed``: route b
    followed route a's routing (else its inputs drift with its own)."""
    flips = swaps = 0
    worst = 0.0
    shown = []
    for layer, ((pa, ia), (pb, ib)) in enumerate(zip(rec_a, rec_b)):
        swap = (ia != ib).any(-1)
        if not bool(swap.any()):
            continue
        flip = (ia.sort(dim=-1).values != ib.sort(dim=-1).values).any(-1)
        j = (ia != ib).int().argmax(-1)                                    # first rank
        top = pa.sort(dim=-1, descending=True).values
        gap = (top.gather(-1, j[..., None]) - top.gather(-1, j[..., None] + 1))[..., 0]
        eps = (pa - pb).abs().amax(-1)
        ratio = gap / (2 * eps).clamp_min(1e-30)
        if bool((ratio[swap] > 1).any()):
            raise AssertionError(f"{label}: layer {layer}: a routing difference whose gap "
                                 "exceeds twice the routes' probability difference")
        worst = max(worst, float(ratio[swap].max()))
        for b, s_ in flip.nonzero().tolist()[:max(0, 3 - len(shown))]:
            shown.append(f"layer {layer} row {b} pos {s_}: rank {int(j[b, s_])}, gap "
                         f"{float(gap[b, s_]):.3g}, probability difference "
                         f"{float(eps[b, s_]):.3g}")
        flips += int(flip.sum())
        swaps += int((swap & ~flip).sum())
    n = rec_a[0][1].shape[0] * rec_a[0][1].shape[1] * len(rec_a)
    how = "replays route a's" if replayed else "follows its own"
    print(f"  {label}: the routes' own routing differs at {flips} of {n} (token, layer) "
          f"picks by set and {swaps} by order only, each a near-tie (gap / (2 x probability "
          f"difference) at most {worst:.3g}){'; e.g. ' + '; '.join(shown) if shown else ''}; "
          f"route b {how} routing")
    return dict(token_layers=n, set_flips=flips, order_swaps=swaps, worst_gap_ratio=worst)


def moe_model(torch, name, n_layers):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    info = dict(params=n, param_gib=round(nbytes / 2 ** 30, 2), init_s=round(secs, 2),
                init_peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    print(f"  {name}{f' cut to {n_layers} layers' if n_layers else ' uncut'}: "
          f"{cfg.n_layers} layers ({M._n_prefix(cfg)} dense prefix), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim_}"
          f"{f' padded to {cfg.pad_heads_to}' if cfg.pad_heads_to else ''}"
          f"{f', MLA r={cfg.kv_lora_rank}' if cfg.use_mla else ''}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} of ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n} {cfg.param_dtype} "
          f"parameters ({info['param_gib']} GiB), initialised in {secs:.2f} s (peak "
          f"{info['init_peak_gib']} GiB)")
    return cfg, params, info


def moe_prefill_check(torch, cfg, params, prompts, flash_layers, hold):
    """``build_prefill`` on the prompts: warm once, then ``MOE_PREFILL_REPS``
    timed calls and one traced (``trace_prefill``), each with
    ``flash_layers`` kernel-8 launches, all on the tensor-core kernel;
    with ``hold``, the last ``PREFILL_TAIL`` positions
    of each prompt held by ``MOE_TRUTH``'s rule: the truth is the
    ``flash=False`` route (f32 activations where the parameters are f32),
    whose routing the other routes replay (``RouteRecorder``); one more
    flash call (kernel 8) is held against it, beside the bf16
    ``flash=False`` route where the truth is f32; every route's own
    routing is held by ``routing_diff``.  Returns the prefill's numbers and
    launches."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.train.serve import build_prefill

    B, S = prompts.shape
    prefill = build_prefill(cfg)
    zero_counts()
    logits = prefill(params, {"tokens": prompts})
    if logits.shape != (B, S, cfg.vocab_size) or logits.dtype != torch.bfloat16:
        raise AssertionError(f"{cfg.name} prefill logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    del logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(MOE_PREFILL_REPS):
        logits = None
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    del logits
    out = {"trace": trace_prefill(torch, cfg, lambda: prefill(params, {"tokens": prompts}))}
    calls = 2 + MOE_PREFILL_REPS
    if hold:
        n_moe = cfg.n_layers - M._n_prefix(cfg)
        f32 = cfg.param_dtype == "float32"
        truth = "f32" if f32 else cfg.dtype

        def tail(pcfg, flash, replay=None):
            with RouteRecorder(replay) as rec:
                lg = build_prefill(pcfg, flash=flash)(params, {"tokens": prompts})
            t = lg[:, -PREFILL_TAIL:].float()
            del lg
            return t, rec.per_layer(torch, n_moe)

        label = f"{cfg.name} prefill {B} x {S}, each prompt's last {PREFILL_TAIL} positions"
        want_t, rec_t = tail(dataclasses.replace(cfg, dtype="float32") if f32 else cfg, False)
        picks = [idx for _, idx in rec_t]
        got, rec_g = tail(cfg, True, picks)
        calls += 1
        out["routing_flash"] = routing_diff(
            torch, f"{label}: the {truth} flash=False route (a) vs the flash route (b)",
            rec_t, rec_g)
        if f32:
            ref, rec_r = tail(cfg, False, picks)
            out["routing_chunked"] = routing_diff(
                torch, f"{label}: the f32 flash=False route (a) vs the {cfg.dtype} "
                "flash=False route (b)", rec_t, rec_r)
            out["flash_vs_chunked"] = logit_gap(
                torch, f"{label}: {cfg.dtype} flash vs {cfg.dtype} flash=False, both "
                "replaying the f32 route's routing", got, ref)
            out["vs_truth"] = hold_against_truth(
                torch, f"{label}: the {cfg.dtype} flash route (kernel 8)", got,
                f"the {cfg.dtype} flash=False route", ref, want_t)
        else:
            check_logits(torch, f"{label}: flash vs flash=False (its routing replayed)", got,
                         want_t)
        del want_t, got

    counts = read_counts()
    want = only_counts(flash_attention=flash_layers * calls)
    if counts != want:
        raise AssertionError(f"{cfg.name} prefill launches {counts}, expected {want}")
    tc = _module("flash_attention").launches_tc
    if tc != flash_layers * calls:
        raise AssertionError(f"{cfg.name}: {tc} of {flash_layers * calls} kernel-8 launches "
                             "on the bf16 tensor-core kernel")
    ms = 1e3 * statistics.median(times)
    out.update(ms=round(ms, 3), ms_each=[round(1e3 * t, 3) for t in times],
               tokens_per_s=round(B * S / ms * 1e3, 1),
               peak_gib=round(peak / 2 ** 30, 2), launches=flash_layers * calls,
               launches_a_call=flash_layers)
    print(f"  {cfg.name} prefill {B} x {S}: {ms:.2f} ms (median of {MOE_PREFILL_REPS}; "
          f"{out['ms_each']}), {out['tokens_per_s']:.0f} prompt tokens/s, peak memory "
          f"{out['peak_gib']} GiB; kernel 8 launches {flash_layers * calls} in {calls} calls "
          f"({flash_layers} a call, all on the tensor-core kernel)")
    return out


def trace_prefill(torch, cfg, call) -> dict:
    """One prefill ``call()`` under a ``torch.profiler`` capture: its device
    kernels summed by name, the top eight, and the device's busy share
    (``trace_round``)."""
    import tempfile

    from repro_torch.obs import profile

    span = f"{cfg.name} prefill"
    with tempfile.TemporaryDirectory() as tmp:
        with profile.capture(tmp):
            with profile.annotate(span):
                call()
                torch.cuda.synchronize()
        return trace_round(torch, f"{tmp}/{profile.TRACE_FILE}", span, top=8)


def moe_decode_check(torch, cfg, params, prompt_len, new_tokens, g):
    """``build_decode_step`` at batch ``MOE_DECODE_B`` against a cache of
    ``decode_32k``'s positions: a random prompt stepped, then greedy
    tokens, under the recorder; the stepped logits held against one
    prefill of the same tokens at a capacity that drops no pick (capacity
    factor E / top_k: capacity S, as a decode step's capacity 1 drops
    none) by ``MOE_TRUTH``'s rule: the prefill in f32 activations (where
    the parameters are f32) is the truth whose routing the replayed routes
    follow (``RouteRecorder``); the bf16 decode, replayed on a cache of
    the sequence's length, is held beside the bf16 prefill, and the f32
    decode by the dense rule; every route's own routing is held by
    ``routing_diff``.  Then ``MOE_DECODE_TIMED`` greedy steps timed
    without the recorder.  No kernel launches."""
    import dataclasses

    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.models import model as M
    from repro_torch.train.serve import build_decode_step, build_prefill

    B = MOE_DECODE_B
    n_moe = cfg.n_layers - M._n_prefix(cfg)
    cache = M.init_cache(cfg, B, DECODE_32K.seq_len)
    cache_gib = sum(t.numel() * t.element_size() for t in
                    [*cache["layers"].values()]
                    + [t for c in cache.get("prefix", []) for t in c.values()]) / 2 ** 30
    prompt = torch.randint(0, cfg.vocab_size, (B, prompt_len), generator=g, device="cuda",
                           dtype=torch.int32)
    step = build_decode_step(cfg)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    stepped, gen = [], []
    with RouteRecorder() as rec:
        for i in range(prompt_len):
            lg, cache = step(params, cache, prompt[:, i:i + 1])
            stepped.append(lg)
        for _ in range(new_tokens):
            gen.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
            lg, cache = step(params, cache, gen[-1])
            stepped.append(lg)
    steps_held = prompt_len + new_tokens
    rec_steps = rec.per_layer(torch, n_moe)
    torch.cuda.synchronize()
    times = []
    nxt = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(MOE_DECODE_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = step(params, cache, nxt)
        nxt = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"{cfg.name} decode launched {read_counts()}")
    if cache["idx"] != steps_held + MOE_DECODE_TIMED:
        raise AssertionError(f"{cfg.name}: cache idx {cache['idx']}")
    del cache
    ms = 1e3 * statistics.median(times)
    seq = torch.cat([prompt] + gen, dim=1)
    st = torch.cat(stepped, dim=1).float()
    del stepped
    if not bool(torch.isfinite(st).all()):
        raise AssertionError(f"{cfg.name}: non-finite decode logits")

    # the truth (MOE_TRUTH): one prefill of the same tokens at a capacity
    # that drops no pick, in f32 activations where the parameters are f32
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    f32 = cfg.param_dtype == "float32"
    truth = "f32" if f32 else cfg.dtype
    with RouteRecorder() as rec:
        tr_logits = build_prefill(dataclasses.replace(no_drop, dtype="float32") if f32
                                  else no_drop)(params, {"tokens": seq}).float()
    rec_truth = rec.per_layer(torch, n_moe)
    picks = [idx for _, idx in rec_truth]

    def replayed_steps(dcfg):
        c = M.init_cache(dcfg, B, steps_held)
        fn = build_decode_step(dcfg)
        outs = []
        with RouteRecorder([p[:, t:t + 1] for t in range(steps_held) for p in picks]) as r:
            for t in range(steps_held):
                lg_t, c = fn(params, c, seq[:, t:t + 1])
                outs.append(lg_t)
        return torch.cat(outs, dim=1).float(), r.per_layer(torch, n_moe)

    label = f"{cfg.name} {steps_held} tokens"
    out = dict(routing_main=routing_diff(
        torch, f"{label}: the {truth} prefill (a) vs the main path's decode (b)", rec_truth,
        rec_steps, replayed=False))
    del rec_steps
    logit_gap(torch, f"{label}: the main path's decode (own routing) vs the {truth} prefill",
              st, tr_logits)
    d16, rec_d = replayed_steps(cfg)
    out["routing_replayed_decode"] = routing_diff(
        torch, f"{label}: the {truth} prefill (a) vs a {cfg.dtype} decode (b)", rec_truth, rec_d)
    if f32:
        with RouteRecorder(picks) as rec:
            p16 = build_prefill(no_drop)(params, {"tokens": seq}).float()
        out["routing_prefill"] = routing_diff(
            torch, f"{label}: the f32 prefill (a) vs the {cfg.dtype} prefill (b)", rec_truth,
            rec.per_layer(torch, n_moe))
        d32, _ = replayed_steps(dataclasses.replace(cfg, dtype="float32"))
        check_logits(torch, f"{label}: f32 decode vs the f32 prefill, its routing replayed",
                     d32, tr_logits)
        out["decode_vs_prefill"] = logit_gap(
            torch, f"{label}: {cfg.dtype} decode vs the {cfg.dtype} prefill, both replaying "
            "the f32 prefill's routing", d16, p16)
        out["vs_truth"] = hold_against_truth(
            torch, f"{label}: the {cfg.dtype} decode (the absorbed cache)"
            if cfg.use_mla else f"{label}: the {cfg.dtype} decode", d16,
            f"the {cfg.dtype} prefill", p16, tr_logits)
    else:
        check_logits(torch, f"{label}: {cfg.dtype} decode vs the {cfg.dtype} prefill, its "
                     "routing replayed", d16, tr_logits)
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"{cfg.name}: the decode check launched {read_counts()}")
    out.update(ms_a_step=round(ms, 3), steps_held=steps_held, batch=B,
               cache_positions=DECODE_32K.seq_len, cache_gib=round(cache_gib, 3),
               tokens_per_s=round(B / ms * 1e3, 1), peak_gib=round(peak / 2 ** 30, 2))
    print(f"  {cfg.name} decode batch {B}, cache of {DECODE_32K.seq_len} positions "
          f"({cache_gib:.3f} GiB): {ms:.3f} ms a step (median of {MOE_DECODE_TIMED} greedy "
          f"steps after the {steps_held} held), {out['tokens_per_s']:.1f} tokens/s, peak "
          f"{out['peak_gib']} GiB; kernel 8 launches 0")
    return out


def check_moe_flash_shapes(torch) -> tuple:
    """Kernel 8 at the MoE prefills' shapes: Moonlight's (B=2, H=16,
    S=8192, hd 128) through ``compare_flash``, and Arctic's 64 padded heads
    (B=1, S=8192, hd 128; heads 56-63 all-zero q, k and v, as the padding
    makes them) against the plain version, the zero heads' o exactly 0 in
    both; then both timed by ``time_flash``.  Returns (errors, times)."""
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain

    errs = [compare_flash(torch, 2, 16, 8192, 8192, 128, True, "bfloat16", 128, seed=90)]
    q, k, v = flash_inputs(torch, 64, 8192, 8192, 128, "bfloat16", seed=91)
    for t in (q, k, v):
        t[56:] = 0
    args = (float(1.0 / 128 ** 0.5), True, 8192, 0)
    got = fk.flash_attention_cuda(q, k, v, *args)[0]
    want = flash_attention_plain(q, k, v, *args)[0]
    err, rel = _hold("64 padded heads (56 live) S=8192 hd=128 bf16", "o", got, want,
                     "bfloat16")
    if not (bool((got[56:] == 0).all()) and bool((want[56:] == 0).all())):
        raise AssertionError("flash_attention: a zero-padded head's o is not exactly 0")
    print(f"  flash_attention 64 padded heads (56 live, the rest zero) S=8192 hd=128 causal "
          f"bf16: max |o - plain| {err:.3g} (relative rms {rel:.3g}); the 8 padded heads' o "
          "exactly 0 in both")
    errs.append(err)
    del q, k, v, got, want
    return errs, {"moonlight B=2 H=16 S=8192 hd=128": time_flash(torch, 2, 16, 8192, 128, 92),
                  "arctic B=1 H=64 (56 + 8 padded) S=8192 hd=128": time_flash(
                      torch, 1, 64, 8192, 128, 93)}


def run_moe_serve(torch) -> tuple:
    """The three MoE models served, one after another, each freed before
    the next.  Returns (launches, report)."""
    from repro_torch.models import model as M

    report, launches = {}, dict.fromkeys(KERNELS, 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, n_layers, (B, S), flash_layers, (prompt, new), hold in MOE_SERVE:
        cfg, params, info = moe_model(torch, name, n_layers)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                                dtype=torch.int32)
        r = dict(info, prefill=moe_prefill_check(torch, cfg, params, prompts, flash_layers,
                                                 hold))
        launches["flash_attention"] += r["prefill"]["launches"]
        del prompts
        r["decode"] = moe_decode_check(torch, cfg, params, prompt, new, g)
        report[name] = r
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name} freed: the process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
              "GiB")
    return launches, report


def run_moe_train(torch) -> tuple:
    """DeepSeek-V2-Lite at full width cut to ``MOE_TRAIN_LAYERS`` (its dense
    prefix block and one MoE block) on the stacked robust-DP trainer
    (``run_lm_train``).  Returns (launches, report)."""
    return run_lm_train(torch, "moe train", MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_K,
                        "1 dense prefix + 1 MoE")


def run_lm_train(torch, label, arch, n_layers, K, what, n_enc_layers=None) -> tuple:
    """``arch`` at full width cut to ``n_layers`` (an encoder-decoder's
    encoder to ``n_enc_layers``, its frames drawn from seed 2 beside the
    tokens) on the stacked robust-DP
    trainer: ``K`` candidates of one row at ``TRAIN_SEQ``, 2 under IPM-100,
    AdamW, ``LM_TRAIN_STEPS`` steps each of WFAgg and Alt-WFAgg on ``fused``
    (each all-reduce held against ``fused_two_launch`` and ``reference``)
    and of the mean; candidate 0's ce and aux printed per step.  The
    training part's checks: exact launches, the attackers at weight 0,
    WFAgg's last loss below its first and the mean's.  Runs with the
    allocator's expandable segments: a step with the hold fills the card
    to within a few GiB, and blocks of the (K, P) buffers' and the leaves'
    sizes left 9.83 GiB reserved but no 4.69 GiB block free on an 80 GB
    H100 (PERF.md §6).  Returns (launches, report)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.topology import spaced_malicious
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    if n_enc_layers is not None:
        cfg = dataclasses.replace(cfg, n_enc_layers=n_enc_layers)
    mesh = make_test_mesh(data=K)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, K)
    batches = [stream.batch(i, device="cuda") for i in range(LM_TRAIN_STEPS)]
    if cfg.is_encoder_decoder:
        g = torch.Generator(device="cuda").manual_seed(2)
        for b in batches:
            b["frames"] = torch.randn((K, TRAIN_SEQ, cfg.d_model), generator=g, device="cuda",
                                      dtype=getattr(torch, cfg.dtype))
    bad = spaced_malicious(K, TRAIN_MALICIOUS).nonzero()[0].tolist()
    launches = dict.fromkeys(KERNELS, 0)
    P = sum(p.numel() for p in M.DecoderLM(cfg, torch.Generator(), "meta").parameters())
    print(f"  {arch} cut to {cfg.n_layers} layers ({what}) at full width, P = {P} "
          f"({4 * P / 2 ** 30:.2f} GiB a copy), K={K} "
          f"candidates of one row at S={TRAIN_SEQ}, candidates {bad} under {TRAIN_ATTACK}, "
          f"AdamW lr {TRAIN_LR}, {LM_TRAIN_STEPS} steps")

    def probe(state, batch):
        with torch.no_grad():
            _, parts = M.loss_fn(cfg, state.params, {k: v[:1] for k, v in batch.items()})
        return {k: round(float(v), 5) for k, v in parts.items()}

    report = {"arch": arch, "layers": cfg.n_layers, "K": K, "P": P}
    gc.collect()
    torch.cuda.empty_cache()
    expandable_segments(torch, True)
    try:
        for method in ("wfagg", "alt_wfagg", "mean"):
            tc = train_config(method, attack=TRAIN_ATTACK, n_malicious=TRAIN_MALICIOUS)
            gc.collect()
            torch.cuda.empty_cache()
            report[method] = lm_train_run(torch, label, cfg, tc, mesh, batches, bad, probe,
                                          launches)
    finally:
        expandable_segments(torch, False)
    w, mean = report["wfagg"]["losses"], report["mean"]["losses"]
    if not (w[-1] < w[0] and w[-1] < mean[-1]):
        raise AssertionError(f"{label}: WFAgg's step-{LM_TRAIN_STEPS} loss {w[-1]} is not "
                             f"below its first {w[0]} and the mean's {mean[-1]}")
    print(f"  the paper's claim on {arch}: WFAgg's loss {w[0]:.4f} -> {w[-1]:.4f}, the "
          f"mean's {mean[0]:.4f} -> {mean[-1]:.4f} under {TRAIN_ATTACK}")
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


def lm_train_run(torch, label, cfg, tc, mesh, batches, bad, probe, launches) -> dict:
    """One of ``run_lm_train``'s runs (the hold on WFAgg's methods),
    checked as the training part's; adds its launches."""
    method = tc.agg.method
    hold = method != "mean"
    r = train_run(torch, cfg, tc, mesh, batches, hold, probe=probe)
    n = len(batches)
    want = only_counts() if not hold else only_counts(
        wfagg_round_indexed=n, robust_stats=n, pairwise_gram=n if method == "alt_wfagg" else 0)
    if r["counts"] != want:
        raise AssertionError(f"{label} {method}: launches {r['counts']}, expected {want}")
    for k in KERNELS:
        launches[k] += r["counts"][k]
    if not all(map(math.isfinite, r["losses"])):
        raise AssertionError(f"{label} {method}: non-finite loss {r['losses']}")
    if hold and any(w[k] != 0.0 for w in r["weights"] for k in bad):
        raise AssertionError(f"{label} {method}: an attacker got weight: {r['weights']}")
    del r["counts"]
    print(f"  stacked {method:9s}: loss per step {[round(x, 4) for x in r['losses']]}, "
          f"weights {r['weights']}")
    print(f"    candidate 0's ce / aux per step (before the step): "
          f"{[(p['ce'], p['aux']) for p in r['probes']]}")
    phases = [[s.get(p) for p in ("grads", "attack", "allreduce", "optimizer")]
              for s in r["ms"]]
    print(f"    ms per step (grads / attack / all-reduce / optimizer): {phases}; tokens/s "
          f"{r['tokens_per_s']}; peak GiB per step {r['peak_gib']} (the hold's "
          f"included); launches {r['launches']}")
    if hold:
        print(f"    fused and fused_two_launch held to reference at every step (weights "
              f"within {STACK_W_TOL}, outputs within rtol {STACK_RTOL} / atol "
              f"{STACK_ATOL}, max|diff| {r['max_out_err']:.3g}); near-ties "
              f"{r['near_ties'] or 'none'}")
    return r


def expandable_segments(torch, on: bool) -> None:
    """The caching allocator's expandable segments, from here on (the
    runtime form of ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``)."""
    setting = f"expandable_segments:{on}"
    if hasattr(torch._C, "_accelerator_setAllocatorSettings"):
        torch._C._accelerator_setAllocatorSettings(setting)
    else:
        torch.cuda.memory._set_allocator_settings(setting)


def run_moe_path(torch) -> tuple:
    """The MoE part: kernel 8 at the MoE prefills' shapes, the three models
    served, an MoE trained.  Returns (launches, kernel-8 errors, kernel-8
    times, report)."""
    card = gpu_line()
    print(f"  {card}")
    errs, flash_times = check_moe_flash_shapes(torch)
    launches, serve = run_moe_serve(torch)
    train_launches, train = run_moe_train(torch)
    for k in KERNELS:
        launches[k] += train_launches[k]
    return launches, errs, flash_times, {"card": card, "serve": serve, "train": train}


# ---------------------------------------------------------------------------
# phase 3: the SSM and hybrid families (serving Falcon-Mamba-7B and
# Zamba2-1.2B at full width, cut in depth; training a hybrid through
# kernels 1, 4 and 6)
# ---------------------------------------------------------------------------

# (arch, prefill (B, S), kernel-8 launches a prefill, decode batch, decode
# cache positions, random prompt tokens, of them taken in one stateful call
# before the single steps, greedy steps held): each decode's held logits
# (prompt and greedy, 24 positions) against one prefill of the same tokens
SSM_SERVE = (
    # cut at full width to fit the whole script's time beside the grid and
    # the families' parts: Falcon-Mamba-7B to 4 of 64 layers (uncut its
    # prefill took 21 s a call on one H100, PERF.md §6),
    # Zamba2-1.2B to 8 of 38 layers (4 groups, the shared block once a
    # group; uncut 10.4 s a prefill on one H100); the decodes' held tokens
    # cut from 96 to 24 beside the bf16 / pad-slot part, the whole script's time
    ("falcon-mamba-7b", 4, (2, 8192), 0, 4, 96, 24, 12, 0),     # arXiv:2410.05355
    ("zamba2-1.2b", 8, (2, 8192), 4, 2, 32768, 16, 0, 8),       # arXiv:2411.15242
)
SSM_DECODE_TIMED = 8           # greedy steps timed after the held ones
SSM_TRAIN_ARCH = "zamba2-1.2b"
SSM_TRAIN_LAYERS = 4           # 2 groups: the shared block serves two; P = 309,967,616
SSM_TRAIN_K = 6
SSM_FLASH = (2, 32, 8192, 64)  # kernel 8 at Zamba2's prefill: B, H (no GQA), S, hd


# SSM_TRUTH: two bf16 routes of one model (kernel 8's prefill and the
# flash=False one; a decode and a prefill) are held to each other by the
# dense rule (``check_logits``).  Where the two differ by more than its
# relative rms or largest difference, 64 (Falcon-Mamba) or 38 + 19 (Zamba2)
# bf16 layers may have amplified rounding beyond it: the route under test
# is then held by ``MOE_TRUTH``'s rule instead, against the f32-activation
# route of the same model beside its counterpart (``hold_against_truth``).
# Either way the f32 routes of the same function (the f32 decode and the
# f32 prefill) are held to each other by the dense rule.  The rule is
# chosen by the measured distance alone, never by the outcome of a hold.


def hold_bf16_route(torch, label, got, ref_label, ref, truth) -> dict:
    """``SSM_TRUTH``'s rule for the bf16 route ``got`` against its bf16
    counterpart ``ref``, the f32 route ``truth`` beside (every distance
    printed).  Returns the distances and the rule applied."""
    rel, big = logit_gap(torch, f"{label} vs {ref_label}", got, ref)
    out = dict(rms=rel, largest=big)
    if rel <= LOGIT_RMS and big <= LOGIT_ATOL:
        check_logits(torch, f"{label} vs {ref_label}", got, ref)
        return dict(out, rule="dense")
    print(f"  {label}: {rel:.4g} / {big:.4g} from {ref_label}, past the dense rule's "
          f"{LOGIT_RMS} / {LOGIT_ATOL}: held against the f32 route (SSM_TRUTH)")
    return dict(out, rule="truth", vs_truth=hold_against_truth(torch, label, got, ref_label,
                                                               ref, truth))


def ssm_model(torch, name, n_layers=None):
    """The model on the seed-0 init, uncut or cut to ``n_layers`` at full
    width, its size and init time printed."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    cfg = get_config(name)
    cut = f"cut to {n_layers} of {cfg.n_layers} layers" if n_layers else "uncut"
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    info = dict(params=n, param_gib=round(nbytes / 2 ** 30, 2), init_s=round(secs, 2))
    shared = (f", one shared attention block ({cfg.n_heads} heads of {cfg.head_dim_}, d_ff "
              f"{cfg.d_ff}) every {cfg.shared_attn_every} layers"
              if cfg.family == "hybrid" else "")
    print(f"  {name} {cut}: {cfg.n_layers} {cfg.ssm_variant} layers, d_model {cfg.d_model}, "
          f"d_inner {cfg.d_inner_}, state {cfg.ssm_state}{shared}, vocab {cfg.vocab_size}; "
          f"{n} {cfg.param_dtype} parameters ({info['param_gib']} GiB), initialised in "
          f"{secs:.2f} s")
    return cfg, params, info


def lm_prefill_check(torch, cfg, params, prompts, flash_layers, extra=None, dense=False):
    """``build_prefill`` on the prompts (with the ``extra`` entries of the
    batch: an encoder-decoder's ``frames``, a VLM's ``patch_embeds``, whose
    positions lead the logits), one call timed (its peak memory; a second
    call differed by 1.6%, PERF.md §6) and one traced (``trace_prefill``),
    each with ``flash_layers`` kernel-8 launches, all on the tensor-core
    kernel.  With kernel 8 on the path, each prompt's last
    ``PREFILL_TAIL`` positions of the timed call are held against the
    ``flash=False`` route: with ``dense`` by the dense rule alone, else by
    ``SSM_TRUTH``'s rule, the f32-activation ``flash=False`` prefill its
    truth.  Returns the prefill's numbers and launches."""
    import dataclasses

    from repro_torch.train.serve import build_prefill

    batch = {"tokens": prompts, **(extra or {})}
    B = prompts.shape[0]
    S = prompts.shape[1] + (batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0)
    prefill = build_prefill(cfg)
    zero_counts()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    peak = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    if logits.shape != (B, S, cfg.vocab_size) or logits.dtype != torch.bfloat16:
        raise AssertionError(f"{cfg.name} prefill logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    got = logits[:, -PREFILL_TAIL:].float()
    del logits
    out = {"trace": trace_prefill(torch, cfg, lambda: prefill(params, batch))}
    calls = 2
    if flash_layers:
        label = f"{cfg.name} prefill {B} x {S}, each prompt's last {PREFILL_TAIL} positions"

        def tail(pcfg):
            lg = build_prefill(pcfg, flash=False)(params, batch)
            t = lg[:, -PREFILL_TAIL:].float()
            del lg
            return t

        ref = tail(cfg)
    if flash_layers and dense:
        check_logits(torch, f"{label}: the {cfg.dtype} flash route (kernel 8) vs the "
                     f"{cfg.dtype} flash=False route", got, ref)
        out["flash_vs_chunked"] = dict(zip(("rms", "largest"), logit_gap(
            torch, f"{label}: flash vs flash=False", got, ref)), rule="dense")
        del ref
    elif flash_layers:
        truth = tail(dataclasses.replace(cfg, dtype="float32"))
        out["flash_vs_truth"] = logit_gap(
            torch, f"{label}: the {cfg.dtype} flash route (kernel 8) vs the f32 flash=False "
            "route", got, truth)
        out["chunked_vs_truth"] = logit_gap(
            torch, f"{label}: the {cfg.dtype} flash=False route vs the f32 flash=False route",
            ref, truth)
        out["flash_vs_chunked"] = hold_bf16_route(
            torch, f"{label}: the {cfg.dtype} flash route (kernel 8)", got,
            f"the {cfg.dtype} flash=False route", ref, truth)
        del ref, truth
    del got
    counts = read_counts()
    want = only_counts(flash_attention=flash_layers * calls)
    if counts != want:
        raise AssertionError(f"{cfg.name} prefill launches {counts}, expected {want}")
    tc = _module("flash_attention").launches_tc
    if tc != flash_layers * calls:
        raise AssertionError(f"{cfg.name}: {tc} of {flash_layers * calls} kernel-8 launches "
                             "on the bf16 tensor-core kernel")
    out.update(ms=round(ms, 3), tokens_per_s=round(B * S / ms * 1e3, 1), peak_gib=peak,
               launches=flash_layers * calls, launches_a_call=flash_layers)
    print(f"  {cfg.name} prefill {B} x {S}: {ms:.2f} ms, {out['tokens_per_s']:.0f} prompt "
          f"tokens/s, peak memory {peak} GiB; kernel 8 launches "
          f"{flash_layers * calls} in {calls} calls ({flash_layers} a call, all on the "
          "tensor-core kernel)")
    return out


def lm_decode_check(torch, cfg, params, batch, positions, prompt_len, one_call, greedy, g,
                    frames=None):
    """``build_decode_step`` at ``batch`` against a cache of ``positions``: a
    random prompt (its first ``one_call`` tokens in one stateful call, the
    rest a token a step), then ``greedy`` greedy tokens; the held logits
    against one prefill of the same tokens: in f32 (the same calls
    replayed) by the dense rule, in the model's activations by
    ``SSM_TRUTH``'s rule; then ``SSM_DECODE_TIMED`` greedy steps timed.  An
    encoder-decoder's caches hold ``_encode``'s output of ``frames`` (in
    the route's activations), and its prefills take those frames.  No
    kernel launches."""
    import dataclasses

    from repro_torch.train.serve import build_decode_step, build_prefill

    extra = {} if frames is None else {"frames": frames}

    def new_cache(ccfg, total):
        return encoded_cache(torch, ccfg, params, batch, total, frames=frames)

    cache = new_cache(cfg, positions)
    cache_gib = sum(t.numel() * t.element_size() for t in
                    [t for v in cache["layers"].values()
                     for t in (v.values() if isinstance(v, dict) else [v])]) / 2 ** 30
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device="cuda",
                           dtype=torch.int32)
    step = build_decode_step(cfg)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    splits = ([(0, one_call)] if one_call else []) + [(i, i + 1)
                                                      for i in range(one_call, prompt_len)]
    stepped, gen = [], []
    for a, b in splits:
        lg, cache = step(params, cache, prompt[:, a:b])
        stepped.append(lg)
    for _ in range(greedy):
        gen.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
        lg, cache = step(params, cache, gen[-1])
        stepped.append(lg)
    torch.cuda.synchronize()
    times = []
    nxt = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(SSM_DECODE_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = step(params, cache, nxt)
        nxt = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"{cfg.name} decode launched {read_counts()}")
    n_calls = len(splits) + greedy + SSM_DECODE_TIMED
    if cache["idx"] != n_calls:
        raise AssertionError(f"{cfg.name}: cache idx {cache['idx']}, {n_calls} calls")
    del cache
    ms = 1e3 * statistics.median(times)
    seq = torch.cat([prompt] + gen, dim=1)
    st = torch.cat(stepped, dim=1).float()
    del stepped
    if st.shape != (batch, seq.shape[1], cfg.vocab_size) or not bool(torch.isfinite(st).all()):
        raise AssertionError(f"{cfg.name}: decode logits {tuple(st.shape)}, finite "
                             f"{bool(torch.isfinite(st).all())}")

    f32 = dataclasses.replace(cfg, dtype="float32")
    pf = build_prefill(cfg)(params, {"tokens": seq, **extra}).float()
    truth = build_prefill(f32)(params, {"tokens": seq, **extra}).float()
    c32 = new_cache(f32, seq.shape[1])
    step32 = build_decode_step(f32)
    d32 = []
    for a, b in splits + [(t, t + 1) for t in range(prompt_len, seq.shape[1])]:
        lg32, c32 = step32(params, c32, seq[:, a:b])
        d32.append(lg32.float())
    d32 = torch.cat(d32, dim=1)
    del c32
    label = f"{cfg.name} {seq.shape[1]} tokens"
    out = {"decode_vs_truth": logit_gap(torch, f"{label}: the {cfg.dtype} decode vs the f32 "
                                        "prefill", st, truth),
           "prefill_vs_truth": logit_gap(torch, f"{label}: the {cfg.dtype} prefill vs the f32 "
                                         "prefill", pf, truth)}
    check_logits(torch, f"{label}: f32 decode vs the f32 prefill", d32, truth)
    out["decode_vs_prefill"] = hold_bf16_route(
        torch, f"{label}: the {cfg.dtype} decode", st, f"the {cfg.dtype} prefill", pf, truth)
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"{cfg.name}: the decode check launched {read_counts()}")
    out.update(ms_a_step=round(ms, 3), steps_held=seq.shape[1], calls_held=len(splits) + greedy,
               batch=batch, cache_positions=positions, cache_gib=round(cache_gib, 3),
               tokens_per_s=round(batch / ms * 1e3, 1), peak_gib=round(peak / 2 ** 30, 2))
    how = f"{one_call} tokens in one stateful call, then " if one_call else ""
    print(f"  {cfg.name} decode batch {batch}, cache for {positions} positions "
          f"({cache_gib:.3f} GiB): {how}{prompt_len - one_call} prompt tokens and {greedy} "
          f"greedy a step held; {ms:.3f} ms a step (median of {SSM_DECODE_TIMED} greedy steps "
          f"after them), {out['tokens_per_s']:.1f} tokens/s, peak {out['peak_gib']} GiB; "
          "kernel 8 launches 0")
    return out


def check_ssm_flash_shape(torch) -> tuple:
    """Kernel 8 at Zamba2's prefill shape (``SSM_FLASH``) through
    ``compare_flash``, then timed by ``time_flash``.  Returns (error,
    times)."""
    B, H, S, hd = SSM_FLASH
    err = compare_flash(torch, B, H, S, S, hd, True, "bfloat16", 128, seed=95)
    return err, time_flash(torch, B, H, S, hd, 96)


def run_ssm_serve(torch) -> tuple:
    """Falcon-Mamba-7B (4 of 64 layers) and Zamba2-1.2B (8 of 38) served, one
    after another, each freed before the next.  Returns (launches, report)."""
    report, launches = {}, dict.fromkeys(KERNELS, 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, depth, (B, S), flash_layers, batch, positions, prompt, one_call, greedy \
            in SSM_SERVE:
        cfg, params, info = ssm_model(torch, name, depth)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                                dtype=torch.int32)
        r = dict(info, prefill=lm_prefill_check(torch, cfg, params, prompts, flash_layers))
        launches["flash_attention"] += r["prefill"]["launches"]
        del prompts
        r["decode"] = lm_decode_check(torch, cfg, params, batch, positions, prompt, one_call,
                                      greedy, g)
        report[name] = r
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name} freed: the process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
              "GiB")
    return launches, report


def run_ssm_path(torch) -> tuple:
    """The SSM part: kernel 8 at Zamba2's prefill shape, Falcon-Mamba-7B and
    Zamba2-1.2B served, Zamba2 trained.  Returns (launches, kernel-8 error,
    kernel-8 times, report)."""
    card = gpu_line()
    print(f"  {card}")
    err, flash_times = check_ssm_flash_shape(torch)
    launches, serve = run_ssm_serve(torch)
    train_launches, train = run_lm_train(
        torch, "ssm train", SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS, SSM_TRAIN_K,
        f"{SSM_TRAIN_LAYERS // 2} groups: the shared block twice")
    for k in KERNELS:
        launches[k] += train_launches[k]
    return launches, err, flash_times, {"card": card, "serve": serve, "train": train}


# ---------------------------------------------------------------------------
# phase 3: the encoder-decoder and VLM families (serving SeamlessM4T-medium
# uncut and LLaVA-NeXT-34B at full width cut in depth; training the
# encoder-decoder through kernels 1, 4 and 6)
# ---------------------------------------------------------------------------

# (arch, layers (None: uncut), prefill (B, S positions), kernel-8 launches a
# prefill, decode batch, decode cache positions, random prompt tokens,
# greedy steps held, the prefill hold's rule): each decode's held logits
# (prompt and greedy, 24 positions: 96 until the bf16 / pad-slot part, the
# whole script's time) against one prefill of the same tokens.
# Seamless's S positions are S frames and S tokens, its decode caches
# ``ENC_LEN_DECODE`` encoded frames; LLaVA's are ``n_modal_tokens`` patches
# and S - n_modal tokens, its decode and the prefill it is held to take
# text only (the reference's ``decode_step`` embeds tokens only).
ENCDEC_SERVE = (
    ("seamless-m4t-medium", None, (2, 8192), 12, 2, 32768, 16, 8, "dense"),  # 2308.11596
    # 6 of 60 layers (53.51 GiB of f32 parameters at 24 layers; uncut
    # 128.33 GiB), cut beside the families' part (to 12) and the bf16 /
    # pad-slot part (to 6) for the whole script's time
    ("llava-next-34b", 6, (1, 8192), 6, 2, 32768, 16, 8, "truth"),
)
ENCDEC_TRAIN_ARCH = "seamless-m4t-medium"
# 2 encoder + 2 decoder layers (6 + 6 until the bf16 / pad-slot part, the
# whole script's time)
ENCDEC_TRAIN_LAYERS = 2
ENCDEC_TRAIN_K = 6


def family_model(torch, name, n_layers):
    """The model on the seed-0 init, cut to ``n_layers`` (None: uncut), its
    size and init time printed."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    info = dict(params=n, param_gib=round(nbytes / 2 ** 30, 2), init_s=round(secs, 2))
    enc = (f"{cfg.n_enc_layers} encoder + " if cfg.is_encoder_decoder else "")
    pad = f" padded to {cfg.pad_heads_to}" if cfg.pad_heads_to else ""
    modal = (f", {cfg.n_modal_tokens} patch embeddings through the projector"
             if cfg.n_modal_tokens else "")
    print(f"  {name}{f' cut to {n_layers} layers' if n_layers else ' uncut'}: {enc}"
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim_}{pad} ({cfg.n_kv_heads} KV), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}{modal}; {n} {cfg.param_dtype} parameters ({info['param_gib']} "
          f"GiB), initialised in {secs:.2f} s")
    return cfg, params, info


def run_encdec_serve(torch) -> tuple:
    """SeamlessM4T-medium and LLaVA-NeXT-34B (``ENCDEC_SERVE``) served, one
    after another, each freed before the next: the prefill with its frames
    or patches (``lm_prefill_check``), then the decode (``lm_decode_check``;
    Seamless's caches hold ``_encode``'s output of ``ENC_LEN_DECODE``
    frames).  Returns (launches, report)."""
    from repro_torch.data.specs import ENC_LEN_DECODE
    from repro_torch.models.model import MODAL_EMBED_DIM

    report, launches = {}, dict.fromkeys(KERNELS, 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    for (name, n_layers, (B, S), flash_layers, batch, positions, prompt, greedy,
         rule) in ENCDEC_SERVE:
        cfg, params, info = family_model(torch, name, n_layers)
        dt = getattr(torch, cfg.dtype)
        if cfg.is_encoder_decoder:
            extra = {"frames": torch.randn((B, S, cfg.d_model), generator=g, device="cuda",
                                           dtype=dt)}
            n_tok = S
        else:
            extra = {"patch_embeds": torch.randn((B, cfg.n_modal_tokens, MODAL_EMBED_DIM),
                                                 generator=g, device="cuda", dtype=dt)}
            n_tok = S - cfg.n_modal_tokens
        prompts = torch.randint(0, cfg.vocab_size, (B, n_tok), generator=g, device="cuda",
                                dtype=torch.int32)
        r = dict(info, prefill=lm_prefill_check(torch, cfg, params, prompts, flash_layers,
                                                extra, dense=rule == "dense"))
        launches["flash_attention"] += r["prefill"]["launches"]
        del prompts, extra
        frames = (torch.randn((batch, ENC_LEN_DECODE, cfg.d_model), generator=g,
                              device="cuda", dtype=dt) if cfg.is_encoder_decoder else None)
        r["decode"] = lm_decode_check(torch, cfg, params, batch, positions, prompt, 0, greedy,
                                      g, frames=frames)
        report[name] = r
        del params, frames
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name} freed: the process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
              "GiB")
    return launches, report


def run_encdec_path(torch) -> tuple:
    """The encoder-decoder and VLM part: Seamless and LLaVA served, Seamless
    trained.  Returns (launches, report)."""
    card = gpu_line()
    print(f"  {card}")
    launches, serve = run_encdec_serve(torch)
    train_launches, train = run_lm_train(
        torch, "encdec train", ENCDEC_TRAIN_ARCH, ENCDEC_TRAIN_LAYERS, ENCDEC_TRAIN_K,
        f"{ENCDEC_TRAIN_LAYERS} encoder + {ENCDEC_TRAIN_LAYERS} decoder",
        n_enc_layers=ENCDEC_TRAIN_LAYERS)
    for k in KERNELS:
        launches[k] += train_launches[k]
    return launches, {"card": card, "serve": serve, "train": train}


# ---------------------------------------------------------------------------
# phase 3: the model (tensor-parallel) axis (distributed/sharding.py,
# logical.py, the model axis of launch/mesh.py, the TP layers, the stacked
# all-reduce's model-axis route)
# ---------------------------------------------------------------------------

TP_ARCH = "qwen1.5-0.5b"
TP_M = 2                       # gloo ranks sharing the one card
# (method, backend, steps) of the TP training runs; the attackers (2 and 6)
# under IPM-100 as the one-card trainer's.  On the model axis fused and
# fused_two_launch are one route (kernels 4, 6 and 7): the second runs 1
# step, held bit for bit to the first's; Alt-WFAgg 1 step for kernel 6
# (WFAgg on fused and the mean cut from 5 steps to 3 beside the grid part;
# since the families' part WFAgg to 2, the second route and Alt-WFAgg to 1
# and the mean to 2, the whole script's 1,050 s)
TP_RUNS = (("wfagg", "fused", 2), ("wfagg", "fused_two_launch", 1), ("alt_wfagg", "fused", 1),
           ("mean", "fused", 2))
# then (method, backend, steps, options): the flat layout on the model axis
# (robust_allreduce.FlatShards: the chunked all-reduce on each rank's blocks,
# no kernel, as the reference's flat layout reaches no Pallas kernel), WFAgg
# and the mean, each step held to the one-process flat route on the gathered
# whole candidates; and one stacked step that runs the options the model axis
# used to refuse at once: min_max (its partial sums over the model group)
# instead of IPM-100, gather_dtype bfloat16 (kernels 4 and 6 on the rounded
# blocks, kernel 7 on the f32 ones) and Adafactor (its update held to one
# process's on the gathered aggregate)
TP_FLAT_RUNS = (("wfagg", "fused", 1, {"layout": "flat"}), ("mean", "fused", 1, {"layout": "flat"}),
                ("wfagg", "fused", 1, {"attack": "min_max", "gather_dtype": "bfloat16",
                                       "optimizer": "adafactor"}))
# the flat layout's hold, fixed before the first run: the rank's decisions
# and weights those of the one-process route on the whole candidates (masks
# bit-equal or a D/C near-tie by NEAR_TIE, weights within FLAT_W_TOL) and
# its aggregate within FLAT_OUT_TOL at its coordinates (the flat layout's
# bounds, as tests/test_torch_flat_tp.py's); Adafactor's updated blocks
# within 1e-5 of the leaf's largest update of one process's (the leaf-wide
# means add M blocks' sums)
ADAFACTOR_TOL = 1e-5
# the TP training runs at 2 of Qwen's 24 layers (12 beside the flat steps,
# then 6 and 2 beside the bf16 / pad-slot part, the whole script's time;
# serving stays uncut)
TP_TRAIN_LAYERS = 2
# the one-card model axis serves 12 of Qwen's 24 layers (uncut until the bf16
# / pad-slot part, the whole script's time; --only cards serves it uncut)
TP_SERVE_LAYERS = 12
# the step-1 candidate gradients at M against M = 1 on the same parameters
# and batch: relative rms of each candidate's whole gradient.  Both are bf16
# activations on f32 parameters, rounded in another order (partial sums of a
# split product rounded to bf16 before they meet); fixed before the first
# run: a wrong block, a missing or doubled all-reduce is an O(1) error
TP_GRAD_RMS = 5e-2
TP_TIMEOUT_S = 900             # the ranks' deadline
# the TP decode's prompt and greedy tokens (cut from the serving path's 64 +
# 32 beside the grid part: each step's 49 host-staged all-reduces ~170 ms)
TP_PROMPT, TP_NEW_TOKENS = 16, 8
CARDS_TP_ARCH = "stablelm-3b"  # --only cards at 4 cards: its state exists only across them
CARDS_TP_STEPS = 3
MASKS = ("mask_d", "mask_c", "mask_t")


def run_label(method, backend, opts) -> str:
    """A training run's name in the reports: method and backend, then its
    options (the flat layout, another attack, gather_dtype, the optimizer)."""
    extra = [("flat" if v == "flat" else v) for k, v in sorted(opts.items())
             if k in ("layout", "attack", "optimizer")]
    if opts.get("gather_dtype"):
        extra.append(f"{opts['gather_dtype']}-gather")
    return " ".join([method, backend] + extra)


def run_config(cfg, method, backend, opts, **kw):
    """A training run's (model config, TrainConfig): ``train_config`` with
    the run's backend and options."""
    import dataclasses

    tc = train_config(method, layout=opts.get("layout", "stacked"),
                      attack=opts.get("attack", TRAIN_ATTACK), **kw)
    tc = dataclasses.replace(tc, agg=dataclasses.replace(
        tc.agg, backend=backend, gather_dtype=opts.get("gather_dtype")))
    if "optimizer" in opts:
        cfg = dataclasses.replace(cfg, optimizer=opts["optimizer"])
    return cfg, tc


class CollectiveClock:
    """The model axis's collectives timed apart: the activation all-reduces
    (``layers.all_reduce_model`` / ``all_max_model``, the TP layers' and the
    vocabulary-parallel loss's) and ``psum_stats`` (the all-reduce's
    statistics), host clock between ``torch.cuda.synchronize()`` calls."""

    def __init__(self, torch):
        from repro_torch.distributed import robust_allreduce as ra
        from repro_torch.models import layers as L

        self.torch, self.L, self.ra = torch, L, ra
        self.orig = (L.all_reduce_model, L.all_max_model, ra.psum_stats)
        self.ms = {"activations": 0.0, "psum_stats": 0.0}
        self.calls = {"activations": 0, "psum_stats": 0}
        L.all_reduce_model = self.wrap(self.orig[0], "activations")
        L.all_max_model = self.wrap(self.orig[1], "activations")
        ra.psum_stats = self.wrap(self.orig[2], "psum_stats")

    def wrap(self, fn, key):
        def timed(*a, **k):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.ms[key] += 1e3 * (time.perf_counter() - t)
            self.calls[key] += 1
            return out
        return timed

    def take(self) -> dict:
        out = {k: round(v, 2) for k, v in self.ms.items()}
        out.update({f"{k}_calls": c for k, c in self.calls.items()})
        self.ms = dict.fromkeys(self.ms, 0.0)
        self.calls = dict.fromkeys(self.calls, 0)
        return out

    def close(self):
        self.L.all_reduce_model, self.L.all_max_model, self.ra.psum_stats = self.orig


def tp_plan(rank, method, backend, needs_gram) -> dict:
    """The launches one TP step plans on model rank ``rank``: kernel 4 on the
    split (K, P_s) matrix, and on rank 0 on the replicated (K, P_r) one
    too; kernel 6 likewise where the rule needs the Gram; kernel 7 on both
    matrices on every rank; kernel 1 never (the mean: none)."""
    if method == "mean":
        return only_counts()
    mats = 2 if rank == 0 else 1
    return only_counts(robust_stats=mats, pairwise_gram=mats if needs_gram else 0,
                       weighted_agg=2)


def tp_margins(torch, cfg, cands, state, flips, shards):
    """``stacked_margins`` on the model axis: the reference route's
    statistics of the rank's candidate blocks, summed over the model group
    (every rank takes part)."""
    from repro_torch.core import trust
    from repro_torch.distributed import robust_allreduce as ra

    leaves = ra._leaves(cands)
    K = leaves[0].shape[0]
    split = [d is not None for d in shards.split_dims]
    groups = [[l for l, s in zip(leaves, split) if s], [l for l, s in zip(leaves, split) if not s]]
    prev = None
    if state is not None:
        pl = ra._leaves(state.prev)
        prev = [[p for p, s in zip(pl, split) if s], [p for p, s in zip(pl, split) if not s]]
    mine = [0] if shards.axis.rank else [0, 1]
    st = ra.psum_stats(ra._partial_stats(
        K, leaves[0].device, [groups[i] for i in mine],
        None if prev is None else [prev[i] for i in mine], cfg), shards.axis.group)
    st = ra.RobustStats(*(None if v is None else v[0] for v in st))
    wcfg = ra._effective_wfagg_config(cfg, K)
    s = b = tb = None
    if state is not None:
        tb = trust.temporal_bands(state.hist_s, state.hist_b, state.count, state.t, wcfg)[None]
        s = st.prev_dist2
        b = 1.0 - st.prev_dot / torch.clamp(torch.sqrt(st.norm2 * st.prev_norm2), min=1e-24)
    return margins_of(torch, wcfg, st.dist2, st.gram, st.dotmed, st.mednorm2, s, b, tb, flips)


class TPObserver:
    """The TP trainer's ``observe`` hook on one rank: each phase's ms, the
    collectives apart (``CollectiveClock``), the launches of the step's own
    route (the hold's excluded), peak memory; with ``hold``, at every step
    the model-axis route of the reference backend (per leaf plain
    statistics of the rank's blocks, summed over the model group, the
    reference's scoring and ``tensordot`` combine) on the same candidates
    and state, held to the step's route: masks bit-equal or near-ties
    (``NEAR_TIE``, ``tp_margins``), weights within ``STACK_W_TOL``, the
    rank's aggregate blocks within rtol ``STACK_RTOL`` / atol
    ``STACK_ATOL``; and at step 1 the candidates (before the attack)
    against the M = 1 gradients of ``grads_m1`` (a (K, P) float32 file in
    ravel order), block by block."""

    def __init__(self, torch, tc, agg_state, hold, clock, model, grads_m1=None):
        self.torch, self.tc, self.hold, self.clock = torch, tc, hold, clock
        self.model, self.grads_m1 = model, grads_m1
        self.hist = (tuple(getattr(agg_state, f).clone() for f in
                           ("hist_s", "hist_b", "count", "t")) if hold else None)
        self.steps, self.peaks, self.launches, self.near_ties = [], [], [], []
        self.max_err, self.grad_rms = 0.0, None

    def start(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self.cur, self.held = {}, 0.0
        self.clock.take()
        zero_counts()
        self.t = time.perf_counter()

    def __call__(self, phase, **v):
        torch = self.torch
        torch.cuda.synchronize()
        self.cur[phase] = 1e3 * (time.perf_counter() - self.t)
        if phase == "optimizer":
            self.cur.update(self.clock.take())
            self.steps.append(self.cur)
            self.peaks.append(round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
            self.launches.append({k: c for k, c in read_counts().items() if c})
            if self.adafactor is not None:
                grads, old = self.adafactor
                self.adafactor_err = hold_adafactor(torch, self.model, self.mesh, grads, old,
                                                    v["params"], self.tc)
                self.adafactor = None
        else:
            counts = read_counts()
            clock = dict(self.clock.ms), dict(self.clock.calls)
            if phase == "grads" and self.grads_m1 is not None and not self.steps:
                self.grad_rms = self.hold_grads(
                    v["candidates"] if self.grads_route is None else self.replayed_grads())
            elif self.hold and phase == "attack":
                self.route(v["candidates"], v["agg_state"])
            elif self.hold and phase == "allreduce":
                self.compare(v["grads"], v["info"])
            if phase == "allreduce" and self.hold_ada and not self.steps:
                from repro_torch.core import flatten as F

                # step 1's aggregate and the parameters before the update
                # (``hold_adafactor`` updates from a zero state, step 1's)
                self.adafactor = (v["grads"], [x.clone() for x in
                                               F.tree_leaves(F.module_tree(self.model))])
            # the hold's own launches and collectives are not the step's
            for name, (mod, attr, _, _) in KERNELS.items():
                setattr(_module(name), attr, counts[name])
            self.clock.ms, self.clock.calls = clock
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    grads_route = None
    batch = None
    hold_ada = False          # hold the first Adafactor update to one process's
    adafactor = None          # (aggregate, old parameters) while an Adafactor step is held
    adafactor_err = None
    mesh = None

    def replayed_grads(self):
        """An MoE model's candidate 0 gradient for the step-1 hold: its rows
        of ``self.batch`` through the rank's model with the one-process
        gradient's routing replayed (``grads_route``: its picks per MoE
        layer, remat off so that each layer routes once), so that what
        differs from one process is continuous (``MOE_TRUTH``); its own
        routing held to the one-process routing by ``routing_diff`` on
        model rank 0.  Returns the candidate tree of that one row."""
        import dataclasses

        from repro_torch.core import flatten as F
        from repro_torch.train import trainer as tr

        torch = self.torch
        route = torch.load(self.grads_route, weights_only=False)
        cfg = dataclasses.replace(route["cfg"], remat=False)
        rows = self.batch["tokens"].shape[0] // self.tc_k
        with RouteRecorder([c[1].to("cuda") for c in route["calls"]]) as rec:
            _, g = tr.loss_and_grad(cfg, self.model, {"tokens": self.batch["tokens"][:rows]})
        if self.model.tp.rank == 0:
            self.routing = routing_diff(
                torch, f"{cfg.name} step-1 candidate 0 routing vs one process",
                [tuple(t.to("cuda") for t in c) for c in route["calls"]],
                [tuple(t.detach() for t in c) for c in rec.calls])
        return F.unravel_rows_split(tuple(x[None] for x in g), self.model)

    def hold_grads(self, cands) -> list:
        """Each candidate's relative rms against M = 1 over the whole
        gradient: this rank's blocks read from the file, the squared sums
        summed over the model group (the replicated leaves on rank 0)."""
        import numpy as np

        from repro_torch.core import flatten as F
        from repro_torch.distributed import robust_allreduce as ra
        from repro_torch.models import layers as L

        from repro_torch.distributed import sharding as shd

        torch = self.torch
        axis = self.model.tp
        full = np.memmap(self.grads_m1, dtype=np.float32, mode="r")
        leaves = ra._leaves(cands)
        P = sum(math.prod(leaf.shape[1:]) * (axis.size if c is not None else 1)
                for leaf, c in zip(leaves, F.split_cuts(self.model)))
        # the file holds the first K of the candidates (all of them, or fewer)
        K = full.shape[0] // P
        full = full.reshape(K, -1)
        num = torch.zeros((K,), dtype=torch.float64, device="cuda")
        den = torch.zeros((K,), dtype=torch.float64, device="cuda")
        off = 0
        for leaf, c in zip(leaves, F.split_cuts(self.model)):
            shape = list(leaf.shape[1:])
            if c is not None:
                shape[c[0].dim] *= axis.size
            n = math.prod(shape)
            want = torch.from_numpy(np.ascontiguousarray(full[:, off:off + n])).view(
                [K] + shape)
            off += n
            if c is not None:
                want = shd.take_block(want, c[0].shifted(1), axis.size, axis.rank)
            elif axis.rank:
                continue
            want = want.to("cuda")
            num += ((leaf[:K] - want).double() ** 2).reshape(K, -1).sum(-1)
            den += (want.double() ** 2).reshape(K, -1).sum(-1)
            del want
        if off != full.shape[1]:
            raise AssertionError(f"tp grads: {off} of {full.shape[1]} values read")
        tot = L.all_reduce_model(torch.stack([num, den]).float(), axis.group)
        rms = (tot[0] / tot[1]).sqrt().tolist()
        if max(rms) > TP_GRAD_RMS:
            raise AssertionError(f"tp step 1: candidate gradients at relative rms {rms} of "
                                 f"M = 1's (bound {TP_GRAD_RMS})")
        return [round(r, 6) for r in rms]

    def route(self, cands, state):
        import dataclasses

        from repro_torch.core import flatten as F
        from repro_torch.distributed import robust_allreduce as ra

        from repro_torch.train import trainer as tr

        self.shards = ra.ModelShards(self.model.tp, tuple(tr._model_cuts(self.model)))
        self.cfg_ref = dataclasses.replace(self.tc.agg, backend="reference")
        st = ra.TreeAggState(state.prev, *self.hist)
        self.cands, self.state = cands, st
        o, ns, info = ra.robust_allreduce_stacked(cands, self.cfg_ref, st,
                                                  model_shards=self.shards)
        self.hist = (ns.hist_s, ns.hist_b, ns.count, ns.t)
        self.ref = (o, info["weights"], {k: info[k] for k in ("mask_d", "mask_c", "mask_t")})

    def compare(self, grads, info):
        from repro_torch.models import layers as L

        torch = self.torch
        o, w, masks = self.ref
        flips = [(k, bit) for bit, name in enumerate(("mask_d", "mask_c", "mask_t"))
                 for k in (masks[name] != info[name]).nonzero().flatten().tolist()]
        label = f"tp {self.tc.agg.method} {self.tc.agg.backend} step {len(self.steps) + 1}"
        keep = torch.ones(w.shape[0], dtype=torch.bool, device="cuda")
        if flips:
            rep = tp_margins(torch, self.cfg_ref, self.cands, self.state, flips, self.shards)
            print(f"  {label}: decisions differ at (candidate, filter, margin) {rep}")
            if not all(m is not None and m <= NEAR_TIE for _, _, m in rep):
                raise AssertionError(f"{label}: decisions differ away from any edge")
            self.near_ties.append((len(self.steps) + 1, rep))
            keep[[k for k, _ in flips]] = False
        torch.testing.assert_close(info["weights"][keep], w[keep], rtol=0, atol=STACK_W_TOL)
        if not flips:
            err = close_leafwise(torch, grads, o, STACK_RTOL, STACK_ATOL)
            err = float(L.all_max_model(torch.tensor([err], device="cuda"),
                                        self.model.tp.group)[0])
            self.max_err = max(self.max_err, err)
        self.ref = self.cands = self.state = None


def gather_root(torch, x):
    """Every rank's ``x`` on the world's rank 0, in rank order (None
    elsewhere): one ``gather``, through host memory on ``gloo``."""
    import torch.distributed as dist

    w = x.contiguous()
    if dist.get_backend() == "gloo":
        w = w.cpu()
    parts = ([torch.empty_like(w) for _ in range(dist.get_world_size())]
             if dist.get_rank() == 0 else None)
    dist.gather(w, parts, dst=0)
    return parts


def world_fails(torch, failed: bool) -> bool:
    """Whether any rank of the world failed its hold (every rank learns it,
    so that all raise together instead of waiting on a collective)."""
    import torch.distributed as dist

    t = torch.tensor([1.0 if failed else 0.0],
                     device="cpu" if dist.get_backend() == "gloo" else "cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def rank_places(places, mrank):
    """Model rank ``mrank``'s places of a buffer whose places on this rank
    are ``places`` (every rank's blocks sit alike, each its own part)."""
    return [p._replace(part=mrank) if p.parts > 1 else p for p in places]


def flat_whole(torch, model, mesh, bufs):
    """The whole candidates (K, P) float32 in ravel order on the world's
    rank 0 (None elsewhere), from every rank's flat buffers: on the model
    axis each rank's (K, P_s) and (K, P_r), the K candidates emulated; on a
    grid each rank's (P_s,) and (P_r,), its data index's candidate.  One
    row a gather, placed by ``core.flatten.global_index``."""
    import torch.distributed as dist

    from repro_torch.core import flatten as F

    places, P = F.coord_places(model)
    M_ = mesh.model_axis().size
    dax = mesh.data_axis()
    K = bufs[0].shape[0] if dax is None else dax.size
    root = dist.get_rank() == 0
    whole = torch.zeros((K, P), dtype=torch.float32, device="cuda") if root else None
    for b, buf in enumerate(bufs):
        for j in range(buf.shape[0] if dax is None else 1):
            parts = gather_root(torch, buf[j] if dax is None else buf)
            if not root:
                continue
            for r, part in enumerate(parts):
                k = j if dax is None else r // M_
                pl = rank_places(places[b], r % M_)
                for a in range(0, part.shape[0], 1 << 25):
                    e = min(part.shape[0], a + (1 << 25))
                    whole[k, F.global_index(pl, a, e, "cuda")] = part[a:e].to("cuda")
            del parts
    return whole


class FlatObserver(TPObserver):
    """The flat layout's ``observe`` hook on one rank of the model axis or a
    grid: ``TPObserver``'s phases, launches and peak memory; with ``hold``,
    at every step the candidates after the attack gathered whole on the
    world's rank 0 (``flat_whole``) and the one-process flat route
    (``robust_allreduce`` over ``Emulated(K)``, from the step's WFAgg-T
    state) run there; after the all-reduce every rank's aggregate
    gathered there too and held to it at its coordinates (``FLAT_OUT_TOL``),
    the decisions masks bit-equal or WFAgg-D/C near-ties (``NEAR_TIE``, by
    the one-process statistics), the weights within ``FLAT_W_TOL``
    (``first_only``: the first step's alone)."""

    def __init__(self, torch, tc, agg_state, hold, clock, model, mesh, first_only=False):
        super().__init__(torch, tc, agg_state, False, clock, model)
        self.hold, self.mesh, self.first_only = hold, mesh, first_only
        self.whole = None

    def __call__(self, phase, **v):
        if phase == "exchange":
            return
        super().__call__(phase, **v)

    def route(self, cands, state):
        from repro_torch.distributed import robust_allreduce as ra

        bufs = cands if isinstance(cands, tuple) else (cands,)
        self.whole = flat_whole(self.torch, self.model, self.mesh, bufs)
        self.ref = None
        if self.whole is not None:
            K = self.whole.shape[0]
            o, _, info = ra.robust_allreduce(self.whole, ra.Emulated(K), self.tc.agg, state)
            self.ref = (o, info["weights"], {k: info[k] for k in MASKS if k in info})

    def compare(self, grads, info):
        import torch.distributed as dist

        from repro_torch.core import flatten as F
        from repro_torch.distributed import robust_allreduce as ra

        torch = self.torch
        label = (f"{'grid' if self.mesh.data_axis() is not None else 'tp'} flat "
                 f"{self.tc.agg.method} step {len(self.steps) + 1}")
        places, _ = F.coord_places(self.model)
        M_ = self.mesh.model_axis().size
        fail, err, rep = None, 0.0, []
        root = dist.get_rank() == 0
        flips = []
        if root:
            o, w, masks = self.ref
            flips = [(k, bit) for bit, name in enumerate(MASKS) if name in masks
                     for k in (masks[name] != info[name]).nonzero().flatten().tolist()]
            keep = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
            if flips:
                K = self.whole.shape[0]
                st = ra._stats_scan(self.whole, ra.Emulated(K), self.tc.agg)
                wcfg = ra._effective_wfagg_config(self.tc.agg, K)
                rep = [(k, "WFAgg-T", None) for k, bit in flips if bit == 2]
                rep += margins_of(torch, wcfg, st.dist2_med, st.gram, st.dot_med, st.med2,
                                  None, None, None, [f for f in flips if f[1] != 2])
                print(f"  {label}: decisions differ at (candidate, filter, margin) {rep}")
                if not all(m is not None and m <= NEAR_TIE for _, _, m in rep):
                    fail = f"{label}: decisions differ away from any edge: {rep}"
                keep[[k for k, _ in flips]] = False
            werr = float((info["weights"][keep] - w[keep]).abs().max()) if keep.any() else 0.0
            if werr > FLAT_W_TOL:
                fail = f"{label}: weights {info['weights'].tolist()} against {w.tolist()}"
        for b, vec in enumerate(grads if isinstance(grads, tuple) else (grads,)):
            parts = gather_root(torch, vec)
            if not root or flips:
                continue
            for r, part in enumerate(parts):
                pl = rank_places(places[b], r % M_)
                for a in range(0, part.shape[0], 1 << 25):
                    e = min(part.shape[0], a + (1 << 25))
                    want = o[F.global_index(pl, a, e, "cuda")]
                    err = max(err, float((part[a:e].to("cuda") - want).abs().max()))
            del parts
        if root and err > FLAT_OUT_TOL:
            fail = f"{label}: the aggregate at max|diff| {err} of the one-process route"
        if fail:
            print(f"  {fail}")
        if world_fails(torch, fail is not None):
            raise AssertionError(fail or f"{label}: the hold failed on rank 0")
        if root and flips:
            self.near_ties.append((len(self.steps) + 1, rep))
        self.max_err = max(self.max_err, err)
        self.ref = self.whole = None
        self.hold = self.hold and not self.first_only
        # the ranks share the card: the hold's whole candidates go back to it
        torch.cuda.empty_cache()


def hold_adafactor(torch, model, mesh, grads, old, new, tc) -> float:
    """The Adafactor step on the model axis against one process's: per leaf
    the aggregate's and the old parameters' blocks gathered whole, one
    Adafactor update of the whole leaf from a zero state (step 1), and the
    rank's block of ``old + update`` against its new block; returns the
    largest difference over the leaf's largest update, the max over the
    model group (raises past ``ADAFACTOR_TOL``)."""
    from repro_torch.core import flatten as F
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.optim.optimizers import make_optimizer, warmup_cosine

    axis = model.tp
    lr = warmup_cosine(tc.lr, tc.warmup, tc.total_steps)(0)
    opt = make_optimizer("adafactor")
    worst = 0.0
    for g, p0, p1, c in zip(F.tree_leaves(grads), old, F.tree_leaves(new), F.split_cuts(model)):
        if c is not None:
            spec = tuple("model" if i == c[0].dim else None for i in range(g.ndim))
            g = shd.gather_tensor(g, spec, mesh, c[0], c[1])
            p0 = shd.gather_tensor(p0, spec, mesh, c[0], c[1])
        u, _ = opt.update({"x": g}, opt.init({"x": p0}), {"x": p0}, lr)
        want = p0 + u["x"]
        if c is not None:
            want = shd.take_block(want, c[0], axis.size, axis.rank)
        scale = float(u["x"].abs().max().clamp(min=1e-30))
        worst = max(worst, float((p1 - want).abs().max()) / scale)
        del g, p0, u, want
    worst = float(L.all_max_model(torch.tensor([worst], device="cuda"), axis.group)[0])
    if worst > ADAFACTOR_TOL:
        raise AssertionError(f"tp adafactor: updated blocks at {worst:.3g} of the leaf's largest "
                             f"update from one process's (bound {ADAFACTOR_TOL})")
    return worst


def tp_serve(torch, cfg, mesh, out_dir, rank) -> tuple:
    """The TP serving part on one rank: ``build_prefill(mesh=)`` on 2 x 8192
    (warm once, then timed; kernel 8 on the rank's H/M heads, one launch a
    layer), the last ``PREFILL_TAIL`` positions' logits gathered and, on
    rank 0, held to the M = 1 prefill's (written by the parent) by the
    dense rule; decode at batch 4 against 32,768 slots over a
    ``TP_PROMPT``-token prompt and ``TP_NEW_TOKENS`` greedy tokens (0
    launches), held to one prefill of the same tokens.  Returns (launches,
    report)."""
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.train import serve as sv

    rep = {}
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
    torch.cuda.synchronize()
    rep["init_s"] = round(time.perf_counter() - t0, 2)
    rep["params_rank"] = sum(p.numel() for p in params.parameters())
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=g,
                            device="cuda", dtype=torch.int32)
    clock = CollectiveClock(torch)
    try:
        prefill = sv.build_prefill(cfg, mesh=mesh, gather=False)
        zero_counts()
        logits = prefill(params, {"tokens": prompts})
        if logits.shape != (PREFILL_B, PREFILL_S, cfg.vocab_size // mesh.shape["model"]):
            raise AssertionError(f"tp prefill logits {tuple(logits.shape)}")
        del logits
        clock.take()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        times, colls = [time.perf_counter() - t], [clock.take()]
        rep["prefill_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
        counts = read_counts()
        tc = _module("flash_attention").launches_tc
        want = only_counts(flash_attention=cfg.n_layers * 2)
        if counts != want or tc != cfg.n_layers * 2:
            raise AssertionError(f"tp prefill launches {counts} ({tc} tensor-core), "
                                 f"expected {cfg.n_layers} a call, all tensor-core")
        launches = dict(counts, **{"flash_attention[tensor_core]": tc})
        rep["prefill_ms"] = [round(1e3 * t, 2) for t in times]
        rep["prefill_tokens_per_s"] = round(PREFILL_B * PREFILL_S / min(times), 1)
        rep["prefill_collectives"] = colls
        tail = shd.gather_tensor(logits[:, -PREFILL_TAIL:].contiguous(),
                                 (None, None, "model"), mesh).float()
        del logits
        if rank == 0:
            want_tail = torch.load(pathlib.Path(out_dir, "prefill_tail.pt")).to("cuda")
            check_logits(torch, f"tp M={TP_M} prefill vs M=1, each prompt's last "
                         f"{PREFILL_TAIL} positions", tail, want_tail)
            del want_tail
        del tail

        cache = M.init_cache(cfg, DECODE_B, DECODE_32K.seq_len, mesh=mesh)
        prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, TP_PROMPT), generator=g,
                               device="cuda", dtype=torch.int32)
        step = sv.build_decode_step(cfg, mesh=mesh)
        zero_counts()
        stepped = []
        for i in range(TP_PROMPT):
            lg, cache = step(params, cache, prompt[:, i:i + 1])
            stepped.append(lg)
        gen = []
        clock.take()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TP_NEW_TOKENS):
            gen.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
            lg, cache = step(params, cache, gen[-1])
            stepped.append(lg)
        torch.cuda.synchronize()
        rep["decode_ms"] = round(1e3 * (time.perf_counter() - t) / TP_NEW_TOKENS, 3)
        rep["decode_collectives_per_step"] = {k: round(v / TP_NEW_TOKENS, 3)
                                              for k, v in clock.take().items()}
        rep["decode_tokens_per_s"] = round(DECODE_B / rep["decode_ms"] * 1e3, 1)
        rep["cache_heads"] = cache["layers"]["k"].shape[2]
        if read_counts() != only_counts():
            raise AssertionError(f"tp decode launched {read_counts()}")
        seq = torch.cat([prompt] + gen, dim=1)
        pf = sv.build_prefill(cfg, mesh=mesh)(params, {"tokens": seq}).float()
        st = torch.cat(stepped, dim=1).float()
        if not bool(torch.isfinite(st).all()):
            raise AssertionError("tp: non-finite decode logits")
        if rank == 0:
            check_logits(torch, f"tp M={TP_M} decode vs one prefill of the same "
                         f"{seq.shape[1]} tokens", st, pf)
        rep["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    finally:
        clock.close()
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rep


def tp_train(torch, cfg, M_, rank, runs, grads_file=None, hold=True, K=TRAIN_K,
             n_mal=TRAIN_MALICIOUS, f=2) -> tuple:
    """The TP training part on one rank: per (method, backend, steps) of
    ``runs`` that many steps of ``build_train_step`` on the mesh {data K, model M}
    from seed 0, IPM-100 on ``n_mal`` of K, AdamW; the hold of
    ``TPObserver`` (the step-1 gradients only with ``grads_file``, the
    route only with ``hold``); WFAgg's ``f``.  Returns (launches, report)."""
    from repro_torch.core.wfagg import WFAggConfig

    import torch.distributed as dist

    from repro_torch.core import flatten as F
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import trainer as tr

    mesh = make_test_mesh(data=K, model=M_, model_group=dist.group.WORLD)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, K)
    batches = with_modal(torch, cfg, [stream.batch(i, device="cuda")
                                      for i in range(max(r[2] for r in runs))])
    launches = dict.fromkeys(KERNELS, 0)
    report = {}
    clock = CollectiveClock(torch)
    try:
        for method, backend, steps, *rest in runs:
            opts = rest[0] if rest else {}
            flat = opts.get("layout") == "flat"
            run_cfg, tc = run_config(cfg, method, backend, opts, n_malicious=n_mal,
                                     wfagg=WFAggConfig(f=f, transient=3, window=3))
            state = tr.init_train_state(run_cfg, tc,
                                        torch.Generator(device="cuda").manual_seed(0), mesh)
            if flat:
                obs = FlatObserver(torch, tc, state.agg_state, hold and method != "mean",
                                   clock, state.params, mesh)
            else:
                obs = TPObserver(torch, tc, state.agg_state, hold and method != "mean", clock,
                                 state.params,
                                 grads_m1=grads_file if (method, backend, opts) == (
                                     *runs[0][:2], {}) else None)
            obs.tc_k, obs.mesh = K, mesh
            obs.hold_ada = hold and run_cfg.optimizer == "adafactor"
            route = pathlib.Path(str(grads_file or "") + ".route")
            if cfg.n_experts and obs.grads_m1 is not None and route.is_file():
                obs.grads_route = str(route)
            step = tr.build_train_step(run_cfg, tc, mesh, observe=obs)
            losses, weights = [], []
            for b in batches[:steps]:
                obs.start()
                obs.batch = b
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                weights.append([round(float(w), 4) for w in m["weights"]])
            needs_gram = method == "alt_wfagg" or tc.agg.gather_dtype is not None
            plan = ({} if flat else
                    {k: c for k, c in tp_plan(rank, method, backend, needs_gram).items() if c})
            label = run_label(method, backend, opts)
            for i, got in enumerate(obs.launches):
                if got != plan:
                    raise AssertionError(f"tp {label} step {i + 1} on rank {rank}: "
                                         f"launches {got}, planned {plan}")
            for k, c in plan.items():
                launches[k] += c * steps
            report[label] = dict(P=[b.numel() for b in F.layout_split(state.params)],
                                 attack=tc.attack, losses=losses, weights=weights, ms=[
                {k: round(v, 2) for k, v in s.items()} for s in obs.steps],
                peak_gib=obs.peaks, launches_per_step=plan, near_ties=obs.near_ties,
                max_out_err=obs.max_err, grad_rms_vs_m1=obs.grad_rms,
                adafactor_err=obs.adafactor_err,
                grad_routing=getattr(obs, "routing", None),
                tokens_per_s=[round(1e3 * batches[0]["tokens"].numel()
                                    / sum(s[p] for p in ("grads", "attack", "allreduce",
                                                         "optimizer")), 1)
                              for s in obs.steps])
            del state, step, obs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        clock.close()
    return launches, report


def tp_child(rank, S, store_path, out_dir, backend) -> None:
    """One rank of the model-axis part: joins the ``backend`` group of S
    ranks (on card ``rank`` modulo the cards); the serving part, then the
    training part (``out_dir``/``tp_job.json`` names the model, the runs and
    the steps); writes its launches and report as JSON."""
    import os

    job = json.loads(pathlib.Path(out_dir, "tp_job.json").read_text())
    if job.get("expandable"):
        # before the first allocation: a card nearly full of train state
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    res = {"rank": rank}
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.launch.mesh import make_test_mesh

        dist.init_process_group(backend, store=dist.FileStore(store_path, S), rank=rank,
                                world_size=S)
        try:
            cfg = job_config(get_config, {"arch": job["arch"],
                                          "layers": job.get("serve_layers")})
            launches = dict.fromkeys(KERNELS, 0)
            res["report"] = {}
            if job["serve"]:
                mesh = make_test_mesh(data=1, model=S, model_group=dist.group.WORLD)
                la, res["report"]["serve"] = tp_serve(torch, cfg, mesh, out_dir, rank)
                for k in KERNELS:
                    launches[k] += la[k]
                res["tc"] = la["flash_attention[tensor_core]"]
            # training at the job's depth (serving at its serve_layers, or uncut)
            cfg = job_config(get_config, {"arch": job["arch"], "layers": job.get("train_layers")})
            la, res["report"]["train"] = tp_train(
                torch, cfg, S, rank, [tuple(r) for r in job["runs"]],
                grads_file=job.get("grads"), hold=job["hold"])
            for k in KERNELS:
                launches[k] += la[k]
            res["launches"] = {"tp": launches}
        finally:
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 - the parent fails the run on it
        import traceback
        res["error"] = traceback.format_exc()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def tp_reference(torch, out_dir, train_layers=None, serve_layers=None) -> None:
    """What the ranks are held to at M = 1, computed here before they start
    and freed: the seed-0 Qwen's prefill tail (cut to ``serve_layers``; 2 x
    8192, its last ``PREFILL_TAIL`` positions, f32) and the K candidate
    gradients of the first training batch on the seed-0 model cut to
    ``train_layers`` (a (K, P) float32 file in ravel order)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.flatten import layout_flat
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import model as M
    from repro_torch.train import serve as sv
    from repro_torch.train import trainer as tr

    cfg = job_config(get_config, {"arch": TP_ARCH, "layers": serve_layers})
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=g,
                            device="cuda", dtype=torch.int32)
    logits = sv.build_prefill(cfg)(params, {"tokens": prompts})
    torch.save(logits[:, -PREFILL_TAIL:].float().cpu(), pathlib.Path(out_dir, "prefill_tail.pt"))
    del logits
    if train_layers:
        del params
        cfg = dataclasses.replace(cfg, n_layers=train_layers)
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    P = layout_flat(params).numel()
    batch = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_K).batch(0, device="cuda")
    rows = batch["tokens"].shape[0] // TRAIN_K
    with open(pathlib.Path(out_dir, "grads_m1.f32"), "wb") as f:
        G = torch.empty((P,), dtype=torch.float32, device="cuda")
        for k in range(TRAIN_K):
            tr.loss_and_grad(cfg, params, {"tokens": batch["tokens"][k * rows:(k + 1) * rows]},
                             G)
            f.write(G.cpu().numpy().tobytes())
    del params, G
    gc.collect()
    torch.cuda.empty_cache()


def time_tp_kernels(torch, K, D, heads) -> dict:
    """Kernels 4, 6 and 7 at the model axis's launch shape, (K, D = P_s)
    with ``prev``, the Gram and the combine with ``lcoef`` = 0 (the wrappers
    ``*_cuda``, median CUDA-event ms), beside their plain versions (kernel
    4's in column chunks), bounds and ``torch.mm`` (kernel 6) and ``addmv``
    (kernel 7); and kernel 8 at a rank's heads of the TP prefill
    (``time_flash``)."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    g = torch.Generator(device="cuda").manual_seed(61)
    u = torch.randn((K, D), generator=g, device="cuda")
    prev = torch.randn((K, D), generator=g, device="cuda")
    out = {}
    b = bound(4.0 * 2 * K * D, D * (2.0 * network_compare_exchanges(K) + 15.0 * K))
    out["robust_stats"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_cuda(u, prev, 0.1, False), 2, 10),
        plain_ms=time_cuda(torch, lambda: chunked_plain_stats(torch, u, prev), 1, 3),
        bound_ms=b[0], bound_by=b[1], library_ms=None, shape=f"K={K} D={D}, prev")
    del prev
    from repro_torch.kernels.pairwise_dist import kernel as pk
    from repro_torch.kernels.pairwise_dist import ops as pops

    b = bound(4.0 * K * D, float(K * (K + 1)) * D)
    out["pairwise_gram"] = dict(
        ms=time_cuda(torch, lambda: pk.pairwise_gram_cuda(u), 2, 10),
        plain_ms=time_cuda(torch, lambda: pops.pairwise_gram_plain(u), 1, 3),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_cuda(torch, lambda: torch.mm(u, u.t()), 2, 10), shape=f"K={K} D={D}")
    w = torch.ones((K,), device="cuda")
    w[2] = w[6] = 0.0
    wvec = w / w.sum()
    lcoef = torch.zeros((1,), device="cuda")
    local = torch.zeros((D,), device="cuda")
    b = bound(4.0 * (K + 2) * D, 2.0 * K * D)
    out["weighted_agg"] = dict(
        ms=time_cuda(torch, lambda: wk.weighted_agg_cuda(wvec, lcoef, local, u), 2, 10),
        plain_ms=time_cuda(torch, lambda: wops.weighted_agg_plain(wvec, lcoef, local, u),
                           1, 3),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_cuda(torch, lambda: torch.addmv(local, u.t(), wvec, beta=0.0), 2, 10),
        shape=f"K={K} D={D}, lcoef 0")
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"  {name} at the model axis's shape {t['shape']}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"library {lib}")
    del u, local
    torch.cuda.empty_cache()
    # kernel 8 at a rank's heads of Qwen's prefill: B=2, H/M, S=8192, hd=64
    out["flash_attention"] = time_flash(torch, PREFILL_B, heads, PREFILL_S, 64, seed=62)
    return out


def run_tp_path(torch, backend="gloo", S=TP_M, serve_layers=None) -> tuple:
    """The model axis on one card: ``TP_M`` gloo ranks share it (a
    ``FileStore``, as the distributed phase's), each one TP shard of
    Qwen1.5-0.5B (seed 0; uncut, or served at ``serve_layers``): serving
    (``tp_serve``) and training
    (``tp_train``: WFAgg on ``fused`` and ``fused_two_launch``, Alt-WFAgg on
    ``fused``, the mean; K = 8, S = 1025, IPM-100 on 2, AdamW lr 1e-3,
    the steps of ``TP_RUNS``), held to M = 1 (``tp_reference``) and to the
    reference backend's route.  Returns (launches summed over the ranks,
    report)."""
    import tempfile

    card = gpu_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_reference(torch, tmp, TP_TRAIN_LAYERS, serve_layers)
    ref_s = time.perf_counter() - t0
    pathlib.Path(tmp, "tp_job.json").write_text(json.dumps(dict(
        arch=TP_ARCH, serve=True, runs=TP_RUNS + TP_FLAT_RUNS, hold=True,
        train_layers=TP_TRAIN_LAYERS, serve_layers=serve_layers,
        grads=str(pathlib.Path(tmp, "grads_m1.f32")))))
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(torch, backend, S, child=tp_child, tmp=tmp, timeout=TP_TIMEOUT_S)
    finally:
        for name in ("grads_m1.f32", "prefill_tail.pt"):
            pathlib.Path(tmp, name).unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    launches, rep = report_tp(ranks, card, ref_s, seconds, TP_ARCH,
                              "gloo, one card" if backend == "gloo" else f"nccl, {S} cards")
    P_s = ranks[0]["report"]["train"]["wfagg fused"]["P"][0]
    rep["kernels"] = time_tp_kernels(torch, TRAIN_K, P_s, 16 // S)
    return launches, rep


def run_tp_cards(torch) -> dict:
    """``--only cards``' model-axis part: Qwen1.5-0.5B on M = the number of
    cards (``nccl``, one rank a card) with the one-card part's checks; with
    four cards first LLaVA-NeXT-34B trained (``run_llava_cards``) and
    Arctic's plan (``run_arctic_cards``), then ``CARDS_TP_ARCH`` uncut at
    M = 4, K = 8, WFAgg-T on
    ``fused``, ``CARDS_TP_STEPS`` steps under IPM-100, its train state
    existing only across the cards (peak per card and step time; no
    one-card hold fits), on the stacked layout and then on the flat layout
    (each rank's (K, P_s) and (K, P_r) buffers, no ``prev``: its peak a card
    beside the stacked route's)."""
    import tempfile

    S = torch.cuda.device_count()
    out = {}
    launches = dict.fromkeys(KERNELS, 0)
    if S == 4:
        # first the largest runs: LLaVA-NeXT-34B trained, Arctic's plan
        la, out["llava"] = run_llava_cards(torch)
        for k in KERNELS:
            launches[k] += la[k]
        out["arctic"] = run_arctic_cards(torch)
    la, rep = run_tp_path(torch, "nccl", S)
    for k in KERNELS:
        launches[k] += la[k]
    out["qwen"] = rep
    if S == 4:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
        pathlib.Path(tmp, "tp_job.json").write_text(json.dumps(dict(
            arch=CARDS_TP_ARCH, serve=False, runs=(
                ("wfagg", "fused", CARDS_TP_STEPS),
                ("wfagg", "fused", CARDS_TP_STEPS, {"layout": "flat"})),
            hold=False, expandable=True)))
        t0 = time.perf_counter()
        ranks = run_ranks(torch, "nccl", S, child=tp_child, tmp=tmp, timeout=TP_TIMEOUT_S)
        la, out["stablelm"] = report_tp(ranks, gpu_line(), 0.0, time.perf_counter() - t0,
                                        CARDS_TP_ARCH, f"nccl, {S} cards")
        peaks = {label: max(t["peak_gib"]) for label, t in
                 ranks[0]["report"]["train"].items()}
        print(f"  {CARDS_TP_ARCH} at M = {S}, K = {TRAIN_K}: peak GiB a card {peaks} "
              f"({gpu_line()})")
        for k in KERNELS:
            launches[k] += la[k]
    out["launches"] = {k: c for k, c in launches.items() if c}
    return out


def report_tp(ranks, card, ref_s, seconds, arch, where, K=TRAIN_K, n_mal=TRAIN_MALICIOUS
              ) -> tuple:
    """Print the TP ranks' reports; the attackers at weight 0 and the WFAgg
    loss claim; returns (launches summed over the ranks, report)."""
    from repro_torch.core.topology import spaced_malicious

    launches = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        for k, c in r["launches"]["tp"].items():
            launches[k] += c
    rep = {"card": card, "ranks": len(ranks), "reference_s": round(ref_s, 1),
           "ranks_s": round(seconds, 1), "per_rank": [r["report"] for r in ranks]}
    r0 = ranks[0]["report"]
    print(f"  {card}: {arch} on {len(ranks)} model ranks ({where}); M = 1 reference "
          f"{ref_s:.1f} s, the ranks {seconds:.1f} s")
    if "serve" in r0:
        for r in ranks:
            s = r["report"]["serve"]
            print(f"  rank {r['rank']} serve: {s['params_rank']} parameters; prefill "
                  f"{PREFILL_B} x {PREFILL_S} ms {s['prefill_ms']} ({s['prefill_tokens_per_s']} "
                  f"tokens/s; collectives per call {s['prefill_collectives']}), peak "
                  f"{s['prefill_peak_gib']} GiB; decode batch {DECODE_B} at 32,768 slots "
                  f"({s['cache_heads']} KV heads a rank) {s['decode_ms']} ms a step "
                  f"({s['decode_tokens_per_s']} tokens/s; collectives per step "
                  f"{s['decode_collectives_per_step']}), peak {s['peak_gib']} GiB")
    for label in r0["train"]:
        for r in ranks:
            t = r["report"]["train"][label]
            phases = [{p: s.get(p) for p in ("grads", "attack", "allreduce", "optimizer",
                                             "activations", "psum_stats")} for s in t["ms"]]
            route = ("the one-process flat route on the whole candidates" if " flat" in label
                     else "the reference route")
            print(f"  rank {r['rank']} train {label}: loss {[round(x, 4) for x in t['losses']]}"
                  f", weights {t['weights'][-1]}; launches a step {t['launches_per_step']}; "
                  f"ms per step {phases}; tokens/s {t['tokens_per_s']}; peak GiB "
                  f"{t['peak_gib']}; held to {route} (max|diff| "
                  f"{t['max_out_err']:.3g}, near-ties {t['near_ties'] or 'none'})"
                  + (f"; step-1 candidates vs M = 1, relative rms {t['grad_rms_vs_m1']}"
                     if t["grad_rms_vs_m1"] else "")
                  + (f"; Adafactor's blocks vs one process, largest difference "
                     f"{t['adafactor_err']:.3g} of the leaf's largest update"
                     if t.get("adafactor_err") is not None else ""))
    tr0 = r0["train"]
    bad = [k for k, m in enumerate(spaced_malicious(K, n_mal)) if m]
    for label, t in tr0.items():
        if not all(map(math.isfinite, t["losses"])):
            raise AssertionError(f"tp {label}: non-finite loss {t['losses']}")
        if (not label.startswith("mean") and t["attack"] == TRAIN_ATTACK
                and any(w[k] != 0.0 for w in t["weights"] for k in bad)):
            raise AssertionError(f"tp {label}: an attacker got weight: {t['weights']}")
    two = tr0.get("wfagg fused_two_launch")
    if two is not None:
        one = tr0["wfagg fused"]
        n = len(two["losses"])
        if two["losses"] != one["losses"][:n] or two["weights"] != one["weights"][:n]:
            raise AssertionError(f"tp: fused_two_launch {two['losses']} {two['weights']} is "
                                 f"not the fused route's first {n} steps")
        print(f"  fused_two_launch equals the fused route bit for bit over {n} steps (one "
              "route on the model axis)")
    if "mean fused" not in tr0:
        return launches, rep
    w = tr0["wfagg fused"]["losses"]
    mean = tr0["mean fused"]["losses"]
    if not (w[-1] < w[0] and w[-1] < mean[-1]):
        raise AssertionError(f"tp: WFAgg's last loss {w[-1]} is not below its first {w[0]} "
                             f"and the mean's {mean[-1]}")
    print(f"  the claim on the model axis: WFAgg's loss {w[0]:.4f} -> {w[-1]:.4f}, the "
          f"mean's {mean[0]:.4f} -> {mean[-1]:.4f} under {TRAIN_ATTACK}")
    return launches, rep


# ---------------------------------------------------------------------------
# phase 3: the data axis as processes (the K x M grid of launch/mesh.py,
# FSDP blocks of core/flatten.py and models/model.py, the stacked
# all-reduce's data-axis route, serving FSDP over data)
# ---------------------------------------------------------------------------

GRID_ARCH = "qwen1.5-0.5b"
GRID_K, GRID_M = 4, 2          # 8 gloo ranks sharing the one card
# (method, backend, steps) of the grid's training runs, fsdp_params on,
# IPM-100 on spaced_malicious(4, 1) = candidate 2 (WFAgg cut from 3 steps
# to 2 and Alt-WFAgg from 2 to 1 beside the families' part)
GRID_RUNS = (("wfagg", "fused", 2), ("alt_wfagg", "fused", 1), ("mean", "fused", 2),
             # the flat layout on the grid (no FSDP blocks; the chunked all-reduce
             # over the data group on each rank's model block, the statistics
             # summed over the model group), held to the one-process flat route
             ("wfagg", "fused", 2, {"layout": "flat"}))
GRID_MALICIOUS = 1
GRID_F = 1                     # WFAgg's f at K = 4: the one attacker
# the step-1 candidate gradients on the grid against one process's on the
# same parameters and rows: relative rms of each candidate's whole gradient.
# A grid rank computes its candidate at M = 2 as the model axis does (bf16
# partial sums rounded before they meet); fixed before the first run as
# TP_GRAD_RMS: a wrong block, row or gather is an O(1) error
GRID_GRAD_RMS = 5e-2
# decode on the grid: a teacher-forced sequence of this many tokens a row
# (each step gathers every layer's weights over the data group, ~2.6 s a
# step on gloo ranks sharing one H100), the last GRID_DECODE_TIMED steps
# timed (4 tokens, 2 timed, until the encoder-decoder and VLM rows of the
# families' part, the whole script's time)
GRID_DECODE, GRID_DECODE_TIMED = 2, 1
GRID_TIMEOUT_S = 600
# Qwen on the grid at 12 of its 24 layers, served and trained (cut in this
# slice beside its flat run, the whole script's time; 8 layers took as long:
# the ranks' start, the first step and the embedding's gathers are the time)
GRID_LAYERS = 12
CARDS_GRID_ARCH = "stablelm-3b"   # --only cards: K = 4 x M = 1 on four nccl cards
CARDS_GRID_STEPS = 3


class GridClock(CollectiveClock):
    """The grid's collectives timed apart, besides the model axis's
    (``CollectiveClock``): the FSDP gathers of the parameters over the data
    group (``spmd.all_gather_rows`` where the model calls it: once a step
    for training, once a layer for serving) and the trainer's exchange
    (``all_to_all_rows``, and ``all_gather_rows`` for the leaves whole over
    data)."""

    def __init__(self, torch):
        super().__init__(torch)
        from repro_torch.distributed import spmd
        from repro_torch.train import trainer as tr

        self.spmd, self.tr = spmd, tr
        self.grid_orig = (spmd.all_gather_rows, tr.all_to_all_rows, tr.all_gather_rows)
        self.ms.update(param_gather=0.0, exchange=0.0)
        self.calls.update(param_gather=0, exchange=0)
        spmd.all_gather_rows = self.wrap(self.grid_orig[0], "param_gather")
        tr.all_to_all_rows = self.wrap(self.grid_orig[1], "exchange")
        tr.all_gather_rows = self.wrap(self.grid_orig[2], "exchange")

    def close(self):
        super().close()
        self.spmd.all_gather_rows, self.tr.all_to_all_rows, self.tr.all_gather_rows = \
            self.grid_orig


def grid_plan(model, mesh, method) -> dict:
    """The launches one grid step plans on this rank: kernel 4 on each
    non-empty column group the rank counts (the model-split, data-split
    one everywhere; those whole over data on data rank 0, the
    model-replicated ones on model rank 0), kernel 6 likewise for
    Alt-WFAgg, kernel 7 on every non-empty group; the mean: none."""
    from repro_torch.core import flatten as F
    from repro_torch.train import trainer as tr

    if method == "mean":
        return {}
    shards = tr.grid_shards(model, mesh)
    live = [w > 0 for w in F.fsdp_widths(model)]
    counted = sum(1 for c, n in zip(shards.counted, live) if c and n)
    plan = {"robust_stats": counted, "weighted_agg": sum(live)}
    if method == "alt_wfagg":
        plan["pairwise_gram"] = counted
    return plan


class GridObserver(TPObserver):
    """The grid trainer's ``observe`` hook on one rank: ``TPObserver``'s
    phases, launches, peak memory and holds, on the rank's column block:
    at every step the data-axis route of the reference backend (per leaf
    plain statistics of the counted column groups, summed over the grid,
    the reference's scoring and ``tensordot`` combine) on the same column
    block and state, held to the step's route (masks bit-equal or near-ties
    by ``NEAR_TIE``, weights within ``STACK_W_TOL``, the aggregate's blocks
    within rtol ``STACK_RTOL`` / atol ``STACK_ATOL``); and at step 1 the
    rank's candidate gradient against one process's (row k of
    ``grads_m1``, cut to the rank's model block), the squared sums summed
    over the model group."""

    def __init__(self, torch, tc, agg_state, hold, clock, model, mesh, grads_m1=None):
        super().__init__(torch, tc, agg_state, hold, clock, model, grads_m1)
        self.mesh = mesh

    def __call__(self, phase, **v):
        if phase == "exchange":
            self.torch.cuda.synchronize()
            self.cur[phase] = 1e3 * (time.perf_counter() - self.t)
            self.torch.cuda.synchronize()
            self.t = time.perf_counter()
            return
        super().__call__(phase, **v)

    def hold_grads(self, vecs) -> list:
        import numpy as np

        from repro_torch.core import flatten as F
        from repro_torch.models import layers as L

        torch = self.torch
        model, mesh = self.model, self.mesh
        axis = mesh.model_axis()
        k = mesh.data_axis().rank
        lay = model.fsdp
        full = np.memmap(self.grads_m1, dtype=np.float32, mode="r")
        K = mesh.data_axis().size
        full = full.reshape(K, -1)[k]
        sets = (F.split_groups(model) if axis is not None else [F.leaf_params(model)])
        num = torch.zeros((), dtype=torch.float64, device="cuda")
        den = torch.zeros((), dtype=torch.float64, device="cuda")
        # the whole gradient's ravel order: each leaf's place in it
        from repro_torch.distributed import sharding as shd

        offs, off = {}, 0
        for (path, ps), c in zip(F.leaf_params(model), F.split_cuts(model)):
            shape = ([len(ps)] if path[0] in F.STACKED else []) + list(lay.shapes[path])
            if c is not None:
                shape[c[0].dim] *= axis.size
            offs[path] = (off, shape, None if c is None else c[0])
            off += math.prod(shape)
        if off != full.shape[0]:
            raise AssertionError(f"grid grads: {off} of {full.shape[0]} values")
        for b, (vec, leaves) in enumerate(zip(vecs, sets)):
            if b == 1 and axis.rank:
                continue            # the replicated leaves count on model rank 0
            at = 0
            for path, ps in leaves:
                o, shape, cut = offs[path]
                n = math.prod(shape)
                want = torch.from_numpy(np.ascontiguousarray(full[o:o + n])).view(shape)
                if cut is not None:
                    want = shd.take_block(want, cut, axis.size, axis.rank)
                want = want.to("cuda").reshape(-1)
                got = vec[at:at + want.numel()]
                at += want.numel()
                num += ((got - want).double() ** 2).sum()
                den += (want.double() ** 2).sum()
                del want
        tot = torch.stack([num, den]).float()
        if axis is not None:
            tot = L.all_reduce_model(tot, axis.group)
        rms = float((tot[0] / tot[1]).sqrt())
        if rms > GRID_GRAD_RMS:
            raise AssertionError(f"grid step 1: candidate {k}'s gradient at relative rms "
                                 f"{rms} of one process's (bound {GRID_GRAD_RMS})")
        return [round(rms, 6)]

    def route(self, cands, state):
        import dataclasses

        from repro_torch.distributed import robust_allreduce as ra
        from repro_torch.train import trainer as tr

        self.shards = tr.grid_shards(self.model, self.mesh)
        self.cfg_ref = dataclasses.replace(self.tc.agg, backend="reference")
        st = ra.TreeAggState(state.prev, *self.hist)
        self.cands, self.state = cands, st
        o, ns, info = ra.robust_allreduce_stacked(cands, self.cfg_ref, st,
                                                  model_shards=self.shards)
        self.hist = (ns.hist_s, ns.hist_b, ns.count, ns.t)
        self.ref = (o, info["weights"], {k: info[k] for k in ("mask_d", "mask_c", "mask_t")})

    def compare(self, grads, info):
        from repro_torch.models import layers as L

        torch = self.torch
        o, w, masks = self.ref
        flips = [(k, bit) for bit, name in enumerate(("mask_d", "mask_c", "mask_t"))
                 for k in (masks[name] != info[name]).nonzero().flatten().tolist()]
        label = f"grid {self.tc.agg.method} {self.tc.agg.backend} step {len(self.steps) + 1}"
        keep = torch.ones(w.shape[0], dtype=torch.bool, device="cuda")
        if flips:
            rep = grid_margins(torch, self.cfg_ref, self.cands, self.state, flips, self.shards)
            print(f"  {label}: decisions differ at (candidate, filter, margin) {rep}")
            if not all(m is not None and m <= NEAR_TIE for _, _, m in rep):
                raise AssertionError(f"{label}: decisions differ away from any edge")
            self.near_ties.append((len(self.steps) + 1, rep))
            keep[[k for k, _ in flips]] = False
        torch.testing.assert_close(info["weights"][keep], w[keep], rtol=0, atol=STACK_W_TOL)
        if not flips:
            err = close_leafwise(torch, grads, o, STACK_RTOL, STACK_ATOL)
            err = float(L.all_max_model(torch.tensor([err], device="cuda"),
                                        self.shards.group)[0])
            self.max_err = max(self.max_err, err)
        self.ref = self.cands = self.state = None


def grid_margins(torch, cfg, cands, state, flips, shards):
    """``stacked_margins`` on the grid: the reference route's statistics of
    the rank's counted column groups, summed over the grid (every rank
    takes part)."""
    from repro_torch.core import trust
    from repro_torch.distributed import robust_allreduce as ra

    leaves = ra._leaves(cands)
    K = leaves[0].shape[0]
    n = len(shards.counted)
    groups = [[l for l, g in zip(leaves, shards.leaf_groups) if g == i] for i in range(n)]
    prev = None
    if state is not None:
        pl = ra._leaves(state.prev)
        prev = [[p for p, g in zip(pl, shards.leaf_groups) if g == i] for i in range(n)]
    mine = [i for i in range(n) if shards.counted[i]]
    st = ra.psum_stats(ra._partial_stats(
        K, leaves[0].device, [groups[i] for i in mine],
        None if prev is None else [prev[i] for i in mine], cfg), shards.group)
    st = ra.RobustStats(*(None if v is None else v[0] for v in st))
    wcfg = ra._effective_wfagg_config(cfg, K)
    s = b = tb = None
    if state is not None:
        tb = trust.temporal_bands(state.hist_s, state.hist_b, state.count, state.t, wcfg)[None]
        s = st.prev_dist2
        b = 1.0 - st.prev_dot / torch.clamp(torch.sqrt(st.norm2 * st.prev_norm2), min=1e-24)
    return margins_of(torch, wcfg, st.dist2, st.gram, st.dotmed, st.mednorm2, s, b, tb, flips)


def grid_serve(torch, cfg, mesh, out_dir, rank) -> tuple:
    """The grid's serving part on one rank: the model as FSDP blocks of the
    rank's model block (``init_params(mesh=)``), a prefill of K x 8192 (one
    row a data rank; each layer's weights gathered over the data group just
    before it; kernel 8 on the rank's H/M heads, one launch a layer), the
    last ``PREFILL_TAIL`` positions' logits gathered and, on rank 0, held
    to one process's (written by the parent) by the dense rule; decode at
    batch K against 32,768 slots over ``GRID_DECODE`` teacher-forced
    tokens (0 launches), the gathered logits held to one process's by the
    dense rule.  Returns (launches, report)."""
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.train import serve as sv

    rep = {}
    K = mesh.shape["data"]
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
    torch.cuda.synchronize()
    rep["init_s"] = round(time.perf_counter() - t0, 2)
    rep["params_rank"] = sum(p.numel() for p in params.parameters())
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (K, PREFILL_S), generator=g, device="cuda",
                            dtype=torch.int32)
    clock = GridClock(torch)
    try:
        prefill = sv.build_prefill(cfg, mesh=mesh, gather=False)
        zero_counts()
        clock.take()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        rep["prefill_collectives"] = clock.take()
        rep["prefill_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
        M_ = mesh.shape["model"]
        if logits.shape != (1, PREFILL_S, cfg.vocab_size // M_):
            raise AssertionError(f"grid prefill logits {tuple(logits.shape)}")
        counts = read_counts()
        tc = _module("flash_attention").launches_tc
        n_flash = flash_layers(cfg)
        want = only_counts(flash_attention=n_flash)
        if counts != want or tc != n_flash:
            raise AssertionError(f"grid prefill launches {counts} ({tc} tensor-core), "
                                 f"expected {n_flash}, all tensor-core")
        launches = dict(counts, **{"flash_attention[tensor_core]": tc})
        rep["prefill_ms"] = round(ms, 2)
        rep["prefill_tokens_per_s"] = round(K * PREFILL_S / ms * 1e3, 1)
        tail = shd.gather_tensor(logits[:, -PREFILL_TAIL:].contiguous(),
                                 ("data", None, "model"), mesh).float()
        del logits
        if rank == 0:
            grid_hold(torch, out_dir, "prefill_tail", f"grid {K} x {M_} prefill, each "
                      f"prompt's last {PREFILL_TAIL} positions,", tail)
        del tail

        cache = M.init_cache(cfg, K, DECODE_32K.seq_len, mesh=mesh)
        kv = cache["layers"]["attn"] if cfg.family == "hybrid" else cache["layers"]
        rep["cache_rows"] = kv["k"].shape[-4]
        rep["cache_heads"] = kv["k"].shape[-3]
        seq = torch.randint(0, cfg.vocab_size, (K, GRID_DECODE), generator=g, device="cuda",
                            dtype=torch.int32)
        step = sv.build_decode_step(cfg, mesh=mesh)
        zero_counts()
        stepped = []
        for i in range(GRID_DECODE):
            if i == GRID_DECODE - GRID_DECODE_TIMED:
                clock.take()
                torch.cuda.synchronize()
                t = time.perf_counter()
            lg, cache = step(params, cache, seq[:, i:i + 1])
            stepped.append(lg)
        torch.cuda.synchronize()
        rep["decode_ms"] = round(1e3 * (time.perf_counter() - t) / GRID_DECODE_TIMED, 3)
        rep["decode_collectives_per_step"] = {k_: round(v / GRID_DECODE_TIMED, 3)
                                              for k_, v in clock.take().items()}
        if read_counts() != only_counts():
            raise AssertionError(f"grid decode launched {read_counts()}")
        st = torch.cat(stepped, dim=1).float()
        if not bool(torch.isfinite(st).all()):
            raise AssertionError("grid: non-finite decode logits")
        if rank == 0:
            rep["decode_vs_f32"] = grid_hold(
                torch, out_dir, "decode", f"grid {K} x {M_} decode at batch {K}, 32,768 "
                f"slots, over the same {GRID_DECODE} tokens,", st)
        rep["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    finally:
        clock.close()
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rep


def grid_hold(torch, out_dir, name, label, got):
    """The grid's gathered logits against one process's (``name``.pt): the
    dense rule, or, where ``name``_truth.pt exists (an SSM or hybrid model)
    and the bf16 routes sit past it, ``SSM_TRUTH``'s rule.  Where
    ``name``_f32.pt exists (a dense model's decode in f32 activations, the
    measurement of where the grid's bf16 decode drift comes from), each
    token's distance of the grid and of one process from it is printed and
    returned (measured only: the hold stays the dense rule)."""
    want = torch.load(pathlib.Path(out_dir, f"{name}.pt")).to("cuda")
    truth = pathlib.Path(out_dir, f"{name}_truth.pt")
    f32 = pathlib.Path(out_dir, f"{name}_f32.pt")
    per_token = None
    if f32.exists():
        t = torch.load(f32).to("cuda")
        per_token = []
        for i in range(t.shape[1]):
            g = logit_gap(torch, f"{label} token {i}: the grid vs f32", got[:, i], t[:, i])
            o = logit_gap(torch, f"{label} token {i}: one process vs f32", want[:, i], t[:, i])
            b = logit_gap(torch, f"{label} token {i}: the grid vs one process", got[:, i],
                          want[:, i])
            per_token.append({"grid_vs_f32": g, "one_vs_f32": o, "grid_vs_one": b})
        del t
    if truth.exists():
        hold_bf16_route(torch, f"{label} grid", got, "one process", want,
                        torch.load(truth).to("cuda"))
    else:
        check_logits(torch, f"{label} vs one process", got, want)
    return per_token


def grid_train(torch, cfg, mesh, rank, runs, grads_file=None, hold=True, arch_tc=False
               ) -> tuple:
    """The grid's training part on one rank: per (method, backend, steps) of
    ``runs`` that many steps of ``build_train_step`` on the grid from seed
    0, K candidates of one row each at S = ``TRAIN_SEQ``, IPM-100 on
    ``GRID_MALICIOUS``, AdamW, ``fsdp_params`` on (``arch_tc``: the
    configuration ``launch.specs.train_config`` picks for the model, its
    backend the run's); the holds of ``GridObserver`` (the step-1 gradients
    only with ``grads_file``, the route only with ``hold``).  Returns
    (launches, report)."""
    import dataclasses

    from repro_torch.core import flatten as F
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import specs
    from repro_torch.train import trainer as tr

    K = mesh.shape["data"]
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, K)
    batches = with_modal(torch, cfg, [stream.batch(i, device="cuda")
                                      for i in range(max(r[2] for r in runs))])
    launches = dict.fromkeys(KERNELS, 0)
    report = {}
    clock = GridClock(torch)
    try:
        for method, backend, steps, *rest in runs:
            opts = rest[0] if rest else {}
            flat = opts.get("layout") == "flat"
            if arch_tc:
                tc = specs.train_config(cfg, multi_pod=False)
                tc = dataclasses.replace(tc, attack=TRAIN_ATTACK, n_malicious=GRID_MALICIOUS,
                                         lr=TRAIN_LR, warmup=0)
                tc = dataclasses.replace(tc, agg=dataclasses.replace(tc.agg, method=method,
                                                                     backend=backend))
            else:
                _, tc = run_config(cfg, method, backend, opts, n_malicious=GRID_MALICIOUS,
                                   wfagg=WFAggConfig(f=GRID_F, transient=3, window=3),
                                   fsdp_params=not flat)
            state = tr.init_train_state(cfg, tc, torch.Generator(device="cuda").manual_seed(0),
                                        mesh)
            if flat:
                # the grid holds its first flat step: each hold moves K whole
                # candidates through host memory to rank 0
                obs = FlatObserver(torch, tc, state.agg_state, hold and method != "mean",
                                   clock, state.params, mesh, first_only=True)
            else:
                obs = GridObserver(torch, tc, state.agg_state, hold and method != "mean", clock,
                                   state.params, mesh,
                                   grads_m1=grads_file if (method, backend, opts) == (
                                       *runs[0][:2], {}) else None)
            step = tr.build_train_step(cfg, tc, mesh, observe=obs)
            losses, weights = [], []
            for b in batches[:steps]:
                obs.start()
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                weights.append([round(float(w), 4) for w in m["weights"]])
            plan = {} if flat else grid_plan(state.params, mesh, method)
            label = run_label(method, backend, opts)
            for i, got in enumerate(obs.launches):
                if got != plan:
                    raise AssertionError(f"grid {label} step {i + 1} on rank {rank}: "
                                         f"launches {got}, planned {plan}")
            for k, c in plan.items():
                launches[k] += c * steps
            report[label] = dict(
                fsdp=tc.fsdp_params, losses=losses,
                widths=[b.numel() for b in F.layout_split(state.params)] if flat else
                F.fsdp_widths(state.params),
                weights=weights, ms=[{k: round(v, 2) for k, v in s.items()} for s in obs.steps],
                peak_gib=obs.peaks, launches_per_step=plan, near_ties=obs.near_ties,
                max_out_err=obs.max_err, grad_rms_vs_one=obs.grad_rms,
                tokens_per_s=[round(1e3 * batches[0]["tokens"].numel()
                                    / sum(s.get(p, 0.0) for p in ("grads", "exchange",
                                                                  "attack", "allreduce",
                                                                  "optimizer")), 1)
                              for s in obs.steps])
            del state, step, obs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        clock.close()
    return launches, report


def grid_child(rank, S, store_path, out_dir, backend) -> None:
    """One rank of the grid part: joins the ``backend`` group of S ranks (on
    card ``rank`` modulo the cards), builds the grid (``make_grid``); the
    serving part, then the training part (``out_dir``/``grid_job.json``
    names the model, K, M, the runs and the holds); writes its launches and
    report as JSON."""
    import os

    job = json.loads(pathlib.Path(out_dir, "grid_job.json").read_text())
    if job.get("expandable"):
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    res = {"rank": rank}
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.launch.mesh import make_grid

        dist.init_process_group(backend, store=dist.FileStore(store_path, S), rank=rank,
                                 world_size=S)
        try:
            cfg = job_config(get_config, job)
            mesh = make_grid(job["K"], job["M"])
            launches = dict.fromkeys(KERNELS, 0)
            res["report"] = {}
            if job["serve"]:
                la, res["report"]["serve"] = grid_serve(torch, cfg, mesh, out_dir, rank)
                for k in KERNELS:
                    launches[k] += la[k]
                res["tc"] = la["flash_attention[tensor_core]"]
            la, res["report"]["train"] = grid_train(
                torch, cfg, mesh, rank, [tuple(r) for r in job["runs"]],
                grads_file=job.get("grads"), hold=job["hold"], arch_tc=job.get("arch_tc", False))
            for k in KERNELS:
                launches[k] += la[k]
            res["launches"] = {"grid": launches}
            # further models trained in the same rank group (its start is most
            # of a grid part's time)
            res["more"] = []
            for more in job.get("more", ()):
                del cfg
                gc.collect()
                torch.cuda.empty_cache()
                cfg = job_config(get_config, more)
                la, train = grid_train(torch, cfg, mesh, rank, [tuple(r) for r in more["runs"]],
                                       grads_file=more["grads"], hold=job["hold"])
                res["more"].append({"rank": rank, "report": {"train": train},
                                    "launches": {"grid": la}})
        finally:
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 - the parent fails the run on it
        import traceback
        res["error"] = traceback.format_exc()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def grid_reference(torch, out_dir, arch, K, serve=True, layers=None, suffix="") -> None:
    """What the grid's ranks are held to in one process, computed here
    before they start and freed: the seed-0 model's prefill tail (K rows
    of 8192, one at a time, the last ``PREFILL_TAIL`` positions, f32), the
    decode logits of the same ``GRID_DECODE`` teacher-forced tokens at
    batch K against 32,768 slots, and the K candidate gradients of the
    first training batch (a (K, P) float32 file in ravel order,
    ``grads_one<suffix>.f32``; the modal rows beside the tokens,
    ``with_modal``); ``layers`` cuts the model's depth.  An SSM or hybrid
    model's prefill and decode also in f32 activations (``*_truth.pt``)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.core.flatten import layout_flat
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import model as M
    from repro_torch.train import serve as sv
    from repro_torch.train import trainer as tr

    cfg = job_config(get_config, {"arch": arch, "layers": layers})
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    if serve:
        g = torch.Generator(device="cuda").manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (K, PREFILL_S), generator=g,
                                device="cuda", dtype=torch.int32)
        seq = torch.randint(0, cfg.vocab_size, (K, GRID_DECODE), generator=g, device="cuda",
                            dtype=torch.int32)
        # an SSM or hybrid model also in f32 activations: the truth of
        # SSM_TRUTH's rule for its bf16 routes
        truth = cfg.family in ("ssm", "hybrid") and cfg.dtype != "float32"
        for c, tag in ((cfg, ""), (dataclasses.replace(cfg, dtype="float32"), "_truth")):
            if tag and not truth:
                continue
            prefill = sv.build_prefill(c)
            tails = [prefill(params, {"tokens": prompts[r:r + 1]})[:, -PREFILL_TAIL:].float()
                     .cpu() for r in range(K)]
            torch.save(torch.cat(tails), pathlib.Path(out_dir, f"prefill_tail{tag}.pt"))
            cache = M.init_cache(c, K, DECODE_32K.seq_len)
            step = sv.build_decode_step(c)
            out = []
            for i in range(GRID_DECODE):
                lg, cache = step(params, cache, seq[:, i:i + 1])
                out.append(lg.float().cpu())
            torch.save(torch.cat(out, dim=1), pathlib.Path(out_dir, f"decode{tag}.pt"))
            del cache
        if cfg.dtype != "float32" and not truth:
            # a dense model's decode in f32 activations beside its bf16 one:
            # each token's distance from it, printed by grid_hold (measured
            # only, the hold stays the dense rule)
            c = dataclasses.replace(cfg, dtype="float32")
            cache = M.init_cache(c, K, DECODE_32K.seq_len)
            step = sv.build_decode_step(c)
            out = []
            for i in range(GRID_DECODE):
                lg, cache = step(params, cache, seq[:, i:i + 1])
                out.append(lg.float().cpu())
            torch.save(torch.cat(out, dim=1), pathlib.Path(out_dir, "decode_f32.pt"))
            del cache, step
    P = layout_flat(params).numel()
    batch = with_modal(torch, cfg, [TokenStream(cfg.vocab_size, TRAIN_SEQ, K).batch(
        0, device="cuda")])[0]
    rows = batch["tokens"].shape[0] // K
    with open(pathlib.Path(out_dir, f"grads_one{suffix}.f32"), "wb") as f:
        G = torch.empty((P,), dtype=torch.float32, device="cuda")
        for k in range(K):
            tr.loss_and_grad(cfg, params, {n: v[k * rows:(k + 1) * rows]
                                           for n, v in batch.items()}, G)
            f.write(G.cpu().numpy().tobytes())
    del params, G
    gc.collect()
    torch.cuda.empty_cache()


# above this many columns two float32 Gram orders drift apart past rtol
# 1e-4 (at K = 4, D = 5.1e8: 4.3e-4 between the kernel and its plain
# version, measured on one H100): each is then held to the float64 Gram
GRAM_F64_D = 1 << 27


def hold_gram_f64(torch, u, gram, gp, where) -> None:
    """Kernel 6's Gram ``gram`` and its plain version's ``gp`` against the
    float64 Gram (column chunks of 2^24): the kernel's largest error may
    exceed the plain version's by at most rtol 1e-4 of the largest entry
    (``MOE_TRUTH``'s form: the two float32 sums' orders differ, and at
    this length neither is within 1e-4 of the other)."""
    want = torch.zeros((u.shape[0], u.shape[0]), dtype=torch.float64, device=u.device)
    for c in range(0, u.shape[1], 1 << 24):
        blk = u[:, c:c + (1 << 24)].double()
        want += blk @ blk.T
    ek = float((gram.double() - want).abs().max())
    ep = float((gp.double() - want).abs().max())
    top = float(want.abs().max())
    print(f"  pairwise_gram at {where} shape K={u.shape[0]} D={u.shape[1]} vs the float64 Gram: "
          f"kernel {ek:.4g}, plain {ep:.4g} (largest entry {top:.4g})")
    if ek > ep + 1e-4 * top:
        raise AssertionError(f"pairwise_gram at {where} shape: {ek} from the float64 Gram, "
                             f"more than 1e-4 of {top} past the plain version's {ep}")


def check_grid_kernels(torch, K, D, heads, where="a grid rank's") -> tuple:
    """Kernels 4, 6, 7 and 8 at a grid rank's launch shapes, each held
    against its plain version and timed (the wrappers ``*_cuda``, median
    CUDA-event ms) beside its bound and the PyTorch call: kernel 4 on the
    (K, D) column block with ``prev`` (statistics within rtol
    ``STAT_RTOL`` / atol ``STAT_ATOL`` of the column-chunked plain
    version), kernel 6 (the Gram within rtol 1e-4 of ``u @ u.T``, or past
    ``GRAM_F64_D`` columns by ``hold_gram_f64``, exactly symmetric;
    ``torch.mm``), kernel 7 with ``lcoef`` 0 (bit for bit;
    ``addmv``), kernel 8 at a rank's prefill (one row, H/M heads: o within
    one bf16 rounding; SDPA).  Returns (errors, times)."""
    from repro_torch.kernels.pairwise_dist import kernel as pk
    from repro_torch.kernels.pairwise_dist import ops as pops
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    g = torch.Generator(device="cuda").manual_seed(71)
    # gradient-like candidates: a shared direction plus each one's own part,
    # prev the last step's (sums over D that do not cancel to nothing, as
    # the column blocks' do not: check_stacked_kernels' pattern)
    base = torch.randn((D,), generator=g, device="cuda")
    u = base + 0.5 * torch.randn((K, D), generator=g, device="cuda")
    prev = base + 0.5 * torch.randn((K, D), generator=g, device="cuda")
    del base
    errs, out = {}, {}
    got = rk.robust_stats_cuda(u, prev, 0.1, False)
    want = chunked_plain_stats(torch, u, prev)
    err = 0.0
    for f in ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot", "prev_norm2"):
        a, b = getattr(got, f).reshape(-1), getattr(want, f).reshape(-1)
        torch.testing.assert_close(a, b, rtol=STAT_RTOL, atol=STAT_ATOL)
        err = max(err, float((a - b).abs().max()))
    errs["robust_stats"] = err
    b4 = bound(4.0 * 2 * K * D, D * (2.0 * network_compare_exchanges(K) + 15.0 * K))
    out["robust_stats"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_cuda(u, prev, 0.1, False), 2, 10),
        plain_ms=time_cuda(torch, lambda: chunked_plain_stats(torch, u, prev), 1, 3),
        bound_ms=b4[0], bound_by=b4[1], library_ms=None, shape=f"K={K} D={D}, prev")
    del prev, got, want
    gram, norm2 = pk.pairwise_gram_cuda(u)
    gp, _ = pops.pairwise_gram_plain(u)
    if not torch.equal(gram, gram.T) or not torch.equal(torch.diagonal(gram), norm2):
        raise AssertionError("pairwise_gram at the grid's shape: not exactly symmetric")
    if D <= GRAM_F64_D:
        torch.testing.assert_close(gram, gp, rtol=1e-4, atol=1e-6 * D)
    else:
        hold_gram_f64(torch, u, gram, gp, where)
    errs["pairwise_gram"] = float((gram - gp).abs().max())
    b6 = bound(4.0 * K * D, float(K * (K + 1)) * D)
    out["pairwise_gram"] = dict(
        ms=time_cuda(torch, lambda: pk.pairwise_gram_cuda(u), 2, 10),
        plain_ms=time_cuda(torch, lambda: pops.pairwise_gram_plain(u), 1, 3),
        bound_ms=b6[0], bound_by=b6[1],
        library_ms=time_cuda(torch, lambda: torch.mm(u, u.t()), 2, 10),
        shape=f"K={K} D={D}")
    del gram, gp
    w = torch.ones((K,), device="cuda")
    w[2] = 0.0
    wvec = w / w.sum()
    lcoef = torch.zeros((1,), device="cuda")
    local = torch.zeros((D,), device="cuda")
    a = wk.weighted_agg_cuda(wvec, lcoef, local, u)
    b = wops.weighted_agg_plain(wvec, lcoef, local, u)
    if not bit_equal(torch, a, b):
        raise AssertionError("weighted_agg at the grid's shape: not bit-equal to its plain "
                             "version")
    errs["weighted_agg"] = 0.0
    b7 = bound(4.0 * (K + 2) * D, 2.0 * K * D)
    out["weighted_agg"] = dict(
        ms=time_cuda(torch, lambda: wk.weighted_agg_cuda(wvec, lcoef, local, u), 2, 10),
        plain_ms=time_cuda(torch, lambda: wops.weighted_agg_plain(wvec, lcoef, local, u),
                           1, 3),
        bound_ms=b7[0], bound_by=b7[1],
        library_ms=time_cuda(torch, lambda: torch.addmv(local, u.t(), wvec, beta=0.0), 2, 10),
        shape=f"K={K} D={D}, lcoef 0")
    del u, local, a, b
    torch.cuda.empty_cache()
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"  {name} at {where} shape {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"library {lib}; max |kernel - plain| {errs[name]:.3g}")
    if heads:
        errs["flash_attention"] = compare_flash(torch, 1, heads, PREFILL_S, PREFILL_S, 64, True,
                                                "bfloat16", 128, 72)
        out["flash_attention"] = time_flash(torch, 1, heads, PREFILL_S, 64, seed=73)
    return errs, out


def run_grid_path(torch, backend="gloo", K=GRID_K, M_=GRID_M, arch=GRID_ARCH,
                  layers=GRID_LAYERS, runs=GRID_RUNS, serve=True, more=()) -> tuple:
    """The data axis as processes on one card: K x M ``gloo`` ranks share
    it (a ``FileStore``), a grid (``make_grid``) of ``arch`` uncut (seed 0)
    whose ranks each hold their FSDP blocks: serving (``grid_serve``) and
    training (``grid_train``: ``GRID_RUNS``, K = 4 candidates of one row at
    S = 1025, IPM-100 on 1, AdamW lr 1e-3, ``fsdp_params``), held to one
    process (``grid_reference``) and to the reference backend's route; then
    kernels 4, 6, 7 and 8 at a rank's shapes (``check_grid_kernels``).
    ``layers`` cuts the model's depth, ``runs`` replaces ``GRID_RUNS``;
    without ``serve`` the ranks only train; ``more`` ((arch, layers, runs),
    ...) trains further models after it in the same ranks, each held to
    its own one-process gradients (the report's ``more``).  Returns
    (launches summed over the ranks, errors, report)."""
    import tempfile

    from repro_torch.configs.registry import get_config

    card = gpu_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_grid_")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grid_reference(torch, tmp, arch, K, serve=serve, layers=layers)
    for j, (a, n, _) in enumerate(more):
        grid_reference(torch, tmp, a, K, serve=False, layers=n, suffix=f"_{j}")
    ref_s = time.perf_counter() - t0
    pathlib.Path(tmp, "grid_job.json").write_text(json.dumps(dict(
        arch=arch, layers=layers, K=K, M=M_, serve=serve, runs=runs, hold=True,
        grads=str(pathlib.Path(tmp, "grads_one.f32")),
        more=[dict(arch=a, layers=n, runs=r, grads=str(pathlib.Path(tmp, f"grads_one_{j}.f32")))
              for j, (a, n, r) in enumerate(more)])))
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(torch, backend, K * M_, child=grid_child, tmp=tmp,
                          timeout=GRID_TIMEOUT_S)
    finally:
        for name in ["grads_one.f32", "prefill_tail.pt", "decode.pt", "prefill_tail_truth.pt",
                     "decode_truth.pt", "decode_f32.pt"] + [f"grads_one_{j}.f32"
                                                           for j in range(len(more))]:
            pathlib.Path(tmp, name).unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    where = "gloo, one card" if backend == "gloo" else "nccl"
    launches, rep = report_grid(ranks, card, ref_s, seconds, arch, K, M_, where)
    rep["more"] = {}
    for j, (a, _, _) in enumerate(more):
        la, rep["more"][a] = report_grid([r["more"][j] for r in ranks], card, ref_s, seconds,
                                         a, K, M_, where)
        for k in KERNELS:
            launches[k] += la[k]
    D = ranks[0]["report"]["train"]["wfagg fused"]["widths"][0]
    errs, rep["kernels"] = check_grid_kernels(torch, K, D, get_config(arch).n_heads // M_)
    return launches, errs, rep


def run_grid_cards(torch) -> dict:
    """``--only cards``' grid part on four cards (``nccl``, one rank a card):
    ``CARDS_GRID_ARCH`` uncut at K = 4 x M = 1 with the configuration
    ``launch.specs.train_config`` picks (stacked, WFAgg, ``fsdp_params``),
    on the ``fused`` route, ``CARDS_GRID_STEPS`` steps under IPM-100 with
    the route's hold (peak per card; no one-process gradient fits a card
    beside its ranks), then Qwen1.5-0.5B at K = 2 x M = 2 served and
    trained with the mean (at K = 2 both candidates sit at one distance
    from their median: WFAgg needs K > 2)."""
    import tempfile

    out = {}
    launches = dict.fromkeys(KERNELS, 0)
    for arch, K, M_, runs, serve, arch_tc in (
            (CARDS_GRID_ARCH, 4, 1, (("wfagg", "fused", CARDS_GRID_STEPS),), False, True),
            (GRID_ARCH, 2, 2, (("mean", "fused", 2),), True, False)):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_grid_")
        if serve:
            grid_reference(torch, tmp, arch, K)
        pathlib.Path(tmp, "grid_job.json").write_text(json.dumps(dict(
            arch=arch, K=K, M=M_, serve=serve, runs=runs, hold=True, arch_tc=arch_tc,
            expandable=not serve)))
        t0 = time.perf_counter()
        try:
            ranks = run_ranks(torch, "nccl", K * M_, child=grid_child, tmp=tmp,
                              timeout=GRID_TIMEOUT_S)
        finally:
            for name in ("grads_one.f32", "prefill_tail.pt", "decode.pt", "decode_f32.pt"):
                pathlib.Path(tmp, name).unlink(missing_ok=True)
        la, out[f"{arch} {K}x{M_}"] = report_grid(ranks, gpu_line(), 0.0,
                                                  time.perf_counter() - t0, arch, K, M_,
                                                  "nccl, one rank a card")
        for k in KERNELS:
            launches[k] += la[k]
    out["launches"] = {k: c for k, c in launches.items() if c}
    return out


def report_grid(ranks, card, ref_s, seconds, arch, K, M_, where) -> tuple:
    """Print the grid ranks' reports; the attacker at weight 0, WFAgg's loss
    claim; returns (launches summed over the ranks, report)."""
    import numpy as np

    from repro_torch.core.topology import spaced_malicious

    launches = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        for k, c in r["launches"]["grid"].items():
            launches[k] += c
    rep = {"card": card, "ranks": len(ranks), "reference_s": round(ref_s, 1),
           "ranks_s": round(seconds, 1), "per_rank": [r["report"] for r in ranks]}
    r0 = ranks[0]["report"]
    print(f"  {card}: {arch} on a grid of {K} x {M_} ranks ({where}); one-process reference "
          f"{ref_s:.1f} s, the ranks {seconds:.1f} s")
    if "serve" in r0:
        for r in ranks:
            s = r["report"]["serve"]
            print(f"  rank {r['rank']} serve: {s['params_rank']} parameters (FSDP blocks); "
                  f"prefill {K} x {PREFILL_S} (one row a data rank) {s['prefill_ms']} ms "
                  f"({s['prefill_tokens_per_s']} tokens/s; collectives {s['prefill_collectives']}"
                  f"), peak {s['prefill_peak_gib']} GiB; decode batch {K} at 32,768 slots "
                  f"({s['cache_rows']} row(s), {s['cache_heads']} KV heads a rank) "
                  f"{s['decode_ms']} ms a step (collectives a step "
                  f"{s['decode_collectives_per_step']}), peak {s['peak_gib']} GiB")
        drift = r0["serve"].get("decode_vs_f32")
        if drift:
            print("  the decode's bf16 drift per token, (relative rms, largest difference) "
                  "from the f32-activation decode: " + "; ".join(
                      f"token {i}: grid {d['grid_vs_f32'][0]:.5g} / {d['grid_vs_f32'][1]:.4g}, "
                      f"one process {d['one_vs_f32'][0]:.5g} / {d['one_vs_f32'][1]:.4g}, grid "
                      f"vs one process {d['grid_vs_one'][0]:.5g}" for i, d in enumerate(drift)))
    for label in r0["train"]:
        for r in ranks:
            t = r["report"]["train"][label]
            phases = [{p: s.get(p) for p in ("grads", "param_gather", "exchange", "attack",
                                             "allreduce", "psum_stats", "optimizer",
                                             "activations")} for s in t["ms"]]
            groups = "buffers" if " flat" in label else "column groups"
            route = ("the one-process flat route on the whole candidates" if " flat" in label
                     else "the reference route")
            print(f"  rank {r['rank']} train {label} (fsdp_params {t['fsdp']}, {groups} "
                  f"{t['widths']}): loss {[round(x, 4) for x in t['losses']]}, weights "
                  f"{t['weights'][-1]}; launches a step {t['launches_per_step']}; ms per step "
                  f"{phases}; tokens/s {t['tokens_per_s']}; peak GiB {t['peak_gib']}; held to "
                  f"{route} (max|diff| {t['max_out_err']:.3g}, near-ties "
                  f"{t['near_ties'] or 'none'})"
                  + (f"; step-1 candidate vs one process, relative rms {t['grad_rms_vs_one']}"
                     if t["grad_rms_vs_one"] else ""))
    tr0 = r0["train"]
    bad = np.flatnonzero(spaced_malicious(K, GRID_MALICIOUS)).tolist()
    for label, t in tr0.items():
        if not all(map(math.isfinite, t["losses"])):
            raise AssertionError(f"grid {label}: non-finite loss {t['losses']}")
        if not label.startswith("mean") and any(w[k] != 0.0 for w in t["weights"] for k in bad):
            raise AssertionError(f"grid {label}: an attacker got weight: {t['weights']}")
    for wlabel in ("wfagg fused", "wfagg fused flat"):
        if "mean fused" not in tr0 or wlabel not in tr0:
            continue
        w = tr0[wlabel]["losses"]
        mean = tr0["mean fused"]["losses"]
        if not (w[-1] < w[0] and w[-1] < mean[-1]):
            raise AssertionError(f"grid: {wlabel}'s last loss {w[-1]} is not below its first "
                                 f"{w[0]} and the mean's {mean[-1]}")
        print(f"  the claim on the grid ({wlabel}): WFAgg's loss {w[0]:.4f} -> {w[-1]:.4f}, the "
              f"mean's {mean[0]:.4f} -> {mean[-1]:.4f} under {TRAIN_ATTACK}")
    return launches, rep


# ---------------------------------------------------------------------------
# phase 3: the MoE, SSM and hybrid families on the model axis and the grid
# (models/layers.py's expert split, MLA and padded heads, models/ssm.py's
# Mamba over d_inner, the shared block; remat of every block)
# ---------------------------------------------------------------------------

FAM_M = 2                      # gloo ranks sharing the one card
FAM_K, FAM_MALICIOUS = 4, 1    # candidates; IPM-100 on spaced_malicious(4, 1) = candidate 2
FAM_DECODE_B, FAM_DECODE = 4, 6    # decode batch and teacher-forced tokens
# (arch, serving layers, prefill (B, S), decode, training layers, training runs):
# DeepSeek-V2-Lite served and trained at 2 of 27 layers (1 dense prefix + 1
# MoE; served at 4 until the bf16 / pad-slot part, the whole script's time;
# the one-card MoE step's depth: K = 4 candidates hold 2K + 7 copies of a
# 1.03e9-parameter model on one card); Zamba2 served and trained at 2 of 38
# (one group; served at 4 until the encoder-decoder and VLM rows below, and
# trained at 4 until the bf16 / pad-slot part: the whole script's time; the
# SSM part serves it at 8 layers, four groups); Falcon-Mamba at 2 of
# 64; Arctic (bf16 parameters, 128 experts)
# at 1 of 35, served only: one card cannot hold its training, which
# ``run_arctic_cards`` runs on four (--only tpcards), the bf16 trainer on one
# card ``run_bf16_path``; SeamlessM4T-medium (arXiv:2308.11596) at 2 + 2 of
# its 12 + 12 layers, served at 2 x 8192 (frames and tokens; its decode
# against ENC_LEN_DECODE encoded frames) and trained; LLaVA-NeXT-34B at 1 of
# 60 layers, served at 1 x 8192 (576 patches and 7,616 tokens) only: two
# ranks of its K = 4 step would hold 2K + 7 copies of ~2.9 GiB each on the
# one card, which ``run_llava_cards`` trains on four (--only tpcards)
FAM_JOBS = (
    ("deepseek-v2-lite-16b", 2, (2, 4096), True, 2,
     (("wfagg", "fused", 2), ("mean", "fused", 2))),
    ("zamba2-1.2b", 2, (2, 8192), True, 2, (("wfagg", "fused", 2), ("mean", "fused", 2))),
    ("falcon-mamba-7b", 2, (2, 8192), True, 2, (("wfagg", "fused", 2),)),
    ("arctic-480b", 1, (1, 8192), False, 0, ()),
    ("seamless-m4t-medium", 2, (2, 8192), True, 2, (("wfagg", "fused", 2), ("mean", "fused", 2))),
    ("llava-next-34b", 1, (1, 8192), True, 0, ()),
)
# (arch, layers, runs) on the GRID_K x GRID_M grid, trained, one rank group:
# Zamba2 at 2 of 38 layers (4 until the bf16 / pad-slot part, the whole
# script's time; the whole script only trains it there since that part: the
# grid part serves Qwen on the grid, the model-axis part Zamba2 split over
# ranks), then Seamless at 2 + 2 layers (the frames' rows a data rank's)
FAM_GRID = (("zamba2-1.2b", 2, (("wfagg", "fused", 1),)),
            ("seamless-m4t-medium", 2, (("wfagg", "fused", 1),)))
FAM_TIMEOUT_S = 900
# --only cards at four cards: Moonlight uncut served at M = 4; DeepSeek-V2-Lite at
# 6 of 27 layers (8 would hold ~68 GB of its 2K + 7 copies a card, too close
# to 80 GB for a one-shot run) and Falcon-Mamba-7B at 32 of 64 trained at
# M = 4, K = 4
CARDS_FAM_JOBS = (
    ("moonshot-v1-16b-a3b", None, (2, 8192), True, 0, ()),
    ("deepseek-v2-lite-16b", None, None, False, 6, (("wfagg", "fused", 2),)),
    ("falcon-mamba-7b", None, None, False, 32, (("wfagg", "fused", 2),)),
)


def cut_depth(cfg, layers):
    """``cfg`` cut to ``layers`` layers (an encoder-decoder's encoder too;
    None: uncut)."""
    import dataclasses

    if not layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, n_enc_layers=(
        layers if cfg.is_encoder_decoder else cfg.n_enc_layers))


def job_config(get_config, job):
    """A job's config: ``job["arch"]`` cut to ``job["layers"]`` layers (None:
    uncut)."""
    return cut_depth(get_config(job["arch"]), job.get("layers"))


MODAL_SEED = 2000              # the modal inputs of training batch i: seed MODAL_SEED + i


def modal_inputs(torch, cfg, B, S, seed) -> dict:
    """What an encoder-decoder or a VLM takes beside B rows of tokens, drawn
    on the card from ``seed`` in the activation dtype (every process draws
    the same): ``frames`` (B, S, d) or ``patch_embeds`` (B, n_modal,
    ``MODAL_EMBED_DIM``); nothing for the other families."""
    from repro_torch.models.model import MODAL_EMBED_DIM

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encoder_decoder:
        return {"frames": torch.randn((B, S, cfg.d_model), generator=g, device="cuda",
                                      dtype=dt)}
    if cfg.modality == "vision":
        return {"patch_embeds": torch.randn((B, cfg.n_modal_tokens, MODAL_EMBED_DIM),
                                            generator=g, device="cuda", dtype=dt)}
    return {}


def prompt_batch(torch, cfg, shape, g, seed) -> dict:
    """A prefill batch of ``shape`` (B, S) positions: an encoder-decoder's S
    frames beside S tokens, a VLM's ``n_modal_tokens`` patches before S -
    n_modal tokens (``modal_inputs`` from ``seed``), the tokens from
    ``g``."""
    B, S = shape
    n_tok = S - (cfg.n_modal_tokens if cfg.modality == "vision" else 0)
    tokens = torch.randint(0, cfg.vocab_size, (B, n_tok), generator=g, device="cuda",
                           dtype=torch.int32)
    return {"tokens": tokens, **modal_inputs(torch, cfg, B, S, seed)}


def with_modal(torch, cfg, batches) -> list:
    """Training batches (tokens) with the modal inputs of their rows beside
    them (``modal_inputs``, batch i from seed ``MODAL_SEED + i``)."""
    return [dict(b, **modal_inputs(torch, cfg, b["tokens"].shape[0], b["tokens"].shape[1],
                                   MODAL_SEED + i)) for i, b in enumerate(batches)]


def encoded_cache(torch, cfg, params, B, total, mesh=None, frames=None) -> dict:
    """A decode cache of ``total`` positions at batch B (on ``mesh``: the
    rank's share); an encoder-decoder's holds ``_encode``'s output of
    ``frames`` (B, S_enc, d; this rank's rows of them on a grid), as the
    caller must fill it."""
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, B, total, mesh=mesh,
                         enc_len=0 if frames is None else frames.shape[1])
    if frames is not None:
        a, n = M.local_rows(B, mesh)
        with torch.inference_mode():
            cache["enc_out"].copy_(M._encode(cfg, params, frames[a:a + n]))
    return cache


def flash_layers(cfg) -> int:
    """Kernel-8 launches of one prefill call at S >= 8192: every attention
    layer of a GQA model, the hybrid's shared block once a group, none for
    MLA (the dense ``_sdpa``) or an SSM."""
    if cfg.family == "ssm" or cfg.use_mla:
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def fam_jobs(rows, hold=True, K=FAM_K) -> list:
    return [dict(arch=a, layers=sl, prefill=pf, decode=dec, train_layers=tl, runs=runs,
                 hold=hold, K=K) for a, sl, pf, dec, tl, runs in rows]


def fam_reference(torch, out_dir, i, job) -> None:
    """What job ``i``'s ranks are held to in one process, computed here
    before they start and freed: the prompts (with an encoder-decoder's
    frames or a VLM's patch embeddings, ``prompt_batch``) and the
    prefill's last ``PREFILL_TAIL`` positions' logits (f32), the decode
    logits of ``FAM_DECODE`` teacher-forced tokens at batch
    ``FAM_DECODE_B`` against 32,768 slots (an encoder-decoder's caches
    holding the encoded ``ENC_LEN_DECODE`` frames, saved for the ranks),
    each with the routing of every MoE call (probabilities and picks,
    ``RouteRecorder``), and candidate 0's gradient of the first training
    batch at the training depth (one row of ravel order; its modal rows
    beside the tokens, ``with_modal``)."""
    import contextlib
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.core.flatten import layout_flat
    from repro_torch.data.specs import ENC_LEN_DECODE
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import model as M
    from repro_torch.train import serve as sv
    from repro_torch.train import trainer as tr

    d = pathlib.Path(out_dir)
    if job["prefill"]:
        cfg = job_config(get_config, job)
        moe = bool(cfg.n_experts)
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator(device="cuda").manual_seed(1)
        batch = prompt_batch(torch, cfg, job["prefill"], g, MODAL_SEED - 1)
        # the f32 truth (SSM_TRUTH, MOE_TRUTH): the model in f32 activations,
        # the bf16 route's routing replayed; none beside bf16 parameters, and
        # none for Falcon-Mamba at 2 layers, whose model-axis route sits at a
        # third of the dense rule from one process (measured on one H100);
        # LLaVA's as the one-card part holds it (ENCDEC_SERVE's "truth" rule)
        truth = (cfg.param_dtype == "float32" and cfg.dtype != "float32"
                 and cfg.family in ("moe", "hybrid", "vlm"))
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        with (RouteRecorder() if moe else contextlib.nullcontext()) as rec:
            logits = sv.build_prefill(cfg)(params, batch)
        out = {"batch": {k: v.cpu() for k, v in batch.items()},
               "tail": logits[:, -PREFILL_TAIL:].float().cpu(),
               "route": [tuple(t.cpu() for t in c) for c in rec.calls] if moe else None}
        del logits
        if truth:
            with (RouteRecorder([c[1] for c in rec.calls]) if moe
                  else contextlib.nullcontext()):
                out["truth"] = sv.build_prefill(cfg32)(params, batch)[:, -PREFILL_TAIL:].cpu()
        torch.save(out, d / f"fam{i}_prefill.pt")
        del out, rec, batch
        if job["decode"]:
            seq = torch.randint(0, cfg.vocab_size, (FAM_DECODE_B, FAM_DECODE), generator=g,
                                device="cuda", dtype=torch.int32)
            out = {"seq": seq.cpu()}
            # an encoder-decoder's caches hold the encoded frames, which the
            # ranks encode again on their blocks
            frames = (torch.randn((FAM_DECODE_B, ENC_LEN_DECODE, cfg.d_model), generator=g,
                                  device="cuda", dtype=getattr(torch, cfg.dtype))
                      if cfg.is_encoder_decoder else None)
            if frames is not None:
                out["frames"] = frames.cpu()
            for c, key in ((cfg, "logits"), (cfg32, "truth")):
                if key == "truth" and not truth:
                    continue
                cache = encoded_cache(torch, c, params, FAM_DECODE_B, DECODE_32K.seq_len,
                                      frames=frames)
                step = sv.build_decode_step(c)
                lgs = []
                replay = ([r[1].to("cuda") for r in out["route"]] if key == "truth" and moe
                          else None)
                with (RouteRecorder(replay) if moe else contextlib.nullcontext()) as rec:
                    for t in range(FAM_DECODE):
                        lg, cache = step(params, cache, seq[:, t:t + 1])
                        lgs.append(lg.float().cpu())
                out[key] = torch.cat(lgs, dim=1)
                if key == "logits":
                    out["route"] = [tuple(t.cpu() for t in c_) for c_ in rec.calls] if moe \
                        else None
                del cache, rec
            torch.save(out, d / f"fam{i}_decode.pt")
            del out, frames
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if job["train_layers"] and job["hold"]:
        cfg = cut_depth(get_config(job["arch"]), job["train_layers"])
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        P = layout_flat(params).numel()
        K = job.get("K", FAM_K)
        batch = with_modal(torch, cfg, [TokenStream(cfg.vocab_size, TRAIN_SEQ, K).batch(
            0, device="cuda")])[0]
        rows = batch["tokens"].shape[0] // K
        G = torch.empty((P,), dtype=torch.float32, device="cuda")
        # an MoE's routing recorded (remat off: each layer routes once) for
        # the ranks to replay in their step-1 hold (TPObserver.replayed_grads)
        moe = bool(cfg.n_experts)
        with (RouteRecorder() if moe else contextlib.nullcontext()) as rec:
            tr.loss_and_grad(dataclasses.replace(cfg, remat=False) if moe else cfg, params,
                             {k: v[:rows] for k, v in batch.items()}, G)
        with open(d / f"fam{i}_grads.f32", "wb") as f:
            f.write(G.cpu().numpy().tobytes())
        if moe:
            torch.save({"cfg": cfg, "calls": [tuple(t.detach().cpu() for t in c)
                                              for c in rec.calls]},
                       d / f"fam{i}_grads.f32.route")
        del rec
        del params, G
        gc.collect()
        torch.cuda.empty_cache()


def fam_serve(torch, cfg, mesh, out_dir, rank, i, job) -> tuple:
    """Job ``i``'s serving part on one model rank: the model cut at init
    (``init_params(mesh=)``; ranks sharing a card one after another, so
    that one whole block exists on a card at a time), a warm prefill, then a
    timed one that replays the one-process prefill's routing
    (``RouteRecorder``; its own picks recorded); kernel 8 on the rank's
    heads at ``flash_layers`` launches a call; the last ``PREFILL_TAIL``
    positions' logits gathered and, on rank 0, held to one process's by
    the dense rule, with every routing difference a near-tie
    (``routing_diff``); decode of the same teacher-forced tokens against
    32,768 slots (0 launches; an encoder-decoder's caches holding the
    rank's encoding of one process's frames), its routing replayed, held
    likewise.  The prompts carry an encoder-decoder's frames or a VLM's
    patch embeddings (``prompt_batch``).  Returns (launches, report)."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.data.specs import ENC_LEN_DECODE
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.train import serve as sv

    rep, d = {}, pathlib.Path(out_dir)
    M_ = mesh.shape["model"]
    moe = bool(cfg.n_experts)
    n_moe = cfg.n_layers - cfg.first_dense_layers if moe else 0
    t0 = time.perf_counter()
    # ranks sharing a card draw one after another
    turns = M_ if torch.cuda.device_count() < M_ else 1
    for r in range(turns):
        if turns == 1 or r == rank:
            params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   mesh=mesh)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    rep["init_s"] = round(time.perf_counter() - t0, 2)
    rep["params_rank"] = sum(p.numel() for p in params.parameters())
    g = torch.Generator(device="cuda").manual_seed(1)
    if (d / f"fam{i}_prefill.pt").exists():
        ref = torch.load(d / f"fam{i}_prefill.pt")
        batch = {k: v.to("cuda") for k, v in ref["batch"].items()}
    else:       # no one-process model fits: held to nothing but its own checks
        ref = None
        batch = prompt_batch(torch, cfg, job["prefill"], g, MODAL_SEED - 1)
    moe = moe and ref is not None
    clock = CollectiveClock(torch)
    try:
        prefill = sv.build_prefill(cfg, mesh=mesh, gather=False)
        zero_counts()
        warm = prefill(params, batch)
        del warm
        clock.take()
        torch.cuda.reset_peak_memory_stats()
        replay = [c[1].to("cuda") for c in ref["route"]] if moe else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        with (RouteRecorder(replay) if moe else contextlib.nullcontext()) as rec:
            logits = prefill(params, batch)
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        rep["prefill_collectives"] = clock.take()
        rep["prefill_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
        counts = read_counts()
        tc = _module("flash_attention").launches_tc
        n_flash = 2 * flash_layers(cfg)
        if counts != only_counts(flash_attention=n_flash) or tc != n_flash:
            raise AssertionError(f"{cfg.name} prefill launches {counts} ({tc} tensor-core), "
                                 f"expected {n_flash} over two calls, all tensor-core")
        launches = dict(counts, **{"flash_attention[tensor_core]": tc})
        B, S = job["prefill"]
        rep["prefill_ms"] = round(ms, 2)
        rep["prefill_tokens_per_s"] = round(B * S / ms * 1e3, 1)
        tail = shd.gather_tensor(logits[:, -PREFILL_TAIL:].contiguous(),
                                 (None, None, "model"), mesh).float()
        del logits
        if not bool(torch.isfinite(tail).all()):
            raise AssertionError(f"{cfg.name}: non-finite prefill logits")
        if rank == 0 and ref is not None:
            label = f"{cfg.name} ({cfg.n_layers} layers) at M = {M_}"
            rep["prefill_hold"] = hold_fam(torch, f"{label} prefill {B} x {S}, the last "
                                           f"{PREFILL_TAIL} positions,", tail, ref)
            if moe:
                rep["prefill_routing"] = routing_diff(
                    torch, f"{label} prefill routing vs one process",
                    [tuple(t.to("cuda") for t in c) for c in ref["route"]],
                    [tuple(t for t in c) for c in rec.calls])
        del tail, ref, rec, replay
        if job["decode"]:
            ref = torch.load(d / f"fam{i}_decode.pt") if (d / f"fam{i}_decode.pt").exists() \
                else None
            seq = ref["seq"].to("cuda") if ref is not None else torch.randint(
                0, cfg.vocab_size, (FAM_DECODE_B, FAM_DECODE), generator=g, device="cuda",
                dtype=torch.int32)
            frames = None
            if cfg.is_encoder_decoder:
                frames = ref["frames"].to("cuda") if ref is not None else torch.randn(
                    (FAM_DECODE_B, ENC_LEN_DECODE, cfg.d_model), generator=g, device="cuda",
                    dtype=getattr(torch, cfg.dtype))
            # the encoder on the rank's blocks fills the cache (untimed)
            cache = encoded_cache(torch, cfg, params, FAM_DECODE_B, DECODE_32K.seq_len, mesh,
                                  frames)
            del frames
            step = sv.build_decode_step(cfg, mesh=mesh)
            replay = [c[1].to("cuda") for c in ref["route"]] if moe else None
            zero_counts()
            clock.take()
            out = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (RouteRecorder(replay) if moe else contextlib.nullcontext()) as rec:
                for j in range(FAM_DECODE):
                    lg, cache = step(params, cache, seq[:, j:j + 1])
                    out.append(lg)
                torch.cuda.synchronize()
            rep["decode_ms"] = round(1e3 * (time.perf_counter() - t) / FAM_DECODE, 3)
            rep["decode_collectives_per_step"] = {k: round(v / FAM_DECODE, 3)
                                                  for k, v in clock.take().items()}
            if read_counts() != only_counts():
                raise AssertionError(f"{cfg.name} decode launched {read_counts()}")
            st = torch.cat(out, dim=1).float()
            if not bool(torch.isfinite(st).all()):
                raise AssertionError(f"{cfg.name}: non-finite decode logits")
            if rank == 0 and ref is not None:
                label = f"{cfg.name} ({cfg.n_layers} layers) at M = {M_}"
                rep["decode_hold"] = hold_fam(
                    torch, f"{label} decode at batch {FAM_DECODE_B}, 32,768 slots, over "
                    f"{FAM_DECODE} teacher-forced tokens,", st, dict(ref, tail=ref["logits"]))
                if moe:
                    rep["decode_routing"] = routing_diff(
                        torch, f"{label} decode routing vs one process",
                        rec_per_layer(torch, [tuple(t.to("cuda") for t in c)
                                              for c in ref["route"]], n_moe),
                        rec.per_layer(torch, n_moe))
            del cache, ref, st, out, rec
        rep["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    finally:
        clock.close()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rep


def hold_fam(torch, label, got, ref) -> dict:
    """The model-axis route's logits ``got`` against one process's
    (``ref["tail"]``): the dense rule, or, where a bf16 route sits past it
    and an f32 truth exists (``ref["truth"]``), ``SSM_TRUTH``'s rule
    (``hold_bf16_route``)."""
    want = ref["tail"].to("cuda")
    if ref.get("truth") is None:
        check_logits(torch, f"{label} vs one process", got, want)
        return {"rule": "dense"}
    return hold_bf16_route(torch, f"{label} model axis", got, "one process", want,
                           ref["truth"].to("cuda").float())


def rec_per_layer(torch, calls, n_moe):
    """Recorded (probs, picks) calls as one pair per MoE layer, the calls of
    that layer joined along S (decode steps in order)."""
    return [tuple(torch.cat([c[i] for c in calls[l::n_moe]], dim=1) for i in range(2))
            for l in range(n_moe)]


def fam_child(rank, S, store_path, out_dir, backend) -> None:
    """One rank of the families' model-axis part: joins the ``backend``
    group of S ranks (on card ``rank`` modulo the cards); per job of
    ``out_dir``/``fam_job.json`` the serving part, then the training part
    (``tp_train`` at the job's K candidates); writes its launches and
    reports as JSON."""
    import os

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    jobs = json.loads(pathlib.Path(out_dir, "fam_job.json").read_text())
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    res = {"rank": rank, "jobs": []}
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.launch.mesh import make_test_mesh

        dist.init_process_group(backend, store=dist.FileStore(store_path, S), rank=rank,
                                world_size=S)
        try:
            mesh = make_test_mesh(data=1, model=S, model_group=dist.group.WORLD)
            for i, job in enumerate(jobs):
                launches = dict.fromkeys(KERNELS, 0)
                out = {"arch": job["arch"], "report": {}}
                if job["prefill"]:
                    cfg = job_config(get_config, job)
                    la, out["report"]["serve"] = fam_serve(torch, cfg, mesh, out_dir, rank, i,
                                                           job)
                    for k in KERNELS:
                        launches[k] += la[k]
                    out["tc"] = la["flash_attention[tensor_core]"]
                if job["train_layers"]:
                    cfg = cut_depth(get_config(job["arch"]), job["train_layers"])
                    grads = pathlib.Path(out_dir, f"fam{i}_grads.f32")
                    la, out["report"]["train"] = tp_train(
                        torch, cfg, S, rank, [tuple(r) for r in job["runs"]],
                        grads_file=str(grads) if grads.exists() else None, hold=job["hold"],
                        K=job["K"], n_mal=FAM_MALICIOUS, f=FAM_MALICIOUS)
                    for k in KERNELS:
                        launches[k] += la[k]
                out["launches"] = {"tp": launches}
                res["jobs"].append(out)
        finally:
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 - the parent fails the run on it
        import traceback
        res["error"] = traceback.format_exc()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def run_fam_path(torch, backend="gloo", S=FAM_M, rows=FAM_JOBS, hold=True, K=FAM_K) -> tuple:
    """The families on the model axis: S ranks (``gloo`` sharing the one
    card, or ``nccl`` one a card) serve and train each job of ``rows`` at
    full width (``fam_serve``, ``tp_train`` at K candidates), held to one
    process (``fam_reference``, with ``hold``) and to the reference
    backend's route.  Returns (launches summed over the ranks and jobs,
    report)."""
    import tempfile

    card = gpu_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fam_")
    jobs = fam_jobs(rows, hold, K)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if hold:
        for i, job in enumerate(jobs):
            fam_reference(torch, tmp, i, job)
    ref_s = time.perf_counter() - t0
    pathlib.Path(tmp, "fam_job.json").write_text(json.dumps(jobs))
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(torch, backend, S, child=fam_child, tmp=tmp, timeout=FAM_TIMEOUT_S)
    finally:
        for f in pathlib.Path(tmp).glob("fam*_*"):
            f.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    where = "gloo, one card" if backend == "gloo" else f"nccl, {S} cards"
    print(f"  {card}: the families on {S} model ranks ({where}); one-process references "
          f"{ref_s:.1f} s, the ranks {seconds:.1f} s")
    launches = dict.fromkeys(KERNELS, 0)
    launches["flash_attention[tensor_core]"] = 0
    report = {"card": card, "reference_s": round(ref_s, 1), "ranks_s": round(seconds, 1)}
    for i, job in enumerate(jobs):
        per = [r["jobs"][i] for r in ranks]
        rep = {"per_rank": [p["report"] for p in per]}
        if job["prefill"]:
            for r, p in enumerate(per):
                s_ = p["report"]["serve"]
                B, S_ = job["prefill"]
                dec = (f"; decode batch {FAM_DECODE_B} at 32,768 slots {s_['decode_ms']} ms a "
                       f"step (collectives a step {s_['decode_collectives_per_step']})"
                       if job["decode"] else "")
                print(f"  rank {r} {job['arch']} serve ({job['layers'] or 'all'} layers): "
                      f"{s_['params_rank']} parameters, init {s_['init_s']} s; prefill {B} x "
                      f"{S_} {s_['prefill_ms']} ms ({s_['prefill_tokens_per_s']} tokens/s; "
                      f"collectives {s_['prefill_collectives']}), peak "
                      f"{s_['prefill_peak_gib']} GiB{dec}; peak {s_['peak_gib']} GiB")
                launches["flash_attention[tensor_core]"] += p.get("tc", 0)
        if job["train_layers"]:
            print(f"  {job['arch']} trained at {job['train_layers']} layers, K = {K}:")
            la, rep["train"] = report_tp([{"rank": r, "report": {"train": p["report"]["train"]},
                                           "launches": p["launches"]}
                                          for r, p in enumerate(per)],
                                         card, 0.0, seconds, job["arch"], where, K=K,
                                         n_mal=FAM_MALICIOUS)
        for p in per:
            for k, c in p["launches"]["tp"].items():
                launches[k] += c
        report[job["arch"]] = rep
    return launches, report


def check_fam_kernels(torch, P_s) -> tuple:
    """Kernels 4, 6 and 7 at the families' largest model-axis launch shape
    (the DeepSeek step's (``FAM_K``, D = P_s) split matrix) and at the
    Seamless step's (``P_s``: arch -> D), and kernel 8 at a rank's heads of
    Arctic's and LLaVA's prefill at M = 2 (B = 1, 28 live heads padded to
    32, hd 128), of LLaVA's at M = 4 on four cards (B = 1, 14 live heads
    padded to 16, hd 128) and of Zamba2's shared block (B = 2, 16 heads,
    hd 64), each held against its plain version and timed beside its
    bound and the PyTorch call (``check_grid_kernels``, ``compare_flash``,
    ``time_flash``).  Returns (errors, times)."""
    errs, out = check_grid_kernels(torch, FAM_K, P_s["deepseek-v2-lite-16b"], 16,
                                   where="the families' model-axis")
    errs["flash_attention"] = [errs["flash_attention"]]
    out["flash_attention"] = {"zamba2_rank": time_flash(torch, 2, 16, PREFILL_S, 64, seed=81)}
    errs["flash_attention"].append(compare_flash(torch, 1, 32, PREFILL_S, PREFILL_S, 128, True,
                                                 "bfloat16", 128, 82))
    out["flash_attention"]["arctic_rank"] = time_flash(torch, 1, 32, PREFILL_S, 128, seed=83)
    errs["flash_attention"].append(compare_flash(torch, 1, 16, PREFILL_S, PREFILL_S, 128, True,
                                                 "bfloat16", 128, 84))
    out["flash_attention"]["llava_rank_m4"] = time_flash(torch, 1, 16, PREFILL_S, 128, seed=85)
    serrs, seamless = check_grid_kernels(torch, FAM_K, P_s["seamless-m4t-medium"], None,
                                         where="Seamless's model-axis")
    for name, t in seamless.items():
        out[name] = {"deepseek_rank": out[name], "seamless_rank": t}
        errs[name] = (errs[name] if isinstance(errs[name], list) else [errs[name]]) + [
            serrs[name]]
    return errs, out


def run_tpfam(torch, grid_serve=True) -> tuple:
    """The families' part: ``run_fam_path`` on ``FAM_M`` gloo ranks, then
    ``FAM_GRID`` on the ``GRID_K`` x ``GRID_M`` grid (``run_grid_path``;
    served too with ``grid_serve``), then kernels 4, 6, 7 and 8 at the new
    shapes (``check_fam_kernels``).  Returns (launches summed over both,
    errors, report)."""
    launches, report = run_fam_path(torch)
    (arch, layers, runs), *more = FAM_GRID
    print(f"  {' then '.join(f'{j[0]} ({j[1]} layers)' for j in FAM_GRID)} on the {GRID_K} x "
          f"{GRID_M} grid, {'the first served and ' if grid_serve else ''}trained:")
    la, gerrs, report["grid"] = run_grid_path(torch, arch=arch, layers=layers, runs=runs,
                                              serve=grid_serve, more=more)
    for k in KERNELS:
        launches[k] += la[k]
    P_s = {a: report[a]["train"]["per_rank"][0]["train"]["wfagg fused"]["P"][0]
           for a in ("deepseek-v2-lite-16b", "seamless-m4t-medium")}
    errs, report["kernels"] = check_fam_kernels(torch, P_s)
    report["grid_kernels"] = report["grid"].pop("kernels")
    for name, e in gerrs.items():
        errs.setdefault(name, [])
        errs[name] = (errs[name] if isinstance(errs[name], list) else [errs[name]]) + [e]
    return launches, errs, report


# ---------------------------------------------------------------------------
# phase 3: bf16 parameters and a padded layout's head slots (train/trainer.py,
# optim/optimizers.py's LeafBlock.live, core/flatten.py's places of the pad
# slots, the noise attack drawn a whole-vector chunk at a time)
# ---------------------------------------------------------------------------

BF16_K = 4                     # candidates on the model axis; noise on spaced_malicious(4, 1)
BF16_STEPS = 3
BF16_SEQ = 257                 # one row of S = 257 a candidate
BF16_CHUNK = 1 << 18           # the flat layout's chunk: the reduced Arctic is 17 of them
# the padded config of tests/test_torch_tp_families.py: 7 live heads padded to 8,
# 1 KV head, on the reduced Arctic (float32)
PAD_CFG = dict(d_model=64, vocab_size=128, n_layers=1, n_heads=7, n_kv_heads=1,
               pad_heads_to=8, head_dim=16, d_ff=32, dense_residual_ff=32, n_experts=4,
               top_k=2)
# (label, config, layout, method): M = 1 in this process
BF16_ONE = (("bf16 M=1 stacked", "bf16", "stacked", "wfagg"),
            ("bf16 M=1 flat", "bf16", "flat", "wfagg"))
# (mesh (K, M), runs): gloo ranks sharing the card, a K x M grid where K > 1 (K
# candidates, one a data rank), else the model axis with BF16_K candidates each
BF16_JOBS = (((1, 2), (("bf16 M=2 stacked", "bf16", "stacked", "wfagg"),
                       ("bf16 M=2 stacked alt", "bf16", "stacked", "alt_wfagg"),
                       ("bf16 M=2 flat", "bf16", "flat", "wfagg"))),
             ((2, 2), (("bf16 2x2 stacked", "bf16", "stacked", "wfagg"),
                       ("bf16 2x2 flat", "bf16", "flat", "wfagg"))),
             ((1, 4), (("padded M=4 stacked", "padded", "stacked", "alt_wfagg"),
                       ("padded M=4 flat", "padded", "flat", "wfagg"))))
BF16_TIMEOUT_S = 300


def bf16_configs() -> dict:
    """The part's configs: the reduced Arctic in bf16 with Adafactor
    (Arctic's own plan; ``reduced()`` is float32 with SGD), and the padded
    one (float32, Adafactor)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    base = get_config("arctic-480b").reduced()
    return {"bf16": dataclasses.replace(base, param_dtype="bfloat16", optimizer="adafactor"),
            "padded": dataclasses.replace(base, optimizer="adafactor", **PAD_CFG)}


def bf16_tc(method, layout, K):
    """The runs' TrainConfig: WFAgg(-T) on ``fused``, noise on one of K,
    f = 1 (0 at K = 2), chunks of ``BF16_CHUNK``."""
    import dataclasses

    from repro_torch.core.wfagg import WFAggConfig

    tc = train_config(method, layout=layout, attack="noise", n_malicious=1,
                      wfagg=WFAggConfig(f=1 if K > 2 else 0, transient=3, window=3))
    return dataclasses.replace(tc, agg=dataclasses.replace(tc.agg, chunk_size=BF16_CHUNK))


def whole_of(torch, model, x, lead, mesh=None, rows=False, columns=False):
    """The whole model's ravel ((K, P) with ``lead`` 1, (P,) with 0) of a
    rank's candidates or aggregate ``x``: a tree of its blocks (stacked),
    or its flat buffers (a tuple, or one tensor at M = 1); gathered over
    the model group (a padded cut back to the live heads) and over the
    data group: ``columns``, a grid's column block (its FSDP dims);
    ``rows``, one candidate a data rank, gathered as rows.  Every rank
    gets it."""
    from repro_torch.core import flatten as F
    from repro_torch.distributed import sharding as shd

    if getattr(model, "tp", None) is None and not rows and not columns:
        if isinstance(x, torch.Tensor):
            return x
        return torch.cat([leaf.reshape((leaf.shape[0], -1) if lead else (-1,))
                          for leaf in F.tree_leaves(x)], -1)
    if not isinstance(x, dict):
        bufs = x if isinstance(x, tuple) else (x,)
        bufs = tuple(b if b.ndim == 2 else b[None] for b in bufs)
        x = (F.unravel_rows_split(bufs, model) if getattr(model, "tp", None) is not None
             else F.unravel_rows(bufs[0], F.module_tree(model)))
        if lead == 0:
            x = F.tree_map(lambda leaf: leaf[0], x)
    dims = dict(model.fsdp.dims) if columns else {}
    out = []
    for leaf, (path, _), c in zip(F.tree_leaves(x), F.leaf_params(model),
                                  F.split_cuts(model)):
        cut = None if c is None else c[0].shifted(lead)
        ddim = dims.get(path)
        spec = tuple("model" if cut is not None and i == cut.dim else
                     "data" if ((ddim is not None and i == ddim + lead)
                                or (rows and lead and i == 0)) else None
                     for i in range(leaf.ndim))
        w = shd.gather_tensor(leaf.contiguous(), spec, mesh, cut, 0 if c is None else c[1])
        out.append(w.reshape((w.shape[0], -1) if lead else (-1,)))
    return torch.cat(out, -1)


class Bf16Hold:
    """The bf16 / pad-slot part's ``observe`` hook on one rank (or the one
    process at M = 1): each phase's ms, the step's launches and peak
    memory; at every step the candidates after the attack gathered whole
    (``whole_of``: every rank gets them) and the one-process M = 1 route
    run on them from the step's WFAgg-T state (stacked: ``fused``, kernel 1
    at N = 1; at M = 1 itself: the ``reference`` backend; flat:
    ``Emulated(K)``; the flat M = 1 run is that route), its launches not
    the step's; after the all-reduce the aggregate gathered whole and held
    to it: masks bit-equal or near-ties (``NEAR_TIE``, on the one-process
    statistics), weights within ``FLAT_W_TOL``, the aggregate within
    ``FLAT_OUT_TOL`` (float32) or one bf16 rounding, 2^-7 |want| (bf16);
    the rank's pad head slots exactly 0 in its candidates after the attack
    and in its parameters after the step."""

    def __init__(self, torch, tc, model, mesh, K, pdtype):
        from repro_torch.core import flatten as F

        self.torch, self.tc, self.model, self.mesh, self.K = torch, tc, model, mesh, K
        self.pdtype = pdtype
        self.tails = F.pad_tails(model)
        self.grid = mesh.data_axis() is not None
        self.rows = self.grid and tc.agg.layout == "flat"
        self.columns = self.grid and tc.agg.layout == "stacked"
        self.one = getattr(model, "tp", None) is None and not self.grid
        self.hold = not (self.one and tc.agg.layout == "flat")
        self.prev = None
        self.steps, self.peaks, self.launches, self.near_ties = [], [], [], []
        self.max_err, self.pad_checks = 0.0, 0

    def start(self):
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        self.cur = {}
        self.t = time.perf_counter()

    def __call__(self, phase, **v):
        torch = self.torch
        torch.cuda.synchronize()
        self.cur[phase] = round(1e3 * (time.perf_counter() - self.t), 2)
        counts = read_counts()
        if phase == "attack":
            self.check_pads(v["candidates"], 1)
            if self.hold:
                self.route(v["candidates"], v["agg_state"])
        elif phase == "allreduce" and self.hold:
            self.compare(v["grads"], v["info"])
        elif phase == "optimizer":
            self.check_pads(v["params"], 0)
            self.steps.append(self.cur)
            self.peaks.append(round(torch.cuda.max_memory_allocated() / 2 ** 30, 3))
            self.launches.append({k: c for k, c in counts.items() if c})
        # the hold's own launches are not the step's
        for name, (mod, attr, _, _) in KERNELS.items():
            setattr(_module(name), attr, counts[name])
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def check_pads(self, tree, lead) -> None:
        from repro_torch.core import flatten as F

        if not any(t is not None for t in self.tails):
            return
        if not isinstance(tree, dict):
            bufs = tree if isinstance(tree, tuple) else (tree,)
            tree = F.unravel_rows_split(tuple(b if b.ndim == 2 else b[None] for b in bufs),
                                        self.model)
            lead = 1
        for leaf, t in zip(F.tree_leaves(tree), self.tails):
            if t is not None:
                d, live = t
                tail = leaf.narrow(lead + d, live, leaf.shape[lead + d] - live)
                if bool((tail != 0).any()):
                    raise AssertionError(f"a pad head slot holds {float(tail.abs().max())}")
                self.pad_checks += 1

    def route(self, cands, state):
        import dataclasses

        from repro_torch.distributed import robust_allreduce as ra

        torch = self.torch
        self.whole = whole_of(torch, self.model, cands, 1, self.mesh, self.rows, self.columns)
        agg = self.tc.agg
        if agg.layout == "flat":
            o, _, info = ra.robust_allreduce(self.whole, ra.Emulated(self.K), agg, state)
        else:
            if self.one:
                agg = dataclasses.replace(agg, backend="reference")
            w = self.whole.to(torch.float32)
            st = None
            if state is not None:
                prev = self.prev if self.prev is not None else torch.zeros_like(w)
                st = ra.TreeAggState(prev={"w": prev}, hist_s=state.hist_s.clone(),
                                     hist_b=state.hist_b.clone(), count=state.count.clone(),
                                     t=state.t.clone())
            o, _, info = ra.robust_allreduce_stacked({"w": w}, agg, st)
            o = o["w"].to(self.pdtype)
            self.prev = w
        self.ref = (o, info["weights"], {k: info[k] for k in MASKS if k in info})

    def compare(self, grads, info):
        from repro_torch.distributed import robust_allreduce as ra

        torch = self.torch
        label = f"{self.tc.agg.layout} {self.tc.agg.method} step {len(self.steps) + 1}"
        got = whole_of(torch, self.model, grads, 0, self.mesh, columns=self.columns).float()
        o, w, masks = self.ref
        o = o.float()
        flips = [(k, bit) for bit, name in enumerate(MASKS) if name in masks
                 for k in (masks[name] != info[name]).nonzero().flatten().tolist()]
        keep = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
        if flips:
            st = ra._stats_scan(self.whole.float(), ra.Emulated(self.K), self.tc.agg)
            wcfg = ra._effective_wfagg_config(self.tc.agg, self.K)
            rep = [(k, "WFAgg-T", None) for k, bit in flips if bit == 2]
            rep += margins_of(torch, wcfg, st.dist2_med, st.gram, st.dot_med, st.med2,
                              None, None, None, [f for f in flips if f[1] != 2])
            print(f"  {label}: decisions differ at (candidate, filter, margin) {rep}")
            if not all(m is not None and m <= NEAR_TIE for _, _, m in rep):
                raise AssertionError(f"{label}: decisions differ away from any edge: {rep}")
            self.near_ties.append((len(self.steps) + 1, rep))
            keep[[k for k, _ in flips]] = False
        werr = float((info["weights"][keep] - w[keep]).abs().max()) if keep.any() else 0.0
        if werr > FLAT_W_TOL:
            raise AssertionError(f"{label}: weights {info['weights'].tolist()} against "
                                 f"{w.tolist()}")
        if flips:
            return
        err = (got - o).abs()
        if self.pdtype == torch.bfloat16:
            bad = err > 2.0 ** -7 * o.abs() + 1e-30
        else:
            bad = err > FLAT_OUT_TOL
        if bool(bad.any()):
            raise AssertionError(f"{label}: the aggregate {float(err.max())} from the "
                                 "one-process route's")
        self.max_err = max(self.max_err, float(err.max()))


def bf16_plan(model, mesh, tc, K) -> dict:
    """One step's launches on this rank: kernel 1 at M = 1 (stacked); on
    the model axis or a grid, kernel 4 (and 6 where the rule needs the
    Gram) per column group this rank counts and kernel 7 per group, each
    where the group has columns; none on the flat layout."""
    from repro_torch.core import flatten as F
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.train import trainer as tr

    if tc.agg.layout == "flat":
        return {}
    grid = mesh.data_axis() is not None
    if getattr(model, "tp", None) is None and not grid:
        return {"wfagg_round_indexed": 1}
    if grid:
        shards = tr.grid_shards(model, mesh)
        widths = F.fsdp_widths(model)
    else:
        shards = ra._as_grid(ra.ModelShards(model.tp, tuple(tr._model_cuts(model))))
        widths = [b.numel() for b in F.layout_split(model)]
    counted = sum(1 for c, n in zip(shards.counted, widths) if c and n)
    plan = {"robust_stats": counted, "weighted_agg": sum(1 for n in widths if n)}
    if ra._needs_gram(tc.agg):
        plan["pairwise_gram"] = counted
    return plan


def bf16_train(torch, mesh, runs, K) -> tuple:
    """The part's training runs on one rank (or the one process): per
    (label, config, layout, method) ``BF16_STEPS`` steps of
    ``build_train_step`` from seed 0 under ``Bf16Hold``, each step's
    launches held to ``bf16_plan``.  Returns (launches, report)."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train import trainer as tr

    cfgs = bf16_configs()
    launches = dict.fromkeys(KERNELS, 0)
    report = {}
    for label, key, layout, method in runs:
        cfg = cfgs[key]
        tc = bf16_tc(method, layout, K)
        t0 = time.perf_counter()
        state = tr.init_train_state(cfg, tc, torch.Generator(device="cuda").manual_seed(0),
                                    mesh)
        pdtype = getattr(torch, cfg.param_dtype)
        obs = Bf16Hold(torch, tc, state.params, mesh, K, pdtype)
        step = tr.build_train_step(cfg, tc, mesh, observe=obs)
        stream = TokenStream(cfg.vocab_size, BF16_SEQ, K)
        losses, weights = [], []
        for i in range(BF16_STEPS):
            b = stream.batch(i, device="cuda")
            obs.start()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            weights.append([round(float(x), 4) for x in m["weights"]])
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        dtypes = sorted({str(p.dtype) for p in state.params.parameters()})
        if dtypes != [str(pdtype)]:
            raise AssertionError(f"{label}: parameters in {dtypes}")
        plan = bf16_plan(state.params, mesh, tc, K)
        for i, got in enumerate(obs.launches):
            if got != {k: c for k, c in plan.items() if c}:
                raise AssertionError(f"{label} step {i + 1}: launches {got}, planned {plan}")
        for k, c in plan.items():
            launches[k] += c * BF16_STEPS
        report[label] = dict(losses=losses, weights=weights, ms=obs.steps, peak_gib=obs.peaks,
                             launches_per_step=plan, near_ties=obs.near_ties,
                             max_out_err=obs.max_err, pad_checks=obs.pad_checks,
                             seconds=round(time.perf_counter() - t0, 2))
        del state, step, obs
        gc.collect()
        torch.cuda.empty_cache()
    return launches, report


def bf16_child(rank, S, store_path, out_dir, backend) -> None:
    """One rank of the part's multi-rank jobs: joins the ``backend`` group
    of S ranks, builds the job's mesh (``bf16_job.json``: a K x M grid where
    K > 1, else the model axis of M = S) and runs ``bf16_train``."""
    import torch
    import torch.distributed as dist

    job = json.loads(pathlib.Path(out_dir, "bf16_job.json").read_text())
    torch.cuda.set_device(rank % torch.cuda.device_count())
    res = {"rank": rank}
    try:
        from repro_torch.launch.mesh import make_grid, make_test_mesh

        dist.init_process_group(backend, store=dist.FileStore(store_path, S), rank=rank,
                                world_size=S)
        try:
            Kg, M_ = job["mesh"]
            if Kg > 1:
                mesh, K = make_grid(Kg, M_), Kg
            else:
                mesh = make_test_mesh(data=BF16_K, model=M_, model_group=dist.group.WORLD)
                K = BF16_K
            la, res["report"] = bf16_train(torch, mesh, [tuple(r) for r in job["runs"]], K)
            res["launches"] = la
        finally:
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 - the parent fails the run on it
        import traceback
        res["error"] = traceback.format_exc()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def run_bf16_path(torch) -> tuple:
    """bf16 parameters and a padded layout's head slots on the card: the
    bf16 reduced Arctic (Adafactor) at M = 1 in this process (stacked on
    ``fused``: kernel 1 at N = 1; flat), on 2 gloo ranks (stacked WFAgg and
    Alt-WFAgg: kernels 4, 6 and 7 on blocks; flat) and on the 2 x 2 grid
    (stacked, flat); the padded config on 4 gloo ranks (stacked Alt-WFAgg,
    flat): K = 4 (2 on the grid) under noise, ``BF16_STEPS`` steps each,
    every step held to the one-process route (``Bf16Hold``), the pad slots
    exactly 0, each step's launches as planned.  Prints the part's time and
    peak memory.  Returns (launches summed over the runs and ranks,
    report)."""
    import tempfile

    t0 = time.perf_counter()
    card = gpu_line()
    torch.cuda.reset_peak_memory_stats()
    from repro_torch.launch.mesh import make_test_mesh

    launches, report = bf16_train(torch, make_test_mesh(data=BF16_K), BF16_ONE, BF16_K)
    report = {"M=1": report}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for (Kg, M_), runs in BF16_JOBS:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
        pathlib.Path(tmp, "bf16_job.json").write_text(json.dumps(dict(mesh=[Kg, M_],
                                                                      runs=runs)))
        ranks = run_ranks(torch, "gloo", Kg * M_, child=bf16_child, tmp=tmp,
                          timeout=BF16_TIMEOUT_S)
        where = f"{Kg} x {M_} grid" if Kg > 1 else f"M = {M_}"
        report[where] = [r["report"] for r in ranks]
        for r in ranks:
            for k, c in r["launches"].items():
                launches[k] += c
        for label in ranks[0]["report"]:
            per = [r["report"][label] for r in ranks]
            if any(p["losses"] != per[0]["losses"] for p in per):
                raise AssertionError(f"{label}: the ranks' losses differ")
            peak = max(peak, max(max(p["peak_gib"]) for p in per))
    for where, rep in report.items():
        reps = rep if isinstance(rep, list) else [rep]
        for label, t in reps[0].items():
            pads = sum(r[label]["pad_checks"] for r in reps)
            print(f"  {card}: {label} ({where}): loss {[round(x, 4) for x in t['losses']]}, "
                  f"weights {t['weights'][-1]}; launches a step (rank 0) "
                  f"{t['launches_per_step']}; ms a step (rank 0) {t['ms']}; peak GiB "
                  f"{t['peak_gib']}; held to the one-process route (max|diff| "
                  f"{t['max_out_err']:.3g}, near-ties {t['near_ties'] or 'none'}); pad slots "
                  f"checked 0 {pads} times")
    seconds = time.perf_counter() - t0
    print(f"  the bf16 / pad-slot part: {seconds:.1f} s, peak {peak:.3f} GiB a process "
          f"({card})")
    return launches, dict(report, seconds=round(seconds, 1), peak_gib=round(peak, 3))


# ---------------------------------------------------------------------------
# --only tpcards at four cards: Arctic's own plan at full width (bf16
# parameters, Adafactor, the flat layout, M = 4) at 1 of its 35 layers
# ---------------------------------------------------------------------------

ARCTIC_ARCH = "arctic-480b"
ARCTIC_LAYERS = 1              # of 35: a card's block of one layer is 3.52e9 parameters
ARCTIC_K = 4                   # candidates, emulated on every rank; noise on spaced_malicious(4, 1)
ARCTIC_STEPS = 3
ARCTIC_SAMPLES = 4             # whole-vector chunks gathered for the hold
ARCTIC_TIMEOUT_S = 900
ARCTIC_STATS_RTOL = 1e-4       # a chunk's statistics, the ranks' partials against the whole's


def chunk_pieces(torch, places, buf, A, B):
    """The columns of a rank's buffer ``buf`` (K, n) whose whole-ravel
    index falls in [A, B): a list of (their values (K, m), their indices
    minus A); each leaf's block is found by bisection on ``global_index``
    (increasing along a block without pad slots)."""
    from repro_torch.core import flatten as F

    out = []
    dev = buf.device
    for pl in places:
        lo_w, hi_w = pl.offset, pl.offset + pl.outer * pl.n * pl.inner
        if hi_w <= A or lo_w >= B:
            continue

        def first_at(v):
            lo, hi = pl.start, pl.start + pl.size
            while lo < hi:
                mid = (lo + hi) // 2
                if int(F.global_index([pl], mid, mid + 1, dev)[0]) < v:
                    lo = mid + 1
                else:
                    hi = mid
            return lo
        a, b = first_at(A), first_at(B)
        if a < b:
            out.append((buf[:, a:b], F.global_index([pl], a, b, dev) - A))
    return out


class ArcticHold:
    """``observe`` of the four-card Arctic run on one rank: each phase's ms
    and the step's peak; after the attack, ``ARCTIC_SAMPLES`` whole-vector
    chunks of the K candidates gathered on every rank (each rank's
    coordinates in them, ``chunk_pieces``, summed over the model group: one
    rank holds each coordinate), their statistics (median, the distance and
    dot sums, the Gram, the count-sketch) recomputed whole and held to the
    ranks' partial sums over their own coordinates, summed in rank order
    (``ARCTIC_STATS_RTOL``, relative to |value| + 1e-3); after the all-reduce, every rank's weights
    and masks equal to rank 0's, and each chunk's weighted aggregate from
    the step's weights (the bf16 rank sum, ``robust_allreduce._psum``'s
    arithmetic) equal, within one bf16 rounding, to the ranks' aggregate
    there."""

    def __init__(self, torch, tc, model, mesh):
        from repro_torch.core import flatten as F

        self.torch, self.tc, self.model, self.mesh = torch, tc, model, mesh
        self.places, self.P = F.coord_places(model)
        self.counted = (True, model.tp.rank == 0)
        L = tc.agg.chunk_size
        n = -(-self.P // L)
        self.chunks = sorted({int(round(i * (n - 1) / (ARCTIC_SAMPLES - 1)))
                              for i in range(ARCTIC_SAMPLES)})
        self.steps, self.peaks, self.errs = [], [], []

    def start(self):
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.cur = {}
        self.t = time.perf_counter()

    def __call__(self, phase, **v):
        torch = self.torch
        torch.cuda.synchronize()
        self.cur[phase] = round(1e3 * (time.perf_counter() - self.t), 1)
        if phase == "attack":
            self.gather(v["candidates"])
        elif phase == "allreduce":
            self.hold(v["grads"], v["info"])
        elif phase == "optimizer":
            self.cur["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
            self.steps.append(self.cur)
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def pieces(self, bufs, c):
        L = self.tc.agg.chunk_size
        out = []
        for buf, counted, places in zip(bufs, self.counted, self.places):
            if counted:
                out += chunk_pieces(self.torch, places, buf, c * L, (c + 1) * L)
        return out

    def whole_chunk(self, bufs, c, K):
        """The whole (K, L) float32 chunk c on every rank, and how many ranks
        gave each coordinate."""
        from repro_torch.models import layers as L_

        torch = self.torch
        L = self.tc.agg.chunk_size
        dev = bufs[0].device
        acc = torch.zeros((K + 1, L), dtype=torch.float32, device=dev)
        for vals, pos in self.pieces(bufs, c):
            acc[:K, pos] = vals.float()
            acc[K, pos] = 1.0
        acc = L_.all_reduce_model(acc, self.model.tp.group)
        return acc[:K], acc[K]

    def gather(self, cands):
        from repro_torch.distributed import robust_allreduce as ra
        from repro_torch.distributed.spmd import all_reduce_in_rank_order

        torch = self.torch
        bufs = cands if isinstance(cands, tuple) else (cands,)
        K = bufs[0].shape[0]
        cfg = self.tc.agg
        L = cfg.chunk_size
        self.whole = {}
        worst = 0.0
        hashes = ra._hash_of(cfg, bufs[0].device)
        for c in self.chunks:
            w, cover = self.whole_chunk(bufs, c, K)
            n = min(L, self.P - c * L)
            if not (bool((cover[:n] == 1).all()) and bool((cover[n:] == 0).all())):
                raise AssertionError(f"arctic chunk {c}: coordinates held {cover.unique()}")
            self.whole[c] = w
            want = ra._add_chunk(ra._zero_stats(K, (K, cfg.sketch_dim), w.device), w)
            want = want._replace(sketch=ra._count_sketch(w, c, cfg.sketch_dim, cfg.seed))
            part = ra._zero_stats(K, (K, cfg.sketch_dim), w.device)
            for vals, pos in self.pieces(bufs, c):
                g = vals.float()
                part = ra._add_chunk(part, g)
                part = part._replace(sketch=part.sketch + ra._sketch_coords(
                    vals, pos + c * L, cfg, hashes))
            flat = torch.cat([x.reshape(-1) for x in part])
            got = all_reduce_in_rank_order(flat, self.model.tp.group)
            ref = torch.cat([x.reshape(-1) for x in want])
            err = float(((got - ref).abs() / (ref.abs() + 1e-3)).max())
            if err > ARCTIC_STATS_RTOL:
                raise AssertionError(f"arctic chunk {c}: the ranks' statistics at {err} of "
                                     "the whole chunk's")
            worst = max(worst, err)
        self.stats_err = worst

    def hold(self, grads, info):
        import torch.distributed as dist

        from repro_torch.distributed import robust_allreduce as ra

        torch = self.torch
        w = info["weights"].float()
        mine = torch.cat([w] + [info[k].float() for k in MASKS if k in info])
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        if any(not torch.equal(e, every[0]) for e in every):
            raise AssertionError(f"arctic: the ranks' weights and masks differ: {every}")
        bufs = grads if isinstance(grads, tuple) else (grads,)
        worst = 0.0
        wsum = torch.clamp(w.sum(), min=1e-12)
        for c, chunk in self.whole.items():
            got, _ = self.whole_chunk(tuple(b[None] for b in bufs), c, 1)
            x = chunk.to(torch.bfloat16)
            if float(w.sum()) > 0:
                want = ra._rank_sum(x * (w / wsum)[:, None].to(torch.bfloat16))
            else:
                want = ra._rank_sum(x) / x.shape[0]
            err = (got[0] - want.float()).abs()
            if bool((err > 2.0 ** -7 * want.float().abs() + 1e-30).any()):
                raise AssertionError(f"arctic chunk {c}: the aggregate {float(err.max())} "
                                     "from the chunk's weighted sum")
            worst = max(worst, float(err.max()))
        self.errs.append(dict(stats_rel=self.stats_err, aggregate=worst))
        self.whole = {}


def arctic_child(rank, S, store_path, out_dir, backend) -> None:
    """One rank of the four-card Arctic run: Arctic at ``ARCTIC_LAYERS``
    layer(s), full width, bf16 parameters, Adafactor, the flat layout, M =
    S on ``nccl``, K = ``ARCTIC_K`` emulated, noise on one, S = 1025,
    ``ARCTIC_STEPS`` steps under ``ArcticHold``."""
    import os

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import dataclasses

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    res = {"rank": rank}
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.core import flatten as F
        from repro_torch.core.wfagg import WFAggConfig
        from repro_torch.data.synthetic import TokenStream
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.train import trainer as tr

        dist.init_process_group(backend, store=dist.FileStore(store_path, S), rank=rank,
                                world_size=S)
        try:
            cfg = dataclasses.replace(get_config(ARCTIC_ARCH), n_layers=ARCTIC_LAYERS)
            mesh = make_test_mesh(data=ARCTIC_K, model=S, model_group=dist.group.WORLD)
            tc = train_config("wfagg", layout="flat", attack="noise", n_malicious=1,
                              wfagg=WFAggConfig(f=1, transient=3, window=3))
            t0 = time.perf_counter()
            state = tr.init_train_state(cfg, tc, torch.Generator(device="cuda").manual_seed(0),
                                        mesh)
            torch.cuda.synchronize()
            rep = {"init_s": round(time.perf_counter() - t0, 1),
                   "param_dtype": cfg.param_dtype, "optimizer": cfg.optimizer,
                   "P_rank": [b.numel() for b in F.layout_split(state.params)],
                   "state_gib": round(torch.cuda.memory_allocated() / 2 ** 30, 2)}
            obs = ArcticHold(torch, tc, state.params, mesh)
            rep["P"] = obs.P
            step = tr.build_train_step(cfg, tc, mesh, observe=obs)
            stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, ARCTIC_K)
            losses, weights = [], []
            for i in range(ARCTIC_STEPS):
                b = stream.batch(i, device="cuda")
                obs.start()
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                weights.append([round(float(x), 4) for x in m["weights"]])
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"arctic: non-finite loss {losses}")
            dtypes = sorted({str(p.dtype) for p in state.params.parameters()})
            rep.update(losses=losses, weights=weights, ms=obs.steps, holds=obs.errs,
                       chunks=obs.chunks, dtypes=dtypes)
            res["report"] = rep
        finally:
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 - the parent fails the run on it
        import traceback
        res["error"] = traceback.format_exc()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


# --only tpcards at four cards: LLaVA-NeXT-34B at full width, 1 of its 60
# layers (5.71 GiB of f32 parameters a copy: one card holds the stacked
# layout's 2K + 7 copies only at K = 2), M = 4 (14 live heads a rank padded
# to 16), K = 6 candidates under IPM-100 on one, Adafactor (its config's),
# the stacked layout, WFAgg on fused, held to one process and to the
# reference backend's route; served beside it at 1 x 8192 (576 patches and
# 7,616 tokens)
LLAVA_CARDS_K = 6
LLAVA_CARDS_STEPS = 3
LLAVA_CARDS_JOBS = (("llava-next-34b", 1, (1, 8192), True, 1,
                     (("wfagg", "fused", LLAVA_CARDS_STEPS),)),)
# the peak a card predicted before the first run: ROADMAP's 2K + 7 copies of
# a rank's quarter of the 5.71 GiB model (19 x 1.43 GiB), plus the holds'
LLAVA_CARDS_PREDICTED_GIB = 27


def run_llava_cards(torch) -> tuple:
    """LLaVA-NeXT-34B on the four cards (``run_fam_path`` on one ``nccl``
    rank a card, ``LLAVA_CARDS_JOBS``): served and trained, held to one
    process (its prefill, decode and step-1 gradient fit one card) and to
    the reference backend's route; the peak a card printed against
    ``LLAVA_CARDS_PREDICTED_GIB``; then kernels 4, 6 and 7 at a rank's
    (K, P_s) block, held and timed (``check_grid_kernels``).  Returns
    (launches, report)."""
    S = torch.cuda.device_count()
    launches, rep = run_fam_path(torch, "nccl", S, LLAVA_CARDS_JOBS, hold=True,
                                 K=LLAVA_CARDS_K)
    job = rep["llava-next-34b"]
    per = job["per_rank"]
    peak = max(max(p["train"]["wfagg fused"]["peak_gib"]) for p in per)
    serve_peak = max(p["serve"]["peak_gib"] for p in per)
    card = gpu_line()
    print(f"  llava-next-34b at 1 of 60 layers, M = {S}, K = {LLAVA_CARDS_K}, Adafactor, "
          f"stacked: training peak a card {peak} GiB (predicted ~{LLAVA_CARDS_PREDICTED_GIB} "
          f"GiB before the first run), serving peak {serve_peak} GiB ({card})")
    P_s = per[0]["train"]["wfagg fused"]["P"][0]
    errs, kernels = check_grid_kernels(torch, LLAVA_CARDS_K, P_s, None,
                                       where="LLaVA's model-axis (four cards)")
    return launches, dict(rep, peak_gib=peak, serve_peak_gib=serve_peak, kernels=kernels,
                          max_abs_err=errs)


def run_arctic_cards(torch) -> dict:
    """Arctic's plan on the four cards (``arctic_child``, one ``nccl`` rank
    a card): per rank each step's phase ms and peak, the sampled-chunk
    holds; the parameters stay bf16; the ranks' losses equal."""
    import tempfile

    S = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_arctic_")
    t0 = time.perf_counter()
    ranks = run_ranks(torch, "nccl", S, child=arctic_child, tmp=tmp, timeout=ARCTIC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    card = gpu_line()
    reps = [r["report"] for r in ranks]
    if any(r["losses"] != reps[0]["losses"] for r in reps):
        raise AssertionError(f"arctic: the ranks' losses differ: {[r['losses'] for r in reps]}")
    if any(r["dtypes"] != ["torch.bfloat16"] for r in reps):
        raise AssertionError(f"arctic: parameters in {[r['dtypes'] for r in reps]}")
    r0 = reps[0]
    print(f"  {card}: {ARCTIC_ARCH} at {ARCTIC_LAYERS} of 35 layers, full width, "
          f"{r0['param_dtype']} parameters, {r0['optimizer']}, the flat layout, M = {S}, K = "
          f"{ARCTIC_K} (noise on one), S = {TRAIN_SEQ}: P = {r0['P']:,}, a rank's P_s / P_r "
          f"{r0['P_rank']}, its state {r0['state_gib']} GiB after init ({r0['init_s']} s); the "
          f"ranks {seconds:.1f} s")
    for i, r in enumerate(reps):
        print(f"  rank {i}: loss "
              f"{[round(x, 4) for x in r['losses']]}, weights {r['weights'][-1]}; ms a step "
              f"(grads, attack, flat all-reduce, optimizer, peak GiB) {r['ms']}; sampled "
              f"chunks {r['chunks']} held {r['holds']}")
    peak = max(s["peak_gib"] for r in reps for s in r["ms"])
    print(f"  arctic peak a card {peak} GiB ({card})")
    return {"card": card, "seconds": round(seconds, 1), "peak_gib": peak, "per_rank": reps}


def main(argv=()) -> int:
    import torch

    only = argv[1] if len(argv) == 2 and argv[0] == "--only" else None
    if argv and only not in ("distributed", "cards", "train", "moe", "ssm", "encdec", "tp",
                             "grid", "tpfam", "tpfamcards", "tpcards", "bf16", "many"):
        print("usage: chip_smoke.py [--only distributed|cards|train|moe|ssm|encdec|tp|grid|"
              "tpfam|tpfamcards|tpcards|bf16|many]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.engine import DFLConfig, run_experiment
    from repro_torch.kernels import common

    print(gpu_line())
    t_main = time.perf_counter()

    def at() -> str:
        """Phase 3's headers carry the seconds since the build began."""
        return f"[3 +{time.perf_counter() - t_main:.0f} s]"

    # ---- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    libs = common.build(*dict.fromkeys(ROOT / src for _, _, src, _ in KERNELS.values()))
    print(f"[1] built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for so in libs:
        entry = ""
        for line in so.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]     # the mangled kernel and its template
            if "registers" in line or "spill" in line:
                print(f"    {so.name.rsplit('_', 1)[0]} {entry} ptxas: {line.strip()}")
    print_cluster_sizes()
    print_stats_plans()
    print_combine_plans()
    if only == "many":
        print("[2] more than 32 candidates and neighbours alone (--only many): kernels 4, 5 "
              "and 6 against their plain versions and timed, kernels 4 and 5 against their "
              "order's emulation; kernels 1, 2 and 3 above 32 against their plain versions, "
              "kernels 1 and 2 against their order's emulation, the stacked fused route at "
              "K=64, timed; then the CFL server over 100 clients and the DFL run over 100 "
              "nodes; no kernels or ok line")
        errs, timed = check_many_candidates(torch)
        check_stats_kernel_order(torch)
        errs.update(check_many_neighbours(torch))
        check_kernel_order(torch, many_order_slates())
        errs["wfagg_round_indexed"].append(check_stacked_many(torch)[0])
        timed.update(time_many_neighbours(torch))
        print(f"[3] CFL over {CFL_MANY[0]} clients")
        launches, accs = run_cfl_many(torch)
        print(f"[3] DFL over {DFL_MANY[0]} nodes at a degree above 32")
        dfl_launches, dfl_accs = run_dfl_many(torch)
        for k in KERNELS:
            launches[k] += dfl_launches[k]
        print(json.dumps({"many": {"launches": {k: c for k, c in launches.items() if c},
                                   "max_abs_err": {k: max(v) for k, v in errs.items()},
                                   "timed": timed, "final_acc": accs,
                                   "dfl_final_acc": {" ".join(k): a
                                                     for k, a in dfl_accs.items()}}}))
        return 0
    if only == "distributed":
        print("[3] distributed alone (--only distributed): no kernels or ok line")
        launches, errs, timed = run_distributed(torch)
        print(json.dumps({"distributed": {"launches": launches, "max_abs_err": {
            k: max(v) for k, v in errs.items()}, "timed": timed}}))
        return 0
    if only == "train":
        print("[3] the trainer alone (--only train): no kernels or ok line")
        launches, report = run_train_path(torch)
        print(json.dumps({"train": {"launches": launches, "report": report}}))
        return 0
    if only == "moe":
        print("[3] the MoE family alone (--only moe): no kernels or ok line")
        launches, errs, flash_times, report = run_moe_path(torch)
        print(json.dumps({"moe": {"launches": launches, "flash_max_abs_err": max(errs),
                                  "flash_times": flash_times, "report": report}}))
        return 0
    if only == "ssm":
        print("[3] the SSM and hybrid families alone (--only ssm): no kernels or ok line")
        launches, err, flash_times, report = run_ssm_path(torch)
        print(json.dumps({"ssm": {"launches": launches, "flash_max_abs_err": err,
                                  "flash_times": flash_times, "report": report}}))
        return 0
    if only == "encdec":
        print("[3] the encoder-decoder and VLM families alone (--only encdec): no kernels or "
              "ok line")
        launches, report = run_encdec_path(torch)
        print(json.dumps({"encdec": {"launches": launches, "report": report}}))
        return 0
    if only == "tp":
        print(f"[3] the model axis alone (--only tp): {TP_ARCH} on {TP_M} gloo ranks sharing "
              "the card; no kernels or ok line")
        launches, report = run_tp_path(torch, serve_layers=TP_SERVE_LAYERS)
        print(json.dumps({"tp": {"launches": {k: c for k, c in launches.items() if c},
                                 "report": report}}))
        return 0
    if only == "grid":
        print(f"[3] the grid alone (--only grid): {GRID_ARCH} on {GRID_K} x {GRID_M} gloo "
              "ranks sharing the card; no kernels or ok line")
        launches, errs, report = run_grid_path(torch)
        print(json.dumps({"grid": {"launches": {k: c for k, c in launches.items() if c},
                                   "max_abs_err": errs, "report": report}}))
        return 0
    if only == "tpfam":
        print(f"[3] the families on the model axis and the grid alone (--only tpfam): "
              f"{FAM_M} gloo ranks sharing the card, then "
              f"{' and '.join(j[0] for j in FAM_GRID)} on {GRID_K} x {GRID_M}; no kernels or "
              "ok line")
        launches, errs, report = run_tpfam(torch)
        print(json.dumps({"tpfam": {"launches": {k: c for k, c in launches.items() if c},
                                    "max_abs_err": errs, "report": report}}))
        return 0
    if only == "bf16":
        print("[3] bf16 parameters and a padded layout's head slots alone (--only bf16): no "
              "kernels or ok line")
        launches, report = run_bf16_path(torch)
        print(json.dumps({"bf16": {"launches": {k: c for k, c in launches.items() if c},
                                   "report": report}}))
        return 0
    if only == "tpfamcards":
        print(f"[3] the families on one nccl rank per card alone (--only tpfamcards): "
              f"{torch.cuda.device_count()} cards; no kernels or ok line")
        la, report = run_fam_path(torch, "nccl", torch.cuda.device_count(), CARDS_FAM_JOBS,
                                  hold=False)
        print(json.dumps({"tpfamcards": {"launches": {k: c for k, c in la.items() if c},
                                         "report": report}}))
        return 0
    if only == "tpcards":
        print(f"[3] the model axis on one nccl rank per card alone (--only tpcards): " + (
                  f"llava-next-34b at 1 layer, full width, Adafactor, stacked, M = 4, K = "
                  f"{LLAVA_CARDS_K}, then {ARCTIC_ARCH} at {ARCTIC_LAYERS} layer, full width, "
                  "bf16, Adafactor, flat, M = 4, then " if torch.cuda.device_count() == 4
                  else "") +
              f"{TP_ARCH} at M = {torch.cuda.device_count()}" + (
                  f", then {CARDS_TP_ARCH} uncut at M = 4, stacked and flat"
                  if torch.cuda.device_count() == 4 else "") + "; no kernels or ok line")
        print(json.dumps({"tpcards": run_tp_cards(torch)}))
        return 0
    if only == "cards":
        print(f"[3] the distributed parts on one nccl rank per card (--only cards): "
              f"{torch.cuda.device_count()} cards; no kernels or ok line")
        cards = run_cards(torch)
        print(f"[3] the model axis on one nccl rank per card: {TP_ARCH} at M = "
              f"{torch.cuda.device_count()}" + (f", then {CARDS_TP_ARCH} uncut at M = 4"
                                                if torch.cuda.device_count() == 4 else ""))
        cards["tp"] = run_tp_cards(torch)
        if torch.cuda.device_count() == 4:
            print(f"[3] the grid on one nccl rank per card: {CARDS_GRID_ARCH} uncut at K = 4 x "
                  f"M = 1 (fsdp_params), then {GRID_ARCH} at K = 2 x M = 2")
            cards["grid"] = run_grid_cards(torch)
            print("[3] the families on one nccl rank per card at M = 4: Moonlight uncut served, "
                  "DeepSeek-V2-Lite (6 layers) and Falcon-Mamba-7B (32 layers) trained, K = "
                  f"{FAM_K}")
            la, cards["families"] = run_fam_path(torch, "nccl", 4, CARDS_FAM_JOBS, hold=False)
            cards["families"]["launches"] = {k: c for k, c in la.items() if c}
        print(json.dumps({"cards": cards}))
        return 0

    # ---- phase 2: kernel vs plain -------------------------------------------
    print("[2] kernel vs plain version on the card")
    topo = make_topology(20, 8, 2, "ring", placement="close")
    errs = {"wfagg_round_indexed": [compare_kernel(
        torch, "paper N=20 K=8 d=44426", 20, 8, 44426, topo.neighbor_indices, None,
        seed=1, dup=(0, 4))]}
    for N, K, d, seed in ((40, 16, 44426, 2), (48, 32, 20011, 3)):
        idx, valid = irregular_slate(N, K, seed)
        errs["wfagg_round_indexed"].append(compare_kernel(
            torch, f"irregular N={N} K={K} d={d} (degree 0)", N, K, d, idx, valid,
            seed=seed))
    errs["robust_stats"] = [
        compare_robust_stats(torch, CFL_K, CFL_D, 7, with_prev, centers)
        for with_prev in (False, True) for centers in (True, False)]
    errs["robust_stats"] += [compare_robust_stats(torch, K, d, 8, True, True)
                             for K, d in ((7, 20011), (32, 20011))]
    errs["pairwise_gram"] = [compare_gram(torch, K, D, 9) for K, D in (
        (CFL_K, CFL_D), (BIG_K, BIG_D), (7, 37), (32, 37))]
    errs["weighted_agg"] = [compare_weighted_agg(torch, *case) for case in COMBINE_CASES]
    paper = time_round(torch, 20, 8, 44426, seed=5)
    print(f"  paper shape N=20 K=8 d=44426: kernel {paper[0]:.4f} ms, plain "
          f"{paper[1]:.4f} ms, bound {paper[2]:.5f} ms ({paper[3]})")
    ms, plain_ms, bound_ms, bound_by = time_round(torch, 64, 16, 1 << 20, seed=6)
    print(f"  N=64 K=16 d=2^20: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes "
          "this function, so there is no library time")
    timed = {"wfagg_round_indexed": dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=bound_by, library_ms=None)}
    cfl_timed = time_cfl_kernels(torch, CFL_K, CFL_D, seed=11)
    timed.update(time_cfl_kernels(torch, BIG_K, BIG_D, seed=12))
    for name, t in cfl_timed.items():
        timed[name]["paper_shape"] = t

    print("[2] the gossip round's Gram variant and the two-launch kernels vs plain")
    slates = [("paper ring N=20 K=8 d=44426", 20, 8, 44426, topo.neighbor_indices,
               None, 21)]
    for N, K, d, seed in ((20, 8, 44426, 22), (40, 16, 44426, 23), (40, 20, 44426, 29),
                          (48, 32, 20011, 24)):
        idx, valid = irregular_slate(N, K, seed)
        slates.append((f"irregular N={N} K={K} d={d} (degree 0)", N, K, d, idx, valid,
                       seed))
    errs["robust_stats_indexed"], errs["weighted_agg_indexed"] = [], []
    for label, N, K, d, idx, valid, seed in slates:
        errs["wfagg_round_indexed"].append(compare_gram_round(
            torch, f"Gram round {label}", N, K, d, idx, valid, seed, dup=(0, 4)))
        combos = (((False, False), (True, False), (False, True), (True, True))
                  if K in (8, 20) else ((False, False), (True, True)))
        errs["robust_stats_indexed"] += [compare_indexed_stats(
            torch, f"robust_stats_indexed {label}", N, K, d, idx, valid, seed, (0, 4),
            with_prev, need_gram) for with_prev, need_gram in combos]
        errs["weighted_agg_indexed"].append(compare_weighted_agg_indexed(
            torch, f"weighted_agg_indexed {label}", N, K, d, idx, valid, seed))
    errs["weighted_agg_indexed"] += check_combine_indexed_extra(torch)
    check_combine_memory(torch)
    check_unpadded_rows(torch)
    paper_timed = time_dfl_kernels(torch, 20, 8, 44426, seed=25)
    dfl_timed = time_dfl_kernels(torch, 64, 16, 1 << 20, seed=26)
    timed["wfagg_round_indexed"]["gram_variant"] = dfl_timed.pop("wfagg_round_indexed_gram")
    timed.update(dfl_timed)
    timed["weighted_agg_indexed"] = time_combine_indexed(torch, 64, 16, 1 << 20, seed=26)
    timed["weighted_agg_indexed"]["paper_shape"] = time_combine_indexed(
        torch, 20, 8, 44426, seed=25)
    print("  kernels 3 and 7 (redesigned), kernel ms / bound ms / plain ms / library ms, "
          "and before that redesign:")
    print_combine_times(timed)
    time_gram_epilogue(torch, 64, 32, 8192, seed=28)
    time_dfl_backends(torch, 64, 16, 1 << 20, seed=27)

    print("[2] the prev_idx variants of the round and statistics kernels on stacked "
          "chaos matrices (apply_transport)")
    r, flat, tout = paper_chaos_stack(torch, 44426)
    for name, e in compare_prev_idx(torch, f"paper N=20 K=8 d=44426 churn+chaos round {r}",
                                    flat, tout, seed=41).items():
        errs[name] = e
    for N, K, d, seed in ((40, 16, 44426, 42), (48, 32, 20011, 43)):
        idx, valid = irregular_slate(N, K, seed)
        flat, tout = chaos_stack(torch, N, K, d, idx, valid, seed)
        for name, e in compare_prev_idx(torch, f"irregular N={N} K={K} d={d} (degree 0)",
                                        flat, tout, seed).items():
            errs[name] += e
    check_overflow_row(torch)
    check_kernel_order(torch, [sl for sl in slates if sl[2] != 8 or sl[5] is None])
    timed.update(time_prev_idx_kernels(torch, 64, 16, 1 << 20, seed=44))
    paper_timed.update(time_prev_idx_kernels(torch, 20, 8, 44426, seed=45))

    print("[2] kernel 5 (the gathered statistics) and the per-edge prev variants of the "
          "round and statistics kernels")
    errs["robust_stats_batch"], k5 = check_kernel5(torch)
    print("[2] more than 32 candidates: kernels 4 and 5's wide path and kernel 6's output "
          "tiles against their plain versions, then timed")
    many_errs, many_timed = check_many_candidates(torch)
    for name, e in many_errs.items():
        errs[name] += e
    check_stats_kernel_order(torch)
    (main_shape, main_t), *rest = [(s_, t) for s_, t in k5.items() if s_[0] == 64] + [
        (s_, t) for s_, t in k5.items() if s_[0] != 64]
    shape_label = lambda s_: (f"N={s_[0]} K={s_[1]} d={s_[2]} prev={s_[3]} "  # noqa: E731
                              f"centers={s_[4]}")
    timed["robust_stats_batch"] = dict(main_t, shape=shape_label(main_shape),
                                       other_shapes={shape_label(s_): t for s_, t in rest})
    for name, t in many_timed.items():
        timed[name]["many_candidates"] = t
    errs["wfagg_round_indexed[per_edge_prev]"] = []
    errs["robust_stats_indexed[per_edge_prev]"] = []
    for label, N, K, d, idx, valid, seed in slates:
        for name, e in compare_per_edge(torch, f"per-edge prev {label}", N, K, d, idx,
                                        valid, seed + 30, (0, 4)).items():
            errs[name] += e
    timed.update(time_per_edge_kernels(torch, 64, 16, 1 << 20, seed=57))
    paper_timed.update(time_per_edge_kernels(torch, 20, 8, 44426, seed=58))
    print("[2] more than 32 neighbours: kernels 1 and 2's wide route and kernel 3 at K up "
          "to 1,024 against their plain versions, kernels 1 and 2 against their order's "
          "emulation, the stacked fused route at K=64, then timed")
    t_nb = time.perf_counter()
    for name, e in check_many_neighbours(torch).items():
        errs[name] += e
    check_kernel_order(torch, many_order_slates())
    errs["wfagg_round_indexed"].append(check_stacked_many(torch)[0])
    many_nb_timed = time_many_neighbours(torch)
    for name, t in many_nb_timed.items():
        timed[name]["many_neighbours"] = t
    print(f"  more than 32 neighbours: {time.perf_counter() - t_nb:.1f} s")
    paper_timed["wfagg_round_indexed"] = dict(zip(
        ("ms", "plain_ms", "bound_ms", "bound_by"), paper))
    print_round_kernel_times(timed, paper_timed)
    for name in KERNELS:
        if name.startswith(("wfagg_round_indexed", "robust_stats_indexed")):
            timed[name]["paper_shape"] = paper_timed[name]

    print("[2] kernel 8, flash attention")
    errs["flash_attention"], timed["flash_attention"] = check_flash(torch)

    # ---- phase 3: the main paths --------------------------------------------
    print(f"{at()} DFL main path: run_experiment, LeNet-5, paper topology, IPM-100, "
          f"{ROUNDS} rounds")
    data = SyntheticImages()
    cfg = DFLConfig(aggregator="wfagg", attack="ipm_100", model="lenet",
                    wfagg_backend="fused")
    zero_counts()
    out = run_experiment(cfg, topo, data, rounds=ROUNDS)
    dfl_counts = read_counts()
    base = run_experiment(DFLConfig(aggregator="mean", attack="ipm_100", model="lenet"),
                          topo, data, rounds=ROUNDS)
    for name, o in (("wfagg", out), ("mean", base)):
        s = o["series"]
        print(f"  {name:5s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}")
    want = {name: ROUNDS if name == "wfagg_round_indexed" else 0 for name in KERNELS}
    if dfl_counts != want:
        raise AssertionError(f"DFL path launches {dfl_counts}, expected {want}")
    print(f"  launches on the DFL path: {dfl_counts} (one round kernel per round)")
    if not all(np.isfinite(e["acc_all"]).all() for e in out["trace"]):
        raise AssertionError("non-finite accuracy on the main path")
    check_against_reference(torch, cfg, topo, data, ROUNDS)

    print(f"{at()} DFL Alt-WFAgg and the two-launch backend: run_experiment, LeNet-5, "
          f"paper topology, IPM-100, {ROUNDS} rounds")
    dfl_launches = dict(dfl_counts)
    times = {"wfagg on fused": out, "mean": base}
    for agg, backend in (("alt_wfagg", "fused"), ("alt_wfagg", "fused_two_launch"),
                         ("wfagg", "fused_two_launch")):
        cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="lenet",
                        wfagg_backend=backend)
        zero_counts()
        o = run_experiment(cfg, topo, data, rounds=ROUNDS)
        counts = read_counts()
        want = dict.fromkeys(KERNELS, 0)
        if backend == "fused":
            want["wfagg_round_indexed"] = ROUNDS
        else:
            want["robust_stats_indexed"] = want["weighted_agg_indexed"] = ROUNDS
        if counts != want:
            raise AssertionError(f"DFL {agg} on {backend} launches {counts}, "
                                 f"expected {want}")
        print(f"  launches on the DFL {agg} {backend} path: {counts}")
        if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
            raise AssertionError(f"non-finite accuracy on the DFL {agg} {backend} path")
        for name in KERNELS:
            dfl_launches[name] += counts[name]
        times[f"{agg} on {backend}"] = o
        check_against_reference(torch, cfg, topo, data, ROUNDS)
        if agg == "alt_wfagg" and backend == "fused":
            # the Gram epilogue against the second route: kernels 2 and 3
            # and the host scoring stage
            check_against_reference(torch, cfg, topo, data, ROUNDS,
                                    against="fused_two_launch")
    for name, o in times.items():
        s = o["series"]
        print(f"  {name:27s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}")

    print(f"{at()} Table I: run_experiment, MLP, paper topology (spaced), IPM-100, 4 rounds, "
          "every aggregator in DFL and CFL")
    table, table_launches = run_table1(torch, data)
    accs = {agg: table[(agg, False)]
            for agg in ("mean", "wfagg", "alt_wfagg", "multi_krum", "clustering")}
    print("  DFL IPM-100 claim (MLP, 4 rounds): " + ", ".join(
        f"{agg} {a:.4f}" for agg, a in accs.items()))
    for agg in ("wfagg", "alt_wfagg"):
        if not (accs[agg] > 0.9 and accs[agg] > accs["mean"] + 0.2):
            raise AssertionError(f"DFL IPM-100 claim does not hold for {agg}: {accs}")

    print(f"{at()} CFL main path: run_experiment(centralized=True), LeNet-5, the same "
          f"topology, IPM-100, {ROUNDS} rounds")
    cfl_launches = dict.fromkeys(KERNELS, 0)
    for agg in ("wfagg", "alt_wfagg"):
        cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="lenet", centralized=True)
        zero_counts()
        o = run_experiment(cfg, topo, data, rounds=ROUNDS)
        counts = read_counts()
        want = dict(dict.fromkeys(KERNELS, 0), robust_stats=ROUNDS, weighted_agg=ROUNDS,
                    pairwise_gram=ROUNDS if agg == "alt_wfagg" else 0)
        s = o["series"]
        print(f"  {agg:9s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}")
        if counts != want:
            raise AssertionError(f"CFL {agg} launches {counts}, expected {want}")
        print(f"  launches on the CFL {agg} path: {counts}")
        if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
            raise AssertionError(f"non-finite accuracy on the CFL {agg} path")
        for name in KERNELS:
            cfl_launches[name] += counts[name]
        check_cfl_against_reference(torch, cfg, topo, data, ROUNDS)

    accs = {agg: table[(agg, True)] for agg in ("mean", "wfagg", "alt_wfagg")}
    print(f"  CFL IPM-100 claim (MLP, 4 rounds): wfagg {accs['wfagg']:.4f}, "
          f"alt_wfagg {accs['alt_wfagg']:.4f}, mean {accs['mean']:.4f}")
    if not (accs["wfagg"] > accs["mean"] + 0.2 and accs["alt_wfagg"] > accs["mean"] + 0.2):
        raise AssertionError(f"CFL IPM-100 claim does not hold: {accs}")

    print(f"{at()} CFL over {CFL_MANY[0]} clients: run_experiment(centralized=True), MLP, "
          f"{CFL_MANY[1]}-regular ring, {CFL_MANY[2]} Byzantine under IPM-100, "
          f"{CFL_MANY_ROUNDS} rounds of {', '.join(CFL_MANY_RULES)}")
    cfl_many_launches, _ = run_cfl_many(torch)

    print(f"{at()} DFL over {DFL_MANY[0]} nodes at a degree above 32: run_experiment, MLP, "
          f"{DFL_MANY[1]} Byzantine under IPM-100, {DFL_MANY[2]} rounds on a 48-regular ring "
          "and an Erdős–Rényi graph, WFAgg and Alt-WFAgg on fused, WFAgg on "
          "fused_two_launch, the mean")
    dfl_many_launches, _ = run_dfl_many(torch)

    print(f"{at()} dynamic topologies and chaos transport: run_dynamic_experiment, "
          f"LeNet-5, the same topology, IPM-100, {ROUNDS} rounds")
    dyn_launches = run_dynamic_paths(torch, topo, data)

    print(f"{at()} adaptive adversaries and the audit plane: the gate grid "
          f"(run_dynamic_experiment, MLP, {GATE_GRID['nodes']}-node ring, close placement, "
          f"{GATE_GRID['rounds']} rounds), band_rider and min_max replays, backend "
          "parity, band_rider on the chaos round, the flight run, CFL under min_max")
    adaptive_launches = run_adaptive_paths(torch)

    print(f"{at()} the gathered wfagg_batch with per-edge WFAgg-T state: LeNet-5, the same "
          f"topology, IPM-100, {ROUNDS} rounds")
    gathered_launches = run_gathered_path(torch, topo, data)

    print(f"{at()} serving {SERVE_ARCH} at full width: build_prefill (kernel 8 in every layer) "
          f"and build_decode_step")
    serve_launches = run_serve_path(torch)

    print(f"{at()} distributed: the d-sharded round on {SHARDS} gloo ranks on the one card "
          f"(round, scan, the sharded DFL engine), S=1 on nccl, and the stacked robust "
          f"all-reduce over {STACK_ARCH}-shaped candidates")
    dist_launches, dist_errs, dist_timed = run_distributed(torch)
    for name, e in dist_errs.items():
        errs[name] += e
    for name, t in dist_timed.items():
        if name in timed:
            timed[name]["distributed"] = t

    # the flat layout on FLAT_K data ranks at M = 1 runs under --only train: the
    # grid part's flat run drives the same chunked all-reduce over the data
    # group at Qwen's width (taken out of the whole script beside the bf16 /
    # pad-slot part, its time: 74.5 s of a 1,000 s run)
    print(f"{at()} training: the robust-DP trainer on {TRAIN_ARCH} at full width (stacked "
          f"layout, K={TRAIN_K}), the launcher")
    train_launches, _ = run_train_path(torch, flat_ranks=False)

    print(f"{at()} the MoE family: kernel 8 at the MoE prefills' shapes; DeepSeek-V2-Lite uncut, "
          f"Moonlight ({MOE_SERVE[1][1]} layers) and Arctic (2 layers) served; "
          f"DeepSeek-V2-Lite (2 layers) trained on the stacked robust-DP trainer, "
          f"K={MOE_TRAIN_K}")
    moe_launches, moe_errs, moe_flash, _ = run_moe_path(torch)
    errs["flash_attention"] += moe_errs
    timed["flash_attention"]["moe_shapes"] = moe_flash

    print(f"{at()} the SSM and hybrid families: kernel 8 at Zamba2's prefill shape; "
          "Falcon-Mamba-7B (4 of 64 layers) and Zamba2-1.2B (8 of 38) served; Zamba2 "
          f"({SSM_TRAIN_LAYERS} layers) trained on the stacked robust-DP trainer, "
          f"K={SSM_TRAIN_K}")
    ssm_launches, ssm_err, ssm_flash, _ = run_ssm_path(torch)
    errs["flash_attention"].append(ssm_err)
    timed["flash_attention"]["zamba2_shape"] = ssm_flash

    print(f"{at()} the encoder-decoder and VLM families: SeamlessM4T-medium uncut and "
          f"LLaVA-NeXT-34B ({ENCDEC_SERVE[1][1]} layers) served; Seamless "
          f"({ENCDEC_TRAIN_LAYERS} + {ENCDEC_TRAIN_LAYERS} layers) trained on the stacked "
          f"robust-DP trainer, K={ENCDEC_TRAIN_K}")
    encdec_launches, _ = run_encdec_path(torch)

    print(f"{at()} the model axis: {TP_ARCH} split over {TP_M} gloo ranks sharing the "
          f"card: served at {TP_SERVE_LAYERS} of 24 layers (prefill 2 x 8192 through kernel 8 "
          f"on each rank's heads, "
          f"decode) and trained at {TP_TRAIN_LAYERS} layers (K={TRAIN_K}, WFAgg on fused and "
          "fused_two_launch, Alt-WFAgg, the mean; kernels 4, 6 and 7 on each rank's blocks; "
          "the flat layout's WFAgg and mean, no kernel; min_max with gather_dtype bfloat16 "
          "and Adafactor)")
    tp_launches, tp_report = run_tp_path(torch, serve_layers=TP_SERVE_LAYERS)
    for name, t in tp_report["kernels"].items():
        timed[name]["model_axis"] = t

    print(f"{at()} the grid: {GRID_ARCH} at {GRID_LAYERS} layers on {GRID_K} x {GRID_M} gloo "
          "ranks sharing the card (the data axis as processes, FSDP blocks): served (prefill "
          f"{GRID_K} x 8192, one row a data rank, kernel 8 on each rank's heads; decode) and "
          f"trained (K={GRID_K}, one candidate a data rank, fsdp_params; WFAgg, Alt-WFAgg, the "
          "mean; kernels 4, 6 and 7 on each rank's column block; the flat layout's WFAgg, no "
          "kernel)")
    grid_launches, grid_errs, grid_report = run_grid_path(torch)
    for name, t in grid_report["kernels"].items():
        timed[name]["grid"] = t
    for name, e in grid_errs.items():
        errs[name].append(e)

    print(f"{at()} the families on the model axis: DeepSeek-V2-Lite, Zamba2-1.2B, "
          f"Falcon-Mamba-7B, Arctic, SeamlessM4T-medium and LLaVA-NeXT-34B at full width, cut "
          f"in depth, split over {FAM_M} gloo ranks sharing the card (served; DeepSeek, "
          f"Zamba2, Falcon-Mamba and Seamless trained at K = {FAM_K}); "
          f"{' and '.join(f'{j[0]} ({j[1]} layers)' for j in FAM_GRID)} trained on the "
          f"{GRID_K} x {GRID_M} grid; kernels 4, 6, 7 and 8 at their shapes")
    fam_launches, fam_errs, fam_report = run_tpfam(torch, grid_serve=False)
    for name, t in fam_report["kernels"].items():
        timed[name]["families"] = t
    for name, t in fam_report["grid_kernels"].items():
        timed[name]["families_grid"] = t
    for name, e in fam_errs.items():
        errs[name] += e if isinstance(e, list) else [e]

    print(f"{at()} bf16 parameters and a padded layout's head slots: the reduced Arctic in "
          f"bf16 with Adafactor at M = 1 (kernel 1), on 2 gloo ranks (kernels 4, 6 and 7 on "
          f"blocks) and the 2 x 2 grid, both layouts; the padded config (7 heads in 8 slots) "
          f"on 4 gloo ranks, both layouts; K = {BF16_K} under noise, {BF16_STEPS} steps, each "
          "held to the one-process route")
    bf16_launches, _ = run_bf16_path(torch)

    # each kernel's launches on the main paths that run it: the round kernel
    # on the DFL WFAgg and Alt-WFAgg runs, kernels 2 and 3 on the two
    # two-launch runs, the CFL kernels on the two CFL runs, the dynamic and
    # chaos runs (the prev_idx variants on the chaos runs only), the
    # adaptive phase (the gate grid's wfagg cells, the backend-parity runs,
    # the flight run, CFL under min_max), the CFL server over 100 clients
    # (kernels 4 and 7, and 6 under Alt-WFAgg), the DFL run over 100 nodes
    # (kernel 1, and kernels 2 and 3 on fused_two_launch), Table I's
    # WFAgg and Alt-WFAgg runs, and the gathered path (kernel 5; the
    # per-edge variants on the indexed calls fed its state), kernel 8 on the
    # full-width prefills, and the trainer's kernels 1, 4 and 6 (the stacked
    # runs with their hold, the launcher); the MoE part's kernel 8 (the
    # Moonlight and Arctic prefills, all on the tensor-core kernel) and its
    # training's kernels 1, 4 and 6; the SSM part's kernel 8 (Zamba2's
    # prefills, on the tensor-core kernel) and its training's kernels 1, 4
    # and 6; the encoder-decoder and VLM part's kernel 8 (the Seamless and
    # LLaVA prefills, on the tensor-core kernel) and its training's kernels
    # 1, 4 and 6; the model axis's kernel 8 (each rank's prefills) and its
    # training's kernels 4, 6 and 7, summed over the ranks; the grid's kernel
    # 8 (each rank's prefill) and its training's kernels 4, 6 and 7, summed
    # over the ranks; the families' kernel 8 (Zamba2's and Arctic's prefills on
    # the model axis) and kernels 4, 6 and 7 of their
    # training, summed over the ranks; the bf16 / pad-slot part's kernel 1 (M =
    # 1, stacked) and kernels 4, 6 and 7 (its ranks' stacked runs)
    launches = {name: dfl_launches[name] + cfl_launches[name] + cfl_many_launches[name]
                + dfl_many_launches[name] + dyn_launches[name]
                + adaptive_launches[name] + table_launches[name]
                + gathered_launches[name] + serve_launches[name] + dist_launches[name]
                + train_launches[name] + moe_launches[name] + ssm_launches[name]
                + encdec_launches[name] + tp_launches[name] + grid_launches[name]
                + fam_launches[name] + bf16_launches[name] for name in KERNELS}
    # the model axis's and the grid's prefills run on the tensor-core kernel
    # only (checked per rank), so their kernel-8 launches are all tensor-core
    timed["flash_attention"]["launches_tc"] = (serve_launches["flash_attention[tensor_core]"]
                                               + moe_launches["flash_attention"]
                                               + ssm_launches["flash_attention"]
                                               + encdec_launches["flash_attention"]
                                               + tp_launches["flash_attention"]
                                               + grid_launches["flash_attention"]
                                               + fam_launches["flash_attention"])
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=replaces,
        launches=launches[name], max_abs_err=max(errs[name]), **timed[name])
        for name, (_, _, src, replaces) in KERNELS.items()]}))
    print(f"{at()} done")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
