#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one NVIDIA GPU

Phases (any failure exits nonzero, and nothing is swallowed):

  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     from the checkout's sources (one nvcc per source, all at once, sm_90a)
     and report the seconds; read each kernel's SASS (``cuobjdump -sass``):
     count the 128-bit global loads and stores (LDG.E.128, STG.E.128) of
     every K1/K2 instance and the tensor-core instructions of the
     flash-attention and ssd_scan kernels (HGMMA for wgmma, HMMA for
     mma.sync), and fail if a K1/K2 instance has no 128-bit load or store,
     K3's bf16 kernel ((Dqk, Dv) = (64, 64), (128, 128), (256, 256),
     (192, 128)) has no HGMMA, K4's f32 kernel no tensor-core instruction,
     or K3's f32 kernel (the same four) no HMMA; print K3's registers and
     spills (ptxas) and fail if its f32 kernel spills;
  2. every kernel against its plain PyTorch version on the card, at its
     main path's shapes, with times (CUDA events around batches of 20
     back-to-back calls, the median of 5 batches) beside the plain
     version's, the bound, and one PyTorch library call where there is one:
       - K1 ``ota_round_step`` (f32, bf16, int8 wires) and K2
         ``ota_aggregate`` (f32, bf16) at the fleet's C = 7 cells, N = 10
         devices, D = 814,090, and at ragged D in {1, 5000}: bitwise equal
         to the plain versions (which take the kernels' order of f32
         operations) and within the f32 / bf16 tolerance; the main shape's
         achieved GB/s and share of the byte bound beside its time;
       - K3 ``flash_attention`` at the serve path's prefill (B 8, S 1024,
         H = KH = 16, Dh 64, bf16, causal), at qwen3's heads (H 16, KH 8,
         Dh 128), with window 256, at ragged S = 1000, at the prefills of
         granite-8b (H 32, KH 8, Dh 128), qwen2.5-14b (H 40) and
         chameleon-34b (H 64), at the qwen train run's eval (B 4, S 128),
         in f32 (the serve path's prefill in f32, qwen3's heads, window
         256), and at recurrentgemma-9b's local layers (Dh 256, H 16 over
         KH 1) at its prefill (B 8, S 1024) and past its window (B 2,
         S 4096, window 2048), in bf16 and in f32, and non-causal at
         seamless-m4t-medium's encoder (B 8, S 1024, H = KH = 16, Dh 64)
         and a ragged cross-attention (Sq 128 over Sk 1,024), in bf16 and
         in f32, and at mixtral-8x22b's sliding-window layers (H 48 over
         KH 8, Dh 128, window 4,096) at its prefill (B 8, S 1024) in bf16
         and in f32 and past its window (B 1, S 8,192) in f32, and at
         deepseek-v3-671b's MLA prefill (B 8, S 1024, H = KH = 128, q.k
         width 192, v width 128, causal) in bf16 and in f32, and at the
         held-out evals of phase 19's train runs (B 4, S 4,096: qwen's
         H = KH = 16, Dh 64, causal; recurrentgemma's Dh 256, H 16 over
         KH 1, window 2,048) in bf16, and at phase 20's (seamless's
         encoder self-attention, B 4, S 4,096, H = KH = 16, Dh 64, and its
         cross-attention, Sq = Sk = 4,096, non-causal) in bf16 and in
         f32 -- f32 to
         2e-5, bf16 to two bf16 ulps plus 1e-2 (past Sq.Sk = 2048^2 the
         plain version is the blocked form); the
         shapes, the bound (the pairs the masks allow: all Sq x Sk
         non-causal; 2 (Dqk + Dv) operations a pair) and the
         ``scaled_dot_product_attention`` call timed beside it (with the
         backend that ran it, or a null time and the error's first line
         where no backend takes the shape) are
         ``repro_torch.profile_attention``'s; the f32 bound takes the
         cheaper of the FMA units and 3xTF32;
       - K4 ``ssd_scan`` at the mamba2 prefill's scan (B 8, S 1024, H 64,
         P 64, N 128, G 1, f32, chunk 128), at ragged S = 1000, with
         G = 2 and a nonzero state0, with bf16 inputs, at the smoke
         model's P = N = 32, and at the mamba2 train run's eval (B 4,
         S 128) -- y and the final state to 1e-4 of their
         largest magnitude plus 2e-4 relative (bf16 y: 1.6e-2); its
         bound takes the cheaper of the f32 FMA units and 3xTF32 on the
         tensor cores; no PyTorch call computes the scan, so no library
         time;
  3. the fleet's main path at full width through ``repro_torch.fig2.run``:
     paper_mlp, 7 schemes, minibatch 128, flat, fused, f32 uplink, 30
     rounds with an eval every 10 -- K1 must launch once per round and the
     plain versions never; then the unfused path (K2 once per round) and
     the bf16 and int8 uplinks (K1 once per round), a few rounds each;
  4. the fleet with its kernels against the same fleet with the kernels
     forced off, on the same draws, for 3 rounds (fused and unfused, f32
     uplink): the params must agree to the f32 tolerance (an int8 wire is
     left out: a reordered f32 sum may move one gradient element across a
     quantizer boundary, a whole quantum, in later rounds);
  5. the Fig.-2 path closed: (a) the ``sca`` design of the ported solver
     (``repro_torch.solvers``, float64 on the card) at the full-width
     Fig.-2 world against the reference's default design committed in
     ``experiments/fig2_reference/sca_design.json``: gamma, alpha and the
     chi thresholds within 1e-6 relative, the (P1) objective within 1e-9,
     and the design's wall beside the SLSQP design's (the schemes are
     designed once, before phase 3, and phases 3-5 use them); (b) ``repro_torch.curves``'s gate at full
     width: ``fig2.run`` for seeds 0-3, 150 rounds, an eval every 10, in
     both protocols -- minibatch 128 on the fused f32 path (K1 once per
     round, 150 a run, the plain versions never) and the paper's full
     batch (aggregated leaf by leaf: no OTA kernel and no plain OTA
     version, by design) -- each scheme's final accuracy, final global
     loss and mean accuracy over the seeds held against the reference's
     committed curves (``experiments/fig2_reference``); (c) kill and
     resume: the minibatch fleet for 30 rounds stopped after its first
     chunk (``max_chunks=1``) and resumed from its checkpoint, bitwise
     equal (params, traces, evals) to an uninterrupted run, K1 once per
     round each invocation ran;
  6. the LM serve path at full width through
     ``python -m repro_torch.launch.serve`` (qwen1.5-0.5b, 24 layers, bf16,
     batch 8, prompt 1,024, 32 decode tokens): K3 must launch 24 times per
     prefill and K3's plain version never; finite logits, tokens in range;
     then the same weights and prompts with K3 forced off: the first
     layer's attention within K3's bf16 tolerance, and the logits' max
     difference and the share of equal greedy tokens through 24 bf16
     layers, held to a drift tolerance; then the same model in float32
     (weights and compute, same draw), where every prefill attention is
     K3's f32 kernel: 24 launches per prefill and no plain attention,
     layer 0's attention on vs off within the f32 tolerance, the logits
     and greedy tokens to the same drift tolerance and share; then a
     2-layer sliding-window run (window 256 < prompt) decoding through the
     ring cache, its tokens held against a full forward over the generated
     sequence;
  7. the Mamba-2 serve path at full width through the same entry point
     (mamba2-1.3b, 48 layers, bf16, batch 8, prompt 1,024, 32 decode
     tokens): K4 must launch 48 times per prefill and K4's plain version,
     K3 and the OTA kernels never; finite logits, tokens in range; then
     the same weights and prompts with K4 forced off: the first layer's
     mixer output within two bf16 ulps; the whole model's logit drift and
     equal greedy tokens are printed as readings, and so is the share of
     greedy tokens of prefill + recurrent decode that one prefill (K4)
     over the prompt and the fed-back tokens reproduces; then the same
     model in float32 (weights and compute, same draw): layer 0 to the
     f32 SSD tolerance, the logits to the drift tolerance, the greedy
     tokens of K4 on vs off and of the state check (which holds K4's final
     state, the conv stash and the plain decode together) to the share of
     equal tokens;
  8. the heterogeneous-wireless path (``repro_torch.scenario_sweep``):
     (a) the theory sweep over all ten registered scenarios x (sca, lcpc,
     zero_bias), the sca designs one batched solve per fading family on
     the card (the three at once, each in a process of its own), each
     row's bias, variance and objective within 1e-6
     relative of the reference's (``experiments/scenario_reference/
     theory_seed0.json``), and the grid's four sca designs within 1e-6 of
     the reference's per-scenario designs; (b) the full-width grid:
     paper_mlp (d = 814,090), the four ``SWEEP_FAMILIES`` x (sca, lcpc,
     zero_bias) x seeds 0-3 = 48 cells, full batch, flat, fused f32 tail,
     100 rounds with an eval every 20 -- K1 once a round, nothing else of
     the OTA tail -- then the same grid at seeds 4-7, and each (scenario,
     scheme)'s curve statistics over seeds 0-7 held by ``curves.gate``
     against the reference's committed grid (``scenario_sweep.GATE_SEEDS``
     says why eight); (c) bitwise:
     the R = 1 grid vs the disk_rayleigh fleet, the grid vs its four
     per-scenario fleets, 10 grid rounds with K1 forced off vs on, and 5
     unfused rounds (K2 once a round) with K2 forced off vs on; K1 alone
     against its plain version at C = 48 with whole cells of s = 0 and
     per-cell noise scales over four decades, bitwise, timed; (d)
     ``adaptive_sca`` on disk_markov at full width, seeds 0-3, 20 rounds
     with an eval every 10: a redesign at each chunk end before the last
     round (the reference's cadence ends chunks after rounds 0, 10 and
     19: two redesigns), each moving the design by more than 1e-3
     relative and differently per seed, and the run's last redesign on
     the card within 1e-6 of the same call on the machine's CPU; (e)
     kill after chunk 1 and resume, bitwise (params, traces, evals,
     fading state), on a disk_markov fleet and on the grid; every wall
     printed beside the card's name and power limit;
  9. the single-run API at full width (paper_mlp, ``sca``): ``run_fl``
     for 30 rounds at minibatch 128 through K1 (once a round, the plain
     version never) and at full batch, each bitwise the K = S = 1
     ``run_fleet`` cell; ``run_fl_legacy`` (numpy minibatch stream, the
     batch copied host -> device every round) at full batch bitwise
     ``run_fl``; ``fig2.benchmark`` (``--bench``) at the reference's
     settings, 7 schemes x 150 rounds, an eval every 15: legacy full
     batch, fleet full batch, fleet minibatch 128 (K1 150 times), its
     ``wall_s`` and ``speedup`` printed;
 10. population mode at full width: (a) ``fig2.make_population
     (1_000_000)``'s cohorts of 50 at ticks 0-4 for seeds 0-1 and their
     gains bitwise the reference's committed ones
     (``experiments/population_reference/population.json``); (b)
     ``fig2.population_benchmark``: ``adaptive_sca``, cohort 50, minibatch
     128, fused f32 tail, 48 rounds, an eval every 16, a cohort (and a
     cohort redesign on the host) every 16 rounds, with stream on and off:
     bitwise in params, traces, cohorts and designs, K1 48 times per run
     and its plain version never, the stream/serial walls and staging
     walls printed; (c) the tick-0 cohort redesign within 1e-6 in gamma of
     the reference's; (d) full participation: the 10-device deployment as
     a population, cohort 10, ``sca``, 6 rounds, bitwise the plain fleet
     through K1; (e) a 200-device Gauss-Markov population (rho 0.95),
     cohort 50, a cohort every 4 rounds, 24 rounds, ``sca``: devices
     re-enter (counted), and a run stopped after 2 chunks and resumed is
     bitwise the uninterrupted one, re-entry table (``pop_last``,
     ``pop_state``) included; K1 at the cohort fleet's C = 1, N = 50,
     bitwise its plain version, timed;
 11. the cifar_conv fleet with run telemetry at full width (d = 268,650,
     N = 10, Dirichlet 0.3 shards padded to the largest, minibatch 32,
     K1 at [7, 10, 268,650]): (a) ``fig2.build_world("cifar_conv")``, its
     seven schemes designed at the task's step sizes, ``sca`` within 1e-6
     of the reference's committed design
     (``experiments/cifar_reference/sca_design.json``); (b) the curves:
     ``curves.run_port`` of cifar_conv, 150 rounds, an eval every 10, K1
     once a round, held by ``curves.gate`` against the reference's curves
     at seeds 0-3, or 0-7 when the gate's false-alarm rate over its 21
     comparisons at four seeds a side (printed) is over 10 %; (c) ``fig2.run
     (task="cifar_conv", telemetry=True)`` -- the path of ``fig2 --task
     cifar_conv --telemetry`` -- for 30 rounds with a checkpoint: params,
     the non-``bv_`` traces and the evals bitwise telemetry off, one
     ``chunk_exec`` per chunk, ``python -m repro_torch.telemetry.report``
     exits 0 and prints every section; (d) kill after chunk 1 and resume
     under telemetry: bitwise the uninterrupted run, one run id, no
     duplicate chunk span; (e) K1 (5 fused rounds) and K2 (5 unfused
     rounds) forced off vs on, bitwise; K1 against its plain version at
     the cifar shape, bitwise, timed beside its byte bound; (f) a short
     ``adaptive_sca`` population run under telemetry, stream on (the
     phase-10 world made Gauss-Markov, two cohorts): ``sca_solve`` events
     tagged with their chunk, ``cohort`` events with each drawn device's
     staleness, ``stage`` and ``stage_wait`` events; (g) the cifar
     round's kernel launches, device time and busy share
     (``profile_round.profile``), telemetry off, two runs of its fleet
     bitwise equal (cuDNN deterministic), and its gradients alone timed
     with deterministic cuDNN and with cuDNN's default algorithms (what the
     determinism costs); its walls on one line;
 12. the three dense GQA archs ported by config (granite-8b, qwen2.5-14b,
     chameleon-34b) through ``python -m repro_torch.launch.serve`` at full
     width and depth in bf16, batch 8, prompt 1,024, 32 decode tokens,
     random weights from seed 0: K3 once per layer per prefill (36, 48,
     48) and its plain version never, finite logits, tokens in range, the
     prefill ms, decode ms per token and peak device memory printed (a
     batch that does not fit the card is halved until one does, and the
     batch run is printed); then K3 on vs off in f32 on each arch's first
     ``DENSE_F32_LAYERS`` layers (f32 chameleon does not fit the card), at
     phase 6's f32 tolerances;
 13. the LM train path (``python -m repro_torch.launch.train``): (a)
     qwen1.5-0.5b at its CLI's defaults (50 steps, seq 128, 4 clients x 1,
     ``sca``, eta 0.02) and mamba2-1.3b for 10 steps, full width in bf16:
     finite losses, qwen's last-10 mean below its first-10 mean, K3 (K4)
     once per layer in the held-out eval and never in training, the plain
     version once per layer in every training forward; (b) one f32 qwen
     step against explicit per-client gradients, their OTA superposition
     plus the same receiver noise, and the SGD step, the params at rtol
     1e-5 / atol 1e-6; (c) the held-out eval through K3 (qwen) and K4
     (mamba2) against the plain versions in f32: the loss within 1e-3
     relative, the logits to phase 6's drift gate; (d) the reference
     example's preset (d_model 512, 8 layers, 200 steps, eta 0.05, seeds
     0-3, the four runs at once, each in a process of its own) held by
     ``repro_torch.lm_curves.gate`` against the reference's
     runs in ``experiments/lm_reference/``, after its false-alarm rate at
     four seeds (printed) is checked to be at most 25 %;
 14. recurrentgemma-9b (module 11's RG-LRU family: 26 RG-LRU layers in
     plain PyTorch, as the reference has no kernel for them, and 12 local
     attention layers through K3 at head_dim 256 over one KV head): (a)
     ``python -m repro_torch.launch.serve`` at full width and depth in
     bf16, batch 8, prompt 1,024, 32 decode tokens, random weights from
     seed 0: K3 12 times per prefill and its plain version, K4 and the OTA
     kernels never, finite logits, tokens in range, the prefill ms, decode
     ms per token and peak device memory; layer 2's attention (the first
     local layer) K3 on vs off within K3's bf16 tolerance, the logits'
     drift a reading; (b) the same draw in f32 at full depth on
     ``RGEMMA_F32_BATCH`` prompts: K3 on vs off at phase 6's f32 gate; (c)
     its greedy tokens of prefill + recurrent decode (the doubling scan's
     final state, the conv stash, the decode step) against one prefill
     over the prompt and the fed-back tokens, to the share of equal
     tokens; (d) its first 6 layers in f32 at batch 2 x 4,096, past the
     window of 2,048: K3 takes the window, the local layers decode 32
     tokens through their 2,048-slot ring caches, held against a full
     windowed forward over the generated sequence;
 15. seamless-m4t-medium (module 11's encoder-decoder: 12 bidirectional
     encoder layers over stub frame embeddings, 12 causal decoder layers
     with cross-attention; K3 36 times a prefill, 24 of them non-causal):
     (a) ``python -m repro_torch.launch.serve`` at full width and depth in
     bf16, batch 8, frames and prompts of 1,024, 32 decode tokens, random
     weights from seed 0: K3 36 times per prefill (24 non-causal) and
     never in decode, its plain version, K4 and the OTA kernels never,
     finite logits, tokens in range, the prefill ms, decode ms per token
     and peak device memory; (b) the same draw in f32 at full depth, K3
     on vs off: the encoder's output within F32_TOL per layer (x 12), the
     first decoder layer (self- and cross-attention) on the same memory
     within F32_TOL, the logits within 1e-4 of their largest and greedy
     tokens equal at >= 0.99; (c) the same gates on a ragged cross case,
     frames 1,000 and a prompt of 100 (long audio, short text); (d) greedy
     tokens of prefill + cached decode (self caches written in place,
     cross caches read) against one teacher-forced pass over the prompt
     and the fed-back tokens, >= 0.97 equal;
 17. mixtral-8x22b (module 11a, MoE: every layer a sliding-window
     attention through K3, window 4,096, H 48 over KH 8, and a top-2 of 8
     experts FFN in plain PyTorch, as the reference has no kernel for
     it): (a) ``launch.serve.run`` at full width on its first 12 layers
     (the memory reckoning, printed first, must leave 8 GB of the card
     free; 56 layers are 281 GB in bf16) in bf16, batch 8,
     prompt 1,024, 32 decode tokens, random weights from seed 0: K3 12
     times per prefill and never in decode, its plain version, K4 and the
     OTA kernels never, finite logits, tokens in range, the prefill ms,
     decode ms per token, peak device memory and each layer's kept and
     dropped assignments (the same in both prefills, none in decode); (b)
     the same draw in f32 on its first 2 layers, K3 on vs off layer by
     layer: layer 0's attention within F32_TOL; every layer's expert
     choices equal away from a near tie (sorted probabilities within
     1e-6; their count printed); the pass without K3 dispatched on the K3
     pass's choices (a flip at a near tie would reach every later
     position of its row through the next layer's attention), so the
     logits are held within 1e-4 of their largest at every position;
     greedy tokens equal at >= 0.99; (c) at a capacity factor
     of E / K (no drops: at the default, one forward drops the fed-back
     tokens first, which a decode step never drops), greedy tokens of
     prefill + cached decode against one forward over the prompt and the
     fed-back tokens, >= 0.97; (d) the same 2 f32 layers at batch 1 x
     8,192, past the window: K3 takes the window, the layers decode 32
     tokens through their 4,096-slot ring caches, held against a full
     windowed forward; (e) one MoE layer
     at full width in f32 with capacity factor 0.5 (tokens dropped), B 1,
     S 1,024, on the card against the same call on the CPU (the CPU's
     experts on the card's routes): slots and drops bitwise, y within
     1e-5 of its largest, aux within 1e-6 relative, the router's choices
     equal away from a near tie; (f) ``launch.train --arch mixtral-8x22b
     --layers 1 --steps 10`` at full width in bf16: finite losses, K3
     only in the held-out eval, and an eval loss equal to its
     cross-entropy plus ``router_aux_weight`` x the aux loss;
 18. deepseek-v3-671b (module 11b: MLA attention, whose prefill runs the
     expanded form through K3's (192, 128) instance at H = KH = 128 and
     whose decode the weight-absorbed form in plain PyTorch against the
     latent cache; 3 dense lead layers, then MoE layers of 256 experts, top
     8, and one shared expert; the MTP head in the loss): (a)
     ``launch.serve.run`` at full width on its first 4 layers (3 dense + 1
     MoE, 15.8B parameters; the memory reckoning, printed first, must leave
     8 GB of the card free) in bf16, batch 8, prompt 1,024, 32 decode
     tokens, random weights from seed 0: K3 4 times per prefill and never
     in decode, its plain version, K4 and the OTA kernels never, finite
     logits, tokens in range, the prefill ms, decode ms per token, peak
     device memory and the MoE layer's kept and dropped assignments (the
     same in both prefills); (b) the same draw in f32 on its first 2
     layers (dense: no routing) at batch 4 x 1,024, K3 on vs off: layer
     0's attention within F32_TOL, the logits within 1e-4 of their
     largest, greedy tokens equal at >= 0.99; (c) on that run, greedy
     tokens of prefill + absorbed decode against one forward over the
     prompt and the fed-back tokens, >= 0.97, and layer 0's absorbed
     decode of token 1,024 against row 1,024 of one expanded prefill,
     within 1e-5 of its largest; (d) one MoE layer in f32 at E 256, K 8,
     one shared expert, D 7,168, but an expert width of 256 (at 2,048 the
     f32 experts are 45 GB on the card and again on the host), capacity
     factor 0.5, B 1, S 1,024, on the card against the CPU: slots and drops
     bitwise, y within 1e-5 of its largest, aux within 1e-6 relative; (e)
     ``launch.train --arch deepseek-v3-671b --layers 2 --steps 10`` at full
     width in bf16 (4 clients x 128 tokens): finite losses, K3 only in the
     held-out eval, 3 times (2 layers and the MTP head's), and an eval
     loss equal to its cross-entropy plus ``mtp_loss_weight`` x the MTP
     head's cross-entropy on the reference's labels;
 19. OTA-FL training at ``train_4k``'s 4,096 tokens (module 11c: the
     blocked form of K3's plain version, ``ref.grouped_attention_blocked``,
     which the train path differentiates past Sq.Sk = 2048^2): (a)
     ``launch.train --seq 4096 --steps 10`` (the sca scheme) for
     qwen1.5-0.5b at full width
     and depth and recurrentgemma-9b at full width on its first
     LONG_RGEMMA_LAYERS layers (one local layer, whose window of 2,048
     bites at 4,096), bf16, 4 clients x 1 x 4,096 (``train_4k``'s global
     batch of 256 cut to 4): the memory reckoning printed beside the
     measured peak, step ms, tokens/s, finite losses lower at the last
     step than at the first, K3 once per attention layer in the held-out
     eval (at S 4,096: 24 launches at Dh 64 causal; 1 at Dh 256 with
     window 2,048) and never in training, the plain attention once per
     attention layer of every training forward; (b) the blocked form
     against the direct form on the card in f32 at B 1, S 4,096 (H = KH =
     16, Dh 64, causal; the same with window 2,048; Dh 256, H 16 over KH
     1, window 2,048): the output within F32_TOL, dq, dk and dv within
     GRAD_RTOL plus GRAD_ATOL_SHARE of their largest of autograd through
     the direct form, both forms' forward + backward time and peak memory,
     the blocked peak lower; (c) qwen1.5-0.5b's held-out eval in f32 on 2
     layers at 4 x 4,096, K3 on vs off (off is the blocked form): the loss
     within LM_EVAL_LOSS_RTOL, the logits within DRIFT_LOGITS_SHARE of
     their largest; (d) phase 13 (b)'s f32 step against the explicit
     per-client aggregation on qwen's first 2 layers at 4 x 4,096 (the
     blocked form's backward and the loss head's chunks in the step), the
     params at rtol 1e-5 / atol 1e-6;
 20. the encoder-decoder's train step at ``train_4k``'s 4,096 tokens
     (module 11e): (a) seamless-m4t-medium at full width and depth (12
     encoder and 12 decoder layers, 877,197,312 parameters), bf16, 4
     clients x 1 x (4,096 frames, 4,097 tokens) (the global batch of 256
     cut to 4), LONG_STEPS steps of ``launch.steps.make_train_step`` on
     (frames, tokens) in ``launch.train``'s world (WirelessConfig(4, seed
     0), eta 0.02, sca; the design made ahead on the host), draws from
     ``DeviceStepDraws(seed + 1)``, tokens from ``tasks.lm.client_batches``,
     frames standard normals from a card generator: the memory reckoning
     (``train_reckoning``, the encoder and the cross-attentions counted)
     beside the peak, step ms, tokens/s, the last loss below the first,
     K3 never in training (the plain attention 36 times a step) and 36
     times in the held-out eval (24 non-causal: 12 encoder, 12 cross; 12
     causal); (c) its trained params through ``checkpoint.save_lm`` and
     ``restore_lm`` onto the card, bitwise; (b) in f32 on the first
     SEAMLESS_F32_LAYERS layers of each side at 4 x 4,096, the eval K3 on
     vs off (the loss within LM_EVAL_LOSS_RTOL, the logits, taken 512
     positions at a time, within DRIFT_LOGITS_SHARE of their largest)
     and one step against the explicit per-client aggregation (the params
     at rtol 1e-5 / atol 1e-6).  Every train run's ``sca`` design
     (phases 13, 17, 18, 19, lm_curves' four seeds, 20) is solved on the
     host's CPU in DESIGN_JOBS spawned processes started at the smoke's
     top, while phases 1-2 keep the card busy; a run refuses a design
     made for another world;
 21. one JSON line ``{"kernels": [...]}`` (K3 bf16 with the bf16 serve
     run's launches, with each dense arch's serve run's, with the qwen
     train run's eval's, with recurrentgemma's and with seamless's, its
     non-causal and causal launches on two rows, and with mixtral's; K3
     f32 with the f32 serve run's, with recurrentgemma's f32 run's, with
     seamless's two and with mixtral's two (its prefill, past the
     window); K3 bf16 and f32 at (192, 128) with deepseek's serve runs;
     K3 bf16 with phase 19's two train runs' evals at S 4,096 and with
     phase 20's (non-causal and causal on two rows), K3 f32 with phase
     20's f32 eval's non-causal launches; K4
     f32 with the mamba2 serve run's and the mamba2 train run's eval's; K1
     f32 four times: the Fig.-2 main path's, the grid's, the cohort
     fleet's and the cifar fleet's), each phase's seconds, then the last
     line ``{"ok": true, "device": {...}}``.

TF32 is off throughout (``repro_torch.device.resolve_device``): the
fleet's reference is full float32.
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_TOL = dict(rtol=2e-5, atol=2e-5)       # as tests/test_kernels.py
BF16_TOL = dict(rtol=6e-2, atol=6e-2)      # bf16 outputs, compared in f32
# K3 in bf16: its scores, softmax and accumulator are f32 like its plain
# version's, so the two bf16 outputs may round one ulp apart (2**-8 of the
# value); 1.6e-2 relative is two ulps, and 1e-2 absolute stays well under
# a typical output at S ~ 1000 (|o| ~ sqrt(e / S) ~ 0.05-0.07 for
# unit-variance q, k, v), so a wrong row fails
ATTN_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
MAIN = (7, 10, 814_090)                    # cells, devices, d of the main path
RAGGED_D = (1, 5000)
ROUNDS, EVERY, BATCH = 30, 10, 128
SHORT = 5                                  # rounds of the other paths
SOURCES = {"ota_round_step": "src/repro_torch/kernels/csrc/ota_kernels.cu",
           "ota_aggregate": "src/repro_torch/kernels/csrc/ota_kernels.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
REPLACES = {"ota_round_step": "src/repro/kernels/round_step.py:53",
            "ota_aggregate": "src/repro/kernels/ota_aggregate.py:41",
            "flash_attention": "src/repro/kernels/flash_attention.py:68",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:69"}
# K3's shapes are repro_torch.profile_attention.SHAPES: the serve path's
# prefill at full width in bf16 ("main") and in f32 ("main_f32"), qwen3's
# heads, window 256, ragged S = 1000
# K4 shapes: (label, B, S, H, P, N, G, dtype, state0, chunk); the first is
# the mamba2 prefill's scan at full width, the last the mamba2 train run's
# held-out eval (4 clients x 128 tokens)
SSD_MAIN = ("main", 8, 1024, 64, 64, 128, 1, "f32", False, 128)
SSD_SHAPES = [SSD_MAIN,
              ("ragged_s1000", 8, 1000, 64, 64, 128, 1, "f32", False, 128),
              ("g2_state0", 8, 1024, 64, 64, 128, 2, "f32", True, 128),
              ("bf16_state0", 8, 1024, 64, 64, 128, 1, "bf16", True, 128),
              ("smoke_p32_n32", 2, 37, 16, 32, 32, 1, "f32", True, 32),
              ("train_eval", 4, 128, 64, 64, 128, 1, "f32", False, 128)]
# K4 sums terms as large as its largest output, in another order and over
# its own tile of 64 rows against the plain version's chunk of 128: f32
# agrees to ~1e-5 of the largest |y|, so y and the state are held at 1e-4
# of their largest magnitude plus 2e-4 relative (the reference's SSD
# tolerance); a bf16 y may then land one ulp apart: 1.6e-2 (two ulps)
SSD_SCALE_TOL = 1e-4
SSD_REL_TOL = {"f32": 2e-4, "bf16": 1.6e-2}
SERVE = dict(arch="qwen1.5-0.5b", batch=8, prompt_len=1024, decode_tokens=32)
SSD_SERVE = dict(arch="mamba2-1.3b", batch=8, prompt_len=1024,
                 decode_tokens=32)
# mamba2 with random weights amplifies a rounding difference through its
# 48 layers: in bf16 a one-ulp change at layer 0 grows to ~20-30 % of the
# largest logit, as far for two plain scans that differ only in their chunk
# length as for K4 against its plain version.  So the bf16 run's whole-model
# drift and token shares are printed readings; its layer-0 mixer is held to
# two bf16 ulps, and DRIFT_LOGITS_SHARE and EQUAL_TOKENS_MIN are held on the
# same model in float32, where a rounding difference stays ~1e-4 of the
# logits
SWA = dict(n_layers=2, window=256)   # over the arch's long-context variant
# full width, K3 on vs off on the same weights: the first layer's attention
# output to the bf16 tolerance; through 24 bf16 layers a one-ulp difference
# may grow, so the logits are held to a drift bound (a share of their
# largest magnitude) and greedy tokens to a share that agrees
DRIFT_LOGITS_SHARE = 0.05
EQUAL_TOKENS_MIN = 0.9
# phase 5: the reference's default sca design is held to 1e-6 relative in
# gamma, alpha and the thresholds and 1e-9 in the (P1) objective (the CPU
# port lands 5e-9 and 2e-16 from it; tests/test_torch_solvers.py); the
# curves at the reference's Fig.-2 protocol, over its seeds 0-3
SCA_RTOL, SCA_OBJECTIVE_RTOL = 1e-6, 1e-9
CURVE_SEEDS, RESUME_ROUNDS = (0, 1, 2, 3), 30
# phase 8: the scenario path.  The theory rows against the reference's at
# 1e-6 relative (the solver lands ~1e-8 from the reference's designs, the
# rows move less); the adaptive fleet's length, cadence and the design move
# it must show (the grid's settings are ``scenario_sweep``'s).  20 rounds
# give two redesigns, each ~30 s of host work
THEORY_RTOL = 1e-6
ADAPTIVE_ROUNDS, ADAPTIVE_EVERY, ADAPTIVE_MOVE = 20, 10, 1e-3
GRID_CELLS = 48                            # 4 scenarios x 3 schemes x 4 seeds


# phase 9: the single-run API and fig2 --bench at the reference's settings
# (150 rounds, an eval every 15; its three runs take ~10-20 s here)
SINGLE_ROUNDS, BENCH_ROUNDS, BENCH_EVERY = 30, 150, 15
# phase 10: the population benchmark at cohort_rounds 16 (its default of 1
# would take 96 cohort redesigns of 4-15 s each: it runs on its own as
# ``python -m repro_torch.fig2 --bench --population 1000000``), the
# full-participation identity's 6 rounds, and the re-entry run
POP_SIZE, POP_COHORT, POP_ROUNDS, POP_EVERY = 1_000_000, 50, 48, 16
POP_COHORT_ROUNDS, FULL_ROUNDS = 16, 6
REENTRY = dict(size=200, rho=0.95, cohort=50, cohort_rounds=4, rounds=24,
               every=8, max_chunks=2)
REDESIGN_RTOL = 1e-6
# phase 11: the cifar_conv fleet with run telemetry.  Its world is
# paper_mlp's deployment with the convnet's d (268,650); K1 reads
# [C, N, D] = [7, 10, 268,650]; its curves run at the reference's cadence
# and the task's minibatch 32.  The gate widens from seeds 0-3 to 0-7 when
# its false-alarm rate at four seeds a side is over CIFAR_FALSE_ALARM_MAX
# (scenario_sweep.gate_false_alarm on the reference's curves)
CIFAR = (7, 10, 268_650)
CIFAR_BATCH, CIFAR_PROTOCOL = 32, "minibatch32"
CIFAR_FALSE_ALARM_MAX = 0.10
TEL_ROUNDS = 30
# the population run under telemetry: the phase-10 world made Gauss-Markov
# (so each cohort event carries the staleness of its devices off the
# re-entry table), adaptive_sca, stream on, two cohorts of 50
POP_TEL = dict(rho=0.95, rounds=8, every=4, cohort_rounds=4)
REPORT_SECTIONS = ("== run ", "== staging-lane timeline", "== SCA solver",
                   "== bias--variance trajectory", "== cohort staleness",
                   "== recompilation audit")
# phase 12: the three dense GQA archs ported by config, served at full width
# and depth in bf16 (halving the batch only if 8 x 1,024 does not fit the
# card: the phase prints the batch it ran); K3 on vs off in f32 on their
# first DENSE_F32_LAYERS layers (f32 chameleon-34b, 137 GB, does not fit)
DENSE_ARCHS = ("granite-8b", "qwen2.5-14b", "chameleon-34b")
DENSE_SERVE = dict(batch=8, prompt_len=1024, decode_tokens=32)
DENSE_F32_LAYERS, DENSE_F32_DECODE = 4, 8
# phase 13: the LM train path.  launch.train at its CLI's defaults (50
# steps, seq 128, 4 clients x 1, sca, eta 0.02) for qwen1.5-0.5b, 10 steps
# for mamba2-1.3b, full width in bf16; one f32 qwen step against the
# explicit per-client aggregation at the CPU parity test's one-step
# tolerance (the params: rtol 1e-5, atol 1e-6); the held-out eval through
# K3 / K4 against the plain versions in f32: the logits to the drift gate,
# the loss to LM_EVAL_LOSS_RTOL
TRAIN_QWEN = ("--arch", "qwen1.5-0.5b")
TRAIN_MAMBA = ("--arch", "mamba2-1.3b", "--steps", "10")
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
LM_EVAL_LOSS_RTOL = 1e-3
# phase 14: recurrentgemma-9b (26 RG-LRU and 12 local-attention layers, K3
# at head_dim 256 over one KV head) served at full width and depth in bf16;
# then in f32 at full depth (41.8 GB of weights) on RGEMMA_F32_BATCH
# prompts: batch 8's f32 logits (8.4 GB) and the softcap's temporaries of
# their size, twice over for K3 on and off, would not fit beside the
# weights; then its first RGEMMA_RING["n_layers"] layers (two local ones)
# in f32 past the window: 2 x 4,096 prompts against the window of 2,048,
# decoding through the 2,048-slot ring cache
RGEMMA_SERVE = dict(arch="recurrentgemma-9b", batch=8, prompt_len=1024,
                    decode_tokens=32)
RGEMMA_F32_BATCH = 4
RGEMMA_RING = dict(n_layers=6, batch=2, prompt_len=4096, decode_tokens=32)
# phase 15: seamless-m4t-medium (12 encoder and 12 decoder layers; K3 36
# times a prefill: 12 encoder self-attentions and 12 cross-attentions
# non-causal, 12 decoder self-attentions causal) served at full width and
# depth in bf16 (frames and prompts of 1,024), then in f32 at full depth:
# K3 on vs off on the encoder's output (F32_TOL per layer, over its 12),
# the first decoder layer (its self- and cross-attention, on the same
# memory: F32_TOL), the logits within SEAMLESS_DRIFT of their largest and
# the greedy tokens equal at >= SEAMLESS_TOKENS_MIN; the same gates on a
# ragged cross case (frames 1,000, a prompt of 100: long audio, short
# text); prefill + cached decode against one teacher-forced pass over the
# prompt and the fed-back tokens, to SEAMLESS_STATE_TOKENS_MIN
SEAMLESS_SERVE = dict(arch="seamless-m4t-medium", batch=8, prompt_len=1024,
                      decode_tokens=32)
SEAMLESS_LAYERS = (12, 12)                 # encoder, decoder
SEAMLESS_RAGGED = dict(batch=8, frames=1000, prompt_len=100)
SEAMLESS_DRIFT, SEAMLESS_TOKENS_MIN = 1e-4, 0.99
SEAMLESS_STATE_TOKENS_MIN = 0.97
# phase 17: mixtral-8x22b (56 sliding-window MoE layers: 140.6B parameters,
# 281 GB in bf16) served at full width on its first MIXTRAL_LAYERS layers
# (61 GB of weights; the memory reckoning must leave MIXTRAL_FREE_MIN_GB of
# the card free); then its first MIXTRAL_F32_LAYERS layers in f32 (21.6
# GB): K3 on vs off (layer 0's attention within F32_TOL; expert choices
# equal but for near ties within MIXTRAL_TIE; the pass without K3 on the K3
# pass's choices, the logits within MIXTRAL_DRIFT of their largest at every
# position; greedy tokens equal at >= MIXTRAL_TOKENS_MIN); at a capacity
# factor of E / K (no drops), prefill + cached decode against one forward
# (>= MIXTRAL_STATE_TOKENS_MIN) and a run past the window (1 x 8,192 over
# 4,096) through the ring caches; one MoE layer at full width in f32 with
# capacity factor 0.5 on the card against the CPU (y within
# MIXTRAL_Y_SHARE of its largest, aux within MIXTRAL_AUX_RTOL); launch.train
# at 1 layer (bf16 params, f32 noise draws and two gradient trees; the
# train run's time is mostly the CPU draw of its weights, ~10 s a billion,
# and one layer holds the same checks as two)
MIXTRAL_SERVE = dict(arch="mixtral-8x22b", batch=8, prompt_len=1024,
                     decode_tokens=32)
MIXTRAL_LAYERS, MIXTRAL_FREE_MIN_GB = 12, 8.0
MIXTRAL_F32_LAYERS, MIXTRAL_TIE = 2, 1e-6
MIXTRAL_DRIFT, MIXTRAL_TOKENS_MIN = 1e-4, 0.99
MIXTRAL_STATE_TOKENS_MIN = 0.97
MIXTRAL_RING = dict(batch=1, prompt_len=8192, decode_tokens=32)
MIXTRAL_DROP = dict(capacity_factor=0.5, batch=1, seq=1024)
MIXTRAL_Y_SHARE, MIXTRAL_AUX_RTOL = 1e-5, 1e-6
TRAIN_MIXTRAL = ("--arch", "mixtral-8x22b", "--layers", "1", "--steps", "10")
# phase 18: deepseek-v3-671b (61 layers: 3 dense, then MoE of 256 experts
# top 8 and one shared, MLA attention, an MTP module; ~671.7B parameters)
# served at full width on its first DEEPSEEK_LAYERS layers (3 dense + 1 MoE,
# 15.8B, 31.6 GB in bf16; the memory reckoning must leave
# DEEPSEEK_FREE_MIN_GB of the card free); then its first
# DEEPSEEK_F32["n_layers"] layers in f32 (dense, 14.8 GB), K3 on vs off
# (layer 0's attention within F32_TOL, the logits within DEEPSEEK_DRIFT of
# their largest, greedy tokens equal at >= DEEPSEEK_TOKENS_MIN), prefill +
# absorbed decode against one forward (>= DEEPSEEK_STATE_TOKENS_MIN; no
# routing at this depth, so no capacity factor is needed) and one layer's
# absorbed decode against the expanded form (DEEPSEEK_FORMS_SHARE of its
# largest); one MoE layer in f32 at full E, K, D and S but an expert width
# of DEEPSEEK_DROP["moe_d_ff"] (at 2,048 the f32 experts would be 45 GB on
# the card and again on the host), card vs CPU; launch.train at 2 layers
# with the MTP term (bf16 params, f32 noise draws, two gradient trees)
DEEPSEEK_SERVE = dict(arch="deepseek-v3-671b", batch=8, prompt_len=1024,
                      decode_tokens=32)
DEEPSEEK_LAYERS, DEEPSEEK_FREE_MIN_GB = 4, 8.0
DEEPSEEK_F32 = dict(n_layers=2, batch=4)
DEEPSEEK_DRIFT, DEEPSEEK_TOKENS_MIN = 1e-4, 0.99
DEEPSEEK_STATE_TOKENS_MIN, DEEPSEEK_FORMS_SHARE = 0.97, 1e-5
DEEPSEEK_DROP = dict(capacity_factor=0.5, batch=1, seq=1024, moe_d_ff=256)
DEEPSEEK_Y_SHARE, DEEPSEEK_AUX_RTOL = 1e-5, 1e-6
TRAIN_DEEPSEEK = ("--arch", "deepseek-v3-671b", "--layers", "2", "--steps",
                  "10")
# phase 19: training at train_4k's 4,096 tokens.  qwen1.5-0.5b at full
# depth; recurrentgemma-9b on its first LONG_RGEMMA_LAYERS layers (rglru,
# rglru, local: 2.75B parameters); 4 clients x 1 x 4,096 tokens; the blocked
# form against the direct form on the card in f32 at B 1, S 4,096 ((label,
# H, KH, Dh, window)), its gradients to the train tests' tolerance; qwen's
# eval in f32 on LONG_EVAL_LAYERS layers, K3 on vs off; the f32 train step
# on LONG_EVAL_LAYERS layers at 4 x 4,096 against the explicit aggregation.
# The two runs take launch.train's default scheme, sca
LONG_STEPS, LONG_RGEMMA_LAYERS, LONG_EVAL_LAYERS = 10, 3, 2
LONG_FORMS = [("h16_dh64_causal", 16, 16, 64, None),
              ("h16_dh64_window2048", 16, 16, 64, 2048),
              ("h16_kh1_dh256_window2048", 16, 1, 256, 2048)]
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-5
# phase 20: the encoder-decoder's train step at train_4k's 4,096 tokens.
# seamless-m4t-medium at full width and depth (SEAMLESS_LAYERS;
# SEAMLESS_TRAIN_PARAMS parameters), bf16, 4 clients x 1 x (4,096 frames,
# 4,097 tokens), LONG_STEPS steps at launch.train's eta through sca; its f32
# checks on the first SEAMLESS_F32_LAYERS layers of each side
SEAMLESS_TRAIN_PARAMS, SEAMLESS_TRAIN_ETA, SEAMLESS_F32_LAYERS = \
    877_197_312, 0.02, 2
# the train runs' designs, made ahead in spawned host processes on the CPU
# (DESIGN_JOBS at once) while phases 1-2 run: (label, run() keywords) for
# launch.train's runs, then lm_curves' seeds and phase 20's world
DESIGN_JOBS = 5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def sass_ops(build, name, ops=("HGMMA", "HMMA")):
    """{kernel symbol: {op: n}} for the built library of ``csrc/<name>.cu``,
    read from its SASS (cuobjdump -sass); the defaults are the tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync)."""
    exe = Path(build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, ops)) + r")\b")
    found, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            found[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            op = pattern.search(line)
            if op:
                found[fn][op.group(1)] += 1
    return found


def ota_timing(kern, plain, byts, flops, bw, f32_peak):
    """Times, bound and achieved rate of a K1/K2 call at the main shape."""
    from repro_torch.card import median_ms
    ms = median_ms(kern)
    bound = 1e3 * max(byts / bw, flops / f32_peak)
    return {"ms": ms, "plain_ms": median_ms(plain), "bound_ms": bound,
            "bytes": byts, "gb_per_s": byts / ms / 1e6,
            "bound_share": bound / ms,
            "bound_by": "bytes" if byts / bw >= flops / f32_peak
            else "operations"}


def phase_kernels(torch, dev, card):
    """Phase 2: K1 and K2 against their plain versions on the card."""
    from repro_torch.card import peaks
    from repro_torch.kernels import ota_aggregate, round_step
    from repro_torch.profile_ota import draw, ota_cases
    _, (bw, f32_peak, _) = peaks(card)
    wrappers = {"ota_round_step": ("K1", round_step.ota_round_step),
                "ota_aggregate": ("K2", ota_aggregate.ota_aggregate)}
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for (c, n, d) in [MAIN] + [(3, 10, dd) for dd in RAGGED_D]:
        for name, wire, args, plain, byts, flops in ota_cases(
                *draw((c, n, d), dev, gen)):
            k, fn = wrappers[name]

            def kern(fn=fn, args=args):
                return fn(*args)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            tol = BF16_TOL if got.dtype == torch.bfloat16 else F32_TOL
            bitwise = bool(torch.equal(got, want))
            got, want = got.float(), want.float()
            err = (got - want).abs()
            ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
            row = {"max_abs_err": float(err.max()), "tol": tol, "ok": ok,
                   "bitwise": bitwise}
            if (c, n, d) == MAIN:
                row.update(ota_timing(kern, plain, byts, flops, bw, f32_peak))
            results[(name, wire, d)] = row
            print(f"  {k} {name:<14} {wire:>4} C={c} N={n} D={d}: "
                  + json.dumps(row), flush=True)
            check(ok, f"{k} {wire} D={d} disagrees with its plain version")
            check(bitwise, f"{k} {wire} D={d} is not bitwise equal to its "
                  "plain version")
    return results


def counts():
    from repro_torch.kernels import ota_aggregate, ref, round_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"ota_round_step": round_step.ota_round_step.launches,
            "ota_aggregate": ota_aggregate.ota_aggregate.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_noncausal": flash_attention.noncausal_launches,
            "ssd_scan": ssd_scan.launches,
            "plain_round_step": ref.ota_round_step_ref.calls,
            "plain_aggregate": ref.ota_aggregate_ref.calls,
            "plain_attention": ref.attention_ref.calls,
            "plain_ssd": ref.ssd_chunked.calls}


def zero_counts():
    from repro_torch.kernels import ota_aggregate, ref, round_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    round_step.ota_round_step.launches = 0
    ota_aggregate.ota_aggregate.launches = 0
    flash_attention.launches = 0
    flash_attention.noncausal_launches = 0
    ssd_scan.launches = 0
    ref.ota_round_step_ref.calls = 0
    ref.ota_aggregate_ref.calls = 0
    ref.attention_ref.calls = 0
    ref.ssd_chunked.calls = 0


def phase_attention_kernel(torch, dev, card):
    """Phase 2, K3: flash attention against its plain version on the card,
    with scaled_dot_product_attention timed beside it."""
    from repro_torch.card import median_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.profile_attention import (SHAPES, bound, draw, sdpa,
                                               sdpa_backend)
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for shape in SHAPES:
        label, causal, window = shape.label, shape.causal, shape.window
        tol = ATTN_BF16_TOL if shape.dtype == "bf16" else F32_TOL
        q, k, v = draw(shape, dev, gen)

        def kern():
            return flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return ref.attention_ref(q, k, v, causal=causal, window=window)
        got, want = kern().float(), plain().float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
        library = sdpa(q, k, v, window, causal)
        backend, lib_error = sdpa_backend(library)
        row = {"shape": [shape.b, shape.s, shape.keys, shape.h, shape.kh,
                         shape.dh, shape.v_width], "dtype": shape.dtype,
               "window": window, "causal": causal,
               "max_abs_err": float(err.max()), "tol": tol, "ok": ok,
               "ms": median_ms(kern),
               "plain_ms": median_ms(plain),
               "library_ms": median_ms(library) if backend else None,
               "library_max_abs_err": float(
                   (library().float() - want).abs().max()) if backend
               else None,
               "library_backend": backend, "library_error": lib_error,
               **bound(shape, card)}
        results[label] = row
        print(f"  K3 flash_attention {label}: " + json.dumps(row), flush=True)
        check(ok, f"K3 {label} disagrees with its plain version")
        del q, k, v, got, want
    return results


def ssd_flops(b, s, h, p, n, g, state0):
    """Fewest operations of the SSD scan on these inputs: the chunked form
    at the tile length q that minimises them (the form is exact for any q;
    K4 walks tiles of 64).  Per tile: C B^T once per group and att (dt x)
    per head over the causal triangle, C S_in (none on the first tile
    without a state in), the state's decay and its update B^T (dt x)."""
    def at(q):
        full, r = divmod(s, q)
        pairs = full * q * (q + 1) // 2 + r * (r + 1) // 2
        carried = 0 if state0 else 1          # the first tile's state is 0
        return (2 * b * pairs * (g * n + h * p)
                + 2 * b * h * n * p * (2 * s - carried * min(q, s))
                + b * h * n * p * (full + (r > 0) - carried))
    return min(at(q) for q in range(1, s + 1))


def phase_ssd_kernel(torch, dev, card):
    """Phase 2, K4: the SSD scan against its plain version on the card."""
    import torch.nn.functional as F
    from repro_torch.card import median_ms, peaks
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    _, (bw, f32_peak, bf16_peak) = peaks(card)
    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}
    for label, b, s, h, p, n, g, dt_name, state, chunk in SSD_SHAPES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(b, s, h, p).to(dtype)
        dt = F.softplus(randn(b, s, h)).to(dtype)
        a_neg = -torch.exp(0.5 * randn(h))
        bm, cm = ((0.5 * randn(b, s, g, n)).to(dtype) for _ in range(2))
        s0 = randn(b, h, p, n) if state else None

        def kern():
            return ssd_scan(x, dt, a_neg, bm, cm, chunk=chunk, state0=s0)

        def plain():
            return ref.ssd_chunked(x, dt, a_neg, bm, cm, chunk, state0=s0)
        (y, st), (want_y, want_st) = kern(), plain()
        torch.cuda.synchronize()
        ok, errs = True, {}
        for name, got, want, rel in (("y", y, want_y, SSD_REL_TOL[dt_name]),
                                     ("state", st, want_st,
                                      SSD_REL_TOL["f32"])):
            got, want = got.float(), want.float()
            err = (got - want).abs()
            scale = float(want.abs().max())
            ok &= bool((err <= SSD_SCALE_TOL * scale
                        + rel * want.abs()).all())
            errs[name] = (float(err.max()), scale)
        byts = nbytes(x, dt, a_neg, bm, cm, s0, y, st)
        flops = ssd_flops(b, s, h, p, n, g, state)
        # the products may run in f32 on the FMA units or as three TF32
        # products on the tensor cores, whichever takes less time
        ops_s = min((flops / f32_peak, "f32 FMA"),
                    (3 * flops / (bf16_peak / 2), "3xTF32 tensor cores"))
        row = {"shape": [b, s, h, p, n, g], "dtype": dt_name,
               "state0": state, "chunk": chunk,
               "max_abs_err": errs["y"][0], "max_abs_y": errs["y"][1],
               "state_max_abs_err": errs["state"][0],
               "max_abs_state": errs["state"][1],
               "tol": {"scale": SSD_SCALE_TOL, "rtol": SSD_REL_TOL[dt_name]},
               "ok": ok, "ms": median_ms(kern),
               "plain_ms": median_ms(plain), "library_ms": None,
               "bound_ms": 1e3 * max(byts / bw, ops_s[0]),
               "bytes": byts, "flops": flops,
               "bound_by": "bytes" if byts / bw >= ops_s[0]
               else "operations", "operations_on": ops_s[1],
               "f32_fma_bound_ms": 1e3 * max(byts / bw, flops / f32_peak)}
        results[label] = row
        print(f"  K4 ssd_scan {label}: " + json.dumps(row), flush=True)
        check(ok, f"K4 {label} disagrees with its plain version")
        del x, dt, bm, cm, s0, y, st, want_y, want_st
    return results


def check_result(torch, np, res, rounds, label):
    k = len(res.names)
    for name, v in res.params.items():
        check(v.shape[:2] == (k, 1), f"{label}: params {name} {v.shape}")
        check(bool(torch.isfinite(v).all()), f"{label}: params {name} not finite")
    for name, v in res.traces.items():
        check(v.shape == (k, 1, rounds), f"{label}: trace {name} {v.shape}")
        check(bool(np.isfinite(v).all()), f"{label}: trace {name} not finite")


def round_ms(res):
    """Host wall per round (device-synchronized chunk ends), first chunk
    excluded (it holds the first launches)."""
    later = res.chunk_walls[1:] or res.chunk_walls
    return 1e3 * sum(sec for _, sec in later) / sum(r for r, _ in later)


def design_world(torch, dev):
    """paper_mlp's Fig.-2 world (data seed 0; the designs do not depend on
    it) and its seven schemes, designed once for phases 3-5.  ``sca`` is
    the ported solver's design on the card, timed; the SLSQP design it
    replaced as the default (``method="scipy"``, on the host) is timed
    beside it, and only timed."""
    from repro_torch import fig2, tasks
    from repro_torch.core import power_control as pcm
    task = tasks.get("paper_mlp", expect_runtime="fleet")
    dep, prm, td = fig2.build_world(task, 0)
    torch.cuda.synchronize()
    t0 = time.time()
    sca = fig2.make_schemes(task, dep, prm, ["sca"], device=dev)[0]
    torch.cuda.synchronize()
    walls = {"torch_card": time.time() - t0}
    t0 = time.time()
    pcm.make_sca(dep, prm.replace(eta=task.eta_for("sca", float(prm.eta))),
                 method="scipy")
    walls["scipy_host"] = time.time() - t0
    rest = [n for n in fig2.SCHEMES if n != "sca"]
    others = dict(zip(rest, fig2.make_schemes(task, dep, prm, rest,
                                              device=dev)))
    schemes = [sca if n == "sca" else others[n] for n in fig2.SCHEMES]
    print(f"  schemes designed once for phases 3-5: sca (torch f64 solver, "
          f"card) {walls['torch_card']:.3f} s; the SLSQP design (host) "
          f"{walls['scipy_host']:.3f} s", flush=True)
    return {"task": task, "dep": dep, "prm": prm, "td": td,
            "schemes": schemes, "design_s": walls}


def phase_main_path(torch, np, dev, world):
    """Phase 3: the port's main path at full width, then its other paths."""
    from repro_torch import fig2
    from repro_torch.fl.driver import run_fleet_task
    zero_counts()
    hist, res = fig2.run(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                         batch_size=BATCH, uplink_dtype="f32",
                         designs=world["schemes"], device=dev)
    torch.cuda.synchronize()
    main = counts()
    print(f"  main path (fused, f32 uplink): counts {main}", flush=True)
    check(main["ota_round_step"] == ROUNDS,
          f"K1 launched {main['ota_round_step']} times in {ROUNDS} rounds")
    check(main["ota_aggregate"] == 0, "K2 launched on the fused path")
    check(main["plain_round_step"] == 0 and main["plain_aggregate"] == 0,
          "a plain kernel version ran on the CUDA path")
    check_result(torch, np, res, ROUNDS, "main path")
    for name, h in hist.items():
        check(len(h) == len(res.evals) == 4, f"{name}: {len(h)} evals")
        print(f"  {name:>17}: acc " + " ".join(f"{r['acc']:.4f}" for r in h)
              + "  global_loss " + " ".join(f"{r['global_loss']:.4f}"
                                            for r in h), flush=True)
        check(all(0.0 <= r["acc"] <= 1.0 for r in h), f"{name}: acc range")
    ideal = hist["ideal"]
    check(ideal[-1]["global_loss"] < ideal[0]["global_loss"]
          and ideal[-1]["acc"] > ideal[0]["acc"],
          "ideal FedAvg did not learn over the main path's rounds")
    walls = {"fused_f32": round_ms(res)}
    print(f"  round wall {walls['fused_f32']:.3f} ms (host clock, chunk ends "
          f"synchronized; first chunk excluded); run wall {res.wall:.2f} s",
          flush=True)

    task, dep, td, schemes = (world[k] for k in ("task", "dep", "td",
                                                 "schemes"))
    paths = {}
    for label, kw, kernel in (
            ("unfused_f32", {"fuse_round": False}, "ota_aggregate"),
            ("fused_bf16", {"uplink_dtype": "bf16"}, "ota_round_step"),
            ("fused_int8", {"uplink_dtype": "int8"}, "ota_round_step")):
        run = task.run_config(num_rounds=SHORT, eval_every=SHORT, seed=0,
                              batch_size=BATCH)
        zero_counts()
        r = run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                           flat=True, device=dev, **kw)
        torch.cuda.synchronize()
        cnt = counts()
        print(f"  {label}: {SHORT} rounds, counts {cnt}, round wall "
              f"{round_ms(r):.3f} ms", flush=True)
        check(cnt[kernel] == SHORT, f"{label}: {kernel} launched "
              f"{cnt[kernel]} times in {SHORT} rounds")
        other = "ota_round_step" if kernel == "ota_aggregate" \
            else "ota_aggregate"
        check(cnt[other] == 0, f"{label}: {other} launched")
        check(cnt["plain_round_step"] == 0 and cnt["plain_aggregate"] == 0,
              f"{label}: a plain kernel version ran on the CUDA path")
        check_result(torch, np, r, SHORT, label)
        paths[label] = cnt
        walls[label] = round_ms(r)
    return main, paths, walls


def phase_kernels_vs_plain_path(torch, dev, world):
    """Phase 4: same draws, kernels on vs forced off, 3 rounds."""
    from repro_torch.fl.driver import run_fleet_task
    task, dep, td, schemes = (world[k] for k in ("task", "dep", "td",
                                                 "schemes"))
    worst = {}
    for label, kw in (("fused", {}), ("unfused", {"fuse_round": False})):
        run = task.run_config(num_rounds=3, eval_every=3, seed=0,
                              batch_size=BATCH)
        on = run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                            flat=True, device=dev, **kw)
        off = run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                             flat=True, device=dev, use_kernel=False, **kw)
        err = 0.0
        for name in on.params:
            a, b = on.params[name], off.params[name]
            check(bool((torch.abs(a - b) <= F32_TOL["atol"]
                        + F32_TOL["rtol"] * torch.abs(b)).all()),
                  f"{label}: params {name} differ, kernels on vs off")
            err = max(err, float(torch.abs(a - b).max()))
        worst[label] = err
        print(f"  {label}: 3 rounds, kernels on vs off, max |dparams| "
              f"{err:.3e} (tol {F32_TOL})", flush=True)
    return worst


def phase_curves(torch, np, dev, world):
    """Phase 5: the sca design against the reference's, the curves' gate in
    both protocols, and kill and resume, all at full width."""
    import tempfile
    from repro_torch import curves, fig2
    from repro_torch.core import theory
    from repro_torch.fl.driver import run_fleet_task

    with open(ROOT / "experiments" / "fig2_reference" / "sca_design.json") as f:
        want = json.load(f)
    task, dep, prm, td, designs = (world[k] for k in ("task", "dep", "prm",
                                                      "td", "schemes"))
    check(task.param_dim == int(want["d"]) == MAIN[2],
          f"paper_mlp d {task.param_dim} vs the design's {want['d']}")
    prm_sca = prm.replace(eta=task.eta_for("sca", float(prm.eta)))
    check(prm_sca.eta == float(want["eta"]), "sca's eta differs")
    sca = designs[fig2.SCHEMES.index("sca")]
    design_s = world["design_s"]
    errs = {"gamma": _rel(np, sca.gamma, want["gamma"]),
            "alpha": _rel(np, sca.alpha, want["alpha"]),
            "thresholds": _rel(np, sca.thresholds, want["thresholds"]),
            "objective": _rel(np, theory.p1_objective(sca.gamma, prm_sca),
                              want["objective"])}
    print(f"  sca design on the card (repro_torch.solvers, f64): wall "
          f"{design_s['torch_card']:.3f} s (SLSQP on the host "
          f"{design_s['scipy_host']:.3f} s); relative error against the reference's "
          f"default design {json.dumps(errs)} (tol {SCA_RTOL}, objective "
          f"{SCA_OBJECTIVE_RTOL})", flush=True)
    for name in ("gamma", "alpha", "thresholds"):
        check(errs[name] <= SCA_RTOL, f"sca {name} off the reference's by "
              f"{errs[name]:.3e}")
    check(errs["objective"] <= SCA_OBJECTIVE_RTOL, "sca objective off the "
          f"reference's by {errs['objective']:.3e}")

    report, walls = {}, {}
    for protocol, batch in curves.PROTOCOLS.items():
        runs = []

        def after(seed, res, protocol=protocol, runs=runs):
            torch.cuda.synchronize()
            runs.append((seed, counts(), round_ms(res), res.wall))
            zero_counts()
            check_result(torch, np, res, curves.ROUNDS,
                         f"{protocol} seed {seed}")
        zero_counts()
        port = curves.run_port(protocol, CURVE_SEEDS, dev, designs,
                               after_run=after)
        for seed, cnt, ms, wall in runs:
            print(f"  {protocol} seed {seed}: {curves.ROUNDS} rounds, round "
                  f"wall {ms:.3f} ms, run wall {wall:.2f} s, counts {cnt}",
                  flush=True)
            ota = {k: cnt[k] for k in ("ota_round_step", "ota_aggregate",
                                       "plain_round_step", "plain_aggregate")}
            if batch:
                check(ota == {"ota_round_step": curves.ROUNDS,
                              "ota_aggregate": 0, "plain_round_step": 0,
                              "plain_aggregate": 0},
                      f"{protocol} seed {seed}: K1 must launch once a round "
                      f"and nothing else of the OTA tail run: {ota}")
            else:
                check(not any(ota.values()),
                      f"{protocol} seed {seed}: the per-leaf tail ran an "
                      f"OTA kernel or its plain version: {ota}")
        if not batch:
            print(f"  {protocol}: no OTA kernel launched, by design (the "
                  "paper's protocol aggregates leaf by leaf)", flush=True)
        walls[protocol] = [ms for _, _, ms, _ in runs]
        rows = curves.gate(port, curves.load_reference(protocol,
                                                       CURVE_SEEDS))
        print(curves.table(rows, f"  {protocol}: port (this card) vs "
                           f"reference (CPU), seeds {list(CURVE_SEEDS)}, "
                           f"{curves.ROUNDS} rounds"), flush=True)
        report[protocol] = rows
    fails = [f"{p}/{r['scheme']}/{r['stat']}" for p, rows in report.items()
             for r in rows if not r["ok"]]
    check(not fails, f"curves outside the gate: {fails}")

    run = task.run_config(num_rounds=RESUME_ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=BATCH)
    kw = dict(task_data=td, flat=True, device=dev)
    launched = {}
    zero_counts()
    whole = run_fleet_task(task, designs, dep.gains, run, **kw)
    torch.cuda.synchronize()
    launched["whole"] = counts()["ota_round_step"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "fleet")
        zero_counts()
        first = run_fleet_task(task, designs, dep.gains, run,
                               checkpoint_path=path, max_chunks=1, **kw)
        torch.cuda.synchronize()
        launched["first"] = counts()["ota_round_step"]
        zero_counts()
        rest = run_fleet_task(task, designs, dep.gains, run,
                              checkpoint_path=path, resume=True, **kw)
        torch.cuda.synchronize()
        launched["resumed"] = counts()["ota_round_step"]
    executed = {"whole": RESUME_ROUNDS,
                "first": sum(n for n, _ in first.chunk_walls),
                "resumed": sum(n for n, _ in rest.chunk_walls)}
    check(executed["first"] + executed["resumed"] == RESUME_ROUNDS
          and executed["first"] < RESUME_ROUNDS, f"rounds run {executed}")
    check(launched == executed, f"K1 launches {launched} vs rounds run "
          f"{executed}")
    bitwise = {"params": all(torch.equal(whole.params[k], rest.params[k])
                             for k in whole.params),
               "traces": set(whole.traces) == set(rest.traces) and all(
                   np.array_equal(whole.traces[k], rest.traces[k])
                   for k in whole.traces),
               "evals": [t for t, _ in whole.evals]
               == [t for t, _ in rest.evals] and all(
                   np.array_equal(a[k], b[k])
                   for (_, a), (_, b) in zip(whole.evals, rest.evals)
                   for k in a)}
    print(f"  kill and resume: {RESUME_ROUNDS} rounds, stopped after chunk 1 "
          f"and resumed; rounds run {executed}, K1 launches {launched}; "
          f"bitwise equal to the uninterrupted run {json.dumps(bitwise)}",
          flush=True)
    check(all(bitwise.values()), f"resumed run differs: {bitwise}")
    return {"design_s": design_s, "design_err": errs, "round_ms": walls,
            "gate": {p: all(r["ok"] for r in rows)
                     for p, rows in report.items()}}


def _rel(np, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def k1_value_patterns(torch, dev, card):
    """K1 against its plain version at the grid's C = 48 cells with the
    values the scenarios bring: whole cells of s = 0 (every device
    dropped), dropped devices inside cells, and per-cell noise scales
    spread over four decades; bitwise, with times."""
    def patterns(s, ns, gen):
        s[::4] = 0.0                               # whole cells dropped
        s[1::4, ::3] = 0.0                         # dropped devices
        ns = 10.0 ** (4.0 * torch.rand((s.shape[0],), generator=gen,
                                       device=s.device) - 3.0)
        return s, ns
    return k1_row(torch, dev, card, (GRID_CELLS, MAIN[1], MAIN[2]),
                  "the grid's (whole cells of s = 0, per-cell noise "
                  "scales 1e-3..10)", 8, patterns)


def k1_row(torch, dev, card, shape, label, seed, patterns=None):
    """K1 against its plain version at ``shape`` (C, N, D), bitwise, with
    times, its bound and the achieved rate.  ``patterns(s, ns, gen)``,
    where given, edits the drawn values first and returns (s, ns)."""
    from repro_torch.card import peaks
    from repro_torch.kernels import ref, round_step
    from repro_torch.profile_ota import draw
    _, (bw, f32_peak, _) = peaks(card)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, n, d = shape
    g, s, z, ns, p, eta = draw((c, n, d), dev, gen)
    if patterns is not None:
        s, ns = patterns(s, ns, gen)
    args = (g, torch.ones_like(s), s, z, ns, p, eta)

    def kern():
        return round_step.ota_round_step(*args)

    def plain():
        return ref.ota_round_step_ref(g, s, z, ns, p, eta, None)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    row = {"max_abs_err": float((got - want).abs().max()),
           "bitwise": bool(torch.equal(got, want)),
           **ota_timing(kern, plain, nbytes(*args) + c * d * 4,
                        c * d * (3 * n + 4), bw, f32_peak)}
    print(f"  K1 f32 at {label} C={c}, N={n}, D={d}: {json.dumps(row)}",
          flush=True)
    check(row["bitwise"], f"K1 is not bitwise its plain version at {label}")
    return row


def phase_single_run(torch, np, dev, world, card_line):
    """Phase 9: ``run_fl`` (K = S = 1) through K1 against the one-cell
    fleet, the legacy host loop at full batch against ``run_fl``, and
    ``fig2.benchmark`` at the reference's settings."""
    from repro_torch import fig2, validate_bench
    from repro_torch.fl.driver import run_fleet
    from repro_torch.fl.server import run_fl, run_fl_legacy
    task, dep, td, designs = (world[k] for k in ("task", "dep", "td",
                                                 "schemes"))
    sca = designs[fig2.SCHEMES.index("sca")]
    p0, ev = task.init_params(0, dev), task.make_eval(td, dev)
    walls, out = {}, {}
    for label, batch, flat in (("minibatch", BATCH, True),
                               ("full_batch", 0, False)):
        run = task.run_config(eta=task.eta_for("sca", 0.05),
                              num_rounds=SINGLE_ROUNDS, eval_every=EVERY,
                              seed=0, batch_size=batch)
        zero_counts()
        params, hist = run_fl(task.loss_fn, p0, sca, dep.gains, td.train,
                              run, ev, flat=flat, device=dev)
        torch.cuda.synchronize()
        cnt = _ota_counts()
        res = run_fleet(task.loss_fn, p0, [sca], dep.gains, td.train, run,
                        ev, flat=flat, seeds=(0,), device=dev)
        same = all(torch.equal(params[k], res.params[k][0, 0])
                   for k in params) and all(
            np.array_equal(hist.traces[k], v[0, 0])
            for k, v in res.traces.items())
        print(f"  run_fl sca, {label}, {SINGLE_ROUNDS} rounds: counts {cnt}; "
              f"bitwise the K = S = 1 run_fleet cell: {same}; final acc "
              f"{hist[-1]['acc']:.4f}", flush=True)
        check(same, f"run_fl ({label}) differs from its one-cell fleet")
        want = {"ota_round_step": SINGLE_ROUNDS if flat else 0,
                "ota_aggregate": 0, "plain_round_step": 0,
                "plain_aggregate": 0}
        check(cnt == want, f"run_fl ({label}) counts {cnt}, want {want}")
        out[label] = (params, hist, run, cnt)
    params, hist, run, _ = out["full_batch"]
    torch.cuda.synchronize()
    t0 = time.time()
    lparams, lhist = run_fl_legacy(task.loss_fn, p0, sca, dep.gains,
                                   td.train, run, ev, device=dev)
    torch.cuda.synchronize()
    walls["legacy_full_batch_s"] = time.time() - t0
    same = all(torch.equal(params[k], lparams[k]) for k in params) and all(
        a[k] == b[k] for a, b in zip(hist, lhist)
        for k in ("acc", "global_loss", "round", "active")) \
        and len(hist) == len(lhist)
    print(f"  run_fl_legacy sca, full batch, {SINGLE_ROUNDS} rounds (the "
          f"batch copied host -> device every round): bitwise run_fl: "
          f"{same}, {walls['legacy_full_batch_s']:.3f} s", flush=True)
    check(same, "run_fl_legacy at full batch differs from run_fl")

    zero_counts()
    t0 = time.time()
    rep = fig2.benchmark(num_rounds=BENCH_ROUNDS, eval_every=BENCH_EVERY,
                         seed=0, batch_size=BATCH, task=task, log=False,
                         designs=designs, device=dev)
    torch.cuda.synchronize()
    cnt = _ota_counts()
    walls["bench_s"] = time.time() - t0
    print(f"  fig2 --bench, {len(fig2.SCHEMES)} schemes x {BENCH_ROUNDS} "
          f"rounds, an eval every {BENCH_EVERY}: wall_s "
          f"{json.dumps(rep['wall_s'])}; speedup "
          f"{json.dumps(rep['speedup'])}; legacy vs fleet at full batch, "
          f"max |delta| {json.dumps(rep['equivalence']['max_abs_delta'])} "
          f"(read: the fleet's 7-cell GEMMs may round apart from the "
          f"legacy's one-cell ones); counts {cnt} [{card_line}]", flush=True)
    check(cnt == {"ota_round_step": BENCH_ROUNDS, "ota_aggregate": 0,
                  "plain_round_step": 0, "plain_aggregate": 0},
          f"fig2 --bench: only its minibatch fleet launches K1, once a "
          f"round: {cnt}")
    check(all(np.isfinite(v) and v > 0 for block in ("wall_s", "speedup")
              for v in rep[block].values()), "fig2 --bench walls")
    errors = validate_bench.validate_summary(
        fig2.bench_summary(rep, task.name, "chip_smoke phase 9"))
    print(f"  its summary against bench_schema.json: {errors or 'valid'}",
          flush=True)
    check(not errors, f"fig2 --bench summary violates the schema: {errors}")
    walls.update(bench_wall_s=rep["wall_s"], bench_speedup=rep["speedup"],
                 bench_max_abs_delta=rep["equivalence"]["max_abs_delta"])
    return walls


def phase_population(torch, np, dev, card, card_line, world):
    """Phase 10: population mode at full width -- the reference's cohorts
    of the 1M-device population, the population benchmark (adaptive_sca,
    stream against serial, the full-participation identity) through K1,
    the tick-0 cohort redesign against the reference's, and re-entry with
    kill and resume on a Gauss-Markov population."""
    import tempfile
    from repro_torch import fig2, scenario_sweep as ss, validate_bench
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import power_control as pcm, scenarios as scn
    from repro_torch.fl.driver import run_fleet_task
    t_phase = time.time()
    with open(ROOT / "experiments" / "population_reference"
              / "population.json") as f:
        ref = json.load(f)
    t0 = time.time()
    pop = fig2.make_population(POP_SIZE)
    same = {}
    for key, c in ref["cohorts"].items():
        seed, tick = map(int, key.split("/"))
        idx = pop.draw_cohort(ref["cohort"], tick, seed)
        same[key] = bool(np.array_equal(idx, c["idx"]) and np.array_equal(
            pop.gains_of(idx), np.asarray(c["gains"], np.float64)))
    print(f"  (a) make_population({POP_SIZE}): cohorts of {ref['cohort']} at "
          f"(seed/tick) {sorted(same)} and their gains bitwise the "
          f"reference's: {json.dumps(same)}; {time.time() - t0:.3f} s",
          flush=True)
    check(pop.describe() == ref["describe"] and all(same.values()),
          f"cohorts differ from the reference's: {same}")

    task = world["task"]
    sca10 = world["schemes"][fig2.SCHEMES.index("sca")]
    zero_counts()
    rep = fig2.population_benchmark(
        task=task, size=POP_SIZE, cohort=POP_COHORT, num_rounds=POP_ROUNDS,
        eval_every=POP_EVERY, cohort_rounds=POP_COHORT_ROUNDS, seed=0,
        batch_size=BATCH, log=False, full_schemes=[sca10], device=dev)
    torch.cuda.synchronize()
    cnt = _ota_counts()
    errors = validate_bench.validate_summary(
        fig2.bench_summary(rep, task.name, "chip_smoke phase 10"))
    res = rep.pop("result")
    print(f"  (b) population_benchmark: adaptive_sca, cohort {POP_COHORT}, "
          f"minibatch {BATCH}, fused f32 tail, {POP_ROUNDS} rounds, an eval "
          f"every {POP_EVERY}, cohort_rounds {POP_COHORT_ROUNDS}: designs at "
          f"rounds {[t for t, _ in res.designs]}; wall_s "
          f"{json.dumps(rep['wall_s'])}; stage walls per chunk "
          f"{json.dumps(rep['stage_chunks_s'])}; round ms "
          f"{json.dumps(rep['round_ms'])}; rounds/s "
          f"{rep['rounds_per_sec']:.3f}; overlap saving "
          f"{rep['overlap_saving_s']:.3f} s; stream bitwise serial "
          f"{rep['stream_bitwise']}; launches {json.dumps(rep['launches'])};"
          f" counts {cnt} [{card_line}]", flush=True)
    print(f"  (d) full participation (the 10-device deployment as a "
          f"population, cohort 10, sca, {FULL_ROUNDS} rounds, minibatch "
          f"{BATCH}) bitwise the plain fleet: {rep['full_cohort_bitwise']}",
          flush=True)
    print(f"  its summary against bench_schema.json: {errors or 'valid'}",
          flush=True)
    check(not errors, f"population benchmark summary violates the schema: "
          f"{errors}")
    check(rep["stream_bitwise"], "stream and serial differ")
    check(rep["full_cohort_bitwise"], "full participation differs from "
          "the plain fleet")
    for label in ("stream", "serial"):
        check(rep["launches"][label] == {"ota_round_step": POP_ROUNDS,
                                         "plain_round_step": 0},
              f"{label}: K1 must launch once a round and its plain version "
              f"never: {rep['launches'][label]}")
    check(rep["launches"]["full_participation"]["ota_round_step"]
          == 2 * FULL_ROUNDS, f"full participation K1 {rep['launches']}")
    check(cnt["ota_round_step"] == 2 * POP_ROUNDS + 2 * FULL_ROUNDS
          and cnt["plain_round_step"] == 0 and cnt["ota_aggregate"] == 0,
          f"population phase counts {cnt}")
    check(len(res.designs) == POP_ROUNDS // POP_COHORT_ROUNDS,
          f"one cohort redesign per tick: {[t for t, _ in res.designs]}")

    want = np.asarray(ref["redesigns"]["0/0"]["gamma"])
    err = _rel(np, res.designs[0][1][0, 0], want)
    print(f"  (c) the tick-0 cohort redesign (host f64 solver) against the "
          f"reference's: {err:.3e} relative in gamma (tol {REDESIGN_RTOL})",
          flush=True)
    check(err <= REDESIGN_RTOL, f"tick-0 cohort redesign off by {err:.3e}")

    t0 = time.time()
    r = REENTRY
    dep, prm, td = fig2.build_world(task, 0, num_devices=r["cohort"])
    prm = prm.replace(eta=task.eta_for("sca", float(prm.eta)))
    sca = pcm.make_sca(dep, prm, method="scipy")
    gm = scn.Population(spec=scn.PopulationSpec(
        size=r["size"], shadowing=scn.ShadowingSpec(),
        dynamics=scn.DynamicsSpec(rho=r["rho"])))
    run = task.run_config(num_rounds=r["rounds"], eval_every=r["every"],
                          seed=0, batch_size=BATCH)
    kw = dict(task_data=td, flat=True, device=dev, population=gm,
              cohort_size=r["cohort"], cohort_rounds=r["cohort_rounds"])
    launched = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for label, extra in (
                ("whole", dict(checkpoint_path=str(Path(tmp) / "whole"))),
                ("first", dict(checkpoint_path=str(Path(tmp) / "fleet"),
                               max_chunks=r["max_chunks"])),
                ("resumed", dict(checkpoint_path=str(Path(tmp) / "fleet"),
                                 resume=True))):
            zero_counts()
            runs[label] = run_fleet_task(task, [sca], dep.gains, run, **kw,
                                         **extra)
            torch.cuda.synchronize()
            launched[label] = counts()["ota_round_step"]
        a = ckpt.load_flat(str(Path(tmp) / "whole"))
        b = ckpt.load_flat(str(Path(tmp) / "fleet"))
    whole, first, rest = runs["whole"], runs["first"], runs["resumed"]
    executed = {k: sum(n for n, _ in v.chunk_walls) for k, v in runs.items()}
    slots = sum(i.size for _, i in whole.cohorts)
    distinct = len(np.unique(np.concatenate([i[0] for _, i in
                                             whole.cohorts])))
    bitwise = {"params_traces": ss.bitwise(whole, rest),
               "evals": len(whole.evals) == len(rest.evals) and all(
                   np.array_equal(x[k], y[k]) for (_, x), (_, y)
                   in zip(whole.evals, rest.evals) for k in x),
               "fading_state": torch.equal(whole.fading_state,
                                           rest.fading_state),
               "cohorts": np.array_equal(a["cohorts_idx"], b["cohorts_idx"]),
               "pop_last": np.array_equal(a["pop_last"], b["pop_last"]),
               "pop_state": np.array_equal(a["pop_state"], b["pop_state"])}
    print(f"  (e) re-entry: a {r['size']}-device Gauss-Markov population "
          f"(rho {r['rho']}), cohort {r['cohort']}, cohort_rounds "
          f"{r['cohort_rounds']}, {r['rounds']} rounds, sca: "
          f"{len(whole.cohorts)} cohorts, {slots} cohort slots over "
          f"{distinct} distinct devices -- {slots - distinct} re-entries; "
          f"stopped after {r['max_chunks']} chunks and resumed: rounds run "
          f"{executed}, K1 launches {launched}; bitwise "
          f"{json.dumps(bitwise)}; {time.time() - t0:.2f} s", flush=True)
    check(slots > distinct, "no device re-entered")
    check(executed["first"] < r["rounds"] and executed["first"]
          + executed["resumed"] == r["rounds"] and launched == executed,
          f"rounds run {executed}, K1 launches {launched}")
    check(all(bitwise.values()), f"resumed population run differs: "
          f"{bitwise}")
    k1 = k1_row(torch, dev, card, (1, POP_COHORT, MAIN[2]),
                "the cohort fleet's", 10)
    walls = {"phase_s": time.time() - t_phase, **rep["wall_s"],
             "round_ms": rep["round_ms"],
             "overlap_saving_s": rep["overlap_saving_s"],
             "stage_chunks_s": rep["stage_chunks_s"]}
    print(f"  phase 10 walls [{card_line}]: {json.dumps(walls)}", flush=True)
    return {"k1_launches": rep["launches"]["stream"]["ota_round_step"],
            "k1_row": k1, "walls": walls}


def cifar_world(torch, np, dev):
    """cifar_conv's world (``fig2.build_world``, data seed 0) and its seven
    schemes designed at the task's step sizes, ``sca`` on the card (timed)
    and held against the reference's committed design."""
    from repro_torch import fig2
    from repro_torch.core import theory
    task = fig2._task("cifar_conv")
    dep, prm, td = fig2.build_world(task, 0)
    check(task.param_dim == CIFAR[2], f"cifar_conv d {task.param_dim}")
    torch.cuda.synchronize()
    t0 = time.time()
    schemes = fig2.make_schemes(task, dep, prm, device=dev)
    torch.cuda.synchronize()
    design_s = time.time() - t0
    with open(ROOT / "experiments" / "cifar_reference"
              / "sca_design.json") as f:
        want = json.load(f)
    prm_sca = prm.replace(eta=task.eta_for("sca", float(prm.eta)))
    check(int(want["d"]) == CIFAR[2] and float(want["eta"]) == prm_sca.eta,
          "the reference's cifar design is for another world")
    sca = schemes[fig2.SCHEMES.index("sca")]
    errs = {"gamma": _rel(np, sca.gamma, want["gamma"]),
            "alpha": _rel(np, sca.alpha, want["alpha"]),
            "thresholds": _rel(np, sca.thresholds, want["thresholds"]),
            "objective": _rel(np, theory.p1_objective(sca.gamma, prm_sca),
                              want["objective"])}
    print(f"  (a) cifar_conv world: d = {task.param_dim}, shards "
          f"{tuple(td.train[0].shape)} (Dirichlet 0.3, padded); the seven "
          f"schemes designed in {design_s:.3f} s (sca: the torch f64 "
          f"solver on the card); sca against the reference's committed "
          f"design, relative: {json.dumps(errs)} (tol {SCA_RTOL}, "
          f"objective {SCA_OBJECTIVE_RTOL})", flush=True)
    for name in ("gamma", "alpha", "thresholds"):
        check(errs[name] <= SCA_RTOL, f"cifar sca {name} off the "
              f"reference's by {errs[name]:.3e}")
    check(errs["objective"] <= SCA_OBJECTIVE_RTOL, "cifar sca objective off "
          f"the reference's by {errs['objective']:.3e}")
    return {"task": task, "dep": dep, "prm": prm, "td": td,
            "schemes": schemes, "design_s": design_s, "design_err": errs}


def cifar_curves(torch, np, dev, cw):
    """The cifar curves through K1 (150 rounds, an eval every 10, minibatch
    32) held by ``curves.gate`` against the reference's, at seeds 0-3, or
    0-7 where the gate's false-alarm rate at four seeds a side is over
    CIFAR_FALSE_ALARM_MAX."""
    from repro_torch import curves, scenario_sweep as ss
    reference, _ = curves.TASKS["cifar_conv"]
    rates = {n: ss.gate_false_alarm(curves.load_reference(
        CIFAR_PROTOCOL, range(n), reference), n)["any"] for n in (4, 8)}
    seeds = tuple(range(8 if rates[4] > CIFAR_FALSE_ALARM_MAX else 4))
    print(f"  (b) the gate's false-alarm rate over 21 comparisons at 4 "
          f"seeds a side {rates[4]:.4f}, at 8 {rates[8]:.4f}: seeds "
          f"{list(seeds)}", flush=True)
    runs = []

    def after(seed, res):
        torch.cuda.synchronize()
        runs.append((seed, _ota_counts(), round_ms(res), res.wall))
        zero_counts()
        check_result(torch, np, res, curves.ROUNDS, f"cifar seed {seed}")
    zero_counts()
    port = curves.run_port(CIFAR_PROTOCOL, seeds, dev, cw["schemes"],
                           after_run=after, task="cifar_conv")
    for seed, cnt, ms, wall in runs:
        print(f"  cifar seed {seed}: {curves.ROUNDS} rounds, round wall "
              f"{ms:.3f} ms, run wall {wall:.2f} s, counts {cnt}",
              flush=True)
        check(cnt == {"ota_round_step": curves.ROUNDS, "ota_aggregate": 0,
                      "plain_round_step": 0, "plain_aggregate": 0},
              f"cifar seed {seed}: K1 must launch once a round and nothing "
              f"else of the OTA tail run: {cnt}")
    rows = curves.gate(port, curves.load_reference(CIFAR_PROTOCOL, seeds,
                                                   reference))
    print(curves.table(rows, f"  cifar_conv {CIFAR_PROTOCOL}: port (this "
                       f"card) vs reference (CPU), seeds {list(seeds)}, "
                       f"{curves.ROUNDS} rounds"), flush=True)
    fails = [f"{r['scheme']}/{r['stat']}" for r in rows if not r["ok"]]
    check(not fails, f"cifar curves outside the gate: {fails}")
    return {"seeds": list(seeds), "false_alarm": rates,
            "round_ms": [ms for _, _, ms, _ in runs],
            "gate_ok": f"{len(rows)}/{len(rows)}"}


def _same_run(np, torch, a, b, bv=True):
    """Params, traces (the ``bv_*`` ones only when ``bv``) and evals of two
    fleet results, bitwise."""
    keys = [k for k in a.traces if bv or not k.startswith("bv_")]
    return (all(torch.equal(a.params[k], b.params[k]) for k in a.params)
            and all(k in b.traces and np.array_equal(a.traces[k],
                                                     b.traces[k])
                    for k in keys)
            and [t for t, _ in a.evals] == [t for t, _ in b.evals]
            and all(np.array_equal(x[k], y[k]) for (_, x), (_, y)
                    in zip(a.evals, b.evals) for k in x))


def cifar_telemetry(torch, np, dev, cw):
    """``fig2.run(task="cifar_conv", telemetry=True)`` (the path of ``fig2
    --task cifar_conv --telemetry``) for TEL_ROUNDS rounds with a
    checkpoint, against the same run with telemetry off; its report; and
    its kill and resume under telemetry."""
    import os
    import subprocess as sp
    import tempfile
    from repro_torch import fig2
    from repro_torch.telemetry import read_events
    kw = dict(num_rounds=TEL_ROUNDS, eval_every=EVERY, seed=0,
              batch_size=CIFAR_BATCH, task=cw["task"], save=False,
              designs=cw["schemes"], device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        zero_counts()
        _, off = fig2.run(**kw, checkpoint_path=str(tmp / "off" / "fleet"))
        torch.cuda.synchronize()
        cnt_off = counts()
        zero_counts()
        _, on = fig2.run(**kw, telemetry=True, out_dir=tmp / "on",
                         checkpoint_path=str(tmp / "on" / "fleet"))
        torch.cuda.synchronize()
        cnt_on = counts()
        events = read_events(str(tmp / "on"))
        execs = [e["chunk"] for e in events if e["ev"] == "chunk_exec"]
        proc = sp.run([sys.executable, "-m", "repro_torch.telemetry.report",
                       str(tmp / "on")], capture_output=True, text=True,
                      timeout=300, env={**os.environ,
                                        "PYTHONPATH": str(SRC)})
        report_ok = proc.returncode == 0 and all(
            t in proc.stdout for t in REPORT_SECTIONS) \
            and "bv_bias_power" in proc.stdout
        first = fig2.run(**kw, telemetry=True, out_dir=tmp / "kill",
                         checkpoint_path=str(tmp / "kill" / "fleet"),
                         max_chunks=1)[1]
        rest = fig2.run(**kw, telemetry=True, out_dir=tmp / "kill",
                        checkpoint_path=str(tmp / "kill" / "fleet"),
                        resume=True)[1]
        kill_ev = read_events(str(tmp / "kill"))
    kill_execs = [e["chunk"] for e in kill_ev if e["ev"] == "chunk_exec"]
    same = _same_run(np, torch, on, off, bv=False)
    bv = sorted(k for k in on.traces if k.startswith("bv_"))
    resumed = _same_run(np, torch, on, rest)
    out = {"round_ms_off": round_ms(off), "round_ms_on": round_ms(on),
           "k1_launches": cnt_on["ota_round_step"]}
    out["overhead_share"] = out["round_ms_on"] / out["round_ms_off"] - 1.0
    print(f"  (c) fig2.run cifar_conv --telemetry, {TEL_ROUNDS} rounds with "
          f"a checkpoint: params, the non-bv traces and the evals bitwise "
          f"telemetry off: {same}; bv traces {bv}; {len(events)} events, "
          f"chunk_exec of chunks {execs} ({len(on.chunk_walls)} chunks); "
          f"round wall {out['round_ms_off']:.3f} ms off, "
          f"{out['round_ms_on']:.3f} ms on ({100 * out['overhead_share']:+.1f}"
          f" %); counts off {cnt_off}, on {cnt_on}; report exit "
          f"{proc.returncode}, every section: {report_ok}", flush=True)
    print("\n".join("    | " + line for line in proc.stdout.splitlines()
                    [:40]), flush=True)
    check(same, "telemetry on changed params, traces or evals")
    check(bv == ["bv_bias_power", "bv_chan_power", "bv_noise_var",
                 "bv_weight_dev"] and not any(k.startswith("bv_")
                                              for k in off.traces),
          f"bv traces: on {bv}, off {sorted(off.traces)}")
    check(execs == list(range(len(on.chunk_walls))),
          f"one chunk_exec per chunk: {execs}")
    check(cnt_on["ota_round_step"] == cnt_off["ota_round_step"] == TEL_ROUNDS
          and cnt_on["plain_round_step"] == 0,
          f"K1 once a round with and without telemetry: {cnt_off}, "
          f"{cnt_on}")
    check(report_ok, f"telemetry.report: {proc.returncode} "
          f"{proc.stderr[-2000:]}")
    runs = {e["run"] for e in kill_ev}
    print(f"  (d) kill after chunk 1 and resume under telemetry: bitwise the "
          f"uninterrupted run (bv traces included): {resumed}; run ids "
          f"{sorted(runs)}; chunk_exec of chunks {kill_execs}; "
          f"{sum(e['ev'] == 'run_resume' for e in kill_ev)} run_resume",
          flush=True)
    check(sum(n for n, _ in first.chunk_walls) < TEL_ROUNDS,
          "the first invocation ran every round")
    check(resumed, "the resumed run differs from the uninterrupted one")
    check(len(runs) == 1 and kill_execs == list(range(len(on.chunk_walls))),
          f"one log after kill and resume: runs {runs}, chunks {kill_execs}")
    return out


def cifar_forced_off(torch, dev, cw):
    """K1 (SHORT fused rounds) and K2 (SHORT unfused rounds) forced off vs
    on, the cifar fleet, bitwise."""
    from repro_torch.fl.driver import run_fleet_task
    task, dep, td = cw["task"], cw["dep"], cw["td"]
    run = task.run_config(num_rounds=SHORT, eval_every=SHORT, seed=0,
                          batch_size=CIFAR_BATCH)
    out = {}
    for label, kw, kernel in (("fused", {}, "ota_round_step"),
                              ("unfused", {"fuse_round": False},
                               "ota_aggregate")):
        zero_counts()
        on = run_fleet_task(task, cw["schemes"], dep.gains, run,
                            task_data=td, flat=True, device=dev, **kw)
        torch.cuda.synchronize()
        cnt = _ota_counts()
        off = run_fleet_task(task, cw["schemes"], dep.gains, run,
                             task_data=td, flat=True, device=dev,
                             use_kernel=False, **kw)
        same = all(torch.equal(on.params[k], off.params[k])
                   for k in on.params)
        print(f"  (e) cifar {label}, {SHORT} rounds, {kernel} forced off vs "
              f"on: bitwise {same}; counts on {cnt}", flush=True)
        check(cnt[kernel] == SHORT and sum(cnt.values()) == SHORT,
              f"cifar {label}: {kernel} once a round, nothing else: {cnt}")
        check(same, f"cifar {label}: kernels forced off differ")
        out[label] = cnt[kernel]
    return out


def population_telemetry(torch, np, dev, world):
    """A short ``adaptive_sca`` population run under telemetry, stream on:
    the phase-10 world (1M devices, disk, 8 dB shadowing, traffic-weighted
    cohorts of 50, paper_mlp) made Gauss-Markov, two cohorts."""
    import tempfile
    from repro_torch import fig2
    from repro_torch.core import power_control as pcm, scenarios as scn
    from repro_torch.fl.driver import run_fleet_task
    from repro_torch.telemetry import Telemetry, read_events
    task = world["task"]
    p = POP_TEL
    dep, prm, td = fig2.build_world(task, 0, num_devices=POP_COHORT)
    prm = prm.replace(eta=task.eta_for("adaptive_sca", float(prm.eta)))
    pcs = [pcm.make_adaptive_sca(dep, prm, base=pcm.make_sca(
        dep, prm, method="scipy"))]
    pop = scn.Population(spec=scn.PopulationSpec(
        size=POP_SIZE, shadowing=scn.ShadowingSpec(), sampling="traffic",
        dynamics=scn.DynamicsSpec(rho=p["rho"])))
    run = task.run_config(num_rounds=p["rounds"], eval_every=p["every"],
                          seed=0, batch_size=BATCH)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        res = run_fleet_task(task, pcs, dep.gains, run, task_data=td,
                             flat=True, population=pop,
                             cohort_size=POP_COHORT,
                             cohort_rounds=p["cohort_rounds"], stream=True,
                             telemetry=Telemetry(run_dir=tmp,
                                                 kappa_sq=float(prm.kappa_sq)),
                             device=dev)
        torch.cuda.synchronize()
        cnt = _ota_counts()
        events = read_events(tmp)
    kinds = {}
    for e in events:
        kinds[e["ev"]] = kinds.get(e["ev"], 0) + 1
    solves = [e for e in events if e["ev"] == "sca_solve"]
    cohorts = [e for e in events if e["ev"] == "cohort"]
    stages = [e for e in events if e["ev"] == "stage"]
    waits = [e for e in events if e["ev"] == "stage_wait"]
    stale = [np.asarray(e["staleness"]).shape for e in cohorts
             if "staleness" in e]
    print(f"  (f) population under telemetry: adaptive_sca on "
          f"{POP_SIZE:,} Gauss-Markov devices (rho {p['rho']}), cohort "
          f"{POP_COHORT}, {p['rounds']} rounds, a cohort every "
          f"{p['cohort_rounds']}, stream on: events {json.dumps(kinds)}; "
          f"sca_solve chunks {[e.get('chunk') for e in solves]}; cohort "
          f"staleness shapes {stale}, never seen "
          f"{[e.get('never_seen') for e in cohorts]}; stage chunks "
          f"{[e['chunk'] for e in stages]}, stage_wait chunks "
          f"{[e['chunk'] for e in waits]}; counts {cnt}; "
          f"{time.time() - t0:.2f} s", flush=True)
    check(len(solves) == len(cohorts) == 2 and all(
        isinstance(e.get("chunk"), int) for e in solves),
        "one sca_solve per fresh cohort, tagged with its chunk")
    check(len(stale) == len(cohorts) and all(
        sh == (1, POP_COHORT) for sh in stale), "cohorts carry staleness")
    check(stages and waits and len(waits) == len(stages) - 1,
          "stage and stage_wait events")
    check(cnt["ota_round_step"] == p["rounds"]
          and cnt["plain_round_step"] == 0, f"population K1 {cnt}")
    check(len(res.designs) == 2, "two cohort redesigns")
    return kinds


def phase_cifar(torch, np, dev, card, card_line, world):
    """Phase 11: the cifar_conv fleet with run telemetry at full width."""
    from repro_torch import fig2
    from repro_torch.profile_round import fig2_fleet, profile
    t_phase = time.time()
    cw = cifar_world(torch, np, dev)
    curves_stats = cifar_curves(torch, np, dev, cw)
    tel = cifar_telemetry(torch, np, dev, cw)
    forced = cifar_forced_off(torch, dev, cw)
    k1 = k1_row(torch, dev, card, CIFAR, "the cifar fleet's", 12)
    pop = population_telemetry(torch, np, dev, world)
    fleet, _, _, grad_ms = fig2_fleet(cw["task"], SHORT, CIFAR_BATCH, dev,
                                      schemes=cw["schemes"])
    prof = profile(fleet, SHORT)
    det, dflt = grad_ms["deterministic_True"], grad_ms["deterministic_False"]
    print(f"  (g) the cifar round, telemetry off, {SHORT} rounds under "
          f"torch.profiler: {prof['launches_per_round']:.1f} kernel "
          f"launches a round, device {prof['device_ms_per_round']:.3f} ms, "
          f"wall {prof['round_wall_ms']:.3f} ms, busy "
          f"{prof['busy_share']:.3f}; two runs apart by "
          f"{prof['repeat_max_abs_diff']:.3e} (deterministic cuDNN); top "
          f"kernels {json.dumps(prof['top'][:6])} [{card_line}]",
          flush=True)
    print(f"  (g) the round's gradients alone (CUDA events): "
          f"{det['ms']:.3f} ms with deterministic cuDNN, {dflt['ms']:.3f} "
          f"ms with cuDNN's default algorithms "
          f"({100 * (det['ms'] / dflt['ms'] - 1):+.1f} %); two calls apart "
          f"by {det['repeat_max_abs_diff']:.3e} and "
          f"{dflt['repeat_max_abs_diff']:.3e}", flush=True)
    check(prof["repeat_max_abs_diff"] == 0.0
          and det["repeat_max_abs_diff"] == 0.0,
          "two runs of the same cifar fleet differ")
    walls = {"phase_s": time.time() - t_phase, "design_s": cw["design_s"],
             "curves": curves_stats, "telemetry": tel,
             "launches_per_round": prof["launches_per_round"],
             "gradients_ms": grad_ms,
             "device_ms_per_round": prof["device_ms_per_round"],
             "busy_share": prof["busy_share"]}
    print(f"  phase 11 walls [{card_line}]: {json.dumps(walls)}", flush=True)
    return {"k1_launches": tel["k1_launches"], "k1_row": k1,
            "forced": forced, "walls": walls, "events": pop}


def _ota_counts():
    return {k: v for k, v in counts().items()
            if k in ("ota_round_step", "ota_aggregate", "plain_round_step",
                     "plain_aggregate")}


def phase_scenarios(torch, np, dev, card, card_line):
    """Phase 8: the heterogeneous-wireless path -- the theory sweep over
    every registered scenario, the full-width grid through K1 and its
    identities, K1/K2 forced off, the adaptive scheme's redesigns, and
    kill and resume on a Gauss-Markov fleet and on the grid."""
    import dataclasses
    import tempfile
    from repro_torch import curves, scenario_sweep as ss, tasks
    from repro_torch.core import power_control as pcm, scenarios as scn
    from repro_torch.fl.driver import run_fleet_task
    from repro_torch.fl.engine import chunk_lengths
    walls = {}
    t_phase = time.time()
    # the three fading families' batched solves at once
    world = ss.design(scn.scenario_names(), device=dev, jobs=3)
    walls["sca_designs_s"] = {fam: sec for fam, _, sec in world["sca_calls"]}
    for fam, group, sec in world["sca_calls"]:
        print(f"  sca designs, {fam} ({', '.join(group)}): one batched solve "
              f"on the card, {sec:.3f} s, the three families' at once "
              f"[{card_line}]", flush=True)
    ref = ss.load_theory_reference(0)
    errs = ss.theory_errors(ss.sweep(world), ref)
    worst = max(errs, key=errs.get)
    design_err = {n: _rel(np, world[n]["schemes"][0].gamma,
                          ref["sca_designs"][n]["gamma"])
                  for n in scn.SWEEP_FAMILIES}
    print(f"  theory rows of {len(errs)} (scenario, scheme) pairs: largest "
          f"relative error of bias / variance / objective {errs[worst]:.3e} "
          f"({worst}; tol {THEORY_RTOL}); the grid's sca designs against "
          f"the reference's per-scenario designs {json.dumps(design_err)}",
          flush=True)
    check(len(errs) == 30 and errs[worst] <= THEORY_RTOL,
          f"theory rows off the reference's: {worst} {errs[worst]:.3e}")
    check(max(design_err.values()) <= THEORY_RTOL,
          f"grid sca designs off the reference's: {design_err}")
    walls["theory_s"] = time.time() - t_phase

    task = tasks.get("paper_mlp", expect_runtime="fleet")
    check(ss.run_config(task, ss.ROUNDS, ss.EVERY).batch_size == 0,
          "the grid runs paper_mlp's full batch")
    rep = ss.grid(world, task, device=dev)
    res, checks = rep["result"], ss.grid_ok(rep)
    grid_counts = rep["counts"]["grid"]
    walls.update(rep["walls"], grid_round_ms=round_ms(res),
                 grid_more_seeds_round_ms=round_ms(rep["more"]))
    k_total = len(res.names)
    check(k_total * len(res.seeds) == GRID_CELLS
          and res.params["w1"].shape[:2] == (k_total, len(ss.SEEDS)),
          f"grid cells {k_total} x {len(res.seeds)}")
    check(all(bool(torch.isfinite(v).all()) for v in res.params.values()),
          "grid params not finite")
    more = rep["more"].seeds
    print(f"  grid {len(scn.SWEEP_FAMILIES)} x {len(ss.SCHEMES)} x "
          f"{len(ss.SEEDS)} = {GRID_CELLS} cells, d = {task.param_dim}, full "
          f"batch, fused f32 tail, {ss.ROUNDS} rounds: counts "
          f"{grid_counts}, round wall {walls['grid_round_ms']:.3f} ms, run "
          f"wall {res.wall:.2f} s; the gate's other seeds {list(more)}: a "
          f"second 48-cell grid, round wall "
          f"{walls['grid_more_seeds_round_ms']:.3f} ms [{card_line}]",
          flush=True)
    print(curves.table(rep["gate"], f"  grid: port (this card) vs reference "
                       f"(CPU), seeds {list(res.seeds + more)}, {ss.ROUNDS} "
                       "rounds"), flush=True)
    print(f"  bitwise: R = 1 grid vs the disk_rayleigh fleet, the grid vs "
          f"its 4 scenario fleets, {ss.IDENTITY_ROUNDS} grid rounds with K1 "
          f"forced off vs on, {ss.UNFUSED_ROUNDS} unfused rounds with K2 off "
          f"vs on (K2 counts {rep['counts']['unfused']}): "
          f"{json.dumps(rep['identities'])}", flush=True)
    check(checks["grid_launches"],
          f"the grid must launch K1 once a round: {grid_counts}")
    misses = [f"{r['scheme']}/{r['stat']}" for r in rep["gate"]
              if not r["ok"]]
    check(checks["gate"], f"grid curves outside the gate: {misses}")
    check(checks["identities"], f"a grid identity failed: "
          f"{rep['identities']}")
    check(checks["unfused_launches"], f"the unfused grid must launch K2 "
          f"once a round: {rep['counts']['unfused']}")
    td = task.build_data(0)
    base = dict(task_data=td, params=task.init_params(0, dev),
                eval_fn=task.make_eval(td, dev), device=dev)
    k1_row = k1_value_patterns(torch, dev, card)

    t0 = time.time()
    mk = world["disk_markov"]
    fading = scn.make_fading_process(mk["dep"], mk["scenario"].dynamics)
    redesign_s, last = [], {}
    pc = pcm.make_adaptive_sca(mk["dep"], mk["prm"],
                               base=mk["schemes"][0], device=dev)
    hook = pc.redesign_fn

    def timed(scheme, proc, state):
        torch.cuda.synchronize()
        ts = time.time()
        out = hook(scheme, proc, state)
        torch.cuda.synchronize()
        redesign_s.append(time.time() - ts)
        last.update(args=(scheme, proc, state.clone()), out=out)
        return out
    pc = dataclasses.replace(pc, redesign_fn=timed)
    arun = ss.run_config(task, ADAPTIVE_ROUNDS, ADAPTIVE_EVERY)
    zero_counts()
    ares = run_fleet_task(task, [pc], mk["dep"].gains, arun, etas=[ss.ETA],
                          seeds=ss.SEEDS, fading=fading, flat=True, **base)
    torch.cuda.synchronize()
    a_counts = _ota_counts()
    gam = [g for _, g in ares.designs]
    moves = [_rel(np, b, a) for a, b in zip(gam, gam[1:])]
    seed_spread = [float(np.max(np.abs(g[0] - g[0, :1]) / np.abs(g[0, :1])))
                   for g in gam[1:]]
    # the run's last redesign on the card against the same redesign on the
    # CPU, from the state it was made from
    scheme, proc, state = last["args"]
    on_card, card_s = last["out"], redesign_s[-1]
    ts = time.time()
    on_cpu = hook(scheme, proc, state.cpu())
    cpu_s = time.time() - ts
    cpu_err = {f: _rel(np, getattr(on_card, f), getattr(on_cpu, f))
               for f in ("gamma", "alpha")}
    walls.update(adaptive_s=time.time() - t0,
                 adaptive_round_ms=round_ms(ares), redesign_s=redesign_s,
                 last_redesign_card_s=card_s, last_redesign_cpu_s=cpu_s)
    print(f"  adaptive_sca on disk_markov, {ADAPTIVE_ROUNDS} rounds, "
          f"S = {len(ss.SEEDS)}: designs at rounds "
          f"{[t for t, _ in ares.designs]}, moves between chunks "
          f"{moves}, spread across seeds {seed_spread}; redesign walls "
          f"{[round(x, 3) for x in redesign_s]} s; round wall "
          f"{walls['adaptive_round_ms']:.3f} ms; counts {a_counts}; the last "
          f"redesign on the card {card_s:.3f} s vs the same on this "
          f"machine's CPU {cpu_s:.3f} s, relative difference "
          f"{json.dumps(cpu_err)} "
          f"[{card_line}]", flush=True)
    # a redesign at every chunk boundary before the last round: the
    # reference's cadence ends chunks after rounds 0, 10 and 19
    n_redesigns = len(chunk_lengths(ADAPTIVE_ROUNDS, ADAPTIVE_EVERY, True)) - 1
    check(len(ares.designs) == n_redesigns + 1
          and len(redesign_s) == n_redesigns,
          f"adaptive designs {[t for t, _ in ares.designs]}")
    check(min(moves) > ADAPTIVE_MOVE and min(seed_spread) > ADAPTIVE_MOVE,
          f"adaptive designs did not move: {moves}, {seed_spread}")
    check(max(cpu_err.values()) <= THEORY_RTOL,
          f"redesign on the card vs the CPU: {cpu_err}")
    check(a_counts["ota_round_step"] == ADAPTIVE_ROUNDS,
          f"adaptive fleet K1 counts {a_counts}")

    t0 = time.time()
    resumes = {}
    rrun = ss.run_config(task, RESUME_ROUNDS, EVERY)
    for label, fleet in (
            ("disk_markov", lambda **kw: ss.scenario_fleet(
                task, world, "disk_markov", rrun, ss.SEEDS, **kw)),
            ("grid", lambda **kw: ss.grid_fleet(
                task, world, scn.SWEEP_FAMILIES, rrun, ss.SEEDS, **kw))):
        whole = fleet(**base)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "fleet")
            first = fleet(checkpoint_path=path, max_chunks=1, **base)
            rest = fleet(checkpoint_path=path, resume=True, **base)
        done = (sum(n for n, _ in first.chunk_walls),
                sum(n for n, _ in rest.chunk_walls))
        same = {"params_traces": ss.bitwise(rest, whole),
                "evals": all(np.array_equal(a[k], b[k])
                             for (_, a), (_, b) in zip(whole.evals,
                                                       rest.evals)
                             for k in a)
                and len(whole.evals) == len(rest.evals),
                "fading_state": torch.equal(whole.fading_state,
                                            rest.fading_state)}
        resumes[label] = same
        print(f"  kill and resume, {label}: {RESUME_ROUNDS} rounds, rounds "
              f"run {done}; bitwise {json.dumps(same)}", flush=True)
        check(done[0] < RESUME_ROUNDS and sum(done) == RESUME_ROUNDS
              and all(same.values()), f"{label} resume: {done} {same}")
    walls["resume_s"] = time.time() - t0
    walls["phase_s"] = time.time() - t_phase
    print(f"  phase 8 walls [{card_line}]: {json.dumps(walls)}", flush=True)
    return {"grid_k1": grid_counts["ota_round_step"], "k1_row": k1_row,
            "walls": walls}


def attention_on_vs_off(torch, res, cfg):
    """K3 on vs forced off on a serve run's weights and prompts: the first
    attention layer's (GQA or MLA) output (on, off), on the hidden state
    that the
    layers before it (none in a dense arch) hand it, and the prefill
    logits of K3 against its plain version as (max |d|, max |logit|, share
    of equal greedy tokens)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed, rmsnorm
    sigs = tfm.layer_sigs(cfg)
    first = next(i for i, (kind, _) in enumerate(sigs)
                 if kind in tfm.GQA_KINDS)
    p = res.params["layers"][first]
    with torch.no_grad():
        x = embed(res.params["embed"], res.prompts, cfg.compute_dtype)
        for i in range(first):
            x, _, _ = tfm.apply_layer(res.params["layers"][i], x, cfg, sigs[i])
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        kind = sigs[first][0]
        if cfg.attn_kind == "mla":
            on, _ = attn.mla_apply(p["mixer"], h, cfg)
            off, _ = attn.mla_apply(p["mixer"], h, cfg, use_kernel=False)
        else:
            on, _ = attn.gqa_apply(p["mixer"], h, cfg, kind=kind)
            off, _ = attn.gqa_apply(p["mixer"], h, cfg, kind=kind,
                                    use_kernel=False)
        del x, h
        logits_off, _ = tfm.forward(res.params, res.prompts, cfg,
                                    use_kernel=False)
    kernel = (float((res.logits - logits_off).abs().max()),
              float(logits_off.abs().max()),
              float((res.logits.argmax(-1) == logits_off.argmax(-1))
                    .float().mean()))
    return on.float(), off.float(), kernel


def check_serve_run(torch, res, cnt, label, n_layers=None):
    """One serve run of a GQA arch or of a hybrid with GQA layers: K3 once
    per attention layer (``n_layers``, default the decoder's GQA layers)
    in each of its two prefills (warm-up, timed) and never in a decode
    step, no plain attention, OTA kernel or K4; finite logits and tokens
    in range, of the run's shapes."""
    from repro_torch.models import transformer as tfm
    if n_layers is None:
        n_layers = sum(kind in tfm.GQA_KINDS for kind, _ in
                       tfm.layer_sigs(res.cfg))
    check(res.stats["k3_launches_per_prefill"] == n_layers,
          f"{label}: K3 launched {res.stats['k3_launches_per_prefill']} "
          f"times in a prefill of {n_layers} attention layers")
    check(cnt["flash_attention"] == 2 * n_layers,     # warm-up + timed
          f"{label}: K3 launched {cnt['flash_attention']} times in 2 "
          "prefills")
    check(cnt["plain_attention"] == 0,
          f"{label}: K3's plain version ran on the card")
    check(cnt["ota_round_step"] == cnt["ota_aggregate"] == 0,
          f"{label}: an OTA kernel ran on the serve path")
    check(cnt["ssd_scan"] == cnt["plain_ssd"] == 0,
          f"{label}: K4 or its plain version ran on the GQA serve path")
    b, s, v = (res.stats["batch"], res.stats["prompt_len"],
               res.cfg.padded_vocab)
    check(tuple(res.logits.shape) == (b, s, v),
          f"{label}: logits {res.logits.shape}")
    check(bool(torch.isfinite(res.logits).all()), f"{label}: logits not "
          "finite")
    check(tuple(res.tokens.shape) == (b, res.stats["decode_tokens"]),
          f"{label}: tokens {res.tokens.shape}")
    check(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < v,
          f"{label}: a token out of range")


def phase_serve(torch, dev):
    """Phase 5: the LM serve path at full width, K3 on vs forced off, in
    bf16 and in float32, and a sliding-window run through the ring
    cache."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in SERVE.items()]
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    main_cnt = counts()
    cfg, st = res.cfg, res.stats
    print(f"  serve main path: counts {main_cnt}", flush=True)
    check_serve_run(torch, res, main_cnt, "bf16 serve")
    b, s = SERVE["batch"], SERVE["prompt_len"]

    # K3 forced off, same weights and prompts
    on, off, kernel = attention_on_vs_off(torch, res, cfg)
    layer0_err = float((on - off).abs().max())
    drift = {"bf16": {"layer0_attention_max_abs_err": layer0_err,
                      "logits_max_abs_diff": kernel[0],
                      "logits_max_abs": kernel[1],
                      "equal_next_tokens": kernel[2]}}
    print(f"  serve (bf16), K3 on vs off: {json.dumps(drift['bf16'])} "
          f"(tolerance: layer 0 within {ATTN_BF16_TOL}; logits within "
          f"{DRIFT_LOGITS_SHARE} of max |logit|, greedy tokens equal at >= "
          f"{EQUAL_TOKENS_MIN} of positions)", flush=True)
    check(bool((on - off).abs().le(ATTN_BF16_TOL["atol"]
                                   + ATTN_BF16_TOL["rtol"]
                                   * off.abs()).all()),
          f"layer 0 attention, K3 on vs off: max |d| {layer0_err}")
    check(kernel[0] <= DRIFT_LOGITS_SHARE * kernel[1],
          f"logits drift {kernel[0]} over {DRIFT_LOGITS_SHARE} x {kernel[1]}")
    check(kernel[2] >= EQUAL_TOKENS_MIN, f"equal next tokens {kernel[2]}")
    del res, on, off

    # the same model in float32 (the same draw, unrounded): K3's f32 kernel
    # in every prefill
    cfg32 = cfg.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    zero_counts()
    r32 = serve.run(cfg32, batch=b, prompt_len=s,
                    decode_tokens=SERVE["decode_tokens"], seed=0, device=dev)
    torch.cuda.synchronize()
    f32_cnt = counts()
    print(f"  serve (f32): counts {f32_cnt}", flush=True)
    check_serve_run(torch, r32, f32_cnt, "f32 serve")
    on, off, kernel = attention_on_vs_off(torch, r32, cfg32)
    drift["f32"] = f32_gate(
        torch, on, off, kernel, "serve", prefill_ms=r32.stats["prefill_ms"],
        decode_ms_per_token=r32.stats["decode_ms_per_token"])
    del r32, on, off

    # sliding window shorter than the prompt: ring-cache decode
    swa_cfg = configs.long_context_config(SERVE["arch"]).replace(**SWA)
    zero_counts()
    sw = serve.run(swa_cfg, batch=b, prompt_len=s,
                   decode_tokens=SERVE["decode_tokens"], seed=0, device=dev)
    torch.cuda.synchronize()
    cnt = counts()
    check(sw.stats["k3_launches_per_prefill"] == SWA["n_layers"],
          f"swa: K3 launched {sw.stats['k3_launches_per_prefill']} times")
    check(cnt["plain_attention"] == 0, "swa: K3's plain version ran")
    check(bool(torch.isfinite(sw.logits).all()), "swa: logits not finite")
    # the ring decode's greedy tokens against one windowed forward (K3)
    # over the prompt and the tokens fed back
    with torch.no_grad():
        seq = torch.cat([sw.prompts, sw.tokens[:, :-1]], dim=1)
        full, _ = tfm.forward(sw.params, seq, swa_cfg)
    want = full[:, s - 1:].argmax(-1)
    ring_equal = float((want == sw.tokens).float().mean())
    print(f"  swa (2 layers, window {SWA['window']}, ring cache of "
          f"{SWA['window']} slots): {json.dumps(sw.stats)}; greedy tokens "
          f"equal to a full windowed forward at {ring_equal}", flush=True)
    check(ring_equal >= EQUAL_TOKENS_MIN,
          f"swa: ring decode agrees with the full forward at {ring_equal}")
    return st, main_cnt, f32_cnt, drift, {"equal_tokens": ring_equal,
                                          **sw.stats}


def ssd_on_vs_off(torch, res, cfg):
    """K4 on vs forced off on a serve run's weights and prompts: the first
    layer's mixer output (on, off), and the prefill logits of K4 against
    its plain version as (max |d|, max |logit|, share of equal greedy
    tokens)."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed, rmsnorm
    p0 = res.params["layers"][0]
    with torch.no_grad():
        h = rmsnorm(p0["ln1"], embed(res.params["embed"], res.prompts,
                                     cfg.compute_dtype), cfg.norm_eps)
        on, _ = ssm.ssd_apply(p0["mixer"], h, cfg)
        off, _ = ssm.ssd_apply(p0["mixer"], h, cfg, use_kernel=False)
        logits_off, _ = tfm.forward(res.params, res.prompts, cfg,
                                    use_kernel=False)
    kernel = (float((res.logits - logits_off).abs().max()),
              float(logits_off.abs().max()),
              float((res.logits.argmax(-1) == logits_off.argmax(-1))
                    .float().mean()))
    return on.float(), off.float(), kernel


def state_check(torch, res, cfg):
    """Share of the greedy tokens of prefill + recurrent decode that one
    prefill over the prompt and the fed-back tokens reproduces (mamba2's
    through K4, recurrentgemma's through its doubling scan and K3)."""
    from repro_torch.models import transformer as tfm
    with torch.no_grad():
        seq = torch.cat([res.prompts, res.tokens[:, :-1]], dim=1)
        full, _ = tfm.forward(res.params, seq, cfg)
    want = full[:, res.prompts.shape[1] - 1:].argmax(-1)
    return float((want == res.tokens).float().mean())


def phase_serve_ssd(torch, dev):
    """Phase 6: the Mamba-2 serve path at full width, K4 on vs forced off,
    prefill + recurrent decode against one prefill; then both checks on
    the same model in float32."""
    from repro_torch.launch import serve
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in SSD_SERVE.items()]
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    cnt = counts()
    cfg, st = res.cfg, res.stats
    n_layers = cfg.n_layers
    print(f"  mamba2 serve main path: counts {cnt}", flush=True)
    check(st["k4_launches_per_prefill"] == n_layers,
          f"K4 launched {st['k4_launches_per_prefill']} times in a prefill "
          f"of {n_layers} layers")
    check(cnt["ssd_scan"] == 2 * n_layers,            # warm-up + timed
          f"K4 launched {cnt['ssd_scan']} times in 2 prefills")
    check(cnt["plain_ssd"] == 0, "K4's plain version ran on the card")
    check(cnt["flash_attention"] == cnt["plain_attention"] == 0,
          "attention ran on the Mamba-2 path")
    check(cnt["ota_round_step"] == cnt["ota_aggregate"] == 0,
          "an OTA kernel ran on the serve path")
    b, s = SSD_SERVE["batch"], SSD_SERVE["prompt_len"]
    v = cfg.padded_vocab
    check(tuple(res.logits.shape) == (b, s, v), f"logits {res.logits.shape}")
    check(bool(torch.isfinite(res.logits).all()), "logits not finite")
    check(tuple(res.tokens.shape) == (b, SSD_SERVE["decode_tokens"]),
          f"tokens {res.tokens.shape}")
    check(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < v,
          "a token out of range")

    # bf16, the main path's weights: K4 forced off
    on, off, kernel = ssd_on_vs_off(torch, res, cfg)
    layer0_err = float((on - off).abs().max())
    check(bool((on - off).abs().le(ATTN_BF16_TOL["atol"]
                                   + ATTN_BF16_TOL["rtol"]
                                   * off.abs()).all()),
          f"layer 0 mixer, K4 on vs off: max |d| {layer0_err}")
    drift = {"bf16": {
        "layer0_mixer_max_abs_err": layer0_err,
        "layer0_mixer_max_abs": float(off.abs().max()),
        "logits_max_abs_diff": kernel[0], "logits_max_abs": kernel[1],
        "equal_next_tokens": kernel[2],
        "state_equal_tokens": state_check(torch, res, cfg)}}
    print(f"  mamba2 serve (bf16), K4 on vs off and prefill + decode vs one "
          f"prefill: {json.dumps(drift['bf16'])} (tolerance: layer 0 within "
          f"{ATTN_BF16_TOL}; the whole model's numbers are readings, held "
          f"in f32 below)", flush=True)
    del res, on, off

    # the same model in float32 (the same draw, unrounded)
    cfg32 = cfg.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    r32 = serve.run(cfg32, batch=b, prompt_len=s,
                    decode_tokens=SSD_SERVE["decode_tokens"], seed=0,
                    device=dev)
    on, off, kernel = ssd_on_vs_off(torch, r32, cfg32)
    layer0_err = float((on - off).abs().max())
    state_equal = state_check(torch, r32, cfg32)
    drift["f32"] = {
        "layer0_mixer_max_abs_err": layer0_err,
        "layer0_mixer_max_abs": float(off.abs().max()),
        "logits_max_abs_diff": kernel[0], "logits_max_abs": kernel[1],
        "equal_next_tokens": kernel[2],
        "state_equal_tokens": state_equal,
        "prefill_ms": r32.stats["prefill_ms"],
        "decode_ms_per_token": r32.stats["decode_ms_per_token"]}
    print(f"  mamba2 serve (f32), K4 on vs off and prefill + decode vs one "
          f"prefill: {json.dumps(drift['f32'])} (tolerance: layer 0 within "
          f"{SSD_SCALE_TOL} of its largest |output| + {SSD_REL_TOL['f32']} "
          f"relative; logits within {DRIFT_LOGITS_SHARE} of max |logit|, "
          f"greedy tokens equal at >= {EQUAL_TOKENS_MIN})", flush=True)
    check(bool(((on - off).abs() <= SSD_SCALE_TOL * off.abs().max()
                + SSD_REL_TOL["f32"] * off.abs()).all()),
          f"f32 layer 0 mixer, K4 on vs off: max |d| {layer0_err}")
    check(kernel[0] <= DRIFT_LOGITS_SHARE * kernel[1],
          f"f32 logits drift {kernel[0]} over {DRIFT_LOGITS_SHARE} x "
          f"{kernel[1]}")
    check(kernel[2] >= EQUAL_TOKENS_MIN, f"f32 equal next tokens {kernel[2]}")
    check(state_equal >= EQUAL_TOKENS_MIN,
          f"f32 recurrent decode agrees with one prefill at {state_equal}")
    return st, cnt, drift


def f32_gate(torch, on, off, kernel, label, layer=0, **extra):
    """Phase 6's f32 gate on a K3 on-vs-off reading, printed first (with
    ``extra``): the first attention layer's (``layer``) output within
    F32_TOL, the logits within DRIFT_LOGITS_SHARE of their largest
    magnitude, greedy tokens equal at >= EQUAL_TOKENS_MIN.  Returns the
    reading."""
    layer_err = float((on - off).abs().max())
    reading = {f"layer{layer}_attention_max_abs_err": layer_err,
               f"layer{layer}_attention_max_abs": float(off.abs().max()),
               "logits_max_abs_diff": kernel[0], "logits_max_abs": kernel[1],
               "equal_next_tokens": kernel[2], **extra}
    print(f"  {label} (f32), K3 on vs off: {json.dumps(reading)} "
          f"(tolerance: layer {layer} within {F32_TOL}; logits within "
          f"{DRIFT_LOGITS_SHARE} of max |logit|, greedy tokens equal at >= "
          f"{EQUAL_TOKENS_MIN} of positions)", flush=True)
    check(bool((on - off).abs().le(F32_TOL["atol"]
                                   + F32_TOL["rtol"] * off.abs()).all()),
          f"{label}: f32 layer {layer} attention, K3 on vs off: max |d| "
          f"{layer_err}")
    check(kernel[0] <= DRIFT_LOGITS_SHARE * kernel[1],
          f"{label}: f32 logits drift {kernel[0]} over "
          f"{DRIFT_LOGITS_SHARE} x {kernel[1]}")
    check(kernel[2] >= EQUAL_TOKENS_MIN,
          f"{label}: f32 equal next tokens {kernel[2]}")
    return reading


def serve_largest_batch(torch, dev, arch):
    """``launch.serve`` of ``arch`` at DENSE_SERVE, halving the batch while
    it runs out of device memory; returns (result, counts, peak bytes)."""
    import gc
    from repro_torch.launch import serve
    batch = DENSE_SERVE["batch"]
    while True:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        argv = [f"--arch={arch}", f"--batch={batch}",
                f"--prompt-len={DENSE_SERVE['prompt_len']}",
                f"--decode-tokens={DENSE_SERVE['decode_tokens']}"]
        try:
            res = serve.main(argv)
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e).splitlines()[0]
            del e
            print(f"  {arch}: batch {batch} x {DENSE_SERVE['prompt_len']} "
                  f"does not fit the card ({msg})", flush=True)
            check(batch > 1, f"{arch}: batch 1 does not fit the card")
            batch //= 2
            continue
        torch.cuda.synchronize()
        return res, counts(), torch.cuda.max_memory_allocated(dev)


def phase_dense_archs(torch, dev):
    """Phase 12: granite-8b, qwen2.5-14b and chameleon-34b served at full
    width and depth through K3, then K3 on vs off in f32 on their first
    layers."""
    import gc
    from repro_torch import configs
    from repro_torch.launch import serve
    out = {}
    for arch in DENSE_ARCHS:
        res, cnt, peak = serve_largest_batch(torch, dev, arch)
        print(f"  {arch} serve: counts {cnt}", flush=True)
        check_serve_run(torch, res, cnt, f"{arch} serve")
        st = dict(res.stats, peak_mem_gb=peak / 1e9,
                  batch_fits=res.stats["batch"] == DENSE_SERVE["batch"])
        del res
        gc.collect()
        torch.cuda.empty_cache()
        cfg32 = configs.get_config(arch).replace(
            param_dtype=torch.float32, compute_dtype=torch.float32,
            n_layers=DENSE_F32_LAYERS)
        zero_counts()
        r32 = serve.run(cfg32, batch=st["batch"],
                        prompt_len=DENSE_SERVE["prompt_len"],
                        decode_tokens=DENSE_F32_DECODE, seed=0, device=dev)
        torch.cuda.synchronize()
        check_serve_run(torch, r32, counts(), f"{arch} f32")
        on, off, kernel = attention_on_vs_off(torch, r32, cfg32)
        st["f32_drift"] = f32_gate(torch, on, off, kernel,
                                   f"{arch}, first {DENSE_F32_LAYERS} layers",
                                   layers=DENSE_F32_LAYERS)
        print(f"  {arch}: {json.dumps(st)}", flush=True)
        out[arch] = (st, cnt)
        del r32, on, off
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_train_run(np, res, cnt, n_layers, kernel, label):
    """A launch.train run: finite losses; K3 or K4 (``kernel``) once per
    layer in the held-out eval and never in training; the plain version
    once per layer in every training step's forward; nothing else."""
    steps = res.stats["steps"]
    check(len(res.losses) == steps and bool(np.all(np.isfinite(res.losses)))
          and bool(np.isfinite(res.held_out)),
          f"{label}: losses not finite: {res.losses[:3]}... "
          f"held out {res.held_out}")
    plain = "plain_attention" if kernel == "flash_attention" else "plain_ssd"
    other = "ssd_scan" if kernel == "flash_attention" else "flash_attention"
    check(cnt[kernel] == n_layers and res.stats[
        "k3_launches_eval" if kernel == "flash_attention"
        else "k4_launches_eval"] == n_layers,
          f"{label}: {kernel} launched {cnt[kernel]} times, not once per "
          f"layer of the eval ({n_layers})")
    check(res.stats["k3_launches_train"] == res.stats["k4_launches_train"]
          == 0, f"{label}: a kernel launched in training")
    check(cnt[plain] == steps * n_layers,
          f"{label}: the plain version ran {cnt[plain]} times, not once per "
          f"layer of {steps} training forwards")
    check(cnt[other] == 0 and cnt["ota_round_step"] == cnt["ota_aggregate"]
          == 0, f"{label}: another kernel ran: {cnt}")


def step_vs_explicit(torch, dev, scheme, gains, seq=128, n_layers=0,
                     arch="qwen1.5-0.5b"):
    """Phase 13 (b), 19 (d) and 20 (b): one full-width train step of
    ``arch`` in f32 (on its first ``n_layers`` layers when given, on each
    side of an encoder-decoder) at 1 x ``seq`` tokens a client (an
    encoder-decoder's batch (frames, tokens), its frames standard
    normals) against explicit per-client gradients, their OTA
    superposition sum_m s_m g_m plus noise_scale z (the same z) and the
    SGD step.  Returns the reading (the params' max abs error, the
    update's largest magnitude and its max abs error); the params are held
    at STEP_TOL."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models.param import param_leaves, trainable
    from repro_torch.models.registry import build_bundle
    from repro_torch.tasks.lm import client_batches
    cfg = configs.get_config(arch).replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers, **(
            {"encoder_layers": n_layers} if cfg.is_enc_dec else {}))
    bundle = build_bundle(cfg, dev)
    params = bundle.init(0)
    n, eta = len(gains), 0.02
    tokens = torch.as_tensor(client_batches(cfg.vocab_size, n, 1, seq, 1, 0)
                             [0].reshape(-1, seq + 1), device=dev).long()
    frames = torch.randn((n, seq, cfg.d_model), device=dev, generator=(
        torch.Generator(device=dev).manual_seed(0))) if cfg.is_enc_dec \
        else None

    def batch(rows):
        return tokens[rows] if frames is None else (frames[rows],
                                                    tokens[rows])
    leaves = param_leaves(params)
    draws = steps.DeviceStepDraws(1, gains, {k: v.shape for k, v in
                                             leaves.items()}, dev)(0)
    s, ns = scheme.round_coeffs(draws.h[None], draws.coin.reshape(1))
    s, ns = s[0], ns[0]
    agg = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for m in range(n):
        view, lv = trainable(params)
        with torch.enable_grad():
            loss_m = bundle.loss(view, batch(slice(m, m + 1)))
            grads = torch.autograd.grad(loss_m, list(lv.values()))
        for k, g in zip(lv, grads):
            agg[k] += s[m] * g
        del grads
    with torch.no_grad():
        want = {k: p - eta * (agg[k] + ns * draws.z[k])
                for k, p in leaves.items()}
        before = {k: p.clone() for k, p in leaves.items()}
    del agg
    step = steps.make_train_step(bundle, scheme, gains,
                                 steps.TrainStepConfig(eta=eta))
    _, metrics = step(params, batch(slice(None)), draws)
    torch.cuda.synchronize()
    got = param_leaves(params)
    ok, err, upd, upd_err = True, 0.0, 0.0, 0.0
    with torch.no_grad():
        for k, w in want.items():
            d = (got[k] - w).abs()
            ok &= bool((d <= STEP_TOL["atol"]
                        + STEP_TOL["rtol"] * w.abs()).all())
            err = max(err, float(d.max()))
            du = before[k] - w
            upd = max(upd, float(du.abs().max()))
            upd_err = max(upd_err, float(((before[k] - got[k]) - du).abs()
                                         .max()))
    reading = {"params_max_abs_err": err, "update_max_abs": upd,
               "update_max_abs_err": upd_err,
               "active_clients": float(metrics["active_clients"]),
               "noise_scale": float(metrics["noise_scale"]),
               "loss": float(metrics["loss"]), "layers": cfg.n_layers,
               "encoder_layers": cfg.encoder_layers, "seq": seq,
               "tol": STEP_TOL}
    check(ok, f"the weighted-loss step disagrees with the explicit "
          f"aggregation: {reading}")
    check(upd > 0, "the step moved no parameter")
    return params, bundle, reading


def eval_on_vs_off(torch, dev, bundle, params, kernel, seq=128):
    """Phase 13 (c) and 19 (c): the held-out eval (4 x (seq + 1) tokens of
    the task's stream) through K3 / K4 against the plain versions on the
    same f32 params: the loss, and the logits to phase 6's drift gate."""
    from repro_torch.models import transformer as tfm
    from repro_torch.tasks.lm import client_batches
    cfg = bundle.cfg
    test = torch.as_tensor(client_batches(cfg.vocab_size, 4, 1, seq, 2, 0)
                           [-1].reshape(-1, seq + 1), device=dev).long()
    with torch.no_grad():
        zero_counts()
        loss_on = float(bundle.loss(params, test, use_kernel=True))
        torch.cuda.synchronize()
        launches = counts()[kernel]
        loss_off = float(bundle.loss(params, test, use_kernel=False))
        on, _ = tfm.forward(params, test[:, :-1], cfg, use_kernel=True)
        off, _ = tfm.forward(params, test[:, :-1], cfg, use_kernel=False)
    reading = {"loss_kernel": loss_on, "loss_plain": loss_off,
               "launches": launches,
               "logits_max_abs_diff": float((on - off).abs().max()),
               "logits_max_abs": float(off.abs().max()),
               "equal_next_tokens": float((on.argmax(-1) == off.argmax(-1))
                                          .float().mean())}
    check(launches == cfg.n_layers,
          f"eval {cfg.name}: {kernel} launched {launches} times")
    check(abs(loss_on - loss_off) <= LM_EVAL_LOSS_RTOL * abs(loss_off),
          f"eval {cfg.name}: loss {loss_on} through the kernel, {loss_off} "
          "plain")
    check(reading["logits_max_abs_diff"]
          <= DRIFT_LOGITS_SHARE * reading["logits_max_abs"],
          f"eval {cfg.name}: logits drift {reading}")
    check(reading["equal_next_tokens"] >= EQUAL_TOKENS_MIN,
          f"eval {cfg.name}: equal next tokens {reading}")
    return reading


def phase_train(torch, np, dev, designs=None):
    """Phase 13: the LM train path at full width, the weighted-loss step
    against the explicit aggregation, the eval's kernels against their
    plain versions, and the trajectories against the reference's; every
    run on its design from ``designs`` (``start_designs``)."""
    import gc
    from repro_torch import configs, lm_curves
    from repro_torch.launch import train
    from repro_torch.models.registry import build_bundle
    out = {}
    # (a) the runs
    zero_counts()
    rq = train.main(list(TRAIN_QWEN),
                    design=made(designs, "qwen1.5-0.5b"))
    torch.cuda.synchronize()
    cq = counts()
    print(f"  qwen1.5-0.5b train: counts {cq}", flush=True)
    check_train_run(np, rq, cq, rq.task.aux["cfg"].n_layers,
                    "flash_attention", "qwen1.5-0.5b train")
    first, last = float(np.mean(rq.losses[:10])), float(
        np.mean(rq.losses[-10:]))
    check(last < first, f"qwen1.5-0.5b: the mean of the last 10 losses "
          f"{last} is not below the first 10's {first}")
    out["qwen"] = dict(rq.stats, first10=first, last10=last)
    scheme, gains = rq.scheme, rq.gains
    del rq
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    rm = train.main(list(TRAIN_MAMBA),
                    design=made(designs, "mamba2-1.3b"))
    torch.cuda.synchronize()
    cm = counts()
    print(f"  mamba2-1.3b train: counts {cm}", flush=True)
    check_train_run(np, rm, cm, rm.task.aux["cfg"].n_layers, "ssd_scan",
                    "mamba2-1.3b train")
    out["mamba2"] = rm.stats
    del rm
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the step against the explicit aggregation, (c) the eval's K3
    params, bundle, reading = step_vs_explicit(torch, dev, scheme, gains)
    print(f"  (b) f32 qwen step vs explicit per-client aggregation: "
          f"{json.dumps(reading)}", flush=True)
    out["step_vs_explicit"] = reading
    out["eval_k3"] = eval_on_vs_off(torch, dev, bundle, params,
                                    "flash_attention")
    print(f"  (c) f32 qwen eval, K3 on vs off: {json.dumps(out['eval_k3'])} "
          f"(loss within {LM_EVAL_LOSS_RTOL} relative; logits within "
          f"{DRIFT_LOGITS_SHARE} of max |logit|, greedy tokens equal at >= "
          f"{EQUAL_TOKENS_MIN})", flush=True)
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config("mamba2-1.3b").replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    bundle = build_bundle(cfg, dev)
    out["eval_k4"] = eval_on_vs_off(torch, dev, bundle, bundle.init(0),
                                    "ssd_scan")
    print(f"  (c) f32 mamba2 eval, K4 on vs off: "
          f"{json.dumps(out['eval_k4'])}", flush=True)
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the reference example's trajectories
    ref = lm_curves.load_reference(lm_curves.SEEDS)
    fa = lm_curves.false_alarm(ref, len(lm_curves.SEEDS))
    print(f"  (d) the gate's false-alarm rate at {len(lm_curves.SEEDS)} "
          f"seeds a side, from the reference's runs: {json.dumps(fa)}",
          flush=True)
    check(fa["any"] <= lm_curves.FALSE_ALARM_MAX,
          f"the LM gate's false-alarm rate {fa['any']} is over "
          f"{lm_curves.FALSE_ALARM_MAX}: widen it to more reference seeds")
    t0 = time.time()
    port = lm_curves.run_port(
        lm_curves.SEEDS, dev, jobs=len(lm_curves.SEEDS),
        designs=[made(designs, f"lm_curves seed {s}")
                 for s in lm_curves.SEEDS])
    rows = lm_curves.gate(port, ref)
    print(lm_curves.table(rows), flush=True)
    check(all(r["ok"] for r in rows), "the LM trajectories miss the "
          "reference's")
    out["curves"] = {"rows": rows, "false_alarm": fa,
                     "wall_s": time.time() - t0,
                     "step_ms": [p["stats"]["step_ms"] for p in port]}
    return out, cq, cm


def phase_recurrentgemma(torch, dev, card_line):
    """Phase 14: recurrentgemma-9b served at full width and depth in bf16
    through K3 at head_dim 256, K3 on vs off and prefill + recurrent decode
    against one prefill in f32 at full depth, and a run past the window
    through the ring cache."""
    import gc
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # (a) bf16, full width and depth, through the serve entry point
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in RGEMMA_SERVE.items()]
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    cnt = counts()
    cfg = res.cfg
    kinds = [kind for kind, _ in tfm.layer_sigs(cfg)]
    print(f"  recurrentgemma-9b serve: {kinds.count('rglru')} rglru and "
          f"{kinds.count('local')} local layers; counts {cnt}", flush=True)
    check(kinds.count("local") == 12 and kinds.count("rglru") == 26,
          f"recurrentgemma-9b's layers: {kinds}")
    check_serve_run(torch, res, cnt, "recurrentgemma-9b serve")
    st = dict(res.stats, peak_mem_gb=torch.cuda.max_memory_allocated(dev)
              / 1e9)
    # bf16, K3 forced off: the first local layer (layer 2) held to K3's
    # bf16 tolerance; the whole model's drift is a reading (bf16 layers
    # amplify an ulp, phase 7)
    on, off, kernel = attention_on_vs_off(torch, res, cfg)
    layer_err = float((on - off).abs().max())
    st["bf16_drift"] = {"layer2_attention_max_abs_err": layer_err,
                        "layer2_attention_max_abs": float(off.abs().max()),
                        "logits_max_abs_diff": kernel[0],
                        "logits_max_abs": kernel[1],
                        "equal_next_tokens": kernel[2]}
    print(f"  (a) recurrentgemma-9b (bf16, batch {RGEMMA_SERVE['batch']} x "
          f"{RGEMMA_SERVE['prompt_len']}) [{card_line}]: {json.dumps(st)} "
          f"(layer 2's attention, K3 on vs off, within {ATTN_BF16_TOL}; the "
          "logits' drift is a reading)", flush=True)
    check(bool((on - off).abs().le(ATTN_BF16_TOL["atol"]
                                   + ATTN_BF16_TOL["rtol"]
                                   * off.abs()).all()),
          f"recurrentgemma-9b: layer 2 attention, K3 on vs off: max |d| "
          f"{layer_err}")
    out["bf16"], out["bf16_counts"] = st, cnt
    del res, on, off
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same draw in float32 at full depth: K3's f32 kernel in every
    # local layer's prefill, on vs off to phase 6's f32 gate
    cfg32 = cfg.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    r32 = serve.run(cfg32, batch=RGEMMA_F32_BATCH,
                    prompt_len=RGEMMA_SERVE["prompt_len"],
                    decode_tokens=RGEMMA_SERVE["decode_tokens"], seed=0,
                    device=dev)
    torch.cuda.synchronize()
    f32_cnt = counts()
    check_serve_run(torch, r32, f32_cnt, "recurrentgemma-9b f32")
    on, off, kernel = attention_on_vs_off(torch, r32, cfg32)
    out["f32"] = f32_gate(
        torch, on, off, kernel, f"recurrentgemma-9b, {cfg32.n_layers} "
        f"layers, batch {RGEMMA_F32_BATCH}", layer=2, layers=cfg32.n_layers,
        batch=RGEMMA_F32_BATCH, prefill_ms=r32.stats["prefill_ms"],
        decode_ms_per_token=r32.stats["decode_ms_per_token"])
    out["f32_counts"] = f32_cnt
    del on, off
    # (c) the recurrence: prefill + recurrent decode (the doubling scan's
    # final state, the conv stash, the decode step) against one prefill
    # over the prompt and the fed-back tokens
    state_equal = state_check(torch, r32, cfg32)
    out["f32"]["state_equal_tokens"] = state_equal
    out["f32"]["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  (c) recurrentgemma-9b (f32): greedy tokens of prefill + "
          f"recurrent decode equal to one prefill's at {state_equal} "
          f"(gate {EQUAL_TOKENS_MIN}); peak {out['f32']['peak_mem_gb']:.2f} "
          f"GB [{card_line}]", flush=True)
    check(state_equal >= EQUAL_TOKENS_MIN,
          f"recurrentgemma-9b f32: recurrent decode agrees with one prefill "
          f"at {state_equal}")
    del r32
    gc.collect()
    torch.cuda.empty_cache()

    # (d) past the window: K3 takes window 2,048 at S 4,096, and the local
    # layers decode through their 2,048-slot ring caches
    ring_cfg = cfg32.replace(n_layers=RGEMMA_RING["n_layers"])
    b, s = RGEMMA_RING["batch"], RGEMMA_RING["prompt_len"]
    zero_counts()
    rr = serve.run(ring_cfg, batch=b, prompt_len=s,
                   decode_tokens=RGEMMA_RING["decode_tokens"], seed=0,
                   device=dev)
    torch.cuda.synchronize()
    ring_cnt = counts()
    check_serve_run(torch, rr, ring_cnt, "recurrentgemma ring")
    with torch.no_grad():
        seq = torch.cat([rr.prompts, rr.tokens[:, :-1]], dim=1)
        full, _ = tfm.forward(rr.params, seq, ring_cfg)
    ring_equal = float((full[:, s - 1:].argmax(-1) == rr.tokens).float()
                       .mean())
    out["ring"] = dict(rr.stats, equal_tokens=ring_equal,
                       layers=ring_cfg.n_layers, window=ring_cfg.window)
    print(f"  (d) recurrentgemma ({ring_cfg.n_layers} layers, f32, batch "
          f"{b} x {s}, window {ring_cfg.window}, ring caches of "
          f"{ring_cfg.window} slots): {json.dumps(out['ring'])}; greedy "
          f"tokens equal to a full windowed forward at {ring_equal} (gate "
          f"{EQUAL_TOKENS_MIN}) [{card_line}]", flush=True)
    check(ring_equal >= EQUAL_TOKENS_MIN,
          f"recurrentgemma ring decode agrees with the full forward at "
          f"{ring_equal}")
    del rr, full, seq
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seamless_on_vs_off(torch, params, cfg, frames, prompts, logits_on):
    """K3 on vs forced off on the encoder-decoder: the encoder's output;
    the first decoder layer on the same memory (the plain one) and the
    same embedded prompts; ``logits_on`` (the prefill's) against a plain
    pass.  Returns (readings, memory through K3)."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed
    with torch.no_grad():
        mem_on = encdec.encode(params, frames, cfg)
        mem_off = encdec.encode(params, frames, cfg, use_kernel=False)
        x = embed(params["embed"], prompts, cfg.compute_dtype)
        p0 = params["dec_layers"][0]
        l0_on, _, _ = tfm.apply_layer(p0, x, cfg, encdec.DEC_SIG,
                                      memory=mem_off)
        l0_off, _, _ = tfm.apply_layer(p0, x, cfg, encdec.DEC_SIG,
                                       memory=mem_off, use_kernel=False)
        logits_off = encdec.decode_train(params, mem_off, prompts, cfg,
                                         use_kernel=False)
    enc_tol = {k: v * cfg.encoder_layers for k, v in F32_TOL.items()}
    reading = {
        "memory_max_abs_err": float((mem_on - mem_off).abs().max()),
        "memory_max_abs": float(mem_off.abs().max()),
        "memory_ok": bool((mem_on - mem_off).abs().le(
            enc_tol["atol"] + enc_tol["rtol"] * mem_off.abs()).all()),
        "dec_layer0_max_abs_err": float((l0_on - l0_off).abs().max()),
        "dec_layer0_max_abs": float(l0_off.abs().max()),
        "dec_layer0_ok": bool((l0_on - l0_off).abs().le(
            F32_TOL["atol"] + F32_TOL["rtol"] * l0_off.abs()).all()),
        "logits_max_abs_diff": float((logits_on - logits_off).abs().max()),
        "logits_max_abs": float(logits_off.abs().max()),
        "equal_next_tokens": float((logits_on.argmax(-1)
                                    == logits_off.argmax(-1)).float()
                                   .mean())}
    del mem_off, x, l0_on, l0_off, logits_off
    return reading, mem_on


def seamless_gate(reading, label):
    """Phase 15's f32 gates on a ``seamless_on_vs_off`` reading."""
    print(f"  {label}, K3 on vs off: {json.dumps(reading)} (tolerance: the "
          f"memory within F32_TOL x {SEAMLESS_LAYERS[0]} layers, decoder "
          f"layer 0 within {F32_TOL}; logits within {SEAMLESS_DRIFT} of max "
          f"|logit|, greedy tokens equal at >= {SEAMLESS_TOKENS_MIN})",
          flush=True)
    check(reading["memory_ok"], f"{label}: the encoder's output, K3 on vs "
          f"off: max |d| {reading['memory_max_abs_err']}")
    check(reading["dec_layer0_ok"], f"{label}: decoder layer 0, K3 on vs "
          f"off: max |d| {reading['dec_layer0_max_abs_err']}")
    check(reading["logits_max_abs_diff"]
          <= SEAMLESS_DRIFT * reading["logits_max_abs"],
          f"{label}: logits drift {reading['logits_max_abs_diff']} over "
          f"{SEAMLESS_DRIFT} x {reading['logits_max_abs']}")
    check(reading["equal_next_tokens"] >= SEAMLESS_TOKENS_MIN,
          f"{label}: equal next tokens {reading['equal_next_tokens']}")


def phase_seamless(torch, dev, card_line):
    """Phase 15: seamless-m4t-medium served at full width and depth in
    bf16 through K3 (its encoder and cross-attention in K3's non-causal
    mode), then in f32 at full depth: K3 on vs off, a ragged cross case,
    and prefill + cached decode against one teacher-forced pass."""
    import gc
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.models.registry import build_bundle
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # (a) bf16, full width and depth, through the serve entry point
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in SEAMLESS_SERVE.items()]
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    cnt = counts()
    cfg = res.cfg
    check((cfg.encoder_layers, cfg.n_layers) == SEAMLESS_LAYERS,
          f"seamless-m4t-medium's layers: {cfg.encoder_layers} + "
          f"{cfg.n_layers}")
    n_attn = cfg.encoder_layers + 2 * cfg.n_layers
    n_noncausal = cfg.encoder_layers + cfg.n_layers
    print(f"  seamless-m4t-medium serve: {cfg.encoder_layers} encoder and "
          f"{cfg.n_layers} decoder layers; counts {cnt}", flush=True)
    check_serve_run(torch, res, cnt, "seamless-m4t-medium serve", n_attn)
    check(cnt["flash_attention_noncausal"] == 2 * n_noncausal,
          f"seamless-m4t-medium: {cnt['flash_attention_noncausal']} "
          f"non-causal K3 launches in 2 prefills, not {2 * n_noncausal}")
    st = dict(res.stats, peak_mem_gb=torch.cuda.max_memory_allocated(dev)
              / 1e9)
    print(f"  (a) seamless-m4t-medium (bf16, batch {SEAMLESS_SERVE['batch']} "
          f"x {SEAMLESS_SERVE['prompt_len']} frames and tokens) "
          f"[{card_line}]: prefill {st['prefill_ms']:.3f} ms, decode "
          f"{st['decode_ms_per_token']:.3f} ms per token, peak "
          f"{st['peak_mem_gb']:.2f} GB; {json.dumps(st)}", flush=True)
    out["bf16"], out["bf16_counts"] = st, cnt
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same draw in float32 at full depth: K3's f32 kernel in all 36
    # prefill attentions, on vs off
    cfg32 = cfg.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    r32 = serve.run(cfg32, batch=SEAMLESS_SERVE["batch"],
                    prompt_len=SEAMLESS_SERVE["prompt_len"],
                    decode_tokens=SEAMLESS_SERVE["decode_tokens"], seed=0,
                    device=dev)
    torch.cuda.synchronize()
    f32_cnt = counts()
    check_serve_run(torch, r32, f32_cnt, "seamless-m4t-medium f32", n_attn)
    check(f32_cnt["flash_attention_noncausal"] == 2 * n_noncausal,
          f"seamless-m4t-medium f32: {f32_cnt['flash_attention_noncausal']} "
          "non-causal K3 launches in 2 prefills")
    reading, mem_on = seamless_on_vs_off(torch, r32.params, cfg32, r32.frames,
                                         r32.prompts, r32.logits)
    reading.update(prefill_ms=r32.stats["prefill_ms"],
                   decode_ms_per_token=r32.stats["decode_ms_per_token"])
    seamless_gate(reading, f"(b) seamless-m4t-medium (f32, "
                  f"{cfg32.encoder_layers} + {cfg32.n_layers} layers, "
                  f"batch {SEAMLESS_SERVE['batch']} x "
                  f"{SEAMLESS_SERVE['prompt_len']})")
    out["f32"], out["f32_counts"] = reading, f32_cnt

    # (d) prefill + cached decode (self caches written in place, cross
    # caches read) against one teacher-forced pass over the prompt and the
    # fed-back tokens
    s = SEAMLESS_SERVE["prompt_len"]
    with torch.no_grad():
        seq = torch.cat([r32.prompts, r32.tokens[:, :-1]], dim=1)
        full = encdec.decode_train(r32.params, mem_on, seq, cfg32)
        want = full[:, s - 1:].argmax(-1)
    state_equal = float((want == r32.tokens).float().mean())
    del full, seq, want, mem_on
    out["f32"]["state_equal_tokens"] = state_equal
    print(f"  (d) seamless-m4t-medium (f32): greedy tokens of prefill + "
          f"cached decode equal to one teacher-forced pass at {state_equal} "
          f"(gate {SEAMLESS_STATE_TOKENS_MIN})", flush=True)
    check(state_equal >= SEAMLESS_STATE_TOKENS_MIN,
          f"seamless-m4t-medium f32: cached decode agrees with one "
          f"teacher-forced pass at {state_equal}")

    # (c) ragged cross: frames 1,000 and a prompt of 100 leave a ragged
    # tile on both sides of every cross-attention
    rg = SEAMLESS_RAGGED
    gen = torch.Generator(device=dev).manual_seed(2)
    frames = torch.randn((rg["batch"], rg["frames"], cfg32.d_model),
                         generator=gen, device=dev)
    prompts = torch.randint(0, cfg32.vocab_size, (rg["batch"],
                                                  rg["prompt_len"]),
                            generator=gen, device=dev)
    bundle = build_bundle(cfg32, dev)
    zero_counts()
    logits_on, _ = bundle.prefill(r32.params, (frames, prompts),
                                  bundle.init_caches(rg["batch"],
                                                     rg["prompt_len"]))
    torch.cuda.synchronize()
    rcnt = counts()
    check(rcnt["flash_attention"] == n_attn
          and rcnt["flash_attention_noncausal"] == n_noncausal
          and rcnt["plain_attention"] == 0,
          f"seamless ragged prefill: counts {rcnt}")
    ragged, _ = seamless_on_vs_off(torch, r32.params, cfg32, frames, prompts,
                                   logits_on)
    seamless_gate(ragged, f"(c) seamless-m4t-medium ragged (f32, batch "
                  f"{rg['batch']}, frames {rg['frames']}, prompt "
                  f"{rg['prompt_len']})")
    out["ragged"] = ragged
    out["f32"]["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  seamless-m4t-medium f32 peak {out['f32']['peak_mem_gb']:.2f} GB "
          f"[{card_line}]", flush=True)
    del r32, logits_on, frames, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def def_bytes(torch, defs):
    """Bytes of a nested def tree (dicts and lists of ``ParamDef``)."""
    from repro_torch.models.param import ParamDef
    if isinstance(defs, ParamDef):
        return defs.size * torch.empty((), dtype=defs.dtype).element_size()
    vals = defs.values() if isinstance(defs, dict) else defs
    return sum(def_bytes(torch, v) for v in vals)


def mixtral_reckoning(torch, cfg, batch, prompt_len, decode_tokens):
    """A serve run's device memory reckoned from its shapes, in bytes: the
    weights; the init's float32 draw of the largest leaf (an expert
    weight ``wi``); the prefill's transients, the experts' products
    ([B, E, cap, 2, F] and the gated [B, E, cap, F] twice, the dispatched
    rows and the experts' outputs [B, E, cap, D]) and the logits (in the
    compute dtype, then f32); the KV caches (ring caches of the window's
    slots)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    es = torch.empty((), dtype=cfg.compute_dtype).element_size()
    e, f, d = cfg.moe_num_experts, cfg.expert_d_ff, cfg.d_model
    slots = batch * e * moe.expert_capacity(cfg, prompt_len)
    cache_len = prompt_len + decode_tokens
    if cfg.window:
        cache_len = min(cache_len, cfg.window)
    r = {"weights": def_bytes(torch, tfm.model_defs(cfg)),
         "init_f32_leaf": 4 * e * d * 2 * f,
         "experts": es * slots * (4 * f + 2 * d),
         "logits": batch * prompt_len * cfg.padded_vocab * (4 + es),
         "caches": cfg.n_layers * 2 * batch * cache_len * cfg.n_kv_heads
         * cfg.resolved_head_dim * es}
    r["peak"] = r["weights"] + max(
        r["init_f32_leaf"], r["experts"] + r["logits"] + r["caches"])
    return r


def near_ties(torch, probs, k):
    """[..., k] bool: a route's top-k choices whose sorted probability lies
    within MIXTRAL_TIE of its neighbour's above or below (a rounding
    difference may swap them)."""
    top = torch.sort(probs, dim=-1, descending=True).values
    tie = (top[..., :-1] - top[..., 1:]) <= MIXTRAL_TIE
    return tie[..., :k] | torch.cat([torch.zeros_like(tie[..., :1]),
                                     tie[..., :k - 1]], -1)


def moe_layer_card_vs_cpu(torch, dev, cfg, batch, seq, y_share, aux_rtol,
                          label):
    """One MoE layer of ``cfg`` (f32, weights from seed 0, x from seed 3)
    on the card against the same call on the CPU, the CPU's experts on the
    card's routes (their slots are then the same function of the same
    integers): assignments dropped, slots and drops bitwise, the router's
    choices equal away from a near tie, y within ``y_share`` of its
    largest, aux within ``aux_rtol`` relative.  Returns the reading."""
    from repro_torch.models import moe
    from repro_torch.models.param import init_param_tree, map_named
    p = init_param_tree(moe.moe_def(cfg), 0, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)
    cpu = torch.device("cpu")
    pc = map_named(p, lambda _, t: t.to(cpu))
    with torch.no_grad():
        t0 = time.time()
        _, top_w, top_e, aux = moe.route(p, x, cfg)
        y, slot, keep = moe.experts(p, x, top_w, top_e, cfg)
        torch.cuda.synchronize()
        card_s = time.time() - t0
        t0 = time.time()
        cprobs, _, ctop_e, caux = moe.route(pc, x.to(cpu), cfg)
        cy, cslot, ckeep = moe.experts(pc, x.to(cpu), top_w.to(cpu),
                                       top_e.to(cpu), cfg)
        cpu_s = time.time() - t0
    near = near_ties(torch, cprobs, cfg.moe_top_k)
    route_differ = top_e.to(cpu) != ctop_e
    drop = {"experts": cfg.moe_num_experts, "top_k": cfg.moe_top_k,
            "shared": cfg.moe_shared_experts, "d_model": cfg.d_model,
            "expert_d_ff": cfg.expert_d_ff,
            "kept": int(keep.sum()), "dropped": int((~keep).sum()),
            "slot_equal": bool(torch.equal(slot.to(cpu), cslot)),
            "keep_equal": bool(torch.equal(keep.to(cpu), ckeep)),
            "y_max_abs_err": float((y.to(cpu) - cy).abs().max()),
            "y_max_abs": float(cy.abs().max()),
            "aux": float(aux), "aux_cpu": float(caux),
            "near_tie_assignments": int(near.sum()),
            "route_differ": int(route_differ.sum()),
            "route_differ_away_from_a_tie": int((route_differ & ~near)
                                                .sum()),
            "card_s": card_s, "cpu_s": cpu_s}
    print(f"  {label} one MoE layer (f32, capacity factor "
          f"{cfg.capacity_factor}, batch {batch} x {seq}), card vs CPU: "
          f"{json.dumps(drop)} (slots and drops bitwise; y within {y_share} "
          f"of its largest; aux within {aux_rtol} relative)", flush=True)
    check(drop["dropped"] > 0, f"{label} MoE layer: no assignment dropped "
          f"at capacity factor {cfg.capacity_factor}")
    check(drop["slot_equal"] and drop["keep_equal"],
          f"{label} MoE layer: slots or drops differ, card vs CPU")
    check(drop["route_differ_away_from_a_tie"] == 0,
          f"{label} MoE layer: the router's choices differ, card vs CPU, "
          "away from a near tie")
    check(drop["y_max_abs_err"] <= y_share * drop["y_max_abs"],
          f"{label} MoE layer: y differs by {drop['y_max_abs_err']}")
    check(abs(drop["aux"] - drop["aux_cpu"]) <= aux_rtol * abs(drop["aux_cpu"]),
          f"{label} MoE layer: aux {drop['aux']} vs {drop['aux_cpu']}")
    return drop


def mixtral_on_vs_off(torch, res, cfg):
    """K3 on vs forced off on a serve run of an MoE decoder, layer by
    layer on the same weights and prompts: layer 0's attention (on, off)
    on the same input; per layer, each pass's own expert choices, and how
    many differ away from a near tie (the K3 pass's sorted probabilities
    of a choice and its neighbour within MIXTRAL_TIE); the logits' drift
    and greedy tokens over every position.  The off pass dispatches on the
    K3 pass's choices, weighted by its own probabilities of them (the
    route's law: gathered, then normalized): a choice that flipped at a
    near tie would send its token to another expert, an O(1) move that
    reaches every later position of its row through the next layer's
    attention, and no tolerance could tell that from a fault of K3."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed, rmsnorm, unembed
    k = cfg.moe_top_k
    params = res.params
    reading, att = {"layers": []}, {}
    with torch.no_grad():
        x = embed(params["embed"], res.prompts, cfg.compute_dtype)
        xs = {True: x, False: x}
        for i, (kind, _) in enumerate(tfm.layer_sigs(cfg)):
            p = params["layers"][i]
            routes = {}
            for on in (True, False):
                h = rmsnorm(p["ln1"], xs[on], cfg.norm_eps)
                a, _ = attn.gqa_apply(p["mixer"], h, cfg, kind=kind,
                                      use_kernel=on)
                if i == 0:
                    att[on] = a
                xo = xs[on] + a
                h2 = rmsnorm(p["ln2"], xo, cfg.norm_eps)
                probs, top_w, top_e, _ = moe.route(p["ffn"], h2, cfg)
                routes[on] = (probs, top_e)
                if not on:
                    top_e = routes[True][1]
                    top_w = torch.gather(probs, -1, top_e)
                    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
                y, _, keep = moe.experts(p["ffn"], h2, top_w, top_e, cfg)
                xs[on] = xo + y
                if on:
                    dropped = int((~keep).sum())
            (probs, e_on), (_, e_off) = routes[True], routes[False]
            near = near_ties(torch, probs, k)
            differ = e_on != e_off
            reading["layers"].append({
                "near_tie_assignments": int(near.sum()),
                "differing_assignments": int(differ.sum()),
                "differing_away_from_a_tie": int((differ & ~near).sum()),
                "dropped_assignments": dropped})
        logits = {}
        for on in (True, False):
            h = rmsnorm(params["ln_f"], xs[on], cfg.norm_eps)
            logits[on] = unembed(params["unembed"], h, cfg)
        err = (att[True] - att[False]).abs()
        reading.update(
            layer0_attention_max_abs_err=float(err.max()),
            layer0_attention_ok=bool(err.le(F32_TOL["atol"] + F32_TOL["rtol"]
                                            * att[False].abs()).all()),
            logits_max_abs_diff=float((logits[True] - logits[False]).abs()
                                      .max()),
            logits_max_abs=float(logits[False].abs().max()),
            equal_next_tokens=float((logits[True].argmax(-1)
                                     == logits[False].argmax(-1))
                                    .float().mean()),
            prefill_logits_equal=bool(torch.equal(logits[True], res.logits)))
    return reading


def phase_mixtral(torch, np, dev, card_line, designs=None):
    """Phase 17: mixtral-8x22b served at full width on its first layers in
    bf16 through K3 (sliding window 4,096 at H 48 over KH 8); in f32 on two
    layers K3 on vs off, prefill + cached decode against one forward, and
    a run past the window through the ring caches; one MoE layer on the
    card against the CPU; and launch.train at two layers."""
    import gc
    from repro_torch import configs
    from repro_torch.launch import serve, train
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    out, t_part = {"seconds": {}}, [time.time()]

    def part_done(label):
        """Record the seconds since the last part ended."""
        now = time.time()
        out["seconds"][label] = round(now - t_part[0], 1)
        t_part[0] = now
    gc.collect()
    torch.cuda.empty_cache()
    base = configs.get_config(MIXTRAL_SERVE["arch"])
    b, s = MIXTRAL_SERVE["batch"], MIXTRAL_SERVE["prompt_len"]
    n_dec = MIXTRAL_SERVE["decode_tokens"]

    # (a) bf16 at full width on MIXTRAL_LAYERS layers, through serve.run
    total = torch.cuda.get_device_properties(dev).total_memory
    layers = MIXTRAL_LAYERS
    cfg = base.replace(n_layers=layers)
    rk = mixtral_reckoning(torch, cfg, b, s, n_dec)
    free = (total - rk["peak"]) / 1e9
    print(f"  (a) mixtral-8x22b memory reckoning at {layers} layers (full "
          f"width, bf16, batch {b} x {s}), GB: "
          f"{json.dumps({k: v / 1e9 for k, v in rk.items()})}; {free:.2f} "
          f"GB of the card's {total / 1e9:.2f} GB left free", flush=True)
    check(free >= MIXTRAL_FREE_MIN_GB, f"mixtral-8x22b: {layers} layers "
          f"leave {free:.2f} GB free, under {MIXTRAL_FREE_MIN_GB}")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    moe.experts.kept.clear()
    res = serve.run(cfg, batch=b, prompt_len=s, decode_tokens=n_dec,
                    seed=0, device=dev)
    torch.cuda.synchronize()
    cnt = counts()
    assignments = moe.kept_and_dropped()
    check(tfm.layer_sigs(cfg) == [("swa", "moe")] * layers,
          f"mixtral-8x22b's layers: {tfm.layer_sigs(cfg)}")
    check_serve_run(torch, res, cnt, "mixtral-8x22b serve")
    # experts calls: the warm-up prefill and decode step, the timed
    # prefill, then the timed decode steps, one per layer each
    check(len(assignments) == (n_dec + 2) * layers,
          f"mixtral-8x22b: {len(assignments)} experts calls")
    prefill = assignments[2 * layers:3 * layers]
    check(assignments[:layers] == prefill, "mixtral-8x22b: the warm-up "
          "and the timed prefill dispatched differently")
    check(all(d == 0 for _, d in assignments[layers:2 * layers]
              + assignments[3 * layers:]),
          "mixtral-8x22b: a decode step dropped an assignment")
    st = dict(res.stats, layers=layers,
              peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
              reckoned_peak_gb=rk["peak"] / 1e9,
              prefill_kept_dropped_per_layer=prefill)
    print(f"  (a) mixtral-8x22b ({layers} layers, bf16, batch {b} x {s}) "
          f"[{card_line}]: prefill {st['prefill_ms']:.3f} ms, decode "
          f"{st['decode_ms_per_token']:.3f} ms per token, peak "
          f"{st['peak_mem_gb']:.2f} GB; counts {cnt}; {json.dumps(st)}",
          flush=True)
    out["bf16"], out["bf16_counts"] = st, cnt
    del res
    gc.collect()
    torch.cuda.empty_cache()
    part_done("a")

    # (b) the same draw in f32 on the first layers, K3 on vs off
    cfg32 = base.replace(n_layers=MIXTRAL_F32_LAYERS,
                         param_dtype=torch.float32,
                         compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    r32 = serve.run(cfg32, batch=b, prompt_len=s, decode_tokens=n_dec,
                    seed=0, device=dev)
    torch.cuda.synchronize()
    f32_cnt = counts()
    check_serve_run(torch, r32, f32_cnt, "mixtral-8x22b f32")
    reading = mixtral_on_vs_off(torch, r32, cfg32)
    reading.update(prefill_ms=r32.stats["prefill_ms"],
                   decode_ms_per_token=r32.stats["decode_ms_per_token"])
    print(f"  (b) mixtral-8x22b (f32, {MIXTRAL_F32_LAYERS} layers, batch {b} "
          f"x {s}), K3 on vs off: {json.dumps(reading)} (tolerance: layer 0's "
          f"attention within {F32_TOL}; expert choices equal away from a "
          f"near tie of {MIXTRAL_TIE}; the pass without K3 on the K3 pass's "
          f"choices, logits within {MIXTRAL_DRIFT} of max |logit| at every "
          f"position; greedy tokens equal at >= "
          f"{MIXTRAL_TOKENS_MIN})", flush=True)
    check(reading["layer0_attention_ok"], f"mixtral-8x22b f32: layer 0 "
          f"attention, K3 on vs off: max |d| "
          f"{reading['layer0_attention_max_abs_err']}")
    check(all(r["differing_away_from_a_tie"] == 0
              for r in reading["layers"]),
          f"mixtral-8x22b f32: expert choices differ away from a near tie: "
          f"{reading['layers']}")
    check(reading["logits_max_abs_diff"]
          <= MIXTRAL_DRIFT * reading["logits_max_abs"],
          f"mixtral-8x22b f32: logits drift {reading['logits_max_abs_diff']}"
          f" over {MIXTRAL_DRIFT} x {reading['logits_max_abs']}")
    check(reading["equal_next_tokens"] >= MIXTRAL_TOKENS_MIN,
          f"mixtral-8x22b f32: equal next tokens "
          f"{reading['equal_next_tokens']}")
    out["f32"], out["f32_counts"] = reading, f32_cnt
    del r32
    gc.collect()
    torch.cuda.empty_cache()
    part_done("b")

    # (c) prefill + cached decode against one forward over the prompt and
    # the fed-back tokens.  A capacity drops an expert's assignments past
    # it by token order, so at the default factor one forward drops the
    # fed-back tokens first (the last in order), which a decode step (4
    # slots per expert for one token) never drops: the two are different
    # functions.  With a factor of E / K every slot a row can fill exists
    # (no drops), and they are the same function: that holds the caches
    nodrop = cfg32.replace(capacity_factor=cfg32.moe_num_experts
                           / cfg32.moe_top_k)
    zero_counts()
    moe.experts.kept.clear()
    rc = serve.run(nodrop, batch=b, prompt_len=s, decode_tokens=n_dec,
                   seed=0, device=dev)
    torch.cuda.synchronize()
    check_serve_run(torch, rc, counts(), "mixtral-8x22b f32, no drops")
    state_equal = state_check(torch, rc, nodrop)
    dropped = sum(d for _, d in moe.kept_and_dropped())
    out["f32"]["state_equal_tokens"] = state_equal
    out["f32"]["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  (c) mixtral-8x22b (f32, capacity factor "
          f"{nodrop.capacity_factor}: {dropped} assignments dropped): greedy "
          f"tokens of prefill + cached decode equal to one forward's at "
          f"{state_equal} (gate {MIXTRAL_STATE_TOKENS_MIN}); peak "
          f"{out['f32']['peak_mem_gb']:.2f} GB", flush=True)
    check(dropped == 0, f"mixtral-8x22b at capacity factor "
          f"{nodrop.capacity_factor}: {dropped} assignments dropped")
    check(state_equal >= MIXTRAL_STATE_TOKENS_MIN,
          f"mixtral-8x22b f32: cached decode agrees with one forward at "
          f"{state_equal}")
    del rc
    gc.collect()
    torch.cuda.empty_cache()
    part_done("c")

    # (d) past the window: K3 takes window 4,096 at S 8,192, and the swa
    # layers decode through their 4,096-slot ring caches (no drops, as (c))
    rb, rs = MIXTRAL_RING["batch"], MIXTRAL_RING["prompt_len"]
    zero_counts()
    rr = serve.run(nodrop, batch=rb, prompt_len=rs,
                   decode_tokens=MIXTRAL_RING["decode_tokens"], seed=0,
                   device=dev)
    torch.cuda.synchronize()
    ring_cnt = counts()
    check_serve_run(torch, rr, ring_cnt, "mixtral-8x22b ring")
    ring_equal = state_check(torch, rr, nodrop)
    out["ring"] = dict(rr.stats, equal_tokens=ring_equal,
                       layers=nodrop.n_layers, window=nodrop.window,
                       capacity_factor=nodrop.capacity_factor)
    out["ring_counts"] = ring_cnt
    print(f"  (d) mixtral-8x22b ({nodrop.n_layers} layers, f32, batch {rb} x "
          f"{rs}, window {nodrop.window}, ring caches of {nodrop.window} "
          f"slots): {json.dumps(out['ring'])}; greedy tokens equal to a "
          f"full windowed forward at {ring_equal} (gate "
          f"{EQUAL_TOKENS_MIN}) [{card_line}]", flush=True)
    check(ring_equal >= EQUAL_TOKENS_MIN,
          f"mixtral-8x22b ring decode agrees with the full forward at "
          f"{ring_equal}")
    del rr
    gc.collect()
    torch.cuda.empty_cache()
    part_done("d")

    # (e) one MoE layer at full width in f32, capacity factor 0.5 (drops),
    # on the card against the same call on the CPU; the CPU's experts take
    # the card's routes, so their slots are the same function of the same
    # integers
    dcfg = base.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32,
                        capacity_factor=MIXTRAL_DROP["capacity_factor"])
    out["drop"] = moe_layer_card_vs_cpu(
        torch, dev, dcfg, MIXTRAL_DROP["batch"], MIXTRAL_DROP["seq"],
        MIXTRAL_Y_SHARE, MIXTRAL_AUX_RTOL, "(e) mixtral-8x22b")
    gc.collect()
    torch.cuda.empty_cache()
    part_done("e")

    # (f) launch.train at one layer, full width, bf16: the loss takes the
    # router's aux term; K3 only in the held-out eval
    zero_counts()
    rt = train.main(list(TRAIN_MIXTRAL),
                    design=made(designs, "mixtral-8x22b"))
    torch.cuda.synchronize()
    tcnt = counts()
    tcfg = rt.task.aux["cfg"]
    print(f"  (f) mixtral-8x22b train: counts {tcnt}", flush=True)
    check_train_run(np, rt, tcnt, tcfg.n_layers, "flash_attention",
                    "mixtral-8x22b train")
    bundle = rt.task.aux["bundle"]
    test = torch.as_tensor(rt.task.build_data(0, steps=1).test,
                           device=dev).long()
    with torch.no_grad():
        logits, _, aux = tfm.forward_aux(rt.params, test[:, :-1], tcfg)
        xent = float(tfm.softmax_xent(logits, test[:, 1:], tcfg.padded_vocab))
        loss = float(bundle.loss(rt.params, test, use_kernel=True))
    aux = float(aux)
    with_aux = xent + tcfg.router_aux_weight * aux
    out["train"] = dict(rt.stats, eval_aux=aux, eval_xent=xent,
                        eval_loss=loss)
    print(f"  (f) mixtral-8x22b train ({tcfg.n_layers} layers) "
          f"[{card_line}]: {json.dumps(out['train'])}; the eval loss "
          f"{loss} = cross-entropy {xent} + {tcfg.router_aux_weight} x aux "
          f"{aux}", flush=True)
    check(np.isfinite(aux) and aux > 0, f"mixtral-8x22b train: aux {aux}")
    check(abs(loss - with_aux) <= 1e-5 * abs(with_aux),
          f"mixtral-8x22b train: the loss {loss} is not the cross-entropy "
          f"plus the aux term {with_aux}")
    out["train_counts"] = tcnt
    part_done("f")
    print(f"  seconds per part of phase 17: {json.dumps(out['seconds'])}",
          flush=True)
    del rt, bundle, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out



def deepseek_reckoning(torch, cfg, batch, prompt_len, decode_tokens):
    """``mixtral_reckoning``'s terms for an MLA + MoE model, with the
    caches its latents ([B, L, kv_lora_rank + rope] a layer), and the
    prefill's MLA transients (the expanded q and k [B, S, H, nope + rope],
    k_nope and v [B, S, H, v]) and the combine's [B, S, K, D] twice beside
    the experts' and the logits."""
    r = mixtral_reckoning(torch, cfg, batch, prompt_len, decode_tokens)
    es = torch.empty((), dtype=cfg.compute_dtype).element_size()
    tokens = batch * prompt_len
    r["caches"] = (cfg.n_layers * batch * (prompt_len + decode_tokens)
                   * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * es)
    r["attention"] = es * tokens * cfg.n_heads * 2 * (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
    r["combine"] = 2 * es * tokens * cfg.moe_top_k * cfg.d_model
    r["peak"] = r["weights"] + max(
        r["init_f32_leaf"], r["experts"] + r["combine"] + r["attention"]
        + r["logits"] + r["caches"])
    return r


def mla_forms(torch, res, cfg):
    """Layer 0's MLA on a serve run's prompts and first generated token:
    the token decoded in the weight-absorbed form against the latent cache
    of a prefill of the prompts (K3), against row S of one expanded
    prefill (K3) over the prompts and that token.  Returns (max |d|, max
    |expanded row|)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import embed, rmsnorm
    p = res.params["layers"][0]
    b, s = res.prompts.shape
    with torch.no_grad():
        seq = torch.cat([res.prompts, res.tokens[:, :1]], dim=1)
        h = rmsnorm(p["ln1"], embed(res.params["embed"], seq,
                                    cfg.compute_dtype), cfg.norm_eps)
        cache = attn.init_mla_cache(cfg, b, s + 1, h.device)
        attn.mla_apply(p["mixer"], h[:, :s], cfg, cache=cache)
        absorbed, _ = attn.mla_apply(p["mixer"], h[:, s:], cfg, pos_offset=s,
                                     cache=cache, decode=True)
        expanded, _ = attn.mla_apply(p["mixer"], h, cfg)
        row = expanded[:, s:]
    return float((absorbed - row).abs().max()), float(row.abs().max())


def phase_deepseek(torch, np, dev, card_line, designs=None):
    """Phase 18: deepseek-v3-671b served at full width on its first layers
    in bf16, MLA's prefill through K3's (192, 128) instance; in f32 on two
    layers K3 on vs off, prefill + absorbed decode against one forward and
    the absorbed decode against the expanded form; one MoE layer on the
    card against the CPU; and launch.train at two layers with the MTP
    term."""
    import gc
    from repro_torch import configs
    from repro_torch.launch import serve, train
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    out, t_part = {"seconds": {}}, [time.time()]

    def part_done(label):
        """Record the seconds since the last part ended."""
        now = time.time()
        out["seconds"][label] = round(now - t_part[0], 1)
        t_part[0] = now
    gc.collect()
    torch.cuda.empty_cache()
    base = configs.get_config(DEEPSEEK_SERVE["arch"])
    b, s = DEEPSEEK_SERVE["batch"], DEEPSEEK_SERVE["prompt_len"]
    n_dec = DEEPSEEK_SERVE["decode_tokens"]

    # (a) bf16 at full width on DEEPSEEK_LAYERS layers, through serve.run
    total = torch.cuda.get_device_properties(dev).total_memory
    layers = DEEPSEEK_LAYERS
    cfg = base.replace(n_layers=layers)
    rk = deepseek_reckoning(torch, cfg, b, s, n_dec)
    free = (total - rk["peak"]) / 1e9
    print(f"  (a) deepseek-v3-671b memory reckoning at {layers} layers (full "
          f"width, bf16, batch {b} x {s}), GB: "
          f"{json.dumps({k: v / 1e9 for k, v in rk.items()})}; {free:.2f} "
          f"GB of the card's {total / 1e9:.2f} GB left free", flush=True)
    check(free >= DEEPSEEK_FREE_MIN_GB, f"deepseek-v3-671b: {layers} layers "
          f"leave {free:.2f} GB free, under {DEEPSEEK_FREE_MIN_GB}")
    sigs = tfm.layer_sigs(cfg)
    moe_layers = sum(ffn == "moe" for _, ffn in sigs)
    check(sigs == [("attn", "dense")] * cfg.moe_first_dense
          + [("attn", "moe")] * (layers - cfg.moe_first_dense),
          f"deepseek-v3-671b's layers: {sigs}")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    moe.experts.kept.clear()
    res = serve.run(cfg, batch=b, prompt_len=s, decode_tokens=n_dec,
                    seed=0, device=dev)
    torch.cuda.synchronize()
    cnt = counts()
    assignments = moe.kept_and_dropped()
    check_serve_run(torch, res, cnt, "deepseek-v3-671b serve")
    # experts calls: the warm-up prefill and decode step, the timed
    # prefill, then the timed decode steps, one per MoE layer each
    check(len(assignments) == (n_dec + 2) * moe_layers,
          f"deepseek-v3-671b: {len(assignments)} experts calls")
    prefill = assignments[2 * moe_layers:3 * moe_layers]
    check(assignments[:moe_layers] == prefill, "deepseek-v3-671b: the "
          "warm-up and the timed prefill dispatched differently")
    st = dict(res.stats, layers=layers,
              peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
              reckoned_peak_gb=rk["peak"] / 1e9,
              prefill_kept_dropped_per_moe_layer=prefill,
              decode_dropped=sum(d for _, d in assignments[moe_layers:
                                                           2 * moe_layers]
                                 + assignments[3 * moe_layers:]))
    print(f"  (a) deepseek-v3-671b ({layers} layers, bf16, batch {b} x {s}) "
          f"[{card_line}]: prefill {st['prefill_ms']:.3f} ms, decode "
          f"{st['decode_ms_per_token']:.3f} ms per token, peak "
          f"{st['peak_mem_gb']:.2f} GB; counts {cnt}; {json.dumps(st)}",
          flush=True)
    out["bf16"], out["bf16_counts"] = st, cnt
    del res
    gc.collect()
    torch.cuda.empty_cache()
    part_done("a")

    # (b) the same draw in f32 on the first layers (dense: no routing), K3
    # on vs off
    fb = DEEPSEEK_F32["batch"]
    cfg32 = base.replace(n_layers=DEEPSEEK_F32["n_layers"],
                         param_dtype=torch.float32,
                         compute_dtype=torch.float32)
    check(all(ffn == "dense" for _, ffn in tfm.layer_sigs(cfg32)),
          "deepseek-v3-671b f32: an MoE layer in the first layers")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    r32 = serve.run(cfg32, batch=fb, prompt_len=s, decode_tokens=n_dec,
                    seed=0, device=dev)
    torch.cuda.synchronize()
    f32_cnt = counts()
    check_serve_run(torch, r32, f32_cnt, "deepseek-v3-671b f32")
    on, off, kernel = attention_on_vs_off(torch, r32, cfg32)
    err = (on - off).abs()
    reading = {"layer0_attention_max_abs_err": float(err.max()),
               "layer0_attention_max_abs": float(off.abs().max()),
               "layer0_attention_ok": bool(err.le(
                   F32_TOL["atol"] + F32_TOL["rtol"] * off.abs()).all()),
               "logits_max_abs_diff": kernel[0], "logits_max_abs": kernel[1],
               "equal_next_tokens": kernel[2],
               "prefill_ms": r32.stats["prefill_ms"],
               "decode_ms_per_token": r32.stats["decode_ms_per_token"]}
    del on, off, err
    print(f"  (b) deepseek-v3-671b (f32, {cfg32.n_layers} layers, batch {fb} "
          f"x {s}), K3 on vs off: {json.dumps(reading)} (tolerance: layer "
          f"0's attention within {F32_TOL}; logits within {DEEPSEEK_DRIFT} "
          f"of max |logit|; greedy tokens equal at >= "
          f"{DEEPSEEK_TOKENS_MIN})", flush=True)
    check(reading["layer0_attention_ok"], f"deepseek-v3-671b f32: layer 0 "
          f"attention, K3 on vs off: max |d| "
          f"{reading['layer0_attention_max_abs_err']}")
    check(kernel[0] <= DEEPSEEK_DRIFT * kernel[1], f"deepseek-v3-671b f32: "
          f"logits drift {kernel[0]} over {DEEPSEEK_DRIFT} x {kernel[1]}")
    check(kernel[2] >= DEEPSEEK_TOKENS_MIN,
          f"deepseek-v3-671b f32: equal next tokens {kernel[2]}")
    part_done("b")

    # (c) on the same run: prefill + absorbed decode against one forward
    # over the prompt and the fed-back tokens, and one layer's absorbed
    # decode against the expanded form's row
    state_equal = state_check(torch, r32, cfg32)
    forms = mla_forms(torch, r32, cfg32)
    reading.update(state_equal_tokens=state_equal,
                   forms_max_abs_err=forms[0], forms_max_abs=forms[1],
                   peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"  (c) deepseek-v3-671b (f32): greedy tokens of prefill + "
          f"absorbed decode equal to one forward's at {state_equal} (gate "
          f"{DEEPSEEK_STATE_TOKENS_MIN}); layer 0's absorbed decode of token "
          f"{s} against the expanded form's row: max |d| {forms[0]} of "
          f"{forms[1]} (gate {DEEPSEEK_FORMS_SHARE} of it); peak "
          f"{reading['peak_mem_gb']:.2f} GB", flush=True)
    check(state_equal >= DEEPSEEK_STATE_TOKENS_MIN,
          f"deepseek-v3-671b f32: cached decode agrees with one forward at "
          f"{state_equal}")
    check(forms[0] <= DEEPSEEK_FORMS_SHARE * forms[1],
          f"deepseek-v3-671b f32: absorbed decode vs expanded form {forms}")
    out["f32"], out["f32_counts"] = reading, f32_cnt
    del r32
    gc.collect()
    torch.cuda.empty_cache()
    part_done("c")

    # (d) one MoE layer at full width but the expert width, in f32 at
    # capacity factor 0.5 (drops), on the card against the same call on the
    # CPU; the CPU's experts take the card's routes
    dcfg = base.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32,
                        capacity_factor=DEEPSEEK_DROP["capacity_factor"],
                        moe_d_ff=DEEPSEEK_DROP["moe_d_ff"])
    out["drop"] = moe_layer_card_vs_cpu(
        torch, dev, dcfg, DEEPSEEK_DROP["batch"], DEEPSEEK_DROP["seq"],
        DEEPSEEK_Y_SHARE, DEEPSEEK_AUX_RTOL, "(d) deepseek-v3-671b")
    gc.collect()
    torch.cuda.empty_cache()
    part_done("d")

    # (e) launch.train at two layers (dense), full width, bf16: the loss
    # takes the MTP term; K3 only in the held-out eval, for the 2 layers
    # and the MTP head's layer
    zero_counts()
    rt = train.main(list(TRAIN_DEEPSEEK),
                    design=made(designs, "deepseek-v3-671b"))
    torch.cuda.synchronize()
    tcnt = counts()
    tcfg = rt.task.aux["cfg"]
    attn_layers = tcfg.n_layers + tcfg.mtp_depth
    print(f"  (e) deepseek-v3-671b train: counts {tcnt}", flush=True)
    check_train_run(np, rt, tcnt, attn_layers, "flash_attention",
                    "deepseek-v3-671b train")
    bundle = rt.task.aux["bundle"]
    test = torch.as_tensor(rt.task.build_data(0, steps=1).test,
                           device=dev).long()
    inputs, labels = test[:, :-1], test[:, 1:]
    with torch.no_grad():
        logits, _, aux, h = tfm.forward_aux(rt.params, inputs, tcfg,
                                            return_hidden=True)
        xent = float(tfm.softmax_xent(logits, labels, tcfg.padded_vocab))
        mtp = tfm.mtp_logits(rt.params, h, inputs, tcfg)
        mtp_xent = float(tfm.softmax_xent(mtp[:, :labels.shape[1] - 2],
                                          labels[:, 2:], tcfg.padded_vocab))
        loss = float(bundle.loss(rt.params, test, use_kernel=True))
    aux = float(aux)
    want = xent + tcfg.router_aux_weight * aux \
        + tcfg.mtp_loss_weight * mtp_xent
    out["train"] = dict(rt.stats, eval_xent=xent, eval_mtp_xent=mtp_xent,
                        eval_aux=aux, eval_loss=loss)
    print(f"  (e) deepseek-v3-671b train ({tcfg.n_layers} layers + MTP) "
          f"[{card_line}]: {json.dumps(out['train'])}; the eval loss {loss} "
          f"= cross-entropy {xent} + {tcfg.router_aux_weight} x aux {aux} + "
          f"{tcfg.mtp_loss_weight} x MTP cross-entropy {mtp_xent}",
          flush=True)
    check(np.isfinite(mtp_xent) and mtp_xent > 0,
          f"deepseek-v3-671b train: MTP cross-entropy {mtp_xent}")
    check(abs(loss - want) <= 1e-5 * abs(want),
          f"deepseek-v3-671b train: the loss {loss} is not the cross-entropy "
          f"plus the MTP term {want}")
    out["train_counts"] = tcnt
    part_done("e")
    print(f"  seconds per part of phase 18: {json.dumps(out['seconds'])}",
          flush=True)
    del rt, bundle, logits, h, mtp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_reckoning(torch, cfg, clients, seq):
    """A ``launch.train`` step's device memory reckoned from its shapes, in
    bytes, at ``clients`` x 1 x ``seq`` tokens: the weights; the step's f32
    noise draws (one z per leaf); the gradients and their noisy copy;
    what the forward keeps for the backward, by layer kind (an attention
    layer's q, k, v, f32 output and row statistics, and one key block's
    scores, p and their gradients while it runs; an RG-LRU layer's f32
    gates and the doubling scan's two f32 levels a step, log2 S steps;
    the FFN's four [T, F] products; the residual stream's f32 norms, two
    a sublayer); the loss head's one chunk of f32 logits five times over
    (the softcap, the log-sum-exp and their gradients).  An
    encoder-decoder (``clients`` x ``seq`` frames and tokens) counts the
    encoder's self-attentions and the decoder's self- and
    cross-attentions (a third sublayer a decoder layer), and the
    encoder's output, which every cross-attention's backward reads.  The
    peak is the largest of the forward's end (weights, noise,
    activations, the head and the unembedding's gradient) and the step's
    end (weights, noise, two gradient trees and the SGD update's f32
    copies of the largest leaf)."""
    import math
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import _map_defs
    es = torch.empty((), dtype=cfg.compute_dtype).element_size()
    defs = encdec.encdec_defs(cfg) if cfg.is_enc_dec else tfm.model_defs(cfg)
    weights = def_bytes(torch, defs)
    sizes = []
    _map_defs(defs, lambda d: sizes.append(d.size))
    n_params = sum(sizes)
    d, dh, h, kh = (cfg.d_model, cfg.resolved_head_dim, cfg.n_heads,
                    cfg.n_kv_heads)
    tokens = clients * seq
    if cfg.is_enc_dec:
        n_layers = cfg.encoder_layers + cfg.n_layers
        n_attn, n_rglru = cfg.encoder_layers + 2 * cfg.n_layers, 0
        sublayers = 2 * cfg.encoder_layers + 3 * cfg.n_layers
        memory = tokens * d * es
    else:
        kinds = [kind for kind, _ in tfm.layer_sigs(cfg)]
        n_layers, n_attn = len(kinds), sum(k != "rglru" for k in kinds)
        n_rglru, sublayers, memory = n_layers - n_attn, 2 * n_layers, 0
    w = cfg.lru_width or d
    attn = tokens * (h * dh * es + 2 * kh * dh * es + h * dh * 4 + h * 8)
    block = 5 * 4 * tokens * h * 1024
    rglru = 4 * tokens * w * (6 + 2 * math.ceil(math.log2(seq)))
    ffn = 4 * tokens * cfg.d_ff * es
    resid = 2 * tokens * d * 4
    r = {"weights": weights, "noise": 4 * n_params,
         "activations": n_attn * attn + n_rglru * rglru + n_layers * ffn
         + sublayers * resid + memory + (block if n_attn else 0),
         "head": 5 * 4 * tfm.HEAD_CHUNK * cfg.padded_vocab,
         "unembed_grad": cfg.padded_vocab * d * es,
         "grads": 2 * weights, "sgd_f32": 3 * 4 * max(sizes)}
    r["peak"] = r["weights"] + r["noise"] + max(
        r["activations"] + r["head"] + r["unembed_grad"],
        r["grads"] + r["sgd_f32"])
    return r


def blocked_vs_direct(torch, dev, label, h, kh, dh, window, seq):
    """Phase 19 (b): one case of the blocked form against the direct form
    on the card in f32, B 1: forward and gradients; each form's forward +
    backward time (a host clock between synchronizations, the median of
    3 after one warm-up) and its peak memory over the inputs."""
    import statistics
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(seq + h + dh)
    q, k, v, cot = (torch.randn(shape, generator=gen, device=dev)
                    for shape in ((1, seq, h, dh), (1, seq, kh, dh),
                                  (1, seq, kh, dh), (1, seq, h, dh)))
    pos = torch.arange(seq, device=dev)
    res = {}
    for name, form in (("direct", ref.grouped_attention),
                       ("blocked", ref.grouped_attention_blocked)):
        walls = []
        for _ in range(4):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out = form(*leaves, pos, pos, causal=True, window=window)
            grads = torch.autograd.grad((out * cot).sum(), leaves)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated(dev) - base
        res[name] = (out.detach(), grads, 1e3 * statistics.median(walls[1:]),
                     peak)
    out_d, grads_d, ms_d, peak_d = res["direct"]
    out_b, grads_b, ms_b, peak_b = res["blocked"]
    out_ok = bool((out_b - out_d).abs().le(
        F32_TOL["atol"] + F32_TOL["rtol"] * out_d.abs()).all())
    grad_err, grad_ok = {}, True
    for name, gb, gd in zip("qkv", grads_b, grads_d):
        tol = GRAD_RTOL * gd.abs() + GRAD_ATOL_SHARE * gd.abs().max()
        grad_ok &= bool((gb - gd).abs().le(tol).all())
        grad_err[f"d{name}_max_abs_err"] = float((gb - gd).abs().max())
        grad_err[f"d{name}_max_abs"] = float(gd.abs().max())
    reading = {"label": label, "h": h, "kh": kh, "dh": dh, "window": window,
               "seq": seq,
               "out_max_abs_err": float((out_b - out_d).abs().max()),
               "out_max_abs": float(out_d.abs().max()), **grad_err,
               "direct_fwd_bwd_ms": ms_d, "blocked_fwd_bwd_ms": ms_b,
               "direct_peak_gb": peak_d / 1e9,
               "blocked_peak_gb": peak_b / 1e9}
    check(out_ok, f"blocked vs direct form, {label}: the output is not "
          f"within {F32_TOL}: {reading}")
    check(grad_ok, f"blocked vs direct form, {label}: a gradient is not "
          f"within {GRAD_RTOL} + {GRAD_ATOL_SHARE} of its largest: "
          f"{reading}")
    check(peak_b < peak_d, f"blocked vs direct form, {label}: the blocked "
          f"peak is not lower: {reading}")
    return reading


def long_argv(arch, layers):
    """launch.train's argv of a phase 19 run: 4 clients x 1 x 4,096
    tokens, LONG_STEPS steps, the first ``layers`` layers (0: all)."""
    from repro_torch import configs
    argv = ["--arch", arch, "--seq", str(configs.TRAIN_4K.seq_len),
            "--steps", str(LONG_STEPS), "--clients", "4"]
    return argv + (["--layers", str(layers)] if layers else [])


def phase_long_train(torch, np, dev, card_line, designs=None):
    """Phase 19: training at train_4k's 4,096 tokens through the blocked
    form, both runs' evals through K3 at S 4,096; the blocked form against
    the direct form on the card; qwen's eval K3 on vs off at S 4,096; the
    f32 step at 4 x 4,096 against the explicit aggregation."""
    import gc
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_bundle
    seq = configs.TRAIN_4K.seq_len
    out, t_part = {"seconds": {}}, [time.time()]

    def part_done(label):
        """Record the seconds since the last part ended."""
        now = time.time()
        out["seconds"][label] = round(now - t_part[0], 1)
        t_part[0] = now

    # (a) the two runs
    total = torch.cuda.get_device_properties(dev).total_memory
    for arch, layers in (("qwen1.5-0.5b", 0),
                         ("recurrentgemma-9b", LONG_RGEMMA_LAYERS)):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = configs.get_config(arch)
        cfg = cfg.replace(n_layers=layers) if layers else cfg
        clients = 4
        rk = train_reckoning(torch, cfg, clients, seq)
        print(f"  (a) {arch} ({cfg.n_layers} layers, full width, bf16, "
              f"{clients} x {seq}) memory reckoning, GB: "
              f"{json.dumps({k: v / 1e9 for k, v in rk.items()})} of the "
              f"card's {total / 1e9:.2f} GB", flush=True)
        zero_counts()
        res = train.main(long_argv(arch, layers),
                         design=made(designs, arch))
        torch.cuda.synchronize()
        cnt = counts()
        attn_layers = sum(kind != "rglru" for kind, _ in tfm.layer_sigs(cfg))
        check_train_run(np, res, cnt, attn_layers, "flash_attention",
                        f"{arch} train at {seq}")
        check(res.losses[-1] < res.losses[0], f"{arch} at {seq}: the last "
              f"step's loss {res.losses[-1]} is not below the first's "
              f"{res.losses[0]}")
        st = dict(res.stats, layers=cfg.n_layers, attention_layers=attn_layers,
                  reckoned_peak_gb=rk["peak"] / 1e9,
                  reckoning_gb={k: v / 1e9 for k, v in rk.items()})
        print(f"  (a) {arch} train at {clients} x {seq} [{card_line}]: step "
              f"{st['step_ms']:.1f} ms, {st['tokens_per_s']:.1f} tokens/s, "
              f"peak {st['peak_mem_gb']:.2f} GB (reckoned "
              f"{st['reckoned_peak_gb']:.2f}); losses {res.losses}; counts "
              f"{cnt}; {json.dumps(st)}", flush=True)
        out[arch], out[f"{arch}_counts"] = st, cnt
        if arch == "qwen1.5-0.5b":
            scheme, gains = res.scheme, res.gains
        del res
        part_done(arch)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the blocked form against the direct form, f32
    out["forms"] = []
    for label, h, kh, dh, window in LONG_FORMS:
        reading = blocked_vs_direct(torch, dev, label, h, kh, dh, window, seq)
        print(f"  (b) blocked vs direct form, f32, B 1, S {seq}, {label} "
              f"[{card_line}]: {json.dumps(reading)}", flush=True)
        out["forms"].append(reading)
        gc.collect()
        torch.cuda.empty_cache()
    part_done("b")

    # (c) qwen's eval in f32 at S 4,096, K3 on vs off (the blocked form)
    cfg = configs.get_config("qwen1.5-0.5b").replace(
        n_layers=LONG_EVAL_LAYERS, param_dtype=torch.float32,
        compute_dtype=torch.float32)
    bundle = build_bundle(cfg, dev)
    zero_counts()
    out["eval_k3"] = eval_on_vs_off(torch, dev, bundle, bundle.init(0),
                                    "flash_attention", seq=seq)
    cnt = counts()
    check(cnt["plain_attention"] >= LONG_EVAL_LAYERS,
          f"qwen f32 eval at {seq}: the plain attention ran "
          f"{cnt['plain_attention']} times")
    print(f"  (c) f32 qwen eval ({LONG_EVAL_LAYERS} layers, 4 x {seq}), K3 "
          f"on vs off (the blocked form): {json.dumps(out['eval_k3'])} (loss "
          f"within {LM_EVAL_LOSS_RTOL} relative; logits within "
          f"{DRIFT_LOGITS_SHARE} of max |logit|)", flush=True)
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    part_done("c")

    # (d) the f32 step at 4 x 4,096 against the explicit aggregation, with
    # the qwen run's scheme and gains
    params, bundle, out["step_vs_explicit"] = step_vs_explicit(
        torch, dev, scheme, gains, seq=seq, n_layers=LONG_EVAL_LAYERS)
    print(f"  (d) f32 qwen step ({LONG_EVAL_LAYERS} layers, 4 x {seq}) vs "
          f"explicit per-client aggregation: "
          f"{json.dumps(out['step_vs_explicit'])}", flush=True)
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    part_done("d")
    print(f"  seconds per part of phase 19: {json.dumps(out['seconds'])}",
          flush=True)
    return out


def start_designs(pool):
    """The train runs' ``sca`` designs (phases 13, 17, 18 and 19, lm_curves'
    seeds and phase 20), each solved on the host's CPU in a spawned
    process of ``pool`` while phases 1 and 2 keep the card busy: a design
    needs the run's world and parameter count, not its weights.  qwen's
    runs in phases 13 and 19 share one world.  Returns {label: future of a
    ``launch.train.TrainDesign``}."""
    from repro_torch import lm_curves
    from repro_torch.launch import train
    runs = [("qwen1.5-0.5b", TRAIN_QWEN), ("mamba2-1.3b", TRAIN_MAMBA)]
    later = [("mixtral-8x22b", TRAIN_MIXTRAL),
             ("deepseek-v3-671b", TRAIN_DEEPSEEK),
             ("recurrentgemma-9b", long_argv("recurrentgemma-9b",
                                             LONG_RGEMMA_LAYERS))]
    out = {label: pool.submit(train.design_of,
                              train.parse_args(list(argv)), "cpu")
           for label, argv in runs}
    for s in lm_curves.SEEDS:
        out[f"lm_curves seed {s}"] = pool.submit(lm_curves.design, s, "cpu")
    out.update({label: pool.submit(train.design_of,
                                   train.parse_args(list(argv)), "cpu")
                for label, argv in later})
    out["seamless-m4t-medium"] = pool.submit(
        train.make_design, "sca", 4, SEAMLESS_TRAIN_PARAMS,
        SEAMLESS_TRAIN_ETA, 0, "cpu")
    return out


def made(designs, label):
    """The design ``start_designs`` made for ``label``'s run, or None
    (the run designs its own) when a phase runs without them."""
    return None if designs is None else designs[label].result()


def seamless_eval_on_vs_off(torch, bundle, params, frames, tokens):
    """Phase 20 (b): the encoder-decoder's held-out eval (frames, tokens)
    through K3 against the plain attention on the same f32 params: the
    loss, and the logits to phase 6's drift gate, taken 512 positions at
    a time (the whole f32 logits at 256,206 words and 4 x 4,096 tokens
    would be 16.8 GB a pass).  Returns the reading and the K3 pass's
    counts."""
    from repro_torch.models import encdec
    from repro_torch.models.layers import unembed
    cfg = bundle.cfg
    with torch.no_grad():
        zero_counts()
        loss_on = float(bundle.loss(params, (frames, tokens),
                                    use_kernel=True))
        torch.cuda.synchronize()
        cnt = counts()
        loss_off = float(bundle.loss(params, (frames, tokens),
                                     use_kernel=False))
        hidden = {}
        for on in (True, False):
            memory = encdec.encode(params, frames, cfg, use_kernel=on)
            hidden[on] = encdec._decode_hidden(params, memory, tokens[:, :-1],
                                               cfg, use_kernel=on)
            del memory
        diff = top = equal = 0.0
        for c in range(0, tokens.shape[1] - 1, 512):
            on, off = (unembed(params["unembed"], hidden[k][:, c:c + 512],
                               cfg) for k in (True, False))
            diff = max(diff, float((on - off).abs().max()))
            top = max(top, float(off.abs().max()))
            equal += float((on.argmax(-1) == off.argmax(-1)).sum())
            del on, off
    reading = {"loss_kernel": loss_on, "loss_plain": loss_off,
               "launches": cnt["flash_attention"],
               "noncausal_launches": cnt["flash_attention_noncausal"],
               "logits_max_abs_diff": diff, "logits_max_abs": top,
               "equal_next_tokens": equal / tokens[:, :-1].numel()}
    n_attn = cfg.encoder_layers + 2 * cfg.n_layers
    check(cnt["flash_attention"] == n_attn
          and cnt["flash_attention_noncausal"]
          == cfg.encoder_layers + cfg.n_layers
          and cnt["plain_attention"] == 0,
          f"seamless f32 eval: K3 counts {cnt}, not {n_attn} launches, "
          f"{cfg.encoder_layers + cfg.n_layers} of them non-causal")
    check(abs(loss_on - loss_off) <= LM_EVAL_LOSS_RTOL * abs(loss_off),
          f"seamless f32 eval: loss {loss_on} through K3, {loss_off} plain")
    check(diff <= DRIFT_LOGITS_SHARE * top,
          f"seamless f32 eval: logits drift {reading}")
    check(reading["equal_next_tokens"] >= EQUAL_TOKENS_MIN,
          f"seamless f32 eval: equal next tokens {reading}")
    return reading, cnt


def phase_seamless_train(torch, np, dev, card_line, design=None):
    """Phase 20: the encoder-decoder's train step at train_4k's 4,096
    tokens.  (a) seamless-m4t-medium at full width and depth in bf16
    through ``launch.steps.make_train_step`` on (frames, tokens) batches,
    on ``design`` (phase 20's world, made ahead; None: made here on the
    card); K3 never in training and
    36 times in the held-out eval; (c) its trained params through
    ``save_lm`` / ``restore_lm``, bitwise; (b) in f32 on the first
    SEAMLESS_F32_LAYERS layers of each side, the eval K3 on vs off and one
    step against the explicit aggregation."""
    import gc
    import statistics
    import tempfile
    from repro_torch import configs
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import steps, train
    from repro_torch.models.param import param_leaves
    from repro_torch.models.registry import build_bundle
    from repro_torch.tasks.lm import client_batches
    seq, clients, seed = configs.TRAIN_4K.seq_len, 4, 0
    out, t_part = {"seconds": {}}, [time.time()]
    if design is None:
        design = train.make_design("sca", clients, SEAMLESS_TRAIN_PARAMS,
                                   SEAMLESS_TRAIN_ETA, seed, dev)

    def part_done(label):
        now = time.time()
        out["seconds"][label] = round(now - t_part[0], 1)
        t_part[0] = now

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    # (a) the bf16 run, full width and depth
    cfg = configs.get_config("seamless-m4t-medium")
    bundle = build_bundle(cfg, dev)
    check((cfg.encoder_layers, cfg.n_layers) == SEAMLESS_LAYERS
          and bundle.num_params == SEAMLESS_TRAIN_PARAMS,
          f"seamless-m4t-medium: {cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, {bundle.num_params} parameters")
    _, prm = train.world(clients, bundle.num_params, SEAMLESS_TRAIN_ETA,
                         seed)
    check(design.pc.name == "sca" and train.same_world(design.prm, prm),
          f"phase 20's design was made for another world: {design.prm}")
    rk = train_reckoning(torch, cfg, clients, seq)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"  (a) seamless-m4t-medium ({cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, full width, bf16, {clients} x ({seq} frames, {seq + 1} "
          f"tokens)) memory reckoning, GB: "
          f"{json.dumps({k: v / 1e9 for k, v in rk.items()})} of the card's "
          f"{total / 1e9:.2f} GB; design made ahead on the host in "
          f"{design.seconds:.1f} s, participation p "
          f"{np.round(design.pc.p, 3).tolist()}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = bundle.init(seed)
    gains = design.prm.gains
    step = steps.make_train_step(bundle, design.pc, gains,
                                 steps.TrainStepConfig(eta=SEAMLESS_TRAIN_ETA))
    draws = steps.DeviceStepDraws(
        seed + 1, gains, {k: v.shape for k, v in param_leaves(params).items()},
        dev)
    tokens = torch.as_tensor(client_batches(
        cfg.vocab_size, clients, 1, seq, LONG_STEPS + 1, seed),
        device=dev).long().reshape(LONG_STEPS + 1, clients, seq + 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randn((LONG_STEPS + 1, clients, seq, cfg.d_model),
                         generator=gen, device=dev).to(cfg.compute_dtype)
    zero_counts()
    losses, walls = [], []
    for i in range(LONG_STEPS):
        t0 = sync()
        params, metrics = step(params, (frames[i], tokens[i]), draws(i))
        losses.append(float(metrics["loss"]))
        walls.append(sync() - t0)
    cnt_train = counts()
    zero_counts()
    t0 = sync()
    with torch.no_grad():
        held_out = float(bundle.loss(params, (frames[-1], tokens[-1]),
                                     use_kernel=True))
    t_eval = sync() - t0
    cnt_eval = counts()
    n_attn = cfg.encoder_layers + 2 * cfg.n_layers
    n_noncausal = cfg.encoder_layers + cfg.n_layers
    step_s = statistics.median(walls[1:])
    st = {"arch": cfg.name, "params": bundle.num_params,
          "encoder_layers": cfg.encoder_layers, "layers": cfg.n_layers,
          "steps": LONG_STEPS, "clients": clients, "seq": seq,
          "eta": SEAMLESS_TRAIN_ETA, "step_ms": 1e3 * step_s,
          "step_ms_mean": 1e3 * statistics.fmean(walls[1:]),
          "first_step_ms": 1e3 * walls[0],
          "tokens_per_s": clients * seq / step_s, "eval_ms": 1e3 * t_eval,
          "first_loss": losses[0], "final_loss": losses[-1],
          "held_out_loss": held_out, "losses": losses,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "reckoned_peak_gb": rk["peak"] / 1e9,
          "reckoning_gb": {k: v / 1e9 for k, v in rk.items()},
          "design_s": design.seconds}
    print(f"  (a) seamless-m4t-medium train at {clients} x {seq} "
          f"[{card_line}]: step {st['step_ms']:.1f} ms, "
          f"{st['tokens_per_s']:.1f} tokens/s, eval {st['eval_ms']:.1f} ms "
          f"(loss {held_out}), peak {st['peak_mem_gb']:.2f} GB (reckoned "
          f"{st['reckoned_peak_gb']:.2f}); losses {losses}; counts in "
          f"training {cnt_train}, in the eval {cnt_eval}; {json.dumps(st)}",
          flush=True)
    check(all(np.isfinite(losses)) and np.isfinite(held_out),
          f"seamless train: losses not finite: {losses}, held out "
          f"{held_out}")
    check(losses[-1] < losses[0], f"seamless train at {seq}: the last "
          f"step's loss {losses[-1]} is not below the first's {losses[0]}")
    check(cnt_train["flash_attention"] == 0
          and cnt_train["plain_attention"] == LONG_STEPS * n_attn,
          f"seamless train: K3 launched {cnt_train['flash_attention']} "
          f"times in training, the plain attention "
          f"{cnt_train['plain_attention']} (not {LONG_STEPS} x {n_attn})")
    check(cnt_eval["flash_attention"] == n_attn
          and cnt_eval["flash_attention_noncausal"] == n_noncausal
          and cnt_eval["plain_attention"] == 0,
          f"seamless eval: K3 counts {cnt_eval}, not {n_attn} launches "
          f"({n_noncausal} non-causal: {cfg.encoder_layers} encoder, "
          f"{cfg.n_layers} cross; {cfg.n_layers} causal)")
    check(all(v == 0 for k, v in {**cnt_train, **cnt_eval}.items()
              if k not in ("flash_attention", "flash_attention_noncausal",
                           "plain_attention")),
          f"seamless train: another kernel ran: {cnt_train}, {cnt_eval}")
    out["bf16"], out["train_counts"], out["eval_counts"] = \
        st, cnt_train, cnt_eval
    del frames, tokens, draws, step
    part_done("a")

    # (c) the checkpoint: save_lm in the reference's stacked layout, then
    # restore_lm onto the card, bitwise
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "seamless.npz")
        t0 = time.perf_counter()
        ckpt.save_lm(path, cfg, params, meta={"arch": cfg.name,
                                              "steps": LONG_STEPS})
        t_save = time.perf_counter() - t0
        size = Path(path).stat().st_size
        back = ckpt.restore_lm(path, cfg, dev)
        t_restore = time.perf_counter() - t0 - t_save
    mine, theirs = param_leaves(params), param_leaves(back)
    same = list(mine) == list(theirs) and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(mine.values(), theirs.values()))
    out["checkpoint"] = {"leaves": len(mine), "archive_gb": size / 1e9,
                         "save_s": t_save, "restore_s": t_restore,
                         "bitwise": same}
    print(f"  (c) seamless-m4t-medium checkpoint (save_lm, restore_lm onto "
          f"the card): {json.dumps(out['checkpoint'])}", flush=True)
    check(same, "seamless checkpoint: restore_lm does not give back the "
          "trained params bitwise")
    del params, back, mine, theirs, bundle
    gc.collect()
    torch.cuda.empty_cache()
    part_done("c")

    # (b) f32 on the first layers of each side, 4 x 4,096: the eval K3 on
    # vs off, then one step against the explicit aggregation
    n = SEAMLESS_F32_LAYERS
    cfg32 = cfg.replace(n_layers=n, encoder_layers=n,
                        param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    bundle = build_bundle(cfg32, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    frames = torch.randn((clients, seq, cfg32.d_model), generator=gen,
                         device=dev)
    tokens = torch.as_tensor(client_batches(
        cfg32.vocab_size, clients, 1, seq, 2, seed)[-1].reshape(
            clients, seq + 1), device=dev).long()
    out["eval_k3"], out["eval_counts_f32"] = seamless_eval_on_vs_off(
        torch, bundle, bundle.init(seed), frames, tokens)
    print(f"  (b) f32 seamless eval ({n} + {n} layers, {clients} x {seq}), "
          f"K3 on vs off (off: the blocked form): "
          f"{json.dumps(out['eval_k3'])} (loss within {LM_EVAL_LOSS_RTOL} "
          f"relative; logits within {DRIFT_LOGITS_SHARE} of max |logit|, "
          f"greedy tokens equal at >= {EQUAL_TOKENS_MIN})", flush=True)
    del bundle, frames, tokens
    gc.collect()
    torch.cuda.empty_cache()
    params, bundle, out["step_vs_explicit"] = step_vs_explicit(
        torch, dev, design.pc, gains, seq=seq, n_layers=n,
        arch="seamless-m4t-medium")
    print(f"  (b) f32 seamless step ({n} + {n} layers, {clients} x {seq}) vs "
          f"explicit per-client aggregation: "
          f"{json.dumps(out['step_vs_explicit'])}", flush=True)
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    part_done("b")
    print(f"  seconds per part of phase 20: {json.dumps(out['seconds'])}",
          flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print(f"FAIL: no port under {SRC} (run from a checkout)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(DESIGN_JOBS, mp_context=multiprocessing
                               .get_context("spawn"))
    try:
        return run_phases(torch, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(torch, pool) -> int:
    """Phases 1-21; the train runs' designs are solved in ``pool``."""
    import numpy as np
    from repro_torch.card import peaks
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    t_start = time.time()
    designs = start_designs(pool)
    phase_s, stamps = {}, [(1, t_start)]

    def begin(n, title):
        """Print the last phase's seconds and the next phase's title."""
        now = time.time()
        prev, t = stamps[-1]
        phase_s[prev] = round(now - t, 1)
        print(f"[{prev}] {now - t:.1f} s", flush=True)
        stamps.append((n, now))
        print(f"[{n}] {title}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    dev = resolve_device(None)
    card = torch.cuda.get_device_name(0)
    peak_name, (bw, f32_peak, bf16_peak) = peaks(card)
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks of {peak_name}: {bw / 1e12} TB/s, "
          f"{f32_peak / 1e12} TFLOP/s f32, {bf16_peak / 1e12} TFLOP/s bf16 "
          "tensor", flush=True)
    t0 = time.time()
    libs = build.build(verbose=True)
    for name in libs:
        build.library(name)
    print(f"[1] built {sorted(p.name for p in libs.values())} in "
          f"{time.time() - t0:.2f} s", flush=True)
    sass = sass_ops(build, "ota_kernels", ("LDG.E.128", "STG.E.128"))
    print(f"[1] 128-bit global loads and stores in the OTA library: "
          f"{json.dumps(sass)}", flush=True)
    ota = {fn: n for fn, n in sass.items()
           if "round_step_kernel" in fn or "aggregate_kernel" in fn}
    check(len(ota) == 5 and all(n["LDG.E.128"] > 0 and n["STG.E.128"] > 0
                                for n in ota.values()),
          f"a K1/K2 instance (K1 f32, bf16, int8; K2 f32, bf16) has no "
          f"128-bit global load or store: {ota}")
    sass = sass_ops(build, "flash_attention")
    print(f"[1] tensor-core instructions in the flash-attention library: "
          f"{json.dumps(sass)}", flush=True)
    bf16_kernels = {fn: n for fn, n in sass.items()
                    if "flash_attention_kernel_bf16" in fn}
    check(len(bf16_kernels) == 4 and all(
        n["HGMMA"] > 0 for n in bf16_kernels.values()),
        f"K3's bf16 kernel ((Dqk, Dv) = (64, 64), (128, 128), (256, 256), "
        f"(192, 128)) has no HGMMA: {bf16_kernels}")
    f32_kernels = {fn: n for fn, n in sass.items()
                   if "flash_attention_kernel_f32" in fn}
    check(len(f32_kernels) == 4 and all(
        n["HMMA"] > 0 for n in f32_kernels.values()),
        f"K3's f32 kernel ((Dqk, Dv) = (64, 64), (128, 128), (256, 256), "
        f"(192, 128)) has no HMMA: {f32_kernels}")
    regs = build.ptxas_report(build.log("flash_attention"),
                              "flash_attention_kernel_bf16")
    print(f"[1] K3 bf16 registers and spills: {json.dumps(regs)}", flush=True)
    regs = build.ptxas_report(build.log("flash_attention"),
                              "flash_attention_kernel_f32")
    print(f"[1] K3 f32 registers and spills: {json.dumps(regs)}", flush=True)
    spills = [int(n) for line in regs
              for n in re.findall(r"(\d+) bytes spill", line)]
    check(len(spills) == 8 and not any(spills),
          f"K3's f32 kernel spills, or its build log was not read: {regs}")
    sass = sass_ops(build, "ssd_scan")
    print(f"[1] tensor-core instructions in the ssd_scan library: "
          f"{json.dumps(sass)}", flush=True)
    f32_kernels = {fn: n for fn, n in sass.items()
                   if "ssd_scan_kernelIf" in fn}
    check(len(f32_kernels) == 16 and all(
        n["HMMA"] > 0 for n in f32_kernels.values()),
        f"K4's f32 kernel (16 P, N pairs) has no HMMA: {f32_kernels}")

    begin(2, "kernels vs plain versions on the card")
    kres = phase_kernels(torch, dev, card)
    ares = phase_attention_kernel(torch, dev, card)
    sres = phase_ssd_kernel(torch, dev, card)
    begin(3, "fleet main path at full width")
    world = design_world(torch, dev)
    main_counts, path_counts, walls = phase_main_path(torch, np, dev, world)
    begin(4, "fleet kernels on vs forced off, same draws")
    phase_kernels_vs_plain_path(torch, dev, world)
    begin(5, "the Fig.-2 path: sca design, curves gate, kill and resume")
    curve_stats = phase_curves(torch, np, dev, world)
    begin(6, "LM serve path at full width")
    serve_stats, serve_counts, f32_counts, drift, swa = phase_serve(torch,
                                                                     dev)
    begin(7, "Mamba-2 serve path at full width")
    ssd_stats, ssd_counts, ssd_drift = phase_serve_ssd(torch, dev)
    begin(8, "the heterogeneous-wireless path: scenarios, the grid through "
          "K1, adaptive_sca")
    scen = phase_scenarios(torch, np, dev, card, card_line)
    begin(9, "the single-run API: run_fl, run_fl_legacy, fig2 --bench")
    single = phase_single_run(torch, np, dev, world, card_line)
    begin(10, "population mode: a 1M-device population, streamed cohorts, "
          "adaptive_sca's cohort redesign, through K1")
    popr = phase_population(torch, np, dev, card, card_line, world)
    begin(11, "the cifar_conv fleet with run telemetry: fig2 --task "
          "cifar_conv --telemetry through K1")
    cifar = phase_cifar(torch, np, dev, card, card_line, world)
    begin(12, "granite-8b, qwen2.5-14b and chameleon-34b served at full "
          "width through K3")
    dense = phase_dense_archs(torch, dev)
    begin(13, "the LM train path: OTA-FL weighted-loss training at full "
          "width, the step against the explicit aggregation, the eval's "
          "kernels, the reference's trajectories")
    print("[13] train runs' designs, made ahead on the host's CPU: "
          + json.dumps({k: round(f.result().seconds, 1)
                        for k, f in designs.items()}), flush=True)
    pool.shutdown()                      # every design is made
    trained, train_k3, train_k4 = phase_train(torch, np, dev, designs)
    begin(14, "recurrentgemma-9b (RG-LRU and local attention) served at full "
          "width through K3 at head_dim 256")
    rgemma = phase_recurrentgemma(torch, dev, card_line)
    begin(15, "seamless-m4t-medium (the encoder-decoder) served at full width "
          "through K3, its encoder and cross-attention non-causal")
    seamless = phase_seamless(torch, dev, card_line)
    begin(17, "mixtral-8x22b (MoE, sliding-window attention) served at full "
          "width through K3, its MoE layer card vs CPU, and its train step "
          "with the router's aux loss")
    mixtral = phase_mixtral(torch, np, dev, card_line, designs)
    begin(18, "deepseek-v3-671b (MLA, MoE of 256 experts top 8, MTP) served "
          "at full width through K3's (192, 128) instance, its MoE layer "
          "card vs CPU, and its train step with the MTP loss")
    deepseek = phase_deepseek(torch, np, dev, card_line, designs)
    begin(19, "OTA-FL training at train_4k's 4,096 tokens through the "
          "blocked form: qwen1.5-0.5b and recurrentgemma-9b at full width, "
          "K3 in their evals at S 4,096")
    long_train = phase_long_train(torch, np, dev, card_line, designs)
    begin(20, "the encoder-decoder's train step at train_4k's 4,096 tokens: "
          "seamless-m4t-medium at full width and depth on (frames, tokens), "
          "K3 non-causal and causal in its eval, the checkpoint")
    seamless_train = phase_seamless_train(
        torch, np, dev, card_line, designs["seamless-m4t-medium"].result())
    begin(21, "the kernels line")
    launches = {("ota_round_step", "f32"): main_counts["ota_round_step"],
                ("ota_round_step", "bf16"):
                    path_counts["fused_bf16"]["ota_round_step"],
                ("ota_round_step", "int8"):
                    path_counts["fused_int8"]["ota_round_step"],
                ("ota_aggregate", "f32"):
                    path_counts["unfused_f32"]["ota_aggregate"]}
    rows = [(f"{name}[{wire}]", name, n_launch, kres[(name, wire, MAIN[2])])
            for (name, wire), n_launch in launches.items()]
    rows.append(("flash_attention[bf16]", "flash_attention",
                 serve_counts["flash_attention"], ares["main"]))
    rows.append(("flash_attention[f32]", "flash_attention",
                 f32_counts["flash_attention"], ares["main_f32"]))
    rows.append(("ssd_scan[f32]", "ssd_scan", ssd_counts["ssd_scan"],
                 sres[SSD_MAIN[0]]))
    rows.append((f"ota_round_step[f32, grid C={GRID_CELLS}]",
                 "ota_round_step", scen["grid_k1"], scen["k1_row"]))
    rows.append((f"ota_round_step[f32, cohort C=1 N={POP_COHORT}]",
                 "ota_round_step", popr["k1_launches"], popr["k1_row"]))
    rows.append((f"ota_round_step[f32, cifar C={CIFAR[0]} D={CIFAR[2]}]",
                 "ota_round_step", cifar["k1_launches"], cifar["k1_row"]))
    for arch in DENSE_ARCHS:
        rows.append((f"flash_attention[bf16, {arch}]", "flash_attention",
                     dense[arch][1]["flash_attention"], ares[arch]))
    rows.append(("flash_attention[bf16, qwen1.5-0.5b train eval]",
                 "flash_attention", train_k3["flash_attention"],
                 ares["train_eval"]))
    rows.append(("ssd_scan[f32, mamba2-1.3b train eval]", "ssd_scan",
                 train_k4["ssd_scan"], sres["train_eval"]))
    rows.append(("flash_attention[bf16, recurrentgemma-9b, Dh 256]",
                 "flash_attention", rgemma["bf16_counts"]["flash_attention"],
                 ares["recurrentgemma-9b"]))
    rows.append(("flash_attention[f32, recurrentgemma-9b, Dh 256]",
                 "flash_attention", rgemma["f32_counts"]["flash_attention"],
                 ares["recurrentgemma-9b_f32"]))
    for dt, key in (("bf16", ""), ("f32", "_f32")):
        cnt = seamless[f"{dt}_counts"]
        rows.append((f"flash_attention[{dt}, seamless-m4t-medium, "
                     "non-causal: encoder and cross]", "flash_attention",
                     cnt["flash_attention_noncausal"],
                     ares[f"seamless_encoder{key}"]))
        rows.append((f"flash_attention[{dt}, seamless-m4t-medium, causal "
                     "decoder]", "flash_attention",
                     cnt["flash_attention"] - cnt["flash_attention_noncausal"],
                     ares[f"main{key}"]))
    rows.append(("flash_attention[bf16, mixtral-8x22b, H 48 over KH 8, "
                 "window 4096]", "flash_attention",
                 mixtral["bf16_counts"]["flash_attention"],
                 ares["mixtral-8x22b"]))
    rows.append(("flash_attention[f32, mixtral-8x22b, H 48 over KH 8, "
                 "window 4096]", "flash_attention",
                 mixtral["f32_counts"]["flash_attention"],
                 ares["mixtral-8x22b_f32"]))
    rows.append(("flash_attention[f32, mixtral-8x22b, past the window: "
                 "S 8192]", "flash_attention",
                 mixtral["ring_counts"]["flash_attention"],
                 ares["mixtral-8x22b_window4096_f32"]))
    rows.append(("flash_attention[bf16, deepseek-v3-671b MLA, Dqk 192, Dv "
                 "128, H 128]", "flash_attention",
                 deepseek["bf16_counts"]["flash_attention"],
                 ares["deepseek-v3"]))
    rows.append(("flash_attention[f32, deepseek-v3-671b MLA, Dqk 192, Dv "
                 "128, H 128]", "flash_attention",
                 deepseek["f32_counts"]["flash_attention"],
                 ares["deepseek-v3_f32"]))
    rows.append(("flash_attention[bf16, qwen1.5-0.5b train eval at S 4096]",
                 "flash_attention",
                 long_train["qwen1.5-0.5b_counts"]["flash_attention"],
                 ares["train_4k_eval"]))
    rows.append(("flash_attention[bf16, recurrentgemma-9b train eval at S "
                 "4096, Dh 256, window 2048]", "flash_attention",
                 long_train["recurrentgemma-9b_counts"]["flash_attention"],
                 ares["recurrentgemma-9b_train_4k_eval"]))
    for dt, key, cnt in (("bf16", "", seamless_train["eval_counts"]),
                         ("f32", "_f32", seamless_train["eval_counts_f32"])):
        rows.append((f"flash_attention[{dt}, seamless-m4t-medium train eval "
                     "at S 4096, non-causal: encoder and cross]",
                     "flash_attention", cnt["flash_attention_noncausal"],
                     ares[f"seamless_train_4k_encoder{key}"]))
    rows.append(("flash_attention[bf16, seamless-m4t-medium train eval at S "
                 "4096, causal decoder]", "flash_attention",
                 seamless_train["eval_counts"]["flash_attention"]
                 - seamless_train["eval_counts"]["flash_attention_noncausal"],
                 ares["train_4k_eval"]))
    kernels = [{
        "name": label, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": n_launch,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row.get("library_ms")}
        for label, name, n_launch, row in rows]
    agg_bf16 = kres[("ota_aggregate", "bf16", MAIN[2])]
    print(f"[21] ota_aggregate[bf16] (no path hands K2 a bf16 g): "
          f"{json.dumps(agg_bf16)}", flush=True)
    print(f"[21] round walls ms: {json.dumps(walls)}", flush=True)
    print(f"[21] curves: {json.dumps(curve_stats)}", flush=True)
    print(f"[21] scenarios: {json.dumps(scen['walls'])}", flush=True)
    print(f"[21] single run: {json.dumps(single)}", flush=True)
    print(f"[21] population: {json.dumps(popr['walls'])}", flush=True)
    print(f"[21] cifar_conv with telemetry: {json.dumps(cifar['walls'])}",
          flush=True)
    print("[21] dense archs: " + json.dumps(
        {arch: {k: st[k] for k in ("batch", "prefill_ms",
                                   "decode_ms_per_token", "peak_mem_gb",
                                   "batch_fits")}
         for arch, (st, _) in dense.items()}), flush=True)
    print("[21] train: " + json.dumps(
        {arch: {k: trained[arch][k] for k in (
            "steps", "step_ms", "first_step_ms", "tokens_per_s", "eval_ms",
            "first_loss", "final_loss", "held_out_loss", "peak_mem_gb")}
         for arch in ("qwen", "mamba2")}
        | {"lm_curves_wall_s": trained["curves"]["wall_s"],
           "lm_curves_step_ms": trained["curves"]["step_ms"]}),
        flush=True)
    print("[21] recurrentgemma-9b: " + json.dumps(
        {"bf16": {k: rgemma["bf16"][k] for k in (
            "batch", "prefill_ms", "decode_ms_per_token", "peak_mem_gb")},
         "f32": {k: rgemma["f32"][k] for k in (
             "layers", "batch", "prefill_ms", "decode_ms_per_token",
             "peak_mem_gb", "state_equal_tokens")},
         "ring": {k: rgemma["ring"][k] for k in (
             "layers", "batch", "prompt_len", "window", "prefill_ms",
             "decode_ms_per_token", "equal_tokens")}}), flush=True)
    print("[21] seamless-m4t-medium: " + json.dumps(
        {"bf16": {k: seamless["bf16"][k] for k in (
            "batch", "prefill_ms", "decode_ms_per_token", "peak_mem_gb")},
         "f32": {k: seamless["f32"][k] for k in (
             "prefill_ms", "decode_ms_per_token", "peak_mem_gb",
             "state_equal_tokens", "memory_max_abs_err",
             "dec_layer0_max_abs_err", "logits_max_abs_diff",
             "equal_next_tokens")},
         "ragged": {k: seamless["ragged"][k] for k in (
             "memory_max_abs_err", "dec_layer0_max_abs_err",
             "logits_max_abs_diff", "equal_next_tokens")}}), flush=True)
    print("[21] mixtral-8x22b: " + json.dumps(
        {"bf16": {k: mixtral["bf16"][k] for k in (
            "layers", "batch", "prefill_ms", "decode_ms_per_token",
            "peak_mem_gb", "reckoned_peak_gb",
            "prefill_kept_dropped_per_layer")},
         "f32": {k: mixtral["f32"][k] for k in (
             "prefill_ms", "decode_ms_per_token", "peak_mem_gb",
             "layer0_attention_max_abs_err", "logits_max_abs_diff",
             "equal_next_tokens",
             "state_equal_tokens")},
         "ring": {k: mixtral["ring"][k] for k in (
             "layers", "batch", "prompt_len", "window", "prefill_ms",
             "decode_ms_per_token", "equal_tokens")},
         "drop": mixtral["drop"],
         "train": {k: mixtral["train"][k] for k in (
             "steps", "step_ms", "first_step_ms", "tokens_per_s", "eval_ms",
             "first_loss", "final_loss", "held_out_loss", "eval_aux",
             "peak_mem_gb")}}), flush=True)
    print("[21] deepseek-v3-671b: " + json.dumps(
        {"bf16": {k: deepseek["bf16"][k] for k in (
            "layers", "batch", "prefill_ms", "decode_ms_per_token",
            "peak_mem_gb", "reckoned_peak_gb",
            "prefill_kept_dropped_per_moe_layer")},
         "f32": {k: deepseek["f32"][k] for k in (
             "prefill_ms", "decode_ms_per_token", "peak_mem_gb",
             "layer0_attention_max_abs_err", "logits_max_abs_diff",
             "equal_next_tokens", "state_equal_tokens", "forms_max_abs_err")},
         "drop": deepseek["drop"],
         "train": {k: deepseek["train"][k] for k in (
             "steps", "step_ms", "first_step_ms", "tokens_per_s", "eval_ms",
             "first_loss", "final_loss", "held_out_loss", "eval_mtp_xent",
             "peak_mem_gb")},
         "seconds": deepseek["seconds"]}), flush=True)
    print("[21] train at 4,096 tokens: " + json.dumps(
        {arch: {k: long_train[arch][k] for k in (
            "layers", "steps", "clients", "seq", "step_ms", "first_step_ms",
            "tokens_per_s", "eval_ms", "first_loss", "final_loss",
            "held_out_loss", "peak_mem_gb", "reckoned_peak_gb")}
         for arch in ("qwen1.5-0.5b", "recurrentgemma-9b")}
        | {"forms": long_train["forms"], "eval_k3": long_train["eval_k3"],
           "step_vs_explicit": long_train["step_vs_explicit"],
           "seconds": long_train["seconds"]}), flush=True)
    print("[21] seamless-m4t-medium train at 4,096 tokens: " + json.dumps(
        {"bf16": {k: seamless_train["bf16"][k] for k in (
            "encoder_layers", "layers", "steps", "clients", "seq", "step_ms",
            "first_step_ms", "tokens_per_s", "eval_ms", "first_loss",
            "final_loss", "held_out_loss", "peak_mem_gb", "reckoned_peak_gb",
            "design_s")},
         "checkpoint": seamless_train["checkpoint"],
         "eval_k3": seamless_train["eval_k3"],
         "step_vs_explicit": seamless_train["step_vs_explicit"],
         "seconds": seamless_train["seconds"]}), flush=True)
    print(f"[21] serve: prefill {serve_stats['prefill_ms']:.3f} ms, decode "
          f"{serve_stats['decode_ms_per_token']:.3f} ms per token "
          f"(batch {serve_stats['batch']}); f32 prefill "
          f"{drift['f32']['prefill_ms']:.3f} ms, decode "
          f"{drift['f32']['decode_ms_per_token']:.3f} ms per token; swa prefill "
          f"{swa['prefill_ms']:.3f} ms, decode "
          f"{swa['decode_ms_per_token']:.3f} ms per token; mamba2 prefill "
          f"{ssd_stats['prefill_ms']:.3f} ms, decode "
          f"{ssd_stats['decode_ms_per_token']:.3f} ms per token; total "
          f"{time.time() - t_start:.1f} s", flush=True)
    print(f"[21] seconds per phase: {json.dumps(phase_s)}", flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
