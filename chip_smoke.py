#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. device: a CUDA card must be present (there is no CPU path); prints
   `nvidia-smi`'s name and power limit of the card;
2. build: builds the seven CUDA kernel sources of the port from
   `aesmc_tpu_torch/csrc/`, one nvcc each, all started together, into
   `aesmc_tpu_torch/_build/` (or the user's cache directory when the
   package cannot be written);
3. kernels against their plain PyTorch versions on the same inputs on the
   card, at the main paths' shapes, at other shapes up to K = 8,388,608
   and at degenerate weights:
   - K1, the fused systematic resample+gather: exactly equal (indices and
     gathered values), index output on and off, at the edges of its tiles
     (K = 1,024, 1,025, 2,049) and of its shared-memory window (K = 8,192,
     8,193), at D = 1, 13 and 300, and at the VRNN step's (16, 4,096, 64);
   - K2, the range sum (the backward of K1 and K3): exactly equal with
     integer cotangents in [-5, 5] (every sum is then exact in float32),
     each source within 1e-5 x its segment's sum of |g| with float
     cotangents, and the same bits on two launches, up to a row of
     8,388,608 slots on one particle and with the mass on a row's first
     or last particle;
   - K3, the search + gather over loaded sorted positions: exactly equal
     on K1's cases with systematic, stratified and multinomial positions,
     on Kp != K, and at (2, 4,194,304, 4,096), whose windows exceed the
     shared-memory cap;
   - K5, the gather by sorted indices: bit-equal for int32 (negative and
     above 2^24), int64, int8, bool, float64 and float32, D in {1, 5, 8,
     64}, at K = 256 and 257 (one slot a thread up to 256), K = 8,388,608
     and B = 65,536, on indices from resampling and all-equal ones;
     timed at (B, K, D) = (10, 100, 1), (2, 256, 1) (the HMM train
     step's), (10, 10,000, 1), (10, 10,000, 8), (10, 10,000, 64) and
     (4, 8,388,608, 1);
   - K4, the index-only sorted search: exactly equal to
     torch.searchsorted for stratified and multinomial positions up to
     K = 4,194,304, at Kc != Kp, and at (2, 4,194,304, 4,096), whose
     windows exceed the shared-memory cap (one row on one particle takes
     the staged path);
   - K6, the fused CDF + search + gather: indices equal to its plain
     version's (both build the same fixed-point CDF), its gathered values
     the values at its own indices, up to (2, 4,194,304), on one particle
     a row, runs of -inf weight, Kp != K both ways, positions in no order
     and D in {0, 1, 2, 3}; timed at (10, 10,000), (10, 1,000), one
     particle a row at (10, 10,000) and (2, 4,194,304);
   - every kernel at B = 65,536 rows (more than a grid's second dimension
     holds) and K = 4, exact;
   - the CDF kernel (phase 3k) against the plain CDF
     (`resampling._normalized_cumsum`) at the paths' shapes up to (1,
     4,194,304), at one particle, the edges of a one-block row and of a
     chunk's tiles, 65,537 rows, runs of -inf, one dominant particle and a row
     with no finite entry: monotone, last entry exactly 1.0, the same bits
     on 10 launches, NaN rows as the plain CDF's, at most twice the plain
     CDF's error against a float64 CDF; K1's ancestors on it against those
     on the plain CDF (fewer than 0.5% differ, by at most 3, at K <=
     100,000); never slower on the card than the plain CDF; 199 launches
     in one graphed filter call and its replay, whose replays it times
     against the plain CDF's graph, as the serving step's at (64,
     10,000); the exported serving step records its operator. Every
     path's launch line counts the CDF kernel beside K1-K6. A later check
     that holds the kernel route exactly against the plain route gives
     the kernel route the plain CDF for that check alone (`_plain_cdf`):
     fed one CDF, K1-K5 give the plain ancestors exactly. The filter (4),
     every `_compare_routes` (5, 11, 17, 22) and the HMM filter (6) also
     hold the kernel route with the CDF kernel against the plain route
     (`_against_plain`): the first resampling step's ancestors within
     the share above, and log-Z or the loss within `ROUTE_RTOL` of the
     plain route's. The mesh phases' ranks hold the mesh against the
     single-device 'cuda' route with the plain CDF (`_md_worker`);
   - K1 and K4 at the shapes of the slice-D2 and D3 paths (phase 3j): K1
     at (10, 4,096, 2), (1,024, 256, 1), (1, 262,144, 0), the block PF's,
     IF2's and the sampler's rows, and learn_twist's (10, 2,048, 1), (4,
     2,048, 2) and (4, 128, 2); K4 at (1, 16,384) and (1, 262,144) with Kp =
     512 positions, sorted and not, exact;
   each is timed against its plain version (CUDA events; plain, kernel,
   kernel, plain), K1 also with indices only, K1-K3 also with all mass on
   one particle and on runs of -inf weight, K4 and K5 also against the
   one PyTorch call that computes their function and K2 against
   `scatter_add_` over the forward's ancestors, and its device time read
   from torch.profiler (the library call's too, over all its kernels); K1
   and K2 also at the VRNN step's (16, 4,096, 64);
   the host cost of K4's wrapper is broken down into its pieces;
4. filter: the LGSSM SMC filter at the bench's shape (T=200, B=10,
   K=10,000) through `inference.infer`: the log-Z-only call launches K1
   T-1 times; the lineage call agrees exactly with the plain route; with
   the optimal proposal log-Z lies within 5% of the Kalman filter; times
   the filter and K1 against their plain versions with CUDA events, and
   prints torch.profiler's device time by kernel for one filter call;
5. train: the AESMC train step (`train.make_train_step`) on the bench's
   LGSSM at the reference training shape (T=200, B=10, K=100): one step
   launches K1 and K2 T-1 times each; the loss equals the plain route's
   exactly and the gradients agree within rtol 1e-5; times the step on
   both routes and at K=10,000 (with peak memory), prints a profile of
   one step, runs one stratified and one multinomial step (K3 and K2,
   T-1 launches each), and a short parameter-recovery run of
   `train.train` that must halve the parameters' distance to the truth;
6. HMM filter: the discrete HMM (D=8 states, the fully adapted proposal,
   int32 particles) at the bench's shape (T=200, B=10, K=10,000): the
   log-Z-only call launches K1 (indices only) and K5 T-1 times each, a
   stratified call K4 and K5 T-1 times each; the lineage call
   equals the plain route exactly; log-Z against the exact forward
   recursion at the JAX test's settings over 8 noise seeds; times both
   routes and prints a profile of one call;
7. HMM training: the JAX package's emission-learning test on the card
   (the loss must fall by more than 0.5 and the learned means land near
   the truth);
8. graphed train step: `train.train_on_device` on the bench's LGSSM at
   (T, B, K) = (200, 10, 100), 400 steps in blocks of 100, one step
   captured in a CUDA graph: its first 8 steps against 8 eager
   `make_train_step` steps from the same seed (bit-equal), fresh noise at every replay (lr 0: every replay's loss
   differs), the transition learned (|mult - 0.9| < 0.45, the last 30
   losses below the first 30), ms/step from CUDA events around blocks
   beside the eager step, the plain route graphed the same way, one
   replay under torch.profiler (199 K1 and 199 K2 kernel events on the
   kernel route, none on the plain route; the idle share against CUDA
   events around the same profiled replay) and a few graphed steps at
   K = 10,000 with peak memory;
9. graphed filters: one `inference.infer` call of the LGSSM filter at
   (200, 10, 10,000) and of the HMM filter (D = 8) captured in a CUDA
   graph: a replay's log-Z equals an eager call's from the same generator
   state, the next replay differs, one replay runs K1 199 times (and K5
   199 times for the HMM) under torch.profiler, and replays are timed
   against eager calls in turns;
10. ESS-adaptive resampling (frac 0.5) on the LGSSM filter at
   (200, 10, 10,000) against the Kalman filter (< 5% a row, K1 199
   launches) and one adaptive train step at K = 100 (K1 and K2); the NaN
   guard (a NaN step raises FloatingPointError and leaves the parameters
   and Adam's state bit-identical); remat at (200, 10, 10,000): the loss
   equals the plain step's, the gradients within 1e-5 relative, and both
   peak memories;
11. soft train step, the bench's config 5 (`bench.py:303-322`): (T, B, K)
   = (10, 2, 1,000,000), alpha 0.5, Adam at lr 1e-2. K3 and K2 against
   their plain versions on the step's own inputs at (2, 1,000,000, D = 3:
   the latent, log w and log q; K3 exact, K2 exact on integer cotangents,
   each source within 1e-5 x its sum of |g| and bit-identical on two
   launches) and timed there; the kernel route's loss equal to the plain
   route's and its gradients within 1e-5 relative; one step launches K3
   and K2 9 times each (peak memory); eager steps on both routes, then
   `train_on_device` graphed (ms/step, peak memory, one replay profiled:
   9 K3 and 9 K2 kernel events);
12. `lgssm_nd` filter, `make_model(dim=10)` with the exact proposal
   (`MultivariateNormalTriL`) at (200, 10, 10,000): K1 with D = 10
   columns 199 times, log-Z within 5% of `kalman_nd` in every row, equal
   on both routes; eager and graphed (phase 9's checks);
13. the auxiliary particle filter (`lgssm.Lookahead`, the scores riding
   K1 as a second column) and residual resampling (torch ops, no kernel)
   on the bench's LGSSM with the exact proposal at (200, 10, 10,000):
   log-Z within 5% of the Kalman filter in every row, the APF equal on
   both routes; eager times beside the plain filter's;
14. the dense-route sweep: `train_on_device` graphed at (200, 10, K) for
   K in {100, 256, 512, 1,024}, kernel route against the dense one-hot
   route ('torch' at K <= 1,024), one graph each (4 timed blocks); the
   dense gather bit for bit under TF32;
15. the TMC train step, the bench's row (`bench.py:281-295`), at (200, 10,
   100): TMC log-Z with the exact proposal within 5% of the Kalman filter
   in every row and closer to it than IWAE on the same draws; no kernel
   launched; the loss equal under 'high' and 'highest' matmul precision;
   the first 8 graphed `train_on_device` steps bit-equal to eager ones;
   eager and graphed ms/step, one replay profiled (no K1-K6 event); peak
   memory with and without remat at K = 100 and 1,000;
16. the VRNN AESMC train step at the JAX ablation width (latent 64, GRU
   256, observations 64, MLP 256; T = 64, B = 16, K = 4,096; data from
   `vrnn.generate`): the kernel route's loss equal to the plain route's,
   gradients within 1e-5 relative; one step launches K1 (D = 64) and K2
   63 times each; eager with and without remat, graphed through
   `train_on_device` with remat, peak memories; one replay profiled and
   split into matrix products, K1/K2 and the rest; bf16 products, eager
   and graphed;
17. the score-function gradient step at (200, 10, 100), multinomial: 199
   K3 and 199 K2 launches, the loss equal across routes (gradients within
   1e-5 relative) and within 1e-5 of the pathwise loss on the same noise;
   eager and graphed ms/step;
18. smoothing on the bench's LGSSM with the exact proposal: FFBS at (200,
   10, 10,000) with M = 128 trajectories and PaRIS at (200, 10, 2,048)
   with N = 2, 'pairwise' and 'rejection', against the RTS smoother at the
   JAX tests' bounds; the genealogy variance estimators on a graphed
   filter (exact proposal, multinomial) against the spread of 256
   replays at the JAX test's band, and printed for phase 9's filter;
19. serving, the bench's rows (`bench.py:324-402`): the streaming filter
   (`online`) on the bench's LGSSM at (B, K) = (10, 10,000), systematic,
   log-Z only: init_fn and 199 step_fn calls equal one `infer` call from
   the same generator state (log-Z, particles, weights; with
   return_ancestors the ancestors), 199 K1 launches, and stratified
   streams of the LGSSM (199 K3) and of the HMM's int32 particles (199
   K4 and K5) equal to `infer` too; eager ms per
   observation and the idle share of a profiled stream; one step captured
   in a CUDA graph (`online.CapturedStep`) replayed for 200 observations,
   bit-equal to eager steps; `batched_steps` with S = 8 graphed; the
   device plane (a 200-step `batched_steps` graph replayed 8 times);
   `track_genealogy` within 1e-4 of `variance.log_z_variance`,
   `fixed_lag` = 10 against the RTS smoother (exact proposal), streaming
   PaRIS (pairwise, (200, 10, 2,048)) equal to `smoothing.paris`, the
   exported step (`export_step` -> `load_step`) equal to the live step
   with K1 launched inside the program, and `forecast_online` at horizon
   10 against the Kalman recursion; phase 3e also times the K1, K3, K4
   and K5 launches through their `torch.library.custom_op` operators
   against the direct launch;
20. OT resampling at the JAX package's engine sizes
   (`benchmarks/ot_engine_probe.py:32`): the plan's marginals and the
   weighted mean at (4, 4,096) at the bounds of `tests/test_ot.py:28-30,
   44`; `infer('smc', 'ot')` with 20 iterations at (50, 4, 4,096) dense
   (and blocked with block 2,048, the crossover) and at (5, 4, 16,384)
   blocked and with rank 32 (T cut from the probe's 50 for the time
   limit): ms a step eager and graphed (a replay equal to an eager call),
   peak MiB, log-Z against Kalman beside systematic's; no kernel
   launched; the AESMC loss and its gradient through 'ot' at (20, 4,
   4,096) (T cut likewise), graphed equal to eager;
21. Lorenz-96 at D = 8, (T, B, K) = (50, 8, 1,024) (the JAX extended
   bench's rows): the bootstrap filter and the assimilation proposal
   ('diagonal', 'extended', 'unscented'): log-Z, ESS, ms a call eager and
   graphed, K1 at D = 8, 49 launches; the batched [8,192, 8, 8] Cholesky
   algebra; the EKF proposal on the linear LGSSM within 1e-5 of the exact
   optimal proposal;
22. the bouncing ball, the JAX bench's config 4
   (`benchmarks/bench_extended.py:394-398`) at full width: (T, B, K) =
   (64, 16, 256), 32 pixels, MLP hidden 64: one `infer` call launches K1
   (D = 2) 63 times, its ancestors and log-Z equal to the plain (dense)
   route's; the AESMC loss equal across routes, gradients within 1e-5
   relative; one `make_train_step` step launches K1 and K2 63 times each;
   `train_on_device` graphed, its first 8 steps bit-equal to eager steps;
   ms a call or step, eager and graphed;
23. SQMC, the JAX bench's row (`benchmarks/bench_extended.py:134-166`):
   the LGSSM with its optimal proposal at (100, 1, 4,096): K3 alone at
   (1, 4,096, 1) exact against its plain version and timed; one
   `sqmc_infer` call launches K3 99 times (emit_idx off), ancestors and
   log-Z equal to the torch route's; the d = 2 Hilbert path (two-word
   keys at bits 16) likewise; one call captured in a CUDA graph (a replay
   equals an eager call), beside plain `infer('smc')` graphed; over 20
   scrambles the mean log-Z within 0.05 of the Kalman filter and plain
   SMC's variance more than 20x SQMC's (`tests/test_sqmc.py:214-241`);
   10 calls at (100, 1, 4,096) and 10 residual draws at (1, 262,144)
   from one generator state draw the same ancestors bit for bit (the
   one-row scan, `resampling._row_cumsum`), each followed by 10 calls
   with the scan reverted to `torch.cumsum`, whose count of distinct
   results is printed;
24. particle Gibbs: the PGAS sweep of the JAX bench's row
   (`benchmarks/bench_extended.py:438-460`, (50, 4, 256)) eager and
   captured in a CUDA graph with the reference pinned inside it (a replay
   equals an eager sweep; 20 chained replays); `particle_gibbs` at (15, 2,
   64), 300 iterations, RMSE < 0.25 against the RTS smoother after 50
   burn-in (`tests/test_csmc.py:91-111`); a 30-iteration PMMH chain at
   K = 256 and its acceptance rate; 10 conditional-ancestor draws at (1,
   262,144) from one generator state equal bit for bit (and the reverted
   scan's count);
25. the RBPF on the JAX bench's switching rows
   (`benchmarks/bench_extended.py:94-131, 337-369`), (100, 10, 4,096),
   Do = 1 and 4: systematic launches K1 (indices only) 99 times, stratified
   K4 99 times, each equal to the torch route; a call graphed (a replay
   equals an eager call); the enumeration oracle at K = 4,096 over 4
   seeds (mean log-Z within 0.05, `tests/test_rbpf.py:173-191`) and the
   Kalman equality on the u-independent problem at K = 1, 7 and 4,096
   (`:57-64`); a call at Do = 9 (the innovation solve's Cholesky branch,
   `distributions.cho_solve`) graphed, a replay equal to an eager call;
   `_psd_inverse_small` against `distributions.cholesky` on the Do = 4
   row's [40,960, 4, 4] stack. Phases 22-25 print their
   seconds;
26. resample-move, the JAX extended bench's row
   (`benchmarks/bench_extended.py:167-183`): the LGSSM with its optimal
   proposal at (100, 10, 4,096), 2 moves: K1 99 launches a call (D = 2
   after t = 1), equal to the torch route; log-Z within 0.6 of the Kalman
   filter in every row and the mean acceptance in (0.05, 0.95)
   (`tests/test_resample_move.py:61-80`); a call graphed (a replay equals
   an eager call);
27. the block PF on Lorenz-96 with blocks of 4 at the bench's (D, T, B,
   K) = (16, 50, 4, 1,024) and (64, 50, 8, 4,096) (`:184-204, 315-336`):
   K1 (indices only) 49 launches a call on J B rows, equal to the torch
   route, graphed; one block equal to the bootstrap `infer` bit for bit;
   blocks of 4 below half the one-block RMSE at `tests/test_blockpf.py:
   57-76`'s shape;
28. the annealed samplers on the bench's 16-D Gaussian (`:205-255`) at K =
   16,384 and 262,144, resample-move (K1 once a rung) and waste-free M =
   512 multinomial (K4 once a rung): adaptive eager (two calls, one for
   waste-free at K = 262,144), the fixed ladder graphed (its last 3
   rungs at K = 262,144); the evidence oracles of
   `tests/test_samplers.py:37-53, 200-218` at their settings over 12 runs
   from fresh prior draws;
29. SMC^2 (`:256-286`), T = 50, B = 1, K = 256, M = 128 and 1,024, eager
   (one host read a step): K1 launches = 49 + 2 x the steps rerun; the
   Kalman-grid oracle of `tests/test_smc2.py:78-96` at its (M, K);
30. IF2 (`:287-314`), T = 50, 10 iterations, (B, K) = (4, 4,096) and (8,
   32,768), `lgssm.Transition(mult=theta["mult"])` built on the card: K1
   50 launches an iteration; one iteration graphed; the MLE oracle of
   `tests/test_if2.py:54-63` at its settings on the mean of 8 fits a row.
   Phases 26-30 print their seconds;
31. continuous twisted SMC at (200, 10, 10,000): the exact twist on the
   bench's LGSSM (K1 199 launches; the log-weight spread within a step;
   log-Z within 1e-4 of the Kalman filter, relative, in every row; the
   spread over 16 seeds); stochastic volatility (mu, phi, sigma, beta) =
   (0, 0.95, 0.6, 0.8) (`benchmarks/twisted_probe_r3.py:34-35, 68-110`):
   `learn_twist`, 2 ADP iterations at K = 2,048 (K1 398), then the zero
   and the learned twist, each graphed (a replay equals an eager call),
   their log-Z spreads over 16 seeds and the ratio (the learned twist
   must cut it more than 3x);
32. discrete twisted SMC: the HMM (D = 8) at (200, 10, 10,000) with the
   exact tabular twist (`benchmarks/bench_extended.py:462-496`): K1
   (indices only) and K5 199 launches each; log-Z within 1e-4 of the
   forward recursion, relative, in every row; graphed beside the
   untwisted (fully adapted) filter on the same observations;
33. the deep twist: the bouncing ball at T = 32, B = 4 on
   `tests/test_twisted.py`'s own observations
   (`tests/data/twisted_bouncing_ball_obs.npy`): `learn_twist` with one
   jittered pass (3.0) at K = 2,048, keep='best' scored at K = 128 over
   6 seeds (K1 403), then 16 seeds at K = 128, zero twist against
   learned, graphed; that test's bars: the learned mean more than 5,000
   nats above the zero twist's, its seed spread below 0.1x, every row
   selecting candidate 1 (`tests/test_twisted.py:357-397`);
34. the EnKF (no kernel): the linear oracle of `tests/test_enkf.py:36-61`
   at (12, 2, 4,000, 4), both schemes, within its bars against the
   Kalman filter; Lorenz-96 at D = 64, (50, 8), r = 0.5, N = 64: the
   stochastic EnKF with Gaspari-Cohn localization (radius 2) and
   inflation 1.05, graphed, and ETKF with inflation 1.05, eager only
   (`torch.linalg.eigh` fails inside a capture), each with its RMSE over
   the second half below 1. Phases 31-34 print their seconds;
35. the multi-device layer (`aesmc_tpu_torch.parallel`), its ranks
   spawned (any rank's failure fails the script): (c) first, in this
   process, K4, K3 (D = 3) and K2 at the all-gather exchange's shapes,
   Kc = 10,000 against Kp = 2,500 and 5,000 positions, and K3 on a ring
   slice (10, 2,500, 2,500), exact (K2 on integer cotangents) and timed;
   (a) a NCCL world of torch.cuda.device_count() ranks, one card each, on
   a (ranks, 1) mesh: the LGSSM filter at (200, 10, 10,000) through the
   default route and the all-gather and ring exchanges (K3 199 a call),
   each equal to the single-device call bit for bit (ancestors, log-Z),
   the HMM filter (D = 8, int32 particles: K4 and K5 199 each) likewise,
   and 5 sharded AESMC train steps at (200, 10, 100) (K3 and K2 199 each)
   against `train.make_train_step`: every loss equal, the parameters
   within 1e-5 relative; (b) 4 gloo ranks sharing cuda:0 (NCCL refuses
   two ranks on one card; gloo aborts on send/recv of CUDA tensors, so
   the port's ring stages them through host copies there) on (2, 2) and
   (1, 4) meshes: the filter
   with the exact proposal, log-Z within the Kalman bound, the first
   step's ancestors within one particle of the single-device call's;
   the distributed resamplers (systematic, multinomial, soft; the
   index-only one on K4) against their plain versions on the same block,
   bit for bit, gradients through K2 within 1e-5; a soft (alpha 0.5)
   sharded train step at (50, 10, 1,000) on (2, 2), loss equal on both
   routes and gradients within 1e-5, loss within 5% of the single-device
   step's; island SMC with one island of 2,048 particles a rank (4
   islands, criterion 0.5) at (100, 4) x 16 replicate row blocks, mean
   Z-hat / Z in (0.85, 1.15) on the mesh and on one device
   (`tests/test_islands.py:144-162`); every path's launches counted on
   each rank and added to the JSON line. Phase 35 prints its seconds;
36. slice E2, inside phase 35's two worlds (no world of its own): (a) on
   the NCCL (ranks, 1) mesh, each path at its single-device phase's
   width with T cut (`E2_*`): FFBS (50, 10, 10,000, M = 128) on a mesh
   filter, PaRIS (20, 10, 2,048) pairwise and rejection, the RBPF (50,
   10, 4,096) Do = 1, SMC² (10, M = 128, K = 256) rejuvenating every
   step (ESS threshold 1.0: the theta resampling and the PMMH reruns),
   twisted SMC on the
   LGSSM (exact twist) and the HMM D = 8 at (50, 10, 10,000), OT dense
   (5, 4, 4,096), resample-move (50, 10, 4,096), the block PF D = 16 (50,
   4, 1,024), the sampler at K = 16,384, IF2 (50, 4, 4,096) with 2
   iterations, each equal to its single-device call bit for bit (OT
   within 1e-4: the ring sums in another order); (b) on the gloo ranks'
   (2, 2) and (1, 4) meshes each path at (6, 4, 32), `learn_twist` on
   phase 31's SV at (50, 10, 2,048) in (a) and with jittered design
   points in (b), with streaming PaRIS + genealogy, PaRIS on the ring
   exchange and the distributed OT on the host-staged ring, SMC²
   rejuvenating every step on both meshes (its thetas and theta weights
   compared too), within each JAX test's bar of the single-device call.
   Every path's mesh call is counted alone (K3, K4, K5 by path in the
   JSON line; no K1 on a mesh). Phase 36 prints its seconds.
37. slice E3, inside phase 35's two worlds too: (a) on the NCCL (ranks,
   1) mesh, residual `infer` on the bench's LGSSM at (50, 10, 10,000)
   (T cut from 200; ancestors, latents and log-Z equal to the
   single-device call bit for bit, K4 and K3 a step), a 50-step residual
   stream equal to it, the residual HMM D = 8 filter (int32 particles:
   K4 twice a step and K5), the low-rank OT (rank 32) in `infer` at (5,
   4, 16,384) within 1e-4, 3 sharded TMC steps (no kernel) and 3 score
   steps (K3, K2) at (200, 10, 100), losses equal to the one-device
   steps' and parameters within 1e-5 relative; (b) on the gloo (2, 2)
   and (1, 4) meshes at (6, 4, 32), each path within the CPU tests' bars
   (`tests/test_torch_mesh_algorithms.py`); (c) in this process, K4, K3,
   K2 and K5 at the residual exchange's shapes (a [10, 10,000] counts
   CDF against 10,000 slots, and K_l = 8 of K = 32) against their plain
   versions exactly, timed with the bytes bound. Phase 37 prints its
   seconds.

It prints a `{"kernels": [...]}` JSON line before the last, and, as the
last line, `{"ok": true, "device": {...}}`. It imports nothing of JAX.

    python3 chip_smoke.py --compare DIR

runs phases 1 and 2, then times each kernel against another version of it
built from the sources in DIR (for example an earlier commit's, from
`git show <commit>:aesmc_tpu_torch/csrc/<file>`), on the same inputs, in
turns, by torch.profiler's device time a launch, and drives no path.

    python3 chip_smoke.py --profile-margin N

runs phases 1 and 2, then profiles one replay of phase 19's graphed
serving step N times in each of four windows: with no idle host time at
either end, with `PROFILE_MARGIN_S` before the replay, after it, or both
(`_profiled` leaves the margin before its work); it prints how many
windows saw K1 and how many events on the card, and drives no path.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import io
import json
import math
import pathlib
import subprocess
import time

import numpy as np
import torch

from torch.utils import _pytree as pytree

from aesmc_tpu_torch import (blockpf, csmc, distributions, enkf, forecast,
                             if2, inference, losses, online, ot, proposals,
                             rbpf, resample_move, resampling, samplers, smc2,
                             smoothing, sqmc, statistics, tmc, train,
                             twisted, variance)
from aesmc_tpu_torch import math as amath
from aesmc_tpu_torch.models import (bouncing_ball, hmm, kalman, kalman_nd,
                                    lgssm, lgssm_nd, lorenz,
                                    stochastic_volatility, vrnn)
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from aesmc_tpu_torch.ops import (_build, _launch, gather_sorted_cuda,
                                 normalized_cdf_cuda, range_sum_cuda,
                                 resample_cuda, resample_sorted_cuda,
                                 searchsorted_cdf_cuda,
                                 searchsorted_sorted_cuda)

T, B, K = 200, 10, 10000
# The reference training shape (bench.py:264).
TRAIN_K = 100
# The VRNN at the JAX package's ablation width
# (benchmarks/vrnn_ablation_r5.py:42-43): T=64, B=16, K=4,096, latent 64,
# GRU hidden 256, observations 64, MLP hidden 256.
VRNN_T, VRNN_B, VRNN_K = 64, 16, 4096
VRNN_LATENT, VRNN_HIDDEN, VRNN_OBS, VRNN_MLP = 64, 256, 64, 256
# Lorenz-96, the JAX package's extended-bench rows
# (benchmarks/BENCH_NOTES.md:512-516, benchmarks/bench_extended.py:420-434):
# D = 8, every component observed at r = 0.5.
LORENZ_D, LORENZ_T, LORENZ_B, LORENZ_K = 8, 50, 8, 1024
# The bench's LGSSM (bench.py): x_0 ~ N(0, 1), x_t = 0.9 x_{t-1} + N(0, 1),
# y_t = x_t + N(0, 0.2^2).
TRANSITION_MULT, TRANSITION_SCALE = 0.9, 1.0
EMISSION_MULT, EMISSION_SCALE = 1.0, 0.2
# The repo's Kalman-oracle bound on log-Z (tests/test_inference.py).
LOG_Z_REL_TOL = 0.05
# K2 with float cotangents: each source's error against the plain version
# within this fraction of its segment's sum of |g| (the two add in
# different orders; the plain version's scatter_add uses atomics).
RANGE_SUM_REL_TOL = 1e-5
# Train step, kernel route against plain route on the same noise: the
# loss is exactly equal (bit-exact ancestors); each gradient entry within
# this relative tolerance (only the order of the backward's sums differs).
GRAD_RTOL = 1e-5

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bandwidth, and float32 outside the tensor cores. A kernel's bound is the
# larger of its bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The JAX bench's HMM row (bench.py:240-259): D=8 states, the fully
# adapted proposal, at the LGSSM's (T, B, K).
HMM_STATES = 8
# The JAX package's HMM test settings (tests/test_hmm.py:18-28): D=3,
# T=25, B=2, K=2048, emission scale 0.6, stay probability 0.85.
HMM_TEST = dict(num_states=3, emission_scale=0.6, stay_prob=0.85)
HMM_TEST_T, HMM_TEST_B, HMM_TEST_K = 25, 2, 2048
# log-Z against the forward recursion over 8 noise seeds, multinomial
# resampling: the mean deviation of each row below the JAX test's bound,
# and the largest below three times it (one seed can miss the bound by
# Monte Carlo noise alone).
HMM_SEEDS, HMM_MEAN_TOL, HMM_MAX_TOL = 8, 0.05, 0.15
# name: (wrapper module, its launch count, the kernel's name in the
# profiler, the TPU kernel it replaces).
KERNELS = {
    "resample_systematic": (resample_cuda, "LAUNCHES",
                            "resample_systematic_kernel",
                            "aesmc_tpu/ops/resample_pallas.py:385"),
    "range_sum": (range_sum_cuda, "LAUNCHES", "range_sum_kernel",
                  "aesmc_tpu/ops/resample_pallas.py:961"),
    "resample_sorted": (resample_sorted_cuda, "LAUNCHES",
                        "resample_sorted_kernel",
                        "aesmc_tpu/ops/resample_pallas.py:945"),
    "searchsorted_sorted": (searchsorted_sorted_cuda, "LAUNCHES",
                            "searchsorted_sorted_kernel",
                            "aesmc_tpu/ops/resample_pallas.py:1024"),
    "gather_sorted": (gather_sorted_cuda, "LAUNCHES", "gather_sorted_kernel",
                      "aesmc_tpu/ops/gather_pallas.py:46"),
    "searchsorted_cdf": (searchsorted_cdf_cuda, "LAUNCHES",
                         "searchsorted_cdf_kernel",
                         "aesmc_tpu/ops/resample_pallas.py:975"),
}

# The CDF kernel (`ops.normalized_cdf_cuda`), counted beside them: one
# launch a resampling step on the 'cuda' route, before K1, K3 or K4 (none
# for residual resampling, the dense gather, the samplers' and SQMC's own
# CDFs and the mesh exchanges).
CDF = "normalized_cdf"

# Kernel launches on each main path, read from the wrappers' counts.
LAUNCHES = {name: {} for name in (*KERNELS, CDF)}
# Medians (ms) and peak memory (MiB) of the eager paths, for the graphed
# ones to stand beside.
EAGER_MS = {}


# The script's start, for the seconds at which each phase begins.
_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)",
          flush=True)


def reset_counts():
    for module, counter, _, _ in KERNELS.values():
        setattr(module, counter, 0)
    normalized_cdf_cuda.LAUNCHES = 0


def read_counts(path):
    """Records each kernel's launches on ``path`` since `reset_counts`, the
    CDF kernel's under `CDF`."""
    torch.cuda.synchronize()
    counts = {name: getattr(module, counter)
              for name, (module, counter, _, _) in KERNELS.items()}
    counts[CDF] = normalized_cdf_cuda.LAUNCHES
    for name, n in counts.items():
        if n:
            LAUNCHES[name][path] = n
    print(f"launches on {path}: {counts}", flush=True)
    return counts


def _searches(counts):
    """The launches of K1-K6 in ``counts`` (`read_counts`), without the
    CDF kernel's."""
    return sum(counts[name] for name in KERNELS)


def device_phase():
    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False: chip_smoke.py drives the "
            "port on a CUDA card and has no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return torch.device("cuda", 0)


def build_phase():
    phase("2 build")
    sources = sorted({module.SOURCE for module, _, _, _ in KERNELS.values()}
                     | {normalized_cdf_cuda.SOURCE})
    # Build from the sources in this checkout, never from a stale library.
    for source in sources:
        _build.library_path(source).unlink(missing_ok=True)
    start = time.perf_counter()
    _build.load_all(sources)
    seconds = time.perf_counter() - start
    print(f"built {', '.join(sources)} with {_build.nvcc_path()} in "
          f"{seconds:.2f} s (concurrently)", flush=True)


def _case_inputs(batch, k, d, kind, generator, dev):
    logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
    if kind in HOT:
        # All mass on one particle per row.
        hot = (torch.randint(0, k, (batch,), generator=generator, device=dev)
               if HOT[kind] is None else HOT[kind] % k)
        logw = torch.full((batch, k), float("-inf"), device=dev)
        logw[torch.arange(batch, device=dev), hot] = 0.0
    elif kind == "neg_inf":
        # Runs of zero weight at both ends and inside each row.
        logw[:, : k // 4] = float("-inf")
        logw[:, k // 2: k // 2 + k // 8] = float("-inf")
        logw[:, -3:] = float("-inf")
    cdf = resampling._normalized_cumsum(logw)
    u = torch.rand(batch, 1, generator=generator, device=dev)
    value = torch.randn(batch, k, d, generator=generator, device=dev)
    return cdf, u, value


# The particle that holds all the mass of each row, by kind of case: a
# random one, the first or the last.
HOT = {"one_particle": None, "hot_first": 0, "hot_last": -1}
# (B, K, D, kind). K1's and K3's edges: tiles of 512 slots (K = 1,024,
# 1,025 and 2,049), the 8,192-entry shared-memory window (K = 8,192 takes
# no narrowing round, 8,193 one), and the two ways the tile gather runs:
# D = 1 from registers, D > 1 through shared memory (D = 13 is above the
# TPU kernel's 12-column cap; D = 300 is more columns than a block has
# threads); last, the shapes the VRNN step and the Lorenz-96 filters give
# K1.
CASES = [(10, 10000, 1, "normal"), (3, 1000, 3, "normal"),
         (1, 1, 1, "normal"), (2, 1025, 1, "normal"),
         (1, 8388608, 1, "normal"), (3, 1000, 2, "one_particle"),
         (3, 1000, 2, "neg_inf"), (1, 8388608, 1, "one_particle"),
         (3, 10000, 2, "hot_first"), (3, 10000, 2, "hot_last"),
         (2, 1024, 1, "normal"), (2, 2049, 13, "normal"),
         (2, 8192, 1, "normal"), (2, 8193, 3, "normal"),
         (3, 10000, 13, "normal"), (2, 1025, 300, "normal"),
         (VRNN_B, VRNN_K, VRNN_LATENT, "normal"),
         (LORENZ_B, LORENZ_K, LORENZ_D, "normal")]


def k1_phase(dev):
    """K1 against its plain version on the card; returns the max abs error."""
    phase("3a K1 resample_systematic against its plain version")
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    worst = 0.0
    for batch, k, d, kind in CASES:
        cdf, u, value = _case_inputs(batch, k, d, kind, generator, dev)
        for emit_idx in (True, False):
            idx, out = resample_cuda.resample_and_gather_systematic(
                cdf, u, value, emit_idx)
            want_idx, want = \
                resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, value, emit_idx)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            worst = max(worst, err)
            if emit_idx:
                mismatches = int((idx != want_idx).sum())
                if mismatches:
                    raise AssertionError(
                        f"K1 indices differ from the plain version at "
                        f"{(batch, k, d, kind)}: {mismatches} of "
                        f"{batch * k}")
            elif idx is not None:
                raise AssertionError("emit_idx=False returned indices")
            if not torch.equal(out, want):
                raise AssertionError(
                    f"K1 gathered values differ from the plain version at "
                    f"{(batch, k, d, kind)}, emit_idx={emit_idx}: max abs "
                    f"error {err}")
            print(f"(B, K, D) = {(batch, k, d)} {kind:12s} "
                  f"emit_idx={emit_idx!s:5s}: exact (tolerance 0)",
                  flush=True)
    return worst


def _sorted_cases(generator, dev):
    """(label, cdf, pos, value) for K2 and K3: K1's cases with systematic,
    stratified and multinomial positions, and three cases with Kp != K,
    the last with windows over the shared-memory cap (K3's and K2's tiles
    of 512 and 1,024 positions span about 500,000 and 1,000,000 CDF
    entries)."""
    for batch, k, d, kind in CASES:
        cdf, u, value = _case_inputs(batch, k, d, kind, generator, dev)
        yield ((batch, k, k, d), kind, "systematic", cdf,
               resample_cuda.systematic_positions(u, k), value)
        noise = NoiseSource(generator)
        for method in ("stratified", "multinomial"):
            pos = resampling.resampling_positions(cdf, noise, method)
            yield (batch, k, k, d), kind, method, cdf, pos, value
    for batch, k, kp, d in ((2, 2048, 512, 1), (2, 512, 2048, 2),
                            (2, 4194304, 4096, 1)):
        cdf, u, value = _case_inputs(batch, k, d, "normal", generator, dev)
        yield ((batch, k, kp, d), "normal", "systematic", cdf,
               resample_cuda.systematic_positions(u, kp), value)


def _bits(x):
    return x.view(torch.int32)


def _k2_case(cdf, pos, d, generator, label):
    """K2 against its plain version on one case: exactly equal with
    integer cotangents, each source within `RANGE_SUM_REL_TOL` of its
    segment's sum of |g| with float ones, and the same bits on two
    launches; returns (max abs error with float cotangents, largest
    bound)."""
    batch, kp = pos.shape
    if not bool((pos[:, 1:] >= pos[:, :-1]).all()):
        raise AssertionError(f"{label}: positions are not sorted")
    g = torch.randint(-5, 6, (batch, kp, d), generator=generator,
                      device=cdf.device).float()
    got = range_sum_cuda.range_sum(cdf, pos, g)
    again = range_sum_cuda.range_sum(cdf, pos, g)
    want = range_sum_cuda.range_sum_torch(cdf, pos, g)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"K2 with integer cotangents differs from the plain version at "
            f"{label}: max abs error {float((got - want).abs().max())}")
    if not torch.equal(_bits(got), _bits(again)):
        raise AssertionError(f"K2 gave other bits on a second launch at "
                             f"{label}")
    g = torch.randn(batch, kp, d, generator=generator, device=cdf.device)
    got = range_sum_cuda.range_sum(cdf, pos, g)
    again = range_sum_cuda.range_sum(cdf, pos, g)
    want = range_sum_cuda.range_sum_torch(cdf, pos, g)
    # Each source's bound: the fraction of its segment's sum of |g|.
    bound = RANGE_SUM_REL_TOL * range_sum_cuda.range_sum_torch(
        cdf, pos, g.abs())
    diff = (got - want).abs()
    err = float(diff.max())
    if not bool((diff <= bound).all()):
        raise AssertionError(
            f"K2 with float cotangents at {label}: "
            f"{int((diff > bound).sum())} sources above their bound, max "
            f"abs error {err}")
    if not torch.equal(_bits(got), _bits(again)):
        raise AssertionError(f"K2 gave other bits on a second launch at "
                             f"{label}")
    return err, float(bound.max())


def k2_phase(dev):
    """K2 against its plain version; returns the max abs error with float
    cotangents."""
    phase("3b K2 range_sum against its plain version")
    generator = torch.Generator(device=dev)
    generator.manual_seed(1)
    worst = 0.0
    for shape, kind, method, cdf, pos, _ in _sorted_cases(generator, dev):
        err, bound = _k2_case(cdf, pos, shape[3], generator,
                              f"{shape} {kind} {method}")
        worst = max(worst, err)
        print(f"(B, K, Kp, D) = {shape} {kind:12s} {method:11s}: integer "
              f"cotangents exact, float max abs error {err:.3g} (each source "
              f"within {RANGE_SUM_REL_TOL:g} x its sum of |g|, largest bound "
              f"{bound:.3g}), two launches bit-identical", flush=True)
    return worst


def k3_phase(dev):
    """K3 against its plain version; returns the max abs error."""
    phase("3c K3 resample_sorted against its plain version")
    generator = torch.Generator(device=dev)
    generator.manual_seed(2)
    worst = 0.0
    for shape, kind, method, cdf, pos, value in _sorted_cases(generator,
                                                              dev):
        for emit_idx in (True, False):
            idx, out = resample_sorted_cuda.resample_and_gather_sorted(
                cdf, pos, value, emit_idx)
            want_idx, want = \
                resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, value, emit_idx)
            torch.cuda.synchronize()
            worst = max(worst, float((out - want).abs().max()))
            if emit_idx and not torch.equal(idx, want_idx):
                raise AssertionError(
                    f"K3 indices differ from the plain version at {shape} "
                    f"{kind} {method}: {int((idx != want_idx).sum())}")
            if not emit_idx and idx is not None:
                raise AssertionError("emit_idx=False returned indices")
            if not torch.equal(out, want):
                raise AssertionError(
                    f"K3 gathered values differ from the plain version at "
                    f"{shape} {kind} {method}, emit_idx={emit_idx}")
        print(f"(B, K, Kp, D) = {shape} {kind:12s} {method:11s}: indices "
              f"and values exact, index output on and off", flush=True)
    return worst


def _cuda_ms(fn, warmup, repeat, each=False):
    """Milliseconds per call of ``fn`` between CUDA events: the mean over
    ``repeat`` calls, or with ``each`` a list with one time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(repeat if each else 1)]
    if each:
        for start, end in events:
            start.record()
            fn()
            end.record()
    else:
        events[0][0].record()
        for _ in range(repeat):
            fn()
        events[0][1].record()
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in events]
    return times if each else times[0] / repeat


def _quartiles(xs):
    return np.percentile(np.asarray(xs), [25, 50, 75])


# Idle host time between the profiler's start and the first work it is to
# see (`_profiled`). A window whose work is launched as soon as the
# profiler starts now and then comes back with no device activity at all;
# `--profile-margin N` counts how often, with the margin and without it.
PROFILE_MARGIN_S = 0.02


@contextlib.contextmanager
def _profiled(cuda_only=False):
    """torch.profiler (CPU and CUDA activity, or CUDA only) over the
    ``with`` body, which starts `PROFILE_MARGIN_S` after the profiler
    does; the body's work is synchronized before the profiler stops."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if not cuda_only:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()


def _device_ms(fn, kernel, calls=50):
    """Mean device time of one launch of ``kernel`` over ``calls`` calls of
    ``fn``, from torch.profiler; None if the profiler saw no such kernel."""
    fn()
    torch.cuda.synchronize()
    with _profiled(cuda_only=True) as prof:
        for _ in range(calls):
            fn()
    total_us, count = 0.0, 0
    for event in prof.key_averages():
        if kernel in event.key:
            total_us += getattr(event, "device_time_total",
                                getattr(event, "cuda_time_total", 0.0))
            count += event.count
    return total_us / count / 1e3 if count else None


def _on_card(events):
    """The profiler's events on the card, less the program's spans
    (`profiling.annotate`, ``aesmc.*``), whose rows there sum the kernels
    they hold and would count them twice."""
    from torch.autograd import DeviceType
    return [e for e in events
            if getattr(e, "device_type", None) == DeviceType.CUDA and
            not e.key.startswith("aesmc.")]


def _calls_device_ms(fn, calls=50):
    """Mean device time of one call of ``fn`` over ``calls`` calls, summed
    over every kernel, copy and fill it runs on the card (torch.profiler);
    None if the profiler saw none."""
    fn()
    torch.cuda.synchronize()
    with _profiled() as prof:
        for _ in range(calls):
            fn()
    total_us = sum(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
                   for e in _on_card(prof.key_averages()))
    return total_us / calls / 1e3 if total_us else None


def _time_pair(kernel_fn, plain_fn, library_fn=None, warmup=20,
               repeat=200):
    """(kernel ms, plain ms, library ms or None, runs): CUDA-event means in
    the order plain, kernel, (library, library,) kernel, plain."""
    fns = {"kernel": kernel_fn, "plain": plain_fn, "library": library_fn}
    order = ("plain", "kernel", "kernel", "plain")
    if library_fn is not None:
        order = ("plain", "kernel", "library", "library", "kernel", "plain")
    runs = {which: [] for which in order}
    for which in order:
        runs[which].append(_cuda_ms(fns[which], warmup, repeat))
    library_ms = (None if library_fn is None else
                  float(np.mean(runs["library"])))
    return (float(np.mean(runs["kernel"])), float(np.mean(runs["plain"])),
            library_ms, runs)


def _bound(nbytes, ops):
    """(bound ms, what bounds it) for moving ``nbytes`` and doing ``ops``
    float32 operations on the card."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def _us(ms):
    """A device time in microseconds, or 'not measured' for None."""
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def _search_steps(n):
    return math.ceil(math.log2(n + 1))


def _kernel_row(name, shape, kernel_fn, plain_fn, library_fn, nbytes, ops,
                library_label="library call"):
    """Times ``name`` at ``shape`` against its plain version (and the one
    PyTorch call computing its function, where there is one), reads its
    device time (and the library call's), and returns its fields of the
    JSON line."""
    ms, plain_ms, library_ms, runs = _time_pair(kernel_fn, plain_fn,
                                                library_fn)
    device_ms = _device_ms(kernel_fn, KERNELS[name][2])
    library_device_ms = (None if library_fn is None else
                         _calls_device_ms(library_fn))
    bound_ms, bound_by = _bound(nbytes, ops)
    library = ("" if library_ms is None else
               f", {library_label} {library_ms * 1e3:.2f} us/call (runs "
               f"{runs['library']}), device {_us(library_device_ms)} a call")
    print(f"{name} at {shape}: {ms * 1e3:.2f} us/call through the wrapper "
          f"(runs {runs['kernel']}), device {_us(device_ms)} a launch, plain "
          f"{plain_ms * 1e3:.2f} us/call (runs {runs['plain']}){library}; "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} bytes, {ops} "
          f"operations)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_device_ms=library_device_ms, shape=list(shape))


def kernel_times(dev):
    """Times K1, K2 and K3 at the filter's shape (B=10, K=10,000, D=1) and
    the training shape (K=100), each against its plain version, K1 also
    with indices only (D=0), and all three on degenerate weights; returns
    the JSON fields of each kernel at (10, 10,000, 1)."""
    phase("3d kernel times against their plain versions")
    out = {}
    for k in (K, TRAIN_K):
        generator = torch.Generator(device=dev).manual_seed(5)
        cdf, u, value = _case_inputs(B, k, 1, "normal", generator, dev)
        pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                              "stratified")
        g = torch.randn(B, k, 1, generator=generator, device=dev)
        sys_pos = resample_cuda.systematic_positions(u, k)
        n, f = B * k, 4
        steps = _search_steps(k)
        # K2's yardstick: what the plain route's autograd runs, a scatter_add
        # into zeros over the forward's ancestors. It is handed the
        # ancestors, which K2 finds itself, and its atomics make it
        # non-deterministic.
        ancestors = torch.searchsorted(cdf, sys_pos, right=True).clamp_(
            max=k - 1).unsqueeze(-1)
        cases = {
            "resample_systematic": (
                lambda: resample_cuda.resample_and_gather_systematic(
                    cdf, u, value, False),
                lambda: resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, value, False),
                None, f * (n + B + 2 * n), n * steps),
            "range_sum": (
                lambda: range_sum_cuda.range_sum(cdf, sys_pos, g),
                lambda: range_sum_cuda.range_sum_torch(cdf, sys_pos, g),
                lambda: torch.zeros((B, k, 1), device=dev).scatter_add_(
                    1, ancestors, g),
                f * 4 * n, n * steps + n),
            "resample_sorted": (
                lambda: resample_sorted_cuda.resample_and_gather_sorted(
                    cdf, pos, value, False),
                lambda: resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, value, False),
                None, f * 4 * n, n * steps),
        }
        for name, (kernel_fn, plain_fn, library_fn, nbytes,
                   ops) in cases.items():
            fields = _kernel_row(
                name, (B, k, k, 1), kernel_fn, plain_fn, library_fn, nbytes,
                ops, "scatter_add_ over the given ancestors (non-"
                "deterministic)")
            if k == K:
                out[name] = fields
        # K1 with no value columns and its index output on: the HMM
        # filter's launch.
        no_columns = value.new_empty((B, k, 0))
        _kernel_row(
            "resample_systematic", (B, k, k, 0),
            lambda: resample_cuda.resample_and_gather_systematic(
                cdf, u, no_columns, True),
            lambda: resample_cuda.resample_and_gather_systematic_torch(
                cdf, u, no_columns, True),
            None, f * (n + B + n), n * steps)
        # Degenerate weights. All mass on one particle a row: K2's weak
        # case (one block sums over every later tile alone), and K1's and
        # K3's windows collapse to a few entries. Runs of -inf weight: flat
        # stretches of the CDF under a tile.
        for kind, label in (("one_particle", "all mass on one particle a "
                                             "row"),
                            ("neg_inf", "runs of -inf weight")):
            kind_cdf, kind_u, _ = _case_inputs(B, k, 1, kind, generator, dev)
            kind_pos = resample_cuda.systematic_positions(kind_u, k)
            kind_g = torch.randn(B, k, 1, generator=generator, device=dev)
            fns = {
                "resample_systematic": lambda: (
                    resample_cuda.resample_and_gather_systematic(
                        kind_cdf, kind_u, value, False)),
                "range_sum": lambda: range_sum_cuda.range_sum(
                    kind_cdf, kind_pos, kind_g),
                "resample_sorted": lambda: (
                    resample_sorted_cuda.resample_and_gather_sorted(
                        kind_cdf, pos, value, False)),
            }
            for name, fn in fns.items():
                ms = _cuda_ms(fn, 5, 50)
                device_ms = _device_ms(fn, KERNELS[name][2], calls=10)
                print(f"{name} at ({B}, {k}, 1), {label}: {ms * 1e3:.2f} "
                      f"us/call, device {_us(device_ms)} a launch",
                      flush=True)
    _vrnn_kernel_times(dev)
    return out


def _vrnn_kernel_times(dev):
    """K1 (no index output, as the VRNN step launches it) and K2 at the
    VRNN step's shape, (B, K, D) = (16, 4,096, 64)."""
    generator = torch.Generator(device=dev).manual_seed(7)
    b, k, d = VRNN_B, VRNN_K, VRNN_LATENT
    cdf, u, value = _case_inputs(b, k, d, "normal", generator, dev)
    pos = resample_cuda.systematic_positions(u, k)
    g = torch.randn(b, k, d, generator=generator, device=dev)
    ancestors = torch.searchsorted(cdf, pos, right=True).clamp_(
        max=k - 1).unsqueeze(-1).expand(g.shape)
    n, f, steps = b * k, 4, _search_steps(k)
    _kernel_row("resample_systematic", (b, k, k, d),
                lambda: resample_cuda.resample_and_gather_systematic(
                    cdf, u, value, False),
                lambda: resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, value, False),
                None, f * (n + b + 2 * n * d), n * steps)
    _kernel_row("range_sum", (b, k, k, d),
                lambda: range_sum_cuda.range_sum(cdf, pos, g),
                lambda: range_sum_cuda.range_sum_torch(cdf, pos, g),
                lambda: torch.zeros_like(g).scatter_add_(1, ancestors, g),
                f * (2 * n + 2 * n * d), n * steps + n * d,
                "scatter_add_ over the given ancestors (non-deterministic)")


def _host_us(fn, calls=300):
    """Host microseconds per call of ``fn`` over ``calls`` back-to-back
    calls ended by one synchronize (the dispatch cost, where the device
    keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / calls * 1e6


def host_costs(dev):
    """Host cost of one resampling step's forward and backward at the
    training shape (B=10, K=100, D=1), kernel route against plain route,
    and of the pieces of the kernel route's backward."""
    phase("3e host cost per resampling step at the training shape")
    generator = torch.Generator(device=dev).manual_seed(6)
    cdf, u, value = _case_inputs(B, TRAIN_K, 1, "normal", generator, dev)
    value.requires_grad_(True)
    g = torch.randn(B, TRAIN_K, 1, generator=generator, device=dev)
    pos = resample_cuda.systematic_positions(u, TRAIN_K)

    def kernel_step():
        _, out = resample_cuda.resample_and_gather_systematic(
            cdf, u, value, False)
        out.backward(g)

    def plain_step():
        _, out = resample_cuda.resample_and_gather_systematic_torch(
            cdf, u, value, False)
        out.backward(g)

    costs = {
        "K1 wrapper, forward only": lambda: (
            resample_cuda.resample_and_gather_systematic(
                cdf, u, value.detach(), False)),
        "plain forward only": lambda: (
            resample_cuda.resample_and_gather_systematic_torch(
                cdf, u, value.detach(), False)),
        "K1 forward + K2 backward": kernel_step,
        "plain forward + backward": plain_step,
        "systematic_positions": lambda: resample_cuda.systematic_positions(
            u, TRAIN_K),
        "K2 wrapper": lambda: range_sum_cuda.range_sum(cdf, pos, g),
        "K2 plain version": lambda: range_sum_cuda.range_sum_torch(cdf, pos,
                                                                   g),
    }
    for label, fn in costs.items():
        print(f"host cost, {label}: {_host_us(fn):.1f} us/call", flush=True)
    _operator_costs(dev, cdf, u, value.detach())


def _operator_costs(dev, cdf, u, value):
    """Host cost of the launches the serving step reaches (K1, K3, K4, K5)
    through their `torch.library.custom_op` operators (the wrappers'
    route, which `torch.export` records), against the direct launch each
    wrapper made before it (`_launch_kernel`), at (B, K) = (10, 100)."""
    generator = torch.Generator(device=dev).manual_seed(9)
    pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                          "stratified")
    idx = searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos)
    states = torch.randint(0, 8, (B, TRAIN_K), dtype=torch.int32,
                           generator=generator, device=dev)
    pairs = {
        "K1": (lambda: resample_cuda._launch_kernel(cdf, u, value, False),
               lambda: resample_cuda._kernel_op(cdf, u, value, False)),
        "K3": (lambda: resample_sorted_cuda._launch_kernel(cdf, pos, value,
                                                           False),
               lambda: resample_sorted_cuda._kernel_op(cdf, pos, value,
                                                       False)),
        "K4": (lambda: searchsorted_sorted_cuda._launch_kernel(cdf, pos),
               lambda: searchsorted_sorted_cuda._kernel_op(cdf, pos)),
        "K5": (lambda: gather_sorted_cuda._launch_kernel(states, idx),
               lambda: gather_sorted_cuda._kernel_op(states, idx)),
    }
    for name, (direct, operator) in pairs.items():
        runs = {"direct": [], "operator": []}
        for which in ("direct", "operator", "operator", "direct"):
            runs[which].append(round(_host_us(
                direct if which == "direct" else operator), 2))
        print(f"host cost, {name} launch: direct {runs['direct']} us/call, "
              f"through its custom_op {runs['operator']} us/call",
              flush=True)


def _same_bits(a, b):
    """Equal dtype, shape and bits (floats compared by bit pattern)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(as_int[x.element_size()]) for x in (a, b))
    return torch.equal(a, b)


K5_DTYPES = (torch.int32, torch.int64, torch.int8, torch.bool,
             torch.float64, torch.float32)
# (B, K, D) of the K5 checks; rows of at most 256 slots take one slot a
# thread, longer ones four.
K5_SHAPES = [(B, K, 1), (B, K, 8), (B, K, 64), (4, 8388608, 1),
             (65536, 4, 1), (3, 256, 5), (3, 257, 1)]
# (B, K, D) of K5's device times; (2, 256, 1) is the HMM train step's.
K5_TIMES = [(B, 100, 1), (2, 256, 1), (B, K, 1), (B, K, 8), (B, K, 64),
            (4, 8388608, 1)]
# (B, Kc, Kp, kind) of the K4 checks: at (2, 4,194,304, 4,096) every
# tile's window exceeds the shared-memory cap, except on the row whose
# mass sits on one particle (an empty window, staged).
K4_CASES = [(B, K, K, "normal"), (B, 4194304, 4194304, "normal"),
            (4, 1048576, 262144, "normal"),
            (2, 4194304, 4096, "one_particle_row")]
# (B, K, Kp, D, kind) of the K6 checks: positions split over the cluster
# apart from the CDF (Kp != K both ways), positions that are not sorted,
# runs of -inf weight, indices only (D = 0) and D = 3.
K6_CASES = [(B, K, K, 1, "normal"), (B, 1000, 1000, 1, "normal"),
            (B, K, K, 1, "one_particle"), (2, 4194304, 4194304, 1, "normal"),
            (2, 20000, 5000, 3, "normal"), (2, 5000, 20000, 1, "normal"),
            (3, 10000, 10000, 1, "unsorted"), (3, 1000, 4000, 3, "unsorted"),
            (2, 50000, 50000, 1, "neg_inf"), (2, 50000, 50000, 0, "neg_inf"),
            (3, 9, 9, 0, "normal"), (3, 1, 1, 1, "normal"),
            (4, 100000, 100000, 2, "normal")]
# (B, K, kind) of K6's device times; the first goes to the JSON line.
K6_TIMES = [(B, K, "normal"), (B, 1000, "normal"), (B, K, "one_particle"),
            (2, 4194304, "normal")]
# B of the check that every kernel takes more rows than a grid's second
# dimension holds (65,535), at K = ROWS_K.
ROWS_B, ROWS_K = 65536, 4


def _k5_value(dtype, shape, generator, dev):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=generator,
                         device=dev, dtype=torch.int64)
    if dtype == torch.bool:
        return bits > 0
    if dtype == torch.int64:
        return bits * (2 ** 31) + bits        # beyond 32 bits
    value = bits.to(dtype)                    # int8 wraps
    if dtype == torch.int32:
        value.view(-1)[:4] = torch.tensor(
            [-1, 2 ** 24 + 1, -(2 ** 30) - 3, 2 ** 31 - 1], dtype=dtype)
    return value


def k5_phase(dev):
    """K5 against its plain version, bit for bit; returns the JSON fields
    of K5 at the HMM filter's shape (10, 10,000), int32 particles."""
    phase("3f K5 gather_sorted against its plain version")
    generator = torch.Generator(device=dev).manual_seed(7)
    for batch, k, d in K5_SHAPES:
        logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
        resampled = resampling.sample_ancestral_index(logw,
                                                      NoiseSource(generator))
        equal = torch.full((batch, k), k // 2, dtype=torch.int32,
                           device=dev)
        for dtype in K5_DTYPES:
            value = _k5_value(dtype, (batch, k, d), generator, dev)
            for label, idx in (("resampled", resampled),
                               ("all-equal", equal)):
                got = gather_sorted_cuda.gather_sorted(value, idx)
                want = gather_sorted_cuda.gather_sorted_torch(value, idx)
                torch.cuda.synchronize()
                if not _same_bits(got, want):
                    raise AssertionError(
                        f"K5 differs from its plain version at "
                        f"{(batch, k, d)} {dtype} on {label} indices")
        print(f"(B, K, D) = {(batch, k, d)}: bit-equal for "
              f"{', '.join(str(t).split('.')[1] for t in K5_DTYPES)} on "
              f"resampled and all-equal indices (tolerance 0)", flush=True)
    # Device times against the bound, int32 values on resampled indices:
    # the HMM filter's shape (10, 10,000, 1), whose fields go to the JSON
    # line, and four others.
    fields = None
    for batch, k, d in K5_TIMES:
        logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
        idx = resampling.sample_ancestral_index(logw, NoiseSource(generator))
        shape = (batch, k) if d == 1 else (batch, k, d)
        latents = _k5_value(torch.int32, shape, generator, dev)
        index = idx.long() if d == 1 else idx.long().unsqueeze(-1)
        n = batch * k
        row = _kernel_row(
            "gather_sorted", (batch, k, d),
            lambda: gather_sorted_cuda.gather_sorted(latents, idx),
            lambda: gather_sorted_cuda.gather_sorted_torch(latents, idx),
            lambda: torch.take_along_dim(latents, index, dim=1),
            4 * n + 2 * 4 * n * d, 0)
        if (batch, k, d) == (B, K, 1):
            fields = row
    return fields


def _k4_case(batch, kc, kind, generator, dev):
    """A `[batch, kc]` CDF from N(0, 3^2) log-weights; with kind
    'one_particle_row' the last row holds all its mass on one particle."""
    logw = torch.randn(batch, kc, generator=generator, device=dev) * 3.0
    if kind == "one_particle_row":
        logw[-1] = float("-inf")
        logw[-1, kc // 3] = 0.0
    return resampling._normalized_cumsum(logw)


def k4_phase(dev):
    """K4 against torch.searchsorted, exactly, and the host cost of its
    wrapper; returns its JSON fields at (10, 10,000), stratified
    positions."""
    phase("3g K4 searchsorted_sorted against torch.searchsorted")
    generator = torch.Generator(device=dev).manual_seed(8)
    for batch, kc, kp, kind in K4_CASES:
        cdf = _k4_case(batch, kc, kind, generator, dev)
        for method in ("stratified", "multinomial"):
            pos = resampling.resampling_positions(
                cdf.new_zeros(batch, kp), NoiseSource(generator), method)
            got = searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos)
            want = searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf,
                                                                      pos)
            library = torch.searchsorted(cdf, pos, right=True)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and
                    torch.equal(got.long(), library.clamp(max=kc - 1))):
                raise AssertionError(
                    f"K4 differs from torch.searchsorted at "
                    f"{(batch, kc, kp)} {kind} {method}: "
                    f"{int((got != want).sum())} indices")
            print(f"(B, Kc, Kp) = {(batch, kc, kp)} {kind:16s} {method:11s}: "
                  f"equal to torch.searchsorted (tolerance 0)", flush=True)
    logw = torch.randn(B, K, generator=generator, device=dev) * 3.0
    cdf = resampling._normalized_cumsum(logw)
    pos = resampling.resampling_positions(logw, NoiseSource(generator),
                                          "stratified")
    n = B * K
    fields = _kernel_row(
        "searchsorted_sorted", (B, K, K, 0),
        lambda: searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos),
        lambda: searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf, pos),
        lambda: torch.searchsorted(cdf, pos, right=True),
        4 * 3 * n, n * _search_steps(K))

    # The host cost of the wrapper against the library call, and of each
    # piece of the wrapper.
    module = searchsorted_sorted_cuda
    fn = _launch.entry(module.SOURCE, module._SYMBOL, module._ARGTYPES)
    idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    card, stream = _launch.target(cdf)
    pieces = {
        "K4 wrapper (searchsorted_sorted)": lambda: module.searchsorted_sorted(
            cdf, pos),
        "torch.searchsorted": lambda: torch.searchsorted(cdf, pos,
                                                         right=True),
        "  its checks (_check)": lambda: module._check(cdf, pos),
        "  the bound C entry (_launch.entry, a dict lookup)": lambda: (
            _launch.entry(module.SOURCE, module._SYMBOL, module._ARGTYPES)),
        "  the output (torch.empty_like)": lambda: torch.empty_like(
            pos, dtype=torch.int32),
        "  the output (torch.empty, the earlier wrapper's)": lambda: (
            torch.empty((B, K), dtype=torch.int32, device=dev)),
        "  card and raw stream (_launch.target)": lambda: _launch.target(
            cdf),
        "  card and stream object (the earlier wrapper's)": lambda: (
            cdf.device.index,
            torch.cuda.current_stream(cdf.device.index).cuda_stream),
        "  the ctypes call and launch": lambda: fn(
            cdf.data_ptr(), pos.data_ptr(), idx.data_ptr(), B, K, K, card,
            stream),
    }
    for label, piece in pieces.items():
        print(f"host cost, {label}: {_host_us(piece):.2f} us/call",
              flush=True)
    return fields


def _k6_inputs(batch, k, kind, generator, dev, kp=None, d=1):
    """K6's log-weights N(0, 2^2) (the JAX package's test's), with all mass
    on one particle a row ('one_particle') or with two runs of -inf weight
    ('neg_inf'); Kp (default K) systematic positions, or uniform ones in no
    order ('unsorted'); D value columns (None for D = 0)."""
    kp = k if kp is None else kp
    logw = torch.randn(batch, k, generator=generator, device=dev) * 2.0
    if kind == "one_particle":
        hot = torch.randint(0, k, (batch,), generator=generator, device=dev)
        logw = torch.full((batch, k), float("-inf"), device=dev)
        logw[torch.arange(batch, device=dev), hot] = 0.0
    elif kind == "neg_inf":
        logw[:, :k // 4] = float("-inf")
        logw[:, k // 2:k // 2 + k // 8] = float("-inf")
    if kind == "unsorted":
        pos = torch.rand(batch, kp, generator=generator, device=dev)
    else:
        u = torch.rand(batch, 1, generator=generator, device=dev)
        pos = resample_cuda.systematic_positions(u, kp)
    value = (None if d == 0 else
             torch.randn(batch, k, d, generator=generator, device=dev))
    return logw, pos, value


def _k6_check(logw, pos, value, label):
    """K6 against its plain version: both build the same fixed-point CDF,
    so every index must be equal (tolerance 0), and the gathered values
    must be exactly those at its own indices."""
    if value is None:
        idx = searchsorted_cdf_cuda.searchsorted_cdf(logw, pos)
        want_idx = searchsorted_cdf_cuda.searchsorted_cdf_torch(logw, pos)
    else:
        idx, out = searchsorted_cdf_cuda.searchsorted_cdf(logw, pos, value)
        want_idx, _ = searchsorted_cdf_cuda.searchsorted_cdf_torch(
            logw, pos, value)
    torch.cuda.synchronize()
    if not torch.equal(idx, want_idx):
        differ = idx != want_idx
        raise AssertionError(
            f"K6 indices differ from its plain version at {label}: "
            f"{int(differ.sum())} of {idx.numel()}, by up to "
            f"{int((idx - want_idx).abs().max())} (tolerance 0)")
    if value is not None:
        own = torch.take_along_dim(value, idx.long().unsqueeze(-1), dim=1)
        if not _same_bits(out, own):
            raise AssertionError(f"K6 gathered other values than those at "
                                 f"its indices at {label}")
    print(f"K6 at {label}: all {idx.numel()} indices equal to its plain "
          f"version's (tolerance 0)"
          f"{'' if value is None else '; gathered values exact'}",
          flush=True)


def _k6_against_float64(logw, pos):
    """How far K6's indices, and those of the engine's float32 CDF
    (`_normalized_cumsum`, torch.cumsum), lie from a float64 CDF's."""
    k = logw.shape[1]
    lw = logw.double()
    cum = torch.cumsum(torch.exp(lw - lw.max(dim=1, keepdim=True).values),
                       dim=1)
    exact = torch.searchsorted(cum / cum[:, -1:], pos.double(),
                               right=True).clamp_(max=k - 1)
    float32 = torch.searchsorted(resampling._normalized_cumsum(logw), pos,
                                 right=True).clamp_(max=k - 1)
    for label, idx in (("K6", searchsorted_cdf_cuda.searchsorted_cdf(
            logw, pos).long()), ("a float32 torch.cumsum CDF", float32)):
        off = (idx - exact).abs()
        print(f"K6 at {tuple(logw.shape)}: {label} against a float64 CDF: "
              f"{float((off > 0).float().mean()):.4%} of indices differ, by "
              f"at most {int(off.max())}", flush=True)


def k6_phase(dev):
    """K6 against its plain version, exactly, and its entry point as its
    path; returns its JSON fields at (10, 10,000, 1)."""
    phase("3h K6 searchsorted_cdf against its plain version")
    generator = torch.Generator(device=dev).manual_seed(9)
    for batch, k, kp, d, kind in K6_CASES:
        logw, pos, value = _k6_inputs(batch, k, kind, generator, dev, kp, d)
        _k6_check(logw, pos, value, f"(B, K, Kp, D) = {(batch, k, kp, d)} "
                                    f"{kind}")
        if k >= 1000000:
            _k6_against_float64(logw, pos)

    logw, pos, value = _k6_inputs(B, K, "normal", generator, dev)
    # Its path is its entry point, called once as a user would.
    reset_counts()
    searchsorted_cdf_cuda.searchsorted_cdf(logw, pos, value)
    if read_counts("K6 entry point")["searchsorted_cdf"] != 1:
        raise AssertionError("searchsorted_cdf did not launch K6 once")
    fields = None
    for batch, k, kind in K6_TIMES:
        logw, pos, value = _k6_inputs(batch, k, kind, generator, dev)
        n = batch * k
        row = _kernel_row(
            "searchsorted_cdf", (batch, k, 1, kind),
            lambda: searchsorted_cdf_cuda.searchsorted_cdf(logw, pos, value),
            lambda: searchsorted_cdf_cuda.searchsorted_cdf_torch(logw, pos,
                                                                 value),
            None, 4 * 5 * n, 4 * n + n * _search_steps(k))
        if fields is None:
            fields = row
            # The port's own route to the same indices (not one PyTorch
            # call): the CDF from torch ops, then K3.
            def port_route():
                cdf = resampling._normalized_cumsum(logw)
                return resample_sorted_cuda.resample_and_gather_sorted(
                    cdf, pos, value)

            route_ms = _cuda_ms(port_route, 20, 200)
            print(f"the port's route (_normalized_cumsum + K3) at "
                  f"{(batch, k, 1)}: {route_ms * 1e3:.2f} us/call, device "
                  f"{_us(_calls_device_ms(port_route))} a call", flush=True)
    return fields


def rows_phase(dev):
    """Every kernel at B = 65,536 rows (more than a grid's second dimension
    holds) and K = 4, against its plain version, exactly."""
    phase(f"3i every kernel at B = {ROWS_B:,} rows, K = {ROWS_K}")
    generator = torch.Generator(device=dev).manual_seed(10)
    cdf, u, value = _case_inputs(ROWS_B, ROWS_K, 2, "normal", generator, dev)
    pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                          "stratified")
    g = torch.randint(-5, 6, value.shape, generator=generator,
                      device=dev).float()
    ints = _k5_value(torch.int32, (ROWS_B, ROWS_K, 3), generator, dev)
    idx = searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf, pos)
    pairs = {
        "resample_systematic": (
            resample_cuda.resample_and_gather_systematic(cdf, u, value),
            resample_cuda.resample_and_gather_systematic_torch(cdf, u,
                                                               value)),
        "range_sum": (range_sum_cuda.range_sum(cdf, pos, g),
                      range_sum_cuda.range_sum_torch(cdf, pos, g)),
        "resample_sorted": (
            resample_sorted_cuda.resample_and_gather_sorted(cdf, pos, value),
            resample_sorted_cuda.resample_and_gather_sorted_torch(cdf, pos,
                                                                  value)),
        "searchsorted_sorted": (
            searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos), idx),
        "gather_sorted": (gather_sorted_cuda.gather_sorted(ints, idx),
                          gather_sorted_cuda.gather_sorted_torch(ints, idx)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"B = {ROWS_B}")
        print(f"{name} at (B, K) = {(ROWS_B, ROWS_K)}: exact (tolerance 0)",
              flush=True)
    logw, pos, value = _k6_inputs(ROWS_B, ROWS_K, "normal", generator, dev)
    _k6_check(logw, pos, value, f"(B, K, D) = {(ROWS_B, ROWS_K, 1)} normal")


# Phase 3k: the CDF kernel (`ops.normalized_cdf_cuda`) against the plain
# CDF (`resampling._normalized_cumsum`) at the shapes of the paths that
# build it on the 'cuda' route: the filters' (10, 10,000), serving's (64,
# 10,000), the VRNN step's (16, 4,096), the sampler's one row of 262,144,
# the soft step's (2, 10^6) and one row of 4,194,304; then SMC^2's [M B,
# 256] rows, the block PF's [J B, K] rows and IF2's (8, 32,768).
CDF_SHAPES = ((10, 10000), (64, 10000), (16, 4096), (1, 262144),
              (2, 1000000), (1, 4194304), (128, 256), (1024, 256),
              (16, 1024), (128, 4096), (8, 32768))
# One entry, a one-block row's longest and a two-block cluster's shortest
# (a block a 2,048 entries), a chunk of one tile of 1,024 threads and one
# of two (K = 8 x 8,192 and one more), and more rows than a grid
# dimension holds.
CDF_EDGES = ((1, 1), (3, 2048), (3, 2049), (3, 65536), (3, 65537),
             (ROWS_B + 1, ROWS_K))
CDF_REPEATS = 10
# K1's ancestors on the kernel's CDF against those on the plain CDF, the
# same uniforms, at K <= CDF_ANCESTOR_MAX_K: fewer than this share differ,
# each by at most this many slots (the bound of
# tests/test_resample_pallas.py::test_near_exact_large).
CDF_ANCESTOR_MAX_K = 100000
CDF_ANCESTOR_SHARE, CDF_ANCESTOR_SHIFT = 0.005, 3
# The kernel's largest |CDF - float64 CDF| within this factor of the plain
# CDF's.
CDF_FLOAT64_FACTOR = 2.0
# Serving rows (the benchmark's lgssm-serve cell).
CDF_SERVE_B = 64


@contextlib.contextmanager
def _plain_cdf():
    """The 'cuda' route with the plain CDF (`_normalized_cumsum`) in place
    of the CDF kernel: for checks that feed one CDF to both sides."""
    kernel = resampling._cuda_route_cdf
    resampling._cuda_route_cdf = resampling._normalized_cumsum
    try:
        yield
    finally:
        resampling._cuda_route_cdf = kernel


# The kernel route with the CDF kernel against the plain route on the same
# noise (`_against_plain`). The two CDFs differ by float32 rounding (phase
# 3k), so the first resampling step's ancestors differ at bin edges only,
# at fewer than `CDF_ANCESTOR_SHARE` of the slots (phase 3k's shift bound
# holds on its N(0, 2^2) weights; where a step's weights are degenerate a
# flip skips the zero-weight particles between two bins, and a CDF
# rounded from float64 moves the same slots as far). Once one differs,
# the runs part, as the plain route parts from itself when it searches a
# CDF rounded from float64 instead (`_rounded_plain_cdf`, printed
# beside). Log-Z, or the loss, of every row within these shares of the
# plain route's, set from readings on an H100 (4-8 seeds a path, PERF.md
# §6): the LGSSM filter with the bench's proposal
# read 0.0042-0.0106 (the rounded CDF 0.0037-0.0085; log-Z's spread over
# seeds is 1.4% there), the HMM filter 1.0-1.9e-5 (6.3e-6 to 9.8e-5), the
# losses at K = 100 and 256 0 to 1.6e-6 (0), the soft loss at 10^6
# 1.2e-4 to 2.5e-3 (1.8e-4 to 1.6e-3).
ROUTE_RTOL = {"lgssm": 0.03, "hmm": 5e-4, "loss": 1e-4, "soft": 1e-2}


def _float64_rounded_cdf(log_weight):
    """`_normalized_cumsum`'s contract, summed in float64 and rounded to
    float32 once: another float32 rounding of the same CDF."""
    lw = log_weight.double()
    cum = torch.exp(lw - lw.max(dim=1, keepdim=True).values).cumsum(dim=1)
    cdf = torch.cummax((cum / cum[:, -1:]).float(), dim=1).values
    return resampling._pin_last(cdf)


@contextlib.contextmanager
def _rounded_plain_cdf():
    """The plain route searching `_float64_rounded_cdf`, for a reading of
    how far float32 rounding of the CDF moves a path."""
    plain = resampling._normalized_cumsum
    resampling._normalized_cumsum = _float64_rounded_cdf
    try:
        yield
    finally:
        resampling._normalized_cumsum = plain


def _against_plain(label, kernel, plain, rounded, rtol, ancestors=None):
    """``kernel``: log-Z `[B]` (or a loss) of the kernel route with the CDF
    kernel; ``plain``: the plain route's on the same noise; ``rounded``:
    the plain route's with `_rounded_plain_cdf`. Each row within ``rtol``
    of the plain route's; with ``ancestors`` (the two routes' `[T - 1, B,
    K]` ancestors), the first resampling step's differ at fewer than
    `CDF_ANCESTOR_SHARE` of the slots."""
    got, want, other = (torch.as_tensor(x).double().reshape(-1).cpu()
                        for x in (kernel, plain, rounded))
    rel = float(((got - want).abs() / want.abs()).max())
    rel_rounded = float(((other - want).abs() / want.abs()).max())
    line = (f"{label}: the kernel route with the CDF kernel within relative "
            f"{rel:.3g} of the plain route (bound {rtol:g}; the plain route "
            f"on a CDF rounded from float64: {rel_rounded:.3g})")
    far = not rel <= rtol
    if ancestors is not None:
        a, b = (x.long() for x in ancestors)
        shift = (a[0] - b[0]).abs()
        share, most = float((shift > 0).float().mean()), int(shift.max())
        later = float((a[1:] != b[1:]).float().mean())
        line += (f"; the first step's ancestors differ at {share:.4%} of the "
                 f"slots (bound {CDF_ANCESTOR_SHARE:.1%}), by at most {most}, "
                 f"the later steps' at {later:.2%}")
        far = far or share >= CDF_ANCESTOR_SHARE
    print(line, flush=True)
    if far:
        raise AssertionError(f"{label}: the CDF kernel's route is too far "
                             f"from the plain route")


def _cdf_inputs(batch, k, kind, generator, dev):
    """`[B, K]` log-weights: N(0, 2^2), with runs of -inf, with one
    particle 60 nats above the rest, or with the last row all -inf."""
    logw = 2.0 * torch.randn(batch, k, generator=generator, device=dev)
    if kind == "-inf runs":
        logw[:, k // 4:k // 2] = -math.inf
        logw[:, -min(k // 8, 100):] = -math.inf
    elif kind == "one particle":
        logw[:, k // 3] += 60.0
    elif kind == "nan row":
        logw[-1] = -math.inf
    return logw


def _cdf_float64_err(cdf, logw):
    """The largest |cdf - the float64 CDF of logw| over the finite rows."""
    lw = logw.double()
    ref = torch.exp(lw - lw.max(dim=1, keepdim=True).values).cumsum(dim=1)
    ref = ref / ref[:, -1:]
    return float((cdf.double() - ref).abs().max())


def _cdf_check(logw, label, float64=False):
    """The kernel's CDF of ``logw``: monotone, in [0, 1], its last entry
    exactly 1, the same bits on `CDF_REPEATS` launches, NaN where the plain
    CDF is NaN; with ``float64``, within `CDF_FLOAT64_FACTOR` of the plain
    CDF's error against a float64 CDF. Returns (kernel CDF, plain CDF)."""
    got = normalized_cdf_cuda.normalized_cdf(logw)
    plain = resampling._normalized_cumsum(logw)
    repeats = [normalized_cdf_cuda.normalized_cdf(logw)
               for _ in range(CDF_REPEATS - 1)]
    torch.cuda.synchronize()
    if not all(_same_bits(got, r) for r in repeats):
        raise AssertionError(f"CDF kernel at {label}: {CDF_REPEATS} launches "
                             f"gave different bits")
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(plain)):
        raise AssertionError(f"CDF kernel at {label}: NaN where the plain CDF"
                             f" is not, or the reverse")
    finite = ~nan.any(dim=1)
    rows = got[finite]
    if not (bool((rows[:, 1:] >= rows[:, :-1]).all()) and
            bool((rows >= 0).all()) and bool((got[:, -1] == 1.0).all())):
        raise AssertionError(f"CDF kernel at {label}: not monotone in [0, 1] "
                             f"with its last entry 1")
    diff = float((rows - plain[finite]).abs().max()) if rows.numel() else 0.0
    line = (f"CDF kernel at {label}: monotone, last entry 1.0, "
            f"{CDF_REPEATS} launches bit-equal, NaN rows as the plain CDF's; "
            f"largest |kernel - plain| {diff:.3g}")
    if float64:
        err, plain_err = (_cdf_float64_err(got, logw),
                          _cdf_float64_err(plain, logw))
        line += (f"; against float64: kernel {err:.3g}, plain "
                 f"{plain_err:.3g}")
        if err > CDF_FLOAT64_FACTOR * plain_err:
            raise AssertionError(f"{line}: the kernel is more than "
                                 f"{CDF_FLOAT64_FACTOR}x the plain error")
    print(line, flush=True)
    return got, plain


def _cdf_ancestors(got, plain, generator, label):
    """K1's indices on the two CDFs with the same uniforms."""
    u = torch.rand(got.shape[0], 1, generator=generator, device=got.device)
    none = got.new_empty(tuple(got.shape) + (0,))
    idx, _ = resample_cuda.resample_and_gather_systematic(got, u, none)
    want, _ = resample_cuda.resample_and_gather_systematic(plain, u, none)
    shift = (idx - want).abs()
    share = float((shift > 0).float().mean())
    most = int(shift.max())
    print(f"K1 at {label} on the kernel's CDF against the plain CDF, same "
          f"uniforms: {share:.4%} of the ancestors differ, by at most {most} "
          f"(bounds {CDF_ANCESTOR_SHARE:.1%}, {CDF_ANCESTOR_SHIFT})",
          flush=True)
    if share >= CDF_ANCESTOR_SHARE or most > CDF_ANCESTOR_SHIFT:
        raise AssertionError(f"K1's ancestors at {label} moved too far")


def _cdf_times(logw, label):
    """Device µs a launch of the kernel against a call of the plain CDF
    (torch.profiler), and CUDA-event means of both in turns; the kernel is
    never slower on the card."""
    batch, k = logw.shape

    def kernel_fn():
        return normalized_cdf_cuda.normalized_cdf(logw)

    def plain_fn():
        return resampling._normalized_cumsum(logw)

    ms, plain_ms, _, runs = _time_pair(kernel_fn, plain_fn, warmup=5,
                                       repeat=20 if k > 10 ** 6 else 100)
    device_ms = _device_ms(kernel_fn, "normalized_cdf", calls=20)
    plain_device_ms = _calls_device_ms(plain_fn, calls=20)
    bound_ms, bound_by = _bound(8 * batch * k, 4 * batch * k)
    print(f"CDF kernel at {label}: device {_us(device_ms)} a launch, plain "
          f"{_us(plain_device_ms)} a call; {ms * 1e3:.2f} against "
          f"{plain_ms * 1e3:.2f} us a call by CUDA events (runs {runs}); "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
    if device_ms is None or plain_device_ms is None or \
            device_ms > plain_device_ms:
        raise AssertionError(f"CDF kernel at {label} is slower than the plain"
                             f" CDF on the card")
    return dict(shape=[batch, k], device_ms=device_ms,
                plain_device_ms=plain_device_ms, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms)


def _cdf_filter_graphs(dev):
    """One graphed LGSSM filter call at (T, B, K), captured with the CDF
    kernel and with the plain CDF: the kernel's launches in the capture and
    in one profiled replay, the ops on the card a replay, and replays of
    the two graphs timed in turns."""
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    noise = NoiseSource.seeded(31, dev)

    def call():
        return inference.infer(
            "smc", obs, *comps, K, noise=noise,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"]

    graphs = {}
    for which in ("plain", "kernel"):
        with (_plain_cdf() if which == "plain" else
              contextlib.nullcontext()), torch.no_grad():
            train._warm_up(call, 1)
            before = normalized_cdf_cuda.LAUNCHES
            graphs[which] = train._capture(call, noise.generator)[0]
            launches = normalized_cdf_cuda.LAUNCHES - before
        print(f"graphed LGSSM filter ({which} CDF): {launches} CDF kernel "
              f"launches in the capture", flush=True)
        if launches != (T - 1 if which == "kernel" else 0):
            raise AssertionError(f"the graphed filter launched the CDF kernel"
                                 f" {launches} times, not {T - 1}")
    for which, graph in graphs.items():
        graph.replay()
        torch.cuda.synchronize()
        with _profiled() as prof:
            graph.replay()
        events = prof.key_averages()
        ops = sum(e.count for e in _on_card(events))
        cdf = sum(e.count for e in events if "normalized_cdf" in e.key)
        print(f"one replay ({which} CDF): {ops} ops on the card, {cdf} CDF "
              f"kernels", flush=True)
        if cdf != (T - 1 if which == "kernel" else 0):
            raise AssertionError(f"a replay ran {cdf} CDF kernels")
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which] += _cuda_ms(graphs[which].replay, 3, 20, each=True)
    med = {which: float(np.median(r)) for which, r in runs.items()}
    print(f"graphed LGSSM filter at ({T}, {B}, {K:,}): median "
          f"{med['kernel']:.3f} ms a replay with the CDF kernel against "
          f"{med['plain']:.3f} with the plain CDF (n = 40 each)", flush=True)
    return med


def _cdf_serving(dev):
    """The serving step at (64, K), captured with the CDF kernel and with
    the plain CDF: µs a replay back to back (the step on the card), in
    turns; and the exported step, which records the kernel's operator."""
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT, batch=CDF_SERVE_B)
    init_fn, step_fn = online.make_online_filter(*comps, K)
    noise = NoiseSource.seeded(47, dev)
    with torch.no_grad():
        state = init_fn(obs[0], noise)
        steps = {}
        for which in ("plain", "kernel"):
            with (_plain_cdf() if which == "plain" else
                  contextlib.nullcontext()):
                steps[which] = online.CapturedStep(step_fn, state, obs[1],
                                                   noise)
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(_cuda_ms(steps[which].graph.replay, 10, 200))
    med = {which: float(np.mean(r)) for which, r in runs.items()}
    print(f"captured serving step at ({CDF_SERVE_B}, {K:,}), replays back to "
          f"back: {med['kernel'] * 1e3:.1f} us a step with the CDF kernel "
          f"against {med['plain'] * 1e3:.1f} with the plain CDF (runs "
          f"{runs})", flush=True)
    with torch.no_grad():
        blob = online.export_step(step_fn, state, obs[1])
        program = torch.export.load(io.BytesIO(blob))
        recorded = "aesmc_tpu_torch.normalized_cdf" in \
            program.graph_module.code
        step = online.load_step(blob)
        start = noise.generator.get_state()
        live = step_fn(state, obs[1], noise)
        noise.generator.set_state(start)
        before = normalized_cdf_cuda.LAUNCHES
        loaded = step(state, obs[1], noise)
        torch.cuda.synchronize()
    launches = normalized_cdf_cuda.LAUNCHES - before
    same = _same_tree((online._fields(live[0]), live[1]),
                      (online._fields(loaded[0]), loaded[1]))
    print(f"export_step: the program records the CDF kernel's operator "
          f"{recorded}; a loaded step launched it {launches} time; equal to "
          f"the live step {same}", flush=True)
    if not (recorded and launches == 1 and same):
        raise AssertionError("the exported step does not run the CDF kernel "
                             "as the live step does")
    return med


@torch.no_grad()
def cdf_phase(dev):
    phase("3k the CDF kernel against the plain CDF")
    start = time.perf_counter()
    generator = torch.Generator(device=dev).manual_seed(12)
    for batch, k in CDF_EDGES:
        logw = _cdf_inputs(batch, k, "normal", generator, dev)
        got, plain = _cdf_check(logw, f"(B, K) = {(batch, k)}")
        if k == 1 and not bool((got == 1.0).all()):
            raise AssertionError("the CDF of one particle is not 1")
    for kind in ("-inf runs", "one particle", "nan row"):
        for k in (K, 10 * K):
            _cdf_check(_cdf_inputs(4, k, kind, generator, dev),
                       f"(4, {k:,}) {kind}")
    times = []
    for batch, k in CDF_SHAPES:
        label = f"(B, K) = ({batch}, {k:,})"
        logw = _cdf_inputs(batch, k, "normal", generator, dev)
        got, plain = _cdf_check(logw, label, float64=True)
        if k <= CDF_ANCESTOR_MAX_K:
            _cdf_ancestors(got, plain, generator, label)
        del got, plain
        times.append(_cdf_times(logw, label))
    filter_ms = _cdf_filter_graphs(dev)
    serve_ms = _cdf_serving(dev)
    print(json.dumps({"cdf_kernel": times, "filter_replay_ms": filter_ms,
                      "serve_step_ms": serve_ms}), flush=True)
    _phase_seconds("3k", start)
    return times


@torch.no_grad()
def filter_phase(dev):
    phase("4 filter: LGSSM SMC, T=200, B=10, K=10,000")
    initial = lgssm.Initial(0.0, 1.0)
    transition = lgssm.Transition(TRANSITION_MULT, TRANSITION_SCALE).to(dev)
    emission = lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev)
    # bench.py's proposal: random affine weights from a seed.
    proposal = lgssm.Proposal.create(
        1.0, 1.0, torch.Generator().manual_seed(0)).to(dev)
    optimal = lgssm.optimal_proposal(
        0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE).to(dev)

    _, obs = statistics.sample_from_prior(initial, transition, emission, T,
                                          B, NoiseSource.seeded(0, dev))

    def smc(prop, seed, implementation="auto", **returns):
        return inference.infer(
            "smc", obs, initial, transition, emission, prop, K,
            noise=NoiseSource.seeded(seed, dev),
            resampling_implementation=implementation,
            return_log_marginal_likelihood=True, **returns)

    # The main path: log-Z only, so K1 runs without its index output.
    reset_counts()
    out = smc(proposal, 1, return_latents=False, return_log_weight=False)
    counts = read_counts("filter")
    launches = counts["resample_systematic"]
    log_z = out["log_marginal_likelihood"]
    if (launches, counts[CDF]) != (T - 1, T - 1):
        raise AssertionError(f"K1 and the CDF kernel launched {counts}, not "
                             f"{T - 1} times each")
    if log_z.shape != (B,) or not bool(torch.isfinite(log_z).all()):
        raise AssertionError(f"bad log-Z {log_z}")
    print(f"log-Z-only call: {launches} K1 launches (emit_idx off), "
          f"{counts[CDF]} of the CDF kernel, log-Z {log_z.cpu().numpy()}",
          flush=True)

    # Lineage outputs turn the index output on. The plain route with the
    # same seed: with the CDF kernel within `_against_plain`'s bounds;
    # given the plain CDF, the same ancestors, latents and log-Z.
    reset_counts()
    kern = smc(proposal, 2, return_ancestral_indices=True)
    counts = read_counts("filter lineage call")
    if (counts["resample_systematic"], counts[CDF]) != (T - 1, T - 1):
        raise AssertionError(f"lineage call launched {counts}")
    anc = kern["ancestral_indices"]
    if anc.shape != (T - 1, B, K) or anc.dtype != torch.int32:
        raise AssertionError(f"bad ancestors {anc.shape} {anc.dtype}")
    reset_counts()
    plain = smc(proposal, 2, "torch", return_ancestral_indices=True)
    if any(read_counts("filter lineage call, plain route").values()):
        raise AssertionError("the plain route launched a kernel")
    with _rounded_plain_cdf():
        rounded = smc(proposal, 2, "torch", return_latents=False)
    _against_plain("LGSSM lineage call, log-Z",
                   kern["log_marginal_likelihood"],
                   plain["log_marginal_likelihood"],
                   rounded["log_marginal_likelihood"], ROUTE_RTOL["lgssm"],
                   (anc, plain["ancestral_indices"]))
    with _plain_cdf():
        kern = smc(proposal, 2, return_ancestral_indices=True)
    anc = kern["ancestral_indices"]
    mismatches = int((anc != plain["ancestral_indices"]).sum())
    if mismatches or not torch.equal(kern["latents"], plain["latents"]):
        raise AssertionError(
            f"lineage call differs from the plain route given one CDF: "
            f"{mismatches} ancestors")
    lz_err = float((kern["log_marginal_likelihood"] -
                    plain["log_marginal_likelihood"]).abs().max())
    if lz_err != 0.0:
        raise AssertionError(f"log-Z differs from the plain route given one "
                             f"CDF: {lz_err}")
    print(f"lineage call (emit_idx on), given the plain CDF: ancestors "
          f"{tuple(anc.shape)} and latents {tuple(kern['latents'].shape)} "
          f"equal the plain route's", flush=True)

    # Accuracy against the exact Kalman filter, optimal proposal.
    est = smc(optimal, 3, return_latents=False)["log_marginal_likelihood"]
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=EMISSION_SCALE ** 2)
    obs_np = obs.cpu().numpy()
    exact = np.array([kalman.kalman_filter(obs_np[:, b], params)[4]
                      for b in range(B)])
    rel = np.abs(est.cpu().numpy() - exact) / np.abs(exact)
    print(f"log-Z vs Kalman, optimal proposal: max relative error "
          f"{rel.max():.3e} (bound {LOG_Z_REL_TOL})", flush=True)
    if not np.all(rel < LOG_Z_REL_TOL):
        raise AssertionError(f"log-Z off the Kalman filter: {rel}")

    # Times: plain, kernel, kernel, plain, all in this one process.
    def filt(implementation):
        return lambda: smc(proposal, 4, implementation,
                           return_latents=False, return_log_weight=False)

    torch.cuda.reset_peak_memory_stats()
    slice_ms = {"torch": [], "cuda": []}
    for implementation in ("torch", "cuda", "cuda", "torch"):
        slice_ms[implementation] += _cuda_ms(
            filt(implementation), warmup=2, repeat=5, each=True)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for implementation, label in (("cuda", "K1 route"),
                                  ("torch", "plain route")):
        q1, med, q3 = _quartiles(slice_ms[implementation])
        print(f"SMC log-Z call, {label}: median {med:.3f} ms/call "
              f"(quartiles {q1:.3f}, {q3:.3f}; n="
              f"{len(slice_ms[implementation])}) = "
              f"{B * K * T / med * 1e3:.4g} particle-steps/s", flush=True)
    print(f"peak device memory {peak_mb:.1f} MiB", flush=True)

    cdf, u, value = _case_inputs(B, K, 1, "normal",
                                 torch.Generator(device=dev).manual_seed(5),
                                 dev)
    ms, plain_ms, _, runs = _time_pair(
        lambda: resample_cuda.resample_and_gather_systematic(
            cdf, u, value, True),
        lambda: resample_cuda.resample_and_gather_systematic_torch(
            cdf, u, value, True))
    print(f"K1 at [{B}, {K}], D=1, emit_idx=True: kernel {ms * 1e3:.2f} "
          f"us/call (runs {runs['kernel']}), plain {plain_ms * 1e3:.2f} "
          f"us/call (runs {runs['plain']})", flush=True)
    _profile(filt("cuda"), "one filter call")


def _profile(fn, label):
    """Device time by kernel name over one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with _profiled() as prof:
        fn()
    print(f"profile of {label}:", flush=True)
    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    # The port's kernels, wherever they rank.
    for kernel in sorted({name for _, _, name, _ in KERNELS.values()}):
        rows = [e for e in events if kernel in e.key]
        total_us = sum(getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
                       for e in rows)
        count = sum(e.count for e in rows)
        if count:
            print(f"{kernel}: {total_us / 1e3:.3f} ms of device time in "
                  f"{count} launches ({total_us / count:.2f} us each)",
                  flush=True)


def _bench_lgssm(dev, transition_mult, batch=B):
    """bench.py's LGSSM components on the card, the transition trainable
    from ``transition_mult``, and ``batch`` rows of observations from the
    true model."""
    initial = lgssm.Initial(0.0, 1.0)
    emission = lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev)
    proposal = lgssm.Proposal.create(
        1.0, 1.0, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            initial, lgssm.Transition(TRANSITION_MULT,
                                      TRANSITION_SCALE).to(dev),
            emission, T, batch, NoiseSource.seeded(0, dev))
    transition = lgssm.Transition(transition_mult, TRANSITION_SCALE).to(dev)
    return (initial, transition, emission, proposal), obs


def _compare_routes(comps, obs, k, method, seed, dev, **loss_kwargs):
    """The loss and gradients of the kernel route, given the plain CDF,
    against the plain route on the same noise; then the kernel route's
    loss with the CDF kernel (`_against_plain`). Returns the worst
    relative gradient error."""
    params = train.get_chained_params(*comps)

    def loss_of(implementation):
        return losses.get_loss(obs, k, "aesmc", *comps,
                               noise=NoiseSource.seeded(seed, dev),
                               resampling_method=method,
                               resampling_implementation=implementation,
                               **loss_kwargs)

    results = {}
    for implementation in ("cuda", "torch"):
        with (_plain_cdf() if implementation == "cuda" else
              contextlib.nullcontext()):
            loss = loss_of(implementation)
        results[implementation] = (loss.detach(),
                                   torch.autograd.grad(loss, params))
    (loss_k, grads_k), (loss_t, grads_t) = results["cuda"], results["torch"]
    if not torch.equal(loss_k, loss_t):
        raise AssertionError(
            f"{method} loss differs between the routes given one CDF: "
            f"{float(loss_k)} vs {float(loss_t)}")
    # Relative to each parameter's largest gradient entry.
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads_k, grads_t))
    if worst > GRAD_RTOL:
        raise AssertionError(
            f"{method} gradients differ between the routes: worst relative "
            f"error {worst} above {GRAD_RTOL}")
    print(f"{method} K={k}: loss {float(loss_k):.6f} equal on both routes "
          f"given the plain CDF; gradients within relative error "
          f"{worst:.3g} (bound {GRAD_RTOL})", flush=True)
    with torch.no_grad():
        kernel = loss_of("cuda")
        with _rounded_plain_cdf():
            rounded = loss_of("torch")
    _against_plain(f"{method} K={k} loss", kernel, loss_t, rounded,
                   ROUTE_RTOL["soft" if method == "soft" else "loss"])
    return worst


def train_phase(dev):
    phase("5 train: AESMC train step, T=200, B=10, K=100")
    comps, obs = _bench_lgssm(dev, 0.5)
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-2)
    _compare_routes(comps, obs, TRAIN_K, "systematic", 11, dev)

    # The main path: one train step as a user calls it.
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer)
    reset_counts()
    loss = step(comps, obs, NoiseSource.seeded(12, dev))
    counts = read_counts("train K=100")
    if (counts["resample_systematic"], counts["range_sum"],
            counts[CDF]) != (T - 1, T - 1, T - 1):
        raise AssertionError(f"one train step launched {counts}, not K1, "
                             f"K2 and the CDF kernel {T - 1} times each")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"train step loss {loss}")

    # Step times, plain route against kernel route.
    steps = {impl: train.make_train_step(
        TRAIN_K, "aesmc", optimizer, resampling_implementation=impl)
        for impl in ("cuda", "torch")}
    noise = NoiseSource.seeded(13, dev)
    step_ms = {"cuda": [], "torch": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        step_ms[impl] += _cuda_ms(lambda: steps[impl](comps, obs, noise),
                                  warmup=2, repeat=6, each=True)
    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        q1, med, q3 = _quartiles(step_ms[impl])
        EAGER_MS[f"train {impl}"] = med
        print(f"AESMC train step K={TRAIN_K}, {label}: median {med:.3f} "
              f"ms/step (quartiles {q1:.3f}, {q3:.3f}; n="
              f"{len(step_ms[impl])}) = {1e3 / med:.2f} steps/s", flush=True)
    _profile(lambda: steps["cuda"](comps, obs, noise),
             f"one train step at K={TRAIN_K}")

    # Stratified and multinomial: K3 forward, K2 backward.
    for method in ("stratified", "multinomial"):
        _compare_routes(comps, obs, TRAIN_K, method, 14, dev)
        method_step = train.make_train_step(TRAIN_K, "aesmc", optimizer,
                                            resampling_method=method)
        reset_counts()
        loss = method_step(comps, obs, NoiseSource.seeded(15, dev))
        counts = read_counts(f"train {method} K=100")
        if (counts["resample_sorted"], counts["range_sum"],
                counts["resample_systematic"], counts[CDF]) != (
                    T - 1, T - 1, 0, T - 1):
            raise AssertionError(f"one {method} step launched {counts}")
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"{method} step loss {loss}")

    # The filter's width: a few steps at K=10,000, with peak memory.
    big_steps = {impl: train.make_train_step(
        K, "aesmc", optimizer, resampling_implementation=impl)
        for impl in ("cuda", "torch")}
    torch.cuda.reset_peak_memory_stats()
    big_steps["cuda"](comps, obs, noise)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    big_ms = {"cuda": [], "torch": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        big_ms[impl] += _cuda_ms(lambda: big_steps[impl](comps, obs, noise),
                                 warmup=1, repeat=2, each=True)
    EAGER_MS["train K=10000"] = float(np.median(big_ms["cuda"]))
    EAGER_MS["peak K=10000"] = peak_mb
    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        q1, med, q3 = _quartiles(big_ms[impl])
        print(f"AESMC train step K={K}, {label}: median {med:.3f} ms/step "
              f"(quartiles {q1:.3f}, {q3:.3f}; runs {big_ms[impl]})",
              flush=True)
    print(f"peak device memory of one K={K} step: {peak_mb:.1f} MiB",
          flush=True)

    recovery_phase(dev)


def recovery_phase(dev):
    """The JAX package's LGSSM recovery test (tests/test_train.py:98-129)
    on the card: T=20, B=16, K=50, 150 Adam steps at lr 5e-2 from
    a0 = c0 = 0, from that test's initial proposal."""
    true_a, true_c, a0, c0 = 0.9, 1.0, 0.0, 0.0
    scale_0, scale_t = lgssm.optimal_proposal_scales(1.0, 1.0, true_c, 0.1)
    loader = train.get_synthetic_dataloader(
        lgssm.Initial(0.0, 1.0), lgssm.Transition(true_a, 1.0).to(dev),
        lgssm.Emission(true_c, 0.1).to(dev), 20, 16,
        NoiseSource.seeded(0, dev))
    # aesmc_tpu's lgssm.Proposal.create(scale_0, scale_t, PRNGKey(0)).
    proposal = lgssm.Proposal(0.68462825, -0.98541236,
                              [0.5691495, 0.5830701], -0.32952663,
                              scale_0, scale_t).to(dev)
    start = time.perf_counter()
    _, transition, emission, _ = train.train(
        loader, 50, "aesmc", lgssm.Initial(0.0, 1.0),
        lgssm.Transition(a0, 1.0).to(dev), lgssm.Emission(c0, 0.1).to(dev),
        proposal, num_epochs=1, num_iterations_per_epoch=150,
        optimizer_kwargs={"lr": 5e-2}, noise=NoiseSource.seeded(3, dev))
    a, c = transition.mult.item(), emission.mult.item()
    seconds = time.perf_counter() - start
    err0 = float(np.linalg.norm([a0 - true_a, c0 - true_c]))
    err = float(np.linalg.norm([a - true_a, c - true_c]))
    print(f"recovery: a {a:.4f} (truth {true_a}), c {c:.4f} (truth "
          f"{true_c}); err {err:.4f} vs err0 {err0:.4f} (bound 0.5 err0); "
          f"150 steps in {seconds:.2f} s", flush=True)
    if not err < 0.5 * err0:
        raise AssertionError(f"recovery failed: err {err}, err0 {err0}")


def _hmm_data(dev, num_timesteps, batch, seed, **model):
    """`hmm.make_model(**model)` on the card and observations from it."""
    comps = hmm.make_model(device=dev, **model)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            *comps[:3], num_timesteps, batch, NoiseSource.seeded(seed, dev))
    return comps, obs


def _hmm_exact(comps, obs):
    """The forward recursion's log-likelihood of each batch row."""
    initial, transition, emission, _ = comps
    args = (initial.logits.cpu().numpy(), transition.logits.cpu().numpy(),
            emission.locs.detach().cpu().numpy(), emission.scale)
    obs_np = obs.cpu().numpy()
    return np.array([hmm.hmm_forward(obs_np[:, b], *args)[1]
                     for b in range(obs_np.shape[1])])


@torch.no_grad()
def hmm_filter_phase(dev):
    phase(f"6 HMM filter: D={HMM_STATES}, fully adapted proposal, T={T}, "
          f"B={B}, K={K:,}")
    comps, obs = _hmm_data(dev, T, B, 0, num_states=HMM_STATES)

    def smc(seed, implementation="auto", method="systematic", **returns):
        return inference.infer(
            "smc", obs, *comps, K, noise=NoiseSource.seeded(seed, dev),
            resampling_method=method,
            resampling_implementation=implementation,
            return_log_marginal_likelihood=True, **returns)

    # The main path: log-Z only. The int32 particles take K5, and K1 runs
    # with no value columns for the indices K5 needs.
    reset_counts()
    out = smc(1, return_latents=False, return_log_weight=False)
    counts = read_counts("hmm filter")
    log_z = out["log_marginal_likelihood"]
    if (counts["resample_systematic"], counts["gather_sorted"],
            counts[CDF]) != (T - 1, T - 1, T - 1):
        raise AssertionError(f"the HMM log-Z call launched {counts}, not "
                             f"K1, K5 and the CDF kernel {T - 1} times "
                             f"each")
    if log_z.shape != (B,) or not bool(torch.isfinite(log_z).all()):
        raise AssertionError(f"bad HMM log-Z {log_z}")
    print(f"log-Z-only call: K1 (indices only) and K5 {T - 1} launches "
          f"each, log-Z {log_z.cpu().numpy()}", flush=True)

    reset_counts()
    smc(1, method="stratified", return_latents=False,
        return_log_weight=False)
    counts = read_counts("hmm filter stratified")
    if (counts["searchsorted_sorted"], counts["gather_sorted"],
            counts["resample_sorted"], counts[CDF]) != (T - 1, T - 1, 0,
                                                        T - 1):
        raise AssertionError(f"the stratified HMM call launched {counts}")

    # Lineage outputs, kernel route against plain route on the same noise:
    # with the CDF kernel within `_against_plain`'s bounds; given the plain
    # CDF, equal.
    kern = smc(2, "cuda", return_ancestral_indices=True)
    plain = smc(2, "torch", return_ancestral_indices=True)
    with _rounded_plain_cdf():
        rounded = smc(2, "torch", return_latents=False)
    _against_plain("HMM lineage call, log-Z", kern["log_marginal_likelihood"],
                   plain["log_marginal_likelihood"],
                   rounded["log_marginal_likelihood"], ROUTE_RTOL["hmm"],
                   (kern["ancestral_indices"], plain["ancestral_indices"]))
    bench_log_z = kern["log_marginal_likelihood"]
    with _plain_cdf():
        kern = smc(2, "cuda", return_ancestral_indices=True)
    lat, anc = kern["latents"], kern["ancestral_indices"]
    if lat.dtype != torch.int32 or lat.shape != (T, B, K):
        raise AssertionError(f"bad HMM latents {lat.dtype} {lat.shape}")
    same = (torch.equal(lat, plain["latents"]) and
            torch.equal(anc, plain["ancestral_indices"]) and
            torch.equal(kern["log_marginal_likelihood"],
                        plain["log_marginal_likelihood"]))
    if not same:
        raise AssertionError(
            f"HMM lineage call differs from the plain route: "
            f"{int((anc != plain['ancestral_indices']).sum())} ancestors, "
            f"{int((lat != plain['latents']).sum())} latents")
    print(f"lineage call given the plain CDF: int32 latents "
          f"{tuple(lat.shape)}, ancestors and log-Z equal the plain route's "
          f"exactly", flush=True)
    bench_dev = np.abs(bench_log_z.cpu().numpy() - _hmm_exact(comps, obs))
    print(f"log-Z vs the forward recursion at the bench's shape "
          f"(systematic): per-row deviation {np.round(bench_dev, 4)}, max "
          f"{bench_dev.max():.4f}, mean {bench_dev.mean():.4f}", flush=True)

    # Accuracy at the JAX test's settings, multinomial, 8 noise seeds.
    tcomps, tobs = _hmm_data(dev, HMM_TEST_T, HMM_TEST_B, 7, **HMM_TEST)
    exact = _hmm_exact(tcomps, tobs)
    devs = np.array([np.abs(inference.infer(
        "smc", tobs, *tcomps, HMM_TEST_K,
        noise=NoiseSource.seeded(100 + seed, dev),
        resampling_method="multinomial", return_log_marginal_likelihood=True,
        return_latents=False)["log_marginal_likelihood"].cpu().numpy() -
        exact) for seed in range(HMM_SEEDS)])          # [seeds, B]
    print(f"log-Z vs the forward recursion, D=3 T={HMM_TEST_T} "
          f"B={HMM_TEST_B} K={HMM_TEST_K} multinomial, {HMM_SEEDS} seeds: "
          f"mean deviation per row {np.round(devs.mean(axis=0), 4)} (bound "
          f"{HMM_MEAN_TOL}), largest {devs.max():.4f} (bound "
          f"{HMM_MAX_TOL})", flush=True)
    if not (np.all(devs.mean(axis=0) < HMM_MEAN_TOL) and
            devs.max() < HMM_MAX_TOL):
        raise AssertionError(f"HMM log-Z off the forward recursion: {devs}")

    def filt(implementation):
        return lambda: smc(4, implementation, return_latents=False,
                           return_log_weight=False)

    torch.cuda.reset_peak_memory_stats()
    call_ms = {"torch": [], "cuda": []}
    for implementation in ("torch", "cuda", "cuda", "torch"):
        call_ms[implementation] += _cuda_ms(
            filt(implementation), warmup=2, repeat=5, each=True)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for implementation, label in (("cuda", "kernel route (K1 + K5)"),
                                  ("torch", "plain route")):
        q1, med, q3 = _quartiles(call_ms[implementation])
        print(f"HMM log-Z call, {label}: median {med:.3f} ms/call "
              f"(quartiles {q1:.3f}, {q3:.3f}; n="
              f"{len(call_ms[implementation])}) = "
              f"{B * K * T / med * 1e3:.4g} particle-steps/s", flush=True)
    print(f"peak device memory {peak_mb:.1f} MiB", flush=True)
    _profile(filt("cuda"), "one HMM filter call")


def hmm_train_phase(dev):
    """The JAX package's emission-learning test (tests/test_hmm.py:154-191)
    on the card: the means start off by (0.8, -0.6, 0.7); 120 Adam steps at
    lr 5e-2, K=256, the same noise at every step as the test fixes its
    key."""
    phase(f"7 HMM training: emission means, T={HMM_TEST_T}, B={HMM_TEST_B},"
          f" K=256, 120 Adam steps")
    comps, obs = _hmm_data(dev, HMM_TEST_T, HMM_TEST_B, 7, **HMM_TEST)
    initial, transition, true_emission, proposal = comps
    truth = true_emission.locs.detach().cpu().numpy()
    emission = hmm.Emission(truth + np.array([0.8, -0.6, 0.7]),
                            true_emission.scale).to(dev)
    optimizer = torch.optim.Adam(emission.parameters(), lr=5e-2)
    step = train.make_train_step(256, "aesmc", optimizer)
    components = (initial, transition, emission, proposal)
    reset_counts()
    first = float(step(components, obs, NoiseSource.seeded(0, dev)))
    counts = read_counts("hmm train step")
    if (counts["resample_systematic"], counts["gather_sorted"]) != (
            HMM_TEST_T - 1, HMM_TEST_T - 1):
        raise AssertionError(f"one HMM train step launched {counts}")
    start = time.perf_counter()
    for _ in range(119):
        loss = step(components, obs, NoiseSource.seeded(0, dev))
    last = float(loss)
    seconds = time.perf_counter() - start
    locs = emission.locs.detach().cpu().numpy()
    err = np.abs(np.sort(locs) - np.sort(truth))
    print(f"loss {first:.4f} -> {last:.4f} (must fall by more than 0.5); "
          f"locs {np.round(locs, 4)} vs truth {truth}: error max "
          f"{err.max():.4f} (bound 0.5), mean {err.mean():.4f} (bound "
          f"0.25); 119 steps in {seconds:.2f} s", flush=True)
    if not (last < first - 0.5 and err.max() < 0.5 and err.mean() < 0.25):
        raise AssertionError(f"HMM emission learning failed: loss {first} "
                             f"-> {last}, error {err}")


# ---- Slice A3: the graphed train step, graphed filters, ESS-adaptive
# resampling, the NaN guard and remat.

# Graphed train step (phase 8): steps and steps a block of the main run,
# and Adam's learning rate (bench.py:266).
GRAPH_STEPS, GRAPH_BLOCK = 400, 100
GRAPH_LR = 1e-2
# The graphed plain route's run, twice (before and after the main run;
# cut from 300 steps each for the time limit).
GRAPH_PLAIN_STEPS, GRAPH_PLAIN_BLOCK = 150, 50
# Steps compared with eager `make_train_step` steps from the same seed:
# the losses must be bit-equal.
GRAPH_EQUAL_STEPS = 8
# Replays and eager calls a turn when timing the graphed filters.
FILTER_REPLAYS, FILTER_EAGER_CALLS = 20, 4

def _graph_learner(dev, lr):
    """The bench's training components (bench.py:261-280): the learner's
    transition from 0.5, emission and proposal trainable, Adam at ``lr``
    capturable; and the generative model the observations come from."""
    comps = (lgssm.Initial(0.0, 1.0),
             lgssm.Transition(0.5, TRANSITION_SCALE).to(dev),
             lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev),
             lgssm.Proposal.create(
                 1.0, 1.0, torch.Generator().manual_seed(0)).to(dev))
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=lr,
                                 capturable=True)
    gen = (lgssm.Initial(0.0, 1.0),
           lgssm.Transition(TRANSITION_MULT, TRANSITION_SCALE).to(dev),
           lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev))
    return comps, optimizer, gen


class _BlockTimer:
    """A `train_on_device` callback: a CUDA event at the end of each block
    (after the block's loss is read), and the block's mean loss."""

    def __init__(self):
        self.events, self.steps, self.losses = [], [], []

    def __call__(self, done, mean_loss, components):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        self.steps.append(done)
        self.losses.append(mean_loss)

    def ms_per_step(self, first=1):
        """ms a step of every block from block ``first`` on (0-based; the
        blocks before it hold the warm-up and the capture)."""
        torch.cuda.synchronize()
        return [self.events[i - 1].elapsed_time(self.events[i]) /
                (self.steps[i] - self.steps[i - 1])
                for i in range(first, len(self.events))]


def _on_device(dev, num_steps, block, k=None, lr=None, seed=21,
               callback=None, algorithm="aesmc", **kwargs):
    """`train.train_on_device` on the bench's LGSSM at (T, B) = (200, 10),
    K = ``k`` (default `TRAIN_K`) and Adam at ``lr`` (default
    `GRAPH_LR`); returns (components, losses)."""
    comps, optimizer, gen = _graph_learner(
        dev, GRAPH_LR if lr is None else lr)
    return train.train_on_device(
        *comps, k or TRAIN_K, algorithm, gen, T, B, num_steps,
        optimizer=optimizer,
        noise=NoiseSource.seeded(seed, dev), steps_per_call=block,
        callback=callback, **kwargs)


def _eager_steps(dev, num_steps, seed=21, algorithm="aesmc"):
    """``num_steps`` eager `make_train_step` steps, each on observations
    sampled from the generative model through the same noise source, as
    `train_on_device` draws them; returns the losses."""
    comps, optimizer, gen = _graph_learner(dev, GRAPH_LR)
    noise = NoiseSource.seeded(seed, dev)
    step = train.make_train_step(TRAIN_K, algorithm, optimizer)
    losses_ = []
    for _ in range(num_steps):
        with torch.no_grad():
            _, obs = statistics.sample_from_prior(*gen, T, B, noise)
        losses_.append(step(comps, obs, noise))
    return torch.stack(losses_)


def _kernel_events(prof):
    """{profiler kernel name: launches} for the port's kernels, and the
    device time of every kernel, copy and fill, in ms."""
    events = prof.key_averages()
    counts = {name: sum(e.count for e in events if name in e.key)
              for name in sorted({n for _, _, n, _ in KERNELS.values()})}
    on_card = _on_card(events)
    device_us = sum(getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
                    for e in on_card)
    print(f"{sum(e.count for e in on_card)} kernels, copies and fills on the"
          f" card", flush=True)
    launch = [e for e in events if e.key == "cudaGraphLaunch"]
    if launch:
        print(f"cudaGraphLaunch: {launch[0].count} calls, "
              f"{launch[0].cpu_time_total / launch[0].count / 1e3:.3f} ms "
              f"of host time each", flush=True)
    return counts, device_us / 1e3


def _report_profile(prof, label, want, span_ms, wall_ms):
    """Prints the device time of one profiled replay by kernel, checks the
    port's kernels' launches against ``want`` ({profiler name:
    launches}) and prints the idle share: against ``span_ms``, the CUDA
    events' span around the same profiled replay, and against
    ``wall_ms``, the median of runs without the profiler. Both ratios are
    printed unclamped; a negative one means the busy time read by the
    profiler exceeds that span."""
    counts, device_ms = _kernel_events(prof)
    print(f"profile of one replay, {label}: device time {device_ms:.3f} ms;"
          f" the port's kernels {counts}", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=12), flush=True)
    for name, n in want.items():
        if counts[name] != n:
            # What the profiler did record, when it drops events.
            seen = {e.key[:60]: e.count for e in _on_card(prof.key_averages())}
            print(f"{label}: {sum(seen.values())} events on the card: {seen}",
                  flush=True)
            raise AssertionError(f"{label}: {counts[name]} {name} events in "
                                 f"one replay, not {n}")
    print(f"{label}: device busy {device_ms:.3f} ms in a profiled replay "
          f"whose CUDA events span {span_ms:.3f} ms: idle share "
          f"{1 - device_ms / span_ms:.2%} (same run); against the median "
          f"{wall_ms:.3f} ms of replays without the profiler "
          f"{1 - device_ms / wall_ms:.2%}", flush=True)
    return counts, device_ms


def _profile_replay(run, label, want, wall_ms):
    """Runs ``run`` (one replay) under torch.profiler (`_profiled`)
    between two CUDA events and reports it (`_report_profile`)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with _profiled() as prof:
        start.record()
        run()
        end.record()
    return _report_profile(prof, label, want, start.elapsed_time(end),
                           wall_ms)


def _profiled_train_replay(dev, label, want, wall_ms, runner=None,
                           **kwargs):
    """One replay of `train_on_device`'s graph under the profiler: the
    first block is the warm-up, the capture and its first replay; the
    profiler and a CUDA event start in its callback, and the second
    block, one more replay, ends at a second event in the next callback
    (after the block's loss is read); the first event waits
    `PROFILE_MARGIN_S` after the profiler starts, as in `_profiled`.
    ``runner(dev, num_steps, block, callback=..., **kwargs)`` runs
    `train_on_device` (default `_on_device`, the bench's LGSSM at (T,
    B))."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    events = []

    def mark(done, mean_loss, components):
        if not events:
            torch.cuda.synchronize()
            prof.start()
            time.sleep(PROFILE_MARGIN_S)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    (runner or _on_device)(dev, train.WARMUP_STEPS + 2,
                           train.WARMUP_STEPS + 1, callback=mark, **kwargs)
    torch.cuda.synchronize()
    prof.stop()
    counts, device_ms = _report_profile(
        prof, f"train step, {label}", want,
        events[0].elapsed_time(events[1]), wall_ms)
    return counts, device_ms, prof


def graph_train_phase(dev):
    phase(f"8 graphed train step: train_on_device, T={T}, B={B}, "
          f"K={TRAIN_K}, {GRAPH_STEPS} steps in blocks of {GRAPH_BLOCK}")
    # The first steps against eager steps from the same seed and Adam.
    _, graphed = _on_device(dev, GRAPH_EQUAL_STEPS, GRAPH_EQUAL_STEPS)
    eager = _eager_steps(dev, GRAPH_EQUAL_STEPS)
    exact = torch.equal(graphed, eager)
    print(f"first {GRAPH_EQUAL_STEPS} steps ({train.WARMUP_STEPS} warm-up, "
          f"{GRAPH_EQUAL_STEPS - train.WARMUP_STEPS} replays) against eager "
          f"make_train_step steps from the same seed: bit-equal {exact}; "
          f"losses {graphed.cpu().numpy()}", flush=True)
    if not exact:
        raise AssertionError(f"graphed losses differ from eager: "
                             f"{graphed} vs {eager}")

    # Fresh noise at every replay: with lr 0 the parameters stay, so the
    # replays' losses differ only by their noise.
    _, frozen = _on_device(dev, train.WARMUP_STEPS + 3, 10, lr=0.0)
    replays = frozen[train.WARMUP_STEPS:].cpu().tolist()
    print(f"lr 0: the replays' losses {replays}", flush=True)
    if len(set(replays)) != len(replays):
        raise AssertionError(f"two replays drew the same noise: {replays}")

    # The plain route graphed, then the kernel route (the main path),
    # then the plain route again.
    timers = {"torch": _BlockTimer(), "cuda": _BlockTimer()}
    _on_device(dev, GRAPH_PLAIN_STEPS, GRAPH_PLAIN_BLOCK,
               callback=timers["torch"], resampling_implementation="torch")
    reset_counts()
    comps, hist = _on_device(dev, GRAPH_STEPS, GRAPH_BLOCK,
                             callback=timers["cuda"])
    counts = read_counts("graphed train K=100")
    plain_again = _BlockTimer()
    _on_device(dev, GRAPH_PLAIN_STEPS, GRAPH_PLAIN_BLOCK,
               callback=plain_again, resampling_implementation="torch")
    # The wrappers count at the warm-up steps and the capture; replays
    # launch from the graph.
    captured = (train.WARMUP_STEPS + 1) * (T - 1)
    if (counts["resample_systematic"], counts["range_sum"],
            counts[CDF]) != (captured, captured, captured):
        raise AssertionError(f"train_on_device launched {counts} through "
                             f"the wrappers, not K1, K2 and the CDF kernel "
                             f"{captured} times")
    ms = {"cuda": timers["cuda"].ms_per_step(),
          "torch": timers["torch"].ms_per_step() +
          plain_again.ms_per_step()}
    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        q1, med, q3 = _quartiles(ms[impl])
        EAGER_MS[f"graphed train {impl}"] = med
        print(f"graphed AESMC train step K={TRAIN_K}, {label}: median "
              f"{med:.3f} ms/step (quartiles {q1:.3f}, {q3:.3f}; blocks "
              f"{np.round(ms[impl], 3).tolist()}) = {1e3 / med:.2f} "
              f"steps/s; eager make_train_step "
              f"{EAGER_MS.get(f'train {impl}', float('nan')):.3f} ms/step "
              f"(phase 5)", flush=True)
    mult = comps[1].mult.item()
    first, last = float(hist[:30].mean()), float(hist[-30:].mean())
    print(f"learning: transition {mult:.4f} (truth {TRANSITION_MULT}, "
          f"bound 0.45), mean loss of the first 30 steps {first:.4f}, of "
          f"the last 30 {last:.4f}", flush=True)
    if not (abs(mult - TRANSITION_MULT) < 0.45 and last < first and
            bool(torch.isfinite(hist).all())):
        raise AssertionError(f"train_on_device did not learn: {mult}, "
                             f"{first} -> {last}")

    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        n = T - 1 if impl == "cuda" else 0
        _profiled_train_replay(
            dev, label,
            {"resample_systematic_kernel": n, "range_sum_kernel": n},
            EAGER_MS[f"graphed train {impl}"],
            resampling_implementation=impl)

    # The filter's width: graphed steps at K=10,000, with and without
    # remat, and peak memory. Blocks of 3 steps: the warm-up, the capture
    # with two replays, then two blocks of three replays, timed.
    block = train.WARMUP_STEPS
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        big = _BlockTimer()
        _on_device(dev, 4 * block, block, k=K, callback=big, remat=remat)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"graphed AESMC train step K={K}{', remat' if remat else ''}:"
              f" {np.round(big.ms_per_step(first=2), 3).tolist()} ms/step "
              f"(eager {EAGER_MS.get('train K=10000', float('nan')):.3f}); "
              f"peak device memory {peak_mb:.1f} MiB (eager step "
              f"{EAGER_MS.get('peak K=10000', float('nan')):.1f} MiB)",
              flush=True)


def _graphed_filter(dev, label, call, noise, want):
    """Captures one filter call (``call`` returns its log-Z), checks a
    replay against an eager call from the same generator state, times
    replays against eager calls in turns, and profiles one replay."""
    with torch.no_grad():
        train._warm_up(call, 1)
        reset_counts()
        graph, log_z = train._capture(call, noise.generator)
        read_counts(f"graphed {label} (capture)")
        state = noise.generator.get_state()
        graph.replay()
        replayed = log_z.clone()
        graph.replay()
        second = log_z.clone()
        noise.generator.set_state(state)
        eager = call()
        print(f"graphed {label}: replay log-Z {replayed.cpu().numpy()}; "
              f"equal to an eager call from the same generator state "
              f"{torch.equal(replayed, eager)}; the next replay differs "
              f"{not torch.equal(replayed, second)}", flush=True)
        if not torch.equal(replayed, eager):
            raise AssertionError(f"graphed {label} differs from eager: "
                                 f"{replayed} vs {eager}")
        if torch.equal(replayed, second):
            raise AssertionError(f"two replays of {label} drew the same "
                                 f"noise")
        runs = {"eager": [], "graph": []}
        for which in ("eager", "graph", "graph", "eager"):
            fn, n = ((call, FILTER_EAGER_CALLS) if which == "eager" else
                     (graph.replay, FILTER_REPLAYS))
            runs[which] += _cuda_ms(fn, warmup=1, repeat=n, each=True)
        out = {}
        for which in ("graph", "eager"):
            q1, med, q3 = _quartiles(runs[which])
            out[which] = med
            print(f"{label}, {which}: median {med:.3f} ms/call (quartiles "
                  f"{q1:.3f}, {q3:.3f}; n={len(runs[which])}) = "
                  f"{B * K * T / med * 1e3:.4g} particle-steps/s",
                  flush=True)
        _profile_replay(graph.replay, label, want, out["graph"])


def graph_filter_phase(dev):
    phase(f"9 graphed filters: one infer call captured, LGSSM at (T, B, K) "
          f"= ({T}, {B}, {K:,}), HMM with D={HMM_STATES}")
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    noise = NoiseSource.seeded(31, dev)

    def lgssm_call():
        return inference.infer(
            "smc", obs, *comps, K, noise=noise,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"]

    _graphed_filter(dev, "LGSSM filter", lgssm_call, noise,
                    {"resample_systematic_kernel": T - 1})
    hcomps, hobs = _hmm_data(dev, T, B, 0, num_states=HMM_STATES)
    hnoise = NoiseSource.seeded(32, dev)

    def hmm_call():
        return inference.infer(
            "smc", hobs, *hcomps, K, noise=hnoise,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"]

    _graphed_filter(dev, "HMM filter", hmm_call, hnoise,
                    {"resample_systematic_kernel": T - 1,
                     "gather_sorted_kernel": T - 1})


class _NanEmission:
    """The bench's emission with a NaN scale from time step 2 on."""

    def __call__(self, latents=None, time=None, previous_observations=None):
        scale = float("nan") if time >= 2 else EMISSION_SCALE
        return distributions.Normal(
            latents[-1], scale,
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def adaptive_phase(dev):
    phase(f"10 ESS-adaptive resampling, the NaN guard and remat, T={T}, "
          f"B={B}")
    # The adaptive filter at K=10,000 against the Kalman filter.
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    optimal = lgssm.optimal_proposal(
        0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE).to(dev)
    reset_counts()
    with torch.no_grad():
        out = inference.infer(
            "smc", obs, *comps[:3], optimal, K,
            noise=NoiseSource.seeded(41, dev), resampling_criterion=0.5,
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True)
    counts = read_counts("adaptive filter")
    if counts["resample_systematic"] != T - 1:
        raise AssertionError(f"the adaptive filter launched {counts}")
    anc = out["ancestral_indices"]
    kept = (anc == torch.arange(K, device=dev)).all(dim=-1)
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=EMISSION_SCALE ** 2)
    obs_np = obs.cpu().numpy()
    exact = np.array([kalman.kalman_filter(obs_np[:, b], params)[4]
                      for b in range(B)])
    rel = np.abs(out["log_marginal_likelihood"].cpu().numpy() - exact) / \
        np.abs(exact)
    print(f"adaptive filter (frac 0.5) at K={K:,}: {T - 1} K1 launches; "
          f"{int((~kept).sum())} of {kept.numel()} row-steps resampled; "
          f"log-Z vs Kalman: max relative error {rel.max():.3e} (bound "
          f"{LOG_Z_REL_TOL})", flush=True)
    if not np.all(rel < LOG_Z_REL_TOL):
        raise AssertionError(f"adaptive log-Z off the Kalman filter: {rel}")

    # One adaptive train step at K=100: K1 forward, K2 backward.
    tcomps, tobs = _bench_lgssm(dev, 0.5)
    optimizer = torch.optim.Adam(train.get_chained_params(*tcomps), lr=1e-2)
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer,
                                 resampling_criterion=0.5)
    reset_counts()
    loss = step(tcomps, tobs, NoiseSource.seeded(42, dev))
    counts = read_counts("adaptive train K=100")
    if (counts["resample_systematic"], counts["range_sum"]) != (T - 1,
                                                                T - 1):
        raise AssertionError(f"the adaptive step launched {counts}")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"adaptive step loss {loss}")
    print(f"adaptive train step K={TRAIN_K}: loss {float(loss):.4f}, K1 and "
          f"K2 {T - 1} launches each", flush=True)

    # The NaN guard: a NaN step raises before the optimizer step.
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer,
                                 nan_check=True)
    step(tcomps, tobs, NoiseSource.seeded(43, dev))
    params = [p.detach().clone() for p in train.get_chained_params(*tcomps)]
    adam = [{k: v.clone() for k, v in s.items()}
            for s in optimizer.state.values()]
    nan_comps = (tcomps[0], tcomps[1], _NanEmission(), tcomps[3])
    try:
        step(nan_comps, tobs, NoiseSource.seeded(44, dev))
    except FloatingPointError as err:
        print(f"NaN step raised FloatingPointError: {err}", flush=True)
    else:
        raise AssertionError("a NaN step did not raise")
    same = all(torch.equal(a, p) for a, p in
               zip(params, train.get_chained_params(*tcomps)))
    same_adam = all(torch.equal(v, s[k]) for a, s in
                    zip(adam, optimizer.state.values())
                    for k, v in a.items())
    print(f"after the NaN step: parameters bit-identical {same}, Adam "
          f"state bit-identical {same_adam}", flush=True)
    if not (same and same_adam):
        raise AssertionError("the NaN step changed the parameters or Adam")

    # remat at the filter's width: loss and gradients against the plain
    # step, and both peak memories.
    rcomps, robs = _bench_lgssm(dev, 0.5)
    params = train.get_chained_params(*rcomps)
    results = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss = losses.get_loss(robs, K, "aesmc", *rcomps,
                               noise=NoiseSource.seeded(45, dev),
                               remat=remat)
        grads = torch.autograd.grad(loss, params)
        counts = read_counts(f"{'remat' if remat else 'plain'} loss+grad "
                             f"K={K}")
        results[remat] = (loss.detach(), grads,
                          torch.cuda.max_memory_allocated() / 2 ** 20,
                          counts)
    (loss_p, grads_p, peak_p, _), (loss_r, grads_r, peak_r, counts_r) = \
        results[False], results[True]
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads_r, grads_p))
    k1, k2 = counts_r["resample_systematic"], counts_r["range_sum"]
    print(f"remat at K={K:,}: loss {float(loss_r):.6f}, equal to the plain "
          f"step's {torch.equal(loss_r, loss_p)}; gradients within relative "
          f"error {worst:.3g} (bound {GRAD_RTOL}); K1 {k1} launches "
          f"(forward and recompute), K2 {k2}; peak device memory "
          f"{peak_r:.1f} MiB "
          f"with remat, {peak_p:.1f} MiB without (766.9 MiB: eager "
          f"train step, PERF.md section 2)", flush=True)
    if not torch.equal(loss_r, loss_p) or worst > GRAD_RTOL:
        raise AssertionError(f"remat differs: loss {loss_r} vs {loss_p}, "
                             f"gradients {worst}")


# ---- Slice B2: soft resampling at the bench's config 5, the D-dim LGSSM,
# the auxiliary particle filter, residual resampling and the dense route.

# The bench's config-5 row (bench.py:303-322): the soft train step at
# (T, B, K) = (10, 2, 1,000,000), alpha 0.5, Adam at lr 1e-2.
SOFT_T, SOFT_B, SOFT_K = 10, 2, 1_000_000
SOFT_ALPHA, SOFT_LR = 0.5, 1e-2
# Graphed soft steps a block: the first block holds the warm-up and the
# capture, the next two are timed.
SOFT_BLOCK = 5
# The D-dim LGSSM of the JAX bench's configuration 2 (`lgssm_nd`).
ND_DIM = 10
# The dense-route sweep: graphed train steps at (T, B) = (200, 10), one
# graph a route and K (a capture costs ~4.5 s, a block of steps ~0.25 s):
# the first block holds the warm-up and the capture, DENSE_TIMED are timed.
DENSE_KS = (100, 256, 512, 1024)
DENSE_BLOCK, DENSE_TIMED = 5, 4


def _soft_components(dev):
    """bench.py's config-5 components (the learner's transition from 0.5,
    Adam at lr 1e-2, capturable), the generative model and observations
    of it at (SOFT_T, SOFT_B)."""
    comps, optimizer, gen = _graph_learner(dev, SOFT_LR)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(*gen, SOFT_T, SOFT_B,
                                              NoiseSource.seeded(0, dev))
    return comps, optimizer, gen, obs


def _soft_on_device(dev, num_steps, block, callback=None, seed=55):
    """`train.train_on_device` on the config-5 soft step."""
    comps, optimizer, gen, _ = _soft_components(dev)
    return train.train_on_device(
        *comps, SOFT_K, "aesmc", gen, SOFT_T, SOFT_B, num_steps,
        optimizer=optimizer, noise=NoiseSource.seeded(seed, dev),
        steps_per_call=block, callback=callback, resampling_method="soft",
        soft_resampling_alpha=SOFT_ALPHA)


def _soft_kernels(dev, comps, obs):
    """K3 and K2 against their plain versions on the soft step's own
    inputs at (2, 1,000,000): the first step's weights, their tempered
    mixture's CDF, multinomial positions and the three columns (latent,
    log w, log q); then their times at that shape."""
    with torch.no_grad():
        first = inference.infer("smc", obs[:1], *comps, SOFT_K,
                                noise=NoiseSource.seeded(1, dev))
    log_w, log_q = resampling._soft_tempered_log_weights(
        first["log_weight"], SOFT_ALPHA)
    generator = torch.Generator(device=dev).manual_seed(51)
    cdf = resampling._normalized_cumsum(log_q)
    pos = resampling.resampling_positions(log_q, NoiseSource(generator),
                                          "multinomial")
    flat = torch.stack([first["latents"][0], log_w, log_q],
                       dim=-1).contiguous()
    idx, out = resample_sorted_cuda.resample_and_gather_sorted(cdf, pos,
                                                               flat)
    want_idx, want = resample_sorted_cuda.resample_and_gather_sorted_torch(
        cdf, pos, flat)
    torch.cuda.synchronize()
    if not (torch.equal(idx, want_idx) and _same_bits(out, want)):
        raise AssertionError(
            f"K3 differs from its plain version on the soft step's inputs: "
            f"{int((idx != want_idx).sum())} indices")
    label = f"({SOFT_B}, {SOFT_K:,}, 3), soft"
    err, bound = _k2_case(cdf, pos, 3, generator, label)
    print(f"K3 at {label}: indices and the three gathered columns exact "
          f"(tolerance 0); K2 there: integer cotangents exact, float max abs "
          f"error {err:.3g} (each source within {RANGE_SUM_REL_TOL:g} x its "
          f"sum of |g|, largest bound {bound:.3g}), two launches "
          f"bit-identical", flush=True)
    n, d = SOFT_B * SOFT_K, 3
    steps = _search_steps(SOFT_K)
    g = torch.randn(SOFT_B, SOFT_K, d, generator=generator, device=dev)
    ancestors = want_idx.long().unsqueeze(-1).expand(g.shape)
    shape = (SOFT_B, SOFT_K, SOFT_K, d)
    _kernel_row("resample_sorted", shape,
                lambda: resample_sorted_cuda.resample_and_gather_sorted(
                    cdf, pos, flat, False),
                lambda: resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, flat, False),
                None, 4 * n * (2 + 2 * d), n * steps)
    _kernel_row("range_sum", shape,
                lambda: range_sum_cuda.range_sum(cdf, pos, g),
                lambda: range_sum_cuda.range_sum_torch(cdf, pos, g),
                lambda: torch.zeros_like(g).scatter_add_(1, ancestors, g),
                4 * n * (2 + 2 * d), n * steps + n * d,
                "scatter_add_ over the given ancestors (non-deterministic)")


def soft_phase(dev):
    phase(f"11 soft train step: the bench's config 5, (T, B, K) = "
          f"({SOFT_T}, {SOFT_B}, {SOFT_K:,}), alpha {SOFT_ALPHA}")
    comps, optimizer, _, obs = _soft_components(dev)
    steps = SOFT_T - 1
    _soft_kernels(dev, comps, obs)
    _compare_routes(comps, obs, SOFT_K, "soft", 52, dev)

    # The main path: one soft train step as a user calls it.
    step = train.make_train_step(SOFT_K, "aesmc", optimizer,
                                 resampling_method="soft",
                                 soft_resampling_alpha=SOFT_ALPHA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = step(comps, obs, NoiseSource.seeded(53, dev))
    counts = read_counts("soft train step")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    others = {name: n for name, n in counts.items()
              if name not in ("resample_sorted", "range_sum", CDF) and n}
    if (counts["resample_sorted"], counts["range_sum"], counts[CDF]) != (
            steps, steps, steps) or others:
        raise AssertionError(f"one soft step launched {counts}, not K3, K2 "
                             f"and the CDF kernel {steps} times each")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"soft step loss {loss}")
    print(f"one soft step: K3, K2 and the CDF kernel {steps} launches "
          f"each, loss {float(loss):.4f}; peak device memory "
          f"{peak_mb:.1f} MiB", flush=True)

    # Eager step times, plain route against kernel route.
    routes = {impl: train.make_train_step(
        SOFT_K, "aesmc", optimizer, resampling_method="soft",
        soft_resampling_alpha=SOFT_ALPHA, resampling_implementation=impl)
        for impl in ("cuda", "torch")}
    noise = NoiseSource.seeded(54, dev)
    step_ms = {"cuda": [], "torch": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        step_ms[impl] += _cuda_ms(lambda: routes[impl](comps, obs, noise),
                                  warmup=1, repeat=4, each=True)
    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        q1, med, q3 = _quartiles(step_ms[impl])
        EAGER_MS[f"soft {impl}"] = med
        print(f"soft train step, eager, {label}: median {med:.3f} ms/step "
              f"(quartiles {q1:.3f}, {q3:.3f}; n={len(step_ms[impl])}) = "
              f"{SOFT_B * SOFT_K * SOFT_T / med * 1e3:.4g} particle-steps/s",
              flush=True)

    # Graphed: train_on_device captures the soft step.
    timer = _BlockTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, hist = _soft_on_device(dev, 3 * SOFT_BLOCK, SOFT_BLOCK, timer)
    counts = read_counts("graphed soft train step")
    graph_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    captured = (train.WARMUP_STEPS + 1) * steps
    if (counts["resample_sorted"], counts["range_sum"], counts[CDF]) != (
            captured, captured, captured):
        raise AssertionError(f"the graphed soft run launched {counts} "
                             f"through the wrappers, not K3, K2 and the CDF "
                             f"kernel {captured} times")
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError(f"graphed soft losses {hist}")
    ms = timer.ms_per_step()
    med = float(np.median(ms))
    print(f"graphed soft train step: {np.round(ms, 3).tolist()} ms/step "
          f"(median {med:.3f} = {SOFT_B * SOFT_K * SOFT_T / med * 1e3:.4g} "
          f"particle-steps/s; eager {EAGER_MS['soft cuda']:.3f}); peak "
          f"device memory {graph_peak_mb:.1f} MiB; losses "
          f"{np.round(hist.cpu().numpy(), 3).tolist()}", flush=True)
    _profiled_train_replay(
        dev, "soft step", {"resample_sorted_kernel": steps,
                           "range_sum_kernel": steps}, med,
        runner=lambda dev, num_steps, block, callback: _soft_on_device(
            dev, num_steps, block, callback))


def _lgssm_exact(obs):
    """The Kalman filter's log-likelihood of each batch row of the bench's
    LGSSM."""
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=EMISSION_SCALE ** 2)
    obs_np = obs.cpu().numpy()
    return np.array([kalman.kalman_filter(obs_np[:, b], params)[4]
                     for b in range(obs_np.shape[1])])


def _check_log_z(label, est, exact):
    rel = np.abs(est.cpu().numpy() - exact) / np.abs(exact)
    print(f"{label}: log-Z vs the exact filter, max relative error "
          f"{rel.max():.3e} (bound {LOG_Z_REL_TOL})", flush=True)
    if not np.all(rel < LOG_Z_REL_TOL):
        raise AssertionError(f"{label}: log-Z off the exact filter: {rel}")


def _eager_turns(calls):
    """CUDA-event times of each of ``calls`` ({label: fn}), 4 calls each
    in turns, forwards then backwards; prints and returns the medians."""
    runs = {label: [] for label in calls}
    for label in list(calls) + list(calls)[::-1]:
        runs[label] += _cuda_ms(calls[label], warmup=1, repeat=2, each=True)
    medians = {}
    for label, times in runs.items():
        q1, medians[label], q3 = _quartiles(times)
        print(f"{label}: median {medians[label]:.3f} ms/call (quartiles "
              f"{q1:.3f}, {q3:.3f}; n={len(times)}) = "
              f"{B * K * T / medians[label] * 1e3:.4g} particle-steps/s",
              flush=True)
    return medians


@torch.no_grad()
def lgssm_nd_phase(dev):
    phase(f"12 lgssm_nd filter: make_model(dim={ND_DIM}), the exact "
          f"proposal, (T, B, K) = ({T}, {B}, {K:,})")
    comps = lgssm_nd.make_model(dim=ND_DIM, device=dev)
    optimal = lgssm_nd.optimal_proposal(*comps[:3])
    _, obs = statistics.sample_from_prior(*comps[:3], T, B,
                                          NoiseSource.seeded(0, dev))

    def smc(noise, implementation="auto"):
        return inference.infer(
            "smc", obs, *comps[:3], optimal, K, noise=noise,
            resampling_implementation=implementation,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"]

    reset_counts()
    log_z = smc(NoiseSource.seeded(61, dev))
    counts = read_counts(f"lgssm_nd filter D={ND_DIM}")
    if counts["resample_systematic"] != T - 1 or \
            _searches(counts) != T - 1 or counts[CDF] != T - 1:
        raise AssertionError(f"the lgssm_nd filter launched {counts}")
    params = lgssm_nd.kalman_params(*comps[:3])
    obs_np = obs.cpu().numpy()
    exact = np.array([kalman_nd.kalman_filter_nd(obs_np[:, b], params)[4]
                      for b in range(B)])
    _check_log_z(f"lgssm_nd filter (K1 with D = {ND_DIM} columns)", log_z,
                 exact)
    with _plain_cdf():
        same_cdf = smc(NoiseSource.seeded(61, dev), "cuda")
    plain = smc(NoiseSource.seeded(61, dev), "torch")
    if not torch.equal(same_cdf, plain):
        raise AssertionError(f"lgssm_nd log-Z differs between the routes "
                             f"given one CDF: {same_cdf} vs {plain}")
    print("kernel route's log-Z, given the plain CDF, equals the plain "
          "route's exactly", flush=True)
    medians = _eager_turns({
        "lgssm_nd filter, eager, kernel route":
            lambda: smc(NoiseSource.seeded(63, dev), "cuda"),
        "lgssm_nd filter, eager, plain route":
            lambda: smc(NoiseSource.seeded(63, dev), "torch")})
    EAGER_MS["lgssm_nd"] = medians["lgssm_nd filter, eager, kernel route"]
    noise = NoiseSource.seeded(62, dev)
    _graphed_filter(dev, "lgssm_nd filter", lambda: smc(noise), noise,
                    {"resample_systematic_kernel": T - 1})


@torch.no_grad()
def apf_residual_phase(dev):
    phase(f"13 auxiliary particle filter and residual resampling: the "
          f"bench's LGSSM, exact proposal, (T, B, K) = ({T}, {B}, {K:,})")
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    optimal = lgssm.optimal_proposal(
        0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE).to(dev)
    lookahead = lgssm.Lookahead(TRANSITION_MULT, TRANSITION_SCALE,
                                EMISSION_MULT, EMISSION_SCALE).to(dev)
    exact = _lgssm_exact(obs)

    def smc(seed, implementation="auto", **kwargs):
        return inference.infer(
            "smc", obs, *comps[:3], optimal, K,
            noise=NoiseSource.seeded(seed, dev),
            resampling_implementation=implementation,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False, **kwargs)["log_marginal_likelihood"]

    # The APF: K1 with the scores as a second column.
    reset_counts()
    apf = smc(71, lookahead=lookahead)
    counts = read_counts("APF filter")
    if counts["resample_systematic"] != T - 1 or \
            _searches(counts) != T - 1 or counts[CDF] != T - 1:
        raise AssertionError(f"the APF filter launched {counts}")
    _check_log_z("APF filter (K1, D = 2: latent and score)", apf, exact)
    with _plain_cdf():
        same_cdf = smc(71, "cuda", lookahead=lookahead)
    if not torch.equal(same_cdf, smc(71, "torch", lookahead=lookahead)):
        raise AssertionError("APF log-Z differs between the routes given "
                             "one CDF")
    _check_log_z("plain filter, same noise", smc(71), exact)

    # Residual resampling: torch ops on the card, no kernel.
    reset_counts()
    res = smc(72, resampling_method="residual")
    counts = read_counts("residual filter")
    if any(counts.values()):
        raise AssertionError(f"the residual filter launched {counts}")
    _check_log_z("residual filter (torch ops)", res, exact)
    _eager_turns({
        "plain filter (exact proposal), eager": lambda: smc(73),
        "APF filter, eager": lambda: smc(73, lookahead=lookahead),
        "residual filter, eager":
            lambda: smc(73, resampling_method="residual")})


def dense_phase(dev):
    phase(f"14 dense-route sweep: graphed train step at (T, B) = ({T}, "
          f"{B}), K in {DENSE_KS}, kernel route (K1 + K2) against the dense "
          f"one-hot route")
    # The dense gather passes values through bit for bit under TF32.
    generator = torch.Generator(device=dev).manual_seed(81)
    k = DENSE_KS[-1]
    logw = torch.randn(B, k, generator=generator, device=dev) * 3.0
    pos = resampling.resampling_positions(logw, NoiseSource(generator),
                                          "stratified")
    value = torch.randn(B, k, 3, generator=generator, device=dev) * 1e3
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        idx, out = resampling.dense_indices_and_gather(logw, pos, value)
    finally:
        torch.set_float32_matmul_precision(previous)
    want = torch.take_along_dim(value, idx.long().unsqueeze(-1), dim=1)
    if not _same_bits(out, want):
        raise AssertionError("the dense gather rounded values under TF32")
    print(f"dense gather at ({B}, {k}, 3) under TF32 ('high'): values bit "
          f"for bit", flush=True)

    # The 'torch' route takes the dense gather at these K.
    calls = []
    real = resampling.dense_indices_and_gather

    def count(*args):
        calls.append(1)
        return real(*args)

    comps, obs = _bench_lgssm(dev, 0.5)
    resampling.dense_indices_and_gather = count
    try:
        losses.get_loss(obs, DENSE_KS[0], "aesmc", *comps,
                        noise=NoiseSource.seeded(82, dev),
                        resampling_implementation="torch").backward()
    finally:
        resampling.dense_indices_and_gather = real
    if len(calls) != T - 1:
        raise AssertionError(f"the dense route ran {len(calls)} times")

    faster = []
    for k in DENSE_KS:
        ms, peak = {"cuda": [], "torch": []}, {}
        for impl in ("torch", "cuda"):
            timer = _BlockTimer()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _on_device(dev, (1 + DENSE_TIMED) * DENSE_BLOCK, DENSE_BLOCK,
                       k=k, callback=timer, resampling_implementation=impl)
            ms[impl] += timer.ms_per_step()
            peak[impl] = torch.cuda.max_memory_allocated() / 2 ** 20
        med = {impl: float(np.median(times)) for impl, times in ms.items()}
        if med["torch"] < med["cuda"]:
            faster.append(k)
        print(f"dense sweep K={k}: graphed ms/step kernel route "
              f"{np.round(ms['cuda'], 3).tolist()} (median "
              f"{med['cuda']:.3f}, peak {peak['cuda']:.1f} MiB), dense route "
              f"{np.round(ms['torch'], 3).tolist()} (median "
              f"{med['torch']:.3f}, peak {peak['torch']:.1f} MiB): "
              f"{'dense' if k in faster else 'kernel'} faster", flush=True)
    print(f"dense route faster at K = {faster}; 'auto' on the card takes "
          f"{resampling.resolve_implementation(dev, 'systematic', 'auto')!r}"
          f" at every K", flush=True)


# ---- Slice B3/C1: Tensor Monte Carlo, the VRNN, the score-function
# gradient and the smoothers.

# Graphed TMC steps a block (phase 15): the first block holds the warm-up
# and the capture, the next ones are timed.
TMC_BLOCK, TMC_BLOCKS = 10, 4
# The larger K at which phase 15 also reads the peak memory with and
# without remat.
TMC_MEMORY_K = 1000
# VRNN steps a block when graphed (phase 16): the first block holds the
# warm-up and the capture.
VRNN_BLOCK = train.WARMUP_STEPS
# FFBS trajectories (the JAX probe's FFBS_M, benchmarks/
# smoothing_probe_r4.py:44) and the PaRIS shape of phase 18.
FFBS_M = 128
PARIS_K, PARIS_N = 2048, 2
# Replays of a graphed filter for the spread of log-Z and of the filtered
# mean, and the JAX package's band for a genealogy estimate against the
# replicate variance (tests/test_variance.py:150-176).
VARIANCE_REPLAYS = 256
VARIANCE_BAND = (0.35, 1.5)
# The JAX tests' bounds against the RTS smoother: FFBS means RMSE and
# mean relative variance deviation (tests/test_smoothing.py:36-50), the
# PaRIS sum of states a row (tests/test_paris.py:71-80).
FFBS_RMSE, FFBS_VAR_DEV, PARIS_SUM_TOL = 0.06, 0.25, 0.35
# The kernels' names in the profiler, for "none of them" checks.
NO_KERNELS = {name: 0 for name in sorted({n for _, _, n, _ in
                                          KERNELS.values()})}


def _optimal_lgssm(dev):
    """The bench's LGSSM (transition 0.9), its exact proposal and
    observations of it at (T, B)."""
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    optimal = lgssm.optimal_proposal(
        0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE).to(dev)
    return comps[:3] + (optimal,), obs


def _peak_mib():
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def tmc_phase(dev):
    phase(f"15 TMC train step: the bench's row (bench.py:281-295), (T, B, K) "
          f"= ({T}, {B}, {TRAIN_K})")
    # Accuracy on the true model with its exact proposal: TMC's and
    # IWAE's log-Z from the same proposal draws against Kalman.
    comps, obs = _optimal_lgssm(dev)
    exact = _lgssm_exact(obs)
    with torch.no_grad():
        est = tmc.tmc_log_marginal_likelihood(
            obs, *comps, TRAIN_K, noise=NoiseSource.seeded(60, dev))
        iwae = inference.infer(
            "is", obs, *comps, TRAIN_K, noise=NoiseSource.seeded(60, dev),
            return_log_marginal_likelihood=True,
            return_latents=False)["log_marginal_likelihood"]
    _check_log_z(f"TMC K={TRAIN_K}, exact proposal", est, exact)
    tmc_err = np.abs(est.cpu().numpy() - exact)
    iwae_err = np.abs(iwae.cpu().numpy() - exact)
    print(f"|log-Z - Kalman| a row: TMC {np.round(tmc_err, 3).tolist()}, "
          f"IWAE on the same draws {np.round(iwae_err, 3).tolist()}; means "
          f"{tmc_err.mean():.4f} against {iwae_err.mean():.4f}", flush=True)
    if not tmc_err.mean() < iwae_err.mean():
        raise AssertionError("TMC is not closer to Kalman than IWAE")
    mode = tmc._resolve_pairwise_mode(comps[1], torch.zeros(
        B, TRAIN_K, device=dev), obs[0])
    print(f"pairwise 'auto' resolves to {mode!r} on the LGSSM", flush=True)
    if mode != "broadcast":
        raise AssertionError(f"'auto' resolved to {mode}")

    # The main path: one TMC train step as a user calls it; it reaches no
    # resampling kernel.
    comps, obs = _bench_lgssm(dev, 0.5)
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-2)
    step = train.make_train_step(TRAIN_K, "tmc", optimizer)
    reset_counts()
    loss = step(comps, obs, NoiseSource.seeded(61, dev))
    counts = read_counts("TMC train step")
    if any(counts.values()) or not bool(torch.isfinite(loss)):
        raise AssertionError(f"TMC step: launches {counts}, loss {loss}")

    # The exp-matmul runs at full float32 whatever the matmul precision.
    previous = torch.get_float32_matmul_precision()
    values = {}
    try:
        for precision in ("high", "highest"):
            torch.set_float32_matmul_precision(precision)
            values[precision] = losses.get_loss(
                obs, TRAIN_K, "tmc", *comps,
                noise=NoiseSource.seeded(62, dev)).detach()
    finally:
        torch.set_float32_matmul_precision(previous)
    print(f"TMC loss under 'high' {float(values['high']):.6f}, 'highest' "
          f"{float(values['highest']):.6f}: equal "
          f"{torch.equal(values['high'], values['highest'])}", flush=True)
    if not torch.equal(values["high"], values["highest"]):
        raise AssertionError("the TMC loss moved with the matmul precision")

    # Graphed against eager: the first steps bit for bit.
    _, graphed = _on_device(dev, GRAPH_EQUAL_STEPS, GRAPH_EQUAL_STEPS,
                            algorithm="tmc")
    eager = _eager_steps(dev, GRAPH_EQUAL_STEPS, algorithm="tmc")
    print(f"first {GRAPH_EQUAL_STEPS} graphed TMC steps against eager "
          f"make_train_step steps from the same seed: bit-equal "
          f"{torch.equal(graphed, eager)}; losses {graphed.cpu().numpy()}",
          flush=True)
    if not torch.equal(graphed, eager):
        raise AssertionError(f"graphed TMC losses differ from eager: "
                             f"{graphed} vs {eager}")

    # Times: eager steps, then graphed blocks.
    noise = NoiseSource.seeded(63, dev)
    eager_ms = _cuda_ms(lambda: step(comps, obs, noise), warmup=1, repeat=6,
                        each=True)
    timer = _BlockTimer()
    _, hist = _on_device(dev, TMC_BLOCKS * TMC_BLOCK, TMC_BLOCK,
                         callback=timer, algorithm="tmc")
    graph_ms = timer.ms_per_step()
    med = float(np.median(graph_ms))
    q1, eager_med, q3 = _quartiles(eager_ms)
    print(f"TMC train step K={TRAIN_K}: eager median {eager_med:.3f} ms/step "
          f"(quartiles {q1:.3f}, {q3:.3f}; n={len(eager_ms)}); graphed "
          f"{np.round(graph_ms, 3).tolist()} ms/step (median {med:.3f} = "
          f"{1e3 / med:.2f} steps/s); losses finite "
          f"{bool(torch.isfinite(hist).all())}", flush=True)
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError(f"graphed TMC losses {hist}")
    _profiled_train_replay(dev, "TMC step", NO_KERNELS, med,
                           algorithm="tmc")

    # Peak memory of loss and backward, with and without remat.
    params = train.get_chained_params(*comps)
    for k in (TRAIN_K, TMC_MEMORY_K):
        peaks = {}
        for remat in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lml = tmc.tmc_log_marginal_likelihood(
                obs, *comps, k, noise=NoiseSource.seeded(64, dev),
                remat=remat)
            torch.autograd.grad(-lml.mean(), params)
            peaks[remat] = _peak_mib()
        print(f"TMC loss and gradients K={k}: peak device memory "
              f"{peaks[True]:.1f} MiB with remat, {peaks[False]:.1f} MiB "
              f"without", flush=True)


def _vrnn_model(dev, seed, compute_dtype=None):
    return vrnn.make_model(VRNN_LATENT, VRNN_HIDDEN, VRNN_OBS, seed=seed,
                           mlp_hidden=VRNN_MLP, compute_dtype=compute_dtype,
                           device=dev)


def _vrnn_data(dev):
    """The data model (seed 1) and observations of it at (VRNN_T,
    VRNN_B), from `vrnn.generate`."""
    data_model = _vrnn_model(dev, 1)
    initial, encoder, transition, emission, _ = data_model
    with torch.no_grad():
        _, obs = vrnn.generate(encoder, initial, transition, emission,
                               VRNN_T, VRNN_B, NoiseSource.seeded(80, dev))
    return data_model, obs


def _vrnn_on_device(dev, num_steps, block, callback=None, remat=True,
                    seed=85, compute_dtype=None):
    """`train.train_on_device` of a VRNN learner (seed 0, products in
    ``compute_dtype``) on observations that each step draws from the data
    model's generative components."""
    data_model, _ = _vrnn_data(dev)
    initial, encoder, transition, emission, _ = data_model
    comps = vrnn.bind_on_call(*_vrnn_model(dev, 0, compute_dtype))
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-3,
                                 capturable=True)
    return train.train_on_device(
        *comps, VRNN_K, "aesmc",
        vrnn.generative_components(encoder, initial, transition, emission),
        VRNN_T, VRNN_B, num_steps, optimizer=optimizer,
        noise=NoiseSource.seeded(seed, dev), steps_per_call=block,
        callback=callback, remat=remat)


def _gemm_split(prof):
    """Device ms of one profiled replay: matrix products (cuBLAS and
    CUTLASS kernels), the port's K1 and K2, and everything else."""
    split = {"gemm": 0.0, "K1/K2": 0.0, "rest": 0.0}
    names = (KERNELS["resample_systematic"][2], KERNELS["range_sum"][2])
    for e in _on_card(prof.key_averages()):
        us = getattr(e, "device_time_total",
                     getattr(e, "cuda_time_total", 0.0))
        key = e.key.lower()
        if any(n in e.key for n in names):
            split["K1/K2"] += us / 1e3
        elif any(w in key for w in ("gemm", "gemv", "xmma", "cutlass")):
            split["gemm"] += us / 1e3
        else:
            split["rest"] += us / 1e3
    return split


def vrnn_phase(dev):
    phase(f"16 VRNN AESMC train step at the ablation width: latent "
          f"{VRNN_LATENT}, GRU {VRNN_HIDDEN}, obs {VRNN_OBS}, MLP {VRNN_MLP}, "
          f"(T, B, K) = ({VRNN_T}, {VRNN_B}, {VRNN_K:,})")
    _, obs = _vrnn_data(dev)
    model = _vrnn_model(dev, 0)
    params = train.get_chained_params(*model[1:])
    steps = VRNN_T - 1

    # Routes: the kernel route's loss and gradients, given the plain CDF,
    # against the plain route's on the same noise.
    results = {}
    for impl in ("cuda", "torch"):
        with (_plain_cdf() if impl == "cuda" else contextlib.nullcontext()):
            loss = vrnn.vrnn_loss(obs, VRNN_K, "aesmc", *model,
                                  noise=NoiseSource.seeded(81, dev),
                                  resampling_implementation=impl)
        results[impl] = (loss.detach(), torch.autograd.grad(loss, params))
        del loss
    (loss_k, grads_k), (loss_t, grads_t) = results["cuda"], results["torch"]
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads_k, grads_t))
    print(f"VRNN loss {float(loss_k):.6f} on the kernel route given the "
          f"plain CDF, equal to the plain route's "
          f"{torch.equal(loss_k, loss_t)}; gradients within "
          f"relative error {worst:.3g} (bound {GRAD_RTOL})", flush=True)
    if not torch.equal(loss_k, loss_t) or worst > GRAD_RTOL:
        raise AssertionError(f"VRNN routes differ: {float(loss_k)} vs "
                             f"{float(loss_t)}, gradients {worst}")
    del results, grads_k, grads_t

    # The main path: one train step as a user calls it, without remat.
    comps = vrnn.bind_on_call(*model)
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-3)
    step = train.make_train_step(VRNN_K, "aesmc", optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = step(comps, obs, NoiseSource.seeded(82, dev))
    counts = read_counts("VRNN train step")
    eager_peak = _peak_mib()
    others = {n: c for n, c in counts.items()
              if n not in ("resample_systematic", "range_sum", CDF) and c}
    if (counts["resample_systematic"], counts["range_sum"], counts[CDF]) != (
            steps, steps, steps) or others or not bool(
                torch.isfinite(loss)):
        raise AssertionError(f"one VRNN step launched {counts}, loss {loss}")
    noise = NoiseSource.seeded(83, dev)
    eager_ms = _cuda_ms(lambda: step(comps, obs, noise), warmup=1, repeat=3,
                        each=True)
    remat_step = train.make_train_step(VRNN_K, "aesmc", optimizer,
                                       remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_step(comps, obs, noise)
    remat_peak = _peak_mib()
    remat_ms = _cuda_ms(lambda: remat_step(comps, obs, noise), warmup=0,
                        repeat=3, each=True)
    # GEMM operations of a step: the prior net (T - 1 steps) and the
    # decoder (T steps) on every particle, forward and twice that
    # backward; the GRU and the proposal net run on B rows only.
    rows = VRNN_B * VRNN_K
    d_in = VRNN_LATENT + VRNN_HIDDEN
    flops = 3 * 2 * rows * (
        steps * (d_in * VRNN_MLP + VRNN_MLP * 2 * VRNN_LATENT) +
        VRNN_T * (d_in * VRNN_MLP + VRNN_MLP * VRNN_OBS))
    med = float(np.median(eager_ms))
    remat_med = float(np.median(remat_ms))
    print(f"VRNN train step, eager: {np.round(eager_ms, 3).tolist()} ms "
          f"(median {med:.3f}), peak device memory {eager_peak:.1f} MiB; "
          f"with remat {np.round(remat_ms, 3).tolist()} ms (median "
          f"{remat_med:.3f}), peak {remat_peak:.1f} MiB; K1 (D = "
          f"{VRNN_LATENT}) and K2 {steps} launches each; the MLP products "
          f"{flops / 1e12:.3f} TFLOP a step = {flops / med / 1e9:.2f} "
          f"TFLOP/s eager", flush=True)
    del step, remat_step, optimizer, comps
    torch.cuda.empty_cache()

    # Graphed through train_on_device, with remat (the graph's pool keeps
    # the captured step's activations beside the warm-up's cache).
    timer = _BlockTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, hist = _vrnn_on_device(dev, 4 * VRNN_BLOCK, VRNN_BLOCK, timer)
    counts = read_counts("graphed VRNN train step")
    graph_peak = _peak_mib()
    # Block 0 is the warm-up, block 1 the capture and its replays.
    graph_ms = timer.ms_per_step(first=2)
    graph_med = float(np.median(graph_ms))
    print(f"graphed VRNN train step (train_on_device, remat): "
          f"{np.round(graph_ms, 3).tolist()} ms/step (median "
          f"{graph_med:.3f}; eager with remat {remat_med:.3f}); peak device "
          f"memory {graph_peak:.1f} MiB; losses "
          f"{np.round(hist.cpu().numpy(), 3).tolist()}", flush=True)
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError(f"graphed VRNN losses {hist}")
    torch.cuda.empty_cache()
    # With remat, K1 runs in the forward and again in the recompute.
    *_, prof = _profiled_train_replay(
        dev, "VRNN step", {KERNELS["resample_systematic"][2]: 2 * steps,
                           KERNELS["range_sum"][2]: steps}, graph_med,
        runner=lambda dev, num_steps, block, callback: _vrnn_on_device(
            dev, num_steps, block, callback))
    split = _gemm_split(prof)
    total = sum(split.values())
    print("VRNN replay by kind: " + ", ".join(
        f"{kind} {ms:.3f} ms ({ms / total:.1%})"
        for kind, ms in split.items()) +
        f"; the products at {flops / split['gemm'] / 1e9:.2f} TFLOP/s "
        f"(with the recompute's forward, {flops * 4 / 3 / split['gemm'] / 1e9:.2f})",
        flush=True)
    torch.cuda.empty_cache()

    # bf16 products (`torch.mm` with a float32 ``out_dtype``): one eager
    # step, finite, and its time; then graphed.
    bf16_comps = vrnn.bind_on_call(*_vrnn_model(dev, 0, "bfloat16"))
    bf16_step = train.make_train_step(VRNN_K, "aesmc", torch.optim.Adam(
        train.get_chained_params(*bf16_comps), lr=1e-3))
    loss = bf16_step(bf16_comps, obs, NoiseSource.seeded(84, dev))
    bf16_ms = _cuda_ms(lambda: bf16_step(bf16_comps, obs, noise), warmup=0,
                       repeat=3, each=True)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"bf16 VRNN loss {loss}")
    del bf16_comps, bf16_step
    torch.cuda.empty_cache()
    timer = _BlockTimer()
    _, hist = _vrnn_on_device(dev, 4 * VRNN_BLOCK, VRNN_BLOCK, timer,
                              compute_dtype="bfloat16")
    bf16_graph = timer.ms_per_step(first=2)
    print(f"VRNN train step with compute_dtype='bfloat16': loss "
          f"{float(loss):.4f}; eager {np.round(bf16_ms, 3).tolist()} ms "
          f"(median {float(np.median(bf16_ms)):.3f}; float32 {med:.3f}); "
          f"graphed with remat {np.round(bf16_graph, 3).tolist()} ms/step "
          f"(float32 {graph_med:.3f}); losses finite "
          f"{bool(torch.isfinite(hist).all())}", flush=True)
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError(f"graphed bf16 VRNN losses {hist}")
    torch.cuda.empty_cache()


def score_phase(dev):
    phase(f"17 score-function gradient step: multinomial resampling, "
          f"(T, B, K) = ({T}, {B}, {TRAIN_K})")
    comps, obs = _bench_lgssm(dev, 0.5)
    _compare_routes(comps, obs, TRAIN_K, "multinomial", 70, dev,
                    gradient_estimator="score")
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-2)
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer,
                                 resampling_method="multinomial",
                                 gradient_estimator="score")
    reset_counts()
    loss = step(comps, obs, NoiseSource.seeded(71, dev))
    counts = read_counts("score train step")
    if (counts["resample_sorted"], counts["range_sum"],
            counts["resample_systematic"], counts[CDF]) != (T - 1, T - 1, 0,
                                                            T - 1):
        raise AssertionError(f"one score step launched {counts}")
    # The loss value is the pathwise multinomial loss on the same noise
    # (the score term cancels exactly; the per-step log-Z terms are summed
    # in another order).
    score = losses.get_loss(obs, TRAIN_K, "aesmc", *comps,
                            noise=NoiseSource.seeded(72, dev),
                            resampling_method="multinomial",
                            gradient_estimator="score").detach()
    pathwise = losses.get_loss(obs, TRAIN_K, "aesmc", *comps,
                               noise=NoiseSource.seeded(72, dev),
                               resampling_method="multinomial").detach()
    diff = abs(float(score) - float(pathwise))
    print(f"score loss {float(score):.6f}, pathwise {float(pathwise):.6f}: "
          f"difference {diff:.3g} (bound 1e-5 x |loss|)", flush=True)
    if diff > 1e-5 * abs(float(pathwise)):
        raise AssertionError(f"score loss {score} vs pathwise {pathwise}")
    noise = NoiseSource.seeded(73, dev)
    eager_ms = _cuda_ms(lambda: step(comps, obs, noise), warmup=1, repeat=6,
                        each=True)
    timer = _BlockTimer()
    _, hist = _on_device(dev, 4 * TMC_BLOCK, TMC_BLOCK, callback=timer,
                         resampling_method="multinomial",
                         gradient_estimator="score")
    graph_ms = timer.ms_per_step()
    q1, med, q3 = _quartiles(eager_ms)
    print(f"score train step K={TRAIN_K}: K3 and K2 {T - 1} launches each; "
          f"eager median {med:.3f} ms/step (quartiles {q1:.3f}, {q3:.3f}); "
          f"graphed {np.round(graph_ms, 3).tolist()} ms/step (median "
          f"{float(np.median(graph_ms)):.3f}); losses finite "
          f"{bool(torch.isfinite(hist).all())}", flush=True)
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError(f"graphed score losses {hist}")


def _rts(obs):
    """The RTS smoother's means and variances `[T, B]` of the bench's
    LGSSM."""
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=EMISSION_SCALE ** 2)
    obs_np = obs.cpu().numpy()
    out = [kalman.kalman_smoother(obs_np[:, b], params)
           for b in range(obs_np.shape[1])]
    return (np.stack([m for m, _ in out], axis=1),
            np.stack([v for _, v in out], axis=1))


def _timed(fn):
    """(fn's result, ms between CUDA events around one call)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@torch.no_grad()
def smoothing_phase(dev):
    phase(f"18 smoothing on the bench's LGSSM with the exact proposal: FFBS "
          f"at (T, B, K, M) = ({T}, {B}, {K:,}, {FFBS_M}), PaRIS at ({T}, "
          f"{B}, {PARIS_K:,}) with N = {PARIS_N}; genealogy variance")
    comps, obs = _optimal_lgssm(dev)
    means, variances = _rts(obs)

    # FFBS on a stored filter run.
    reset_counts()
    run, filter_ms = _timed(lambda: inference.infer(
        "smc", obs, *comps, K, noise=NoiseSource.seeded(90, dev),
        return_original_latents=True, return_log_weights=True,
        return_latents=False, return_log_weight=False))
    read_counts("FFBS's filter")
    traj, ffbs_ms = _timed(lambda: smoothing.backward_simulation(
        run["original_latents"], run["log_weights"], comps[1], FFBS_M,
        NoiseSource.seeded(91, dev)))
    smoothed = traj.mean(dim=2).cpu().numpy()
    spread = traj.var(dim=2).cpu().numpy()
    rmse = float(np.sqrt(np.mean((smoothed - means) ** 2)))
    var_dev = float(np.mean(np.abs(spread - variances) / variances))
    print(f"FFBS: trajectories {tuple(traj.shape)}; the filter "
          f"{filter_ms:.3f} ms, the backward pass {ffbs_ms:.3f} ms; smoothed "
          f"means RMSE {rmse:.4f} against RTS (bound {FFBS_RMSE}), variances "
          f"mean relative deviation {var_dev:.4f} (bound {FFBS_VAR_DEV})",
          flush=True)
    if not (rmse < FFBS_RMSE and var_dev < FFBS_VAR_DEV):
        raise AssertionError(f"FFBS off the RTS smoother: {rmse}, {var_dev}")

    # PaRIS: the smoothed sum of states, both backward modes.
    exact_sum = means.sum(axis=0)
    for mode in ("pairwise", "rejection"):
        reset_counts()
        out, ms = _timed(lambda: smoothing.paris(
            obs, *comps, PARIS_K, h=lambda xp, xc, t: xc, h0=lambda x0: x0,
            noise=NoiseSource.seeded(92, dev), num_backward_draws=PARIS_N,
            backward=mode))
        counts = read_counts(f"PaRIS {mode}")
        err = np.abs(out["smoothed"].cpu().numpy() - exact_sum)
        extra = ""
        if mode == "rejection":
            extra = (f"; first-round acceptance "
                     f"{np.round(out['backward_accept_rate'].cpu().numpy(), 3).tolist()}"
                     f", lanes left open "
                     f"{out['backward_unconverged'].cpu().tolist()}")
        print(f"PaRIS {mode}: {ms:.3f} ms a call; |sum of states - RTS| a "
              f"row {np.round(err, 4).tolist()} (bound {PARIS_SUM_TOL}); K1 "
              f"{counts['resample_systematic']} launches{extra}", flush=True)
        if not np.all(err < PARIS_SUM_TOL):
            raise AssertionError(f"PaRIS {mode} off the RTS sum: {err}")
        if counts["resample_systematic"] != T - 1:
            raise AssertionError(f"PaRIS {mode} launched {counts}")

    # Genealogy variance on a graphed filter (phase 9's capture): the mean
    # single-run estimates against the spread over replays, with the exact
    # proposal and multinomial resampling, the estimators' unbiased regime.
    for label, fcomps, fobs, method, replays in (
            ("exact proposal, multinomial", comps, obs, "multinomial",
             VARIANCE_REPLAYS),
            ("phase 9's filter (the bench's proposal, systematic)",
             *_bench_lgssm(dev, TRANSITION_MULT), "systematic", 16)):
        _genealogy_variance(dev, label, fcomps, fobs, method, replays,
                            check=method == "multinomial")


def _genealogy_variance(dev, label, comps, obs, method, replays, check):
    """Captures one filter call at (T, B, K), replays it ``replays`` times
    and compares `variance.log_z_variance` with the variance of log-Z
    across the replays, and `variance.expectation_variance` / K of the
    final state with the variance of its weighted mean (means over rows;
    with ``check``, within `VARIANCE_BAND`)."""
    noise = NoiseSource.seeded(93, dev)

    def call():
        out = inference.infer(
            "smc", obs, *comps, K, noise=noise, resampling_method=method,
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True)
        return (out["log_marginal_likelihood"], out["log_weight"],
                out["ancestral_indices"], out["last_latent"])

    train._warm_up(call, 1)
    graph, (log_z, log_weight, anc, last) = train._capture(call,
                                                           noise.generator)
    runs = {"log_z": [], "est": [], "mean": [], "sigma2": []}
    _, replay_ms = _timed(graph.replay)
    for _ in range(replays):
        graph.replay()
        w = torch.softmax(log_weight, dim=-1)
        runs["log_z"].append(log_z.double())
        runs["est"].append(variance.log_z_variance(log_weight, anc).double())
        runs["mean"].append((w * last).sum(dim=-1).double())
        runs["sigma2"].append(variance.expectation_variance(
            last, log_weight, anc).double())
    runs = {name: torch.stack(values) for name, values in runs.items()}
    pairs = {"log_z_variance": (float(runs["est"].mean()),
                                float(runs["log_z"].var(dim=0).mean())),
             "expectation_variance / K": (
                 float(runs["sigma2"].mean()) / K,
                 float(runs["mean"].var(dim=0).mean()))}
    families = variance.num_families(anc).cpu().tolist()
    low, high = VARIANCE_BAND
    for name, (est, replicate) in pairs.items():
        print(f"{label}: {name} mean {est:.4g} against the variance over "
              f"{replays} replays {replicate:.4g} (ratio "
              f"{est / replicate:.3f}; band {low} to {high}"
              f"{'' if check else ', not checked'})", flush=True)
        if check and not low * replicate < est < high * replicate:
            raise AssertionError(f"{label}: {name} {est} against the "
                                 f"replicate variance {replicate}")
    print(f"{label}: one replay {replay_ms:.3f} ms; surviving families in the "
          f"last replay {families}", flush=True)


# Phase 19: the streaming filter, the bench's serving rows
# (bench.py:324-402), at the headline LGSSM shape.
SERVE_S = 8
SERVE_PLANE_STEPS, SERVE_PLANE_REPLAYS = 200, 8
SERVE_PASSES = 3
SERVE_LAG, LAG_EMISSION_SCALE = 10, 0.5
GENEALOGY_TOL = 1e-4
FORECAST_H, FORECAST_TOL = 10, 0.15


def _serving_data(dev, comps, num):
    """``num`` observations of the bench's LGSSM (the true transition),
    y_0 first."""
    with torch.no_grad():
        return statistics.sample_from_prior(
            comps[0], lgssm.Transition(TRANSITION_MULT,
                                       TRANSITION_SCALE).to(dev),
            comps[2], num, B, NoiseSource.seeded(0, dev))[1]


def _stream(init_fn, step_fn, obs, noise):
    """init_fn on obs[0], then step_fn on each later observation; returns
    (the last carry, the list of infos)."""
    fs = init_fn(obs[0], noise)
    infos = []
    for t in range(1, obs.shape[0]):
        fs, info = step_fn(fs, obs[t], noise)
        infos.append(info)
    return fs, infos


def _same_tree(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _replay_stream(captured, chunks):
    """Replays ``captured`` over ``chunks``; (ms per chunk between CUDA
    events around the whole stream, each chunk's log_pred)."""
    preds = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for chunk in chunks:
        preds.append(captured(chunk)["log_pred"].clone())
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(chunks), preds


@torch.no_grad()
def serving_phase(dev):
    phase(f"19 serving: the streaming filter (online), the bench's serving "
          f"rows (bench.py:324-402), LGSSM at (B, K) = ({B}, {K:,}), "
          f"systematic, log-Z only")
    comps, _ = _bench_lgssm(dev, TRANSITION_MULT)
    obs = _serving_data(dev, comps, T + 1)           # y_0 .. y_200
    init_fn, step_fn = online.make_online_filter(*comps, K)

    # 199 eager step_fn calls against one infer call from the same source.
    reset_counts()
    fs, infos = _stream(init_fn, step_fn, obs[:T], NoiseSource.seeded(40,
                                                                      dev))
    counts = read_counts("serving")
    ref = inference.infer("smc", obs[:T], *comps, K,
                          noise=NoiseSource.seeded(40, dev),
                          return_log_marginal_likelihood=True,
                          return_latents=False)
    log_z = online.log_marginal_likelihood(fs)
    if (counts["resample_systematic"], counts[CDF]) != (T - 1, T - 1):
        raise AssertionError(f"serving launched {counts}")
    if not (torch.equal(log_z, ref["log_marginal_likelihood"]) and
            torch.equal(fs.latent, ref["last_latent"]) and
            torch.equal(fs.log_weight, ref["log_weight"])):
        raise AssertionError(
            f"the stream differs from infer: {log_z} vs "
            f"{ref['log_marginal_likelihood']}")
    a_init, a_step = online.make_online_filter(*comps, K,
                                               return_ancestors=True)
    _, a_infos = _stream(a_init, a_step, obs[:T], NoiseSource.seeded(41,
                                                                     dev))
    a_ref = inference.infer("smc", obs[:T], *comps, K,
                            noise=NoiseSource.seeded(41, dev),
                            return_ancestral_indices=True,
                            return_latents=False)
    if not torch.equal(torch.stack([i["ancestral_index"] for i in a_infos]),
                       a_ref["ancestral_indices"]):
        raise AssertionError("the stream's ancestors differ from infer's")
    print(f"init_fn + {T - 1} step_fn calls: log-Z, particles and weights "
          f"equal to one infer call from the same generator state (log-Z "
          f"{log_z.cpu().numpy()}); with return_ancestors the {T - 1} "
          f"ancestor rows equal too; K1 {counts['resample_systematic']} "
          f"launches", flush=True)

    # The other kernels of the serving step: stratified resampling (K3),
    # and the HMM's int32 particles, stratified (K4 and K5).
    hcomps, hobs = _hmm_data(dev, T, B, 0, num_states=HMM_STATES)
    for label, s_comps, s_obs, want in (
            ("serving stratified", comps, obs[:T], ("resample_sorted", CDF)),
            ("serving HMM stratified", hcomps, hobs,
             ("searchsorted_sorted", "gather_sorted", CDF))):
        s_init, s_step = online.make_online_filter(
            *s_comps, K, resampling_method="stratified")
        reset_counts()
        fs, _ = _stream(s_init, s_step, s_obs, NoiseSource.seeded(49, dev))
        counts = read_counts(label)
        ref = inference.infer("smc", s_obs, *s_comps, K,
                              noise=NoiseSource.seeded(49, dev),
                              resampling_method="stratified",
                              return_log_marginal_likelihood=True,
                              return_latents=False)
        if any(counts[name] != T - 1 for name in want) or not (
                torch.equal(online.log_marginal_likelihood(fs),
                            ref["log_marginal_likelihood"]) and
                torch.equal(fs.latent, ref["last_latent"])):
            raise AssertionError(f"{label}: {counts}, or the stream differs "
                                 f"from infer")
        print(f"{label}: {T - 1} step_fn calls equal one infer call; "
              f"{', '.join(f'{n} {counts[n]}' for n in want)} launches",
              flush=True)

    # Eager ms per observation, and the device's idle share over a stream.
    noise = NoiseSource.seeded(42, dev)
    eager_ms = [_timed(lambda: _stream(init_fn, step_fn, obs[:T], noise))[1]
                / (T - 1) for _ in range(SERVE_PASSES)]
    with _profiled() as prof:
        _, span = _timed(lambda: _stream(init_fn, step_fn, obs[:T], noise))
    _, device_ms = _kernel_events(prof)
    print(f"serving, eager: {[round(x, 4) for x in eager_ms]} ms per "
          f"observation over {SERVE_PASSES} streams of {T - 1} steps "
          f"(median {float(np.median(eager_ms)):.4f}); a profiled stream: "
          f"device busy {device_ms:.3f} of {span:.3f} ms, idle share "
          f"{1 - device_ms / span:.2%}", flush=True)

    # One step captured in a CUDA graph: replays over the stream equal
    # eager steps from the same generator state and carry, bit for bit.
    noise = NoiseSource.seeded(43, dev)
    fs0 = init_fn(obs[0], noise)
    captured = online.CapturedStep(step_fn, fs0, obs[1], noise)
    start = noise.generator.get_state()
    steps = [obs[t] for t in range(1, T + 1)]
    _, replayed = _replay_stream(captured, steps)
    noise.generator.set_state(start)
    fs, eager_preds = fs0, []
    for y in steps:
        fs, info = step_fn(fs, y, noise)
        eager_preds.append(info["log_pred"])
    if not (_same_tree(replayed, eager_preds) and
            _same_tree(online._fields(captured.state), online._fields(fs))):
        raise AssertionError("the graphed step differs from eager steps")
    graph_ms = [_replay_stream(captured, steps)[0]
                for _ in range(SERVE_PASSES)]
    _profile_replay(lambda: captured(steps[0]), "serving, one graphed step",
                    {"resample_systematic_kernel": 1},
                    float(np.median(graph_ms)))
    print(f"serving, one step graphed: {T} replays equal {T} eager steps "
          f"bit for bit (log_pred and the carry); "
          f"{[round(x, 4) for x in graph_ms]} ms per observation (the "
          f"observation's copy and the replay; "
          f"median {float(np.median(graph_ms)):.4f})", flush=True)

    # batched_steps, S observations a replay.
    batched = online.batched_steps(step_fn)
    chunks = [obs[t:t + SERVE_S] for t in range(1, T + 1 - SERVE_S,
                                                 SERVE_S)]
    captured = online.CapturedStep(batched, fs0, chunks[0], noise)
    start = noise.generator.get_state()
    _, replayed = _replay_stream(captured, chunks[:3])
    noise.generator.set_state(start)
    fs, eager_preds = fs0, []
    for chunk in chunks[:3]:
        fs, info = batched(fs, chunk, noise)
        eager_preds.append(info["log_pred"])
    if not _same_tree(replayed, eager_preds):
        raise AssertionError("the graphed batched_steps differ from eager")
    s_ms = [_replay_stream(captured, chunks)[0] / SERVE_S
            for _ in range(SERVE_PASSES)]
    print(f"serving, batched_steps S={SERVE_S} graphed: equal to eager "
          f"batches bit for bit; {[round(x, 4) for x in s_ms]} ms per "
          f"observation (median {float(np.median(s_ms)):.4f})", flush=True)

    # The device plane: a captured 200-step batched_steps, replayed 8 times.
    block = obs[1:SERVE_PLANE_STEPS + 1]
    captured = online.CapturedStep(batched, fs0, block, noise)
    plane_ms = [_replay_stream(captured, [block] * SERVE_PLANE_REPLAYS)[0] /
                SERVE_PLANE_STEPS for _ in range(SERVE_PASSES)]
    _profile_replay(lambda: captured(block), "serving, device plane",
                    {"resample_systematic_kernel": SERVE_PLANE_STEPS},
                    float(np.median(plane_ms)) * SERVE_PLANE_STEPS)
    print(f"serving, device plane ({SERVE_PLANE_REPLAYS} replays of a "
          f"{SERVE_PLANE_STEPS}-step graph): {[round(x, 4) for x in plane_ms]}"
          f" ms per step (median {float(np.median(plane_ms)):.4f})",
          flush=True)
    del captured
    EAGER_MS["serving"] = dict(eager=eager_ms, graph=graph_ms,
                               batched=s_ms, plane=plane_ms)

    _serving_options(dev, comps, obs)
    _fold_cost(dev)


FOLD_REPLAYS, FOLD_TERMS_REPEAT = 10, 50


def _fold_cost(dev):
    """What summing the log-Z terms in time order costs (a running sum,
    `inference._sum_in_order`, which the stream's bits need): the graphed
    LGSSM filter at (T, B, K) captured with it and with one stacked sum,
    replayed in turns; and the eager sum of T - 1 `[B]` terms both ways."""
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    fold = inference._sum_in_order
    routes = {"fold": fold,
              "stacked": lambda values: torch.stack(values).sum(0)}
    graphs = {}
    for name, summer in routes.items():
        noise = NoiseSource.seeded(33, dev)

        def call(noise=noise):
            return inference.infer(
                "smc", obs, *comps, K, noise=noise,
                return_log_marginal_likelihood=True, return_latents=False,
                return_log_weight=False)["log_marginal_likelihood"]

        inference._sum_in_order = summer
        try:
            train._warm_up(call, 1)
            graphs[name] = train._capture(call, noise.generator)[0]
        finally:
            inference._sum_in_order = fold
    runs = {name: [] for name in routes}
    for name in ("fold", "stacked", "stacked", "fold"):
        runs[name] += _cuda_ms(graphs[name].replay, warmup=1,
                               repeat=FOLD_REPLAYS, each=True)
    terms = [torch.randn(B, device=dev) for _ in range(T - 1)]
    eager = {name: _cuda_ms(lambda summer=summer: summer(terms), 3,
                            FOLD_TERMS_REPEAT)
             for name, summer in routes.items()}
    med = {name: float(np.median(v)) for name, v in runs.items()}
    print(f"log-Z summed in time order against one stacked sum: graphed "
          f"LGSSM filter at ({T}, {B}, {K:,}) median {med['fold']:.3f} "
          f"against {med['stacked']:.3f} ms a call "
          f"({med['fold'] - med['stacked']:+.3f}; {2 * FOLD_REPLAYS} replays "
          f"each, in turns); eager, {T - 1} [{B}] terms: "
          f"{eager['fold']:.4f} against {eager['stacked']:.4f} ms",
          flush=True)
    del graphs


@torch.no_grad()
def _serving_options(dev, comps, obs):
    """Genealogy, fixed lag, streaming PaRIS, export and forecasting at
    full width."""
    # track_genealogy against variance.log_z_variance on infer's ancestors,
    # with the exact proposal and multinomial resampling as in phase 18:
    # with the bench's proposal every row's cloud falls to one family and
    # both estimates saturate at 1; with systematic resampling the
    # estimate (made for multinomial) clips at 0.
    ocomps, oobs = _optimal_lgssm(dev)
    g_init, g_step = online.make_online_filter(
        *ocomps, K, resampling_method="multinomial", track_genealogy=True)
    _, g_infos = _stream(g_init, g_step, oobs, NoiseSource.seeded(44, dev))
    ref = inference.infer("smc", oobs, *ocomps, K,
                          noise=NoiseSource.seeded(44, dev),
                          resampling_method="multinomial",
                          return_ancestral_indices=True,
                          return_latents=False)
    want = variance.log_z_variance(ref["log_weight"],
                                   ref["ancestral_indices"])
    families = variance.num_families(ref["ancestral_indices"]).cpu().tolist()
    err = float((g_infos[-1]["log_z_rel_var"] - want).abs().max())
    print(f"track_genealogy, exact proposal, multinomial: final "
          f"log_z_rel_var "
          f"{g_infos[-1]['log_z_rel_var'].cpu().numpy()} against "
          f"log_z_variance {want.cpu().numpy()}: max |difference| {err:.2e} "
          f"(bound {GENEALOGY_TOL}); surviving families {families}",
          flush=True)
    if min(families) < 2 or not bool(((want > 0) & (want < 1)).any()):
        raise AssertionError(f"the genealogy check saturated: estimates "
                             f"{want}, families {families}")
    if not err <= GENEALOGY_TOL:
        raise AssertionError(f"genealogy variance off by {err}")

    # fixed_lag against the RTS smoother, on the JAX test's model (the
    # bench's with emission scale 0.5, where smoothing moves the means
    # further from the filter's than at 0.2) with its exact proposal, and
    # its bound: the lagged error below half the filtered one
    # (tests/test_online.py:326-385).
    lag_comps = (lgssm.Initial(0.0, 1.0),
                 lgssm.Transition(TRANSITION_MULT, TRANSITION_SCALE).to(dev),
                 lgssm.Emission(EMISSION_MULT, LAG_EMISSION_SCALE).to(dev),
                 lgssm.optimal_proposal(
                     0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE,
                     EMISSION_MULT, LAG_EMISSION_SCALE).to(dev))
    lag_obs = statistics.sample_from_prior(*lag_comps[:3], T, B,
                                           NoiseSource.seeded(45, dev))[1]
    l_init, l_step = online.make_online_filter(*lag_comps, K,
                                               fixed_lag=SERVE_LAG)
    noise = NoiseSource.seeded(45, dev)
    fs = l_init(lag_obs[0], noise)
    filtered, lagged = {}, {}
    for t in range(1, T):
        filtered[t - 1] = statistics.empirical_mean(fs.latent, fs.log_weight)
        fs, info = l_step(fs, lag_obs[t], noise)
        if t >= SERVE_LAG:
            lagged[t - SERVE_LAG] = statistics.empirical_mean(
                info["lagged_latent"], fs.log_weight)
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=LAG_EMISSION_SCALE ** 2)
    means = np.stack([kalman.kalman_smoother(lag_obs.cpu().numpy()[:, b],
                                             params)[0] for b in range(B)],
                     axis=1)
    lag_err = float(np.mean([np.abs(v.cpu().numpy() - means[t])
                             for t, v in lagged.items()]))
    filt_err = float(np.mean([np.abs(filtered[t].cpu().numpy() - means[t])
                              for t in lagged]))
    print(f"fixed_lag={SERVE_LAG}: mean |lagged mean - RTS| {lag_err:.4f} "
          f"against the filtered means' {filt_err:.4f} (bound: below half)",
          flush=True)
    if not lag_err < 0.5 * filt_err:
        raise AssertionError(f"fixed lag {lag_err} vs filtered {filt_err}")

    # Streaming PaRIS (pairwise) against the offline smoothing.paris.
    def h(xp, xc, t):
        return xc

    p_init, p_step = online.make_online_filter(
        *ocomps, PARIS_K, paris_h=h, paris_h0=lambda x0: x0,
        paris_num_draws=PARIS_N)
    (fs, p_infos), stream_ms = _timed(lambda: _stream(
        p_init, p_step, oobs, NoiseSource.seeded(46, dev)))
    offline = smoothing.paris(oobs, *ocomps, PARIS_K, h=h,
                              h0=lambda x0: x0,
                              noise=NoiseSource.seeded(46, dev),
                              num_backward_draws=PARIS_N)
    if not (torch.equal(p_infos[-1]["paris_smoothed"], offline["smoothed"])
            and torch.equal(fs.tau, offline["tau"]) and torch.equal(
                online.log_marginal_likelihood(fs),
                offline["log_marginal_likelihood"])):
        raise AssertionError("streaming PaRIS differs from smoothing.paris")
    print(f"streaming PaRIS (pairwise) at ({T}, {B}, {PARIS_K:,}): smoothed "
          f"sums, statistics and log-Z equal to smoothing.paris on the same "
          f"noise; {stream_ms / (T - 1):.4f} ms per observation", flush=True)

    # export_step -> load_step: the loaded program equals the live step
    # and launches K1 inside it.
    init_fn, step_fn = online.make_online_filter(*comps, K)
    noise = NoiseSource.seeded(47, dev)
    fs = init_fn(obs[0], noise)
    (blob, export_ms) = _timed(lambda: online.export_step(step_fn, fs,
                                                          obs[1]))
    step = online.load_step(blob)
    start = noise.generator.get_state()
    live = step_fn(fs, obs[1], noise)
    noise.generator.set_state(start)
    reset_counts()
    loaded = step(fs, obs[1], noise)
    counts = read_counts("serving (exported step)")
    if (counts["resample_systematic"], counts[CDF]) != (1, 1):
        raise AssertionError(f"the exported step launched {counts}")
    if not _same_tree((online._fields(live[0]), live[1]),
                      (online._fields(loaded[0]), loaded[1])):
        raise AssertionError("the exported step differs from the live step")
    loaded_ms = _cuda_ms(lambda: step(fs, obs[1], noise), 3, 20)
    live_ms = _cuda_ms(lambda: step_fn(fs, obs[1], noise), 3, 20)
    print(f"export_step: {len(blob):,} bytes in {export_ms:.1f} ms; the "
          f"loaded step equals the live step and launched K1 "
          f"{counts['resample_systematic']} time inside the program; "
          f"{loaded_ms:.4f} ms a loaded step against {live_ms:.4f} live",
          flush=True)

    # forecast_online: the h-step predictive mean against the Kalman
    # recursion 0.9^h E[x_t | y_0:t], exact proposal.
    o_init, o_step = online.make_online_filter(*ocomps, K)
    fs, _ = _stream(o_init, o_step, oobs, NoiseSource.seeded(48, dev))
    out = forecast.forecast_online(fs, ocomps[1], ocomps[2], FORECAST_H,
                                   NoiseSource.seeded(49, dev))
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=EMISSION_SCALE ** 2)
    last = np.array([kalman.kalman_filter(oobs.cpu().numpy()[:, b],
                                          params)[0][-1] for b in range(B)])
    pred = torch.stack([statistics.empirical_mean(out["latents"][h],
                                                  fs.log_weight)
                        for h in range(FORECAST_H)]).cpu().numpy()
    exact = np.stack([TRANSITION_MULT ** (h + 1) * last
                      for h in range(FORECAST_H)])
    err = np.abs(pred - exact)
    if out["latents"].shape != (FORECAST_H, B, K) or not np.isfinite(
            pred).all() or not err.mean() < FORECAST_TOL:
        raise AssertionError(f"forecast_online off: {err}")
    print(f"forecast_online at horizon {FORECAST_H}: predictive means "
          f"{float(err.mean()):.4f} from the Kalman recursion on average "
          f"over rows and horizons (bound {FORECAST_TOL}), at most "
          f"{float(err.max()):.4f}", flush=True)


# Phase 20: OT resampling at the JAX package's engine sizes
# (benchmarks/ot_engine_probe.py:32, benchmarks/BENCH_NOTES.md:220-227).
OT_T, OT_B, OT_K, OT_ITERATIONS = 50, 4, 4096, 20
# K = 16,384 cut to T = 5 for the time limit (from 10, itself cut from
# the probe's T = 50, ~70 s a call blocked on an H100); the phase makes ~7
# calls at this K. The loss with its gradient at OT_T.
OT_LARGE_T, OT_LARGE_K, OT_RANK = 5, 16384, 32
OT_MARGINAL_TOL, OT_MEAN_TOL = 1e-3, 5e-3
OT_TIMED_CALLS = 1


def _ot_call(comps, obs, k, noise, **kwargs):
    return lambda: inference.infer(
        "smc", obs, *comps, k, noise=noise, resampling_method="ot",
        ot_num_iterations=OT_ITERATIONS, return_log_marginal_likelihood=True,
        return_latents=False, return_log_weight=False,
        **kwargs)["log_marginal_likelihood"]


def _ot_rows(label, comps, obs, k, seed, graphed=True, **kwargs):
    """Eager ms a step (and peak MiB), and graphed (replay == eager from the
    same generator state); returns the eager log-Z."""
    steps = obs.shape[0] - 1
    noise = NoiseSource.seeded(seed, obs.device)
    call = _ot_call(comps, obs, k, noise, **kwargs)
    torch.cuda.reset_peak_memory_stats()
    log_z, first_ms = _timed(call)
    peak = _peak_mib()
    eager_ms = [_timed(call)[1] / steps for _ in range(OT_TIMED_CALLS)]
    line = (f"{label}: eager {[round(x, 3) for x in eager_ms]} ms a step "
            f"(first call {first_ms / steps:.3f}), peak {peak:.1f} MiB")
    if graphed:
        train._warm_up(call, 1)
        graph, out = train._capture(call, noise.generator)
        start = noise.generator.get_state()
        graph.replay()
        replayed = out.clone()
        noise.generator.set_state(start)
        if not torch.equal(replayed, call()):
            raise AssertionError(f"{label}: the graphed call differs")
        graph_ms = [_timed(graph.replay)[1] / steps
                    for _ in range(OT_TIMED_CALLS)]
        line += (f"; graphed {[round(x, 3) for x in graph_ms]} ms a step "
                 f"(a replay equals an eager call from the same generator "
                 f"state)")
        del graph, out
    print(line, flush=True)
    if not bool(torch.isfinite(log_z).all()):
        raise AssertionError(f"{label}: log-Z {log_z}")
    return log_z


@torch.no_grad()
def _ot_plan_checks(dev):
    """`ot_resample`'s plan at full width against `tests/test_ot.py:28-30`
    (marginals) and `:44` (the weighted mean), with the tests' settings."""
    generator = torch.Generator(device=dev).manual_seed(60)
    logw = torch.randn(OT_B, OT_K, generator=generator, device=dev)
    x = torch.randn(OT_B, OT_K, 1, generator=generator, device=dev)
    sq = (x * x).sum(-1)
    cost = sq[:, :, None] + sq[:, None, :] - 2 * torch.bmm(x, x.transpose(
        1, 2))
    f, g = ot.sinkhorn_potentials(logw, cost, 0.5, 200)
    plan = torch.exp((f[:, :, None] + g[:, None, :] - cost) / 0.5)
    row = float((plan.sum(2) - torch.softmax(logw, -1)).abs().max())
    col = float((plan.sum(1) - 1.0 / OT_K).abs().max())
    out, _ = ot.ot_resample(logw, x[..., 0], epsilon=0.2,
                            num_iterations=200)
    mean_err = float(((torch.softmax(logw, -1) * x[..., 0]).sum(-1) -
                      out.mean(-1)).abs().max())
    print(f"ot plan at ({OT_B}, {OT_K:,}): rows within {row:.2e} of the "
          f"weights, columns within {col:.2e} of 1/K (bound "
          f"{OT_MARGINAL_TOL}); weighted mean kept within {mean_err:.2e} "
          f"(bound {OT_MEAN_TOL})", flush=True)
    if not (row < OT_MARGINAL_TOL and col < OT_MARGINAL_TOL and
            mean_err < OT_MEAN_TOL):
        raise AssertionError(f"ot plan off: {row}, {col}, {mean_err}")


def ot_phase(dev):
    phase(f"20 OT resampling: infer('smc', 'ot'), {OT_ITERATIONS} Sinkhorn "
          f"iterations, at ({OT_T}, {OT_B}, {OT_K:,}) dense and "
          f"({OT_LARGE_T}, {OT_B}, {OT_LARGE_K:,}) blocked (auto block "
          f"2,048)")
    _ot_plan_checks(dev)
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    obs = obs[:OT_T, :OT_B].contiguous()
    reset_counts()
    with torch.no_grad():
        log_z = _ot_rows(f"ot dense at ({OT_T}, {OT_B}, {OT_K:,})", comps,
                         obs, OT_K, 61)
    counts = read_counts("ot")
    if any(counts.values()):
        raise AssertionError(f"the OT path launched {counts}")
    for name in KERNELS:
        LAUNCHES[name]["ot"] = 0

    # log-Z against Kalman beside systematic's, on the same model.
    exact = _lgssm_exact(obs)
    with torch.no_grad():
        systematic = inference.infer(
            "smc", obs, *comps, OT_K, noise=NoiseSource.seeded(62, dev),
            return_log_marginal_likelihood=True,
            return_latents=False)["log_marginal_likelihood"]
    for label, est in (("ot", log_z), ("systematic", systematic)):
        rel = np.abs(est.cpu().numpy() - exact) / np.abs(exact)
        print(f"log-Z vs Kalman at ({OT_T}, {OT_B}, {OT_K:,}), the bench's "
              f"proposal, {label}: relative error a row "
              f"{np.round(rel, 5).tolist()}", flush=True)

    with torch.no_grad():
        # Dense against blocked at the crossover K = 4,096.
        _ot_rows(f"ot blocked (block {OT_K // 2:,}) at ({OT_T}, {OT_B}, "
                 f"{OT_K:,})", comps, obs, OT_K, 63, graphed=False,
                 ot_block_size=OT_K // 2)
        # K = 16,384: blocked with the auto block, and low rank.
        big = _serving_data(dev, comps, OT_LARGE_T)[:, :OT_B].contiguous()
        _ot_rows(f"ot blocked (auto) at ({OT_LARGE_T}, {OT_B}, "
                 f"{OT_LARGE_K:,})", comps, big, OT_LARGE_K, 64)
        _ot_rows(f"ot rank {OT_RANK} at ({OT_LARGE_T}, {OT_B}, "
                 f"{OT_LARGE_K:,})", comps, big, OT_LARGE_K, 65,
                 ot_rank=OT_RANK)
    _ot_gradient(dev, comps, obs)


def _ot_gradient(dev, comps, obs):
    """The AESMC loss and its gradient through 'ot' at (OT_T, OT_B,
    OT_K): finite, and a graphed loss equal to the eager one from the
    same generator state."""
    noise = NoiseSource.seeded(66, dev)
    params = list(comps[3].parameters())

    def loss_and_grads():
        loss = losses.get_loss(obs, OT_K, "aesmc", *comps, noise=noise,
                               resampling_method="ot",
                               ot_num_iterations=OT_ITERATIONS)
        return (loss.detach(),) + torch.autograd.grad(loss, params)

    torch.cuda.reset_peak_memory_stats()
    (loss, *grads), ms = _timed(loss_and_grads)
    peak = _peak_mib()
    train._warm_up(loss_and_grads, 1)
    graph, out = train._capture(loss_and_grads, noise.generator)
    start = noise.generator.get_state()
    _, graph_ms = _timed(graph.replay)
    replayed = [t.clone() for t in out]
    noise.generator.set_state(start)
    eager = loss_and_grads()
    if not all(bool(torch.isfinite(t).all()) for t in eager):
        raise AssertionError(f"OT loss or gradients not finite: {eager}")
    if not torch.equal(replayed[0], eager[0]):
        raise AssertionError(f"graphed OT loss {replayed[0]} vs {eager[0]}")
    print(f"AESMC loss through 'ot' at ({obs.shape[0]}, {OT_B}, {OT_K:,}): "
          f"loss "
          f"{float(eager[0]):.4f}, gradients finite (norm "
          f"{float(torch.cat([g.reshape(-1) for g in eager[1:]]).norm()):.4g})"
          f"; eager {ms:.1f} ms with the backward (peak {peak:.1f} MiB), "
          f"graphed {graph_ms:.1f} ms; the graphed loss equals the eager "
          f"one", flush=True)
    del graph, out


# Phase 21: Lorenz-96 (LORENZ_* above, with the kernels' cases).
EKF_LINEAR_TOL = 1e-5


def _lorenz_rows(dev, label, comps, obs, seed):
    """Eager and graphed ms a call of the log-Z filter, log-Z and the mean
    ESS of the final weights."""
    noise = NoiseSource.seeded(seed, dev)

    def call():
        out = inference.infer(
            "smc", obs, *comps, LORENZ_K, noise=noise,
            return_log_marginal_likelihood=True, return_latents=False)
        return out["log_marginal_likelihood"], statistics.ess(
            out["log_weight"])

    reset_counts()
    (log_z, ess), first_ms = _timed(call)
    counts = read_counts("lorenz")
    if (counts["resample_systematic"], counts[CDF]) != (LORENZ_T - 1,
                                                        LORENZ_T - 1):
        raise AssertionError(f"{label}: launched {counts}")
    eager_ms = [_timed(call)[1] for _ in range(3)]
    train._warm_up(call, 1)
    graph, (g_log_z, _) = train._capture(call, noise.generator)
    start = noise.generator.get_state()
    graph.replay()
    replayed = g_log_z.clone()
    noise.generator.set_state(start)
    if not torch.equal(replayed, call()[0]):
        raise AssertionError(f"{label}: the graphed call differs")
    graph_ms = [_timed(graph.replay)[1] for _ in range(5)]
    del graph
    if not bool(torch.isfinite(log_z).all()):
        raise AssertionError(f"{label}: log-Z {log_z}")
    print(f"Lorenz-96 {label}: log-Z mean {float(log_z.mean()):.3f} (rows "
          f"{np.round(log_z.cpu().numpy(), 2).tolist()}), final ESS mean "
          f"{float(ess.mean()):.1f} of {LORENZ_K}; eager "
          f"{[round(x, 3) for x in eager_ms]} ms a call (first "
          f"{first_ms:.1f}), graphed {[round(x, 3) for x in graph_ms]} "
          f"(a replay equals an eager call); K1 "
          f"{counts['resample_systematic']} launches at D = {LORENZ_D}",
          flush=True)
    return float(np.median(eager_ms)), float(np.median(graph_ms))


@torch.no_grad()
def lorenz_phase(dev):
    phase(f"21 Lorenz-96: D = {LORENZ_D}, (T, B, K) = ({LORENZ_T}, "
          f"{LORENZ_B}, {LORENZ_K:,}), bootstrap and the assimilation "
          f"proposal under three linearizations")
    boot = lorenz.make_model(dim=LORENZ_D, emission_scale=0.5,
                             proposal="bootstrap", device=dev)
    obs = statistics.sample_from_prior(*boot[:3], LORENZ_T, LORENZ_B,
                                       NoiseSource.seeded(70, dev))[1]
    times = {"bootstrap": _lorenz_rows(dev, "bootstrap", boot, obs, 71)}
    for i, linearization in enumerate(("diagonal", "extended",
                                       "unscented")):
        comps = boot[:3] + (lorenz.assimilation_proposal(
            *boot[:3], linearization=linearization),)
        times[linearization] = _lorenz_rows(
            dev, f"assimilation ({linearization})", comps, obs, 72 + i)
    for linearization in ("extended", "unscented"):
        print(f"Lorenz-96 generic {linearization} against the closed form: "
              f"{times[linearization][0] / times['diagonal'][0]:.2f}x eager, "
              f"{times[linearization][1] / times['diagonal'][1]:.2f}x "
              f"graphed", flush=True)

    # The generic path's batched algebra at its shape, [B K, D, D]: the
    # factor, and the gain's Cholesky solve as two triangular solves (the
    # port's `distributions.cho_solve`) against torch.cholesky_solve.
    generator = torch.Generator(device=dev).manual_seed(75)
    n = LORENZ_B * LORENZ_K
    a_mat = torch.randn(n, LORENZ_D, LORENZ_D, generator=generator,
                        device=dev)
    spd = a_mat @ a_mat.transpose(1, 2) + LORENZ_D * torch.eye(
        LORENZ_D, device=dev)
    rhs = torch.randn(n, LORENZ_D, LORENZ_D, generator=generator, device=dev)
    chol = distributions.cholesky(spd)

    def two_triangular():
        return distributions.cho_solve(chol, rhs)

    err = float((two_triangular() - torch.cholesky_solve(rhs, chol)).abs()
                .max())
    pieces = {"distributions.cholesky (cholesky_ex)":
              lambda: distributions.cholesky(spd),
              "two solve_triangular": two_triangular,
              "torch.cholesky_solve": lambda: torch.cholesky_solve(rhs,
                                                                   chol)}
    print(f"batched algebra at [{n}, {LORENZ_D}, {LORENZ_D}] (the two "
          f"solves agree within {err:.2e}): " + "; ".join(
              f"{label} {_cuda_ms(fn, 3, 20):.4f} ms"
              for label, fn in pieces.items()), flush=True)

    # The EKF proposal on the linear LGSSM is the exact locally-optimal
    # proposal (tests/test_proposals.py).
    a, q, c, r = TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT, \
        EMISSION_SCALE
    prop = proposals.ekf_proposal(lambda x: a * x, q ** 2, lambda x: c * x,
                                  r ** 2, 0.0, 1.0).to(dev)
    generator = torch.Generator(device=dev).manual_seed(74)
    x_prev = torch.randn(B, K, generator=generator, device=dev)
    ys = torch.randn(3, B, generator=generator, device=dev)
    d = prop(previous_latents=[x_prev], time=inference.TimeIndex(1),
             observations=inference.ObservationSequence(ys))
    var = 1.0 / (1.0 / q ** 2 + c ** 2 / r ** 2)
    loc = var * (a * x_prev / q ** 2 + c * ys[1][:, None] / r ** 2)
    loc_err = float(((d.loc - loc).abs() / loc.abs().clamp(min=1.0)).max())
    scale_err = float((d.scale - var ** 0.5).abs().max() / var ** 0.5)
    print(f"EKF proposal on the linear LGSSM at ({B}, {K:,}): loc within "
          f"{loc_err:.2e}, scale within {scale_err:.2e} of the exact "
          f"optimal proposal (bound {EKF_LINEAR_TOL}, relative)", flush=True)
    if not (loc_err < EKF_LINEAR_TOL and scale_err < EKF_LINEAR_TOL):
        raise AssertionError(f"EKF proposal off: {loc_err}, {scale_err}")


# Phases 22-25: slice D1 (the bouncing ball, SQMC, particle Gibbs, the
# RBPF). Each prints its seconds.

def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _graph_equal(label, call, noise, eager_calls=3, replays=5):
    """Captures one call of ``call`` (a tensor or a tuple of tensors) in a
    CUDA graph, checks a replay against an eager call from the same
    generator state, and times eager calls and replays by CUDA events.
    Returns (graph, the captured outputs, median eager ms, median replay
    ms)."""
    eager_ms = [_timed(call)[1] for _ in range(eager_calls)]
    train._warm_up(call, 1)
    graph, out = train._capture(call, noise.generator)
    state = noise.generator.get_state()
    graph.replay()
    replayed = [x.clone() for x in _as_tuple(out)]
    noise.generator.set_state(state)
    eager = _as_tuple(call())
    if not all(torch.equal(a, b) for a, b in zip(replayed, eager)):
        raise AssertionError(f"{label}: the graphed call differs from an "
                             f"eager call from the same generator state")
    graph_ms = [_timed(graph.replay)[1] for _ in range(replays)]
    eager_med, graph_med = (float(np.median(eager_ms)),
                            float(np.median(graph_ms)))
    print(f"{label}: eager {[round(x, 3) for x in eager_ms]} ms (median "
          f"{eager_med:.3f}), graphed {[round(x, 3) for x in graph_ms]} ms "
          f"(median {graph_med:.3f}); a replay equals an eager call from the "
          f"same generator state", flush=True)
    return graph, out, eager_med, graph_med


def _phase_seconds(label, start):
    print(f"phase {label} took {time.perf_counter() - start:.1f} s",
          flush=True)


# Phase 22: the JAX bench's config 4 (benchmarks/bench_extended.py:394-398)
# at full width: 64-step sequences, 32 pixels, MLP hidden 64, K = 256.
BB_T, BB_B, BB_K = 64, 16, 256
BB_PIXELS, BB_HIDDEN = 32, 64
# train_on_device: steps, and steps a block (the first block compared with
# eager steps bit for bit, the later ones timed).
BB_STEPS, BB_BLOCK = 32, 8


def _bb_model(dev, seed):
    return bouncing_ball.make_model(torch.Generator().manual_seed(seed),
                                    num_pixels=BB_PIXELS, hidden=BB_HIDDEN,
                                    device=dev)


def bouncing_ball_phase(dev):
    start = time.perf_counter()
    phase(f"22 bouncing ball (config 4): (T, B, K) = ({BB_T}, {BB_B}, "
          f"{BB_K}), {BB_PIXELS} pixels, MLP hidden {BB_HIDDEN}")
    model = _bb_model(dev, 40)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(*model[:3], BB_T, BB_B,
                                              NoiseSource.seeded(41, dev))

    def call(impl, noise):
        return inference.infer(
            "smc", obs, *model, BB_K, noise=noise,
            resampling_implementation=impl,
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True)

    with torch.no_grad():
        reset_counts()
        out = call("auto", NoiseSource.seeded(42, dev))
        counts = read_counts("bouncing ball infer")
        if (counts["resample_systematic"] != BB_T - 1 or
                _searches(counts) != BB_T - 1 or counts[CDF] != BB_T - 1):
            raise AssertionError(f"one bouncing-ball call launched {counts}")
        plain = call("torch", NoiseSource.seeded(42, dev))
        with _plain_cdf():
            same_cdf = call("auto", NoiseSource.seeded(42, dev))
        if not (torch.equal(same_cdf["ancestral_indices"],
                            plain["ancestral_indices"]) and
                torch.equal(same_cdf["log_marginal_likelihood"],
                            plain["log_marginal_likelihood"])):
            raise AssertionError("bouncing ball: the kernel route differs "
                                 "from the plain route given one CDF")
        log_z = out["log_marginal_likelihood"]
        if not bool(torch.isfinite(log_z).all()):
            raise AssertionError(f"bouncing ball log-Z {log_z}")
        ms = {"cuda": [], "torch": []}
        for impl in ("torch", "cuda", "cuda", "torch"):
            ms[impl] += [_timed(lambda: call(impl, NoiseSource.seeded(
                43, dev)))[1] for _ in range(2)]
    print(f"bouncing-ball filter: log-Z mean {float(log_z.mean()):.2f}; K1 "
          f"(D = 2) {counts['resample_systematic']} launches; ancestors and "
          f"log-Z equal on both routes given the plain CDF; eager ms a "
          f"call, kernel route "
          f"{np.round(ms['cuda'], 3).tolist()}, plain route (dense) "
          f"{np.round(ms['torch'], 3).tolist()}", flush=True)

    _compare_routes(model, obs, BB_K, "systematic", 44, dev)
    optimizer = torch.optim.Adam(train.get_chained_params(*model), lr=1e-3)
    step = train.make_train_step(BB_K, "aesmc", optimizer)
    reset_counts()
    loss = step(model, obs, NoiseSource.seeded(45, dev))
    counts = read_counts("bouncing ball train step")
    if (counts["resample_systematic"], counts["range_sum"]) != (
            BB_T - 1, BB_T - 1) or not bool(torch.isfinite(loss)):
        raise AssertionError(f"one bouncing-ball train step launched "
                             f"{counts}, loss {loss}")
    step_ms = [_timed(lambda: step(model, obs, NoiseSource.seeded(
        46, dev)))[1] for _ in range(4)]

    # train_on_device graphed: its first block against eager steps.
    gen = _bb_model(dev, 40)[:3]

    def learner():
        comps = _bb_model(dev, 47)
        return comps, torch.optim.Adam(train.get_chained_params(*comps),
                                       lr=1e-3, capturable=True)

    comps, opt = learner()
    timer = _BlockTimer()
    reset_counts()
    _, graphed = train.train_on_device(
        *comps, BB_K, "aesmc", gen, BB_T, BB_B, BB_STEPS, optimizer=opt,
        noise=NoiseSource.seeded(48, dev), steps_per_call=BB_BLOCK,
        callback=timer)
    counts = read_counts("bouncing ball graphed train (warm-up, capture)")
    comps, opt = learner()
    eager_step = train.make_train_step(BB_K, "aesmc", opt)
    noise = NoiseSource.seeded(48, dev)
    eager = []
    for _ in range(BB_BLOCK):
        with torch.no_grad():
            _, step_obs = statistics.sample_from_prior(*gen, BB_T, BB_B,
                                                       noise)
        eager.append(eager_step(comps, step_obs, noise))
    if not torch.equal(graphed[:BB_BLOCK], torch.stack(eager)):
        raise AssertionError(f"graphed bouncing-ball steps differ from "
                             f"eager: {graphed[:BB_BLOCK]} vs {eager}")
    graph_ms = timer.ms_per_step()
    print(f"bouncing-ball AESMC train step: K1 and K2 {BB_T - 1} launches "
          f"each; eager make_train_step {np.round(step_ms, 3).tolist()} ms;"
          f" train_on_device graphed {np.round(graph_ms, 3).tolist()} "
          f"ms/step (blocks after the capture); its first {BB_BLOCK} steps "
          f"bit-equal to eager steps; losses first block "
          f"{float(graphed[:BB_BLOCK].mean()):.2f}, last "
          f"{float(graphed[-BB_BLOCK:].mean()):.2f}", flush=True)
    _phase_seconds("22", start)


# Phase 23: the JAX bench's SQMC row (benchmarks/bench_extended.py:134-166):
# the LGSSM x' = 0.9 x + N(0, 1), y = x + N(0, 0.5) with its optimal
# proposal at (T, B, K) = (100, 1, 4,096); 20 scrambles for the oracle of
# tests/test_sqmc.py:214-241.
SQMC_T, SQMC_B, SQMC_K = 100, 1, 4096
SQMC_A, SQMC_Q, SQMC_EM, SQMC_R = 0.9, 1.0, 1.0, 0.5
SQMC_2D_T = 50
SQMC_SCRAMBLES, SQMC_BIAS_TOL, SQMC_VARIANCE_RATIO = 20, 0.05, 20.0


def _sqmc_k3(dev):
    """K3 alone at the SQMC step's shape (1, 4,096, 1): the Hilbert-sorted
    CDF, the sorted first Sobol coordinate and the permutation column."""
    generator = torch.Generator(device=dev).manual_seed(55)
    noise = NoiseSource(generator)
    u_first = torch.sort(sqmc.sobol_points(
        SQMC_K, 2, noise, batch_shape=(SQMC_B,))[..., 0], dim=-1).values
    logw = torch.randn(SQMC_B, SQMC_K, generator=generator, device=dev)
    sigma = sqmc.hilbert_sort_indices(torch.randn(
        SQMC_B, SQMC_K, generator=generator, device=dev))
    cdf = sqmc._sorted_cdf(logw * 2.0, sigma)
    value = sigma.to(torch.float32)[..., None]
    for emit_idx in (True, False):
        idx, out = resample_sorted_cuda.resample_and_gather_sorted(
            cdf, u_first, value, emit_idx)
        want_idx, want = resample_sorted_cuda.resample_and_gather_sorted_torch(
            cdf, u_first, value, emit_idx)
        if not torch.equal(out, want) or (emit_idx and
                                          not torch.equal(idx, want_idx)):
            raise AssertionError("K3 at the SQMC shape differs from its "
                                 "plain version")

    def kernel():
        return resample_sorted_cuda.resample_and_gather_sorted(
            cdf, u_first, value, False)

    def plain():
        return resample_sorted_cuda.resample_and_gather_sorted_torch(
            cdf, u_first, value, False)

    ms, plain_ms, _, _ = _time_pair(kernel, plain)
    device_ms = _device_ms(kernel, KERNELS["resample_sorted"][2])
    bound_ms, bound_by = _bound(4 * 4 * SQMC_K * SQMC_B,
                                SQMC_B * SQMC_K * _search_steps(SQMC_K))
    print(f"K3 at the SQMC shape ({SQMC_B}, {SQMC_K:,}, 1), emit_idx off: "
          f"exact against its plain version (tolerance 0); {ms * 1e3:.2f} us"
          f" a call by CUDA events, device {_us(device_ms)} a launch, plain "
          f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}); no single library call computes it", flush=True)


# The one-row scans (`resampling._row_cumsum`): calls repeated from one
# generator state give the same ancestors bit for bit. K = 262,144 is a row
# on which PyTorch's own one-row scan gave 10 results in 10 runs.
REPEAT_CALLS, ONE_ROW_K = 10, 262144


def _repeatable(label, fn, noise, repeats=REPEAT_CALLS):
    """Runs ``fn`` ``repeats`` times from the same generator state of
    ``noise``; its outputs must be equal bit for bit. Then runs it as often
    again with every call site's scan reverted to ``torch.cumsum`` (the
    code before the repair) and prints how many distinct outputs those
    give: whether the check could fail on this card."""
    state = noise.generator.get_state()

    def distinct(scan):
        saved, resampling._row_cumsum = resampling._row_cumsum, scan
        try:
            outs = set()
            for _ in range(repeats):
                noise.generator.set_state(state)
                outs.add(fn().cpu().numpy().tobytes())
        finally:
            resampling._row_cumsum = saved
        return len(outs)

    ours = distinct(resampling._row_cumsum)
    reverted = distinct(lambda x: torch.cumsum(x, dim=-1))
    print(f"{label}: {repeats} calls from one generator state give {ours} "
          f"distinct result (bit for bit); with the scan reverted to "
          f"torch.cumsum, {reverted} distinct results", flush=True)
    if ours != 1:
        raise AssertionError(f"{label}: repeated calls drew other ancestors")


@torch.no_grad()
def sqmc_phase(dev):
    start = time.perf_counter()
    phase(f"23 SQMC: the LGSSM with its optimal proposal, (T, B, K) = "
          f"({SQMC_T}, {SQMC_B}, {SQMC_K:,}); the d = 2 Hilbert path")
    _sqmc_k3(dev)
    q_scale, r_scale = math.sqrt(SQMC_Q), math.sqrt(SQMC_R)
    comps = (lgssm.Initial(0.0, 1.0),
             lgssm.Transition(SQMC_A, q_scale).to(dev),
             lgssm.Emission(SQMC_EM, r_scale).to(dev),
             lgssm.optimal_proposal(0.0, 1.0, SQMC_A, q_scale, SQMC_EM,
                                    r_scale).to(dev))
    _, obs = statistics.sample_from_prior(*comps[:3], SQMC_T, SQMC_B,
                                          NoiseSource.seeded(50, dev))
    exact = kalman.kalman_filter(obs[:, 0].cpu().numpy(), kalman.KalmanParams(
        0.0, 1.0, SQMC_A, 0.0, SQMC_Q, SQMC_EM, 0.0, SQMC_R))[4]

    def sqmc_call(noise, impl="auto", **kwargs):
        return sqmc.sqmc_infer(
            obs, *comps, SQMC_K, noise=noise, resampling_implementation=impl,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False, **kwargs)

    reset_counts()
    out = sqmc_call(NoiseSource.seeded(51, dev),
                    return_ancestral_indices=True)
    counts = read_counts("sqmc")
    if (counts["resample_sorted"] != SQMC_T - 1 or
            _searches(counts) != SQMC_T - 1 or counts[CDF]):
        raise AssertionError(f"one SQMC call launched {counts}")
    plain = sqmc_call(NoiseSource.seeded(51, dev), "torch",
                      return_ancestral_indices=True)
    if not (torch.equal(out["ancestral_indices"],
                        plain["ancestral_indices"]) and
            torch.equal(out["log_marginal_likelihood"],
                        plain["log_marginal_likelihood"])):
        raise AssertionError("SQMC: the K3 route differs from the torch "
                             "route")
    print(f"SQMC: K3 {counts['resample_sorted']} launches, emit_idx off; "
          f"ancestors and log-Z equal to the torch route's; log-Z "
          f"{float(out['log_marginal_likelihood'][0]):.4f}, Kalman "
          f"{exact:.4f}", flush=True)
    # B = 1: the sorted CDF is a one-row scan (`resampling._row_cumsum`),
    # as is the residual resampler's CDF of the residuals.
    repeat_noise = NoiseSource.seeded(57, dev)
    _repeatable(f"SQMC call at ({SQMC_T}, {SQMC_B}, {SQMC_K:,})",
                lambda: sqmc_call(repeat_noise, return_ancestral_indices=True
                                  )["ancestral_indices"], repeat_noise)
    residual_lw = torch.randn(1, ONE_ROW_K, device=dev,
                              generator=repeat_noise.generator)
    _repeatable(f"residual_indices at (1, {ONE_ROW_K:,})",
                lambda: resampling.residual_indices(residual_lw,
                                                    repeat_noise),
                repeat_noise)

    # The d = 2 path: two-word Hilbert keys at bits = 16.
    nd = lgssm_nd.make_model(dim=2, emission_scale=0.5, device=dev)
    optimal = lgssm_nd.optimal_proposal(*nd[:3])
    _, obs2 = statistics.sample_from_prior(*nd[:3], SQMC_2D_T, SQMC_B,
                                           NoiseSource.seeded(52, dev))
    runs = {}
    for impl in ("cuda", "torch"):
        reset_counts()
        runs[impl] = sqmc.sqmc_infer(
            obs2, *nd[:3], optimal, SQMC_K, noise=NoiseSource.seeded(53, dev),
            hilbert_bits=16, resampling_implementation=impl,
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True)
        if impl == "cuda":
            counts = read_counts("sqmc d=2")
    if counts["resample_sorted"] != SQMC_2D_T - 1 or counts[CDF] or not (
            torch.equal(runs["cuda"]["ancestral_indices"],
                        runs["torch"]["ancestral_indices"]) and
            torch.equal(runs["cuda"]["log_marginal_likelihood"],
                        runs["torch"]["log_marginal_likelihood"])):
        raise AssertionError(f"SQMC d = 2: launches {counts}, or the routes "
                             f"differ")
    exact2 = kalman_nd.kalman_filter_nd(obs2[:, 0].cpu().numpy(),
                                        lgssm_nd.kalman_params(*nd[:3]))[4]
    print(f"SQMC d = 2 (T = {SQMC_2D_T}, two-word keys at bits 16): K3 "
          f"{counts['resample_sorted']} launches, routes equal; log-Z "
          f"{float(runs['cuda']['log_marginal_likelihood'][0]):.4f}, Kalman "
          f"{exact2:.4f}", flush=True)

    # Graphed, beside plain SMC at the same shape; the oracle over
    # scrambles from the replays (each replay draws fresh noise).
    noise = NoiseSource.seeded(54, dev)
    graph, log_z, sqmc_eager, sqmc_graph = _graph_equal(
        "SQMC call", lambda: sqmc_call(noise)["log_marginal_likelihood"],
        noise)
    zq = []
    for _ in range(SQMC_SCRAMBLES):
        graph.replay()
        zq.append(float(log_z[0]))
    del graph
    smc_noise = NoiseSource.seeded(56, dev)
    graph, smc_log_z, smc_eager, smc_graph = _graph_equal(
        "plain SMC call at the same shape", lambda: inference.infer(
            "smc", obs, *comps, SQMC_K, noise=smc_noise,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"], smc_noise)
    zm = []
    for _ in range(SQMC_SCRAMBLES):
        graph.replay()
        zm.append(float(smc_log_z[0]))
    del graph
    zq, zm = np.asarray(zq), np.asarray(zm)
    bias, ratio = abs(zq.mean() - exact), zm.var() / zq.var()
    print(f"SQMC over {SQMC_SCRAMBLES} scrambles: mean log-Z {zq.mean():.4f}"
          f" (Kalman {exact:.4f}, |bias| {bias:.4f}, bound "
          f"{SQMC_BIAS_TOL}), std {zq.std():.4f}; plain SMC std "
          f"{zm.std():.4f}; variance ratio {ratio:.1f} (bound > "
          f"{SQMC_VARIANCE_RATIO}); ms a call, SQMC eager {sqmc_eager:.3f} "
          f"graphed {sqmc_graph:.3f}, SMC eager {smc_eager:.3f} graphed "
          f"{smc_graph:.3f}", flush=True)
    if not (bias < SQMC_BIAS_TOL and ratio > SQMC_VARIANCE_RATIO):
        raise AssertionError(f"SQMC oracle: bias {bias}, ratio {ratio}")
    _phase_seconds("23", start)


# Phase 24: the JAX bench's PGAS row (benchmarks/bench_extended.py:438-460)
# and the chain of tests/test_csmc.py:91-111.
PG_T, PG_B, PG_K = 50, 4, 256
PG_CHAIN_T, PG_CHAIN_B, PG_CHAIN_K = 15, 2, 64
PG_ITERATIONS, PG_BURN_IN, PG_RMSE_TOL = 300, 50, 0.25
PG_GRAPH_SWEEPS = 20
PMMH_K, PMMH_ITERATIONS = 256, 30


# The proposal of the JAX bench's row and test, `lgssm.Proposal.create(1.0,
# 1.0, PRNGKey(0))`: its fields, copied (the port draws another random
# init from a torch.Generator; one with negative weights on x_{t-1} and
# y_t mixes as badly in the JAX package as in the port).
PG_PROPOSAL = dict(lin_0_weight=0.68462825, lin_0_bias=-0.98541236,
                   lin_t_weight=[0.5691495, 0.5830701],
                   lin_t_bias=-0.32952663, scale_0=1.0, scale_t=1.0)


def _pg_components(dev, emission_scale):
    return (lgssm.Initial(0.0, 1.0),
            lgssm.Transition(0.9, 1.0).to(dev),
            lgssm.Emission(1.0, emission_scale).to(dev),
            lgssm.Proposal(**PG_PROPOSAL).to(dev))


@torch.no_grad()
def particle_gibbs_phase(dev):
    start = time.perf_counter()
    phase(f"24 particle Gibbs: the PGAS sweep at (T, B, K) = ({PG_T}, "
          f"{PG_B}, {PG_K}); the chain at ({PG_CHAIN_T}, {PG_CHAIN_B}, "
          f"{PG_CHAIN_K}) against RTS; PMMH at K = {PMMH_K}")
    comps = _pg_components(dev, 0.2)
    lat, obs_sweep = statistics.sample_from_prior(
        *comps[:3], PG_T, PG_B, NoiseSource.seeded(60, dev))
    ref = lat.clone()
    noise = NoiseSource.seeded(61, dev)

    def sweep():
        return csmc.particle_gibbs_step(ref, obs_sweep, *comps, PG_K, noise,
                                        ancestor_sampling=True)

    reset_counts()
    sweep()
    read_counts("pgas sweep")
    graph, (new_ref, _), eager_ms, graph_ms = _graph_equal(
        "PGAS sweep (the reference pinned inside the graph)", sweep, noise)
    # A chain of replays: each copies its new reference into the input.
    for _ in range(PG_GRAPH_SWEEPS):
        graph.replay()
        ref.copy_(new_ref)
    del graph
    if not bool(torch.isfinite(ref).all()):
        raise AssertionError("the graphed PGAS chain is not finite")
    print(f"PGAS sweep: {eager_ms:.3f} ms eager, {graph_ms:.3f} ms graphed "
          f"= {1e3 / graph_ms:.1f} sweeps/s; {PG_GRAPH_SWEEPS} chained "
          f"replays finite", flush=True)
    # B = 1: the conditional ancestors' spacings are a one-row scan.
    cond_noise = NoiseSource.seeded(65, dev)
    cond_lw = torch.randn(1, ONE_ROW_K, device=dev,
                          generator=cond_noise.generator)
    _repeatable(f"csmc conditional-ancestor draw at (1, {ONE_ROW_K:,})",
                lambda: csmc._conditional_ancestors(cond_lw, cond_noise),
                cond_noise)

    chain_comps = _pg_components(dev, 0.5)
    _, obs = statistics.sample_from_prior(*chain_comps[:3], PG_CHAIN_T,
                                          PG_CHAIN_B,
                                          NoiseSource.seeded(62, dev))
    reset_counts()
    (trajs, lmls), chain_ms = _timed(lambda: csmc.particle_gibbs(
        obs, *chain_comps, PG_CHAIN_K, PG_ITERATIONS,
        noise=NoiseSource.seeded(63, dev)))
    counts = read_counts("particle_gibbs (initial reference)")
    if (counts["resample_systematic"], counts[CDF]) != (PG_CHAIN_T - 1,
                                                        PG_CHAIN_T - 1):
        raise AssertionError(f"the initial reference launched {counts}")
    pg_mean = trajs[PG_BURN_IN:].mean(dim=0).cpu().numpy()       # [T, B]
    params = kalman.KalmanParams(0.0, 1.0, 0.9, 0.0, 1.0, 1.0, 0.0, 0.25)
    obs_np = obs.cpu().numpy()
    exact = np.stack([kalman.kalman_smoother(obs_np[:, b], params)[0]
                      for b in range(PG_CHAIN_B)], axis=1)
    rmse = float(np.sqrt(np.mean((pg_mean - exact) ** 2)))
    print(f"particle Gibbs, {PG_ITERATIONS} PGAS iterations in "
          f"{chain_ms:.0f} ms eager: RMSE against the RTS smoother after "
          f"{PG_BURN_IN} burn-in {rmse:.4f} (bound {PG_RMSE_TOL}); log-Z "
          f"finite {bool(torch.isfinite(lmls).all())}", flush=True)
    if not (rmse < PG_RMSE_TOL and bool(torch.isfinite(lmls).all())):
        raise AssertionError(f"particle Gibbs RMSE {rmse}")

    # PMMH on the transition's multiplier, on the sweep's data; `build` as
    # the JAX package's tests write it (the LGSSM transition keeps the
    # chain's 0-d tensor on the card).
    def build(theta):
        return (comps[0], lgssm.Transition(mult=theta["mult"], scale=1.0),
                comps[2], comps[3])

    reset_counts()
    (thetas, lps, rate), pmmh_ms = _timed(lambda: csmc.pmmh(
        obs_sweep, build, {"mult": 0.5},
        lambda theta: -0.5 * theta["mult"] ** 2, PMMH_K, PMMH_ITERATIONS,
        noise=NoiseSource.seeded(64, dev), step_size=0.05))
    read_counts("pmmh")
    print(f"PMMH, {PMMH_ITERATIONS} iterations at K = {PMMH_K} on the "
          f"sweep's data: acceptance rate {float(rate):.3f}, multiplier "
          f"{float(thetas['mult'][-1]):.3f} (truth 0.9), {pmmh_ms:.0f} ms "
          f"eager", flush=True)
    if not bool(torch.isfinite(lps).all()):
        raise AssertionError(f"PMMH log posteriors {lps}")
    _phase_seconds("24", start)


# Phase 25: the JAX bench's two switching rows
# (benchmarks/bench_extended.py:94-131, 337-369): 2 regimes, D = 2, Do = 1
# and Do = 4 (the Schur solve), (T, B, K) = (100, 10, 4,096); the oracles
# of tests/test_rbpf.py:57-64 and :173-191.
RBPF_T, RBPF_B, RBPF_K, RBPF_D = 100, 10, 4096, 2
RBPF_CHOL_DO = 9
RBPF_ENUM_T, RBPF_ENUM_SEEDS, RBPF_ENUM_TOL = 8, 4, 0.05
RBPF_KALMAN_RTOL = 1e-3
# `_psd_inverse_small` against float64 `linalg.inv`/`slogdet` of the same
# float32 stack, with the JAX function's bounds (tests/test_rbpf.py:323).
RBPF_INV_RTOL, RBPF_INV_ATOL = 2e-4, 2e-5
RBPF_LOGDET_RTOL, RBPF_LOGDET_ATOL = 2e-6, 2e-6
_SW = dict(pi0=np.array([0.6, 0.4]),
           pmat=np.array([[0.85, 0.15], [0.3, 0.7]]),
           a_by_regime=np.array([0.95, 0.2]), qvar=1.0, cmat=1.0,
           rvar=0.25, m0=0.0, p0=2.0)


def _f32(x, dev):
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def _bench_switching(dev, do):
    """The bench's switching model at Do = 1 or 4; a larger Do repeats the
    Do = 4 row's emission rows (Do = 9 reaches `_psd_inverse_small`'s
    Cholesky branch)."""
    c = ([[1.0, 0.5]] if do == 1 else
         np.resize([[1.0, 0.5], [0.3, 1.0], [0.0, 0.8], [0.6, 0.1]],
                   (do, 2)))
    r = [[0.09]] if do == 1 else 0.09 * np.eye(do) + 0.01 * np.ones((do, do))
    pi0, pmat = _f32(np.log([0.6, 0.4]), dev), _f32(
        np.log([[0.85, 0.15], [0.3, 0.7]]), dev)
    a_by, a_mat = _f32([0.95, 0.2], dev), _f32([[1.0, 0.1], [0.0, 1.0]], dev)
    zeros, eye, q = (_f32(np.zeros(RBPF_D), dev), _f32(np.eye(RBPF_D), dev),
                     _f32(0.5 * np.eye(RBPF_D), dev))
    c, d, r = _f32(c, dev), _f32(np.zeros(do), dev), _f32(r, dev)
    return dict(
        initial=lambda: distributions.Categorical(logits=pi0),
        transition=lambda previous_latents, time: distributions.Categorical(
            logits=amath.table_lookup(pmat, previous_latents[0])),
        linear_initial=lambda u0: (zeros, eye),
        linear_dynamics=lambda u, time: (
            amath.table_lookup(a_by, u)[..., None, None] * a_mat, zeros, q),
        linear_emission=lambda u, time: (c, d, r))


def _enumeration_problem(dev):
    """tests/test_rbpf.py's switching problem (T = 8, B = 1, D = 1) and its
    exact log-Z by summing all 2^T regime paths."""
    rng = np.random.default_rng(7)
    y = np.zeros(RBPF_ENUM_T)
    u = rng.choice(2, p=_SW["pi0"])
    x = rng.normal(_SW["m0"], np.sqrt(_SW["p0"]))
    for t in range(RBPF_ENUM_T):
        if t > 0:
            u = rng.choice(2, p=_SW["pmat"][u])
            x = _SW["a_by_regime"][u] * x + rng.normal(0.0,
                                                       np.sqrt(_SW["qvar"]))
        y[t] = _SW["cmat"] * x + rng.normal(0.0, np.sqrt(_SW["rvar"]))
    log_joint = []
    for bits in range(2 ** RBPF_ENUM_T):
        path = [(bits >> t) & 1 for t in range(RBPF_ENUM_T)]
        lp = np.log(_SW["pi0"][path[0]]) + sum(
            np.log(_SW["pmat"][path[t - 1], path[t]])
            for t in range(1, RBPF_ENUM_T))
        m, p, ll = _SW["m0"], _SW["p0"], 0.0
        for t in range(RBPF_ENUM_T):
            if t > 0:
                a = _SW["a_by_regime"][path[t]]
                m, p = a * m, a * a * p + _SW["qvar"]
            s = _SW["cmat"] ** 2 * p + _SW["rvar"]
            innov = y[t] - _SW["cmat"] * m
            ll += -0.5 * (np.log(2 * np.pi * s) + innov ** 2 / s)
            gain = p * _SW["cmat"] / s
            m, p = m + gain * innov, (1.0 - gain * _SW["cmat"]) * p
        log_joint.append(lp + ll)
    log_joint = np.asarray(log_joint)
    peak = log_joint.max()
    exact = peak + np.log(np.exp(log_joint - peak).sum())
    pi0, pmat = _f32(np.log(_SW["pi0"]), dev), _f32(np.log(_SW["pmat"]), dev)
    a_r = _f32(_SW["a_by_regime"], dev)
    comps = dict(
        initial=lambda: distributions.Categorical(logits=pi0),
        transition=lambda previous_latents, time: distributions.Categorical(
            logits=amath.table_lookup(pmat, previous_latents[0])),
        linear_initial=lambda u0: (torch.full(u0.shape + (1,), _SW["m0"],
                                              device=dev),
                                   torch.full(u0.shape + (1, 1), _SW["p0"],
                                              device=dev)),
        linear_dynamics=lambda u, time: (
            amath.table_lookup(a_r, u)[..., None, None],
            torch.zeros(1, device=dev),
            torch.full((1, 1), _SW["qvar"], device=dev)),
        linear_emission=lambda u, time: (
            torch.full((1, 1), _SW["cmat"], device=dev),
            torch.zeros(1, device=dev),
            torch.full((1, 1), _SW["rvar"], device=dev)))
    return _f32(y[:, None, None], dev), comps, float(exact)


def _u_independent(dev):
    """tests/test_rbpf.py's oracle problem: linear parameters that do not
    depend on u; its exact Kalman log-Z a row."""
    rng = np.random.default_rng(2)
    a = np.array([[0.9, 0.1], [0.0, 0.8]])
    q, c, r = 0.5 * np.eye(2), np.array([[1.0, 0.5]]), np.array([[0.09]])
    obs = np.zeros((15, 3, 1))
    for b in range(3):
        x = rng.multivariate_normal(np.zeros(2), np.eye(2))
        for t in range(15):
            if t > 0:
                x = a @ x + rng.multivariate_normal(np.zeros(2), q)
            obs[t, b] = c @ x + rng.multivariate_normal(np.zeros(1), r)
    params = kalman_nd.KalmanNdParams(np.zeros(2), np.eye(2), a, q, c, r)
    exact = np.array([kalman_nd.kalman_filter_nd(obs[:, b], params)[4]
                      for b in range(3)])
    comps = dict(
        initial=lambda: distributions.Normal(0.0, 1.0),
        transition=lambda previous_latents, time: distributions.Normal(
            0.5 * previous_latents[0], 1.0),
        linear_initial=lambda u0: (_f32(np.zeros(2), dev),
                                   _f32(np.eye(2), dev)),
        linear_dynamics=lambda u, time: (_f32(a, dev), _f32(np.zeros(2), dev),
                                         _f32(q, dev)),
        linear_emission=lambda u, time: (_f32(c, dev), _f32(np.zeros(1), dev),
                                         _f32(r, dev)))
    return _f32(obs, dev), comps, exact


@torch.no_grad()
def rbpf_phase(dev):
    start = time.perf_counter()
    phase(f"25 RBPF: the bench's switching rows, (T, B, K) = ({RBPF_T}, "
          f"{RBPF_B}, {RBPF_K:,}), D = {RBPF_D}, Do = 1 and 4; Do = "
          f"{RBPF_CHOL_DO} graphed")
    for do in (1, 4):
        obs = torch.randn(RBPF_T, RBPF_B, do,
                          generator=torch.Generator(device=dev).manual_seed(
                              70 + do), device=dev)
        comps = _bench_switching(dev, do)

        def call(noise, method="systematic", impl="auto"):
            out = rbpf.rbpf(obs, num_particles=RBPF_K, noise=noise,
                            resampling_method=method,
                            resampling_implementation=impl, **comps)
            return out["log_marginal_likelihood"], out["nonlinear_latents"]

        for method, kernel in (("systematic", "resample_systematic"),
                               ("stratified", "searchsorted_sorted")):
            reset_counts()
            got = call(NoiseSource.seeded(71, dev), method)
            counts = read_counts(f"rbpf Do={do} {method}")
            if (counts[kernel] != RBPF_T - 1 or
                    _searches(counts) != RBPF_T - 1 or
                    counts[CDF] != RBPF_T - 1):
                raise AssertionError(f"rbpf {method} launched {counts}")
            want = call(NoiseSource.seeded(71, dev), method, "torch")
            with _plain_cdf():
                got = call(NoiseSource.seeded(71, dev), method)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"rbpf Do={do} {method}: the routes "
                                     f"differ given one CDF")
        noise = NoiseSource.seeded(72, dev)
        graph, (log_z, _), eager_ms, graph_ms = _graph_equal(
            f"RBPF Do={do} systematic call", lambda: call(noise), noise)
        del graph
        print(f"RBPF Do = {do}: systematic K1 (indices only) and stratified "
              f"K4 {RBPF_T - 1} launches a call, each equal to the torch "
              f"route given the plain CDF; log-Z mean "
              f"{float(log_z.mean()):.3f}; {eager_ms:.3f} "
              f"ms eager, {graph_ms:.3f} ms graphed = "
              f"{RBPF_B * RBPF_K * RBPF_T / graph_ms / 1e3:.1f} M "
              f"particle-steps/s", flush=True)

    # Do = 9: the innovation solve's Cholesky branch, captured (a captured
    # torch.cholesky_solve aborted the process there).
    obs = torch.randn(RBPF_T, RBPF_B, RBPF_CHOL_DO,
                      generator=torch.Generator(device=dev).manual_seed(79),
                      device=dev)
    comps = _bench_switching(dev, RBPF_CHOL_DO)
    noise = NoiseSource.seeded(78, dev)
    graph, (log_z, _), eager_ms, graph_ms = _graph_equal(
        f"RBPF Do={RBPF_CHOL_DO} systematic call (the Cholesky branch)",
        lambda: tuple(rbpf.rbpf(
            obs, num_particles=RBPF_K, noise=noise, **comps)[key]
            for key in ("log_marginal_likelihood", "nonlinear_latents")),
        noise, eager_calls=2)
    del graph
    if not bool(torch.isfinite(log_z).all()):
        raise AssertionError(f"RBPF Do={RBPF_CHOL_DO}: log-Z not finite")
    print(f"RBPF Do = {RBPF_CHOL_DO}: log-Z mean {float(log_z.mean()):.3f}; "
          f"{eager_ms:.3f} ms eager, {graph_ms:.3f} ms graphed", flush=True)

    obs, comps, exact = _enumeration_problem(dev)
    lzs = [float(rbpf.rbpf(obs, num_particles=RBPF_K,
                           noise=NoiseSource.seeded(73 + s, dev),
                           **comps)["log_marginal_likelihood"][0])
           for s in range(RBPF_ENUM_SEEDS)]
    err = abs(np.mean(lzs) - exact)
    print(f"RBPF against enumeration of the 2^{RBPF_ENUM_T} regime paths at "
          f"K = {RBPF_K:,} over {RBPF_ENUM_SEEDS} seeds: mean log-Z "
          f"{np.mean(lzs):.4f}, exact {exact:.4f}, error {err:.4f} (bound "
          f"{RBPF_ENUM_TOL})", flush=True)
    obs, comps, exact = _u_independent(dev)
    rels = []
    for k in (1, 7, RBPF_K):
        out = rbpf.rbpf(obs, num_particles=k,
                        noise=NoiseSource.seeded(k, dev), **comps)
        rels.append(float(np.max(np.abs(
            out["log_marginal_likelihood"].cpu().numpy() - exact) /
            np.abs(exact))))
    print(f"RBPF on the u-independent problem: log-Z against the Kalman "
          f"filter, max relative error at K = 1, 7, {RBPF_K:,}: "
          f"{[f'{x:.2e}' for x in rels]} (bound {RBPF_KALMAN_RTOL})",
          flush=True)
    if not (err < RBPF_ENUM_TOL and max(rels) < RBPF_KALMAN_RTOL):
        raise AssertionError(f"RBPF oracles: {err}, {rels}")

    # The innovation solve at the Do = 4 row's stack, [B K, 4, 4].
    generator = torch.Generator(device=dev).manual_seed(76)
    a = torch.randn(RBPF_B * RBPF_K, 4, 4, generator=generator, device=dev)
    s = a @ a.transpose(1, 2) + 4.0 * torch.eye(4, device=dev)
    eye = torch.eye(4, device=dev).expand(s.shape)
    log_det, inv = rbpf._psd_inverse_small(s)
    chol = distributions.cholesky(s)
    err = float((inv - distributions.cho_solve(chol, eye)).abs().max())
    want_inv = torch.linalg.inv(s.double())
    want_log_det = torch.linalg.slogdet(s.double()).logabsdet
    inv_excess = float(((inv.double() - want_inv).abs() - RBPF_INV_ATOL -
                        RBPF_INV_RTOL * want_inv.abs()).max())
    log_det_excess = float(((log_det.double() - want_log_det).abs() -
                            RBPF_LOGDET_ATOL -
                            RBPF_LOGDET_RTOL * want_log_det.abs()).max())
    print(f"_psd_inverse_small at [{RBPF_B * RBPF_K}, 4, 4] against float64 "
          f"linalg: inverse within rtol {RBPF_INV_RTOL} + atol "
          f"{RBPF_INV_ATOL} (largest excess {inv_excess:.3e}), log-det "
          f"within rtol {RBPF_LOGDET_RTOL} + atol {RBPF_LOGDET_ATOL} "
          f"(largest excess {log_det_excess:.3e})", flush=True)
    if not (inv_excess <= 0.0 and log_det_excess <= 0.0):
        raise AssertionError(f"_psd_inverse_small: inverse excess "
                             f"{inv_excess}, log-det excess {log_det_excess}")
    pieces = {"_psd_inverse_small (Schur, closed forms)":
              lambda: rbpf._psd_inverse_small(s),
              "distributions.cholesky (cholesky_ex)":
              lambda: distributions.cholesky(s),
              "cholesky + cho_solve (the Do > 8 branch)":
              lambda: distributions.cho_solve(distributions.cholesky(s),
                                              eye)}
    print(f"innovation solve at [{RBPF_B * RBPF_K}, 4, 4] (inverses agree "
          f"within {err:.2e}): " + "; ".join(
              f"{label} {_cuda_ms(fn, 3, 20):.4f} ms"
              for label, fn in pieces.items()), flush=True)
    _phase_seconds("25", start)


# Phases 3j and 26-30: slice D2 (resample-move, the block PF, the annealed
# samplers, SMC^2 and IF2) at the JAX extended bench's rows
# (benchmarks/bench_extended.py:167-336). Phases 26-30 print their seconds.

# (B, K, D) of K1 on the D2 and D3 paths: resample-move's pairs (D = 2)
# and its t = 1 heads; the block PF's J B rows at D = 16 and 64 (indices
# only); IF2's rows (indices only); the sampler's one row (indices only);
# SMC^2's M B rows with the latent as the column; learn_twist on SV; the
# bouncing ball's learn_twist and its scored and deployed twisted runs.
PATH_K1_SHAPES = ((10, 4096, 2), (10, 4096, 1), (16, 1024, 0),
                  (128, 4096, 0), (4, 4096, 0), (8, 32768, 0),
                  (1, 16384, 0), (1, 262144, 0), (128, 256, 1),
                  (1024, 256, 1), (10, 2048, 1), (4, 2048, 2), (4, 128, 2))
# (Kc, Kp) of K4 on the waste-free root draws: one row, M = 512 positions.
D2_K4_SHAPES = ((16384, 512), (262144, 512))


def path_shapes_phase(dev):
    """K1 and K4 at the shapes the D2 and D3 paths give them, bit for bit
    against their plain versions (K4 also against torch.searchsorted)."""
    phase("3j K1 and K4 at the D2 and D3 paths' shapes against their plain "
          "versions")
    generator = torch.Generator(device=dev).manual_seed(12)
    for batch, k, d in PATH_K1_SHAPES:
        cdf, u, value = _case_inputs(batch, k, d, "normal", generator, dev)
        for emit_idx in ((True,) if d == 0 else (True, False)):
            idx, out = resample_cuda.resample_and_gather_systematic(
                cdf, u, value, emit_idx)
            want_idx, want = \
                resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, value, emit_idx)
            if not (torch.equal(out, want) and
                    (not emit_idx or torch.equal(idx, want_idx))):
                raise AssertionError(f"K1 differs from its plain version at "
                                     f"{(batch, k, d)}, emit_idx={emit_idx}")
        print(f"K1 (B, K, D) = {(batch, k, d)}: exact (tolerance 0)",
              flush=True)
    for kc, kp in D2_K4_SHAPES:
        cdf = _k4_case(1, kc, "normal", generator, dev)
        grid = ((torch.rand((1, 1), generator=generator, device=dev) +
                 torch.arange(kp, device=dev, dtype=torch.float32)) / kp)
        unsorted = torch.rand((1, kp), generator=generator, device=dev)
        for label, pos in (("systematic grid", grid),
                           ("multinomial, unsorted", unsorted)):
            got = searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos)
            want = searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf,
                                                                      pos)
            library = torch.searchsorted(cdf, pos, right=True)
            if not (torch.equal(got, want) and
                    torch.equal(got.long(), library.clamp(max=kc - 1))):
                raise AssertionError(f"K4 differs at (1, {kc}, {kp}) "
                                     f"{label}")
            print(f"K4 (B, Kc, Kp) = (1, {kc}, {kp}) {label}: equal to its "
                  f"plain version and torch.searchsorted (tolerance 0)",
                  flush=True)


def _bench_optimal_lgssm(dev):
    """The extended bench's LGSSM (`bench_extended.py:134-148`, SQMC's):
    x' = 0.9 x + N(0, 1), y = x + N(0, 0.5), its optimal proposal."""
    q_scale, r_scale = math.sqrt(SQMC_Q), math.sqrt(SQMC_R)
    return (lgssm.Initial(0.0, 1.0),
            lgssm.Transition(SQMC_A, q_scale).to(dev),
            lgssm.Emission(SQMC_EM, r_scale).to(dev),
            lgssm.optimal_proposal(0.0, 1.0, SQMC_A, q_scale, SQMC_EM,
                                   r_scale).to(dev))


def _kalman_log_z(obs, a, q, em, r):
    """Each row's exact log-Z (numpy Kalman filter)."""
    params = kalman.KalmanParams(0.0, 1.0, a, 0.0, q, em, 0.0, r)
    obs_np = obs.cpu().numpy()
    return np.array([kalman.kalman_filter(obs_np[:, b], params)[4]
                     for b in range(obs_np.shape[1])])


# Phase 26: the bench's resample-move row (`bench_extended.py:167-183`);
# the oracle of tests/test_resample_move.py:61-80 (0.6 a row).
RM_T, RM_B, RM_K, RM_MOVES = 100, 10, 4096, 2
RM_LOG_Z_TOL, RM_ACCEPTANCE = 0.6, (0.05, 0.95)


@torch.no_grad()
def resample_move_phase(dev):
    start = time.perf_counter()
    phase(f"26 resample-move: the bench's LGSSM with its optimal proposal "
          f"at (T, B, K) = ({RM_T}, {RM_B}, {RM_K:,}), {RM_MOVES} moves")
    comps = _bench_optimal_lgssm(dev)
    _, obs = statistics.sample_from_prior(*comps[:3], RM_T, RM_B,
                                          NoiseSource.seeded(80, dev))

    def call(noise, impl="auto"):
        out = resample_move.resample_move_filter(
            obs, *comps, RM_K, noise=noise, num_move_steps=RM_MOVES,
            resampling_implementation=impl, return_latents=False)
        return out["log_marginal_likelihood"], out["acceptance_rate"]

    reset_counts()
    log_z, rate = call(NoiseSource.seeded(81, dev))
    counts = read_counts("resample-move")
    if (counts["resample_systematic"] != RM_T - 1 or
            _searches(counts) != RM_T - 1 or counts[CDF] != RM_T - 1):
        raise AssertionError(f"one resample-move call launched {counts}")
    plain = call(NoiseSource.seeded(81, dev), "torch")
    with _plain_cdf():
        same_cdf = call(NoiseSource.seeded(81, dev))
    if not (torch.equal(same_cdf[0], plain[0]) and
            torch.equal(same_cdf[1], plain[1])):
        raise AssertionError("resample-move: the K1 route differs from the "
                             "torch route given one CDF")
    exact = _kalman_log_z(obs, SQMC_A, SQMC_Q, SQMC_EM, SQMC_R)
    err = float(np.max(np.abs(log_z.cpu().numpy() - exact)))
    mean_rate = float(rate.mean())
    noise = NoiseSource.seeded(82, dev)
    graph, _, eager_ms, graph_ms = _graph_equal(
        "resample-move call", lambda: call(noise), noise)
    del graph
    print(f"resample-move: K1 {counts['resample_systematic']} launches "
          f"(D = 1 at t = 1, D = 2 after), equal to the torch route given the "
          f"plain CDF; log-Z "
          f"within {err:.4f} of the Kalman filter in every row (bound "
          f"{RM_LOG_Z_TOL}); mean acceptance {mean_rate:.3f} (bounds "
          f"{RM_ACCEPTANCE}); {eager_ms:.3f} ms eager, {graph_ms:.3f} ms "
          f"graphed = {RM_B * RM_K * RM_T / graph_ms / 1e3:.1f} M "
          f"particle-steps/s", flush=True)
    if not (err < RM_LOG_Z_TOL and
            RM_ACCEPTANCE[0] < mean_rate < RM_ACCEPTANCE[1]):
        raise AssertionError(f"resample-move oracle: {err}, {mean_rate}")
    _phase_seconds("26", start)


# Phase 27: the bench's two block-PF rows on Lorenz-96 with blocks of 4
# (`bench_extended.py:184-204, 315-336`): (D, T, B, K); the oracle of
# tests/test_blockpf.py:57-76 at its shape (D = 16, T = 20, K = 128, 3
# seeds, transition scale 0.4).
BPF_ROWS = ((16, 50, 4, 1024), (64, 50, 8, 4096))
BPF_BLOCK = 4
BPF_ORACLE_D, BPF_ORACLE_T, BPF_ORACLE_K, BPF_ORACLE_SEEDS = 16, 20, 128, 3


@torch.no_grad()
def _block_pf_oracle(dev):
    """Blocks of 4 against one block: the filtered RMSE must halve."""
    dim = BPF_ORACLE_D
    model = lorenz.make_model(dim=dim, emission_scale=0.5,
                              transition_scale=0.4, proposal="bootstrap",
                              device=dev)
    lat, obs = statistics.sample_from_prior(*model[:3], BPF_ORACLE_T, 1,
                                            NoiseSource.seeded(86, dev))
    truth = lat[:, 0].cpu().numpy()
    half = BPF_ORACLE_T // 2

    def rmse(block_size, seed):
        blocks = blockpf.contiguous_blocks(dim, block_size)
        out = blockpf.block_pf(obs, *model[:3], BPF_ORACLE_K, blocks,
                               noise=NoiseSource.seeded(seed, dev),
                               return_log_weights=True)
        m = blockpf.block_filtered_mean(out["latents"], out["log_weights"],
                                        blocks)[:, 0].cpu().numpy()
        return float(np.sqrt(np.mean((m[half:] - truth[half:]) ** 2)))

    plain = np.mean([rmse(dim, 87 + s) for s in range(BPF_ORACLE_SEEDS)])
    local = np.mean([rmse(BPF_BLOCK, 87 + s)
                     for s in range(BPF_ORACLE_SEEDS)])
    print(f"block PF oracle (D = {dim}, T = {BPF_ORACLE_T}, K = "
          f"{BPF_ORACLE_K}, {BPF_ORACLE_SEEDS} seeds): filtered RMSE with "
          f"blocks of {BPF_BLOCK} {local:.4f}, one block {plain:.4f} (bound: "
          f"below half, and below 1)", flush=True)
    if not (local < 0.5 * plain and local < 1.0):
        raise AssertionError(f"block PF oracle: {local} vs {plain}")


@torch.no_grad()
def block_pf_phase(dev):
    start = time.perf_counter()
    phase(f"27 block PF on Lorenz-96, blocks of {BPF_BLOCK}: (D, T, B, K) in "
          f"{BPF_ROWS}")
    for dim, num_timesteps, batch, k in BPF_ROWS:
        model = lorenz.make_model(dim=dim, emission_scale=0.5,
                                  proposal="bootstrap", device=dev)
        _, obs = statistics.sample_from_prior(*model[:3], num_timesteps,
                                              batch,
                                              NoiseSource.seeded(83, dev))
        blocks = blockpf.contiguous_blocks(dim, BPF_BLOCK)

        def call(noise, impl="auto", model=model, obs=obs, blocks=blocks,
                 k=k):
            return blockpf.block_pf(
                obs, *model[:3], k, blocks, noise=noise,
                resampling_implementation=impl,
                return_log_marginal_likelihood=True,
                return_latents=False)["log_marginal_likelihood"]

        reset_counts()
        log_z = call(NoiseSource.seeded(84, dev))
        counts = read_counts(f"block PF D={dim}")
        if (counts["resample_systematic"] != num_timesteps - 1 or
                _searches(counts) != num_timesteps - 1 or
                counts[CDF] != num_timesteps - 1):
            raise AssertionError(f"one block-PF call launched {counts}")
        with _plain_cdf():
            same_cdf = call(NoiseSource.seeded(84, dev))
        if not torch.equal(same_cdf, call(NoiseSource.seeded(84, dev),
                                          "torch")):
            raise AssertionError(f"block PF D={dim}: the routes differ given "
                                 f"one CDF")
        noise = NoiseSource.seeded(85, dev)
        graph, _, eager_ms, graph_ms = _graph_equal(
            f"block PF D={dim} call", lambda: call(noise), noise)
        del graph
        print(f"block PF D = {dim}, (T, B, K) = ({num_timesteps}, {batch}, "
              f"{k:,}): K1 (indices only) {counts['resample_systematic']} "
              f"launches on {len(blocks) * batch} rows, equal to the torch "
              f"route given the plain CDF; log-Z mean "
              f"{float(log_z.mean()):.2f}; {eager_ms:.3f} "
              f"ms eager, {graph_ms:.3f} ms graphed = "
              f"{batch * k * num_timesteps / graph_ms / 1e3:.1f} M "
              f"particle-steps/s", flush=True)

    # One block covering every dimension: the bootstrap engine, bit for
    # bit, at the first row's shape.
    dim, num_timesteps, batch, k = BPF_ROWS[0]
    model = lorenz.make_model(dim=dim, emission_scale=0.5,
                              proposal="bootstrap", device=dev)
    _, obs = statistics.sample_from_prior(*model[:3], num_timesteps, batch,
                                          NoiseSource.seeded(83, dev))
    got = blockpf.block_pf(obs, *model[:3], k,
                           blockpf.contiguous_blocks(dim, dim),
                           noise=NoiseSource.seeded(88, dev),
                           return_log_marginal_likelihood=True,
                           return_ancestral_indices=True)
    ref = inference.infer("smc", obs, *model, k,
                          noise=NoiseSource.seeded(88, dev),
                          return_log_marginal_likelihood=True,
                          return_ancestral_indices=True,
                          return_original_latents=True, return_latents=False)
    if not (torch.equal(got["ancestral_indices"][:, 0],
                        ref["ancestral_indices"]) and
            torch.equal(got["latents"], ref["original_latents"]) and
            torch.equal(got["log_marginal_likelihood"],
                        ref["log_marginal_likelihood"])):
        raise AssertionError("one-block PF differs from the bootstrap infer")
    print(f"one block (D = {dim}, K = {k:,}): ancestors, latents and log-Z "
          f"equal to the bootstrap infer bit for bit", flush=True)
    _block_pf_oracle(dev)
    _phase_seconds("27", start)


# Phase 28: the bench's annealed rows (`bench_extended.py:205-255`): the
# 16-D Gaussian, 2 moves of step 0.4, resample-move (systematic) and
# waste-free (M = 512, multinomial), at K = 16,384 and 262,144. The
# oracles of tests/test_samplers.py:37-53 and 200-218 at their settings
# (its y, D = 4, K = 2,048, normalized densities; 4 moves, or waste-free M
# = 64 with 1), over 12 runs, each from fresh prior draws: the 3-run mean
# of either package spreads 0.04 around a -0.055 bias there (60 runs each
# on the CPU), and one cloud shared by every run errs the same way in
# each (+0.124 over 12 runs on the card from one cloud and another y).
SAMPLER_D, SAMPLER_KS, SAMPLER_M = 16, (16384, 262144), 512
SAMPLER_MOVES, SAMPLER_STEP = 2, 0.4
# The graphed fixed ladder at K = 262,144 runs the adaptive ladder's last 3
# rungs (a cut of depth: waste-free there is ~1 s of host time a rung
# eagerly, and a capture runs the call eagerly 4 times); times are given a
# rung.
SAMPLER_GRAPH_RUNGS = {262144: 3}
SAMPLER_ORACLE_K, SAMPLER_ORACLE_SEEDS = 2048, 12
# jax.random.normal(PRNGKey(3), (4,)), the observation of
# tests/test_samplers.py:19.
SAMPLER_ORACLE_Y = (-1.4462569952011108, 1.5393810272216797,
                    0.38250625133514404, 1.970701813697815)


def _sampler_oracle(dev):
    dim, s0, s = len(SAMPLER_ORACLE_Y), 2.0, 0.5
    y = torch.tensor(SAMPLER_ORACLE_Y, device=dev)
    c0 = dim * math.log(s0 * math.sqrt(2 * math.pi))
    c = dim * math.log(s * math.sqrt(2 * math.pi))

    def log_prior(x):
        return -0.5 * torch.sum((x / s0) ** 2) - c0

    def log_lik(x):
        return -0.5 * torch.sum(((x - y) / s) ** 2) - c

    var = s0 ** 2 + s ** 2
    y_np = y.cpu().numpy().astype(np.float64)
    exact = float(-0.5 * np.sum(y_np ** 2) / var -
                  dim / 2 * np.log(2 * np.pi * var))
    generator = torch.Generator(device=dev).manual_seed(90)
    for label, kwargs, tol in (
            ("resample-move", dict(num_moves=4), 0.1),
            ("waste-free M = 64 multinomial",
             dict(num_moves=1, waste_free_chains=64,
                  resampling_method="multinomial"), 0.15),
            ("waste-free M = 64 systematic",
             dict(num_moves=1, waste_free_chains=64), 0.15)):
        lzs = [float(samplers.smc_sampler(
            log_prior, log_lik, s0 * torch.randn(
                SAMPLER_ORACLE_K, dim, generator=generator, device=dev),
            noise=NoiseSource.seeded(91 + seed, dev), step_size=0.4,
            **kwargs)["log_normalizer"])
            for seed in range(SAMPLER_ORACLE_SEEDS)]
        err = abs(float(np.mean(lzs)) - exact)
        print(f"sampler oracle, {label}: mean log Z over "
              f"{SAMPLER_ORACLE_SEEDS} runs {np.mean(lzs):.4f}, exact "
              f"{exact:.4f}, error {err:.4f} (bound {tol})", flush=True)
        if not err < tol:
            raise AssertionError(f"sampler oracle {label}: {err}")


@torch.no_grad()
def sampler_phase(dev):
    start = time.perf_counter()
    phase(f"28 annealed SMC samplers: the bench's {SAMPLER_D}-D Gaussian at "
          f"K in {SAMPLER_KS}, resample-move and waste-free M = {SAMPLER_M}")
    y = torch.full((SAMPLER_D,), 1.5, device=dev)

    def log_prior(x):
        return -0.5 * torch.sum(x * x)

    def log_lik(x):
        return -0.5 * torch.sum((y - x) ** 2) / 0.5

    for k in SAMPLER_KS:
        x0 = torch.randn(k, SAMPLER_D, generator=torch.Generator(
            device=dev).manual_seed(92), device=dev)
        for waste_free in (False, True):
            kwargs = dict(num_moves=SAMPLER_MOVES, step_size=SAMPLER_STEP,
                          waste_free_chains=SAMPLER_M if waste_free else None,
                          resampling_method=("multinomial" if waste_free
                                             else "systematic"))
            label = (f"waste-free M = {SAMPLER_M}" if waste_free
                     else "resample-move")
            kernel = ("searchsorted_sorted" if waste_free
                      else "resample_systematic")

            def call(noise, kwargs=kwargs, x0=x0, **extra):
                return samplers.smc_sampler(log_prior, log_lik, x0,
                                            noise=noise, **kwargs, **extra)

            reset_counts()
            out, first_ms = _timed(lambda: call(NoiseSource.seeded(93, dev),
                                                return_history=True))
            counts = read_counts(f"sampler K={k} {label}")
            rungs = int(out["num_steps"])
            if counts[kernel] != rungs or _searches(counts) != rungs or \
                    counts[CDF] != (0 if waste_free else rungs):
                raise AssertionError(f"sampler {label} at K = {k}: {rungs} "
                                     f"rungs launched {counts}")
            # One adaptive call of the waste-free sampler at the largest K
            # (2.6-4.0 s eager) keeps the run inside its time limit.
            eager = [first_ms] + ([] if waste_free and k == SAMPLER_KS[-1]
                                  else [_timed(lambda: call(
                                      NoiseSource.seeded(94, dev)))[1]])
            betas = out["beta_history"][:rungs].cpu().tolist()
            betas = betas[-SAMPLER_GRAPH_RUNGS.get(k, rungs):]
            noise = NoiseSource.seeded(95, dev)
            graph, _, fixed_ms, graph_ms = _graph_equal(
                f"sampler K={k} {label}, the fixed ladder's last "
                f"{len(betas)} rungs", lambda: tuple(
                    call(noise, betas=betas)[key] for key in
                    ("log_normalizer", "acceptance_rate")), noise,
                eager_calls=1, replays=3)
            del graph
            print(f"sampler K = {k:,} {label}: {rungs} rungs (adaptive), "
                  f"{kernel} {counts[kernel]} launches (one a rung); log Z "
                  f"{float(out['log_normalizer']):.4f}, acceptance "
                  f"{float(out['acceptance_rate']):.3f}; adaptive eager "
                  f"{[round(ms, 3) for ms in eager]} ms a call = "
                  f"{np.median(eager) / rungs:.3f} ms a rung; fixed ladder "
                  f"({len(betas)} rungs) eager {fixed_ms / len(betas):.3f} "
                  f"ms a rung, graphed {graph_ms / len(betas):.3f} ms a rung"
                  f" = {k * len(betas) / graph_ms / 1e3:.1f} M "
                  f"particle-rungs/s", flush=True)
    _sampler_oracle(dev)
    _phase_seconds("28", start)


# Phase 29: the bench's SMC^2 rows (`bench_extended.py:256-286`): the
# transition multiplier of the bench's LGSSM, T = 50, B = 1, K = 256, M =
# 128 and 1,024 theta particles; the oracle of tests/test_smc2.py:78-96 at
# its settings (T = 25, M = 384, K = 64, emission scale 0.5).
S2_T, S2_B, S2_K, S2_MS = 50, 1, 256, (128, 1024)
S2_ORACLE_T, S2_ORACLE_M, S2_ORACLE_K = 25, 384, 64


def _s2_grid_posterior(obs, emission_scale, lo=-2.5, hi=2.5, n=501):
    """The exact p(mult | y) under a N(0, 1) prior on a Kalman grid: (mean,
    std, log evidence by the trapezoid rule)."""
    grid = np.linspace(lo, hi, n)
    obs_np = obs.cpu().numpy()
    log_lik = np.array([sum(kalman.kalman_filter(
        obs_np[:, b], kalman.KalmanParams(0.0, 1.0, float(g), 0.0, 1.0, 1.0,
                                          0.0, emission_scale ** 2))[4]
        for b in range(obs_np.shape[1])) for g in grid])
    log_joint = log_lik - 0.5 * grid ** 2 - 0.5 * math.log(2 * math.pi)
    top = log_joint.max()
    w = np.exp(log_joint - top)
    log_evidence = top + math.log(float(np.sum(0.5 * (w[1:] + w[:-1]))) *
                                  (grid[1] - grid[0]))
    w /= w.sum()
    mean = float((grid * w).sum())
    return mean, float(np.sqrt(((grid - mean) ** 2 * w).sum())), \
        log_evidence


@torch.no_grad()
def _smc2_oracle(dev):
    es = 0.5
    sig = math.sqrt(1.0 / (1.0 + 1.0 / es ** 2))
    initial = lgssm.Initial(0.0, 1.0)
    emission = lgssm.Emission(1.0, es).to(dev)
    proposal = lgssm.Proposal(0.8, 0.0, [0.2 * 0.8, 0.8], 0.0, sig,
                              sig).to(dev)
    _, obs = statistics.sample_from_prior(
        initial, lgssm.Transition(0.8, 1.0).to(dev), emission, S2_ORACLE_T,
        1, NoiseSource.seeded(96, dev))

    def build(theta):
        return (initial, lgssm.Transition(mult=theta["mult"], scale=1.0),
                emission, proposal)

    theta0 = torch.randn(S2_ORACLE_M, generator=torch.Generator(
        device=dev).manual_seed(97), device=dev)
    out = smc2.smc2(obs, build, {"mult": theta0},
                    lambda theta: -0.5 * theta["mult"] ** 2, S2_ORACLE_K,
                    noise=NoiseSource.seeded(98, dev), ess_threshold=0.5,
                    num_moves=2, step_size=0.2)
    exact_mean, exact_std, exact_lz = _s2_grid_posterior(obs, es)
    w = torch.softmax(out["log_theta_weight"], dim=0).cpu().numpy()
    vals = out["theta"]["mult"].cpu().numpy()
    mean = float((vals * w).sum())
    std = float(np.sqrt(((vals - mean) ** 2 * w).sum()))
    mean_tol = max(3 * exact_std / math.sqrt(S2_ORACLE_M), 0.05)
    lz_err = abs(float(out["log_evidence"]) - exact_lz)
    print(f"SMC^2 oracle (T = {S2_ORACLE_T}, M = {S2_ORACLE_M}, K = "
          f"{S2_ORACLE_K}): posterior mean {mean:.4f} (grid {exact_mean:.4f}"
          f", bound {mean_tol:.4f}), std {std:.4f} (grid {exact_std:.4f}, "
          f"ratio bounds (0.5, 2)), log evidence "
          f"{float(out['log_evidence']):.4f} (grid {exact_lz:.4f}, bound "
          f"2.0); {int(out['num_rejuvenations'])} rejuvenations, acceptance "
          f"{float(out['acceptance_rate']):.3f}", flush=True)
    if not (abs(mean - exact_mean) < mean_tol and
            0.5 < std / exact_std < 2.0 and lz_err < 2.0 and
            int(out["num_rejuvenations"]) >= 1):
        raise AssertionError(f"SMC^2 oracle: {mean}, {std}, {lz_err}")


@torch.no_grad()
def smc2_phase(dev):
    start = time.perf_counter()
    phase(f"29 SMC^2: the bench's LGSSM multiplier, (T, B, K) = ({S2_T}, "
          f"{S2_B}, {S2_K}), M in {S2_MS}; eager (one host read a step)")
    comps = _bench_optimal_lgssm(dev)
    _, obs = statistics.sample_from_prior(*comps[:3], S2_T, S2_B,
                                          NoiseSource.seeded(99, dev))
    q_scale = math.sqrt(SQMC_Q)

    def build(theta):
        return (comps[0], lgssm.Transition(mult=theta["mult"],
                                           scale=q_scale),
                comps[2], comps[3])

    for m in S2_MS:
        theta0 = 0.8 + 0.2 * torch.randn(m, generator=torch.Generator(
            device=dev).manual_seed(100), device=dev)

        def call(noise, theta0=theta0):
            return smc2.smc2(obs, build, {"mult": theta0},
                             lambda th: -0.5 * ((th["mult"] - 0.8) / 0.2) ** 2,
                             S2_K, noise=noise)

        reset_counts()
        out = call(NoiseSource.seeded(101, dev))
        counts = read_counts(f"smc2 M={m}")
        ess = out["ess_path"].cpu().numpy()
        rejuvenated = [t for t in range(1, S2_T) if ess[t] < 0.5 * m]
        want = S2_T - 1 + 2 * sum(rejuvenated)
        if (counts["resample_systematic"] != want or
                _searches(counts) != want or counts[CDF] != want or
                len(rejuvenated) != int(out["num_rejuvenations"])):
            raise AssertionError(f"SMC^2 M = {m}: {counts}, expected K1 "
                                 f"{want} ({rejuvenated})")
        if not bool(torch.isfinite(out["log_evidence"])):
            raise AssertionError(f"SMC^2 log evidence {out['log_evidence']}")
        eager = [_timed(lambda: call(NoiseSource.seeded(102, dev)))[1]
                 for _ in range(2)]
        w = torch.softmax(out["log_theta_weight"], dim=0)
        mean = float((w * out["theta"]["mult"]).sum())
        print(f"SMC^2 M = {m}: K1 {counts['resample_systematic']} launches "
              f"({S2_T - 1} steps + 2 moves x the steps rerun at "
              f"{len(rejuvenated)} rejuvenations, t = {rejuvenated}) on "
              f"{m * S2_B} rows; log evidence "
              f"{float(out['log_evidence']):.4f}, posterior mean multiplier "
              f"{mean:.4f}, acceptance {float(out['acceptance_rate']):.3f}; "
              f"eager {[round(ms, 3) for ms in eager]} ms a call", flush=True)
    _smc2_oracle(dev)
    _phase_seconds("29", start)


# Phase 30: the bench's IF2 rows (`bench_extended.py:287-314`): the
# transition multiplier of the bench's LGSSM from 0.5, random walk 0.05,
# 10 iterations, T = 50, (B, K) = (4, 4,096) and (8, 32,768); the
# proposal, built once outside `build_components`, has the JAX bench's
# `Proposal.create(1.0, 1.0, PRNGKey(0))` fields (PG_PROPOSAL). The oracle
# of tests/test_if2.py:54-63 at its settings (T = 50, B = 2, K = 256, 40
# iterations, bootstrap, multiplier 0.8, emission scale 0.5), on the mean
# of 8 fits of each row (8 copies of the rows in one call): a fit's spread
# at K = 256 follows the data's likelihood curvature, 0.05-0.08 on a flat
# row (16 fits each of the JAX package and the port on the CPU: means
# 0.902 / 0.774 and 0.894 / 0.779 against the MLE 0.880 / 0.765).
IF2_T, IF2_ITERATIONS, IF2_ROWS = 50, 10, ((4, 4096), (8, 32768))
IF2_ORACLE_B, IF2_ORACLE_K, IF2_ORACLE_ITERATIONS, IF2_ORACLE_TOL = (
    2, 256, 40, 0.08)
IF2_ORACLE_FITS = 8


class _Bootstrap:
    """The bootstrap proposal of tests/test_if2.py: the prior at t = 0,
    the transition after."""

    def __init__(self, initial, transition):
        self.initial, self.transition = initial, transition

    def __call__(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            return self.initial()
        return self.transition(previous_latents=previous_latents, time=time)


def _grid_mle(obs, a_grid, q, em, r):
    """Each row's maximum-likelihood multiplier on ``a_grid`` (Kalman)."""
    obs_np = obs.cpu().numpy()
    out = []
    for b in range(obs_np.shape[1]):
        lls = [kalman.kalman_filter(obs_np[:, b], kalman.KalmanParams(
            0.0, 1.0, float(g), 0.0, q, em, 0.0, r))[4] for g in a_grid]
        out.append(a_grid[int(np.argmax(lls))])
    return np.array(out)


@torch.no_grad()
def _if2_oracle(dev):
    initial = lgssm.Initial(0.0, 1.0)
    emission = lgssm.Emission(1.0, 0.5).to(dev)
    _, obs = statistics.sample_from_prior(
        initial, lgssm.Transition(0.8, 1.0).to(dev), emission, IF2_T,
        IF2_ORACLE_B, NoiseSource.seeded(103, dev))

    def build(theta):
        transition = lgssm.Transition(mult=theta["mult"], scale=1.0)
        return initial, transition, emission, _Bootstrap(initial, transition)

    out = if2.if2(obs.repeat(1, IF2_ORACLE_FITS), build, {"mult": 0.3},
                  {"mult": 0.1}, IF2_ORACLE_K, IF2_ORACLE_ITERATIONS,
                  noise=NoiseSource.seeded(104, dev), cooling=0.9)
    mle = _grid_mle(obs, np.linspace(0.5, 1.1, 121), 1.0, 1.0, 0.25)
    fits = out["theta_mean"]["mult"].cpu().numpy().reshape(
        IF2_ORACLE_FITS, IF2_ORACLE_B)
    est = fits.mean(axis=0)
    lls = out["log_likelihoods"].cpu().numpy().reshape(
        IF2_ORACLE_ITERATIONS, IF2_ORACLE_FITS, IF2_ORACLE_B).mean(axis=1)
    rising = bool((lls[-3:].mean(axis=0) > lls[:3].mean(axis=0)).all())
    err = float(np.abs(est - mle).max())
    print(f"IF2 oracle (T = {IF2_T}, B = {IF2_ORACLE_B}, K = {IF2_ORACLE_K}, "
          f"{IF2_ORACLE_ITERATIONS} iterations, {IF2_ORACLE_FITS} fits a "
          f"row): mean estimates {np.round(est, 4)} (fits' sd "
          f"{np.round(fits.std(axis=0), 4)}), Kalman-grid MLE {mle}, largest "
          f"error {err:.4f} (bound {IF2_ORACLE_TOL}); log-likelihood trend "
          f"rising {rising}", flush=True)
    if not (err < IF2_ORACLE_TOL and rising):
        raise AssertionError(f"IF2 oracle: {err}, rising {rising}")


@torch.no_grad()
def if2_phase(dev):
    start = time.perf_counter()
    phase(f"30 IF2: the bench's LGSSM multiplier, T = {IF2_T}, "
          f"{IF2_ITERATIONS} iterations, (B, K) in {IF2_ROWS}")
    comps = _bench_optimal_lgssm(dev)
    proposal = lgssm.Proposal(**PG_PROPOSAL).to(dev)
    q_scale = math.sqrt(SQMC_Q)

    def build(theta):
        return (comps[0], lgssm.Transition(mult=theta["mult"],
                                           scale=q_scale),
                comps[2], proposal)

    for batch, k in IF2_ROWS:
        _, obs = statistics.sample_from_prior(*comps[:3], IF2_T, batch,
                                              NoiseSource.seeded(105, dev))

        def call(noise, theta0, iterations, obs=obs, k=k):
            out = if2.if2(obs, build, {"mult": theta0}, {"mult": 0.05}, k,
                          iterations, noise=noise)
            return out["theta"]["mult"], out["log_likelihoods"]

        reset_counts()
        swarm, log_liks = call(NoiseSource.seeded(106, dev), 0.5,
                               IF2_ITERATIONS)
        counts = read_counts(f"if2 B={batch} K={k}")
        want = IF2_ITERATIONS * IF2_T
        if (counts["resample_systematic"] != want or
                _searches(counts) != want or counts[CDF] != want):
            raise AssertionError(f"IF2 launched {counts}, expected K1 {want}")
        eager = [_timed(lambda: call(NoiseSource.seeded(107, dev), 0.5,
                                     IF2_ITERATIONS))[1] for _ in range(2)]
        # One iteration from the fitted swarm, captured.
        noise = NoiseSource.seeded(108, dev)
        graph, _, iter_eager_ms, iter_graph_ms = _graph_equal(
            f"IF2 B={batch} K={k}, one iteration", lambda: call(
                noise, swarm, 1), noise)
        del graph
        est = swarm.mean(dim=1).cpu().numpy()
        mle = _grid_mle(obs, np.linspace(0.5, 1.2, 141), SQMC_Q, SQMC_EM,
                        SQMC_R)
        print(f"IF2 (B, K) = ({batch}, {k:,}): K1 (indices only) "
              f"{counts['resample_systematic']} launches ({IF2_T} an "
              f"iteration: {IF2_T - 1} steps and the final draw); estimates "
              f"{np.round(est, 4)} against the Kalman-grid MLE {mle}; eager "
              f"{[round(ms, 3) for ms in eager]} ms a fit; one iteration "
              f"{iter_eager_ms:.3f} ms eager, {iter_graph_ms:.3f} ms graphed "
              f"= {batch * k * IF2_T / iter_graph_ms / 1e3:.1f} M "
              f"particle-steps/s", flush=True)
        if not bool(torch.isfinite(log_liks).all()):
            raise AssertionError(f"IF2 log-likelihoods {log_liks}")
    _if2_oracle(dev)
    _phase_seconds("30", start)


# Phases 31-34: slice D3 (twisted SMC, the bouncing ball's twist, the
# EnKF). Each prints its seconds.
# Stochastic volatility (mu, phi, sigma, beta) of
# `benchmarks/twisted_probe_r3.py:34-35`, learned with 2 ADP iterations at
# K = 2,048 (`:85-88`); log-Z spreads over 16 seeds (`:99-107`).
TW_SV = (0.0, 0.95, 0.6, 0.8)
TW_LEARN_K, TW_LEARN_ITERATIONS, TW_SEEDS = 2048, 2, 16
# The learned SV twist must cut the log-Z spread by more than this factor
# (11.8x measured on an H100 80GB HBM3 at 700 W).
TW_SV_SPREAD_RATIO = 3.0
# The exact twist's log-Z against the Kalman filter, relative, a row.
TW_EXACT_REL_TOL = 1e-4
# The deep twist (`benchmarks/twisted_probe_r4.py:40-41, 70-100`,
# `tests/test_twisted.py:357-397`): the bouncing ball at T = 32, B = 4,
# one jittered pass at K = 2,048, scored at K = 128 over 6 seeds, on that
# test's own observations (`tests/data/make_twisted_fixture.py`): its bars
# are the test's, and on other observations a row can select the zero
# twist in the JAX package too.
TW_BB_OBS = pathlib.Path(__file__).resolve().parent.joinpath(
    "tests", "data", "twisted_bouncing_ball_obs.npy")
TW_BB_T, TW_BB_B, TW_BB_LEARN_K, TW_BB_K = 32, 4, 2048, 128
TW_BB_JITTER, TW_BB_SCORE_SEEDS = 3.0, 6
TW_BB_MEAN_GAIN, TW_BB_SPREAD_RATIO = 5000.0, 0.1
# The EnKF: the linear oracle of tests/test_enkf.py:36-61 (T, B, N, D) and
# its bars; Lorenz-96 at the block PF's production row
# (`bench_extended.py:315-320`: D = 64, T = 50, B = 8, r = 0.5, every
# component observed) with N = 64 members.
ENKF_T, ENKF_B, ENKF_N, ENKF_D = 12, 2, 4000, 4
ENKF_RMSE_TOL, ENKF_VAR_TOL, ENKF_LL_REL_TOL = 0.08, 0.08, 0.05
ENKF_L96_D, ENKF_L96_T, ENKF_L96_B, ENKF_L96_N = 64, 50, 8, 64
ENKF_INFLATION, ENKF_RADIUS, ENKF_L96_RMSE_TOL = 1.05, 2.0, 1.0


def _replayed(graph, out, n):
    """``n`` replays of a captured log-Z call: `[n, B]` numpy (each replay
    draws fresh noise from the graph's generator)."""
    values = []
    for _ in range(n):
        graph.replay()
        values.append(out.cpu().numpy().copy())
    return np.stack(values)


def _check_launches(label, counts, want):
    """The wrappers' counts of one call against ``want`` {kernel: n}; every
    other kernel 0."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{label} launched {counts}, expected "
                                 f"{want}")


@torch.no_grad()
def twisted_phase(dev):
    start = time.perf_counter()
    phase(f"31 continuous twisted SMC at (T, B, K) = ({T}, {B}, {K:,}): the "
          f"exact LGSSM twist; stochastic volatility {TW_SV}, zero and "
          f"learned twists")
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    emission = comps[2]
    spec = twisted.GaussianSSMSpec(
        0.0, 1.0, TRANSITION_SCALE, mean_fn=lambda x, t: TRANSITION_MULT * x)
    exact_twist = twisted.exact_lgssm_twist(
        obs, 0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE)
    reset_counts()
    out = twisted.twisted_smc(obs, spec, emission, exact_twist, K,
                              noise=NoiseSource.seeded(110, dev),
                              return_latents=False, return_log_weights=True)
    counts = read_counts("twisted lgssm (exact twist)")
    _check_launches("twisted LGSSM", counts, {"resample_systematic": T - 1,
                                              CDF: T - 1})
    lw = out["log_weights"]
    spread = float((lw.amax(dim=2) - lw.amin(dim=2)).max())
    exact = _lgssm_exact(obs)
    est = out["log_marginal_likelihood"].cpu().numpy()
    rel = np.abs(est - exact) / np.abs(exact)
    print(f"exact LGSSM twist: log-weight spread within a step, largest "
          f"{spread:.3e}; log-Z {np.round(est, 4)} against Kalman "
          f"{np.round(exact, 4)}, relative error max {rel.max():.3e} (bound "
          f"{TW_EXACT_REL_TOL})", flush=True)
    if not np.all(rel < TW_EXACT_REL_TOL):
        raise AssertionError(f"exact twist log-Z off Kalman: {rel}")
    noise = NoiseSource.seeded(111, dev)
    graph, log_z, exact_eager, exact_graph = _graph_equal(
        "twisted LGSSM call, exact twist", lambda: twisted.twisted_smc(
            obs, spec, emission, exact_twist, K, noise=noise,
            return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"], noise,
        eager_calls=2)
    z = _replayed(graph, log_z, TW_SEEDS)
    del graph
    print(f"exact twist over {TW_SEEDS} seeds: log-Z std a row, largest "
          f"{z.std(0).max():.3e}; ms a call eager {exact_eager:.3f}, graphed "
          f"{exact_graph:.3f}", flush=True)

    # Stochastic volatility: zero twist, learn_twist, the learned twist.
    mu, phi, sigma, beta = TW_SV
    sv = stochastic_volatility.make_model(mu, phi, sigma, beta, device=dev)
    _, sv_obs = statistics.sample_from_prior(*sv[:3], T, B,
                                             NoiseSource.seeded(112, dev))
    sv_spec = twisted.GaussianSSMSpec(
        mu, sigma / math.sqrt(1.0 - phi ** 2), sigma,
        mean_fn=lambda x, t: mu + phi * (x - mu))
    reset_counts()
    (learned, info), learn_ms = _timed(lambda: twisted.learn_twist(
        sv_obs, sv_spec, sv[2], TW_LEARN_K, noise=NoiseSource.seeded(113, dev),
        num_iterations=TW_LEARN_ITERATIONS))
    counts = read_counts("learn_twist sv")
    iteration_log_z = info["log_marginal_likelihood"].mean(1).cpu().numpy()
    _check_launches("learn_twist", counts,
                    {"resample_systematic": TW_LEARN_ITERATIONS * (T - 1),
                     CDF: TW_LEARN_ITERATIONS * (T - 1)})
    print(f"learn_twist, {TW_LEARN_ITERATIONS} ADP iterations at K = "
          f"{TW_LEARN_K:,}: {learn_ms:.0f} ms eager; per-iteration log-Z "
          f"(mean over rows) {np.round(iteration_log_z, 3)}; K1 "
          f"{counts['resample_systematic']} launches", flush=True)
    if not all(bool(torch.isfinite(v).all()) for v in
               (learned.A, learned.b, learned.c)):
        raise AssertionError("learn_twist gave a twist that is not finite")
    zero = twisted.QuadraticTwist.zeros(T, B, device=dev)
    spreads, times = {}, {}
    for label, tw, seed in (("zero", zero, 114), ("learned", learned, 116)):
        noise = NoiseSource.seeded(seed, dev)

        def call(tw=tw, noise=noise):
            return twisted.twisted_smc(
                sv_obs, sv_spec, sv[2], tw, K, noise=noise,
                return_latents=False,
                return_log_weight=False)["log_marginal_likelihood"]

        reset_counts()
        call()
        counts = read_counts(f"twisted sv ({label} twist)")
        _check_launches("twisted SV", counts,
                        {"resample_systematic": T - 1, CDF: T - 1})
        graph, log_z, eager_ms, graph_ms = _graph_equal(
            f"twisted SV call, {label} twist", call, noise, eager_calls=2)
        z = _replayed(graph, log_z, TW_SEEDS)
        del graph
        spreads[label] = float(z.std(0).mean())
        times[label] = (eager_ms, graph_ms)
    ratio = spreads["zero"] / spreads["learned"]
    print(f"SV over {TW_SEEDS} seeds: log-Z std (mean over rows) zero twist "
          f"{spreads['zero']:.4f}, learned {spreads['learned']:.4f}, ratio "
          f"{ratio:.2f}x; ms a call eager/graphed zero "
          f"{times['zero'][0]:.3f}/{times['zero'][1]:.3f}, learned "
          f"{times['learned'][0]:.3f}/{times['learned'][1]:.3f} = "
          f"{B * K * T / times['learned'][1] / 1e3:.1f} M particle-steps/s "
          f"graphed", flush=True)
    if not ratio > TW_SV_SPREAD_RATIO:
        raise AssertionError(f"the learned twist did not cut the SV log-Z "
                             f"spread: {spreads}")
    _phase_seconds("31", start)


@torch.no_grad()
def twisted_hmm_phase(dev):
    start = time.perf_counter()
    phase(f"32 discrete twisted SMC: the HMM (D = {HMM_STATES}) at ({T}, {B}, "
          f"{K:,}) with the exact tabular twist")
    hcomps, hobs = _hmm_data(dev, T, B, 0, num_states=HMM_STATES)
    initial, transition, emission, _ = hcomps
    spec = twisted.DiscreteSSMSpec(initial.logits, transition.logits)
    twist = twisted.exact_hmm_twist(hobs, initial.logits, transition.logits,
                                    emission.locs, emission.scale)
    reset_counts()
    out = twisted.twisted_smc(hobs, spec, emission, twist, K,
                              noise=NoiseSource.seeded(120, dev),
                              return_latents=False, return_log_weights=True)
    counts = read_counts("twisted hmm (exact twist)")
    _check_launches("twisted HMM", counts, {"resample_systematic": T - 1,
                                            "gather_sorted": T - 1,
                                            CDF: T - 1})
    lw = out["log_weights"]
    spread = float((lw.amax(dim=2) - lw.amin(dim=2)).max())
    exact = _hmm_exact(hcomps, hobs)
    est = out["log_marginal_likelihood"].cpu().numpy()
    rel = np.abs(est - exact) / np.abs(exact)
    print(f"exact HMM twist: K1 (indices only) {counts['resample_systematic']}"
          f" and K5 {counts['gather_sorted']} launches; log-weight spread "
          f"within a step, largest {spread:.3e}; log-Z {np.round(est, 4)} "
          f"against the forward recursion {np.round(exact, 4)}, relative "
          f"error max {rel.max():.3e} (bound {TW_EXACT_REL_TOL})", flush=True)
    if not np.all(rel < TW_EXACT_REL_TOL):
        raise AssertionError(f"exact HMM twist log-Z off: {rel}")
    noise = NoiseSource.seeded(121, dev)
    graph, _, tw_eager, tw_graph = _graph_equal(
        "twisted HMM call, exact twist", lambda: twisted.twisted_smc(
            hobs, spec, emission, twist, K, noise=noise,
            return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"], noise,
        eager_calls=2)
    del graph
    noise = NoiseSource.seeded(122, dev)
    graph, _, plain_eager, plain_graph = _graph_equal(
        "untwisted HMM filter (phase 9's) on the same observations",
        lambda: inference.infer(
            "smc", hobs, *hcomps, K, noise=noise,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"], noise,
        eager_calls=2)
    del graph
    print(f"HMM ms a call, eager/graphed: twisted {tw_eager:.3f}/"
          f"{tw_graph:.3f}, untwisted (fully adapted) {plain_eager:.3f}/"
          f"{plain_graph:.3f}", flush=True)
    _phase_seconds("32", start)


@torch.no_grad()
def deep_twist_phase(dev):
    start = time.perf_counter()
    phase(f"33 the deep twist: the bouncing ball at T = {TW_BB_T}, B = "
          f"{TW_BB_B}; one jittered ADP pass at K = {TW_BB_LEARN_K:,}, "
          f"keep='best' scored at K = {TW_BB_K} over {TW_BB_SCORE_SEEDS} "
          f"seeds, on tests/test_twisted.py's observations")
    bb = bouncing_ball.make_model(torch.Generator().manual_seed(0),
                                  num_pixels=BB_PIXELS, hidden=BB_HIDDEN,
                                  device=dev)
    obs = torch.tensor(np.load(TW_BB_OBS), device=dev)
    if tuple(obs.shape) != (TW_BB_T, TW_BB_B, BB_PIXELS):
        raise AssertionError(f"{TW_BB_OBS}: shape {tuple(obs.shape)}")
    spec = bouncing_ball.gaussian_spec(bb[1], bb[0])
    reset_counts()
    (learned, info), learn_ms = _timed(lambda: twisted.learn_twist(
        obs, spec, bb[2], TW_BB_LEARN_K, noise=NoiseSource.seeded(131, dev),
        num_iterations=1, fit_jitter=TW_BB_JITTER, keep="best",
        keep_num_particles=TW_BB_K, keep_num_seeds=TW_BB_SCORE_SEEDS))
    counts = read_counts("learn_twist bouncing ball")
    runs = 1 + 2 * TW_BB_SCORE_SEEDS
    _check_launches("learn_twist (bouncing ball)", counts,
                    {"resample_systematic": runs * (TW_BB_T - 1),
                     CDF: runs * (TW_BB_T - 1)})
    scores = info["scores"].cpu().numpy()
    selected = info["selected"].cpu().numpy()
    print(f"learn_twist: {learn_ms:.0f} ms eager; K1 "
          f"{counts['resample_systematic']} launches ({runs} runs of "
          f"{TW_BB_T - 1}); scores {np.round(scores, 1).tolist()}, selected "
          f"{selected.tolist()}", flush=True)
    zero = twisted.QuadraticTwist.zeros(TW_BB_T, TW_BB_B, dim=2, device=dev)
    z, times = {}, {}
    for label, tw, seed in (("zero", zero, 132), ("learned", learned, 133)):
        noise = NoiseSource.seeded(seed, dev)
        graph, log_z, eager_ms, graph_ms = _graph_equal(
            f"twisted bouncing-ball call at K = {TW_BB_K}, {label} twist",
            lambda tw=tw, noise=noise: twisted.twisted_smc(
                obs, spec, bb[2], tw, TW_BB_K, noise=noise,
                return_latents=False,
                return_log_weight=False)["log_marginal_likelihood"], noise,
            eager_calls=2)
        z[label] = _replayed(graph, log_z, TW_SEEDS)
        del graph
        times[label] = (eager_ms, graph_ms)
    mean0, mean1 = float(z["zero"].mean()), float(z["learned"].mean())
    sd0, sd1 = (float(z["zero"].std(0).mean()),
                float(z["learned"].std(0).mean()))
    print(f"bouncing ball over {TW_SEEDS} seeds at K = {TW_BB_K}: zero twist "
          f"log-Z mean {mean0:.1f}, std {sd0:.2f}; learned mean {mean1:.1f}, "
          f"std {sd1:.2f} (bars: mean > zero's + {TW_BB_MEAN_GAIN:.0f}, std "
          f"< {TW_BB_SPREAD_RATIO} x zero's, every row selects 1); ms a call "
          f"eager/graphed zero {times['zero'][0]:.3f}/{times['zero'][1]:.3f}"
          f", learned {times['learned'][0]:.3f}/{times['learned'][1]:.3f}",
          flush=True)
    if not (mean1 > mean0 + TW_BB_MEAN_GAIN and
            sd1 < TW_BB_SPREAD_RATIO * sd0 and np.all(selected == 1)):
        raise AssertionError(f"the deep twist missed the JAX test's bars: "
                             f"means {mean0} {mean1}, stds {sd0} {sd1}, "
                             f"selected {selected}")
    _phase_seconds("33", start)


class _LinearGaussian:
    """tests/test_enkf.py's linear model on the card: x_0 ~ N(0, I), x_t =
    A x_{t-1} + N(0, 0.7^2 I), y = x + N(0, 0.5^2 I)."""

    def __init__(self, dev):
        rng = np.random.default_rng(0)
        self.a_np = (0.9 * np.eye(ENKF_D) +
                     0.05 * rng.normal(size=(ENKF_D, ENKF_D)))
        self.a = torch.tensor(self.a_np, dtype=torch.float32, device=dev)
        self.dev = dev

    def initial(self):
        return distributions.MultivariateNormalDiag(
            torch.zeros(ENKF_D, device=self.dev),
            torch.ones(ENKF_D, device=self.dev))

    def transition(self, previous_latents=None, time=None,
                   previous_observations=None):
        x = previous_latents[-1]
        return distributions.MultivariateNormalDiag(
            x @ self.a.T, torch.full_like(x, 0.7),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    def simulate(self, seed):
        rng = np.random.RandomState(seed)
        x = rng.randn(ENKF_B, ENKF_D)
        ys = []
        for _ in range(ENKF_T):
            ys.append(x + 0.5 * rng.randn(ENKF_B, ENKF_D))
            x = x @ self.a_np.T + 0.7 * rng.randn(ENKF_B, ENKF_D)
        return torch.tensor(np.asarray(ys), dtype=torch.float32,
                            device=self.dev)


@torch.no_grad()
def enkf_phase(dev):
    start = time.perf_counter()
    phase(f"34 EnKF: the linear oracle (T, B, N, D) = ({ENKF_T}, {ENKF_B}, "
          f"{ENKF_N:,}, {ENKF_D}); Lorenz-96 D = {ENKF_L96_D} at (T, B) = "
          f"({ENKF_L96_T}, {ENKF_L96_B}), N = {ENKF_L96_N}")
    model = _LinearGaussian(dev)
    obs = model.simulate(140)
    params = kalman_nd.KalmanNdParams(
        initial_mean=np.zeros(ENKF_D), initial_cov=np.eye(ENKF_D),
        transition_matrix=model.a_np, transition_cov=0.49 * np.eye(ENKF_D),
        emission_matrix=np.eye(ENKF_D), emission_cov=0.25 * np.eye(ENKF_D))
    obs_np = obs.cpu().numpy().astype(np.float64)
    for method in ("stochastic", "etkf"):
        reset_counts()
        out = enkf.enkf_filter(obs, model.initial, model.transition,
                               lambda x: x, 0.25, ENKF_N,
                               noise=NoiseSource.seeded(141, dev),
                               method=method)
        counts = read_counts(f"enkf {method} (linear)")
        _check_launches("EnKF", counts, {})
        worst = [0.0, 0.0, 0.0]
        for b in range(ENKF_B):
            m_exact, p_exact, _, _, ll_exact = kalman_nd.kalman_filter_nd(
                obs_np[:, b], params)
            m = out["filtered_means"][:, b].cpu().numpy()
            v = out["filtered_variances"][:, b].cpu().numpy()
            v_exact = np.stack([np.diag(p) for p in p_exact])
            ll = float(out["log_likelihood"][b])
            rmse = float(np.sqrt(np.mean((m - m_exact) ** 2)))
            worst = [max(worst[0], rmse),
                     max(worst[1], float(np.abs(v - v_exact).max())),
                     max(worst[2], abs(ll - ll_exact) / abs(ll_exact))]
        print(f"EnKF {method} against the Kalman filter: mean RMSE "
              f"{worst[0]:.4f} (bound {ENKF_RMSE_TOL}), variance error "
              f"{worst[1]:.4f} (bound {ENKF_VAR_TOL}), log-likelihood "
              f"relative error {worst[2]:.4f} (bound {ENKF_LL_REL_TOL})",
              flush=True)
        if not (worst[0] < ENKF_RMSE_TOL and worst[1] < ENKF_VAR_TOL and
                worst[2] < ENKF_LL_REL_TOL):
            raise AssertionError(f"EnKF {method} missed the Kalman bars: "
                                 f"{worst}")

    # Lorenz-96 at D = 64, every component observed at r = 0.5.
    l96 = lorenz.make_model(dim=ENKF_L96_D, emission_scale=0.5,
                            proposal="bootstrap", device=dev)
    lat, l96_obs = statistics.sample_from_prior(
        *l96[:3], ENKF_L96_T, ENKF_L96_B, NoiseSource.seeded(142, dev))
    truth = lat[ENKF_L96_T // 2:]
    loc = tuple(m.to(dev, torch.float32) for m in
                enkf.gaspari_cohn_localization(ENKF_L96_D,
                                               radius=ENKF_RADIUS))
    for method, localization in (("stochastic", loc), ("etkf", None)):
        noise = NoiseSource.seeded(143, dev)

        def call(method=method, localization=localization, noise=noise):
            return enkf.enkf_filter(
                l96_obs, l96[0], l96[1], lambda x: x, 0.25, ENKF_L96_N,
                noise=noise, method=method, inflation=ENKF_INFLATION,
                localization=localization)["filtered_means"]

        reset_counts()
        means = call()
        _check_launches("EnKF", read_counts(f"enkf {method} lorenz"), {})
        rmse = float(torch.sqrt(torch.mean(
            (means[ENKF_L96_T // 2:] - truth) ** 2)))
        if method == "stochastic":
            graph, _, eager_ms, graph_ms = _graph_equal(
                f"EnKF {method} call, Lorenz-96 D = {ENKF_L96_D}", call,
                noise, eager_calls=2)
            del graph
            timing = f"eager {eager_ms:.3f} ms, graphed {graph_ms:.3f} ms"
        else:
            # torch.linalg.eigh fails inside a CUDA graph capture.
            eager_ms = float(np.median([_timed(call)[1] for _ in range(3)]))
            timing = f"eager {eager_ms:.3f} ms (eigh: eager only)"
        print(f"EnKF {method} on Lorenz-96 D = {ENKF_L96_D}, N = "
              f"{ENKF_L96_N}, inflation {ENKF_INFLATION}"
              f"{', Gaspari-Cohn radius 2' if localization else ''}: RMSE "
              f"against the truth over the second half {rmse:.4f}; {timing} "
              f"a call", flush=True)
        if not rmse < ENKF_L96_RMSE_TOL:
            raise AssertionError(f"EnKF {method} on Lorenz-96: RMSE {rmse}")
    _phase_seconds("34", start)


# Phase 35 (slice E1): the multi-device layer. (a) A NCCL world of
# torch.cuda.device_count() ranks, one card each, on a (ranks, 1) mesh:
# the batch is sharded and every particle cloud whole on one rank, so the
# arithmetic is the single-device run's and the checks are bit for bit.
# (b) MD_GLOO_RANKS gloo ranks with every tensor on cuda:0 (NCCL refuses two
# ranks on one card), on (data, particle) meshes that shard the particle
# axis. gloo takes CUDA tensors in its all-gather, all-reduce and
# reduce-scatter but aborts the process on send/recv (torch 2.11), so
# the ring exchange runs in (a) only. (c) K2-K4 at the distributed
# shapes, in this process.
MD_GLOO_RANKS = 4
MD_GLOO_MESHES = ((2, 2), (1, 4))
MD_TRAIN_STEPS = 5
MD_SOFT_K = 1000
# The soft step on gloo runs T = 50 of the bench's 200 steps: a gloo
# collective on CUDA tensors stages through host memory and loopback TCP,
# and a sharded soft step makes ~8 a time step, forward and backward.
MD_SOFT_GLOO_T = 50
# With the particle axis sharded, each CDF entry is a shard prefix plus a
# local scan, summed in another order than the single-device scan: the
# two CDFs differ by float rounding (~1e-6 at K = 10,000), far below the
# bins' width (~1e-4 under the exact proposal's near-even weights), so on
# the first resampling step (same particles, same weights) an ancestor
# may move to a neighbouring particle, never further.
MD_FIRST_STEP_MAX_SHIFT = 1
# The JAX island test's bootstrap LGSSM and its bar on the mean of Z-hat
# / Z over replicates (tests/test_islands.py:24-45, 144-162).
# The 16 seeds are 16 blocks of the 4 rows in one call (every row draws
# its own noise), one call's collectives for 64 replicates.
MD_ISLANDS, MD_ISLAND_K = 4, 2048
MD_ISLAND_T, MD_ISLAND_B, MD_ISLAND_SEEDS = 100, 4, 16
MD_ISLAND_A, MD_ISLAND_R = 0.9, 2.0
MD_ISLAND_BAND = (0.85, 1.15)
# K2-K4 with Kc = K against one rank's positions for n = 4 and 2 ranks
# (Kp = K / n), and K3 on the ring's visiting slice (B, K / 4) (D = 3:
# soft resampling's particle and two weight columns).
MD_KP = (2500, 5000)
MD_D = 3


def _md_worker(rank, world, port, backend, task, out_dir):
    """One rank of a phase-35 world: runs ``task`` (a function of this
    module) on its card and saves what it returns."""
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, **({"device_id": dev} if backend == "nccl" else
                             {}))
    try:
        # A mesh's exchange builds its CDF with the plain CDF's arithmetic
        # (`dist_resampling`), which the CDF kernel sums in another order:
        # the mesh is held bit for bit against the single-device 'cuda'
        # route with the plain CDF, not with the CDF kernel.
        with _plain_cdf():
            result = globals()[task](dev)
        torch.save(result, pathlib.Path(out_dir) / f"{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _md_world(world, backend, task):
    """Runs ``task`` on ``world`` spawned ranks of ``backend``; a rank that
    fails fails the script. Returns the ranks' results and adds their
    kernel launches to `LAUNCHES`."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_md_worker,
                           args=(world, port, backend, task, out_dir),
                           nprocs=world, start_method="spawn", join=True)
        results = [torch.load(pathlib.Path(out_dir) / f"{r}.pt",
                              weights_only=False) for r in range(world)]
    for result in results:
        for path, counts in result["launches"].items():
            for name, n in counts.items():
                if n:
                    LAUNCHES[name][path] = LAUNCHES[name].get(path, 0) + n
    _phase_seconds(f"35 {task}, {world} {backend} ranks", start)
    return results


def _md_print(*args):
    if torch.distributed.get_rank() == 0:
        print(*args, flush=True)


def _md_counts(launches, path):
    """This rank's launches since `reset_counts`, kept under ``path``."""
    torch.cuda.synchronize()
    counts = {name: getattr(module, counter)
              for name, (module, counter, _, _) in KERNELS.items()}
    launches[path] = counts
    _md_print(f"launches on {path} (rank 0): {counts}")
    return counts


def _md_expect(counts, path, **want):
    got = {name: counts[name] for name in KERNELS}
    expected = {name: want.get(name, 0) for name in KERNELS}
    if got != expected:
        raise AssertionError(f"{path}: launched {got}, not {expected}")


def _md_param_rel(a, b):
    """The largest relative difference between two models' parameters."""
    with torch.no_grad():
        return max(float(((p - q).abs() / q.abs().clamp(min=1e-30)).max())
                   for p, q in zip(train.get_chained_params(*a),
                                   train.get_chained_params(*b)))


def _md_median_ms(fn, calls=2):
    times = _cuda_ms(fn, warmup=1, repeat=calls, each=True)
    return float(np.median(times)), [round(t, 3) for t in times]


def _md_collective_ms(dev, mesh, label):
    """Host-clock ms a collective over the particle group: an all-reduce of
    B scalars and an all-gather of a [B, K / n] block (20 each)."""
    from aesmc_tpu_torch.parallel import collectives

    group = mesh.get_group("particle")
    n = collectives.size(group)
    small = torch.ones(B, device=dev)
    block = torch.ones(B, K // n, device=dev)
    out = {}
    for name, fn in (("all-reduce", lambda: collectives.all_reduce(
            small, group)), ("all-gather", lambda: collectives.all_gather(
                block, group, dim=1))):
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - start) / 20 * 1e3
    _md_print(f"{label}: {out['all-reduce']:.3f} ms an all-reduce of {B} "
              f"floats, {out['all-gather']:.3f} ms an all-gather of [{B}, "
              f"{K // n}] over {n} rank(s) (host clock, rank 0)")
    return out


def _md_filter_kwargs():
    return dict(return_log_marginal_likelihood=True, return_latents=False,
                return_ancestral_indices=True)


def _md_nccl_task(dev):
    """(a): the filter and the train step on a (ranks, 1) NCCL mesh, each
    against the single-device call bit for bit."""
    from aesmc_tpu_torch import parallel

    world = torch.distributed.get_world_size()
    batch = -(-B // world) * world
    mesh = parallel.make_mesh(world, 1)
    rows = parallel.data_particle_specs(mesh, batch, K)[0]
    launches, times = {}, {}
    times["35a NCCL collectives"] = _md_collective_ms(dev, mesh,
                                                      "35a NCCL")
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT, batch)
    obs_b = parallel.shard_batch(obs, mesh)
    with torch.no_grad():
        want = inference.infer("smc", obs, *comps, K,
                               noise=NoiseSource.seeded(35, dev),
                               **_md_filter_kwargs())
    routes = {"default": "auto"}
    for exchange in ("allgather", "ring"):
        routes[exchange] = parallel.make_distributed_fused_resampler(
            mesh, exchange=exchange)
    for label, impl in routes.items():
        def call(impl=impl):
            return inference.infer(
                "smc", obs_b, *comps, K, noise=NoiseSource.seeded(35, dev),
                resampling_implementation=impl, mesh=mesh,
                **_md_filter_kwargs())

        path = f"35a NCCL filter, {label} exchange"
        with torch.no_grad():
            reset_counts()
            got = call()
            _md_expect(_md_counts(launches, path), path,
                       resample_sorted=T - 1)
            if not (torch.equal(got["ancestral_indices"],
                                want["ancestral_indices"][:, rows]) and
                    torch.equal(got["log_marginal_likelihood"],
                                want["log_marginal_likelihood"][rows])):
                raise AssertionError(f"{path}: ancestors or log-Z differ "
                                     f"from the single-device call")
            times[path] = _md_median_ms(call)
        _md_print(f"{path}: ancestors and log-Z equal to the single-device "
                  f"call bit for bit; {times[path][0]:.3f} ms/call (runs "
                  f"{times[path][1]})")

    # The HMM's int32 particles ride the exchange apart from the CDF: K4
    # finds the indices on the gathered CDF and K5 gathers the particles.
    hmm_comps, hmm_obs = _hmm_data(dev, T, batch, 0, num_states=HMM_STATES)
    path = f"35a NCCL HMM filter (D = {HMM_STATES}, int32 particles)"

    def hmm_call(mesh_=None):
        return inference.infer(
            "smc", hmm_obs if mesh_ is None else
            parallel.shard_batch(hmm_obs, mesh_), *hmm_comps, K,
            noise=NoiseSource.seeded(36, dev), mesh=mesh_,
            **_md_filter_kwargs())

    with torch.no_grad():
        want = hmm_call()
        reset_counts()
        got = hmm_call(mesh)
        _md_expect(_md_counts(launches, path), path,
                   searchsorted_sorted=T - 1, gather_sorted=T - 1)
        if not (torch.equal(got["ancestral_indices"],
                            want["ancestral_indices"][:, rows]) and
                torch.equal(got["log_marginal_likelihood"],
                            want["log_marginal_likelihood"][rows])):
            raise AssertionError(f"{path}: ancestors or log-Z differ from "
                                 f"the single-device call")
        times[path] = _md_median_ms(lambda: hmm_call(mesh), calls=1)
    _md_print(f"{path}: ancestors and log-Z equal to the single-device call "
              f"bit for bit; {times[path][0]:.3f} ms/call")

    # Sharded AESMC train steps against train.make_train_step.
    (comps_m, obs_t), (comps_1, _) = (_bench_lgssm(dev, 0.5, batch),
                                      _bench_lgssm(dev, 0.5, batch))
    opt_m = torch.optim.Adam(train.get_chained_params(*comps_m), lr=1e-2)
    opt_1 = torch.optim.Adam(train.get_chained_params(*comps_1), lr=1e-2)
    sharded = parallel.make_sharded_train_step(TRAIN_K, "aesmc", opt_m, mesh)
    single = train.make_train_step(TRAIN_K, "aesmc", opt_1)
    obs_tb = parallel.shard_batch(obs_t, mesh)
    path = f"35a NCCL sharded train step K={TRAIN_K}"
    for i in range(MD_TRAIN_STEPS):
        reset_counts()
        loss_m = sharded(comps_m, obs_tb, NoiseSource.seeded(350 + i, dev))
        if i == 0:
            _md_expect(_md_counts(launches, path), path,
                       resample_sorted=T - 1, range_sum=T - 1)
        loss_1 = single(comps_1, obs_t, NoiseSource.seeded(350 + i, dev))
        same = (torch.equal(loss_m, loss_1) if world == 1 else
                torch.allclose(loss_m, loss_1, rtol=1e-6, atol=0))
        if not same:
            raise AssertionError(f"{path}: step {i} loss {float(loss_m)} "
                                 f"vs {float(loss_1)}")
    worst = _md_param_rel(comps_m, comps_1)
    if worst > GRAD_RTOL:
        raise AssertionError(f"{path}: parameters after {MD_TRAIN_STEPS} "
                             f"steps off by {worst} relative")
    noise = NoiseSource.seeded(360, dev)
    times[path] = _md_median_ms(lambda: sharded(comps_m, obs_tb, noise))
    _md_print(f"{path}: {MD_TRAIN_STEPS} steps, every loss equal to "
              f"train.make_train_step's, parameters within {worst:.3g} "
              f"relative (bound {GRAD_RTOL}); {times[path][0]:.3f} ms/step "
              f"(runs {times[path][1]})")
    e2_seconds = _e2_nccl_task(dev, mesh, launches, times)
    e3_seconds = _e3_nccl_task(dev, mesh, launches, times)
    return {"launches": launches, "times": times, "e2_seconds": e2_seconds,
            "e3_seconds": e3_seconds}


@contextlib.contextmanager
def _md_plain_route():
    """Every resampling of the block on the plain PyTorch route (the
    kernels' plain versions), for the kernel-against-plain checks."""
    original = resampling._route
    resampling._route = lambda device, implementation: "torch"
    try:
        yield
    finally:
        resampling._route = original


def _md_resampler_checks(dev, mesh, dp, pp, launches):
    """The distributed resamplers on this rank's block of [B, K] weights:
    the kernels (K3, K4, K2 in the backward) against their plain versions
    on the same inputs, bit for bit (the gradient within
    RANGE_SUM_REL_TOL)."""
    from aesmc_tpu_torch import parallel
    from aesmc_tpu_torch.sharding_utils import local_block

    generator = torch.Generator(device=dev).manual_seed(36)
    lw = local_block(torch.randn(B, K, generator=generator, device=dev) * 3,
                     mesh, {0: "data", 1: "particle"})
    value = local_block(torch.randn(B, K, 2, generator=generator,
                                    device=dev), mesh,
                        {0: "data", 1: "particle"})
    for method in ("systematic", "multinomial", "soft"):
        resampler = parallel.make_distributed_fused_resampler(
            mesh, method=method)
        outs = []
        for plain in (False, True):
            x = lw.clone().requires_grad_(method == "soft")
            v = value.clone().requires_grad_(True)
            with (_md_plain_route() if plain else contextlib.nullcontext()):
                out = resampler(x, NoiseSource.seeded(37, dev), v)
                loss = out[-1].sum() + (out[1].sum() if method == "soft"
                                        else 0.0)
                loss.backward()
            outs.append((out, x.grad, v.grad))
        (kernel, kx, kv), (plain, px, pv) = outs
        if not all(torch.equal(a, b) for a, b in zip(kernel, plain)):
            raise AssertionError(f"{dp}x{pp} {method}: the kernels' "
                                 f"exchange differs from the plain one")
        for a, b in ((kv, pv),) + (((kx, px),) if method == "soft" else ()):
            if not torch.allclose(a, b, rtol=0, atol=RANGE_SUM_REL_TOL *
                                  float(b.abs().max())):
                raise AssertionError(f"{dp}x{pp} {method}: the gradient "
                                     f"through K2 differs from the plain "
                                     f"one")
    indices = parallel.make_distributed_resampler(mesh, method="stratified")
    reset_counts()
    got = indices(lw, NoiseSource.seeded(38, dev))
    _md_expect(_md_counts(launches, f"35b gloo {dp}x{pp} index-only "
                          f"resampler"), "index-only",
               searchsorted_sorted=1)
    with _md_plain_route():
        plain = indices(lw, NoiseSource.seeded(38, dev))
    if not torch.equal(got, plain):
        raise AssertionError(f"{dp}x{pp}: K4 differs inside the resampler")
    _md_print(f"gloo {dp}x{pp}: the all-gather exchange (systematic, "
              f"multinomial, soft) and the index-only resampler equal their "
              f"plain versions bit for bit; gradients through K2 within "
              f"{RANGE_SUM_REL_TOL} of the plain backward's")


def _md_island_model(dev):
    model = (lgssm.Initial(0.0, 1.0),
             lgssm.Transition(MD_ISLAND_A, 1.0),
             lgssm.Emission(1.0, MD_ISLAND_R),
             lgssm.Proposal(0.0, 0.0, [MD_ISLAND_A, 0.0], 0.0, 1.0, 1.0))
    return tuple(m.to(dev) for m in model)


def _md_island_data(dev):
    """Observations from the model (as `tests/test_islands.py` makes them)
    and each row's exact log-Z."""
    rng = np.random.default_rng(4)
    x = rng.normal(0.0, 1.0, size=MD_ISLAND_B)
    ys = []
    for t in range(MD_ISLAND_T):
        if t:
            x = MD_ISLAND_A * x + rng.normal(0.0, 1.0, size=MD_ISLAND_B)
        ys.append(x + rng.normal(0.0, MD_ISLAND_R, size=MD_ISLAND_B))
    obs = np.stack(ys).astype(np.float32)
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=MD_ISLAND_A, transition_offset=0.0,
        transition_variance=1.0, emission_mult=1.0, emission_offset=0.0,
        emission_variance=MD_ISLAND_R ** 2)
    exact = np.array([kalman.kalman_filter(obs[:, b], params)[4]
                      for b in range(MD_ISLAND_B)])
    return torch.tensor(obs, device=dev), exact


def _md_gloo_task(dev):
    """(b): the filter, the resamplers, the soft train step and island SMC
    on gloo ranks sharing one card."""
    from aesmc_tpu_torch import parallel

    launches, times = {}, {}
    comps, obs = _optimal_lgssm(dev)
    exact = _lgssm_exact(obs)
    with torch.no_grad():
        want = inference.infer("smc", obs, *comps, K,
                               noise=NoiseSource.seeded(35, dev),
                               **_md_filter_kwargs())
    meshes = {}
    for dp, pp in MD_GLOO_MESHES:
        mesh = meshes[(dp, pp)] = parallel.make_mesh(dp, pp, backend="gloo")
        times[f"35b gloo {dp}x{pp} collectives"] = _md_collective_ms(
            dev, mesh, f"35b gloo {dp}x{pp}")
        rows, parts = parallel.data_particle_specs(mesh, B, K)
        path = f"35b gloo filter {dp}x{pp}, all-gather exchange"

        def call(mesh=mesh):
            return inference.infer(
                "smc", parallel.shard_batch(obs, mesh), *comps, K,
                noise=NoiseSource.seeded(35, dev), mesh=mesh,
                **_md_filter_kwargs())

        with torch.no_grad():
            reset_counts()
            got, ms = _timed(call)
            _md_expect(_md_counts(launches, path), path,
                       resample_sorted=T - 1)
            times[path] = (ms, [round(ms, 3)])
        log_z = got["log_marginal_likelihood"]
        if not bool(torch.isfinite(log_z).all()):
            raise AssertionError(f"{path}: log-Z {log_z}")
        _check_log_z(f"{path} (rank {torch.distributed.get_rank()})",
                     log_z, exact[rows])
        shift = (got["ancestral_indices"][0].long() -
                 want["ancestral_indices"][0][rows, parts].long()).abs()
        first = float((shift == 0).float().mean())
        if int(shift.max()) > MD_FIRST_STEP_MAX_SHIFT:
            raise AssertionError(f"{path}: a first-step ancestor moved "
                                 f"{int(shift.max())} particles from the "
                                 f"single-device call's")
        delta = float((log_z - want["log_marginal_likelihood"][rows]).abs()
                      .max())
        print(f"{path} (rank {torch.distributed.get_rank()}): log-Z finite, "
              f"within the Kalman bound; first step's ancestors equal to the "
              f"single-device call's on {first:.6f} of its slots, the others "
              f"one particle over (bound {MD_FIRST_STEP_MAX_SHIFT}); |log-Z "
              f"- single device| <= {delta:.4g}; {times[path][0]:.3f} "
              f"ms/call", flush=True)
        _md_resampler_checks(dev, mesh, dp, pp, launches)

    # Soft (alpha 0.5) sharded train step on the (2, 2) mesh: the kernels'
    # gradients against the plain route's on the same noise.
    mesh = meshes[MD_GLOO_MESHES[0]]
    path = (f"35b gloo soft train step 2x2 (T, B, K) = ({MD_SOFT_GLOO_T}, "
            f"{B}, {MD_SOFT_K})")

    def soft_model():
        comps_s, obs_s = _bench_lgssm(dev, 0.5)
        return comps_s, obs_s[:MD_SOFT_GLOO_T]

    grads, losses_ = {}, {}
    for plain in (False, True):
        comps_s, obs_s = soft_model()
        params = train.get_chained_params(*comps_s)
        step = parallel.make_sharded_train_step(
            MD_SOFT_K, "aesmc", torch.optim.SGD(params, lr=0.0), mesh,
            resampling_method="soft")
        reset_counts()
        with (_md_plain_route() if plain else contextlib.nullcontext()):
            losses_[plain] = step(comps_s, parallel.shard_batch(obs_s, mesh),
                                  NoiseSource.seeded(39, dev))
        if not plain:
            _md_expect(_md_counts(launches, path), path,
                       resample_sorted=MD_SOFT_GLOO_T - 1,
                       range_sum=MD_SOFT_GLOO_T - 1)
        grads[plain] = [p.grad.clone() for p in params]
    if not torch.equal(losses_[False], losses_[True]):
        raise AssertionError(f"{path}: the loss differs between routes")
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads[False], grads[True]))
    if worst > GRAD_RTOL:
        raise AssertionError(f"{path}: gradients off the plain route's by "
                             f"{worst}")
    comps_1, obs_1 = soft_model()
    single = train.make_train_step(
        MD_SOFT_K, "aesmc", torch.optim.SGD(train.get_chained_params(
            *comps_1), lr=0.0), resampling_method="soft")
    loss_1 = single(comps_1, obs_1, NoiseSource.seeded(39, dev))
    rel = float((losses_[False] - loss_1).abs() / loss_1.abs())
    if rel > LOG_Z_REL_TOL:
        raise AssertionError(f"{path}: loss {float(losses_[False])} vs the "
                             f"single-device step's {float(loss_1)}")
    step = parallel.make_sharded_train_step(
        MD_SOFT_K, "aesmc", torch.optim.SGD(train.get_chained_params(
            *comps_s), lr=0.0), mesh, resampling_method="soft")
    noise = NoiseSource.seeded(40, dev)
    times[path] = _md_median_ms(lambda: step(
        comps_s, parallel.shard_batch(obs_s, mesh), noise), calls=1)
    _md_print(f"{path}: loss equal on the kernel and plain routes, "
              f"gradients within {worst:.3g} relative (bound {GRAD_RTOL}); "
              f"loss {float(losses_[False]):.4f} vs the single-device "
              f"step's {float(loss_1):.4f} ({rel:.3g} relative, bound "
              f"{LOG_Z_REL_TOL}); {times[path][0]:.3f} ms/step (runs "
              f"{times[path][1]})")

    # Island SMC: one island of MD_ISLAND_K particles a rank.
    island_mesh = parallel.make_island_mesh(MD_GLOO_RANKS, backend="gloo")
    model = _md_island_model(dev)
    obs_i, exact_i = _md_island_data(dev)
    path = f"35b islands {MD_ISLANDS} x {MD_ISLAND_K}"

    replicated = obs_i.repeat(1, MD_ISLAND_SEEDS)

    def islands(seed, mesh=island_mesh):
        return parallel.island_infer(
            replicated, *model, num_particles=MD_ISLAND_K,
            num_islands=MD_ISLANDS, noise=NoiseSource.seeded(seed, dev),
            island_resampling_criterion=0.5, mesh=mesh)

    with torch.no_grad():
        reset_counts()
        out, ms = _timed(lambda: islands(0))
        _md_expect(_md_counts(launches, path), path,
                   resample_systematic=2 * (MD_ISLAND_T - 1))
        times[path] = (ms, [round(ms, 3)])
        single = islands(0, mesh=None)
    # The mesh's rows and the single device's (all islands as [N B, K]
    # rows of one filter) reduce their logsumexps over rows of other
    # counts, whose float sums may differ in the last bit; the runs then
    # part, so each is held to the bar on its own (on the CPU the two are
    # equal bit for bit, tests/test_torch_islands.py).
    ratios = {}
    for label, log_z in (("mesh", out["log_marginal_likelihood"]),
                         ("single device",
                          single["log_marginal_likelihood"])):
        lml = log_z.double().cpu().numpy()
        if not np.isfinite(lml).all():
            raise AssertionError(f"{path}, {label}: log-Z not finite")
        ratios[label] = float(np.exp(
            lml - np.tile(exact_i, MD_ISLAND_SEEDS)).mean())
        if not MD_ISLAND_BAND[0] < ratios[label] < MD_ISLAND_BAND[1]:
            raise AssertionError(f"{path}, {label}: mean Z-hat / Z "
                                 f"{ratios[label]} outside {MD_ISLAND_BAND}")
    delta = float((out["log_marginal_likelihood"] -
                   single["log_marginal_likelihood"]).abs().max())
    _md_print(f"{path}, criterion 0.5, (T, B) = ({MD_ISLAND_T}, "
              f"{MD_ISLAND_B}) x {MD_ISLAND_SEEDS} replicate blocks of rows: "
              f"mean Z-hat / Z over the {MD_ISLAND_SEEDS * MD_ISLAND_B} rows "
              f"{ratios['mesh']:.4f} on the mesh, "
              f"{ratios['single device']:.4f} on one device (band "
              f"{MD_ISLAND_BAND}); |log-Z mesh - one device| <= "
              f"{delta:.4g}; {times[path][0]:.3f} ms/call")
    e2_seconds = _e2_gloo_task(dev, meshes, launches, times)
    e3_seconds = _e3_gloo_task(dev, meshes, launches, times)
    return {"launches": launches, "times": times, "e2_seconds": e2_seconds,
            "e3_seconds": e3_seconds}


def _md_kernel_phase(dev):
    """(c): K4, K3 and K2 at the shapes of the distributed exchanges, bit
    for bit against their plain versions (K2 on integer cotangents), and
    timed."""
    generator = torch.Generator(device=dev).manual_seed(35)
    lw = torch.randn(B, K, generator=generator, device=dev) * 3.0
    cdf = resampling._normalized_cumsum(lw)
    u = torch.rand(B, 1, generator=generator, device=dev)
    value = torch.randn(B, K, MD_D, generator=generator, device=dev)
    f = 4
    for kp in MD_KP:
        # The last rank's slots [K - Kp, K) of the systematic grid.
        grid = resample_cuda.systematic_positions(u, K)[:, K - kp:]
        pos = grid.contiguous()
        g = torch.randint(-5, 6, (B, kp, MD_D), generator=generator,
                          device=dev).float()
        checks = {
            "K4": (searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos),
                   searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf,
                                                                      pos)),
            "K3": (resample_sorted_cuda.resample_and_gather_sorted(
                cdf, pos, value),
                resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, value)),
            "K2": (range_sum_cuda.range_sum(cdf, pos, g),
                   range_sum_cuda.range_sum_torch(cdf, pos, g)),
        }
        for label, (got, want) in checks.items():
            if not all(torch.equal(a, b) for a, b in zip(_as_tuple(got),
                                                         _as_tuple(want))):
                raise AssertionError(f"{label} differs from its plain "
                                     f"version at Kc = {K}, Kp = {kp}")
        print(f"K4, K3 and K2 at (B, Kc, Kp, D) = ({B}, {K}, {kp}, {MD_D}): "
              f"exact (tolerance 0; K2 on integer cotangents)", flush=True)
        n_p, steps = B * kp, _search_steps(K)
        ancestors = torch.searchsorted(cdf, pos, right=True).clamp_(
            max=K - 1).unsqueeze(-1).expand(B, kp, MD_D)
        _kernel_row("searchsorted_sorted", (B, K, kp),
                    lambda: searchsorted_sorted_cuda.searchsorted_sorted(
                        cdf, pos),
                    lambda: searchsorted_sorted_cuda.searchsorted_sorted_torch(
                        cdf, pos),
                    lambda: torch.searchsorted(cdf, pos, right=True),
                    f * (B * K + 2 * n_p), n_p * steps,
                    "torch.searchsorted")
        _kernel_row("resample_sorted", (B, K, kp, MD_D),
                    lambda: resample_sorted_cuda.resample_and_gather_sorted(
                        cdf, pos, value),
                    lambda: (resample_sorted_cuda
                             .resample_and_gather_sorted_torch(cdf, pos,
                                                               value)),
                    None, f * (B * K * (1 + MD_D) + n_p * (2 + MD_D)),
                    n_p * steps)
        _kernel_row("range_sum", (B, K, kp, MD_D),
                    lambda: range_sum_cuda.range_sum(cdf, pos, g),
                    lambda: range_sum_cuda.range_sum_torch(cdf, pos, g),
                    lambda: torch.zeros((B, K, MD_D), device=dev)
                    .scatter_add_(1, ancestors, g),
                    f * (B * K * (1 + MD_D) + n_p * (1 + MD_D)),
                    n_p * steps + n_p * MD_D,
                    "scatter_add_ over the given ancestors (non-"
                    "deterministic)")
    # The ring: rank 0's positions against the visiting slice of rank 1.
    kl = K // MD_GLOO_RANKS
    cdf_slice = cdf[:, kl:2 * kl].contiguous()
    value_slice = value[:, kl:2 * kl].contiguous()
    pos = resample_cuda.systematic_positions(u, K)[:, :kl].contiguous()
    got = resample_sorted_cuda.resample_and_gather_sorted(cdf_slice, pos,
                                                          value_slice)
    want = resample_sorted_cuda.resample_and_gather_sorted_torch(
        cdf_slice, pos, value_slice)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("K3 differs from its plain version on a ring "
                             "slice")
    print(f"K3 on a ring slice (B, Kc, Kp, D) = ({B}, {kl}, {kl}, {MD_D}): "
          f"exact (tolerance 0)", flush=True)
    n_p = B * kl
    _kernel_row("resample_sorted", (B, kl, kl, MD_D),
                lambda: resample_sorted_cuda.resample_and_gather_sorted(
                    cdf_slice, pos, value_slice),
                lambda: resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf_slice, pos, value_slice),
                None, f * (n_p * (1 + MD_D) * 2 + n_p),
                n_p * _search_steps(kl))


# Phase 36 (slice E2): every E2 path on a mesh, inside phase 35's two
# worlds (no world of its own). (a) The NCCL world's (ranks, 1) mesh at
# the width of each path's single-device phase, T cut (E2_*_T): the batch
# is sharded and every particle cloud whole on one rank, so each path
# equals the single-device call bit for bit, but OT's ring-streamed
# Sinkhorn (another order of sums: the JAX test's 1e-4). (b) The gloo
# ranks on cuda:0 on (2, 2) and (1, 4) at small width (E2G_*), each path
# within its JAX test's bar of the single-device call: here the particle
# axis is sharded, the twists', IF2's and SMC^2's per-row parameters cut
# by the data axis, and the ring (PaRIS's exchange on (1, 4), the
# distributed OT) moves device tensors through gloo's host-staged form.
E2_T, E2_PARIS_T, E2_S2_T, E2_OT_T = 50, 20, 10, 5
E2_FFBS_M, E2_PARIS_K, E2_RBPF_K = FFBS_M, PARIS_K, 4096
E2_S2_M, E2_S2_K, E2_OT_B, E2_OT_K = 128, 256, 4, 4096
E2_RM_K, E2_BPF_D, E2_BPF_B, E2_BPF_K = 4096, 16, 4, 1024
E2_SAMPLER_K, E2_IF2_B, E2_IF2_K, E2_IF2_ITERATIONS = 16384, 4, 4096, 2
E2G_T, E2G_B, E2G_K, E2G_M, E2G_THETA = 6, 4, 32, 8, 8
# The JAX tests' bars against one device (tests/test_parallel.py,
# tests/test_online.py, tests/test_samplers.py): (rtol, atol).
E2_BARS = {"ffbs": (0.0, 1e-5), "paris": (0.0, 1e-4), "online": (2e-5, 1e-4),
           "rbpf": (1e-4, 1e-4), "rbpf_means": (0.0, 1e-3),
           "smc2": (0.0, 1e-4), "twisted": (0.0, 1e-4), "ot": (1e-5, 1e-4),
           "sampler": (1e-4, 1e-4), "sampler_means": (0.0, 1e-3),
           "rm": (1e-5, 1e-4), "bpf": (1e-5, 1e-4), "if2": (1e-5, 1e-4)}


def _e2_optimal(dev, batch, num_timesteps):
    """The bench's LGSSM with its exact proposal, ``batch`` rows of T."""
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT, batch)
    optimal = lgssm.optimal_proposal(
        0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE).to(dev)
    return comps[:3] + (optimal,), obs[:num_timesteps].contiguous()


# The single-device FFBS call's filter output, by width (the gloo FFBS
# smooths it on the mesh).
_E2_FILTERS = {}


def _e2_ffbs(dev, mesh, width, shared_filter=False):
    from aesmc_tpu_torch import parallel
    from aesmc_tpu_torch.sharding_utils import local_block
    t, batch, k, m = width
    comps, obs = _e2_optimal(dev, batch, t)
    kwargs = dict(return_original_latents=True, return_log_weights=True,
                  return_latents=False, return_log_weight=False,
                  return_log_marginal_likelihood=True)
    if mesh is None:
        run = _E2_FILTERS[width] = inference.infer(
            "smc", obs, *comps, k, noise=NoiseSource.seeded(360, dev),
            **kwargs)
    elif shared_filter:
        # The single-device call's filter, this rank's blocks: the
        # smoother alone on the mesh.
        run = {name: local_block(_E2_FILTERS[width][name], mesh, dims)
               for name, dims in (
                   ("original_latents", {1: "data", 2: "particle"}),
                   ("log_weights", {1: "data", 2: "particle"}),
                   ("log_marginal_likelihood", {0: "data"}))}
    else:
        run = inference.infer("smc", parallel.shard_batch(obs, mesh), *comps,
                              k, noise=NoiseSource.seeded(360, dev),
                              mesh=mesh, **kwargs)
    traj = smoothing.backward_simulation(
        run["original_latents"], run["log_weights"], comps[1], m,
        NoiseSource.seeded(361, dev), mesh=mesh)
    return ({"trajectories": traj, "log_z": run["log_marginal_likelihood"]},
            {"trajectories": {1: "data"}, "log_z": {0: "data"}})


def _e2_paris(dev, mesh, width, backward="pairwise", exchange="allgather"):
    from aesmc_tpu_torch import parallel
    t, batch, k = width
    comps, obs = _e2_optimal(dev, batch, t)
    extra = {}
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
        extra = dict(mesh=mesh, resampling_implementation=(
            parallel.make_distributed_fused_resampler(mesh,
                                                      exchange=exchange)))
    out = smoothing.paris(obs, *comps, k, h=lambda xp, xc, time: xp * xc,
                          h0=lambda x0: x0 * x0,
                          noise=NoiseSource.seeded(362, dev),
                          num_backward_draws=PARIS_N, backward=backward,
                          **extra)
    return ({"tau": out["tau"], "smoothed": out["smoothed"],
             "log_z": out["log_marginal_likelihood"]},
            {"tau": {0: "data", 1: "particle"}, "smoothed": {0: "data"},
             "log_z": {0: "data"}})


def _e2_online(dev, mesh, width):
    """Streaming PaRIS and genealogy: the final tau and each step's
    relative-variance estimate."""
    from aesmc_tpu_torch import parallel
    t, batch, k = width
    comps, obs = _e2_optimal(dev, batch, t)
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
    init_fn, step_fn = online.make_online_filter(
        *comps, k, track_genealogy=True, paris_h=lambda xp, xc, time: xp * xc,
        paris_h0=lambda x0: x0 * x0, mesh=mesh)
    noise = NoiseSource.seeded(363, dev)
    fs = init_fn(obs[0], noise)
    rel_var = []
    for step in range(1, t):
        fs, info = step_fn(fs, obs[step], noise)
        rel_var.append(info["log_z_rel_var"])
    return ({"tau": fs.tau, "rel_var": torch.stack(rel_var)},
            {"tau": {0: "data", 1: "particle"}, "rel_var": {1: "data"}})


def _e2_rbpf(dev, mesh, width):
    from aesmc_tpu_torch import parallel
    t, batch, k = width
    obs = torch.randn(t, batch, 1, generator=torch.Generator(
        device=dev).manual_seed(364), device=dev)
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
    out = rbpf.rbpf(obs, num_particles=k, noise=NoiseSource.seeded(365, dev),
                    ess_threshold=0.5, mesh=mesh, **_bench_switching(dev, 1))
    return ({"regimes": out["nonlinear_latents"],
             "log_z": out["log_marginal_likelihood"],
             "filtered_means": out["filtered_means"]},
            {"regimes": {0: "data", 1: "particle"}, "log_z": {0: "data"},
             "filtered_means": {1: "data"}})


def _e2_smc2(dev, mesh, width, ess_threshold=1.0):
    """SMC² rejuvenating at every step (the default threshold 1.0): the
    theta resampling and the PMMH reruns run T - 1 times."""
    t, m, k = width
    comps = _bench_optimal_lgssm(dev)
    _, obs = statistics.sample_from_prior(*comps[:3], t, 1,
                                          NoiseSource.seeded(366, dev))
    q_scale = math.sqrt(SQMC_Q)

    def build(theta):
        return (comps[0], lgssm.Transition(mult=theta["mult"],
                                           scale=q_scale),
                comps[2], comps[3])

    theta0 = 0.8 + 0.2 * torch.randn(m, generator=torch.Generator(
        device=dev).manual_seed(367), device=dev)
    out = smc2.smc2(obs, build, {"mult": theta0},
                    lambda th: -0.5 * ((th["mult"] - 0.8) / 0.2) ** 2, k,
                    noise=NoiseSource.seeded(368, dev),
                    ess_threshold=ess_threshold, mesh=mesh)
    if int(out["num_rejuvenations"]) != t - 1:
        raise AssertionError(f"SMC^2 rejuvenated {out['num_rejuvenations']} "
                             f"times in {t} steps; expected {t - 1}")
    return ({"log_evidence": out["log_evidence"],
             "ess_path": out["ess_path"], "theta": out["theta"]["mult"],
             "log_theta_weight": out["log_theta_weight"],
             "acceptance_rate": out["acceptance_rate"]},
            {"log_evidence": {}, "ess_path": {}, "theta": {0: "data"},
             "log_theta_weight": {0: "data"}, "acceptance_rate": {}})


def _e2_twisted(dev, mesh, width, discrete=False):
    from aesmc_tpu_torch import parallel
    t, batch, k = width
    if discrete:
        hcomps, obs = _hmm_data(dev, t, batch, 0, num_states=HMM_STATES)
        initial, transition, emission, _ = hcomps
        spec = twisted.DiscreteSSMSpec(initial.logits, transition.logits)
        twist = twisted.exact_hmm_twist(obs, initial.logits,
                                        transition.logits, emission.locs,
                                        emission.scale)
    else:
        comps, obs = _bench_lgssm(dev, TRANSITION_MULT, batch)
        obs = obs[:t].contiguous()
        emission = comps[2]
        spec = twisted.GaussianSSMSpec(
            0.0, 1.0, TRANSITION_SCALE,
            mean_fn=lambda x, time: TRANSITION_MULT * x)
        # The twist's [T, B] tables of the global batch: the port cuts
        # them to each rank's rows.
        twist = twisted.exact_lgssm_twist(
            obs, 0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
            EMISSION_SCALE)
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
    out = twisted.twisted_smc(obs, spec, emission, twist, k,
                              noise=NoiseSource.seeded(369, dev), mesh=mesh,
                              return_latents=False,
                              return_ancestral_indices=True)
    return ({"ancestors": out["ancestral_indices"],
             "log_z": out["log_marginal_likelihood"]},
            {"ancestors": {1: "data", 2: "particle"}, "log_z": {0: "data"}})


def _e2_learn_twist(dev, mesh, width, fit_jitter=0.0):
    """`learn_twist` on phase 31's stochastic volatility, 2 ADP
    iterations: the global twist and evidence, the same on every rank."""
    from aesmc_tpu_torch import parallel
    t, batch, k = width
    mu, phi, sigma, beta = TW_SV
    sv = stochastic_volatility.make_model(mu, phi, sigma, beta, device=dev)
    _, obs = statistics.sample_from_prior(*sv[:3], t, batch,
                                          NoiseSource.seeded(379, dev))
    spec = twisted.GaussianSSMSpec(
        mu, sigma / math.sqrt(1.0 - phi ** 2), sigma,
        mean_fn=lambda x, time: mu + phi * (x - mu))
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
    tw, info = twisted.learn_twist(
        obs, spec, sv[2], k, noise=NoiseSource.seeded(380, dev),
        num_iterations=TW_LEARN_ITERATIONS, fit_jitter=fit_jitter, mesh=mesh)
    return ({"A": tw.A, "b": tw.b, "c": tw.c,
             "log_z": info["log_marginal_likelihood"]},
            {"A": {}, "b": {}, "c": {}, "log_z": {}})


def _e2_ot(dev, mesh, width):
    from aesmc_tpu_torch import parallel
    t, batch, k = width
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    obs = obs[:t, :batch].contiguous()
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
    out = inference.infer("smc", obs, *comps, k,
                          noise=NoiseSource.seeded(370, dev),
                          resampling_method="ot",
                          ot_num_iterations=OT_ITERATIONS,
                          return_log_marginal_likelihood=True,
                          return_latents=False, return_log_weight=False,
                          mesh=mesh)
    return ({"log_z": out["log_marginal_likelihood"]},
            {"log_z": {0: "data"}})


def _e2_resample_move(dev, mesh, width):
    from aesmc_tpu_torch import parallel
    t, batch, k = width
    comps = _bench_optimal_lgssm(dev)
    _, obs = statistics.sample_from_prior(*comps[:3], t, batch,
                                          NoiseSource.seeded(371, dev))
    impl = "auto"
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
        impl = parallel.make_distributed_fused_resampler(mesh)
    out = resample_move.resample_move_filter(
        obs, *comps, k, noise=NoiseSource.seeded(372, dev),
        num_move_steps=RM_MOVES, target_acceptance=0.4,
        resampling_implementation=impl, return_latents=False)
    return ({"log_z": out["log_marginal_likelihood"],
             "acceptance": out["acceptance_rate"],
             "log_weight": out["log_weight"]},
            {"log_z": {0: "data"}, "acceptance": {1: "data"},
             "log_weight": {0: "data", 1: "particle"}})


def _e2_block_pf(dev, mesh, width):
    from aesmc_tpu_torch import parallel
    t, dim, batch, k = width
    model = lorenz.make_model(dim=dim, emission_scale=0.5,
                              proposal="bootstrap", device=dev)
    _, obs = statistics.sample_from_prior(*model[:3], t, batch,
                                          NoiseSource.seeded(373, dev))
    impl = "auto"
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
        impl = parallel.make_distributed_resampler(mesh)
    out = blockpf.block_pf(obs, *model[:3], k,
                           blockpf.contiguous_blocks(dim, BPF_BLOCK),
                           noise=NoiseSource.seeded(374, dev),
                           resampling_implementation=impl,
                           return_log_marginal_likelihood=True,
                           return_latents=False,
                           return_ancestral_indices=True)
    return ({"log_z": out["log_marginal_likelihood"],
             "ancestors": out["ancestral_indices"]},
            {"log_z": {0: "data"}, "ancestors": {2: "data", 3: "particle"}})


def _e2_sampler(dev, mesh, width):
    """The bench's Gaussian (phase 28); ``mesh`` must have a data axis of
    one rank (the cloud has no batch axis)."""
    from aesmc_tpu_torch import parallel
    from aesmc_tpu_torch.sharding_utils import local_block
    k, dim = width
    y = torch.full((dim,), 1.5, device=dev)

    def log_prior(x):
        return -0.5 * torch.sum(x * x)

    def log_lik(x):
        return -0.5 * torch.sum((y - x) ** 2) / 0.5

    x0 = torch.randn(k, dim, generator=torch.Generator(device=dev)
                     .manual_seed(375), device=dev)
    impl = "auto"
    if mesh is not None:
        x0 = local_block(x0, mesh, {0: "particle"})
        impl = parallel.make_distributed_resampler(mesh)
    out = samplers.smc_sampler(log_prior, log_lik, x0,
                               noise=NoiseSource.seeded(376, dev),
                               num_moves=SAMPLER_MOVES,
                               step_size=SAMPLER_STEP,
                               resampling_implementation=impl)
    total = out["particles"].sum(dim=0)
    if mesh is not None:
        from aesmc_tpu_torch.parallel import collectives
        total = collectives.all_reduce(total, mesh.get_group("particle"))
    return ({"log_normalizer": out["log_normalizer"],
             "num_steps": out["num_steps"], "particle_mean": total / k},
            {"log_normalizer": {}, "num_steps": {}, "particle_mean": {}})


def _e2_if2(dev, mesh, width):
    from aesmc_tpu_torch import parallel
    t, batch, k, iterations = width
    comps = _bench_optimal_lgssm(dev)
    proposal = lgssm.Proposal(**PG_PROPOSAL).to(dev)
    q_scale = math.sqrt(SQMC_Q)

    def build(theta):
        return (comps[0], lgssm.Transition(mult=theta["mult"],
                                           scale=q_scale),
                comps[2], proposal)

    _, obs = statistics.sample_from_prior(*comps[:3], t, batch,
                                          NoiseSource.seeded(377, dev))
    # [B] starting centres of the global batch: the port cuts them.
    theta0 = torch.linspace(0.3, 0.7, batch, device=dev)
    impl = "auto"
    if mesh is not None:
        obs = parallel.shard_batch(obs, mesh)
        impl = parallel.make_distributed_fused_resampler(mesh)
    out = if2.if2(obs, build, {"mult": theta0}, {"mult": 0.05}, k,
                  iterations, noise=NoiseSource.seeded(378, dev),
                  resampling_implementation=impl)
    return ({"theta": out["theta"]["mult"],
             "log_likelihoods": out["log_likelihoods"]},
            {"theta": {0: "data", 1: "particle"},
             "log_likelihoods": {1: "data"}})


def _e2_compare(path, mesh, single, sharded, layouts, bars):
    """This rank's blocks of the mesh call against the same blocks of the
    single-device call: bit for bit (``bars`` None) or within (rtol,
    atol) (a dict by output, or one pair). Returns the largest absolute
    difference."""
    from aesmc_tpu_torch.sharding_utils import local_block
    worst = 0.0
    for name, dims in layouts.items():
        want = local_block(single[name], mesh, dims) if dims else \
            single[name]
        got = sharded[name]
        bar = bars.get(name, bars.get("*")) if isinstance(bars, dict) \
            else bars
        if bar == "skip":
            continue
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
            raise AssertionError(f"{path}: {name} {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(want.shape)} "
                                 f"{want.dtype}")
        diff = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        worst = max(worst, diff)
        if bar is None:
            if not torch.equal(got, want):
                raise AssertionError(f"{path}: {name} differs from the "
                                     f"single-device call (largest "
                                     f"difference {diff})")
        elif not torch.allclose(got.double(), want.double(), rtol=bar[0],
                                atol=bar[1]):
            raise AssertionError(f"{path}: {name} off the single-device "
                                 f"call by {diff} (bar rtol {bar[0]}, atol "
                                 f"{bar[1]})")
    return worst


def _e2_expect(path, counts, kernels):
    """Each of ``kernels`` launched on the path, K1 never (a mesh resamples
    through the exchanges), and nothing at all for no ``kernels``."""
    missing = [name for name in kernels if not counts[name]]
    if missing or counts["resample_systematic"] or (
            not kernels and any(counts.values())):
        raise AssertionError(f"{path}: launched {counts}; expected each of "
                             f"{kernels} and nothing else")


def _e2_run(dev, mesh, path, fn, width, kernels, bars, launches, times,
            **kwargs):
    """One E2 path: the single-device call, then the mesh call with the
    launch counts set to 0 just before it and read just after; the two
    compared (`_e2_compare`), the mesh call's kernels checked: each of
    ``kernels`` launched, K1 never (a mesh resamples through the
    exchanges)."""
    with torch.no_grad():
        single, _ = fn(dev, None, width, **kwargs)
        reset_counts()
        start = time.perf_counter()
        sharded, layouts = fn(dev, mesh, width, **kwargs)
        counts = _md_counts(launches, path)
        seconds = time.perf_counter() - start
    _e2_expect(path, counts, kernels)
    worst = _e2_compare(path, mesh, single, sharded, layouts, bars)
    times[path] = (seconds * 1e3, [round(seconds * 1e3, 3)])
    how = ("bit for bit" if bars is None else
           f"within the JAX test's bar (largest difference {worst:.3g})")
    _md_print(f"{path}: equal to the single-device call {how}; "
              f"{seconds * 1e3:.1f} ms the mesh call (host clock)")


def _e2_nccl_task(dev, mesh, launches, times):
    """(36a) Each E2 path on the NCCL world's (ranks, 1) mesh at its
    phase's width, bit for bit but OT."""
    from aesmc_tpu_torch import parallel
    start = time.perf_counter()
    world = torch.distributed.get_world_size()
    _md_print(f"== 36a slice E2 on the NCCL (ranks, 1) mesh, {world} "
              f"rank(s)")
    batch = -(-B // world) * world
    k3, k4, k5 = "resample_sorted", "searchsorted_sorted", "gather_sorted"
    runs = (
        ("FFBS", _e2_ffbs, (E2_T, batch, K, E2_FFBS_M), (k3,), None, {}),
        ("PaRIS pairwise", _e2_paris, (E2_PARIS_T, batch, E2_PARIS_K),
         (k3,), None, {}),
        ("PaRIS rejection", _e2_paris, (E2_PARIS_T, batch, E2_PARIS_K),
         (k3,), None, dict(backward="rejection")),
        ("RBPF Do = 1", _e2_rbpf, (E2_T, batch, E2_RBPF_K), (k3,), None,
         {}),
        ("twisted LGSSM, exact twist", _e2_twisted, (E2_T, batch, K), (k3,),
         None, {}),
        (f"twisted HMM D = {HMM_STATES}", _e2_twisted, (E2_T, batch, K),
         (k4, k5), None, dict(discrete=True)),
        ("learn_twist SV", _e2_learn_twist, (E2_T, batch, TW_LEARN_K),
         (k3,), None if world == 1 else {"*": E2_BARS["twisted"]}, {}),
        ("OT dense", _e2_ot, (E2_OT_T, max(E2_OT_B, world), E2_OT_K), (),
         {"*": E2_BARS["ot"]}, {}),
        ("resample-move", _e2_resample_move, (E2_T, batch, E2_RM_K), (k3,),
         None, {}),
        (f"block PF D = {E2_BPF_D}", _e2_block_pf,
         (E2_T, E2_BPF_D, max(E2_BPF_B, world), E2_BPF_K), (k4,), None, {}),
        ("IF2", _e2_if2, (E2_T, max(E2_IF2_B, world), E2_IF2_K,
                          E2_IF2_ITERATIONS), (k3,), None, {}),
    )
    for label, fn, width, kernels, bars, kwargs in runs:
        _e2_run(dev, mesh, f"36a NCCL {label} {width}", fn, width, kernels,
                bars, launches, times, **kwargs)
    # SMC^2 shards its thetas over the data axis; the sampler has no batch
    # axis and shards its particles over a (1, ranks) mesh.
    _e2_run(dev, mesh, f"36a NCCL SMC^2 (T, M, K) = ({E2_S2_T}, {E2_S2_M}, "
            f"{E2_S2_K})", _e2_smc2, (E2_S2_T, E2_S2_M, E2_S2_K), (k3,),
            None if world == 1 else {"*": E2_BARS["smc2"]}, launches, times)
    particle_mesh = (mesh if world == 1 else
                     parallel.make_mesh(1, world, device_type=dev.type))
    _e2_run(dev, particle_mesh, f"36a NCCL sampler K = {E2_SAMPLER_K}",
            _e2_sampler, (E2_SAMPLER_K, SAMPLER_D), (k4,),
            None if world == 1 else {
                "log_normalizer": E2_BARS["sampler"], "num_steps": None,
                "particle_mean": E2_BARS["sampler_means"]}, launches, times)
    seconds = time.perf_counter() - start
    _md_print(f"== 36a took {seconds:.1f} s")
    return seconds


def _e2_gloo_task(dev, meshes, launches, times):
    """(36b) Each E2 path on the gloo ranks' (2, 2) and (1, 4) meshes at
    small width, within its JAX test's bar."""
    start = time.perf_counter()
    _md_print(f"== 36b slice E2 on {MD_GLOO_RANKS} gloo ranks on cuda:0, "
              f"meshes {MD_GLOO_MESHES}, (T, B, K) = ({E2G_T}, {E2G_B}, "
              f"{E2G_K})")
    t, b, k = E2G_T, E2G_B, E2G_K
    k3, k4, k5 = "resample_sorted", "searchsorted_sorted", "gather_sorted"
    # What the JAX tests compare on a sharded particle axis (whose CDF may
    # move an ancestor across a bin edge): the smoothed sum and log-Z, the
    # evidence.
    paris_bars = {"tau": "skip", "smoothed": E2_BARS["paris"],
                  "log_z": E2_BARS["paris"]}
    twisted_bars = {"ancestors": "skip", "log_z": E2_BARS["twisted"]}
    for (dp, pp), mesh in meshes.items():
        tag = f"36b gloo {dp}x{pp}"
        runs = [
            ("FFBS pairwise", _e2_ffbs, (t, b, k, E2G_M), (),
             {"trajectories": E2_BARS["ffbs"], "log_z": (0.0, 0.0)},
             dict(shared_filter=True)),
            ("PaRIS pairwise" + (", ring exchange" if pp == 4 else ""),
             _e2_paris, (t, b, k), (k3,), paris_bars,
             dict(exchange="ring" if pp == 4 else "allgather")),
            ("PaRIS rejection", _e2_paris, (t, b, k), (k3,), paris_bars,
             dict(backward="rejection")),
            ("streaming PaRIS + genealogy", _e2_online, (t, b, k), (k3,),
             {"*": E2_BARS["online"]}, {}),
            ("RBPF", _e2_rbpf, (t, b, k), (k3,),
             {"regimes": "skip", "log_z": E2_BARS["rbpf"],
              "filtered_means": E2_BARS["rbpf_means"]}, {}),
            # Rejuvenating at every step; with the thetas split, the
            # theta resampling runs on the theta group (K4).
            ("SMC^2", _e2_smc2, (t, E2G_THETA, k),
             (k3,) + ((k4,) if dp > 1 else ()),
             {"*": E2_BARS["smc2"]}, {}),
            ("twisted LGSSM", _e2_twisted, (t, b, k), (k3,), twisted_bars,
             {}),
            ("twisted HMM", _e2_twisted, (t, b, k), (k4, k5), twisted_bars,
             dict(discrete=True)),
            ("learn_twist SV, jittered design points", _e2_learn_twist,
             (t, b, k), (k3,), {"*": E2_BARS["twisted"]},
             dict(fit_jitter=1.5)),
            ("OT (ring-streamed Sinkhorn)", _e2_ot, (t, b, k), (),
             {"*": E2_BARS["ot"]}, {}),
            ("resample-move", _e2_resample_move, (t, b, k), (k3,),
             {"*": E2_BARS["rm"]}, {}),
            ("block PF", _e2_block_pf, (t, E2_BPF_D, b, k), (k4,),
             {"*": E2_BARS["bpf"]}, {}),
            ("IF2", _e2_if2, (t, b, k, E2_IF2_ITERATIONS), (k3,),
             {"*": E2_BARS["if2"]}, {}),
        ]
        if dp == 1:
            runs.append(("sampler", _e2_sampler, (16 * k, SAMPLER_D), (k4,),
                         {"log_normalizer": E2_BARS["sampler"],
                          "num_steps": None,
                          "particle_mean": E2_BARS["sampler_means"]}, {}))
        for label, fn, width, kernels, bars, kwargs in runs:
            _e2_run(dev, mesh, f"{tag} {label}", fn, width, kernels, bars,
                    launches, times, **kwargs)
    seconds = time.perf_counter() - start
    _md_print(f"== 36b took {seconds:.1f} s")
    return seconds


# Phase 37 (slice E3): the four combinations of a mesh and an option that
# the JAX package computes: residual resampling (the residual exchange:
# K4 on the draws and the slots, K3 with K2 as its backward, K5 for int
# leaves), the low-rank OT on the particle group, the TMC objective and
# the score estimator. (a) The NCCL world's (ranks, 1) mesh at full
# width, T cut to E3_T for the residual paths; (b) the gloo ranks' (2, 2)
# and (1, 4) meshes at (E3G_T, E3G_B, E3G_K), within the CPU tests' bars
# (tests/test_torch_mesh_algorithms.py); (c) the four kernels at the
# residual exchange's shapes, in this process.
E3_T, E3_STEPS = 50, 3
E3G_T, E3G_B, E3G_K, E3G_RANK = 6, 4, 32, 4
# The low-rank OT on gloo makes ~15 collectives an iteration (2-12 ms
# each there): T cut to 3 and 3 iterations keep it near 2 s on both
# meshes (5.4 s on (1, 4) alone at T = 6 and 5 iterations, 4 gloo ranks
# on one H100).
E3G_OT_T, E3G_OT_ITERATIONS = 3, 3
# The CPU tests' bars: (rtol, atol) of a value; a gradient leaf within
# rtol times its largest entry plus atol; the score gradient's leaves
# within rtol times their largest entry plus E3_SCORE_ROUNDING times the
# single-device gradient's own float32 rounding (its distance from a
# float64 evaluation of the same surrogate: the score term sums K
# per-particle gradients times advantages, which cancel to a gradient
# far smaller than its terms).
E3_BARS = {"log_z": (1e-5, 0.0), "lowrank": (0.0, 1e-4),
           "tmc_loss": (1e-5, 0.0), "tmc_grads": (1e-5, 1e-6),
           "score_loss": (1e-6, 0.0), "score_grads": (1e-5, 0.0)}
E3_SCORE_ROUNDING = 10.0
E3_K3, E3_K4, E3_K5, E3_K2 = ("resample_sorted", "searchsorted_sorted",
                              "gather_sorted", "range_sum")


def _e3_same(path, name, got, want, bar=None):
    """``got`` against ``want``: bit for bit (``bar`` None) or within
    (rtol, atol). Returns the largest difference."""
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise AssertionError(f"{path}: {name} {tuple(got.shape)} {got.dtype}"
                             f" vs {tuple(want.shape)} {want.dtype}")
    diff = (float((got.double() - want.double()).abs().max())
            if got.numel() else 0.0)
    ok = (torch.equal(got, want) if bar is None else torch.allclose(
        got.double(), want.double(), rtol=bar[0], atol=bar[1]))
    if not ok:
        raise AssertionError(f"{path}: {name} off the single-device call by "
                             f"{diff} (bar {bar or 'bit for bit'})")
    return diff


def _e3_same_grads(path, got, want, bar, rounding=None):
    """Each gradient leaf within bar[0] times its largest entry plus
    bar[1], plus E3_SCORE_ROUNDING times that leaf's entry of
    ``rounding`` (the reference's own float32 rounding) where given;
    returns the largest difference relative to the leaf's largest
    entry."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        diff = float((g - w).abs().max())
        worst = max(worst, diff / max(scale, 1e-30))
        allowed = bar[0] * scale + bar[1] + (
            0.0 if rounding is None else E3_SCORE_ROUNDING * rounding[i])
        if diff > allowed:
            raise AssertionError(f"{path}: gradient {i} off by {diff} "
                                 f"(largest entry {scale}, allowed "
                                 f"{allowed})")
    return worst


def _e3_score_reference(obs, comps, k, noise):
    """The single-device score loss, its gradients, and each leaf's
    float32 rounding: the largest distance of the gradient from the
    same surrogate's, evaluated in float64 on the same engine output."""
    from aesmc_tpu_torch import gradients
    result = inference.infer(
        "smc", obs, *comps, k, noise=noise, resampling_method="multinomial",
        return_log_weights=True, return_ancestral_indices=True,
        return_latents=False)
    params = train.get_chained_params(*comps)
    loss = gradients.score_surrogate_from_result(result)
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    wide = dict(result, log_weights=result["log_weights"].double())
    grads_64 = torch.autograd.grad(
        gradients.score_surrogate_from_result(wide), params)
    rounding = [float((g.double() - w).abs().max())
                for g, w in zip(grads, grads_64)]
    return loss.detach(), grads, rounding


def _e3_mean_grads(params):
    """The mean over the world of the ranks' gradients (the single-device
    gradient, `parallel.sharded`)."""
    world = torch.distributed.get_world_size()
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    torch.distributed.all_reduce(flat)
    flat = flat / world
    out, offset = [], 0
    for p in params:
        out.append(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return out


def _e3_score_step(optimizer, mesh):
    """A sharded score-estimator step: `get_loss(gradient_estimator=
    'score', mesh=...)`, the ranks' gradients averaged, one optimizer
    step (`parallel.make_sharded_train_step`'s body; the JAX package's
    sharded step takes no estimator)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(comps, obs, noise):
        optimizer.zero_grad(set_to_none=True)
        loss = losses.get_loss(obs, TRAIN_K, "aesmc", *comps, noise=noise,
                               resampling_method="multinomial",
                               gradient_estimator="score", mesh=mesh)
        loss.backward()
        for p, g in zip(params, _e3_mean_grads(params)):
            p.grad = g.clone()
        optimizer.step()
        return loss.detach()

    return step


def _e3_steps(path, sharded, single, comps_m, comps_1, obs, mesh, seed,
              launches, times, expected):
    """E3_STEPS sharded steps against the one-device steps on the same
    noise: losses equal (over one particle rank bit for bit), parameters
    within GRAD_RTOL relative; the first sharded step's launches, each
    sharded step's time between CUDA events."""
    from aesmc_tpu_torch import parallel
    obs_b = parallel.shard_batch(obs, mesh)
    step_ms = []
    for i in range(E3_STEPS):
        reset_counts()
        loss_m, ms = _timed(lambda: sharded(
            comps_m, obs_b, NoiseSource.seeded(seed + i, obs.device)))
        step_ms.append(round(ms, 3))
        if i == 0:
            _md_expect(_md_counts(launches, path), path, **expected)
        loss_1 = single(comps_1, obs, NoiseSource.seeded(seed + i,
                                                          obs.device))
        if not torch.allclose(loss_m, loss_1, rtol=1e-6, atol=0):
            raise AssertionError(f"{path}: step {i} loss {float(loss_m)} vs "
                                 f"{float(loss_1)}")
    worst = _md_param_rel(comps_m, comps_1)
    if worst > GRAD_RTOL:
        raise AssertionError(f"{path}: parameters after {E3_STEPS} steps off "
                             f"by {worst} relative")
    times[path] = (float(np.median(step_ms)), step_ms)
    _md_print(f"{path}: {E3_STEPS} steps, losses equal to the one-device "
              f"steps' (last {float(loss_m):.6f} vs {float(loss_1):.6f}), "
              f"parameters within {worst:.3g} relative (bound {GRAD_RTOL}); "
              f"{times[path][0]:.3f} ms/step (runs {times[path][1]})")


def _e3_nccl_task(dev, mesh, launches, times):
    """(37a) The E3 paths on the NCCL world's (ranks, 1) mesh."""
    from aesmc_tpu_torch import parallel
    start = time.perf_counter()
    world = torch.distributed.get_world_size()
    batch = -(-B // world) * world
    rows = parallel.data_particle_specs(mesh, batch, K)[0]
    _md_print(f"== 37a slice E3 on the NCCL (ranks, 1) mesh, {world} "
              f"rank(s)")

    # Residual resampling: the filter, a stream, the HMM's int particles.
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT, batch)
    obs = obs[:E3_T].contiguous()
    kwargs = dict(resampling_method="residual",
                  return_log_marginal_likelihood=True,
                  return_ancestral_indices=True)

    def residual(mesh_=None):
        return inference.infer(
            "smc", obs if mesh_ is None else parallel.shard_batch(obs, mesh_),
            *comps, K, noise=NoiseSource.seeded(370, dev), mesh=mesh_,
            **kwargs)

    path = f"37a NCCL residual filter ({E3_T}, {batch}, {K})"
    with torch.no_grad():
        want = residual()
        reset_counts()
        got = residual(mesh)
        counts = _md_counts(launches, path)
        _md_expect(counts, path, **{E3_K4: E3_T - 1, E3_K3: E3_T - 1})
        for name in ("ancestral_indices", "latents"):
            _e3_same(path, name, got[name], want[name][:, rows])
        _e3_same(path, "log-Z", got["log_marginal_likelihood"],
                 want["log_marginal_likelihood"][rows])
        times[path] = _md_median_ms(lambda: residual(mesh))
    _md_print(f"{path}: ancestors, latents and log-Z equal to the "
              f"single-device call bit for bit; {times[path][0]:.3f} "
              f"ms/call (runs {times[path][1]}); launches K2 "
              f"{counts[E3_K2]}, K3 {counts[E3_K3]}, K4 {counts[E3_K4]}, K5 "
              f"{counts[E3_K5]}")

    path = f"37a NCCL residual stream, {E3_T} observations"
    with torch.no_grad():
        init_fn, step_fn = online.make_online_filter(
            *comps, K, resampling_method="residual", return_ancestors=True,
            mesh=mesh)
        obs_b = parallel.shard_batch(obs, mesh)
        noise = NoiseSource.seeded(370, dev)
        reset_counts()
        stream_start = time.perf_counter()
        fs = init_fn(obs_b[0], noise)
        ancestors = []
        for t in range(1, E3_T):
            fs, info = step_fn(fs, obs_b[t], noise)
            ancestors.append(info["ancestral_index"])
        counts = _md_counts(launches, path)
        seconds = time.perf_counter() - stream_start
        _md_expect(counts, path, **{E3_K4: E3_T - 1, E3_K3: E3_T - 1})
        _e3_same(path, "ancestors", torch.stack(ancestors),
                 got["ancestral_indices"])
        _e3_same(path, "log-Z", online.log_marginal_likelihood(fs, mesh),
                 got["log_marginal_likelihood"])
    times[path] = (seconds * 1e3, [round(seconds * 1e3, 3)])
    _md_print(f"{path}: ancestors and log-Z equal to the mesh `infer` call "
              f"bit for bit; {seconds * 1e3 / (E3_T - 1):.3f} ms an "
              f"observation (host clock)")

    hmm_comps, hmm_obs = _hmm_data(dev, E3_T, batch, 0,
                                   num_states=HMM_STATES)
    path = f"37a NCCL residual HMM filter (D = {HMM_STATES}, int32 particles)"

    def hmm_residual(mesh_=None):
        return inference.infer(
            "smc", hmm_obs if mesh_ is None else
            parallel.shard_batch(hmm_obs, mesh_), *hmm_comps, K,
            noise=NoiseSource.seeded(371, dev), resampling_method="residual",
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True, mesh=mesh_)

    with torch.no_grad():
        want = hmm_residual()
        reset_counts()
        got = hmm_residual(mesh)
        counts = _md_counts(launches, path)
        _md_expect(counts, path, **{E3_K4: 2 * (E3_T - 1),
                                    E3_K5: E3_T - 1})
        _e3_same(path, "ancestors", got["ancestral_indices"],
                 want["ancestral_indices"][:, rows])
        _e3_same(path, "log-Z", got["log_marginal_likelihood"],
                 want["log_marginal_likelihood"][rows])
        times[path] = _md_median_ms(lambda: hmm_residual(mesh), calls=1)
    _md_print(f"{path}: ancestors and log-Z equal to the single-device call "
              f"bit for bit; {times[path][0]:.3f} ms/call; launches K4 "
              f"{counts[E3_K4]} (draws and slots), K5 {counts[E3_K5]}")

    # The low-rank OT at the rank-32 row of benchmarks/ot_engine_probe.py:32.
    ot_batch = max(OT_B, world)
    ot_comps, ot_obs = _bench_lgssm(dev, TRANSITION_MULT)
    ot_obs = ot_obs[:OT_LARGE_T, :ot_batch].contiguous()
    path = (f"37a NCCL low-rank OT r = {OT_RANK} ({OT_LARGE_T}, {ot_batch}, "
            f"{OT_LARGE_K})")
    ot_rows = parallel.data_particle_specs(mesh, ot_batch, OT_LARGE_K)[0]

    def lowrank(mesh_=None):
        return inference.infer(
            "smc", ot_obs if mesh_ is None else
            parallel.shard_batch(ot_obs, mesh_), *ot_comps, OT_LARGE_K,
            noise=NoiseSource.seeded(372, dev), resampling_method="ot",
            ot_rank=OT_RANK, ot_num_iterations=OT_ITERATIONS,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False, mesh=mesh_)["log_marginal_likelihood"]

    with torch.no_grad():
        want = lowrank()
        reset_counts()
        got = lowrank(mesh)
        counts = _md_counts(launches, path)
        _md_expect(counts, path)
        diff = _e3_same(path, "log-Z", got, want[ot_rows],
                        E3_BARS["lowrank"])
        times[path] = _md_median_ms(lambda: lowrank(mesh), calls=1)
    _md_print(f"{path}: log-Z within {diff:.3g} of the single-device call "
              f"(bar {E3_BARS['lowrank'][1]}); no kernel; "
              f"{times[path][0]:.3f} ms/call (runs {times[path][1]})")

    # TMC and score steps at the bench's training shape.
    for label, seed, expected in (("TMC", 380, {}),
                                  ("score", 390, {E3_K3: T - 1,
                                                  E3_K2: T - 1})):
        (comps_m, obs_t), (comps_1, _) = (_bench_lgssm(dev, 0.5, batch),
                                          _bench_lgssm(dev, 0.5, batch))
        opt_m = torch.optim.Adam(train.get_chained_params(*comps_m), lr=1e-2)
        opt_1 = torch.optim.Adam(train.get_chained_params(*comps_1), lr=1e-2)
        if label == "TMC":
            sharded = parallel.make_sharded_train_step(TRAIN_K, "tmc", opt_m,
                                                       mesh)
            single = train.make_train_step(TRAIN_K, "tmc", opt_1)
        else:
            sharded = _e3_score_step(opt_m, mesh)
            single = train.make_train_step(
                TRAIN_K, "aesmc", opt_1, resampling_method="multinomial",
                gradient_estimator="score")
        _e3_steps(f"37a NCCL sharded {label} step ({T}, {batch}, {TRAIN_K})",
                  sharded, single, comps_m, comps_1, obs_t, mesh, seed,
                  launches, times, expected)
    seconds = time.perf_counter() - start
    _md_print(f"== 37a took {seconds:.1f} s")
    return seconds


def _e3_gloo_task(dev, meshes, launches, times):
    """(37b) The E3 paths on the gloo ranks' (2, 2) and (1, 4) meshes at
    small width, within the CPU tests' bars."""
    from aesmc_tpu_torch import parallel
    from aesmc_tpu_torch.sharding_utils import local_block
    start = time.perf_counter()
    t, b, k = E3G_T, E3G_B, E3G_K
    _md_print(f"== 37b slice E3 on {MD_GLOO_RANKS} gloo ranks on cuda:0, "
              f"meshes {MD_GLOO_MESHES}, (T, B, K) = ({t}, {b}, {k})")
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT, b)
    optimal = _e2_optimal(dev, b, t)
    obs = obs[:E3G_OT_T].contiguous()
    with torch.no_grad():
        want_res = inference.infer(
            "smc", optimal[1], *optimal[0], k,
            noise=NoiseSource.seeded(373, dev), resampling_method="residual",
            return_log_marginal_likelihood=True,
            return_ancestral_indices=True)
        want_lr = inference.infer(
            "smc", obs, *comps, k, noise=NoiseSource.seeded(374, dev),
            resampling_method="ot", ot_rank=E3G_RANK,
            ot_num_iterations=E3G_OT_ITERATIONS,
            return_log_marginal_likelihood=True, return_latents=False)
    singles = {}
    comps_1, obs_1 = _bench_lgssm(dev, 0.5, b)
    loss = losses.get_loss(obs_1[:t], k, "tmc", *comps_1,
                           noise=NoiseSource.seeded(375, dev))
    singles["TMC"] = (loss.detach(), torch.autograd.grad(
        loss, train.get_chained_params(*comps_1)), None, "tmc", {})
    comps_1, obs_1 = _bench_lgssm(dev, 0.5, b)
    singles["score"] = _e3_score_reference(
        obs_1[:t], comps_1, k, NoiseSource.seeded(375, dev)) + (
            "aesmc", dict(resampling_method="multinomial",
                          gradient_estimator="score"))
    for (dp, pp), mesh in meshes.items():
        tag = f"37b gloo {dp}x{pp}"
        rows = parallel.data_particle_specs(mesh, b, k)[0]
        dims = {1: "data", 2: "particle"}
        path = f"{tag} residual filter (optimal proposal)"
        with torch.no_grad():
            reset_counts()
            got, ms = _timed(lambda: inference.infer(
                "smc", parallel.shard_batch(optimal[1], mesh), *optimal[0], k,
                noise=NoiseSource.seeded(373, dev),
                resampling_method="residual",
                return_log_marginal_likelihood=True,
                return_ancestral_indices=True, mesh=mesh))
            counts = _md_counts(launches, path)
        _md_expect(counts, path, **{E3_K4: t - 1, E3_K3: t - 1})
        for name in ("ancestral_indices", "latents"):
            _e3_same(path, name, got[name],
                     local_block(want_res[name], mesh, dims))
        diff = _e3_same(path, "log-Z", got["log_marginal_likelihood"],
                        want_res["log_marginal_likelihood"][rows],
                        E3_BARS["log_z"])
        times[path] = (ms, [round(ms, 3)])
        _md_print(f"{path}: ancestors and latents equal to the single-device "
                  f"call, log-Z within {diff:.3g}; {ms:.1f} ms")

        path = (f"{tag} low-rank OT r = {E3G_RANK}, T = {E3G_OT_T}, "
                f"{E3G_OT_ITERATIONS} iterations")
        with torch.no_grad():
            reset_counts()
            got, ms = _timed(lambda: inference.infer(
                "smc", parallel.shard_batch(obs, mesh), *comps, k,
                noise=NoiseSource.seeded(374, dev), resampling_method="ot",
                ot_rank=E3G_RANK, ot_num_iterations=E3G_OT_ITERATIONS,
                return_log_marginal_likelihood=True, return_latents=False,
                mesh=mesh))
            _md_expect(_md_counts(launches, path), path)
        diff = _e3_same(path, "log-Z", got["log_marginal_likelihood"],
                        want_lr["log_marginal_likelihood"][rows],
                        E3_BARS["lowrank"])
        times[path] = (ms, [round(ms, 3)])
        _md_print(f"{path}: log-Z within {diff:.3g} of the single-device "
                  f"call; {ms:.1f} ms")

        for label, (loss_1, grads_1, rounding, algorithm,
                    kwargs) in singles.items():
            path = f"{tag} {label} loss and gradients"
            comps_m, obs_m = _bench_lgssm(dev, 0.5, b)
            params = train.get_chained_params(*comps_m)
            reset_counts()

            def run(comps_m=comps_m, obs_m=obs_m, algorithm=algorithm,
                    kwargs=kwargs):
                loss = losses.get_loss(
                    parallel.shard_batch(obs_m[:t], mesh), k, algorithm,
                    *comps_m, noise=NoiseSource.seeded(375, dev), mesh=mesh,
                    **kwargs)
                loss.backward()
                return loss.detach()

            loss_m, ms = _timed(run)
            counts = _md_counts(launches, path)
            _md_expect(counts, path, **({} if label == "TMC" else
                                        {E3_K3: t - 1, E3_K2: t - 1}))
            key = "tmc" if label == "TMC" else "score"
            _e3_same(path, "loss", loss_m, loss_1, E3_BARS[f"{key}_loss"])
            worst = _e3_same_grads(path, _e3_mean_grads(params), grads_1,
                                   E3_BARS[f"{key}_grads"], rounding)
            times[path] = (ms, [round(ms, 3)])
            _md_print(f"{path}: loss {float(loss_m):.6f} vs "
                      f"{float(loss_1):.6f}, gradients within {worst:.3g} "
                      f"of each leaf's largest entry (bar "
                      f"{E3_BARS[key + '_grads']}"
                      + ("" if rounding is None else
                         f" + {E3_SCORE_ROUNDING:g} x the single-device "
                         f"gradient's float32 rounding "
                         f"{[float(f'{r:.3g}') for r in rounding]}")
                      + f"); {ms:.1f} ms")
    seconds = time.perf_counter() - start
    _md_print(f"== 37b took {seconds:.1f} s")
    return seconds


def _e3_kernel_phase(dev):
    """(37c) K4, K3, K2 and K5 at the residual exchange's shapes against
    their plain versions, exactly (K2 on integer cotangents), and timed:
    the NCCL (1, 1) exchange's gathered [B, K] counts CDF against its K
    slots, and a gloo rank's K_l = 8 of K = 32; K4 also on the residual
    draws (the residual CDF against a rank's sorted uniforms)."""
    start = time.perf_counter()
    generator = torch.Generator(device=dev).manual_seed(37)
    f = 4
    for batch, k, k_l in ((B, K, K), (E3G_B, E3G_K, E3G_K // MD_GLOO_RANKS)):
        lw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
        noise = NoiseSource(generator)
        idx = resampling.residual_indices(lw, noise)
        counts = torch.zeros((batch, k), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, idx.long(), torch.ones_like(idx))
        cum = torch.cumsum(counts, dim=1, dtype=torch.int32).float()
        # The last rank's slots, as the exchange searches them.
        slots = torch.arange(k - k_l, k, dtype=torch.float32,
                             device=dev).expand(batch, k_l).contiguous()
        _, _, cum_res = resampling._residual_parts(lw)
        draws = torch.sort(torch.rand(batch, k_l, generator=generator,
                                      device=dev), dim=1).values
        value = torch.randn(batch, k, 1, generator=generator, device=dev)
        states = torch.randint(0, HMM_STATES, (batch, k), generator=generator,
                               device=dev, dtype=torch.int32)
        g = torch.randint(-5, 6, (batch, k_l, 1), generator=generator,
                          device=dev).float()
        sel = searchsorted_sorted_cuda.searchsorted_sorted_torch(cum, slots)
        checks = {
            "K4 slots": (searchsorted_sorted_cuda.searchsorted_sorted(
                cum, slots), sel),
            "K4 draws": (searchsorted_sorted_cuda.searchsorted_sorted(
                cum_res, draws),
                searchsorted_sorted_cuda.searchsorted_sorted_torch(
                    cum_res, draws)),
            "K3": (resample_sorted_cuda.resample_and_gather_sorted(
                cum, slots, value),
                resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cum, slots, value)),
            "K2": (range_sum_cuda.range_sum(cum, slots, g),
                   range_sum_cuda.range_sum_torch(cum, slots, g)),
            "K5": (gather_sorted_cuda.gather_sorted(states, sel),
                   gather_sorted_cuda.gather_sorted_torch(states, sel)),
        }
        for label, (got, want) in checks.items():
            if not all(torch.equal(a, b) for a, b in zip(_as_tuple(got),
                                                         _as_tuple(want))):
                raise AssertionError(f"{label} differs from its plain version "
                                     f"on the residual exchange at (B, K, "
                                     f"K_l) = ({batch}, {k}, {k_l})")
        print(f"K4 (slots and draws), K3, K2 and K5 at the residual "
              f"exchange's (B, K, K_l) = ({batch}, {k}, {k_l}): exact "
              f"(tolerance 0; K2 on integer cotangents)", flush=True)
        n_p, steps = batch * k_l, _search_steps(k)
        shape = (batch, k, k_l)
        _kernel_row("searchsorted_sorted", shape,
                    lambda: searchsorted_sorted_cuda.searchsorted_sorted(
                        cum, slots),
                    lambda: searchsorted_sorted_cuda.searchsorted_sorted_torch(
                        cum, slots),
                    lambda: torch.searchsorted(cum, slots, right=True),
                    f * (batch * k + 2 * n_p), n_p * steps,
                    "torch.searchsorted")
        _kernel_row("resample_sorted", shape + (1,),
                    lambda: resample_sorted_cuda.resample_and_gather_sorted(
                        cum, slots, value),
                    lambda: (resample_sorted_cuda
                             .resample_and_gather_sorted_torch(cum, slots,
                                                               value)),
                    None, f * (batch * k * 2 + n_p * 3), n_p * steps)
        _kernel_row("range_sum", shape + (1,),
                    lambda: range_sum_cuda.range_sum(cum, slots, g),
                    lambda: range_sum_cuda.range_sum_torch(cum, slots, g),
                    lambda: torch.zeros((batch, k, 1), device=dev)
                    .scatter_add_(1, sel.long().unsqueeze(-1), g),
                    f * (batch * k * 2 + n_p * 2), n_p * steps + n_p,
                    "scatter_add_ over the given ancestors (non-"
                    "deterministic)")
        _kernel_row("gather_sorted", (batch, k, k_l),
                    lambda: gather_sorted_cuda.gather_sorted(states, sel),
                    lambda: gather_sorted_cuda.gather_sorted_torch(states,
                                                                   sel),
                    lambda: torch.take_along_dim(states, sel.long(), dim=1),
                    f * (batch * k + 2 * n_p), 0, "take_along_dim")
    seconds = time.perf_counter() - start
    print(f"== 37c took {seconds:.1f} s", flush=True)
    return seconds


def multi_device_phase(dev):
    phase(f"35 multi-device: NCCL world of {torch.cuda.device_count()} "
          f"rank(s), one card each; {MD_GLOO_RANKS} gloo ranks on cuda:0 "
          f"on meshes {MD_GLOO_MESHES}; K2-K4 at the distributed shapes; "
          f"phases 36 (slice E2) and 37 (slice E3) inside both worlds")
    print("the ranks' single-device calls run the 'cuda' route with the "
          "plain CDF (resampling._normalized_cumsum), whose arithmetic the "
          "mesh exchanges keep; with the CDF kernel a single-device call "
          "differs from a (1, 1) mesh at the bin-edge ancestors of phase 3k",
          flush=True)
    start = time.perf_counter()
    _md_kernel_phase(dev)
    e3_kernels = _e3_kernel_phase(dev)
    nccl = _md_world(torch.cuda.device_count(), "nccl", "_md_nccl_task")
    gloo = _md_world(MD_GLOO_RANKS, "gloo", "_md_gloo_task")
    e2 = nccl[0]["e2_seconds"] + gloo[0]["e2_seconds"]
    e3 = e3_kernels + nccl[0]["e3_seconds"] + gloo[0]["e3_seconds"]
    _phase_seconds("35", start)
    print(f"== phase 36 (slice E2) took {e2:.1f} s of them (rank 0: "
          f"{nccl[0]['e2_seconds']:.1f} s in the NCCL world, "
          f"{gloo[0]['e2_seconds']:.1f} s in the gloo world)", flush=True)
    print(f"== phase 37 (slice E3) took {e3:.1f} s of them ({e3_kernels:.1f} "
          f"s the kernels here; rank 0: {nccl[0]['e3_seconds']:.1f} s in "
          f"the NCCL world, {gloo[0]['e3_seconds']:.1f} s in the gloo "
          f"world)", flush=True)


def _build_other(other, sources):
    """Builds each of ``sources`` from directory ``other`` with `_build`'s
    flags, one nvcc each, all started together, into `compare/` of the
    build directory; returns {source: its library}."""
    out = _build.build_dir() / "compare"
    out.mkdir(parents=True, exist_ok=True)

    def build(source):
        lib = out / f"lib{pathlib.Path(source).stem}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(other / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {other / source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        return ctypes.CDLL(str(lib))

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


@contextlib.contextmanager
def _launching(entries):
    """The wrappers launch ``entries`` ({(source, symbol): C entry}) in
    place of the entries `_launch.entry` bound for them (K4's wrapper
    keeps its entry in its module as well)."""
    k4 = searchsorted_sorted_cuda
    saved, saved_k4 = dict(_launch._entries), k4._entry
    _launch._entries.update(entries)
    k4._entry = _launch._entries[(k4.SOURCE, k4._SYMBOL)]
    try:
        yield
    finally:
        _launch._entries.update(saved)
        k4._entry = saved_k4


def compare_phase(dev, other):
    """Each kernel's device time against another version of it, built from
    the sources in ``other`` (files named as in `aesmc_tpu_torch/csrc/`,
    with the same C entries), on the same inputs, in turns (other, this,
    this, other, twice). The other version is launched through this
    version's wrappers: its C entries are bound with the argument types
    that the wrappers bound for their own."""
    phase(f"3 compare: each kernel against the version in {other}")
    generator = torch.Generator(device=dev).manual_seed(11)
    cdf, u, value = _case_inputs(B, K, 1, "normal", generator, dev)
    pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                          "stratified")
    g = torch.randn(B, K, 1, generator=generator, device=dev)
    cases = [
        ("K1 (10, 10000, 1)", "resample_systematic", lambda: (
            resample_cuda.resample_and_gather_systematic(cdf, u, value))),
        ("K1 (10, 10000, 0) indices", "resample_systematic", lambda: (
            resample_cuda.resample_and_gather_systematic(
                cdf, u, value.new_empty((B, K, 0)), True))),
        ("K2 (10, 10000, 1)", "range_sum", lambda: range_sum_cuda.range_sum(
            cdf, pos, g)),
        ("K3 (10, 10000, 1)", "resample_sorted", lambda: (
            resample_sorted_cuda.resample_and_gather_sorted(cdf, pos,
                                                            value))),
        ("K4 (10, 10000)", "searchsorted_sorted", lambda: (
            searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos))),
    ]
    for batch, k, d in K5_TIMES:
        logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
        idx = resampling.sample_ancestral_index(logw, NoiseSource(generator))
        shape = (batch, k) if d == 1 else (batch, k, d)
        latents = _k5_value(torch.int32, shape, generator, dev)
        cases.append((f"K5 {(batch, k, d)} int32", "gather_sorted",
                      lambda latents=latents, idx=idx: (
                          gather_sorted_cuda.gather_sorted(latents, idx))))
    for batch, k, kind in K6_TIMES:
        logw, p6, v6 = _k6_inputs(batch, k, kind, generator, dev)
        cases.append((f"K6 {(batch, k, 1)} {kind}", "searchsorted_cdf",
                      lambda logw=logw, p6=p6, v6=v6: (
                          searchsorted_cdf_cuda.searchsorted_cdf(logw, p6,
                                                                 v6))))
    for _, _, fn in cases:
        fn()        # binds this version's C entries
    torch.cuda.synchronize()
    libs = _build_other(other, sorted({key[0] for key in _launch._entries}))
    entries = {}
    for (source, symbol), fn in _launch._entries.items():
        entries[(source, symbol)] = getattr(libs[source], symbol)
        entries[(source, symbol)].argtypes = fn.argtypes
        entries[(source, symbol)].restype = fn.restype
    # K5's int32 rows go to the other version as 4-byte elements, which
    # every version takes (the wrapper may hand them over as 16-byte ones).
    k5 = (gather_sorted_cuda.SOURCE, "aesmc_gather_sorted")
    raw = entries[k5]
    entries[k5] = lambda value, idx, out, batch, k, kp, d, unit, *rest: raw(
        value, idx, out, batch, k, kp, d * unit // 4, 4, *rest)
    for label, name, fn in cases:
        runs = {"this": [], "other": []}
        calls = 10 if "4194304" in label else 50
        for which in ("other", "this", "this", "other") * 2:
            with (_launching(entries) if which == "other" else
                  contextlib.nullcontext()):
                ms = _device_ms(fn, KERNELS[name][2], calls)
            runs[which].append(None if ms is None else round(ms * 1e3, 3))
        print(f"compare {label}: device us a launch, this version "
              f"{runs['this']}, the other {runs['other']}", flush=True)


@torch.no_grad()
def profile_margin_phase(dev, trials):
    """Profiles one replay of phase 19's graphed serving step ``trials``
    times in each of four windows, in turns: no margin, `PROFILE_MARGIN_S`
    of idle host time before the replay only, after it only, and both
    (`_profiled` leaves the one before); prints, for each, how many windows saw how many K1
    events and how many kernels, copies and fills on the card."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    phase(f"3 profile margin: {trials} profiled replays of the graphed "
          f"serving step in each of four windows")
    comps, _ = _bench_lgssm(dev, TRANSITION_MULT)
    obs = _serving_data(dev, comps, 2)
    init_fn, step_fn = online.make_online_filter(*comps, K)
    noise = NoiseSource.seeded(43, dev)
    captured = online.CapturedStep(step_fn, init_fn(obs[0], noise), obs[1],
                                   noise)
    for _ in range(5):
        captured(obs[1])
    torch.cuda.synchronize()
    margins = [(0.0, 0.0), (PROFILE_MARGIN_S, 0.0), (0.0, PROFILE_MARGIN_S),
               (PROFILE_MARGIN_S, PROFILE_MARGIN_S)]
    seen = {margin: collections.Counter() for margin in margins}
    start = time.perf_counter()
    for _ in range(trials):
        for before, after in margins:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(before)
                captured(obs[1])
                torch.cuda.synchronize()
                time.sleep(after)
            events = prof.key_averages()
            k1 = sum(e.count for e in events
                     if KERNELS["resample_systematic"][2] in e.key)
            on_card = sum(e.count for e in events if getattr(
                e, "device_type", None) == DeviceType.CUDA)
            seen[before, after][k1, on_card] += 1
    for (before, after), counts in seen.items():
        print(f"margin {before} s before, {after} s after: {trials} "
              f"windows, (K1 events, events on the card): windows "
              f"{dict(sorted(counts.items()))}", flush=True)
    print(f"{time.perf_counter() - start:.1f} s", flush=True)


def main():
    parser = argparse.ArgumentParser(
        description="Smoke test of the PyTorch port on one NVIDIA GPU.")
    parser.add_argument(
        "--compare", type=pathlib.Path, metavar="DIR",
        help="after phases 1 and 2, time each kernel against the version "
             "whose sources are in DIR instead of driving the paths")
    parser.add_argument(
        "--profile-margin", type=int, metavar="N",
        help="after phases 1 and 2, profile one replay of the graphed "
             "serving step N times in each of four windows (with and "
             "without idle host time at either end) instead of driving "
             "the paths")
    args = parser.parse_args()
    dev = device_phase()
    build_phase()
    if args.compare is not None:
        compare_phase(dev, args.compare)
        return
    if args.profile_margin is not None:
        profile_margin_phase(dev, args.profile_margin)
        return
    errors = {"resample_systematic": k1_phase(dev),
              "range_sum": k2_phase(dev),
              "resample_sorted": k3_phase(dev)}
    times = kernel_times(dev)
    host_costs(dev)
    times["gather_sorted"] = k5_phase(dev)
    errors["gather_sorted"] = 0.0
    times["searchsorted_sorted"] = k4_phase(dev)
    errors["searchsorted_sorted"] = 0.0
    times["searchsorted_cdf"] = k6_phase(dev)
    errors["searchsorted_cdf"] = 0.0
    rows_phase(dev)
    cdf_times = cdf_phase(dev)
    path_shapes_phase(dev)
    filter_phase(dev)
    train_phase(dev)
    hmm_filter_phase(dev)
    hmm_train_phase(dev)
    graph_train_phase(dev)
    graph_filter_phase(dev)
    adaptive_phase(dev)
    soft_phase(dev)
    lgssm_nd_phase(dev)
    apf_residual_phase(dev)
    dense_phase(dev)
    tmc_phase(dev)
    vrnn_phase(dev)
    score_phase(dev)
    smoothing_phase(dev)
    serving_phase(dev)
    ot_phase(dev)
    lorenz_phase(dev)
    bouncing_ball_phase(dev)
    sqmc_phase(dev)
    particle_gibbs_phase(dev)
    rbpf_phase(dev)
    resample_move_phase(dev)
    block_pf_phase(dev)
    sampler_phase(dev)
    smc2_phase(dev)
    if2_phase(dev)
    twisted_phase(dev)
    twisted_hmm_phase(dev)
    deep_twist_phase(dev)
    enkf_phase(dev)
    multi_device_phase(dev)
    kernels = []
    for name, (module, _, _, replaces) in KERNELS.items():
        launches = sum(LAUNCHES[name].values())
        if not launches:
            raise AssertionError(f"{name} was never launched on a main path")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"aesmc_tpu_torch/csrc/{module.SOURCE}",
            replaces=replaces, launches=launches,
            launches_by_path=LAUNCHES[name], max_abs_err=errors[name],
            **times[name]))
    launches = sum(LAUNCHES[CDF].values())
    if not launches:
        raise AssertionError(f"{CDF} was never launched on a main path")
    kernels.append(dict(
        name=CDF, route="cuda",
        source=f"aesmc_tpu_torch/csrc/{normalized_cdf_cuda.SOURCE}",
        replaces="none: the JAX engine builds the CDF with XLA ops",
        launches=launches, launches_by_path=LAUNCHES[CDF],
        times_by_shape=cdf_times))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
