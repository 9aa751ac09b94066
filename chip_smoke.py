#!/usr/bin/env python3
"""Smoke test of drone_tpu_torch on one CUDA card: `python3 chip_smoke.py`.

Builds the CUDA kernels from csrc/ (nvcc, in parallel; prints each
library's registers and spills, and those of the tensor-core kernels of
K10, K7 (both arms' walk and its products), K11/K9, both arms of K8/K6, K3
(its weights and running sums on chip, and off it), K5 and K2 with their
shared memory and their HMMA instructions, the SASS of mma.sync, which
each must hold; and the bf16 arms of K2, K3, K9/K11, K10 and K7 (its walk,
both arms, its products and its tower kernels) beside their fp32 arms:
the bf16 tensor cores' product (HMMA.16816.F32.BF16) and no TF32 HMMA,
or a third of the fp32 arm's TF32 HMMA where one TF32 product of rounded
operands stands for 3xTF32's three, and bf16 roundings, F2FP.BF16, which
the fp32 arms lack), holds each against
its plain PyTorch version on the card's inputs, drives the port's paths
through the entry points a user calls (the megakernel trainers, the scan
trainers and the hybrid recurrent tier, the env adapters, the export
to the C runtime, the sweep, the autotuner, the watch rollout and the
data-parallel trainers over torch.distributed), checks what comes out, and
times
each kernel beside its plain version and its bound. Exits nonzero, printing
no result, when there is no CUDA device or a phase fails; a learning gate
that fails (phases 10, 17, 24, 31, 38, 46, 51) stops no later phase, and the
script then exits nonzero after them, its kernels line printed and its last
line not.

Phases:
  1. K1 (csrc/rollout.cu; the auto-reset computed by the warp for its
     lanes that are done) against its plain version run on the CPU, bitwise
     on every state plane and per-lane statistic: all 6 task x integrator
     pairs, hover/euler at 65,536 lanes (configs/hover.toml's num_envs) and
     the others at 2,048, T = 32 over episodes of 20 steps (truncation ends
     whole warps on one step), with a provided action stream and with the
     in-kernel one; the same at 2,061 lanes (a ragged last warp); and
     in-kernel actions at the default horizon, T = 256, 2,048 lanes, for
     hover/euler and waypoint/rk4 (episodes end on scattered steps within
     each warp). Each case launched twice, bitwise equal. The plain version
     on the card must equal the CPU's bitwise too: env params are CUDA
     tensors there (a CPU scalar divisor would become a reciprocal
     multiply).
  2. K5 (csrc/acting.cu; the tower's products on the tensor cores in
     3xTF32) against its fp32 plain version on the card, deterministic and
     stochastic: hover, [64, 64], 65,536 lanes, T = 3 within rtol 2e-5 /
     atol 2e-6 with episode counts equal, and T = 64 with episode counts
     within 2% and mean reward per lane-step within 0.01; then a [32, 48,
     20] tower on waypoint/rk4 and a linear policy on racing/euler, 8,192
     lanes, [64, 64] on waypoint/rk4 over a ragged last block (8,232
     lanes) and [128, 128] (its weights off chip), T = 3. Each T = 3 case
     launched twice, bitwise equal.
  3. The env-engine path: `ops.rollout_cuda` at 65,536 lanes x 1,001 steps
     of in-kernel random actions (hover.toml's env).
  4. The serving path: a seeded ActorCritic([64, 64]) saved with the
     Checkpointer, `train.evaluate(cfg, episodes=65536)` on hover.toml, and
     `cli eval` at its default size. Launch counts are zeroed just before
     each path and read just after; each path must have run its kernel.
  5. evaluate() on the card against evaluate() on the CPU (plain versions)
     at 512 episodes: episode counts within 1%, mean return within 1%.
  6. Times by CUDA events after a warm-up, at the paths' shapes. K1's
     bound counts arithmetic instructions (k1_instruction_bound): its probe
     kernels' SASS, built with its flags, gives the fp32, int32 and MUFU
     instructions of a lane-step and of a reset; moves, branches and
     predicate logic are left out, and their tally printed.
  7. K2 (csrc/acting_traj.cu; both towers' products on the tensor cores in
     3xTF32, the weights packed on the device from the flat buffer) against
     its fp32 plain version on the card: hover, [64, 64], 65,536 lanes, T =
     3 (all 21 planes and the final state within rtol 2e-5 / atol 2e-6,
     episodes equal), both action modes, and T = 64 stochastic (episodes
     within 2%, mean reward within 0.01); then at T = 3 in both modes
     [64, 64] on waypoint/rk4 over a ragged last block (8,232 lanes), a
     [32, 48, 20] tower on waypoint/rk4, [128, 128], the widest tower of
     its envelope, a linear policy on racing/euler and [48] on hover/rk4
     (their fragments staged in shared memory, the others' read through
     L1), 8,192 lanes. Each T = 3 case launched twice, bitwise equal.
  8. K3 (csrc/update.cu; the towers' products on the tensor cores in
     3xTF32) against its fp32 plain version on hover.toml's minibatch (8
     row blocks of 1,024 lanes x 64 steps, planes from K2): each gradient
     tensor, and the stat sums, within 1e-4 x its max |value|, two launches
     bitwise equal. Twice: at the weights that wrote the planes (ratio 1,
     the first minibatch of an update), and at weights moved off them
     (then also [128, 128], its weights and running sums off chip, on a
     smaller run's minibatch), where at least 0.1% of the samples take
     each branch of the head's subgradients (ratio clipped with and
     without gradient, value clipped with and without gradient) and each
     of the policy-loss, value-loss, approx-KL and clip-fraction sums is
     held on its own. K4 (csrc/update.cu, one cooperative launch over a
     grid fixed by the buffer's length) against its plain version: rtol
     1e-5 / atol 1e-8, the norm clip active and inactive, each case
     launched twice, bitwise equal (likewise over the LSTM, CNN and
     CNN-LSTM layouts in 14, 21 and 29).
  9. The training path: `train.train` on hover.toml with 3 updates (K2 = 3,
     K3 = 96, K4 = 96 launches, finite metrics with the reference's keys);
     `cli train configs/hover.toml` for 2 updates, then `evaluate` of the
     checkpoint it wrote (through K5).
 10. The learning gate on the card (8,192 envs, horizon 32, [32, 32], lr
     3e-3, no entropy bonus): mean reward of 5 updates above 0.3 within
     120; and resume: train(4) == train(2) + resume(2) bitwise.
 11. Times of K2, K3, K4 (CUDA events) beside their plain versions and
     bounds (K2's and K3's the tensor-pipe bound, their products at the
     3xTF32 rate and the rest at the fp32 rate, the fp32 bound beside it;
     K5's, in phase 6, likewise). One full-width update, queued with
     torch's host-sync check on (it must not sync), split into rollout,
     GAE, update and metrics by CUDA events at make_train_step's phase
     marks and by the host clock; one more update traced with
     torch.profiler for the device's busy time and idle share.
 12. K8 (csrc/acting_lstm.cu, serving) against its plain version: hover,
     H 128 / encoder (64,), 65,536 lanes from a random carry, T = 3 within
     rtol 2e-5 / atol 2e-6 on the final carry and the per-lane statistics
     with episode counts equal, and T = 64 statistically (episodes within
     2%, mean reward within 0.01); then H 32 / encoder (16, 24) on
     waypoint/rk4 with a ragged last lane tile (8,232 lanes: 40 of the
     last 64-lane tile), H 36 / encoder (36,) (the gate block's units and
     input rows padded to 40; 4,132 lanes, ragged too) and H 12 with no
     encoder on racing/euler (4,096 lanes), T = 3. The gate block runs on the tensor cores in 3xTF32
     (csrc/lstm_mma.cuh); each T = 3 case launched twice, bitwise equal.
 13. K6 (the same kernel, training) against its plain version at 65,536
     lanes: T = 3 with bptt 1 (3 anchors), both action modes, planes,
     anchors and the final carry within rtol 2e-5 / atol 2e-6; T = 128,
     bptt 16, stochastic, statistically.
 14. K7 (csrc/update_lstm.cu) against its plain version on the full-width
     minibatch of the reference's recurrent geometry (16 row blocks of
     1,024 lanes x 128 steps, bptt 16, planes and anchors from K6, at
     least 0.1% of its samples ending an episode inside a segment): each
     gradient tensor and the stat sums within 1e-4 x its max |value|, at
     the planes' own weights and at weights moved off them (every branch of
     the head's subgradients taken, each stat sum held on its own, KL and
     clip fraction nonzero); two launches bitwise equal; then on small
     minibatches (2,048 envs x 32 steps) at the shapes the gate block pads,
     H 36 / encoder (20, 36) and H 12 with no encoder. The gate block, its
     input gradient and the weight-gradient products run on the tensor
     cores in 3xTF32. K4 over the LSTM's 19 tensors against its plain
     version, rtol 1e-5.
 15. The LSTM serving path: `evaluate(episodes=65536)` and `cli eval` on
     hover.toml with run.policy=lstm (K8 twice); evaluate(512) on the card
     against the CPU.
 16. The LSTM training path: `train` at the reference's recurrent geometry
     (hover.toml + run.policy=lstm train.horizon=128 train.bptt_horizon=16
     train.num_minibatches=4) for 3 updates (K6 = 3, K7 = K4 = 48), then
     `cli train` for 2 and `cli eval` of its checkpoint.
 17. The LSTM learning gate (H 32, encoder (32,), 256 envs, horizon 32, bptt
     16, lr 5e-3, no entropy bonus, one run from seed 0: the mean reward of
     the last 5 of 100 updates beats the first 5 by 0.15, parameters
     finite) and train(4) == train(2) + resume(2) bitwise, carry included.
 18. Times of K8, K6 and K7 beside their plain versions and bounds (the
     tensor-pipe bound, the gate block's and K7's products at the 3xTF32
     rate and the rest at the fp32 rate, the fp32 bound beside it; the gate
     fragments' L2 bytes; K7's bound with its scratch's bytes), and one
     full-width LSTM update split and traced as in 11 (K7 by its kernels:
     gate packing, walk, products, reduction).
 19. K11 (csrc/acting_cnn.cu, serving; the tower's products on the tensor
     cores in 3xTF32, csrc/cnn_mma.cuh) against its fp32 plain version:
     hover, the PatchCNNActorCritic defaults (24x24x4 render, conv0 4x4/4
     -> 64, conv1 2x2/2 -> 64, trunk 128), 65,536 lanes, T = 3
     (deterministic and with K9's noise) within rtol 2e-5 / atol 2e-6 on
     the final state and the per-lane statistics with episode counts
     equal, and T = 64 statistically; then waypoint/rk4 with a ragged last
     lane tile (8,232 lanes: 40 of the last 64-lane tile), T = 3. Each T = 3 case launched twice,
     bitwise equal.
 20. K9 (the same kernel, training) against its plain version at 65,536
     lanes: T = 3 in both action modes, all 21 planes and the final state
     within rtol 2e-5 / atol 2e-6, two launches bitwise equal; T = 128
     stochastic, statistically.
 21. K10 (csrc/update_cnn.cu; the tower's products on the tensor cores in
     3xTF32, csrc/cnn_mma.cuh) against its fp32 plain version on the
     full-width minibatch of the reference's CNN geometry (16 row blocks of
     1,024 lanes x 128 steps, planes from K9): each gradient tensor and the stat
     sums within 1e-4 x its max |value|, at the planes' own weights and at
     weights moved off them (every branch of the head's subgradients on at
     least 0.1% of the samples, each stat sum held on its own); two launches
     bitwise equal. K4 over the CNN's 11 tensors against its plain version,
     rtol 1e-5.
 22. The CNN serving path: `evaluate(episodes=65536)` and `cli eval` on
     hover.toml with run.policy=cnn from a Checkpointer checkpoint (K11
     twice); evaluate(512) on the card against the CPU.
 23. The CNN training path: `train` at the reference's CNN geometry
     (hover.toml + run.policy=cnn train.horizon=128
     train.num_minibatches=4) for 3 updates (K9 = 3, K10 = K4 = 48), then
     `cli train` for 2 and `cli eval` of its checkpoint.
 24. The CNN learning gate (4,096 envs, horizon 32, 2 epochs x 2
     minibatches, lr 1e-3, no entropy bonus, 150 updates, one run from each
     of seeds 0-3: in every run a 10-update mean of the value loss below
     half that of updates 3-12, the mean reward of the last 10 above the
     first 10, parameters finite; the rise's mean over the runs above 0.2)
     and train(4) == train(2) + resume(2) bitwise.
 25. Times of K11, K9, K10 and K4 over the CNN layout beside their plain
     versions, bounds and (K4) library pair, and one full-width CNN update
     split and traced as in 11 (K10 by its kernels: tower forward, tower
     backward, products, reduction). The bounds of K11, K9 and K10 are the
     tensor-pipe ones (the tower's products at the 3xTF32 rate, the rest
     at the fp32 rate), their fp32 bounds beside them.
 26. evaluate() on the card serves what its acting kernels cannot take
     through the module, as the reference serves every policy it builds:
     hover.toml with run.hidden=[256, 256] (past K5's shared memory), and
     run.lstm_hidden=256 for the LSTM and the CNN-LSTM (past K8's hidden),
     1,024 lanes x 201 steps each, finite statistics with the K5 and K8
     launch counts 0;
     build() trains the MLP [256, 256] (past K2 and K3) on the scan
     trainer and refuses it under run.rollout=pallas.
 27. K8's CNN arm (the pixel-recurrent cnn_lstm: CNNLSTMActorCritic's
     default tower, 24x24x4 render, conv0 4x4/4 -> 64, conv1 2x2/2 -> 64,
     trunk 128, into an LSTM of hidden 128; the tower and the gate block on
     the tensor cores in 3xTF32, csrc/lstm_mma.cuh) against its fp32 plain
     version as in 12: hover, 65,536 lanes from a random carry, T = 3
     within rtol 2e-5 / atol 2e-6 and T = 64 statistically; waypoint/rk4
     with a ragged last tile (8,232 lanes), T = 3; hidden 36 (its gate
     block padded to 40 units), 4,132 lanes (ragged too), T = 3. Each T = 3 case
     launched twice, bitwise equal (as in 12, 13 and 28).
 28. K6's CNN arm against its plain version as in 13, at 65,536 lanes.
 29. K7's CNN arm (the tower's forward and backward on the tensor cores in
     3xTF32, out of the walk through time) against its fp32 plain version
     as in 14 on the full-width minibatch of the cnn_lstm geometry (planes
     and anchors from K6's CNN arm), on-policy and off-policy with every
     branch, two launches bitwise equal; K4 over the 23 tensors (226,697
     parameters), rtol 1e-5.
 30. The cnn_lstm serving path (`evaluate(episodes=65536)` and `cli eval`
     from a Checkpointer checkpoint, K8's CNN arm twice; evaluate(512) on
     the card against the CPU) and training path (`train` at hover.toml +
     run.policy=cnn_lstm train.horizon=128 train.bptt_horizon=16
     train.num_minibatches=4 for 3 updates: K6 = 3, K7 = K4 = 48, all on
     the CNN arms; `cli train` for 2 and `cli eval` of its checkpoint).
 31. The cnn_lstm learning gate (2,048 envs, horizon 32, bptt 16, 2 epochs
     x 2 minibatches, lr 2e-3, no entropy bonus, 150 updates, one run from
     each of seeds 0-3: in every run the lowest 10-update mean of the value
     loss below 0.75 of that of updates 3-12, the mean reward of the last 10
     above the first 10, parameters finite; the rise's mean over the runs
     above 0.2) and train(4) == train(2) + resume(2) bitwise, carry
     included.
 32. Times of the CNN arms of K8, K6 and K7 and of K4 over their layout
     beside their plain versions and bounds (both bounds, as 18), and one
     full-width cnn_lstm update split and traced as in 11 (K7 by its
     kernels: gate and tower packing, tower forward, walk, tower backward,
     products, reduction).
 33. K4 past 524,288 parameters (each of its 256 blocks several slices of
     2,048 floats): at 1,200,000 against its plain version as in 8 (rtol
     1e-5, clip active and inactive, two launches bitwise equal); and at
     the MLP's, the LSTM's, the CNN's and the CNN-LSTM's parameter counts
     bitwise equal to the parent commit's K4 (sha256 of its outputs on
     numpy-seeded inputs, K4_PARENT_DIGESTS, from scripts/k4_digests.py).
 34. Each scan trainer's update on the card against the same update on
     the CPU (the plain versions) from the same weights, env state, noise
     and permutations (numpy-seeded): the MLP ([64, 64], 1,024 envs x 8
     steps, 2 x 2 minibatches) with shuffle="lanes", then "flat" with
     grad_accum 2; the LSTM scan tier and the hybrid tier (K6 against its
     plain version carrying the rollout; H 32, encoder (32,), 512 envs,
     bptt 4); cnn_overlap (PixelActorCritic, 256 envs, grad_accum 2).
     Every parameter tensor and its slices of mu and nu within 1e-4 x its
     max |value|, the metrics likewise (one vector; episodes equal); each
     update run twice on the card, bitwise equal.
 35. The scan paths through `cli train` on hover.toml (launch counts zeroed
     before each, read after): run.rollout=scan, 3 updates (K4 = 96, K2 =
     K3 = 0); run.policy=cnn_overlap train.grad_accum=16, 2 updates (K4 =
     64, no CNN kernel); run.policy=lstm train.num_envs=65280 (510 rows of
     128 that do not split into 8 minibatches of whole rows: the hybrid
     tier), 1 update (K6 = 1, K4 = 32, K7 = 0); under run.rollout=auto,
     run.hidden=256,256 and run.policy=lstm run.lstm_hidden=256, 1 update
     each on the scan trainers (K4 = 32, no other kernel); `cli eval` of
     each checkpoint (K5, the module, K8, the module, the module).
 36. Resume on the card: train(2) == train(1) + resume(1) bitwise for the
     MLP scan trainer and cnn_overlap, both generators' states included;
     a megakernel checkpoint restored under run.rollout=scan and the
     reverse, parameters, moments and count bitwise as saved, then one more
     update each.
 37. One hover.toml scan update split into rollout, GAE, update and
     metrics (CUDA events at make_train_step's marks, the host clock, the
     host syncs it makes), and traced as in 11 for the idle share.
 38. The trainer-equivalence gate (tests/test_trainer_equivalence.py's
     sizes, thresholds and seeds 0 and 1): the scan and the megakernel
     trainer of the MLP, the CNN (the default PatchCNNActorCritic, the only
     architecture K9 and K10 take, at lr 1e-3) and the LSTM cross the same
     hover threshold within 1.5x of each other's mean update budget; the
     12 runs in 6 processes at once. A failure stops no later phase, as in
     10, 17, 24 and 31.
 39. The bench path's kernels at the bench's own shapes, against their
     plain versions at their checks' tolerances (phase_bench_shapes): K1
     bitwise with in-kernel actions, K5, K8's both arms, K11 and K2 at
     131,072 lanes (T = 32 over 20-step episodes for K1, T = 3 for the
     rest), K2 at 262,144 lanes, and one train_sps_262k minibatch (262,144
     envs x 128 steps, 4 minibatches: 8.4 M samples) through K3, off the
     weights that wrote it with every branch taken, and its gradients
     through K4. The maxima join the kernels line's max_abs_err.
 40. The bench path: `cli bench configs/hover.toml` in-process (the
     reference's phases and shapes, drone_tpu_torch/bench.py), with the
     launch counts zeroed just before and read just after: K1-K11 and the
     CNN arms of K6, K7 and K8 must each launch; its JSON line must hold
     the reference's keys and "device", every phase (the four scan_*
     training phases, the scan trainers at the reference's shapes, among
     them) a positive finite rate. Its seconds are printed. One timed
     repeat a phase after the warm-up (`cli bench` itself takes three).
 41. K2's bf16 arm (run.compute_dtype=bfloat16: every product's operands
     rounded to bf16 once, cvt.rn.bf16x2.f32, m16n8k16 products of bf16
     rows and bf16x2 weight fragments, sums in fp32) against its bf16
     plain version on the card by H12's
     rule (BF16_*: at least 98% of the T = 3 planes and final state within
     rtol 2e-5 / atol 2e-6, every value within 0.02, the planes' mean
     difference under a tenth of the kernel's to the fp32 plain version),
     episodes equal, each T = 3 case launched twice, bitwise equal: hover
     [64, 64] at 65,536 lanes in both action modes and T = 64
     statistically, waypoint/rk4 over a ragged last block and at [32, 48,
     20] (three layers, widths padded to 16), [128, 128] with its
     fragments staged and read through L1, and a linear policy.
 42. K3's bf16 arm (m16n8k16 products of operands stored once as bf16, db
     the fp32 sum of dY) by H12's rule for updates (each gradient tensor
     and the stat sums within 1e-2 of the tensor's max, the mean gradient
     difference under a tenth of the fp32 plain version's), two launches
     bitwise equal: hover.toml's minibatch on K2 bf16's planes at their
     weights (no ratio outside 1 +- clip_eps) and off them (every branch
     taken), on chip; [128, 128] off chip.
 43. K9's bf16 arm at 65,536 lanes (T = 3 both action modes by H12's rule,
     T = 32 statistically) and K11's, the same instantiation, at T = 3.
 44. K10's bf16 arm as 42, on K9 bf16's planes at the CNN geometry's
     full-width minibatch, at their weights and off them.
 45. The bf16 paths: `cli train` under run.compute_dtype=bfloat16 on
     hover.toml (3 updates: K2 = 3, K3 = K4 = 96) and at the CNN geometry
     (2 updates: K9 = 2, K10 = K4 = 32), each launch of K2, K3, K9 and K10
     their bf16 arm's (`bf16_launches`), none an fp32 arm's; `cli eval` of
     each checkpoint through the module, as the reference serves a bf16
     policy (no acting kernel).
 46. The bf16 learning gates by the fp32 gates' rules (the MLP's one run,
     phase 10's; the CNN's four, phase 24's); train(4) == train(2) +
     resume(2) bitwise under bfloat16, MLP and CNN.
 47. Times of the bf16 arms beside their fp32 arms' in the same call, their
     bf16 plain versions and bounds (the products at the bf16 rate, 989
     TFLOP/s, the rest at the fp32 rate); one bf16 MLP and one bf16 CNN
     update split and traced as in 11.
 48. run.profile_dir: `cli train` under bfloat16 for 6 updates writes the
     trace of updates 3-5, which must hold K3's 96 launches.
 49. K7's bf16 arm (run.compute_dtype=bfloat16 on the recurrent trainer:
     every product's operands rounded to bf16, the gate block, [dx; dh],
     the weight products and the CNN arm's tower one TF32 product a
     k-step, the dense encoder, the heads and dh' on the fp32 cores with
     the weights rounded once a call) against its bf16 plain version by
     H12's rule for updates (as 42: each gradient tensor and the stat sums
     within 1e-2 of the tensor's max, the mean difference under a tenth of
     the fp32 plain version's), two launches bitwise equal, on the
     full-width minibatch of the recurrent geometry (planes and anchors
     from K6 in fp32, as the path writes them): at their weights and off
     them (every branch taken); the dense arm, then the CNN arm.
 50. The bf16 recurrent paths: `cli train` under run.compute_dtype=bfloat16
     of run.policy=lstm and cnn_lstm at the recurrent geometry (2 updates
     each: K6 = 2 in fp32, K7 = K4 = 32, every K7 launch the bf16 arm's),
     `cli eval` of each checkpoint through K8 (fp32, as the reference).
 51. The bf16 recurrent learning gates by the fp32 gates' rules (the
     LSTM's one run, phase 17's; the cnn_lstm's four, phase 31's);
     train(4) == train(2) + resume(2) bitwise under bfloat16, carry
     included, LSTM and CNN-LSTM.
 52. Times of K7's bf16 arm, both encoders, beside its fp32 arm's in the
     same call, its bf16 plain version and its bound (the products at the
     bf16 rate); one bf16 LSTM and one bf16 cnn_lstm update split and
     traced as in 11.
 53. The env adapters (the plain env on the card; no kernel): each of
     VecDrone (backend jit, and the partial-batch protocol at 2
     sub-batches), DroneVectorGymnasium, DroneSwarmParallel and
     DroneGymnasium (one lane) on the card and on the CPU from the same
     seed and numpy action stream, bitwise: hover/euler at 4,096 lanes,
     waypoint/rk4 and racing/rk4 at 256, 64 steps over episodes of at most
     24; both backends at 8 lanes x 32 steps, bitwise to each other. It prints
     whether gymnasium's classes or the fallbacks ran. send() is queued
     under torch's host-sync check (sync and partial batch), and VecDrone's
     steps/s at 65,536 lanes is printed beside the card's name and power
     limit.
 54. Export to the C runtime: native/libdronenet.so and native/drone_demo
     built with cc and native/Makefile's CFLAGS into build/native/; one
     checkpoint of each family (MLP [64, 64], LSTM 128 / (64,), the default
     patch CNN and CNN-LSTM) exported to DRNW and run by the C forward
     (ctypes) against the module's forward on the card at the reference
     tests' tolerances (rtol 1e-5 / atol 1e-6 feed-forward, 2e-5 / 2e-6
     LSTM, 2e-5 / 2e-5 CNN-LSTM over 12 steps that carry the state).
 55. Racing end to end: `cli train configs/racing.toml
     run.total_updates=2` (racing/rk4, 16,384 envs; K2 = 2, K3 = K4 = 64,
     finite losses), `cli export`, and the C demo for one racing/rk4
     episode (exit 0, a finite trajectory.csv that ends its episode, the
     four gates read back from the .params file equal to
     default_params("racing")'s).
 56. The sweep: `cli sweep configs/sweep_hover.toml --device cuda` in full
     (8 trials of 60 updates, the best 4 for 200 more; 4,096 envs, MLP
     [32, 32], the megakernel trainer): every trial's score finite (a
     caught failure scores -inf), each trial's launches zeroed before it
     and read after it (K2 once an update, K3 and K4 once an SGD step);
     `--resume` on the finished journal trains nothing; a 2-trial sweep of
     one 10-update rung under suggester="random" gives bitwise the same
     scores with workers=2 (spawned processes on the card) as with
     workers=1.
 57. The autotuner: `cli autotune configs/hover.toml --device cuda --iters
     1`: every candidate of candidate_shapes measured (15 shapes, 16,384
     to 262,144 envs x 2, 4 or 8 minibatches), none failed, each on the
     megakernel trainer (K2 twice a candidate); the ranked list printed.
 58. The watch rollout (`viewer.watch_rollout`, `cli watch` without its
     render) on the card, 200 steps: mlp on racing/rk4 (its four gates),
     lstm and cnn_lstm on hover with episodes of 60 steps. Finite CSVs with
     the reference's header; the recurrent rows equal to the evaluation
     path's (the carry zeroed at each done); the first 40 rows against a
     CPU watch rollout of the same checkpoint (done equal, positions within
     1e-3). A PNG when matplotlib imports.
 59. A NCCL process group of one rank on the card: two sharded updates
     (parallel.make_sharded_train_step: advantage moments, each SGD step's
     gradient and the metrics through all_reduce) bitwise equal to two
     undistributed updates in parameters, optimizer state, env state and
     metrics, for the MLP megakernel trainer at hover.toml, the CNN (8,192
     envs x 32) and LSTM (16,384 x 32, bptt 16) megakernel trainers, the
     hybrid tier (16,256 lanes) and the scan trainer (8,192 x 32); one
     more sharded MLP update queued under set_sync_debug_mode("error").
 60. Two ranks sharing the card over Gloo (NCCL refuses two ranks on one
     device): `python -m drone_tpu_torch.parallel._smoke_worker` twice,
     through train.build on hover.toml's widths and horizon at 16,384 lanes
     a rank. Two updates of its geometry: the same loss and approx-KL bit
     for bit, each rank on the megakernel trainer with K2 2, K3 and K4 64
     launches. One update of one epoch of one minibatch with the clip off:
     each rank's parameters, optimizer state and metrics allclose (rtol
     2e-5, atol 1e-7; metrics 1e-6) to one undistributed update of the
     32,768-lane global batch on the card, the lanes bitwise.
 61. ops.sharded's K1 and K5 in the group of phase 59 (65,536 lanes x 256
     steps): bitwise the unsharded kernels in final state and statistics.

Launch counts: each wrapper counts its launches; the recurrent wrappers
(K6, K7, K8) also count their CNN arm's alone (`cnn_launches`), and K2,
K3, K7, K9, K10 and K11 their bf16 arm's (`bf16_launches`).

The kernels JSON's launches add phases 56-61's to each kernel's count.
The second-to-last line is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import collections
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's peaks used for bound_ms (NVIDIA H100 SXM data sheet, dense):
# 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores. 67 TFLOP/s
# counts a fused multiply-add as 2 operations: 132 SMs x 128 lanes x 2 x
# 1.98 GHz. Every bound but K1's divides operations counted that way by it.
# K1 builds with --fmad=false, so each of its adds and multiplies is an
# instruction of its own, IEEE division and sqrt are sequences of several,
# and its threefry words are integer instructions, which run at half the
# fp32 rate. Its bound counts arithmetic instructions instead
# (k1_instruction_bound): every fp32, int32 and MUFU instruction at 128 a
# clock an SM (INSTR_PER_S), and the int32 ones alone at 64 a clock an SM
# (INT32_PER_S; the CUDA C++ Programming Guide's throughput table for
# compute capability 9.0). The old operation count at 67 TFLOP/s is printed
# beside it.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INSTR_PER_S = 33.5e12
INT32_PER_S = 16.7e12
# The tensor cores' TF32 rate (495 TFLOP/s dense); a 3xTF32 product takes
# three TF32 products for one fp32-accurate one: 165 TFLOP/s.
MMA_3XTF32_OPS_PER_S = 495e12 / 3

# Probe kernels for K1's instruction counts, built with K1's nvcc flags
# (k1_instructions): one lane-step of its main path (hover, Euler, in-kernel
# actions; the env params as a kernel argument, so they are operands and not
# loads), one block of a reset's draws, hover's reset tail, one IEEE
# division and one sqrt; probe_base holds their common set-up
K1_PROBE_CU = r"""
#include <cstdint>
#include "env.cuh"
using namespace drone;
struct ProbeIn { Carry c; Fresh f; float acc[N_STATS]; };
struct ProbeOut { Carry c; Fresh f; float acc[N_STATS]; };
extern "C" __global__ void probe_base(const ProbeIn* in, ProbeOut* out,
                                      EnvP P) {
  const int i = threadIdx.x;
  out[i].acc[0] = in[i].acc[0];
}
extern "C" __global__ void probe_step(const ProbeIn* in, ProbeOut* out,
                                      EnvP P) {
  const int i = threadIdx.x;
  Carry c = in[i].c;
  const Fresh f = in[i].f;
  float acc[N_STATS];
  for (int k = 0; k < N_STATS; ++k) acc[k] = in[i].acc[k];
  float a0, a1, a2, a3, r, epret2;
  bool done;
  int step2;
  stream_actions(c.k0, c.k1, c.rc, c.stp, a0, a1, a2, a3);
  Advance v;
  env_advance<TASK_HOVER, INTEG_EULER>(c, a0, a1, a2, a3, P, v, r, done,
                                       epret2, step2);
  env_select(c, v, f, done, epret2, step2);
  accumulate(acc, r, done, epret2, step2);
  out[i].c = c;
  for (int k = 0; k < N_STATS; ++k) out[i].acc[k] = acc[k];
}
extern "C" __global__ void probe_block(const ProbeIn* in, ProbeOut* out,
                                       EnvP P) {
  const int i = threadIdx.x;
  fresh_uniforms(in[i].c.k0, in[i].c.k1, in[i].c.rc, in[i].c.wp,
                 out[i].acc[0], out[i].acc[1]);
}
extern "C" __global__ void probe_tail(const ProbeIn* in, ProbeOut* out,
                                      EnvP P) {
  const int i = threadIdx.x;
  float u[14];
  for (int j = 0; j < 13; ++j) u[j] = in[i].f.s[j];
  u[13] = in[i].f.tx;
  Fresh f;
  fresh_from_uniforms<TASK_HOVER>(u, P, f);
  out[i].f = f;
}
extern "C" __global__ void probe_div(const ProbeIn* in, ProbeOut* out,
                                     EnvP P) {
  const int i = threadIdx.x;
  out[i].acc[0] = in[i].acc[0] / in[i].acc[1];
}
extern "C" __global__ void probe_sqrt(const ProbeIn* in, ProbeOut* out,
                                      EnvP P) {
  const int i = threadIdx.x;
  out[i].acc[0] = sqrtf(in[i].acc[0]);
}
"""
# The SASS opcodes K1's bound counts: fp32 arithmetic (with the IEEE
# division's range check and the conversions) and MUFU, and int32
# arithmetic (the throughput table's integer add, multiply-add, shift,
# logic, compare and select rows; IMAD.MOV is a move). Everything else
# (moves, byte permutes, predicate logic, branches and convergence
# barriers) is left out of the bound and tallied beside it; the memory and
# uniform-datapath instructions are not looked at.
FP32_OPS = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSETP",
            "FSEL", "FMNMX", "FSET", "FCHK", "FRND", "MUFU", "I2F", "I2FP",
            "F2I", "F2IP", "F2F"}
INT32_OPS = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF",
             "SHL", "SHR", "IMAD", "IMAD32I", "IMUL", "LEA", "ISETP", "SEL",
             "IMNMX", "VIMNMX", "IABS", "POPC", "FLO", "BREV", "BMSK",
             "VIADD"}
UNCOUNTED_OPS = {"LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "LDL", "STL",
                 "S2R", "CS2R", "S2UR", "NOP"}


def sass_fast_path(lines) -> list:
    """The opcodes of one function's SASS (cuobjdump -sass lines), with
    their modifiers, in the order it runs them up to its EXIT, every
    predicated branch taken: the IEEE division's and sqrt's fast paths jump
    over the calls of their slow ones. Memory, uniform-datapath and
    special-register instructions are left out."""
    ops, skip = [], None
    for line in lines:
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            skip = None if label.group(1) == skip else skip
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not ins:
            continue
        if skip is not None and skip != int(ins.group(1), 16):
            continue
        skip = None
        text = ins.group(2)
        words = text.split()
        if words[0].startswith("@"):
            words = words[1:]
        op = words[0].split(".")[0]
        if op == "EXIT":
            break
        target = re.search(r"(\.L_x_\d+)|BRA\s+(0x[0-9a-f]+)", text)
        if op == "BRA" and text.startswith("@") and target:
            skip = target.group(1) or int(target.group(2), 16)
        if op in UNCOUNTED_OPS or op.startswith("U"):
            continue
        ops.append(words[0])
    return ops


def arithmetic(op) -> str | None:
    """"fp32" or "int32" for an opcode K1's bound counts, else None."""
    base = op.split(".")[0]
    if base in FP32_OPS:
        return "fp32"
    if base in INT32_OPS and not op.startswith("IMAD.MOV"):
        return "int32"
    return None


def k1_instructions() -> tuple:
    """({probe: (arithmetic instructions, of them int32)} of K1's probe
    kernels beyond probe_base's, {probe: {opcode: count}} of the
    instructions left out), from cuobjdump -sass of K1_PROBE_CU built with
    K1's nvcc flags (sass_fast_path, arithmetic)."""
    from drone_tpu_torch.ops import cuda_build

    nvcc = cuda_build.nvcc_path()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "k1_probe.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(K1_PROBE_CU)
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-cubin", f"-I{cuda_build.CSRC}", "-o",
                    str(cubin), str(src)], check=True, timeout=300,
                   capture_output=True, text=True)
    tool = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cubin)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name:
            funcs[name].append(line)
    counts, left_out = {}, {}
    for fn, lines in funcs.items():
        kinds = [(op, arithmetic(op)) for op in sass_fast_path(lines)]
        counts[fn] = (sum(k is not None for _, k in kinds),
                      sum(k == "int32" for _, k in kinds))
        left_out[fn.removeprefix("probe_")] = dict(collections.Counter(
            op for op, k in kinds if k is None))
    base = counts.pop("probe_base")
    return ({fn.removeprefix("probe_"): (n - base[0], k - base[1])
             for fn, (n, k) in counts.items()}, left_out)


def k1_instruction_bound(instr, lane_steps, resets, nbytes):
    """K1's bound at the main path's hover/euler: (ms, what sets it, its
    arithmetic instructions, of them int32), the larger of its arithmetic
    instructions over INSTR_PER_S, its int32 ones over INT32_PER_S and its
    bytes over the HBM rate. A lane-step is probe_step; a reset, counted
    only for the lane-steps that end an episode, 7 blocks and hover's
    tail."""
    per_reset = [7 * b + t for b, t in zip(instr["block"], instr["tail"])]
    total = lane_steps * instr["step"][0] + resets * per_reset[0]
    ints = lane_steps * instr["step"][1] + resets * per_reset[1]
    times = {"arithmetic instructions": total / INSTR_PER_S,
             "int32 instructions": ints / INT32_PER_S,
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, total, ints


# Operations of the hover/euler paths, counted from csrc/env.cuh and the
# kernels (one op per add, mul, div, sqrt, compare, select, shift, xor or
# rotate; a multiply-add counts 2). A threefry block is 79 integer ops (2
# key adds, 20 rounds of add/rotate/xor, 5 key injections of 3 adds, the
# parity word), a uniform 3 more.
_TF, _UNI = 79, 3
# every lane-step: mix 25, euler deriv + update 119, normalize 12, reward 33,
# termination 20, state select 25, statistics 9
OPS_STEP = 243
# a reset, needed only by lanes that ended an episode: 7 blocks + init_pose
OPS_RESET = 7 * (_TF + 2 * _UNI) + 60
OPS_RANDOM_ACTIONS = 2 + 2 * _TF + 4 * (_UNI + 2)
OPS_OBS = 3


# K2's exploration noise and log-prob per lane-step: 2 threefry blocks, 4
# uniforms, 2 logs, 2 sqrts, 4 sines/cosines and their 6 products, then
# 4 x (mul, add, sub, div, mul, mul, sub, sub) and 3 adds
OPS_NOISE_LOGP = 2 * _TF + 4 * _UNI + 14 + 35
# K3's PPO head per sample (_head_grads: z, logp, ratio, the clipped
# surrogate and value loss, their subgradients, dm, g_v and 8 stats)
OPS_PPO_HEAD = 110


def tower_ops(hidden, n_head: int = 4) -> int:
    """Multiply-adds x2 + bias adds + one per tanh of a tower."""
    dims = [13, *hidden, n_head]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2 * macs + sum(dims[1:]) + sum(hidden)


def update_ops(hidden) -> int:
    """Operations of one sample through K3: both towers forward, the head,
    and backward: dW and db of every layer, and for every layer but the
    first the input gradient and the tanh derivative (3 ops a unit)."""
    ops = tower_ops(hidden, 4) + tower_ops(hidden, 1) + OPS_PPO_HEAD
    for n_head in (4, 1):
        dims = [13, *hidden, n_head]
        for layer, (nin, nout) in enumerate(zip(dims[:-1], dims[1:])):
            ops += 2 * nin * nout + nout
            if layer > 0:
                ops += 2 * nin * nout + 3 * nin
    return ops


def tower_mma_ops(hidden, n_head: int = 4) -> int:
    """The part of tower_ops on the tensor cores in K5, K2 and K3: the
    products' multiply-adds x2."""
    dims = [13, *hidden, n_head]
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def update_mma_ops(hidden) -> int:
    """The part of update_ops on the tensor cores in K3: both towers'
    forward products, dW and db (db as a product with ones), and dX of
    every layer but the first."""
    ops = 0
    for n_head in (4, 1):
        dims = [13, *hidden, n_head]
        ops += tower_mma_ops(hidden, n_head)
        for layer, (nin, nout) in enumerate(zip(dims[:-1], dims[1:])):
            ops += 2 * nin * nout + 2 * nout
            if layer > 0:
                ops += 2 * nin * nout
    return ops


def bound(ops, nbytes):
    """(the least time in ms the card could take, what sets it): the larger
    of the operations over the fp32 rate and the bytes over the HBM rate."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tensor_bound(mma_ops, other_ops, nbytes):
    """The bound of a kernel whose matrix products run on the tensor cores
    in 3xTF32 (every kernel but K1 and K4): (the least time in ms, what
    sets it), the larger of the products at the 3xTF32 rate plus the rest
    at the fp32 rate, and the bytes over the HBM rate."""
    t_ops = mma_ops / MMA_3XTF32_OPS_PER_S + other_ops / FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_label(name, keys):
    """The label of the mangled entry function `name`: the first of keys it
    holds, or None. The encoder arm of a template whose last parameter is
    it (lstm_act_kernel), or whose last but one is it before the bf16 flag
    (bptt_kernel), is named <dense> or <cnn>, and the walk's bf16 arm <dense,
    bf16> or <cnn, bf16>; a key holding a template's first arguments picks
    one instance (the acting kernels' "ILi0ELi0E": hover, euler)."""
    entry = next((k for k in keys if k in name), None)
    arm = re.search(r"Li(\d+)E(?:Lb([01])E)?EEv", name)
    if entry and arm and ("bptt_kernel" in entry
                          or "lstm_act_kernel" in entry):
        label = entry.split("I")[0] if "ILi" in entry else entry
        enc = "cnn" if arm.group(1) == "1" else "dense"
        entry = f"{label}<{enc}{', bf16' if arm.group(2) == '1' else ''}>"
    return entry


def ptxas_report(lib, keys) -> dict:
    """{kernel: (registers, spill line)} from a library's ptxas log, for the
    entry functions kernel_label names."""
    out, entry = {}, None
    for line in lib.with_suffix(".so.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = kernel_label(line.split("'")[1], keys)
        elif entry and "spill stores" in line:
            out[entry] = (None, line.strip())
        elif entry and "Used " in line:
            out[entry] = (int(line.split("Used ")[1].split()[0]),
                          out.get(entry, (None, ""))[1])
    return out


def mma_counts(lib, keys) -> dict:
    """{kernel: its tensor-core instructions (HMMA, the SASS of mma.sync)}
    in a library's machine code (cuobjdump -sass, beside nvcc), for the
    entry functions kernel_label names."""
    from drone_tpu_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, entry = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            entry = kernel_label(line.split("Function :")[1].strip(), keys)
            if entry:
                out[entry] = 0
        elif entry and "HMMA" in line:
            out[entry] += 1
    return out


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bitwise_equal(a, b) -> bool:
    import torch

    a, b = a.contiguous().cpu(), b.contiguous().cpu()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_repeat(name, first, again):
    """Two launches of a kernel on the same inputs (their outputs as
    tuples of tensors) bitwise equal, or raise."""
    if not all(bitwise_equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"two {name} launches on the same inputs differ")


def planes(state, lane_stats):
    from drone_tpu_torch.ops import cuda_rollout

    return [*cuda_rollout.pack_state(state), lane_stats]


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean time of `fn` over `reps` back-to-back calls, by CUDA events,
    after one warm-up call (none for a call of seconds that its check has
    already made at the same shapes)."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# K1's checks: (task, integrator, lanes, T, horizon or None for the
# task's default, action modes). Episodes of 20 steps end whole warps on
# one step (truncation; the warp's reset passes repeat); 2,061 lanes end in
# a ragged warp and three warps past n; the default horizon with in-kernel
# actions ends episodes on scattered steps within each warp
K1_CASES = (
    *[(task, integ, 65536 if (task, integ) == ("hover", "euler") else 2048,
       32, 20, ("provided", "in-kernel"))
      for task in ("hover", "waypoint", "racing")
      for integ in ("euler", "rk4")],
    *[(task, integ, 2061, 32, 20, ("provided", "in-kernel"))
      for task in ("hover", "waypoint", "racing")
      for integ in ("euler", "rk4")],
    ("hover", "euler", 2048, 256, None, ("in-kernel",)),
    ("waypoint", "rk4", 2048, 256, None, ("in-kernel",)),
)


def phase_k1(cases=K1_CASES):
    """K1 against its plain version; returns the largest difference (0.0)."""
    import torch

    from drone_tpu_torch import prng
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_rollout
    from drone_tpu_torch.types import default_params

    # the plain version on the CPU is the slow part: the main path's width
    # for hover/euler, a smaller one for the other cases, and every lane
    # through at least one reset
    for task, integ, n, T, horizon, modes in cases:
        # a wide reach radius so waypoint/gate progression fires; domain
        # randomization on
        over = dict(dr_mass_lo=0.8, dr_mass_hi=1.2, dr_thrust_lo=0.9,
                    dr_thrust_hi=1.1)
        if horizon is not None:
            over["horizon"] = horizon
        if task != "hover":
            over["reach_tol2"] = 4.0
        env = DroneEnv(task, integ, default_params(task, **over),
                       device="cuda")
        state = env.init_batch(11, n)
        stream = torch.from_numpy(
            prng.action_stream_np(T, n, seed=3, scale=0.9, bias=0.05))
        plain_provided = None
        for mode in modes:
            acts = stream if mode == "provided" else None
            args = (state, env.params, env.statics, T,
                    None if acts is None else acts.cuda())
            k_state, k_stats = cuda_rollout.rollout_kernel(*args)
            again = planes(*cuda_rollout.rollout_kernel(*args))
            torch.cuda.synchronize()
            plain = planes(*cuda_rollout.rollout_plain(
                state.to("cpu"), env.params.to("cpu"), env.statics, T,
                acts))
            ok = all(bitwise_equal(a, b) for a, b in
                     zip(planes(k_state, k_stats), plain))
            episodes = float(k_stats[1].sum())
            print(f"K1 {task}/{integ} n={n} T={T} horizon="
                  f"{int(env.params.horizon)} {mode} actions: bitwise={ok} "
                  f"episodes={episodes:.0f}", flush=True)
            if not ok:
                raise AssertionError(f"K1 differs from its plain version "
                                     f"({task}/{integ}, n={n}, T={T}, "
                                     f"{mode})")
            check_repeat("K1", planes(k_state, k_stats), again)
            if episodes < n:
                raise AssertionError("K1 check exercised too few resets")
            if acts is not None:
                plain_provided = plain
        if plain_provided is None:
            continue
        on_card = planes(*cuda_rollout.rollout_plain(
            state, env.params, env.statics, T, stream.cuda()))
        ok = all(bitwise_equal(a, b)
                 for a, b in zip(on_card, plain_provided))
        print(f"plain env on the card == on the CPU ({task}/{integ}): "
              f"{ok}", flush=True)
        if not ok:
            raise AssertionError("the plain env differs between the card "
                                 "and the CPU")
    return 0.0


def seeded_policy(hidden=(64, 64), seed=0, head_gain=None):
    import torch
    from torch import nn

    from drone_tpu_torch.models import ActorCritic

    g = torch.Generator().manual_seed(seed)
    m = ActorCritic(hidden, generator=g)
    if head_gain is not None:
        # actions of order 1, so the comparison exercises the tower
        nn.init.orthogonal_(m.actor_mean.weight, head_gain, generator=g)
    return m


def phase_k5(cases=None) -> float:
    """K5 against its plain version on the card; returns the max abs error
    of the T = 3 final states."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting
    from drone_tpu_torch.types import default_params

    # the main path's tower at its width, then a depth-3 tower of odd widths
    # (ping-pong activation buffers, padded chunks), a linear policy on the
    # other task templates, the main tower over a ragged last block (8,232
    # lanes: 40 in the last, one warp of them ragged), and [128, 128], whose
    # weights stay in device memory (384-lane blocks, act_layout)
    cases = cases or [
             ("hover", "euler", (64, 64), 65536, ((3, 2), (64, 40))),
             ("waypoint", "rk4", (32, 48, 20), 8192, ((3, 2),)),
             ("racing", "euler", (), 8192, ((3, 2),)),
             ("waypoint", "rk4", (64, 64), 8192 + 40, ((3, 2),)),
             ("hover", "euler", (128, 128), 8192, ((3, 2),))]
    max_err = 0.0
    for task, integ, hidden, n, runs in cases:
        policy = seeded_policy(hidden, head_gain=1.0).cuda()
        for T, horizon in runs:
            env = DroneEnv(task, integ, default_params(task, horizon=horizon),
                           device="cuda")
            state = env.init_batch(2, n)
            for sto in (False, True):
                args = (state, policy, env.params, env.statics, T, sto)
                kf, ks = cuda_acting.act_rollout_kernel(*args)
                pf, ps = cuda_acting.act_rollout_plain(*args)
                torch.cuda.synchronize()
                k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
                k_r = float(ks[0].sum()) / (n * T)
                p_r = float(ps[0].sum()) / (n * T)
                err = float((kf.fstate() - pf.fstate()).abs().max())
                print(f"K5 {task}/{integ} {list(hidden)} n={n} T={T} "
                      f"stochastic={sto}: max|state err|={err:.3g} episodes "
                      f"{k_ep:.0f} vs {p_ep:.0f}, mean reward {k_r:.6f} vs "
                      f"{p_r:.6f}", flush=True)
                if T == 3:
                    max_err = max(max_err, err)
                    torch.testing.assert_close(kf.fstate(), pf.fstate(),
                                               rtol=2e-5, atol=2e-6)
                    if k_ep != p_ep or k_ep < n:
                        raise AssertionError("K5 episode counts differ at T=3")
                    kf2, ks2 = cuda_acting.act_rollout_kernel(*args)
                    check_repeat("K5", (kf.fstate(), ks), (kf2.fstate(), ks2))
                elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                    raise AssertionError("K5 episode statistics disagree")
    return max_err


def _wrappers() -> dict:
    from drone_tpu_torch import ops

    return {"K1": ops.rollout_cuda, "K2": ops.traj_rollout_cuda,
            "K3": ops.ppo_update_cuda, "K4": ops.fused_adam_cuda,
            "K5": ops.act_rollout_cuda, "K6": ops.traj_lstm_rollout_cuda,
            "K7": ops.lstm_update_cuda, "K8": ops.lstm_act_rollout_cuda,
            "K9": ops.traj_cnn_rollout_cuda, "K10": ops.ppo_cnn_update_cuda,
            "K11": ops.cnn_act_rollout_cuda}


ARMS = ("K6", "K7", "K8")  # the recurrent kernels, with a CNN arm each
# the kernels with a bf16 operand arm, whose launches they count apart too
BF16_ARMS = ("K2", "K3", "K7", "K9", "K10", "K11")


def zero_counts():
    w = _wrappers()
    for fn in w.values():
        fn.launches = 0
    for k in ARMS:
        w[k].cnn_launches = 0
    for k in BF16_ARMS:
        w[k].bf16_launches = 0


def counts() -> dict:
    w = _wrappers()
    c = {k: fn.launches for k, fn in w.items()}
    c.update({f"{k} cnn": w[k].cnn_launches for k in ARMS})
    c.update({f"{k} bf16": w[k].bf16_launches for k in BF16_ARMS})
    return c


def flat_policy(hidden=(64, 64), seed=1, log_std=-0.5):
    """A seeded ActorCritic on the card, flattened as the trainer keeps it,
    with actions of order 1 and a given log_std."""
    import torch

    m = seeded_policy(hidden, seed=seed, head_gain=1.0)
    with torch.no_grad():
        m.log_std.fill_(log_std)
    m = m.cuda()
    m.flatten_()
    return m


# K2's checks: (task, integrator, hidden, lanes, ((T, horizon), ...)); T = 3
# in both action modes, T = 64 stochastic
K2_CASES = (
    ("hover", "euler", (64, 64), 65536, ((3, 2), (64, 40))),
    ("waypoint", "rk4", (64, 64), 8192 + 40, ((3, 2),)),  # a ragged block
    ("waypoint", "rk4", (32, 48, 20), 8192, ((3, 2),)),
    ("hover", "euler", (128, 128), 8192, ((3, 2),)),  # the widest, off chip
    ("racing", "euler", (), 8192, ((3, 2),)),  # linear: fragments staged
    ("hover", "rk4", (48,), 8192, ((3, 2),)),  # one layer, staged
)


def phase_k2(cases=K2_CASES) -> float:
    """K2 against its plain version on the card; returns the max abs error
    of the T = 3 planes."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting_traj as K2
    from drone_tpu_torch.types import default_params

    if (K2.traj_layout((128, 128))["wsm"], K2.traj_layout(())["wsm"],
            K2.traj_layout((48,))["wsm"]) != (0, 1, 1):
        raise AssertionError("[128, 128] was to read its fragments through "
                             "L1, [] and [48] to stage them")
    max_err = 0.0
    for task, integ, hidden, n, runs in cases:
        model = flat_policy(hidden)
        lay = K2.traj_layout(hidden)
        for T, horizon in runs:
            env = DroneEnv(task, integ, default_params(task, horizon=horizon),
                           device="cuda")
            state = env.init_batch(5, n)
            for sto in ((False, True) if T == 3 else (True,)):
                args = (state, model.flat, model.hidden, env.params,
                        env.statics, T, sto)
                kf, kp, ks = K2.traj_rollout_kernel(*args)
                pf, pp, ps = K2.traj_rollout_plain(*args)
                torch.cuda.synchronize()
                k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
                k_r = float(ks[0].sum()) / (n * T)
                p_r = float(ps[0].sum()) / (n * T)
                err = float((kp - pp).abs().max())
                print(f"K2 {task}/{integ} {list(hidden)} n={n} T={T} "
                      f"stochastic={sto} ({lay['bl']} lanes a block, "
                      f"fragments staged {lay['wsm']}): max|plane err|="
                      f"{err:.3g} episodes {k_ep:.0f} vs {p_ep:.0f}, mean "
                      f"reward {k_r:.6f} vs {p_r:.6f}", flush=True)
                if T == 3:
                    max_err = max(max_err, err)
                    torch.testing.assert_close(kp, pp, rtol=2e-5, atol=2e-6)
                    torch.testing.assert_close(kf.fstate(), pf.fstate(),
                                               rtol=2e-5, atol=2e-6)
                    if k_ep != p_ep or k_ep < n:
                        raise AssertionError("K2 episode counts differ at "
                                             "T=3")
                    kf2, kp2, ks2 = K2.traj_rollout_kernel(*args)
                    check_repeat("K2", (kf.fstate(), kp, ks),
                                 (kf2.fstate(), kp2, ks2))
                elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                    raise AssertionError("K2 episode statistics disagree")
    return max_err


def hover_minibatch(cfg, model, env, compute_dtype="float32"):
    """hover.toml's update inputs on the card: K2's planes at full width
    (its compute_dtype arm), their normalized advantages, a minibatch's row
    blocks."""
    import torch

    from drone_tpu_torch import ppo_cuda
    from drone_tpu_torch.env import observe
    from drone_tpu_torch.ops import cuda_acting_traj as K2

    tc = cfg.train
    _, _, rbu, n_rb, mb_rb, co = ppo_cuda.plan_minibatch_geometry(
        tc, tc.num_envs)
    state = env.init_batch(7, tc.num_envs)
    final, planes, _ = K2.traj_rollout_kernel(state, model.flat, model.hidden,
                                              env.params, env.statics,
                                              tc.horizon,
                                              compute_dtype=compute_dtype)
    _, critic, _ = K2.tower_weights(model.flat, model.hidden)
    with torch.no_grad():
        last_value = K2.tower_forward(observe(final), critic,
                                      compute_dtype)[:, 0]
    advret = ppo_cuda.normalized_advret(planes, last_value, tc)
    perm = torch.randperm(n_rb, generator=torch.Generator().manual_seed(3))
    perm_mb = perm[:mb_rb].to(device="cuda", dtype=torch.int32)
    return planes, advret, perm_mb, co, rbu * 128


def off_policy(flat, order, seed=5, critic_scale=2.0):
    """A copy of a flat parameter buffer (kernel order `order`) moved away
    from the weights that wrote the planes: noise on the actor's head and
    (critic_scale) on the critic's, log_std up by 0.1. On part of the
    samples the ratio then leaves 1 +- clip_eps and v leaves v_old +-
    vf_clip, as on every minibatch of an update after its first."""
    import torch

    from drone_tpu_torch.models import order_offsets

    offs, _ = order_offsets(order)
    shapes = dict(order)
    theta = flat.clone()
    g = torch.Generator().manual_seed(seed)
    for name, scale in (("actor_mean.weight", 0.02), ("actor_mean.bias", 0.02),
                        ("critic_value.weight", critic_scale),
                        ("critic_value.bias", critic_scale)):
        n = math.prod(shapes[name])
        theta[offs[name]:offs[name] + n] += (
            scale * torch.randn(n, generator=g)).to(theta.device)
    theta[offs["log_std"]:offs["log_std"] + 4] += 0.1
    return theta


def check_branches(name, n):
    """Fail unless at least 0.1% of the samples take each branch of the
    head's subgradients (cuda_update.branch_counts)."""
    print(f"{name} off-policy branches: {n}", flush=True)
    least = 0.001 * n["samples"]
    if not (n["ratio_out"] - n["policy_grad_zero"] > least
            and n["policy_grad_zero"] > least
            and n["value_out"] - n["value_grad_zero"] > least
            and n["value_grad_zero"] > least):
        raise AssertionError(f"the off-policy {name} check misses a branch")


def check_k3(planes, advret, perm_mb, theta, hidden, co, rbl, ent_coef,
             each_stat: bool) -> float:
    """K3 against its plain version on one minibatch: each gradient tensor
    within 1e-4 x its max |value|, two launches bitwise equal. The stat sums likewise: with each_stat,
    the policy-loss, value-loss, approx-KL and clip-fraction sums each
    against its own value and the log_std terms as a group; otherwise all 8
    as one tensor. Returns (the largest absolute difference, the plain
    version's stat sums)."""
    import torch

    from drone_tpu_torch.models import kernel_order
    from drone_tpu_torch.ops import cuda_update as K3

    args = (planes, advret, perm_mb, theta, hidden, co, rbl, ent_coef)
    kg, ks = K3.ppo_update_kernel(*args)
    pg, ps = K3.ppo_update_plain(*args)
    torch.cuda.synchronize()
    check_repeat("K3", (kg, ks), K3.ppo_update_kernel(*args))
    max_err = compare_grads(
        f"K3 hover.toml minibatch ({perm_mb.numel()} row blocks of {rbl} "
        f"lanes x {planes.shape[0]} steps)", kg, ks, pg, ps,
        kernel_order(hidden), each_stat)
    return max_err, ps


def compare_grads(what, kg, ks, pg, ps, order, each_stat: bool) -> float:
    """An update kernel's gradients and stat sums against its plain
    version's: each tensor of `order` within 1e-4 x its max |value|; the
    stat sums likewise, with each_stat each of the first 4 on its own and
    the log_std terms as a group, else all 8 as one. Returns the largest
    absolute difference."""
    groups, off = [], 0
    for name, shape in order:
        n = math.prod(shape)
        groups.append((name, kg[off:off + n], pg[off:off + n]))
        off += n
    if each_stat:
        groups += [(f"stat {i}", ks[i:i + 1], ps[i:i + 1]) for i in range(4)]
        groups.append(("stats 4-7", ks[4:], ps[4:]))
    else:
        groups.append(("stats", ks, ps))
    max_err = max_rel = 0.0
    for name, a, b in groups:
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        rel = err / scale if scale > 0 else err
        max_err, max_rel = max(max_err, err), max(max_rel, rel)
        if rel > 1e-4:
            raise AssertionError(f"{what} {name}: max|err| {err:.3g} is "
                                 f"{rel:.3g} of max|value| {scale:.3g}")
    print(f"{what}: max|err| {max_err:.3g}, at most {max_rel:.3g} of a "
          f"tensor's max|value|; stats kernel {ks.tolist()} plain "
          f"{ps.tolist()}", flush=True)
    return max_err


def check_k4(flat, order, cfg, label, grads=None) -> tuple:
    """K4 against its plain version over a layout (rtol 1e-5 / atol 1e-8)
    at step count 5, on `grads` (by default seeded noise, |g| = 0.05
    sqrt(P), which the norm clip cuts) and on the same gradients scaled to
    a quarter of the clip norm, each launched twice on the same inputs,
    bitwise equal. Returns (the largest absolute difference, the first
    case's inputs for timing: grads, mu, nu, schedule, constants)."""
    import torch

    from drone_tpu_torch import ppo_cuda
    from drone_tpu_torch.models import tensor_sizes
    from drone_tpu_torch.ops import cuda_update as K4

    g = torch.Generator(device="cuda").manual_seed(4)
    P = flat.numel()
    noise = 0.05 * torch.randn(P, device="cuda", generator=g)
    grads = noise if grads is None else grads
    mu0 = 0.01 * torch.randn(P, device="cuda", generator=g)
    nu0 = 0.001 * torch.rand(P, device="cuda", generator=g)
    sched = ppo_cuda.make_fused_lr(cfg.train)
    ac = K4.AdamConsts(clip_norm=cfg.train.max_grad_norm)
    sizes = tensor_sizes(order)
    k4_err = 0.0
    for gr in (grads, grads * (0.25 * ac.clip_norm / float(grads.norm()))):
        clip = "active" if float(gr.norm()) > ac.clip_norm else "inactive"
        outs = []
        for run in (K4.fused_adam_kernel, K4.fused_adam_kernel,
                    K4.fused_adam_plain):
            th, mu, nu = flat.clone(), mu0.clone(), nu0.clone()
            count = torch.tensor(5.0, device="cuda")
            run(th, gr, mu, nu, count, ac, sched, sizes)
            outs.append((th, mu, nu, count))
        torch.cuda.synchronize()
        check_repeat("K4", outs[0], outs[1])
        err = 0.0
        for a, b in zip(outs[0], outs[2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)
            err = max(err, float((a - b).abs().max()))
        k4_err = max(k4_err, err)
        print(f"K4 over {label} ({P} parameters, {len(sizes)} tensors, "
              f"{K4.adam_blocks(P)} blocks), count 5, clip {clip} (|g| = "
              f"{float(gr.norm()):.3g}): max|err| {err:.3g}, two launches "
              f"bitwise equal", flush=True)
    return k4_err, (grads, mu0, nu0, sched, ac)


def phase_k3_k4(cfg, env):
    """K3 and K4 against their plain versions at hover.toml's shapes;
    returns (K3 max abs error, K4 max abs error, inputs for timing)."""
    from drone_tpu_torch.models import kernel_order
    from drone_tpu_torch.ops import cuda_update as K3

    model = flat_policy()
    planes, advret, perm_mb, co, rbl = hover_minibatch(cfg, model, env)
    ent = cfg.train.ent_coef
    # the first minibatch of an update: the weights that wrote the planes,
    # ratio 1 and v == v_old on every sample
    k3_err, _ = check_k3(planes, advret, perm_mb, model.flat, model.hidden,
                         co, rbl, ent, each_stat=False)
    # a later minibatch: every branch of the head's subgradients taken
    theta = off_policy(model.flat, kernel_order(model.hidden))
    n = K3.head_branch_counts(planes, advret, perm_mb, theta, model.hidden,
                              co, rbl)
    check_branches("K3", n)
    err, ps = check_k3(planes, advret, perm_mb, theta, model.hidden, co, rbl,
                       ent, each_stat=True)
    if float(ps[K3.ST_KL]) == 0.0 or float(ps[K3.ST_CF]) == 0.0:
        raise AssertionError("the off-policy approx-KL or clip-fraction sum "
                             "is 0")
    k3_err = max(k3_err, err)
    # a tower whose weight planes and running sums do not fit beside its
    # activations (update_kernel<false>), on a smaller run's minibatch
    big = flat_policy((128, 128))
    if K3.mma_layout(big.hidden)["onchip"]:
        raise AssertionError("[128, 128] was to run off chip")
    inputs = hover_minibatch(
        cfg.with_overrides(["train.num_envs=8192", "train.horizon=16"]),
        big, env)
    err, _ = check_k3(*inputs[:3], off_policy(big.flat, kernel_order(
        big.hidden)), big.hidden, *inputs[3:], ent, each_stat=False)
    k3_err = max(k3_err, err)

    k4_err, k4_inputs = check_k4(model.flat, kernel_order(model.hidden),
                                 cfg, "the MLP layout")
    return k3_err, k4_err, (model, planes, advret, perm_mb, co, rbl,
                            *k4_inputs)


def path_training(cfg_path, tmp):
    """train() on hover.toml for 3 updates, then cli train for 2 and
    evaluate of its checkpoint. Returns the launch counts of train()."""
    import torch

    from drone_tpu_torch import cli, ppo_cuda
    from drone_tpu_torch.train import evaluate, train
    from drone_tpu_torch.utils.config import Config

    cfg = Config.from_toml(cfg_path).with_overrides([
        "run.total_updates=3", f"run.checkpoint_dir={tmp}",
        "run.run_name=smoke"])
    zero_counts()
    t0 = time.time()
    _, last = train(cfg)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    train_counts = counts()
    print(f"training path: train(hover.toml, 3 updates) in {t_train:.2f} s; "
          f"launches {train_counts}; last {last}", flush=True)
    want = {"K2": 3, "K3": 96, "K4": 96}
    if any(train_counts[k] != v for k, v in want.items()):
        raise AssertionError(f"the training path launched {train_counts}, "
                             f"expected {want}")
    if not set(ppo_cuda.METRIC_KEYS) <= set(last):
        raise AssertionError(f"metric keys {sorted(last)}")
    if not all(v == v and abs(v) != float("inf") for k, v in last.items()
               if k in ppo_cuda.METRIC_KEYS):
        raise AssertionError("non-finite training metrics")

    zero_counts()
    rc = cli.main(["train", str(cfg_path), "run.total_updates=2",
                   f"run.checkpoint_dir={tmp}", "run.run_name=cli"])
    res = evaluate(Config.from_toml(cfg_path).with_overrides(
        [f"run.resume_from={tmp}/cli/checkpoints"]), episodes=4096)
    torch.cuda.synchronize()
    cli_counts = counts()
    print(f"cli train (2 updates) rc={rc}, then evaluate of its checkpoint "
          f"{res}; launches {cli_counts}", flush=True)
    if rc != 0 or cli_counts["K2"] != 2 or cli_counts["K3"] != 64 \
            or cli_counts["K5"] != 1 or res["episodes"] < 4096:
        raise AssertionError("cli train + evaluate did not run as expected")
    return train_counts


# the MLP learning gate: the mean reward of 5 updates must pass this within
# MLP_GATE_UPDATES updates
MLP_GATE_REWARD = 0.3
MLP_GATE_UPDATES = 120


def mlp_gate_run(seed, compute_dtype="float32"):
    """The MLP learning gate's training (8,192 envs, horizon 32, [32, 32],
    4 epochs x 4 minibatches, lr 3e-3, no entropy bonus; its compute_dtype
    arms), the model and the runner from one seed, until the mean reward of the last 5 updates
    passes MLP_GATE_REWARD or MLP_GATE_UPDATES updates have run: (updates
    run, the last 5's mean reward, the first 5's, parameters finite)."""
    import torch

    from drone_tpu_torch import ppo_cuda
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.models import ActorCritic
    from drone_tpu_torch.ppo import PPOConfig, init_runner

    env = DroneEnv(device="cuda")
    cfg = PPOConfig(horizon=32, num_envs=8192, epochs=4, num_minibatches=4,
                    lr=3e-3, ent_coef=0.0)
    model = ActorCritic((32, 32),
                        generator=torch.Generator().manual_seed(seed))
    runner = init_runner(model, env, cfg, seed=seed)
    step = ppo_cuda.make_train_step(env, cfg, compute_dtype=compute_dtype)
    rewards = []
    for u in range(MLP_GATE_UPDATES):
        runner, m = step(runner)
        rewards.append(float(m["reward_mean"]))
        if u >= 4 and sum(rewards[-5:]) / 5 > MLP_GATE_REWARD:
            break
    return (len(rewards), sum(rewards[-5:]) / 5, sum(rewards[:5]) / 5,
            bool(torch.isfinite(runner.params.flat).all()))


def phase_learning_and_resume(tmp):
    """The learning gate (one run from seed 0, mlp_gate_run) and bitwise
    resume on the card."""
    import torch

    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    t0 = time.time()
    updates, mean5, first5, finite = mlp_gate_run(0)
    print(f"learning gate: mean reward of the last 5 updates {mean5:.4f} "
          f"after {updates} updates ({time.time() - t0:.1f} s); first 5 "
          f"{first5:.4f}; parameters finite {finite}", flush=True)
    if not (mean5 > MLP_GATE_REWARD and finite):
        raise AssertionError("the learning gate failed on the card")

    def cfg_for(name, total, extra=()):
        return Config.default().with_overrides([
            "train.num_envs=4096", "train.horizon=16", "train.epochs=2",
            "train.num_minibatches=2", "run.hidden=32,32",
            "run.log_interval=2", f"run.total_updates={total}",
            f"run.run_name={name}", f"run.checkpoint_dir={tmp}", *extra])

    full, _ = train(cfg_for("full", 4))
    train(cfg_for("half", 2))
    resumed, _ = train(cfg_for("resumed", 4, [
        f"run.resume_from={tmp}/half/checkpoints"]))
    torch.cuda.synchronize()

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step]

    ok = all(bitwise_equal(a, b) for a, b in zip(tensors(full),
                                                 tensors(resumed)))
    print(f"resume on the card: train(4) == train(2) + resume(2) bitwise: "
          f"{ok}", flush=True)
    if not ok:
        raise AssertionError("resume is not bitwise on the card")


def time_training(cfg, env, inputs):
    """Times of K2, K3 and K4 (CUDA events) beside their plain versions,
    bounds and K4's library pair, and one full-width update split into its
    phases. Returns {name: (ms, plain_ms, bound_ms, bound_by, library_ms)}
    (the breakdown is printed)."""
    import torch

    from drone_tpu_torch.models import kernel_order, tensor_sizes
    from drone_tpu_torch.ops import cuda_acting_traj as K2
    from drone_tpu_torch.ops import cuda_update as K3

    model, planes, advret, perm_mb, co, rbl, grads, mu0, nu0, sched, ac = inputs
    tc = cfg.train
    n, T, hidden = tc.num_envs, tc.horizon, model.hidden
    P = model.flat.numel()
    state = env.init_batch(9, n)

    out = {}
    _, _, lane = K2.traj_rollout_kernel(state, model.flat, hidden, env.params,
                                        env.statics, T)
    episodes = float(lane[1].sum())
    k2_ms = cuda_ms(lambda: K2.traj_rollout_kernel(
        state, model.flat, hidden, env.params, env.statics, T), reps=5)
    t0 = time.time()
    K2.traj_rollout_plain(state, model.flat, hidden, env.params, env.statics, T)
    torch.cuda.synchronize()
    k2_plain = (time.time() - t0) * 1e3
    k2_ops = (n * T * (OPS_STEP + OPS_OBS + tower_ops(hidden, 4)
                       + tower_ops(hidden, 1) + OPS_NOISE_LOGP)
              + episodes * OPS_RESET)
    k2_bytes = n * (2 * 25 * 4 + 5 * 4) + T * 21 * n * 4 + P * 4
    k2_mma = n * T * (tower_mma_ops(hidden, 4) + tower_mma_ops(hidden, 1))
    out["K2"] = (k2_ms, k2_plain,
                 *tensor_bound(k2_mma, k2_ops - k2_mma, k2_bytes), None)
    print(f"K2: {k2_mma:.4g} of {k2_ops:.4g} ops on the tensor cores; fp32 "
          f"bound {bound(k2_ops, k2_bytes)[0]:.4f} ms", flush=True)

    args = (planes, advret, perm_mb, model.flat, hidden, co, rbl, tc.ent_coef)
    samples = perm_mb.numel() * rbl * T
    k3_ms = cuda_ms(lambda: K3.ppo_update_kernel(*args), reps=10)
    k3_plain = cuda_ms(lambda: K3.ppo_update_plain(*args), reps=2)
    k3_ops = samples * update_ops(hidden)
    k3_mma = samples * update_mma_ops(hidden)
    k3_bytes = samples * 21 * 4 + P * 4 + (P + 8) * 4
    out["K3"] = (k3_ms, k3_plain,
                 *tensor_bound(k3_mma, k3_ops - k3_mma, k3_bytes), None)
    print(f"K3: {k3_mma:.4g} of {k3_ops:.4g} ops on the tensor cores; fp32 "
          f"bound {bound(k3_ops, k3_bytes)[0]:.4f} ms", flush=True)

    theta, mu, nu = model.flat.clone(), mu0.clone(), nu0.clone()
    count = torch.tensor(5.0, device="cuda")
    sizes = tensor_sizes(kernel_order(hidden))
    k4_ms = cuda_ms(lambda: K3.fused_adam_kernel(
        theta, grads, mu, nu, count, ac, sched, sizes), reps=100)
    k4_plain = cuda_ms(lambda: K3.fused_adam_plain(
        theta, grads, mu, nu, count, ac, sched, sizes), reps=20)
    k4_lib = adam_library_ms(model.flat, grads, kernel_order(hidden), tc)
    # squares and sum (2), then per element: scale, 2 moments (7), the
    # update (8) and the add (1); read params, grads, mu, nu, write 3
    out["K4"] = (k4_ms, k4_plain, *bound(P * 18, P * 4 * 7 + 8), k4_lib)

    for name, (ms, plain, bms, by, lib) in out.items():
        print(f"{name}: kernel {ms:.4f} ms, plain {plain:.2f} ms, bound "
              f"{bms:.4f} ms ({by}), library {lib}", flush=True)
    split_update(cfg)
    return out


def adam_library_ms(flat, grads, order, tc) -> float:
    """The time of the nearest library pair to K4 over a layout's tensors
    (two calls: clip_grad_norm_(foreach=True) + Adam(fused=True).step()), by
    CUDA events."""
    import torch

    shapes = [sh for _, sh in order]
    numels = [math.prod(sh) for sh in shapes]
    params = [torch.nn.Parameter(t.clone().reshape(sh)) for t, sh in
              zip(torch.split(flat, numels), shapes)]
    for prm, g in zip(params, torch.split(grads, numels)):
        prm.grad = g.clone().reshape(prm.shape)
    opt = torch.optim.Adam(params, lr=tc.lr, eps=1e-5, fused=True)

    def library_step():
        torch.nn.utils.clip_grad_norm_(params, tc.max_grad_norm, foreach=True)
        opt.step()

    return cuda_ms(library_step, reps=100)


def split_update(cfg):
    """One warm full-width update of train.build's runner, split into its
    phases by CUDA events recorded at the phase marks of make_train_step
    (device time between marks, so a gap the host leaves is counted in
    the phase it delays) and by the host clock (time to queue each phase).
    The update must queue without a host sync: torch's sync check is on
    while it does. A torch.profiler trace of one more update gives the
    device's busy time and idle share, and the time of each kernel class."""
    import warnings

    import torch

    from drone_tpu_torch import ppo_cnn_cuda, ppo_cuda, ppo_rnn_cuda
    from drone_tpu_torch.train import build

    env, _, runner, _, bcfg = build(cfg)
    tc = bcfg.train
    marks = []
    maker = {"lstm": ppo_rnn_cuda.make_rnn_train_step,
             "cnn_lstm": ppo_rnn_cuda.make_rnn_train_step,
             "cnn": ppo_cnn_cuda.make_cnn_train_step}.get(
                 cfg.run.policy, ppo_cuda.make_train_step)

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    dtype = bcfg.run.compute_dtype
    step = maker(env, tc, on_phase=mark, **dtype_kwargs(dtype))
    runner, m = step(runner)  # warm-up
    float(m["loss"])
    marks.clear()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            runner, m = step(runner)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t_queued = time.perf_counter()
    float(m["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    if syncs:
        raise AssertionError(f"the update synced with the host: {syncs}")
    split = {"wall_ms": wall_ms,
             "samples_per_s": tc.num_envs * tc.horizon / wall_ms * 1e3,
             "host_queue_ms": (t_queued - t0) * 1e3}
    for (name, e0, h0), (_, e1, h1) in zip(marks, marks[1:]):
        split[f"{name}_device_ms"] = e0.elapsed_time(e1)
        split[f"{name}_host_ms"] = (h1 - h0) * 1e3
    print(f"one {cfg.run.policy} {dtype} update at hover.toml's shape (no "
          f"host sync inside): {split}", flush=True)
    print(f"the same update traced: "
          f"{trace_update(step, runner, cfg.run.policy)}", flush=True)
    return split


def trace_update(step, runner, policy) -> dict:
    """Device busy time, idle share and the time of each kernel class over
    one update (torch.profiler, from its host-side range to the read of the
    loss), and of each kernel of a class: K7's gate packing, tower forward,
    walk, tower backward, products and reduction apart, and K10's. The
    tower's backward and packing kernels are K10's in a CNN update, else
    K7's; the gate packing is K7's (K6's one packing a rollout, a few
    microseconds, falls there too).
    Returns {"not measured": reason} when the trace holds no device
    activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with tempfile.TemporaryDirectory() as tmp:
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("one_update"):
                    _, m = step(runner)
                    float(m["loss"])
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
        except RuntimeError as e:  # no CUPTI: the trace is what is missing
            return {"not measured": f"torch.profiler failed: {e}"}
        events = json.loads(path.read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "one_update"
            and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    if not span or not device:
        return {"not measured": "no device activity in the trace"}
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    busy, end = 0.0, t0
    for e in sorted(device, key=lambda e: float(e["ts"])):
        a = max(float(e["ts"]), end)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b > a:
            busy += b - a
        end = max(end, b)
    # the port's kernels live in namespace drone (torch has reduce_kernels
    # of its own)
    tower = ("drone::pack_tower_kernel", "drone::tower_bwd_kernel")
    classes = {"K2": ("drone::pack_traj", "drone::traj_kernel"),
               "K3": ("drone::pack_planes_kernel", "drone::pack_b16_kernel",
                      "drone::update_kernel", "drone::reduce_kernel"),
               "K4": ("drone::adam_kernel",),
               "K6": ("drone::lstm_act_kernel",),
               "K7": ("drone::pack_gates", "drone::tower_fwd_kernel",
                      "drone::bptt_kernel",
                      *(() if policy == "cnn" else tower),
                      "drone::grad_mma_kernel", "drone::grad_rounded_kernel",
                      "drone::lstm_reduce_kernel"),
               "K9": ("drone::cnn_act_kernel",),
               "K10": ("drone::cnn_fwd_kernel",
                       *(tower if policy == "cnn" else ()),
                       "drone::cnn_gemm_kernel", "drone::cnn_reduce_kernel")}
    by_class = {k: 0.0 for k in (*classes, "other")}
    counts = {k: 0 for k in by_class}
    other, by_kernel = {}, {}
    for e in device:
        k = next((c for c, keys in classes.items()
                  if any(key in e["name"] for key in keys)), "other")
        by_class[k] += float(e["dur"]) / 1e3
        counts[k] += 1
        if k == "other":
            name = e["name"][:60]
            other[name] = other.get(name, 0.0) + float(e["dur"]) / 1e3
        else:  # each kernel of a class (K3's and K7's have several)
            name = next(key for key in classes[k] if key in e["name"])
            by_kernel[name] = by_kernel.get(name, 0.0) + float(e["dur"]) / 1e3
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    return {"span_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0),
            "device_ms": by_class, "device_ops": counts,
            "device_ms_by_kernel": by_kernel,
            "largest_other_ms": dict(top)}

# ---------------------------------------------------------------------------
# The LSTM slice: K8 (serving), K6 (training rollout), K7 (BPTT update)
# ---------------------------------------------------------------------------

LSTM_OVERRIDES = ("run.policy=lstm", "train.horizon=128",
                  "train.bptt_horizon=16", "train.num_minibatches=4")


def lstm_ops(hidden, encoder, value: bool) -> int:
    """Operations of one LSTM lane-step: the encoder (multiply-adds x2, bias,
    tanh; or the patch-CNN tower, cnn_tower_ops), the gate block (4H (E + H)
    multiply-adds x2, 4 bias adds and 4 activations a unit, then c' (3),
    tanh(c') and h'), the action head, the value head when asked, and the
    carry mask (2 a unit)."""
    from drone_tpu_torch.models.lstm import encoder_width, is_cnn

    E, H = encoder_width(encoder), hidden
    if is_cnn(encoder):
        ops = cnn_tower_ops()
    else:
        dims = [13, *encoder]
        ops = sum(2 * a * b + 2 * b for a, b in zip(dims[:-1], dims[1:]))
    ops += 2 * 4 * H * (E + H) + 13 * H + 2 * 4 * H + 4 + 2 * H
    return ops + (2 * H + 1 if value else 0)


def bptt_ops(hidden, encoder) -> int:
    """Operations of one sample through K7: the forward step with both heads,
    the PPO head, dh' (10 a unit), the cell backward (20 a unit), [dx; dh]
    (4H (E + H) multiply-adds), the encoder backward (3 a unit, and the
    input gradient below the last layer; or the patch-CNN tower's,
    cnn_tower_bwd_ops), and the weight-gradient products with their bias
    sums."""
    from drone_tpu_torch.models.lstm import encoder_width, is_cnn

    E, H = encoder_width(encoder), hidden
    ops = lstm_ops(H, encoder, True) + OPS_PPO_HEAD + 30 * H
    ops += 2 * 4 * H * (E + H) + 2 * 4 * H * (E + H + 1) + 2 * 5 * (H + 1)
    if is_cnn(encoder):
        return ops + cnn_tower_bwd_ops()
    dims = [13, *encoder]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ops += 3 * b + 2 * b * (a + 1) + (2 * a * b if i > 0 else 0)
    return ops


def gate_mma_ops(hidden, encoder) -> int:
    """Operations of the gate block's product on one lane-step, which every
    recurrent kernel runs on the tensor cores in 3xTF32 (4H (E + H)
    multiply-adds x2)."""
    from drone_tpu_torch.models.lstm import encoder_width

    return 2 * 4 * hidden * (encoder_width(encoder) + hidden)


def k7_mma_ops(hidden, encoder) -> int:
    """Operations of one sample through K7 that it runs on the tensor cores
    in 3xTF32 besides the CNN arm's tower (cnn_tower_mma_ops): the forward
    gate block, [dx; dh] (dh alone with no encoder), and the weight
    gradients of the gates, the heads and the dense encoder's layers
    (multiply-adds x2)."""
    from drone_tpu_torch.models.lstm import encoder_width, is_cnn

    E, H = encoder_width(encoder), hidden
    dx = E if is_cnn(encoder) or encoder else 0
    macs = 4 * H * (E + H) + 4 * H * (dx + H) + 4 * H * (E + H) + 5 * H
    if not is_cnn(encoder):
        dims = [13, *encoder]
        macs += sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2 * macs


def k7_scratch_floats(hidden, encoder, compute_dtype="float32") -> int:
    """Floats of K7's scratch traffic on one sample: the forward writes
    [obs, the encoder's outputs, h_in], the gate block's [gi, gf, gg, go,
    c_in, tanh(c')] over its padded units (the bf16 walk's first five:
    cuda_update_lstm.scratch_rows), h' and the heads' outputs; the walk back
    reads the heads' outputs, the gate block's quantities and the encoder's
    outputs and writes dz, [dm; g_v] and dpre (the CNN arm: it reads x and
    writes dzt); each product reads its two operands once (the CNN arm's
    tower kernels' own traffic, X2 among it, not counted)."""
    from drone_tpu_torch.models.lstm import encoder_width, is_cnn
    from drone_tpu_torch.ops.cuda_update_lstm import GF, scratch_rows

    E, H = encoder_width(encoder), hidden
    enc_rows = E if is_cnn(encoder) else sum(encoder)
    gf = scratch_rows(H, encoder, compute_dtype)[GF]
    fwd = (13 + enc_rows + H) + gf + H + 5
    back = (5 + gf + enc_rows) + (4 * H + 5 + enc_rows)
    prods = (4 * H + E + H) + (5 + H)
    if not is_cnn(encoder):
        dims = [13, *encoder]
        prods += sum(a + b for a, b in zip(dims[:-1], dims[1:]))
    return fwd + back + prods


def gate_l2_bytes(hidden, encoder, transposed=False,
                  compute_dtype="float32") -> float:
    """Bytes a lane-step of the gate weights' fragments, which a tile
    (cuda_acting_cnn.TILE lanes) reads from L2 each step: the (big, small)
    float4s (csrc/lstm_mma.cuh gate_frags), or K7's bf16 walk's bf16x2
    words (cuda_update_lstm.gate_fragment_bytes); K7's walk reads the
    transposed ones too."""
    from drone_tpu_torch.ops import cuda_update_lstm as K7
    from drone_tpu_torch.ops.cuda_acting_cnn import TILE

    fwd, bwd = K7.gate_fragment_bytes(hidden, encoder, compute_dtype)
    return (fwd + (bwd if transposed else 0)) / TILE


def lstm_policy(hidden=128, encoder=(64,), seed=1, log_std=-0.5):
    """A seeded LSTMActorCritic on the card, flattened as the trainer keeps
    it, with actions of order 1 and a given log_std."""
    import torch
    from torch import nn

    from drone_tpu_torch.models import LSTMActorCritic

    g = torch.Generator().manual_seed(seed)
    m = LSTMActorCritic(hidden, encoder, generator=g)
    with torch.no_grad():
        nn.init.orthogonal_(m.actor_mean.weight, 1.0, generator=g)
        m.log_std.fill_(log_std)
    m = m.cuda()
    m.flatten_()
    return m


def random_carry(n, hidden, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(0.5 * torch.randn(n, hidden, device="cuda", generator=g)
                 for _ in range(2))


def enc_label(encoder) -> str:
    from drone_tpu_torch.models.lstm import is_cnn

    return "cnn" if is_cnn(encoder) else str(list(encoder))


def phase_k8(cases=None, name="K8") -> float:
    """K8 (or its CNN arm: cases of a CnnArch encoder) against its plain
    version on the card; returns the max abs error of the T = 3 carries and
    statistics."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting_lstm as K8
    from drone_tpu_torch.types import default_params

    # the main path's policy at its width, then a smaller two-layer encoder
    # on waypoint/rk4 with a ragged last lane tile (40 of a tile's 64)
    # and with the gate block's padding: hidden 36 (40 units) over an input
    # width of 36 (40 rows), a ragged last tile too (36 lanes), and no
    # encoder (x the 13 obs, 16 rows)
    cases = cases or [
        ("hover", "euler", 128, (64,), 65536, ((3, 2), (64, 40))),
        ("waypoint", "rk4", 32, (16, 24), 8192 + 40, ((3, 2),)),
        ("hover", "euler", 36, (36,), 4096 + 36, ((3, 2),)),
        ("racing", "euler", 12, (), 4096, ((3, 2),))]
    max_err = 0.0
    for task, integ, hidden, encoder, n, runs in cases:
        model = lstm_policy(hidden, encoder)
        arch = (hidden, encoder)
        carry = random_carry(n, hidden, 3)
        for T, horizon in runs:
            env = DroneEnv(task, integ, default_params(task, horizon=horizon),
                           device="cuda")
            state = env.init_batch(2, n)
            kf, kc, ks = K8.lstm_act_rollout_kernel(
                state, model.flat, arch, carry, env.params, env.statics, T)
            pf, pc, ps = K8.lstm_act_rollout_plain(
                state, model.flat, arch, carry, env.params, env.statics, T)
            torch.cuda.synchronize()
            k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
            k_r, p_r = float(ks[0].sum()) / (n * T), float(ps[0].sum()) / (n * T)
            err = max(float((a - b).abs().max())
                      for a, b in zip((*kc, ks), (*pc, ps)))
            serr = float((kf.fstate() - pf.fstate()).abs().max())
            print(f"{name} {task}/{integ} H={hidden} enc={enc_label(encoder)} "
                  f"n={n} T={T}: max|carry, stats err|={err:.3g} (state "
                  f"{serr:.3g}) episodes {k_ep:.0f} vs {p_ep:.0f}, mean "
                  f"reward {k_r:.6f} vs {p_r:.6f}", flush=True)
            if T == 3:
                max_err = max(max_err, err)
                for a, b in zip((*kc, ks), (*pc, ps)):
                    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)
                if k_ep != p_ep or k_ep < n:
                    raise AssertionError(f"{name} episode counts differ at "
                                         f"T=3")
                kf2, kc2, ks2 = K8.lstm_act_rollout_kernel(
                    state, model.flat, arch, carry, env.params, env.statics,
                    T)
                check_repeat(name, (kf.fstate(), *kc, ks),
                             (kf2.fstate(), *kc2, ks2))
            elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                raise AssertionError(f"{name} episode statistics disagree")
    return max_err


def phase_k6(model=None, name="K6") -> float:
    """K6 (or its CNN arm, for a CNN-LSTM model) against its plain version
    on the card; returns the max abs error of the T = 3 planes and
    anchors."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting_lstm as K6
    from drone_tpu_torch.types import default_params

    n = 65536
    model = model or lstm_policy()
    arch = (model.hidden, model.encoder)
    carry = random_carry(n, model.hidden, 4)
    max_err = 0.0
    for T, bptt, horizon, modes in ((3, 1, 2, (False, True)),
                                    (128, 16, 40, (True,))):
        env = DroneEnv("hover", "euler", default_params("hover",
                                                         horizon=horizon),
                       device="cuda")
        state = env.init_batch(5, n)
        for sto in modes:
            kf, kc, kp, ka, ks = K6.traj_lstm_rollout_kernel(
                state, model.flat, arch, carry, env.params, env.statics, T,
                bptt, sto)
            pf, pc, pp, pa, ps = K6.traj_lstm_rollout_plain(
                state, model.flat, arch, carry, env.params, env.statics, T,
                bptt, sto)
            torch.cuda.synchronize()
            k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
            k_r, p_r = float(ks[0].sum()) / (n * T), float(ps[0].sum()) / (n * T)
            err = max(float((kp - pp).abs().max()), float((ka - pa).abs().max()))
            print(f"{name} hover H={model.hidden} enc="
                  f"{enc_label(model.encoder)} n={n} T={T} bptt={bptt} "
                  f"stochastic={sto}: max|plane, anchor err|={err:.3g} "
                  f"episodes {k_ep:.0f} vs {p_ep:.0f}, mean reward {k_r:.6f} "
                  f"vs {p_r:.6f}", flush=True)
            if T == 3:
                max_err = max(max_err, err)
                for a, b in zip((kp, ka, *kc), (pp, pa, *pc)):
                    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)
                if k_ep != p_ep or k_ep < n:
                    raise AssertionError(f"{name} episode counts differ at "
                                         f"T=3")
                again = K6.traj_lstm_rollout_kernel(
                    state, model.flat, arch, carry, env.params, env.statics,
                    T, bptt, sto)
                check_repeat(name, (kf.fstate(), *kc, kp, ka, ks),
                             (again[0].fstate(), *again[1], *again[2:]))
            elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                raise AssertionError(f"{name} episode statistics disagree")
    return max_err


def lstm_minibatch(cfg, model, env):
    """The LSTM update's inputs at full width on the card: K6's planes and
    anchors, their normalized advantages, a minibatch's row blocks."""
    import torch

    from drone_tpu_torch import ppo_cuda, ppo_rnn_cuda
    from drone_tpu_torch.env import observe
    from drone_tpu_torch.ops.cuda_acting_lstm import lstm_value
    from drone_tpu_torch.ops import cuda_acting_lstm as K6

    tc = cfg.train
    bptt = ppo_rnn_cuda.bptt_of(tc)
    _, _, rbu, n_rb, mb_rb, co = ppo_cuda.plan_minibatch_geometry(
        tc, tc.num_envs)
    arch = (model.hidden, model.encoder)
    state = env.init_batch(7, tc.num_envs)
    final, carry, planes, snap, _ = K6.traj_lstm_rollout_kernel(
        state, model.flat, arch, model.initial_carry(tc.num_envs, "cuda"),
        env.params, env.statics, tc.horizon, bptt)
    with torch.no_grad():
        last_value = lstm_value(observe(final), carry, model.flat, *arch)
    advret = ppo_cuda.normalized_advret(planes, last_value, tc)
    perm = torch.randperm(n_rb, generator=torch.Generator().manual_seed(3))
    perm_mb = perm[:mb_rb].to(device="cuda", dtype=torch.int32)
    return planes, advret, snap, perm_mb, co, rbu * 128, bptt


def check_segment_resets(planes, perm_mb, rbl, bptt):
    """Fail unless at least 0.1% of the minibatch's samples end an episode
    at a step that is not the last of its bptt segment, so that the masks
    (the keep mask on the through-time gradient, dgf from the masked c_in)
    are exercised by the K7 comparison."""
    import torch

    from drone_tpu_torch.ops.cuda_acting_traj import TP_DONE

    lanes = (perm_mb.long()[:, None] * rbl
             + torch.arange(rbl, device=perm_mb.device)).reshape(-1)
    done = planes[:, TP_DONE, :].index_select(1, lanes)  # (T, lanes)
    inner = torch.arange(planes.shape[0], device=done.device) % bptt < bptt - 1
    resets = int((done[inner] > 0).sum())
    samples = done.numel()
    print(f"K7 minibatch: {resets} episode ends inside bptt segments "
          f"({resets / samples:.3%} of {samples} samples)", flush=True)
    if resets < 0.001 * samples:
        raise AssertionError("the K7 check has too few resets inside bptt "
                             "segments to exercise the masks")


def check_k7(args, order, each_stat: bool):
    """K7 against its plain version on one minibatch (compare_grads), and
    two launches of the kernel on the same inputs bitwise equal."""
    import torch

    from drone_tpu_torch.ops import cuda_update_lstm as K7

    kg, ks = K7.lstm_update_kernel(*args)
    kg2, ks2 = K7.lstm_update_kernel(*args)
    pg, ps = K7.lstm_update_plain(*args)
    torch.cuda.synchronize()
    if not (bitwise_equal(kg, kg2) and bitwise_equal(ks, ks2)):
        raise AssertionError("two K7 launches on the same inputs differ")
    planes, perm_mb, rbl, bptt = args[0], args[3], args[7], args[8]
    err = compare_grads(
        f"K7 minibatch ({perm_mb.numel()} row blocks of {rbl} lanes x "
        f"{planes.shape[0]} steps, bptt {bptt}; two launches bitwise equal)",
        kg, ks, pg, ps, order, each_stat)
    return err, ps


def phase_k7_shapes(cfg, env) -> float:
    """K7 against its plain version at the shapes the gate block pads, on a
    small minibatch (2,048 envs x 32 steps, bptt 16, 2 minibatches): hidden
    36 (40 units) over two encoder layers of 20 and 36 (40 input rows), and
    hidden 12 with no encoder (the 13 obs as x, 16 rows, no dx); two
    launches bitwise equal. Returns the max abs error."""
    err = 0.0
    small = cfg.with_overrides(["train.num_envs=2048", "train.horizon=32",
                                "train.num_minibatches=2"])
    for hidden, encoder in ((36, (20, 36)), (12, ())):
        model = lstm_policy(hidden, encoder)
        planes, advret, snap, perm_mb, co, rbl, bptt = lstm_minibatch(
            small, model, env)
        args = (planes, advret, snap, perm_mb, model.flat, (hidden, encoder),
                co, rbl, bptt, small.train.ent_coef)
        e, _ = check_k7(args, model.kernel_order(), each_stat=False)
        err = max(err, e)
    return err


def phase_k7_k4(cfg, env, model=None, critic_scales=(2.0,)):
    """K7 (or its CNN arm, for a CNN-LSTM model) against its plain version
    at the full-width minibatch, on the planes' own weights and off them,
    and K4 over the policy's layout. Off the planes' weights the critic's
    noise is the first of critic_scales at which the minibatch takes every
    branch of the head's subgradients. Returns (K7 max abs error, inputs
    for timing, K4 max abs error)."""
    from drone_tpu_torch.ops import cuda_update as K4
    from drone_tpu_torch.ops import cuda_update_lstm as K7

    model = model or lstm_policy()
    arch = (model.hidden, model.encoder)
    order = model.kernel_order()
    planes, advret, snap, perm_mb, co, rbl, bptt = lstm_minibatch(cfg, model,
                                                                  env)
    check_segment_resets(planes, perm_mb, rbl, bptt)
    ent = cfg.train.ent_coef
    args = (planes, advret, snap, perm_mb, model.flat, arch, co, rbl, bptt,
            ent)
    k7_err, _ = check_k7(args, order, each_stat=False)
    for critic_scale in critic_scales:
        theta = off_policy(model.flat, order, critic_scale=critic_scale)
        try:
            check_branches(f"K7 enc={enc_label(model.encoder)} (critic noise "
                           f"{critic_scale})", K7.lstm_head_branch_counts(
                               planes, advret, snap, perm_mb, theta, arch, co,
                               rbl, bptt))
            break
        except AssertionError:
            if critic_scale == critic_scales[-1]:
                raise
    err, ps = check_k7((*args[:4], theta, *args[5:]), order, each_stat=True)
    if float(ps[K4.ST_KL]) == 0.0 or float(ps[K4.ST_CF]) == 0.0:
        raise AssertionError("the off-policy approx-KL or clip-fraction sum "
                             "is 0")
    k7_err = max(k7_err, err)

    k4_err, _ = check_k4(model.flat, order, cfg,
                         f"the {enc_label(model.encoder)} LSTM layout")
    return k7_err, args, k4_err


def path_lstm_serving(cfg, cfg_path, model=None):
    """evaluate() and cli eval of a seeded recurrent policy (the LSTM, or
    `model`) on hover.toml with cfg's run.policy; the card's evaluate(512)
    against the CPU's. Returns the launch counts of the path."""
    import torch

    from drone_tpu_torch import cli
    from drone_tpu_torch.train import evaluate
    from drone_tpu_torch.utils.checkpoint import Checkpointer

    n = cfg.train.num_envs
    policy = cfg.run.policy
    arm = "K8 cnn" if policy == "cnn_lstm" else "K8"
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(0, model or lstm_policy(seed=2, log_std=0.0))
        cfg_eval = cfg.with_overrides([f"run.resume_from={tmp}"])
        zero_counts()
        t0 = time.time()
        res = evaluate(cfg_eval, episodes=n)
        torch.cuda.synchronize()
        t_eval = time.time() - t0
        rc = cli.main(["eval", str(cfg_path), f"run.policy={policy}",
                       f"run.resume_from={tmp}"])
        torch.cuda.synchronize()
        serve_counts = counts()
        print(f"{policy} serving path: evaluate({n} episodes) {res} in "
              f"{t_eval:.3f} s; cli eval rc={rc}; launches {serve_counts}",
              flush=True)
        if serve_counts[arm] < 2 or rc != 0:
            raise AssertionError(f"the {policy} serving path did not launch "
                                 f"{arm} twice")
        if not all(v == v and abs(v) != float("inf") for v in res.values()):
            raise AssertionError("evaluate returned non-finite stats")
        horizon = int(cfg.env.build()[1].horizon) + 1
        if res["episodes"] < n or not 1.0 <= res["ep_length_mean"] <= horizon:
            raise AssertionError(f"implausible evaluate stats {res}")
        small_gpu = evaluate(cfg_eval, episodes=512, device="cuda")
        small_cpu = evaluate(cfg_eval, episodes=512, device="cpu")
        print(f"{policy} evaluate(512) card {small_gpu} cpu {small_cpu}",
              flush=True)
        if (abs(small_gpu["episodes"] - small_cpu["episodes"])
                > 0.01 * small_cpu["episodes"]
                or abs(small_gpu["ep_return_mean"] - small_cpu["ep_return_mean"])
                > 0.01 * abs(small_cpu["ep_return_mean"])):
            raise AssertionError(f"{policy} evaluate on the card disagrees "
                                 f"with the CPU")
    return serve_counts


def path_lstm_training(cfg_path, tmp, overrides=LSTM_OVERRIDES):
    """train() at full width with a recurrent run.policy (lstm, or cnn_lstm
    in `overrides`) for 3 updates, then cli train for 2 and cli eval of its
    checkpoint. Returns the launch counts of train()."""
    import torch

    from drone_tpu_torch import cli, ppo_cuda
    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    over = [*overrides, f"run.checkpoint_dir={tmp}"]
    cfg = Config.from_toml(cfg_path).with_overrides(
        [*over, "run.total_updates=3"])
    policy = cfg.run.policy
    cfg = cfg.with_overrides([f"run.run_name={policy}"])
    sfx = " cnn" if policy == "cnn_lstm" else ""  # the arm's own counts
    n_mb = cfg.train.epochs * cfg.train.num_minibatches
    zero_counts()
    t0 = time.time()
    _, last = train(cfg)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    train_counts = counts()
    print(f"{policy} training path: train(hover.toml + {list(overrides)}, 3 "
          f"updates) in {t_train:.2f} s; launches {train_counts}; last {last}",
          flush=True)
    want = {"K6" + sfx: 3, "K7" + sfx: 3 * n_mb, "K4": 3 * n_mb}
    if any(train_counts[k] != v for k, v in want.items()):
        raise AssertionError(f"the {policy} training path launched "
                             f"{train_counts}, expected {want}")
    if not set(ppo_cuda.METRIC_KEYS) <= set(last):
        raise AssertionError(f"metric keys {sorted(last)}")
    if not all(v == v and abs(v) != float("inf") for k, v in last.items()
               if k in ppo_cuda.METRIC_KEYS):
        raise AssertionError(f"non-finite {policy} training metrics")

    zero_counts()
    rc = cli.main(["train", str(cfg_path), *over, "run.total_updates=2",
                   f"run.run_name={policy}_cli"])
    rc2 = cli.main(["eval", str(cfg_path), f"run.policy={policy}",
                    f"run.resume_from={tmp}/{policy}_cli/checkpoints"])
    torch.cuda.synchronize()
    cli_counts = counts()
    print(f"{policy} cli train (2 updates) rc={rc}, then cli eval of its "
          f"checkpoint rc={rc2}; launches {cli_counts}", flush=True)
    if (rc, rc2) != (0, 0) or cli_counts["K6" + sfx] != 2 \
            or cli_counts["K7" + sfx] != 2 * n_mb \
            or cli_counts["K8" + sfx] != 1:
        raise AssertionError(f"{policy} cli train + cli eval did not run as "
                             f"expected")
    return train_counts, cfg


def dtype_kwargs(compute_dtype) -> dict:
    """A trainer's compute_dtype argument, none for float32 (so that
    scripts/gate_seeds.py trains a checkout whose trainer takes none)."""
    return {} if compute_dtype == "float32" else {
        "compute_dtype": compute_dtype}


def lstm_gate_run(seed, compute_dtype="float32"):
    """The LSTM learning gate's training (H 32, encoder (32,), 256 envs,
    horizon 32, bptt 16, 4 epochs x 2 minibatches, lr 5e-3, no entropy
    bonus, 100 updates; its compute_dtype arm of K7), the model and the
    runner from one seed: gate_readings over 5-update windows."""
    import torch

    from drone_tpu_torch import ppo_rnn_cuda
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.models import LSTMActorCritic
    from drone_tpu_torch.ppo import PPOConfig
    from drone_tpu_torch.ppo_rnn import init_recurrent_runner

    env = DroneEnv(device="cuda")
    cfg = PPOConfig(horizon=32, num_envs=256, epochs=4, num_minibatches=2,
                    lr=5e-3, ent_coef=0.0, bptt_horizon=16)
    model = LSTMActorCritic(32, (32,),
                            generator=torch.Generator().manual_seed(seed))
    runner = init_recurrent_runner(model, env, cfg, seed=seed)
    return gate_readings(ppo_rnn_cuda.make_rnn_train_step(
        env, cfg, **dtype_kwargs(compute_dtype)), runner, 100, 5)


def phase_lstm_learning_and_resume(tmp):
    """The LSTM learning gate and bitwise resume on the card, at the shape
    of the reference's tests/test_pallas_update_lstm.py learning test: one
    run from seed 0 (gate_passes with GATES["lstm"])."""
    import torch

    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    t0 = time.time()
    run = lstm_gate_run(0)
    _, _, _, first, last5, finite = run
    print(f"LSTM learning gate: mean reward of the first 5 of 100 updates "
          f"{first:.4f}, of the last 5 {last5:.4f}; parameters finite "
          f"{finite} ({time.time() - t0:.1f} s)", flush=True)
    if not gate_passes(run, *GATES["lstm"][1:]):
        raise AssertionError("the LSTM learning gate failed on the card")

    def cfg_for(name, total, extra=()):
        return Config.default().with_overrides([
            "run.policy=lstm", "run.lstm_hidden=32", "run.hidden=32,32",
            "train.num_envs=1024", "train.horizon=16",
            "train.bptt_horizon=8", "train.epochs=2",
            "train.num_minibatches=2", "run.log_interval=2",
            f"run.total_updates={total}", f"run.run_name={name}",
            f"run.checkpoint_dir={tmp}", *extra])

    full, _ = train(cfg_for("lstm_full", 4))
    train(cfg_for("lstm_half", 2))
    resumed, _ = train(cfg_for("lstm_resumed", 4, [
        f"run.resume_from={tmp}/lstm_half/checkpoints"]))
    torch.cuda.synchronize()

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step, *r.carry]

    ok = all(bitwise_equal(a, b) for a, b in zip(tensors(full),
                                                 tensors(resumed)))
    print(f"LSTM resume on the card: train(4) == train(2) + resume(2) "
          f"bitwise: {ok}", flush=True)
    if not ok:
        raise AssertionError("LSTM resume is not bitwise on the card")


def host_ms(fn, depth, full):
    """A plain version's host-clock time at `depth` steps, scaled linearly
    to `full`."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    fn(depth)
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 * full / depth


def time_lstm(cfg, env, k7_args, model=None, plain_depths=(100, 32)):
    """Times of K8 (65,536 x 1,001), K6 (65,536 x 128) and K7 (one
    full-width minibatch), or of their CNN arms for a CNN-LSTM model, by
    CUDA events beside their plain versions and bounds, and one full-width
    update of cfg's policy split into its phases. The plain K8 and K6 run
    plain_depths steps, scaled linearly to the path's depth. Returns
    {name: (ms, plain_ms, bound_ms, bound_by, library_ms)}."""
    from drone_tpu_torch import ppo_rnn_cuda
    from drone_tpu_torch.models.lstm import is_cnn
    from drone_tpu_torch.ops import cuda_acting_lstm as K6
    from drone_tpu_torch.ops import cuda_update_lstm as K7

    tc = cfg.train
    model = model or lstm_policy(seed=2, log_std=0.0)
    arch = (model.hidden, model.encoder)
    H, enc = arch
    cnn = is_cnn(enc)
    P = model.flat.numel()
    n = tc.num_envs
    horizon = int(env.params.horizon) + 1
    out = {}
    state = env.init_batch(cfg.run.seed + 1, n)
    carry = model.initial_carry(n, "cuda")
    carry_bytes = 2 * 2 * H * n * 4
    state_bytes = n * (2 * 25 * 4 + 5 * 4)
    _, _, lane = K6.lstm_act_rollout_kernel(state, model.flat, arch, carry,
                                            env.params, env.statics, horizon)
    episodes = float(lane[1].sum())
    ms = cuda_ms(lambda: K6.lstm_act_rollout_kernel(
        state, model.flat, arch, carry, env.params, env.statics, horizon),
        reps=1 if cnn else 2, warm_up=False)
    plain = host_ms(lambda d: K6.lstm_act_rollout_plain(
        state, model.flat, arch, carry, env.params, env.statics, d),
        plain_depths[0], horizon)
    ops = (n * horizon * (OPS_STEP + OPS_OBS + lstm_ops(H, enc, False))
           + episodes * OPS_RESET)
    nbytes = state_bytes + carry_bytes + P * 4
    # the gate block on the tensor cores, and the CNN arm's tower
    mma = gate_mma_ops(H, enc) + (2 * CNN_MACS if cnn else 0)
    l2 = {"l2_fragment_bytes_per_lane_step": gate_l2_bytes(H, enc)}
    out["K8"] = (ms, plain, *acting_bounds(ops, n * horizon * mma, nbytes, l2))

    T, bptt = tc.horizon, ppo_rnn_cuda.bptt_of(tc)
    state = env.init_batch(9, n)
    _, _, _, _, lane = K6.traj_lstm_rollout_kernel(
        state, model.flat, arch, carry, env.params, env.statics, T, bptt)
    episodes = float(lane[1].sum())
    ms = cuda_ms(lambda: K6.traj_lstm_rollout_kernel(
        state, model.flat, arch, carry, env.params, env.statics, T, bptt),
        reps=2 if cnn else 3, warm_up=False)
    plain = host_ms(lambda d: K6.traj_lstm_rollout_plain(
        state, model.flat, arch, carry, env.params, env.statics, d, bptt),
        plain_depths[1], T)
    ops = (n * T * (OPS_STEP + OPS_OBS + lstm_ops(H, enc, True)
                    + OPS_NOISE_LOGP) + episodes * OPS_RESET)
    nbytes = (state_bytes + carry_bytes + P * 4 + T * 21 * n * 4
              + (T // bptt) * 2 * H * n * 4)
    out["K6"] = (ms, plain, *acting_bounds(ops, n * T * mma, nbytes, l2))

    planes, perm_mb, rbl = k7_args[0], k7_args[3], k7_args[7]
    samples = perm_mb.numel() * rbl * T
    ms = cuda_ms(lambda: K7.lstm_update_kernel(*k7_args),
                 reps=2 if cnn else 3, warm_up=False)
    plain = cuda_ms(lambda: K7.lstm_update_plain(*k7_args), reps=1,
                    warm_up=False)
    nbytes = (samples * 23 * 4 + (T // bptt) * 2 * H * perm_mb.numel() * rbl
              * 4 + P * 4 + (P + 8) * 4)
    ops = samples * bptt_ops(H, enc)
    # the gate block, [dx; dh] and the weight products on the tensor cores,
    # and the CNN arm's tower; beside the function's bound, the one its
    # scratch's bytes set, and the gate fragments it reads from L2
    mma = samples * (k7_mma_ops(H, enc) + (cnn_tower_mma_ops() if cnn else 0))
    scratch = samples * 4 * k7_scratch_floats(H, enc)
    t_ops = (mma / MMA_3XTF32_OPS_PER_S + (ops - mma) / FP32_OPS_PER_S) * 1e3
    out["K7"] = (ms, plain, *acting_bounds(ops, mma, nbytes, {
        "scratch_bytes": scratch,
        "bound_with_scratch_ms": max(
            t_ops, (nbytes + scratch) / HBM_BYTES_PER_S * 1e3),
        "l2_fragment_bytes_per_sample": gate_l2_bytes(H, enc, True)}))
    for name, (ms, plain, bms, by, lib, *extra) in out.items():
        print(f"{name} enc={enc_label(enc)}: kernel {ms:.4f} ms, plain "
              f"{plain:.2f} ms, bound {bms:.4f} ms ({by}), library {lib} "
              f"{extra}", flush=True)
    time_adam(model, cfg)
    split_update(cfg)
    return out


def time_adam(model, cfg):
    """K4 over a model's flat buffer (its kernel order's tensors) beside its
    plain version, bound and library pair (printed)."""
    import torch

    from drone_tpu_torch import ppo_cuda
    from drone_tpu_torch.models import tensor_sizes
    from drone_tpu_torch.ops import cuda_update as K4

    P = model.flat.numel()
    g = torch.Generator(device="cuda").manual_seed(4)
    grads = 0.05 * torch.randn(P, device="cuda", generator=g)
    theta, mu = model.flat.clone(), 0.01 * torch.randn(P, device="cuda",
                                                        generator=g)
    nu = 0.001 * torch.rand(P, device="cuda", generator=g)
    count = torch.tensor(5.0, device="cuda")
    sched = ppo_cuda.make_fused_lr(cfg.train)
    ac = K4.AdamConsts(clip_norm=cfg.train.max_grad_norm)
    sizes = tensor_sizes(model.kernel_order())
    k4 = cuda_ms(lambda: K4.fused_adam_kernel(theta, grads, mu, nu, count, ac,
                                              sched, sizes), reps=100)
    k4_plain = cuda_ms(lambda: K4.fused_adam_plain(
        theta, grads, mu, nu, count, ac, sched, sizes), reps=20)
    lib = adam_library_ms(model.flat, grads, model.kernel_order(), cfg.train)
    print(f"K4 over {type(model).__name__}'s layout ({P} "
          f"parameters, {len(sizes)} tensors): kernel {k4:.4f} ms, plain "
          f"{k4_plain:.3f} ms, bound {bound(P * 18, P * 4 * 7 + 8)[0]:.5f} ms "
          f"(bytes), library {lib:.4f} ms", flush=True)


# ---------------------------------------------------------------------------
# The CNN slice: K11 (serving), K9 (training rollout), K10 (PPO update)
# ---------------------------------------------------------------------------

CNN_OVERRIDES = ("run.policy=cnn", "train.horizon=128",
                 "train.num_minibatches=4")
# the patch CNN's shapes (PatchCNNActorCritic defaults): 36 conv0 patches of
# 64 inputs -> 64, 9 conv1 windows of 256 -> 64, trunk 576 -> 128
CNN_PIXELS = 36 * 64          # rendered pixel-channels a lane-step
CNN_MACS = 36 * 64 * 64 + 9 * 64 * 256 + 128 * 576


def cnn_tower_ops() -> int:
    """Operations of the patch-CNN tower on one lane-step: the 12 splat
    scalars (~70), the render (2 subs, 2 muls, an add, the scaled negation,
    the expf and the amplitude: 8 a pixel-channel), the three layers
    (multiply-adds x2, bias and relu a unit)."""
    units = 36 * 64 + 9 * 64 + 128
    return 70 + 8 * CNN_PIXELS + 2 * CNN_MACS + 2 * units


def cnn_tower_bwd_ops() -> int:
    """Operations of the tower's backward on one sample, from the gradient at
    its output: the trunk's mask, the weight gradients of the trunk, conv1
    and conv0 with their bias sums (multiply-adds x2 + 1 a weight row), the
    input gradients dX2 and dX1 with their relu masks, and the re-render of
    the 36 patches."""
    ops = 128 + 2 * CNN_MACS + 128 + 9 * 64 + 36 * 64
    ops += 2 * (128 * 576 + 9 * 64 * 256) + 576 + 2304
    return ops + 8 * CNN_PIXELS


def cnn_tower_mma_ops() -> int:
    """The tower's matrix operations on one sample that K10 and K7's CNN arm
    run on the tensor cores (multiply-adds x2): the forward (CNN_MACS), the
    weight gradients of conv0, conv1 and the trunk (CNN_MACS), dX2 and dX1.
    958,464 multiply-adds; the kernels' re-run of conv0 is not counted, as
    the function does not need it."""
    return 2 * (2 * CNN_MACS + 128 * 576 + 9 * 64 * 256)


def cnn_ops(value: bool) -> int:
    """Operations of one CNN lane-step: the tower, the action head and the
    value head when asked."""
    return cnn_tower_ops() + 2 * 4 * 128 + 4 + (2 * 128 + 1 if value else 0)


def cnn_update_ops() -> int:
    """Operations of one sample through K10's function (the reference's
    _cnn_block_grads): the forward with both heads, the PPO head, the heads'
    gradients and dh, and the tower's backward."""
    return (cnn_ops(True) + OPS_PPO_HEAD + 2 * 5 * 129 + 2 * 5 * 128
            + cnn_tower_bwd_ops())


def acting_bounds(ops, mma_ops, nbytes, extra=None):
    """(bound_ms, bound_by, library_ms, notes) of a kernel whose tower
    and/or gate block products run on the tensor cores in 3xTF32: the
    tensor-pipe bound, and notes for the kernel's printed line: the fp32
    bound beside it, and `extra`."""
    tb = tensor_bound(mma_ops, ops - mma_ops, nbytes)
    return (*tb, None, {"tensor_bound_ms": tb[0],
                        "fp32_bound_ms": bound(ops, nbytes)[0],
                        **(extra or {})})


def cnn_policy(seed=1, log_std=-0.5):
    """A seeded PatchCNNActorCritic on the card, flattened as the trainer
    keeps it, with actions of order 1 and a given log_std."""
    import torch
    from torch import nn

    from drone_tpu_torch.models import PatchCNNActorCritic

    g = torch.Generator().manual_seed(seed)
    m = PatchCNNActorCritic(generator=g)
    with torch.no_grad():
        nn.init.orthogonal_(m.actor_mean.weight, 1.0, generator=g)
        m.log_std.fill_(log_std)
    m = m.cuda()
    m.flatten_()
    return m


def phase_k11(cases=None) -> float:
    """K11 against its plain version on the card; returns the max abs error
    of the T = 3 final states and statistics."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting_cnn as K11
    from drone_tpu_torch.types import default_params

    # the main path's width (deterministic, and K9's noise at T = 3), then
    # a ragged last lane tile (40 of a tile's 64) on waypoint/rk4
    cases = cases or [
        ("hover", "euler", 65536, ((3, 2, False), (3, 2, True),
                                   (64, 40, False))),
        ("waypoint", "rk4", 8192 + 40, ((3, 2, False),))]
    model = cnn_policy()
    max_err = 0.0
    for task, integ, n, runs in cases:
        for T, horizon, sto in runs:
            env = DroneEnv(task, integ, default_params(task, horizon=horizon),
                           device="cuda")
            state = env.init_batch(2, n)
            kf, ks = K11.cnn_act_rollout_kernel(state, model.flat, model.arch,
                                                env.params, env.statics, T,
                                                sto)
            pf, ps = K11.cnn_act_rollout_plain(state, model.flat, model.arch,
                                               env.params, env.statics, T,
                                               sto)
            torch.cuda.synchronize()
            k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
            k_r, p_r = float(ks[0].sum()) / (n * T), float(ps[0].sum()) / (n * T)
            err = max(float((kf.fstate() - pf.fstate()).abs().max()),
                      float((ks - ps).abs().max()))
            print(f"K11 {task}/{integ} n={n} T={T} stochastic={sto}: "
                  f"max|state, stats err|="
                  f"{err:.3g} episodes {k_ep:.0f} vs {p_ep:.0f}, mean reward "
                  f"{k_r:.6f} vs {p_r:.6f}", flush=True)
            if T == 3:
                max_err = max(max_err, err)
                torch.testing.assert_close(kf.fstate(), pf.fstate(),
                                           rtol=2e-5, atol=2e-6)
                torch.testing.assert_close(ks, ps, rtol=2e-5, atol=2e-6)
                if k_ep != p_ep or k_ep < n:
                    raise AssertionError("K11 episode counts differ at T=3")
                kf2, ks2 = K11.cnn_act_rollout_kernel(
                    state, model.flat, model.arch, env.params, env.statics,
                    T, sto)
                check_repeat("K11", (kf.fstate(), ks), (kf2.fstate(), ks2))
            elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                raise AssertionError("K11 episode statistics disagree")
    return max_err


def phase_k9() -> float:
    """K9 against its plain version on the card; returns the max abs error
    of the T = 3 planes and final states."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting_cnn as K9
    from drone_tpu_torch.types import default_params

    n = 65536
    model = cnn_policy()
    max_err = 0.0
    for T, horizon, modes in ((3, 2, (False, True)), (128, 40, (True,))):
        env = DroneEnv("hover", "euler", default_params("hover",
                                                         horizon=horizon),
                       device="cuda")
        state = env.init_batch(5, n)
        for sto in modes:
            kf, kp, ks = K9.traj_cnn_rollout_kernel(
                state, model.flat, model.arch, env.params, env.statics, T,
                sto)
            pf, pp, ps = K9.traj_cnn_rollout_plain(
                state, model.flat, model.arch, env.params, env.statics, T,
                sto)
            torch.cuda.synchronize()
            k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
            k_r, p_r = float(ks[0].sum()) / (n * T), float(ps[0].sum()) / (n * T)
            err = max(float((kp - pp).abs().max()),
                      float((kf.fstate() - pf.fstate()).abs().max()))
            print(f"K9 hover n={n} T={T} stochastic={sto}: max|plane, state "
                  f"err|={err:.3g} episodes {k_ep:.0f} vs {p_ep:.0f}, mean "
                  f"reward {k_r:.6f} vs {p_r:.6f}", flush=True)
            if T == 3:
                max_err = max(max_err, err)
                torch.testing.assert_close(kp, pp, rtol=2e-5, atol=2e-6)
                torch.testing.assert_close(kf.fstate(), pf.fstate(),
                                           rtol=2e-5, atol=2e-6)
                if k_ep != p_ep or k_ep < n:
                    raise AssertionError("K9 episode counts differ at T=3")
                kf2, kp2, ks2 = K9.traj_cnn_rollout_kernel(
                    state, model.flat, model.arch, env.params, env.statics, T,
                    sto)
                check_repeat("K9", (kf.fstate(), kp, ks),
                             (kf2.fstate(), kp2, ks2))
            elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                raise AssertionError("K9 episode statistics disagree")
    return max_err


def cnn_minibatch(cfg, model, env, compute_dtype="float32"):
    """The CNN update's inputs at full width on the card: K9's planes (its
    compute_dtype arm), their normalized advantages, a minibatch's row
    blocks."""
    import torch

    from drone_tpu_torch import ppo_cuda
    from drone_tpu_torch.env import observe
    from drone_tpu_torch.ops import cuda_acting_cnn as K9
    from drone_tpu_torch.pixels import patch_grid

    tc = cfg.train
    _, _, rbu, n_rb, mb_rb, co = ppo_cuda.plan_minibatch_geometry(
        tc, tc.num_envs)
    state = env.init_batch(7, tc.num_envs)
    final, planes, _ = K9.traj_cnn_rollout_kernel(
        state, model.flat, model.arch, env.params, env.statics, tc.horizon,
        compute_dtype=compute_dtype)
    with torch.no_grad():
        if compute_dtype == "float32":
            last_value = model(observe(final))[2]
        else:  # the trainer's: the plane-space forward, bf16 operands
            last_value = K9.cnn_forward(
                observe(final), K9.cnn_all_weights(model.flat, model.arch),
                *patch_grid(model.arch.res, model.arch.p0, "cuda"),
                model.arch.geom, compute_dtype=compute_dtype)[1]
    advret = ppo_cuda.normalized_advret(planes, last_value, tc)
    perm = torch.randperm(n_rb, generator=torch.Generator().manual_seed(3))
    perm_mb = perm[:mb_rb].to(device="cuda", dtype=torch.int32)
    return planes, advret, perm_mb, co, rbu * 128


def check_k10(args, order, each_stat: bool):
    """K10 against its plain version on one minibatch (compare_grads), and
    two launches of the kernel on the same inputs bitwise equal."""
    import torch

    from drone_tpu_torch.ops import cuda_update_cnn as K10

    kg, ks = K10.ppo_cnn_update_kernel(*args)
    kg2, ks2 = K10.ppo_cnn_update_kernel(*args)
    pg, ps = K10.ppo_cnn_update_plain(*args)
    torch.cuda.synchronize()
    if not (bitwise_equal(kg, kg2) and bitwise_equal(ks, ks2)):
        raise AssertionError("two K10 launches on the same inputs differ")
    planes, perm_mb, rbl = args[0], args[2], args[6]
    err = compare_grads(
        f"K10 minibatch ({perm_mb.numel()} row blocks of {rbl} lanes x "
        f"{planes.shape[0]} steps; two launches bitwise equal)",
        kg, ks, pg, ps, order, each_stat)
    return err, ps


def phase_k10_k4(cfg, env):
    """K10 against its plain version at the full-width minibatch, on the
    planes' own weights and off them, and K4 over the CNN layout. Returns
    (K10 max abs error, inputs for timing, K4 max abs error)."""
    from drone_tpu_torch.ops import cuda_update as K4
    from drone_tpu_torch.ops import cuda_update_cnn as K10

    model = cnn_policy()
    order = model.kernel_order()
    planes, advret, perm_mb, co, rbl = cnn_minibatch(cfg, model, env)
    args = (planes, advret, perm_mb, model.flat, model.arch, co, rbl,
            cfg.train.ent_coef)
    k10_err, _ = check_k10(args, order, each_stat=False)
    # off the planes' weights. At the MLP's and LSTM's noise no sample's v
    # left v_old +- vf_clip (10) here, so the value head takes more: the
    # first of a few scales whose
    # minibatch takes every branch of the head's subgradients on >= 0.1%
    # of the samples
    for critic_scale in (16.0, 64.0, 256.0):
        theta = off_policy(model.flat, order, critic_scale=critic_scale)
        n = K10.cnn_head_branch_counts(planes, advret, perm_mb, theta,
                                       model.arch, co, rbl)
        try:
            check_branches(f"K10 (critic noise {critic_scale})", n)
            break
        except AssertionError:
            if critic_scale == 256.0:
                raise
    err, ps = check_k10((*args[:3], theta, *args[4:]), order, each_stat=True)
    if float(ps[K4.ST_KL]) == 0.0 or float(ps[K4.ST_CF]) == 0.0:
        raise AssertionError("the off-policy approx-KL or clip-fraction sum "
                             "is 0")
    k10_err = max(k10_err, err)

    k4_err, _ = check_k4(model.flat, order, cfg, "the CNN layout")
    return k10_err, args, k4_err


def path_cnn_serving(cfg, cfg_path):
    """evaluate() and cli eval of a seeded CNN policy on hover.toml with
    run.policy=cnn; the card's evaluate(512) against the CPU's. Returns the
    launch counts of the path."""
    import torch

    from drone_tpu_torch import cli
    from drone_tpu_torch.train import evaluate
    from drone_tpu_torch.utils.checkpoint import Checkpointer

    n = cfg.train.num_envs
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(0, cnn_policy(seed=2, log_std=0.0))
        cfg_eval = cfg.with_overrides([f"run.resume_from={tmp}"])
        zero_counts()
        t0 = time.time()
        res = evaluate(cfg_eval, episodes=n)
        torch.cuda.synchronize()
        t_eval = time.time() - t0
        rc = cli.main(["eval", str(cfg_path), "run.policy=cnn",
                       f"run.resume_from={tmp}"])
        torch.cuda.synchronize()
        serve_counts = counts()
        print(f"CNN serving path: evaluate({n} episodes) {res} in "
              f"{t_eval:.3f} s; cli eval rc={rc}; launches {serve_counts}",
              flush=True)
        if serve_counts["K11"] < 2 or rc != 0:
            raise AssertionError("the CNN serving path did not launch K11 "
                                 "twice")
        if not all(v == v and abs(v) != float("inf") for v in res.values()):
            raise AssertionError("evaluate returned non-finite stats")
        horizon = int(cfg.env.build()[1].horizon) + 1
        if res["episodes"] < n or not 1.0 <= res["ep_length_mean"] <= horizon:
            raise AssertionError(f"implausible evaluate stats {res}")
        small_gpu = evaluate(cfg_eval, episodes=512, device="cuda")
        small_cpu = evaluate(cfg_eval, episodes=512, device="cpu")
        print(f"CNN evaluate(512) card {small_gpu} cpu {small_cpu}",
              flush=True)
        if (abs(small_gpu["episodes"] - small_cpu["episodes"])
                > 0.01 * small_cpu["episodes"]
                or abs(small_gpu["ep_return_mean"] - small_cpu["ep_return_mean"])
                > 0.01 * abs(small_cpu["ep_return_mean"])):
            raise AssertionError("CNN evaluate on the card disagrees with "
                                 "the CPU")
    return serve_counts


def path_cnn_training(cfg_path, tmp):
    """train() at the CNN geometry for 3 updates, then cli train for 2 and
    cli eval of its checkpoint. Returns the launch counts of train()."""
    import torch

    from drone_tpu_torch import cli, ppo_cuda
    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    over = [*CNN_OVERRIDES, f"run.checkpoint_dir={tmp}"]
    cfg = Config.from_toml(cfg_path).with_overrides(
        [*over, "run.total_updates=3", "run.run_name=cnn"])
    n_mb = cfg.train.epochs * cfg.train.num_minibatches
    zero_counts()
    t0 = time.time()
    _, last = train(cfg)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    train_counts = counts()
    print(f"CNN training path: train(hover.toml + {list(CNN_OVERRIDES)}, 3 "
          f"updates) in {t_train:.2f} s; launches {train_counts}; last {last}",
          flush=True)
    want = {"K9": 3, "K10": 3 * n_mb, "K4": 3 * n_mb}
    if any(train_counts[k] != v for k, v in want.items()):
        raise AssertionError(f"the CNN training path launched "
                             f"{train_counts}, expected {want}")
    if not set(ppo_cuda.METRIC_KEYS) <= set(last):
        raise AssertionError(f"metric keys {sorted(last)}")
    if not all(v == v and abs(v) != float("inf") for k, v in last.items()
               if k in ppo_cuda.METRIC_KEYS):
        raise AssertionError("non-finite CNN training metrics")

    zero_counts()
    rc = cli.main(["train", str(cfg_path), *over, "run.total_updates=2",
                   "run.run_name=cnn_cli"])
    rc2 = cli.main(["eval", str(cfg_path), "run.policy=cnn",
                    f"run.resume_from={tmp}/cnn_cli/checkpoints"])
    torch.cuda.synchronize()
    cli_counts = counts()
    print(f"CNN cli train (2 updates) rc={rc}, then cli eval of its "
          f"checkpoint rc={rc2}; launches {cli_counts}", flush=True)
    if (rc, rc2) != (0, 0) or cli_counts["K9"] != 2 \
            or cli_counts["K10"] != 2 * n_mb or cli_counts["K11"] != 1:
        raise AssertionError("CNN cli train + cli eval did not run as "
                             "expected")
    return train_counts


def gate_readings(step, runner, updates, window):
    """A learning gate's readings of `updates` train steps: (value loss of
    the `window` updates from the third, its lowest `window`-update mean, of
    the last `window`; mean reward of the first `window` updates, of the
    last `window`; parameters finite)."""
    import torch

    vloss, rewards = [], []
    for _ in range(updates):
        runner, m = step(runner)
        vloss.append(float(m["v_loss"]))
        rewards.append(float(m["reward_mean"]))

    def mean(xs, i):
        return sum(xs[i:i + window]) / window

    return (mean(vloss, 2),
            min(mean(vloss, i) for i in range(len(vloss) - window + 1)),
            mean(vloss, len(vloss) - window), mean(rewards, 0),
            mean(rewards, len(rewards) - window),
            bool(torch.isfinite(runner.params.flat).all()))


def gate_passes(run, fall, rise) -> bool:
    """One run's rule: its lowest value-loss mean below `fall` x its early
    one (unless fall is None), its mean reward risen by more than `rise`,
    its parameters finite."""
    early, lowest, _, r_first, r_last, finite = run
    return ((fall is None or lowest < fall * early)
            and r_last > r_first + rise and finite)


def gate_verdict(runs, fall, rise):
    """A learning gate over several runs: (passed, the mean reward rise).
    Every run must have its value loss fall (below `fall` x its early one,
    unless None), its mean reward rise and its parameters finite; the
    rise's mean over the runs must exceed `rise`."""
    mean_rise = sum(r_last - r_first for _, _, _, r_first, r_last, _ in runs) \
        / len(runs)
    each = all(gate_passes(r, fall, 0.0) for r in runs)
    return each and mean_rise > rise, mean_rise


# the seeds of the CNN and cnn_lstm learning gates: one run's reward rise
# is a sample (its spread from seed to seed is ~0.1, against the 0.2
# asked), so each gate holds the mean rise of four runs to its threshold
# and every run to the rest
GATE_SEEDS = range(4)


def cnn_gate_run(seed, compute_dtype="float32"):
    """The CNN learning gate's training (4,096 envs, horizon 32, 2 epochs x
    2 minibatches, lr 1e-3, no entropy bonus, 150 updates; its
    compute_dtype arms), the model and the runner from one seed:
    gate_readings over 10-update windows."""
    import torch

    from drone_tpu_torch import ppo_cnn_cuda
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.models import PatchCNNActorCritic
    from drone_tpu_torch.ppo import PPOConfig, init_runner

    env = DroneEnv(device="cuda")
    cfg = PPOConfig(horizon=32, num_envs=4096, epochs=2, num_minibatches=2,
                    lr=1e-3, ent_coef=0.0)
    model = PatchCNNActorCritic(generator=torch.Generator().manual_seed(seed))
    runner = init_runner(model, env, cfg, seed=seed)
    return gate_readings(ppo_cnn_cuda.make_cnn_train_step(
        env, cfg, compute_dtype=compute_dtype), runner, 150, 10)


def cnn_gate(seeds, compute_dtype="float32"):
    """The CNN learning gate's runs from each seed, one after another
    (cnn_gate_run; in processes of their own at once they took 29.4 s
    against 18-19.5 s on an H100, PERF.md), each printed: (passed, the mean
    reward rise), gate_verdict with GATES["cnn"]."""
    runs = []
    for seed in seeds:
        t0 = time.time()
        runs.append(cnn_gate_run(seed, compute_dtype))
        early, lowest, last, r_first, r_last, finite = runs[-1]
        print(f"{compute_dtype} CNN learning gate (150 updates, seed {seed}): "
              f"value loss of updates 3-12 {early:.5g}, its lowest 10-update "
              f"mean {lowest:.5g}, of the last 10 {last:.5g}; mean reward of "
              f"the first 10 {r_first:.4f}, of the last 10 {r_last:.4f} (rise "
              f"{r_last - r_first:.4f}); parameters finite {finite} "
              f"({time.time() - t0:.1f} s)", flush=True)
    return gate_verdict(runs, *GATES["cnn"][1:])


def phase_cnn_learning_and_resume(tmp):
    """The CNN learning gate and bitwise resume on the card. Over 150
    updates at a size the kernels take, in a run from each of seeds 0-3,
    the mean reward must rise, and the value loss must fall, as
    tests/test_pallas_cnn.py's gate asks, at some point: once the policy
    improves, the returns grow and the value loss with them, so its last
    updates are not the place to read it (gate_verdict with GATES["cnn"]:
    each value loss below half, the mean rise above 0.2). A failed gate
    is raised after the resume check has run."""
    import torch

    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    learned, rise = cnn_gate(GATE_SEEDS)
    print(f"CNN learning gate: mean reward rise over seeds "
          f"{list(GATE_SEEDS)} {rise:.4f}", flush=True)

    def cfg_for(name, total, extra=()):
        return Config.default().with_overrides([
            "run.policy=cnn", "train.num_envs=1024", "train.horizon=16",
            "train.epochs=2", "train.num_minibatches=2", "run.log_interval=2",
            f"run.total_updates={total}", f"run.run_name={name}",
            f"run.checkpoint_dir={tmp}", *extra])

    full, _ = train(cfg_for("cnn_full", 4))
    train(cfg_for("cnn_half", 2))
    resumed, _ = train(cfg_for("cnn_resumed", 4, [
        f"run.resume_from={tmp}/cnn_half/checkpoints"]))
    torch.cuda.synchronize()

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step]

    ok = all(bitwise_equal(a, b) for a, b in zip(tensors(full),
                                                 tensors(resumed)))
    print(f"CNN resume on the card: train(4) == train(2) + resume(2) "
          f"bitwise: {ok}", flush=True)
    if not ok:
        raise AssertionError("CNN resume is not bitwise on the card")
    if not learned:
        raise AssertionError("the CNN learning gate failed on the card")


def time_cnn(cfg, env, k10_args):
    """Times of K11 (65,536 x 1,001), K9 (65,536 x 128), K10 (one full-width
    minibatch, k10_args) and K4 over the CNN layout by CUDA events beside
    their plain versions and bounds, and one full-width CNN update split
    into its phases. The plain K11 and K9 are timed at a reduced depth (10
    and 32 steps) and scaled to the path's, linearly. Returns {name: (ms,
    plain_ms, bound_ms, bound_by, library_ms)}."""
    from drone_tpu_torch.ops import cuda_acting_cnn as K9
    from drone_tpu_torch.ops import cuda_update_cnn as K10

    tc = cfg.train
    model = cnn_policy(seed=2, log_std=0.0)
    P = model.flat.numel()
    n = tc.num_envs
    horizon = int(env.params.horizon) + 1
    state_bytes = n * (2 * 25 * 4 + 5 * 4)
    out = {}

    state = env.init_batch(cfg.run.seed + 1, n)
    _, lane = K9.cnn_act_rollout_kernel(state, model.flat, model.arch,
                                        env.params, env.statics, horizon)
    episodes = float(lane[1].sum())
    ms = cuda_ms(lambda: K9.cnn_act_rollout_kernel(
        state, model.flat, model.arch, env.params, env.statics, horizon),
        reps=1, warm_up=False)
    plain = host_ms(lambda T: K9.cnn_act_rollout_plain(
        state, model.flat, model.arch, env.params, env.statics, T), 10,
        horizon)
    ops = (n * horizon * (OPS_STEP + OPS_OBS + cnn_ops(False))
           + episodes * OPS_RESET)
    out["K11"] = (ms, plain, *acting_bounds(ops, n * horizon * 2 * CNN_MACS,
                                            state_bytes + P * 4))

    T = tc.horizon
    state = env.init_batch(9, n)
    _, _, lane = K9.traj_cnn_rollout_kernel(state, model.flat, model.arch,
                                            env.params, env.statics, T)
    episodes = float(lane[1].sum())
    ms = cuda_ms(lambda: K9.traj_cnn_rollout_kernel(
        state, model.flat, model.arch, env.params, env.statics, T), reps=3,
        warm_up=False)
    plain = host_ms(lambda d: K9.traj_cnn_rollout_plain(
        state, model.flat, model.arch, env.params, env.statics, d), 32, T)
    ops = (n * T * (OPS_STEP + OPS_OBS + cnn_ops(True) + OPS_NOISE_LOGP)
           + episodes * OPS_RESET)
    out["K9"] = (ms, plain, *acting_bounds(
        ops, n * T * 2 * CNN_MACS, state_bytes + P * 4 + T * 21 * n * 4))

    args = k10_args
    planes, perm_mb, rbl = args[0], args[2], args[6]
    samples = perm_mb.numel() * rbl * planes.shape[0]
    ms = cuda_ms(lambda: K10.ppo_cnn_update_kernel(*args), reps=2,
                 warm_up=False)
    plain = cuda_ms(lambda: K10.ppo_cnn_update_plain(*args), reps=1,
                    warm_up=False)
    nbytes = samples * 23 * 4 + P * 4 + (P + 8) * 4
    ops, mma = samples * cnn_update_ops(), samples * cnn_tower_mma_ops()
    tb = tensor_bound(mma, ops - mma, nbytes)
    out["K10"] = (ms, plain, *tb, None, {"tensor_bound_ms": tb[0],
                                         "fp32_bound_ms": bound(ops, nbytes)[0]})

    time_adam(model, cfg)
    for name, (ms, plain, bms, by, lib, *extra) in out.items():
        print(f"{name}: kernel {ms:.4f} ms, plain {plain:.2f} ms, bound "
              f"{bms:.4f} ms ({by}), library {lib} {extra}", flush=True)
    split_update(cfg)
    return out


# ---------------------------------------------------------------------------
# F5, and the pixel-recurrent slice: the CNN arms of K8, K6 and K7
# ---------------------------------------------------------------------------

CNN_LSTM_OVERRIDES = ("run.policy=cnn_lstm", "train.horizon=128",
                      "train.bptt_horizon=16", "train.num_minibatches=4")
# the cnn_lstm learning gate: its length, and the fall of the value loss
# (the lowest 10-update mean against updates 3-12) and the rise of the mean
# reward (the last 10 updates against the first 10) it asks for
GATE_UPDATES = 150
GATE_VLOSS_FALL = 0.75
GATE_REWARD_RISE = 0.2


def cnn_lstm_policy(seed=1, log_std=-0.5):
    """A seeded CNNLSTMActorCritic (the default tower, hidden 128) on the
    card, flattened, as lstm_policy."""
    from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH

    return lstm_policy(128, KERNEL_ARCH, seed, log_std)


def phase_f5(cfg_path):
    """evaluate() on the card serves the policies its acting kernels cannot
    take through the module (the K5 and K8 counts stay 0), and build()
    trains an MLP that K2 and K3 cannot take on the scan trainer (and
    refuses it under run.rollout=pallas)."""
    import torch

    from drone_tpu_torch.train import build, build_env_and_model, evaluate
    from drone_tpu_torch.utils.config import Config

    # episodes of 200 steps: the routing, not the depth, is what is checked
    for over in (["run.hidden=256,256"],
                 ["run.policy=lstm", "run.lstm_hidden=256"],
                 ["run.policy=cnn_lstm", "run.lstm_hidden=256"]):
        cfg = Config.from_toml(cfg_path).with_overrides(
            [*over, "env.params.horizon=200"])
        _, model = build_env_and_model(cfg)
        zero_counts()
        t0 = time.time()
        res = evaluate(cfg, runner=types.SimpleNamespace(params=model),
                       episodes=1024)
        torch.cuda.synchronize()
        c = counts()
        print(f"F5: evaluate(hover.toml + {over}, 1024 episodes of 200 "
              f"steps) {res} in "
              f"{time.time() - t0:.2f} s through the module; K5 {c['K5']}, "
              f"K8 {c['K8']} launches", flush=True)
        if c["K5"] or c["K8"]:
            raise AssertionError("evaluate launched an acting kernel on a "
                                 "policy outside its envelope")
        if res["episodes"] < 1024 or not all(
                v == v and abs(v) != float("inf") for v in res.values()):
            raise AssertionError(f"implausible evaluate stats {res}")
    wide = Config.from_toml(cfg_path).with_overrides(["run.hidden=256,256"])
    _, _, _, step, _ = build(wide)
    try:
        build(wide.with_overrides(["run.rollout=pallas"]))
    except ValueError as e:
        print(f"F5: build(run.hidden=[256, 256]) trains on {step.__module__}"
              f"; with run.rollout=pallas refused: {e}", flush=True)
    else:
        raise AssertionError("build took an MLP past K2 and K3 on the "
                             "megakernel trainer")
    if step.__module__ != "drone_tpu_torch.ppo":
        raise AssertionError(f"build(run.hidden=[256, 256]) picked "
                             f"{step.__module__}, not the scan trainer")


def cnn_lstm_gate_run(seed, compute_dtype="float32"):
    """The cnn_lstm learning gate's training (2,048 envs, horizon 32, bptt
    16, 2 epochs x 2 minibatches, lr 2e-3, no entropy bonus, GATE_UPDATES
    updates; its compute_dtype arm of K7), the model and the runner from
    one seed: gate_readings over 10-update windows."""
    import torch

    from drone_tpu_torch import ppo_rnn_cuda
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.models import CNNLSTMActorCritic
    from drone_tpu_torch.ppo import PPOConfig
    from drone_tpu_torch.ppo_rnn import init_recurrent_runner

    env = DroneEnv(device="cuda")
    cfg = PPOConfig(horizon=32, num_envs=2048, epochs=2, num_minibatches=2,
                    lr=2e-3, ent_coef=0.0, bptt_horizon=16)
    model = CNNLSTMActorCritic(
        generator=torch.Generator().manual_seed(seed))
    runner = init_recurrent_runner(model, env, cfg, seed=seed)
    return gate_readings(ppo_rnn_cuda.make_rnn_train_step(
        env, cfg, **dtype_kwargs(compute_dtype)), runner, GATE_UPDATES, 10)


def cnn_lstm_gate(seeds, compute_dtype="float32"):
    """The cnn_lstm learning gate's runs from each seed, one after another
    (cnn_lstm_gate_run), each printed: (passed, the mean reward rise),
    gate_verdict with GATES["cnn_lstm"]."""
    runs = []
    for seed in seeds:
        t0 = time.time()
        runs.append(cnn_lstm_gate_run(seed, compute_dtype))
        early, lowest, last, r_first, r_last, finite = runs[-1]
        print(f"{compute_dtype} cnn_lstm learning gate ({GATE_UPDATES} "
              f"updates, seed {seed}): value loss of updates 3-12 "
              f"{early:.5g}, its lowest 10-update mean {lowest:.5g}, of the "
              f"last 10 {last:.5g}; mean reward of the first 10 "
              f"{r_first:.4f}, of the last 10 {r_last:.4f} (rise "
              f"{r_last - r_first:.4f}); parameters finite {finite} "
              f"({time.time() - t0:.1f} s)", flush=True)
    return gate_verdict(runs, *GATES["cnn_lstm"][1:])


# each learning gate but the MLP's (mlp_gate_run, a threshold within a
# budget): (its training from a seed, the value loss's fall it asks or
# None, the mean reward's rise it asks); scripts/gate_seeds.py runs them
# from several seeds
GATES = {"cnn": (cnn_gate_run, 0.5, 0.2), "lstm": (lstm_gate_run, None, 0.15),
         "cnn_lstm": (cnn_lstm_gate_run, GATE_VLOSS_FALL, GATE_REWARD_RISE)}


def phase_cnn_lstm_learning_and_resume(tmp):
    """The cnn_lstm learning gate and bitwise resume on the card, after the
    CNN's (phase 24): over GATE_UPDATES updates at 2,048 envs, in a run from
    each of seeds 0-3, the value loss must fall and the mean reward rise
    (gate_verdict with GATES["cnn_lstm"]). The value loss reaches ~0.5-0.7
    of its early level before the improving policy's growing returns raise
    it again, where the CNN's fell below half. Four runs, as the CNN's,
    because one run's rule failed three of seeds 0-11 on the parent of this
    form (scripts/gate_seeds.py). A failed gate is raised after the resume
    check has run."""
    import torch

    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    learned, rise = cnn_lstm_gate(GATE_SEEDS)
    print(f"cnn_lstm learning gate: mean reward rise over seeds "
          f"{list(GATE_SEEDS)} {rise:.4f}", flush=True)

    def cfg_for(name, total, extra=()):
        return Config.default().with_overrides([
            "run.policy=cnn_lstm", "train.num_envs=1024", "train.horizon=16",
            "train.bptt_horizon=8", "train.epochs=2",
            "train.num_minibatches=2", "run.log_interval=2",
            f"run.total_updates={total}", f"run.run_name={name}",
            f"run.checkpoint_dir={tmp}", *extra])

    full, _ = train(cfg_for("cnn_lstm_full", 4))
    train(cfg_for("cnn_lstm_half", 2))
    resumed, _ = train(cfg_for("cnn_lstm_resumed", 4, [
        f"run.resume_from={tmp}/cnn_lstm_half/checkpoints"]))
    torch.cuda.synchronize()

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step, *r.carry]

    ok = all(bitwise_equal(a, b) for a, b in zip(tensors(full),
                                                 tensors(resumed)))
    print(f"cnn_lstm resume on the card: train(4) == train(2) + resume(2) "
          f"bitwise: {ok}", flush=True)
    if not ok:
        raise AssertionError("cnn_lstm resume is not bitwise on the card")
    if not learned:
        raise AssertionError("the cnn_lstm learning gate failed on the card")


# the reference's bench keys (bench.py main): the secondary phases, and
# the top level with the port's "device"
BENCH_SECONDARY = (
    "acting_megakernel_sps", "scan_policy_rollout_sps", "traj_rollout_sps",
    "lstm_acting_sps", "cnn_acting_sps", "cnn_lstm_acting_sps",
    "train_sps_64k", "scan_train_sps_64k", "train_sps_262k",
    "lstm_train_sps_64k", "scan_lstm_train_sps_64k", "cnn_lstm_train_sps_64k",
    "cnn_train_sps_64k", "cnn_train_sps_4k", "scan_cnn_train_sps_4k",
    "scan_cnn_overlap_train_sps_64k")
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "secondary",
              "spread", "repeats", "device")


# the bench's lane and env counts (drone_tpu_torch/bench.py): its serving
# phases' lanes and train_sps_262k's envs
BENCH_LANES = 131072
BENCH_TRAIN_ENVS = 262144


def phase_bench_shapes(cfg, env) -> dict:
    """The bench path's kernels against their plain versions at the bench's
    own lane and env counts, at the tolerances of their own checks and a
    short T: K1 bitwise (in-kernel actions, as the bench draws them), K5,
    K8's both arms, K11 and K2 at 131,072 lanes, and one train_sps_262k
    minibatch (262,144 envs x 128 steps in 4 minibatches, 8.4 M samples)
    through K2 (also checked at T = 3 over 262,144 lanes), K3 (off the
    weights that wrote the planes, every branch taken) and K4 (on K3's
    gradients). Returns {kernel: max abs error}."""
    from drone_tpu_torch.models import kernel_order
    from drone_tpu_torch.ops import cuda_update as K3
    from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH

    n = BENCH_LANES
    hover = ("hover", "euler")
    err = {"K1": phase_k1([(*hover, n, 32, 20, ("in-kernel",))]),
           "K5": phase_k5([(*hover, (64, 64), n, ((3, 2),))]),
           "K8": phase_k8([(*hover, 128, (64,), n, ((3, 2),))]),
           "K8 cnn": phase_k8([(*hover, 128, KERNEL_ARCH, n, ((3, 2),))],
                              name="K8 cnn arm"),
           "K11": phase_k11([(*hover, n, ((3, 2, False),))]),
           "K2": phase_k2([(*hover, (64, 64), n, ((3, 2),)),
                           (*hover, (64, 64), BENCH_TRAIN_ENVS, ((3, 2),))])}
    cfg = cfg.with_overrides([f"train.num_envs={BENCH_TRAIN_ENVS}",
                              "train.horizon=128", "train.num_minibatches=4"])
    model = flat_policy()
    planes, advret, perm_mb, co, rbl = hover_minibatch(cfg, model, env)
    order = kernel_order(model.hidden)
    theta = off_policy(model.flat, order)
    check_branches("K3 train_sps_262k", K3.head_branch_counts(
        planes, advret, perm_mb, theta, model.hidden, co, rbl))
    args = (planes, advret, perm_mb, theta, model.hidden, co, rbl,
            cfg.train.ent_coef)
    err["K3"], _ = check_k3(*args, each_stat=True)
    grads, _ = K3.ppo_update_kernel(*args)
    err["K4"], _ = check_k4(model.flat, order, cfg, "the MLP layout, a "
                            "train_sps_262k minibatch's K3 gradients", grads)
    print(f"bench shapes: max abs errors {err}", flush=True)
    return err


def path_bench(cfg_path):
    """The bench path: `cli bench` on hover.toml in-process, launch counts
    zeroed just before and read just after. Every kernel (both arms of K6,
    K7 and K8) must launch; its JSON line must hold the reference's keys
    and "device", every phase (the four scan_* training phases among them)
    a positive finite rate."""
    import contextlib
    import io

    import torch

    from drone_tpu_torch import cli

    from drone_tpu_torch import bench

    zero_counts()
    out = io.StringIO()
    t0 = time.time()
    # one timed repeat after the warm-up where `cli bench` takes three (the
    # median; PERF.md section 2): this path shows that every phase runs
    # through its kernels, and its rates are read beside their spread from
    # cli bench itself
    repeats, bench.REPEATS = bench.REPEATS, 1
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["bench", str(cfg_path)])
    finally:
        bench.REPEATS = repeats
    torch.cuda.synchronize()
    seconds = time.time() - t0
    bench_counts = counts()
    line = out.getvalue().strip().splitlines()[-1]
    print(f"bench path: cli bench rc={rc} in {seconds:.1f} s, launches "
          f"{bench_counts}\n{line}", flush=True)
    res = json.loads(line)
    # the bench runs in float32: every kernel but the bf16 arms
    missing = [k for k, v in bench_counts.items()
               if v < 1 and not k.endswith(" bf16")]
    if rc != 0 or missing:
        raise AssertionError(f"the bench path did not launch {missing}")
    if (tuple(res) != BENCH_KEYS
            or set(res["secondary"]) != set(BENCH_SECONDARY)
            or set(res["spread"]) != {"headline", *BENCH_SECONDARY}):
        raise AssertionError(f"the bench's keys differ from the reference's: "
                             f"{list(res)}, {list(res['secondary'])}")
    for key, v in [("value", res["value"]), *res["secondary"].items()]:
        if not (isinstance(v, float) and math.isfinite(v) and v > 0):
            raise AssertionError(f"bench phase {key} gave {v}")
    return res, bench_counts, seconds


# ---------------------------------------------------------------------------
# The scan trainers: autograd PPO over the policy modules, K4 as their
# optimizer, and the hybrid recurrent tier (K6's rollout, autograd update)
# ---------------------------------------------------------------------------

# K4's parameter counts at the policy families' default widths, and the
# wide case past ADAM_MAX_BLOCKS one-slice blocks (an LSTM of hidden 512
# has 1,185,161)
K4_FAMILY_P = {"mlp": 10441, "lstm": 100361, "cnn": 95113, "cnn_lstm": 226697}
K4_WIDE_P = 1_200_000
# sha256 (first 16 hex digits) of K4's outputs (theta, mu, nu, count) on
# k4_inputs(P) for the clip active and inactive, from the K4 of the commit
# before its envelope grew past 524,288 parameters (one slice a block;
# scripts/k4_digests.py on that commit's git archive, NVIDIA H100 80GB
# HBM3, 700 W): the widened K4 must give them bit for bit
K4_PARENT_DIGESTS = {
    "mlp": ["25645d727ad1b8bb", "07752f1c5e69dc1f"],
    "lstm": ["8a5869ffa2019d7b", "57c630dcc6075d94"],
    "cnn": ["ca0c22783788e52b", "5cd7d8fa13f3e818"],
    "cnn_lstm": ["743cdab97caeae9a", "0299929d857f5cd9"],
}


def k4_inputs(P: int):
    """K4's seeded inputs at P, made with numpy (the same bits on any
    machine): theta, gradients whose norm the clip cuts, mu, nu."""
    import numpy as np

    rng = np.random.default_rng(P)
    theta = rng.random(P, dtype=np.float32) - np.float32(0.5)
    grads = (rng.random(P, dtype=np.float32) - np.float32(0.5)) * np.float32(
        0.2)
    mu = (rng.random(P, dtype=np.float32) - np.float32(0.5)) * np.float32(0.02)
    nu = rng.random(P, dtype=np.float32) * np.float32(0.001)
    return theta, grads, mu, nu


def k4_digests(P: int) -> list:
    """[digest with the clip active, with it inactive] of K4's outputs on
    k4_inputs(P) at step count 5, lr 3e-4 annealed over 2,400 steps."""
    import hashlib

    import numpy as np
    import torch

    from drone_tpu_torch.ops import cuda_update as K4

    theta, grads, mu, nu = k4_inputs(P)
    out = []
    for scale in (1.0, 0.25 * 0.5 / float(np.linalg.norm(grads))):
        t = [torch.from_numpy(x).cuda() for x in (theta, grads * np.float32(
            scale), mu, nu)]
        count = torch.full((), 5.0, device="cuda")
        K4.fused_adam_kernel(t[0], t[1], t[2], t[3], count, K4.AdamConsts(),
                             K4.LrSchedule(3e-4, 2400, True), [P])
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for x in (t[0], t[2], t[3], count):
            h.update(x.cpu().numpy().tobytes())
        out.append(h.hexdigest()[:16])
    return out


def phase_k4_wide(cfg) -> float:
    """K4 at K4_WIDE_P (each block several slices) against its plain
    version as check_k4 holds it, and at each family's P bitwise equal to
    the parent's K4 (K4_PARENT_DIGESTS). Returns the max abs error."""
    import torch

    from drone_tpu_torch.ops import cuda_update as K4

    g = torch.Generator(device="cuda").manual_seed(11)
    flat = 0.1 * torch.randn(K4_WIDE_P, device="cuda", generator=g)
    order = [("a", (K4_WIDE_P - 200_000,)), ("b", (200_000,))]
    slices = len(K4.adam_slices(K4_WIDE_P))
    err, _ = check_k4(flat, order, cfg, f"a wide buffer ({slices} slices)")
    for family, P in K4_FAMILY_P.items():
        got = k4_digests(P)
        want = K4_PARENT_DIGESTS.get(family)
        print(f"K4 at the {family} P ({P}): digests {got}, the parent's "
              f"{want}", flush=True)
        if got != want:
            raise AssertionError(f"K4 at the {family} P differs from the "
                                 f"parent's K4")
    return err


def _scan_case(name):
    """(model on the CPU from its seed, PPOConfig, recurrent tier or None)
    of a card-against-CPU scan update case."""
    import torch

    from drone_tpu_torch.models import (
        ActorCritic,
        LSTMActorCritic,
        PixelActorCritic,
    )
    from drone_tpu_torch.ppo import PPOConfig

    gen = torch.Generator().manual_seed(7)
    base = dict(horizon=8, num_envs=1024, epochs=2, num_minibatches=2,
                anneal_lr=True, total_updates=10)
    if name == "MLP lanes":
        return ActorCritic((64, 64), generator=gen), PPOConfig(**base), None
    if name == "MLP flat, grad_accum 2":
        return (ActorCritic((64, 64), generator=gen),
                PPOConfig(shuffle="flat", grad_accum=2, **base), None)
    rnn = dict(base, num_envs=512, bptt_horizon=4)
    if name == "LSTM scan":
        return LSTMActorCritic(32, (32,), generator=gen), PPOConfig(**rnn), \
            "scan"
    if name == "hybrid (K6)":
        return LSTMActorCritic(32, (32,), generator=gen), PPOConfig(**rnn), \
            "pallas"
    return (PixelActorCritic(generator=gen),
            PPOConfig(grad_accum=2, **dict(base, num_envs=256)), None)


SCAN_CASES = ("MLP lanes", "MLP flat, grad_accum 2", "LSTM scan",
              "hybrid (K6)", "cnn_overlap")


def scan_update(name, device, draws):
    """One update of a scan case on `device` from the case's weights, env
    state, noise and permutations (draws: (noise (T, N, 4), perms)):
    (runner after it, metrics)."""
    import torch

    from drone_tpu_torch import ppo, ppo_rnn
    from drone_tpu_torch.env import DroneEnv

    model, cfg, tier = _scan_case(name)
    env = DroneEnv(device=device)
    noise, perms = draws
    kw = dict(permutations=lambda r: perms,
              noise=lambda r: torch.from_numpy(noise).to(device))
    if tier is None:
        runner = ppo.init_runner(model, env, cfg, seed=3)
        step = ppo.make_train_step(model, env, cfg, **kw)
    else:
        runner = ppo_rnn.init_recurrent_runner(model, env, cfg, seed=3)
        step = ppo_rnn.make_recurrent_train_step(model, env, cfg,
                                                 rollout=tier, **kw)
    return step(runner)


def phase_scan_vs_cpu() -> float:
    """Each scan trainer's update on the card against the same update on
    the CPU (the plain versions: K4's, and K6's for the hybrid tier), from
    the same weights, env state, noise and permutations: every parameter
    tensor and its slices of mu and nu within 1e-4 x its max |value|, the
    metrics likewise (as one vector, episodes equal); the update run twice
    on the card, bitwise equal. Returns the largest error over the
    tolerance's scale."""
    import numpy as np
    import torch

    from drone_tpu_torch.ppo import METRIC_KEYS

    worst = 0.0
    for name in SCAN_CASES:
        _, cfg, _ = _scan_case(name)
        rng = np.random.default_rng(5)
        noise = rng.standard_normal((cfg.horizon, cfg.num_envs, 4),
                                    dtype=np.float32)
        n = cfg.num_envs * (cfg.horizon if cfg.shuffle == "flat" else 1)
        perms = np.stack([rng.permutation(n) for _ in range(cfg.epochs)])
        t0 = time.time()
        card, m_card = scan_update(name, "cuda", (noise, perms))
        again, m_again = scan_update(name, "cuda", (noise, perms))
        torch.cuda.synchronize()
        t_card = time.time() - t0
        cpu, m_cpu = scan_update(name, "cpu", (noise, perms))
        check_repeat(f"{name} update", [card.params.flat, *card.opt_state,
                                        *m_card.values()],
                     [again.params.flat, *again.opt_state,
                      *m_again.values()])
        err = 0.0
        off = 0
        for pname, shape in card.params.kernel_order():
            k = math.prod(shape)
            for what, a, b in (("param", card.params.flat, cpu.params.flat),
                               ("mu", card.opt_state[1], cpu.opt_state[1]),
                               ("nu", card.opt_state[2], cpu.opt_state[2])):
                a, b = a[off:off + k].cpu(), b[off:off + k]
                scale = float(b.abs().max()) or 1.0
                e = float((a - b).abs().max()) / scale
                if e > 1e-4:
                    raise AssertionError(f"{name}: {what} {pname} differs "
                                         f"from the CPU's by {e:.3g} of its "
                                         f"max")
                err = max(err, e)
            off += k
        if float(m_card["episodes"]) != float(m_cpu["episodes"]):
            raise AssertionError(f"{name}: episodes differ from the CPU's")
        keys = [k for k in METRIC_KEYS if k != "episodes"]
        a = torch.stack([m_card[k].cpu() for k in keys])
        b = torch.stack([m_cpu[k] for k in keys])
        e = float((a - b).abs().max()) / float(b.abs().max())
        if e > 1e-4:
            raise AssertionError(f"{name}: metrics differ from the CPU's by "
                                 f"{e:.3g} of their max: {a} {b}")
        err = max(err, e)
        worst = max(worst, err)
        print(f"scan update {name} ({cfg.num_envs} envs x {cfg.horizon} "
              f"steps, {cfg.epochs} x {cfg.num_minibatches} minibatches): "
              f"card against CPU within {err:.3g} of each tensor's max; two "
              f"card updates bitwise equal ({t_card:.2f} s for both)",
              flush=True)
    return worst


# the hybrid path's updates: 1, cut from 2 when the whole script ran past
# 720 s (771 s on an H100); the equivalence gate's CNN pair keeps both seeds, as its
# runs share the card at once and seed 1 adds no time
HYBRID_UPDATES = 1


def path_scan_training(cfg_path, tmp) -> dict:
    """The scan paths through `cli train` on hover.toml, launch counts
    zeroed before each run and read after, then `cli eval` of each
    checkpoint: run.rollout=scan for 3 updates (K4 96 times, K2 and K3
    never); run.policy=cnn_overlap with grad_accum 16 for 2 (K4 64 times,
    no CNN kernel); run.policy=lstm at 65,280 envs (510 rows of 128: 8
    minibatches of 8,160 lanes are not whole rows, so K7 refuses and the
    hybrid tier trains) for HYBRID_UPDATES (K6 once an update, K4, no K7);
    and under run.rollout=auto the runs no kernel tier takes, an MLP [256,
    256] and an LSTM of hidden 256, 1 update each on the scan trainers
    (K4 32 times, no other kernel), served by the module. Returns {run:
    launch counts}."""
    import torch

    from drone_tpu_torch import cli

    out = {}
    # (run, overrides, its launch counts, the launch counts of cli eval)
    runs = (
        ("scan", ["run.rollout=scan", "run.total_updates=3"],
         {"K4": 96, "K2": 0, "K3": 0}, {"K5": 1}),
        ("cnn_overlap", ["run.policy=cnn_overlap", "train.grad_accum=16",
                         "run.total_updates=2"],
         {"K4": 64, "K9": 0, "K10": 0, "K11": 0}, {"K11": 0}),
        ("hybrid", ["run.policy=lstm", "train.num_envs=65280",
                    f"run.total_updates={HYBRID_UPDATES}"],
         {"K6": HYBRID_UPDATES, "K4": 32 * HYBRID_UPDATES, "K7": 0},
         {"K8": 1}),
        ("mlp256", ["run.hidden=256,256", "run.total_updates=1"],
         {"K4": 32, "K2": 0, "K3": 0}, {"K5": 0}),
        ("lstm256", ["run.policy=lstm", "run.lstm_hidden=256",
                     "run.total_updates=1"],
         {"K4": 32, "K6": 0, "K7": 0}, {"K8": 0}),
    )
    for name, over, want, want_eval in runs:
        over = [*over, f"run.checkpoint_dir={tmp}", f"run.run_name={name}"]
        zero_counts()
        t0 = time.time()
        rc = cli.main(["train", str(cfg_path), *over])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        c = counts()
        last = json.loads((Path(tmp) / name / "metrics.jsonl").read_text()
                          .splitlines()[-1])
        print(f"scan path {name}: cli train hover.toml {over[:-2]} rc={rc} in "
              f"{seconds:.1f} s; launches {c}; last {last}", flush=True)
        if rc != 0 or any(c[k] != v for k, v in want.items()):
            raise AssertionError(f"the {name} path launched {c}, expected "
                                 f"{want}")
        if not all(math.isfinite(last[k]) for k in ("loss", "v_loss",
                                                     "reward_mean")):
            raise AssertionError(f"the {name} path's metrics are not finite")
        zero_counts()
        rc = cli.main(["eval", str(cfg_path), *over[:-2],
                       f"run.resume_from={tmp}/{name}/checkpoints"])
        torch.cuda.synchronize()
        ce = counts()
        print(f"scan path {name}: cli eval of its checkpoint rc={rc}; "
              f"launches {ce}", flush=True)
        if rc != 0 or any(ce[k] != v for k, v in want_eval.items()):
            raise AssertionError(f"cli eval of the {name} checkpoint: rc {rc}"
                                 f", launches {ce}, expected {want_eval}")
        out[name] = c
    return out


def phase_scan_resume(tmp):
    """Resume on the card: train(2) == train(1) + resume(1) bitwise for the
    MLP scan trainer and for cnn_overlap (every tensor of the runner, both
    generators' states); and a megakernel checkpoint restored under
    run.rollout=scan, and a scan one under the megakernel, with the
    parameters, the moments and the count as saved, bitwise, each then
    trained one more update."""
    import torch

    from drone_tpu_torch.train import build, train
    from drone_tpu_torch.utils.checkpoint import Checkpointer
    from drone_tpu_torch.utils.config import Config

    def cfg_for(name, total, extra=()):
        return Config.default().with_overrides([
            "train.num_envs=4096", "train.horizon=16", "train.epochs=2",
            "train.num_minibatches=2", "run.hidden=32,32",
            "run.log_interval=1", f"run.total_updates={total}",
            f"run.run_name={name}", f"run.checkpoint_dir={tmp}", *extra])

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step,
                r.generator.get_state(), r.noise_generator.get_state()]

    overlap = ["run.policy=cnn_overlap", "train.num_envs=1024",
               "train.horizon=8", "train.epochs=1", "train.grad_accum=2"]
    for label, extra in (("MLP scan", ["run.rollout=scan"]),
                         ("cnn_overlap", overlap)):
        tag = label.split()[0].lower()
        full, _ = train(cfg_for(f"{tag}_full", 2, extra))
        train(cfg_for(f"{tag}_half", 1, extra))
        resumed, _ = train(cfg_for(f"{tag}_resumed", 2, [
            *extra, f"run.resume_from={tmp}/{tag}_half/checkpoints"]))
        torch.cuda.synchronize()
        ok = all(bitwise_equal(a, b) for a, b in zip(tensors(full),
                                                     tensors(resumed)))
        print(f"{label} resume on the card: train(2) == train(1) + "
              f"resume(1) bitwise: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"{label} resume is not bitwise on the card")
    for first, then in (("pallas", "scan"), ("scan", "pallas")):
        saved, _ = train(cfg_for(f"x_{first}", 1, [f"run.rollout={first}"]))
        ckpt = f"{tmp}/x_{first}/checkpoints"
        _, _, template, _, _ = build(cfg_for(f"y_{then}", 2, [
            f"run.rollout={then}"]))
        restored, _ = Checkpointer(ckpt).restore(template)
        ok = (all(bitwise_equal(a, b) for a, b in zip(restored.opt_state,
                                                      saved.opt_state))
              and bitwise_equal(restored.params.flat, saved.params.flat))
        resumed, last = train(cfg_for(f"y_{then}", 2, [
            f"run.rollout={then}", f"run.resume_from={ckpt}"]))
        torch.cuda.synchronize()
        print(f"a {first} checkpoint restored under run.rollout={then}: "
              f"parameters, moments and count bitwise as saved: {ok}; "
              f"count after one more update {float(resumed.opt_state[0])}, "
              f"loss {last['loss']:.6g}", flush=True)
        if not ok or float(resumed.opt_state[0]) != 8.0:
            raise AssertionError(f"a {first} checkpoint did not carry over "
                                 f"under run.rollout={then}")


def split_scan_update(cfg) -> dict:
    """One warm hover.toml update of the scan trainer (run.rollout=scan),
    split into rollout, GAE, update and metrics by CUDA events at
    make_train_step's phase marks and by the host clock, with the host
    syncs torch's sync check reports while it queues; then one more
    update traced (trace_update) for the device's busy time and idle
    share."""
    import warnings

    import torch

    from drone_tpu_torch import ppo
    from drone_tpu_torch.train import build

    env, model, runner, _, bcfg = build(cfg.with_overrides(
        ["run.rollout=scan"]))
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    step = ppo.make_train_step(model, env, bcfg.train, on_phase=mark)
    runner, m = step(runner)  # warm-up
    float(m["loss"])
    marks.clear()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            runner, m = step(runner)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t_queued = time.perf_counter()
    float(m["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    tc = bcfg.train
    split = {"wall_ms": wall_ms,
             "samples_per_s": tc.num_envs * tc.horizon / wall_ms * 1e3,
             "host_queue_ms": (t_queued - t0) * 1e3,
             "host_syncs": sum("called a synchronizing" in str(w.message)
                               for w in caught)}
    for (name, e0, h0), (_, e1, h1) in zip(marks, marks[1:]):
        split[f"{name}_device_ms"] = e0.elapsed_time(e1)
        split[f"{name}_host_ms"] = (h1 - h0) * 1e3
    print(f"one scan update at hover.toml's shape: {split}", flush=True)
    print(f"the same scan update traced: "
          f"{trace_update(step, runner, 'mlp')}", flush=True)
    return split


# the trainer-equivalence gate (tests/test_trainer_equivalence.py at its
# sizes, thresholds and seeds): the scan trainer and the megakernel trainer
# of each family cross the same hover threshold (a 5-update mean of the
# mean reward) within EQUIV_RATIO of each other's mean update budget.
# {family: (PPOConfig fields, threshold, most updates)}. The CNN pair runs
# the default PatchCNNActorCritic, the only architecture K9 and K10 take
# (the reference's test shrinks it to res 8, patches 2 x 2, channels 16,
# hidden 32), at the port's CNN learning gate's lr for that architecture
# (phase 24's 1e-3; the reference's 3e-3 is for its tiny CNN)
EQUIV_RATIO = 1.5
EQUIV_SEEDS = (0, 1)
EQUIV = {
    "mlp": (dict(horizon=32, num_envs=512, epochs=4, num_minibatches=4,
                 lr=3e-3, ent_coef=0.0), 0.3, 120),
    "cnn": (dict(horizon=32, num_envs=256, epochs=4, num_minibatches=2,
                 lr=1e-3, ent_coef=0.0), 0.2, 160),
    "lstm": (dict(horizon=32, num_envs=256, epochs=4, num_minibatches=2,
                  lr=5e-3, ent_coef=0.0, bptt_horizon=16), 0.2, 160),
}
# the gate's runs go to this many processes at once (each run is a few
# hundred lanes, bound by the host's Python)
EQUIV_PROCS = 6


def updates_to_threshold(step, runner, threshold, max_updates):
    """Updates until the 5-update mean of the mean reward passes
    `threshold`, or None within max_updates."""
    window = []
    for u in range(max_updates):
        runner, m = step(runner)
        window.append(float(m["reward_mean"]))
        if len(window) >= 5 and sum(window[-5:]) / 5 > threshold:
            return u + 1
    return None


def equivalence_run(task):
    """One run of the gate, task = (family, trainer, seed, PPOConfig
    fields, threshold, most updates): updates_to_threshold of that
    trainer from the model and runner of that seed."""
    import torch

    from drone_tpu_torch import ppo, ppo_cnn_cuda, ppo_cuda, ppo_rnn
    from drone_tpu_torch import ppo_rnn_cuda
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.models import (
        ActorCritic,
        LSTMActorCritic,
        PatchCNNActorCritic,
    )
    from drone_tpu_torch.ppo import PPOConfig

    family, trainer, seed, fields, threshold, most = task
    env, cfg = DroneEnv(device="cuda"), PPOConfig(**fields)
    gen = torch.Generator().manual_seed(seed)
    if family == "lstm":
        model = LSTMActorCritic(32, (32,), generator=gen)
        runner = ppo_rnn.init_recurrent_runner(model, env, cfg, seed=seed)
        step = (ppo_rnn.make_recurrent_train_step(model, env, cfg)
                if trainer == "scan" else
                ppo_rnn_cuda.make_rnn_train_step(env, cfg))
    else:
        model = (ActorCritic((32, 32), generator=gen) if family == "mlp"
                 else PatchCNNActorCritic(generator=gen))
        runner = ppo.init_runner(model, env, cfg, seed=seed)
        kernel = (ppo_cuda.make_train_step if family == "mlp"
                  else ppo_cnn_cuda.make_cnn_train_step)
        step = (ppo.make_train_step(model, env, cfg) if trainer == "scan"
                else kernel(env, cfg))
    return updates_to_threshold(step, runner, threshold, most)


def equivalence_budgets(tasks) -> list:
    """equivalence_run of each task, EQUIV_PROCS processes at a time
    (spawned, each on the card; all stopped before this returns)."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(EQUIV_PROCS) as pool:
        return pool.map(equivalence_run, tasks, chunksize=1)


def phase_trainer_equivalence(tmp):
    """The trainer-equivalence gate for the MLP, the CNN and the LSTM: each
    trainer crosses its family's threshold from every seed, and the mean
    budgets agree within EQUIV_RATIO. A failure is raised after all three
    families have been read."""
    del tmp
    # the slow families first, so the processes finish together
    tasks = [(family, trainer, seed, *EQUIV[family])
             for family in ("lstm", "cnn", "mlp")
             for trainer in ("scan", "megakernel") for seed in EQUIV_SEEDS]
    t0 = time.time()
    results = dict(zip([t[:3] for t in tasks], equivalence_budgets(tasks)))
    failures = []
    for family in EQUIV:
        b = {trainer: [results[family, trainer, seed] for seed in EQUIV_SEEDS]
             for trainer in ("scan", "megakernel")}
        crossed = all(n is not None for ns in b.values() for n in ns)
        means = [sum(ns) / len(ns) for ns in b.values()] if crossed else []
        ratio = max(means) / min(means) if crossed else float("inf")
        print(f"trainer equivalence {family} ({EQUIV[family]}): updates to "
              f"the threshold from seeds {EQUIV_SEEDS} {b}, ratio "
              f"{ratio:.3f}", flush=True)
        if ratio > EQUIV_RATIO:
            failures.append(family)
    print(f"trainer equivalence: {len(tasks)} runs in {EQUIV_PROCS} "
          f"processes, {time.time() - t0:.1f} s", flush=True)
    if failures:
        raise AssertionError(f"the trainer-equivalence gate failed for "
                             f"{failures}")


# ---------------------------------------------------------------------------
# The bf16 slice: the bf16 operand arms of K2, K3, K9 (K11's is the same
# instantiation) and K10, bfloat16 training and run.profile_dir
# ---------------------------------------------------------------------------

BF16 = "bfloat16"
# The bf16 products on the tensor cores (989 TFLOP/s dense bf16: a bf16 arm
# takes one product of the rounded operands, at the TF32 instruction's
# 495, but the function is a bf16 product and is bounded at the bf16 rate)
MMA_BF16_OPS_PER_S = 989e12
# H12: a bf16 arm against its bf16 plain version. Both round the same
# operands, but a value that lies within the kernel's and the plain
# version's few-ulp disagreement of a bf16 rounding boundary rounds to
# neighbouring bf16 values on the two sides: one term of a sum then moves
# by 2^-8 of its size. So most outputs agree as closely as the fp32 arms'
# (the fp32 check's rtol 2e-5 / atol 2e-6, BF16_CLOSE), a few do not. A bf16
# arm passes when at least BF16_MIN_SHARE of its outputs agree so, its
# largest difference is within BF16_MAX_ERR, and its mean difference is
# under BF16_SEPARATION of its mean difference to the fp32 plain version
# (a kernel that quietly stayed fp32 fails there); an update's gradients
# each within BF16_GRAD_REL of the tensor's largest value, and their mean
# difference under BF16_SEPARATION of the fp32 plain version's. Measured
# (the first chip run of these checks, NVIDIA H100 80GB HBM3, 700 W): the
# shares 0.9935-1.0 (K9's planes the least), the largest differences
# 4.8e-7 to 4.4e-3 (K2's planes the most), the mean differences 3e-4 to
# 6e-3 of the fp32 plain version's, the gradients within 6e-6 to 1.9e-3
# of their tensors' max (K3's [128, 128] minibatch the most); the limits
# leave a margin of 2x to 5x on each.
BF16_CLOSE = (2e-5, 2e-6)
BF16_MIN_SHARE = 0.98
BF16_MAX_ERR = 0.02
BF16_GRAD_REL = 1e-2
BF16_SEPARATION = 0.1


def close_share(a, b) -> float:
    """The share of the elements of a within BF16_CLOSE of b's."""
    rtol, atol = BF16_CLOSE
    return float(((a - b).abs() <= atol + rtol * b.abs()).double().mean())


def bf16_verdict(name, k, p16, p32=None) -> float:
    """A bf16 arm's outputs k (one tensor) against its bf16 plain version's
    p16 and, when given, the fp32 plain version's p32 (H12's rule); returns
    the largest difference to p16."""
    err = float((k - p16).abs().max())
    mean16 = float((k - p16).abs().double().mean())
    share = close_share(k, p16)
    line = (f"{name}: max|err| {err:.3g}, mean {mean16:.3g}; within rtol "
            f"{BF16_CLOSE[0]} / atol {BF16_CLOSE[1]}: {share:.6f} of the "
            f"values")
    apart = True
    if p32 is not None:
        mean32 = float((k - p32).abs().double().mean())
        apart = mean16 <= BF16_SEPARATION * mean32
        line += (f" (the fp32 plain version's: mean {mean32:.3g}, "
                 f"{close_share(k, p32):.6f} within)")
    print(line, flush=True)
    if not (share >= BF16_MIN_SHARE and err <= BF16_MAX_ERR and apart):
        raise AssertionError(f"{name} disagrees with its bf16 plain version "
                             f"(H12's rule)")
    return err


def bf16_grads_verdict(name, kg, ks, pg, ps, fg, fs, order) -> float:
    """An update's bf16 arm (gradients kg, stat sums ks) against its bf16
    plain version (pg, ps) and the fp32 one (fg, fs): each tensor of order
    and the stat sums within BF16_GRAD_REL x the tensor's max |value|, the
    gradients' mean difference under BF16_SEPARATION of the fp32 plain
    version's. Returns the largest difference."""
    worst, off, max_err = 0.0, 0, 0.0
    for tname, shape in [*order, ("stats", (8,))]:
        n = math.prod(shape)
        if tname == "stats":
            a, b = ks, ps
        else:
            a, b = kg[off:off + n], pg[off:off + n]
            off += n
        scale = float(b.abs().max())
        e = float((a - b).abs().max())
        max_err = max(max_err, e)
        worst = max(worst, e / scale if scale > 0 else e)
    mean16 = float((kg - pg).abs().double().mean())
    mean32 = float((kg - fg).abs().double().mean())
    print(f"{name}: max|err| {max_err:.3g}, at most {worst:.3g} of a "
          f"tensor's max|value|; mean gradient difference {mean16:.3g} (to "
          f"the fp32 plain version {mean32:.3g}); stats kernel "
          f"{ks.tolist()} plain {ps.tolist()} fp32 plain {fs.tolist()}",
          flush=True)
    if not (worst <= BF16_GRAD_REL and mean16 <= BF16_SEPARATION * mean32):
        raise AssertionError(f"{name} disagrees with its bf16 plain version "
                             f"(H12's rule)")
    return max_err


# K2's bf16 checks: (task, integrator, hidden, lanes, T cases) as K2_CASES,
# then the layout (lanes a block, fragments staged) when not traj_layout's
K2_BF16_CASES = (
    ("hover", "euler", (64, 64), 65536, ((3, 2), (64, 40)), None),
    ("waypoint", "rk4", (64, 64), 8192 + 40, ((3, 2),), None),  # ragged
    # three layers (ping-pong rows), widths padded to 16, a fold chunk of
    # one n-tile
    ("waypoint", "rk4", (32, 48, 20), 8192, ((3, 2),), None),
    ("hover", "euler", (128, 128), 8192, ((3, 2),), None),  # the widest
    ("hover", "euler", (128, 128), 8192, ((3, 2),), (512, 0)),  # through L1
    ("racing", "euler", (), 8192, ((3, 2),), None),  # linear
)


def k2_bf16_case(task, integ, hidden, n, runs) -> float:
    """One case of phase_k2_bf16 under the layout traj_layout gives;
    returns the largest difference of its T = 3 planes."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting_traj as K2
    from drone_tpu_torch.types import default_params

    model = flat_policy(hidden)
    max_err = 0.0
    for T, horizon in runs:
        env = DroneEnv(task, integ, default_params(task, horizon=horizon),
                       device="cuda")
        state = env.init_batch(5, n)
        for sto in ((False, True) if T == 3 else (True,)):
            args = (state, model.flat, model.hidden, env.params, env.statics,
                    T, sto)
            kf, kp, ks = K2.traj_rollout_kernel(*args, compute_dtype=BF16)
            pf, pp, ps = K2.traj_rollout_plain(*args, compute_dtype=BF16)
            fp = K2.traj_rollout_plain(*args)[1] if T == 3 else None
            torch.cuda.synchronize()
            k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
            k_r = float(ks[0].sum()) / (n * T)
            p_r = float(ps[0].sum()) / (n * T)
            what = (f"K2 bf16 {task}/{integ} {list(hidden)} n={n} T={T} "
                    f"stochastic={sto} ({K2.traj_layout(hidden, BF16)['bl']} "
                    f"lanes a block, fragments staged "
                    f"{K2.traj_layout(hidden, BF16)['wsm']})")
            print(f"{what}: episodes {k_ep:.0f} vs {p_ep:.0f}, mean reward "
                  f"{k_r:.6f} vs {p_r:.6f}", flush=True)
            if T == 3:
                max_err = max(max_err, bf16_verdict(f"{what} planes", kp, pp,
                                                    fp))
                bf16_verdict(f"{what} final state", kf.fstate(), pf.fstate())
                if k_ep != p_ep or k_ep < n:
                    raise AssertionError("K2 bf16 episode counts differ at "
                                         "T=3")
                kf2, kp2, ks2 = K2.traj_rollout_kernel(*args,
                                                       compute_dtype=BF16)
                check_repeat("K2 bf16", (kf.fstate(), kp, ks),
                             (kf2.fstate(), kp2, ks2))
            elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                raise AssertionError("K2 bf16 episode statistics disagree")
    return max_err


def phase_k2_bf16() -> float:
    """K2's bf16 arm against its bf16 plain version on the card (H12's
    rule on the T = 3 planes and final state, episodes equal; T = 64
    statistically), each T = 3 case launched twice, bitwise equal; a case
    with a layout of its own runs under it (traj_layout replaced by
    layout_at)."""
    from drone_tpu_torch.ops import cuda_acting_traj as K2

    max_err, rule = 0.0, K2.traj_layout
    try:
        for *case, at in K2_BF16_CASES:
            K2.traj_layout = rule if at is None else (
                lambda h, d, at=at: K2.layout_at(h, *at, bf16=True))
            max_err = max(max_err, k2_bf16_case(*case))
    finally:
        K2.traj_layout = rule
    return max_err


def check_k3_bf16(planes, advret, perm_mb, theta, hidden, co, rbl,
                  ent_coef) -> float:
    """K3's bf16 arm against its bf16 plain version on one minibatch
    (bf16_grads_verdict), two launches bitwise equal."""
    import torch

    from drone_tpu_torch.models import kernel_order
    from drone_tpu_torch.ops import cuda_update as K3

    args = (planes, advret, perm_mb, theta, hidden, co, rbl, ent_coef)
    kg, ks = K3.ppo_update_kernel(*args, compute_dtype=BF16)
    pg, ps = K3.ppo_update_plain(*args, compute_dtype=BF16)
    fg, fs = K3.ppo_update_plain(*args)
    torch.cuda.synchronize()
    check_repeat("K3 bf16", (kg, ks),
                 K3.ppo_update_kernel(*args, compute_dtype=BF16))
    return bf16_grads_verdict(
        f"K3 bf16 minibatch ({perm_mb.numel()} row blocks of {rbl} lanes x "
        f"{planes.shape[0]} steps; two launches bitwise equal)",
        kg, ks, pg, ps, fg, fs, kernel_order(hidden))


def phase_k3_bf16(cfg, env):
    """K3's bf16 arm at hover.toml's minibatch, the planes written by K2's
    bf16 arm: at their weights (ratio 1: no sample's ratio leaves 1 +-
    clip_eps, as the reference rebuilds logp from the stored action) and
    off them (every branch of the head's subgradients taken); then [128,
    128] off chip (its tanh rows, fragments and running sums in device
    memory). Returns (the largest difference, inputs for timing)."""
    from drone_tpu_torch.models import kernel_order
    from drone_tpu_torch.ops import cuda_update as K3

    model = flat_policy()
    planes, advret, perm_mb, co, rbl = hover_minibatch(cfg, model, env, BF16)
    ent = cfg.train.ent_coef
    n = K3.head_branch_counts(planes, advret, perm_mb, model.flat,
                              model.hidden, co, rbl, compute_dtype=BF16)
    print(f"K3 bf16 at the planes' weights: {n}", flush=True)
    if n["ratio_out"] != 0:
        raise AssertionError("the bf16 ratio left 1 +- clip_eps at the "
                             "weights that wrote the planes")
    err = check_k3_bf16(planes, advret, perm_mb, model.flat, model.hidden,
                        co, rbl, ent)
    theta = off_policy(model.flat, kernel_order(model.hidden))
    check_branches("K3 bf16", K3.head_branch_counts(
        planes, advret, perm_mb, theta, model.hidden, co, rbl,
        compute_dtype=BF16))
    err = max(err, check_k3_bf16(planes, advret, perm_mb, theta, model.hidden,
                                 co, rbl, ent))
    # the fp32 tanh rows, fragments and running sums of [64, 64] in shared
    # memory (update_kernel<true, true>), [128, 128]'s in device memory
    big = flat_policy((128, 128))
    if not K3.b16_layout(model.hidden)["onchip"] or K3.b16_layout(
            big.hidden)["onchip"]:
        raise AssertionError("the bf16 arm was to run [64, 64] on chip and "
                             "[128, 128] off it")
    small = hover_minibatch(
        cfg.with_overrides(["train.num_envs=8192", "train.horizon=16"]),
        big, env, BF16)
    err = max(err, check_k3_bf16(*small[:3], off_policy(big.flat, kernel_order(
        big.hidden)), big.hidden, *small[3:], ent))
    return err, (model, planes, advret, perm_mb, co, rbl)


def phase_k9_bf16() -> float:
    """K9's bf16 arm against its bf16 plain version at 65,536 lanes (T = 3
    in both action modes by H12's rule, two launches bitwise equal; T = 32
    statistically), and K11's, the same instantiation, at T = 3 (the final
    state and the per-lane statistics)."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting_cnn as K9
    from drone_tpu_torch.types import default_params

    n = 65536
    model = cnn_policy()
    max_err = 0.0
    for T, horizon, modes in ((3, 2, (False, True)), (32, 40, (True,))):
        env = DroneEnv("hover", "euler", default_params("hover",
                                                         horizon=horizon),
                       device="cuda")
        state = env.init_batch(5, n)
        for sto in modes:
            args = (state, model.flat, model.arch, env.params, env.statics, T,
                    sto)
            kf, kp, ks = K9.traj_cnn_rollout_kernel(*args, compute_dtype=BF16)
            pf, pp, ps = K9.traj_cnn_rollout_plain(*args, compute_dtype=BF16)
            torch.cuda.synchronize()
            k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
            k_r, p_r = float(ks[0].sum()) / (n * T), float(ps[0].sum()) / (n * T)
            what = f"K9 bf16 hover n={n} T={T} stochastic={sto}"
            print(f"{what}: episodes {k_ep:.0f} vs {p_ep:.0f}, mean reward "
                  f"{k_r:.6f} vs {p_r:.6f}", flush=True)
            if T == 3:
                fp = K9.traj_cnn_rollout_plain(*args)[1]
                max_err = max(max_err, bf16_verdict(f"{what} planes", kp, pp,
                                                    fp))
                bf16_verdict(f"{what} final state", kf.fstate(), pf.fstate())
                if k_ep != p_ep or k_ep < n:
                    raise AssertionError("K9 bf16 episode counts differ at "
                                         "T=3")
                again = K9.traj_cnn_rollout_kernel(*args, compute_dtype=BF16)
                check_repeat("K9 bf16", (kf.fstate(), kp, ks),
                             (again[0].fstate(), *again[1:]))
            elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                raise AssertionError("K9 bf16 episode statistics disagree")
    env = DroneEnv("hover", "euler", default_params("hover", horizon=2),
                   device="cuda")
    state = env.init_batch(6, n)
    args = (state, model.flat, model.arch, env.params, env.statics, 3)
    kf, ks = K9.cnn_act_rollout_kernel(*args, compute_dtype=BF16)
    pf, ps = K9.cnn_act_rollout_plain(*args, compute_dtype=BF16)
    ff, fs = K9.cnn_act_rollout_plain(*args)
    torch.cuda.synchronize()
    max_err = max(max_err, bf16_verdict(
        f"K11 bf16 (K9's instantiation) hover n={n} T=3 final state",
        kf.fstate(), pf.fstate(), ff.fstate()))
    bf16_verdict("K11 bf16 per-lane statistics", ks, ps)
    again = K9.cnn_act_rollout_kernel(*args, compute_dtype=BF16)
    check_repeat("K11 bf16", (kf.fstate(), ks), (again[0].fstate(), again[1]))
    return max_err


def check_k10_bf16(args, order) -> float:
    """K10's bf16 arm against its bf16 plain version on one minibatch
    (bf16_grads_verdict), two launches bitwise equal."""
    import torch

    from drone_tpu_torch.ops import cuda_update_cnn as K10

    kg, ks = K10.ppo_cnn_update_kernel(*args, compute_dtype=BF16)
    kg2, ks2 = K10.ppo_cnn_update_kernel(*args, compute_dtype=BF16)
    pg, ps = K10.ppo_cnn_update_plain(*args, compute_dtype=BF16)
    fg, fs = K10.ppo_cnn_update_plain(*args)
    torch.cuda.synchronize()
    check_repeat("K10 bf16", (kg, ks), (kg2, ks2))
    planes, perm_mb, rbl = args[0], args[2], args[6]
    return bf16_grads_verdict(
        f"K10 bf16 minibatch ({perm_mb.numel()} row blocks of {rbl} lanes x "
        f"{planes.shape[0]} steps; two launches bitwise equal)",
        kg, ks, pg, ps, fg, fs, order)


def phase_k10_bf16(cfg, env):
    """K10's bf16 arm at the CNN geometry's full-width minibatch, the
    planes written by K9's bf16 arm: at their weights (no ratio outside 1
    +- clip_eps) and off them (every branch taken). Returns (the largest
    difference, inputs for timing)."""
    from drone_tpu_torch.ops import cuda_update_cnn as K10

    model = cnn_policy()
    order = model.kernel_order()
    planes, advret, perm_mb, co, rbl = cnn_minibatch(cfg, model, env, BF16)
    args = (planes, advret, perm_mb, model.flat, model.arch, co, rbl,
            cfg.train.ent_coef)
    n = K10.cnn_head_branch_counts(*args[:7], compute_dtype=BF16)
    print(f"K10 bf16 at the planes' weights: {n}", flush=True)
    if n["ratio_out"] != 0:
        raise AssertionError("the bf16 ratio left 1 +- clip_eps at the "
                             "weights that wrote the planes")
    err = check_k10_bf16(args, order)
    for critic_scale in (16.0, 64.0, 256.0):
        theta = off_policy(model.flat, order, critic_scale=critic_scale)
        n = K10.cnn_head_branch_counts(planes, advret, perm_mb, theta,
                                       model.arch, co, rbl,
                                       compute_dtype=BF16)
        try:
            check_branches(f"K10 bf16 (critic noise {critic_scale})", n)
            break
        except AssertionError:
            if critic_scale == 256.0:
                raise
    err = max(err, check_k10_bf16((*args[:3], theta, *args[4:]), order))
    return err, args


# The bf16 instantiations beside their fp32 ones (hover/euler, stochastic
# for K2): (library, fp32 label, bf16 label, rule); the labels are
# kernel_label's of the build report. Rule "third": one TF32 product a
# k-step of the rounded operands where 3xTF32 takes three, so exactly a
# third of the fp32 arm's HMMA (K7's dense arm's products,
# grad_rounded_kernel, 32 against 96); "bf16": the bf16
# tensor cores' own product, m16n8k16 (HMMA.16816.F32.BF16) and no TF32
# HMMA at all (the patch-CNN tower's bf16 design in K9/K11, K10 and K7's
# CNN arm, the bf16 weight products of K10 (gWt, whose fp32 arm runs on the
# fp32 cores) and K7's CNN arm, K7's walk, both arms, and since their
# redesigns K2's bf16 arm and K3's, on chip and off it (its db became an
# fp32 sum on the CUDA cores, so the products with ones that kept TF32 HMMA
# there are gone).
BF16_PAIRS = (
    ("acting_traj", "traj_kernelILi0ELi0ELb1ELb0E",
     "traj_kernelILi0ELi0ELb1ELb1E", "bf16"),
    ("update", "update_kernelILb1ELb0E", "update_kernelILb1ELb1E", "bf16"),
    ("update", "update_kernelILb0ELb0E", "update_kernelILb0ELb1E", "bf16"),
    ("acting_cnn", "cnn_act_kernelILi0ELi0ELb0E",
     "cnn_act_kernelILi0ELi0ELb1E", "bf16"),
    ("update_cnn", "cnn_fwd_kernelILb0E", "cnn_fwd_kernelILb1E", "bf16"),
    ("update_cnn", "tower_bwd_kernelILb0E", "tower_bwd_kernelILb1E", "bf16"),
    ("update_cnn", "cnn_gemm_kernelILb0E", "cnn_gemm_kernelILb1E", "bf16"),
    ("update_lstm", "bptt_kernel<dense>", "bptt_kernel<dense, bf16>",
     "bf16"),
    ("update_lstm", "bptt_kernel<cnn>", "bptt_kernel<cnn, bf16>", "bf16"),
    ("update_lstm", "grad_mma_kernelILb0E", "grad_mma_kernelILb1E", "bf16"),
    ("update_lstm", "grad_mma_kernelILb0E", "grad_rounded_kernel", "third"),
    ("update_lstm", "tower_fwd_kernelILb0E", "tower_fwd_kernelILb1E", "bf16"),
    ("update_lstm", "tower_bwd_kernelILb0E", "tower_bwd_kernelILb1E", "bf16"),
)
# SASS mnemonics of the bf16 tensor cores' product and of TF32's
HMMA_BF16 = "HMMA.16816.F32.BF16"
HMMA_TF32 = "HMMA.1688.F32.TF32"


def sass_counts(lib, keys, opcodes) -> dict:
    """{kernel: {opcode: instructions}} in a library's machine code
    (cuobjdump -sass), for the entry functions kernel_label names; an
    opcode counts the instructions whose mnemonic starts with it."""
    from drone_tpu_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, entry = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            entry = kernel_label(line.split("Function :")[1].strip(), keys)
            if entry:
                out[entry] = dict.fromkeys(opcodes, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if entry and m:
            for op in opcodes:
                if m.group(1).startswith(op):
                    out[entry][op] += 1
    return out


def bf16_build_report(libs) -> list:
    """Each bf16 instantiation's tensor-core products (HMMA, of them the
    bf16 m16n8k16 ones and the TF32 ones) and bf16 roundings (F2FP.BF16,
    cvt.rn.bf16x2) beside its fp32 one's: the bf16 arm must round to bf16
    and the fp32 one not; then its pair's rule (BF16_PAIRS): "third"
    holds TF32 HMMA, exactly a third of the fp32 arm's; "bf16" holds
    HMMA.16816.F32.BF16 and no other HMMA. Returns the failures."""
    failures = []
    keys = list(dict.fromkeys(k.split("<")[0] for _, a, b, _ in BF16_PAIRS
                              for k in (a, b)))
    ops = ("HMMA", HMMA_BF16, HMMA_TF32, "F2FP.BF16")
    for name in dict.fromkeys(lib for lib, _, _, _ in BF16_PAIRS):
        c = sass_counts(libs[name], keys, ops)
        for lib, fp32, bf16, rule in BF16_PAIRS:
            if lib != name:
                continue
            a, b = c.get(fp32, {}), c.get(bf16, {})
            print(f"  {name} bf16 arm {bf16} ({rule}): {b.get('HMMA')} HMMA "
                  f"({b.get(HMMA_BF16)} {HMMA_BF16}, {b.get(HMMA_TF32)} "
                  f"{HMMA_TF32}), {b.get('F2FP.BF16')} F2FP.BF16; its fp32 "
                  f"arm {fp32}: {a.get('HMMA')} HMMA, {a.get('F2FP.BF16')} "
                  f"F2FP.BF16", flush=True)
            ok = bool(a and b.get("F2FP.BF16") and a.get("F2FP.BF16") == 0)
            if rule == "bf16":
                ok = ok and b.get(HMMA_BF16, 0) > 0 \
                    and b["HMMA"] == b[HMMA_BF16]
            else:
                ok = ok and bool(b.get("HMMA")) and b[HMMA_BF16] == 0 \
                    and 3 * b["HMMA"] == a["HMMA"]
            if not ok:
                failures.append(f"{bf16} ({rule}): {b} against {fp32}: {a}")
    return failures


def path_bf16_training(cfg_path, tmp) -> dict:
    """cli train under run.compute_dtype=bfloat16 on hover.toml (3
    updates: K2 = 3, K3 = K4 = 96) and at the CNN geometry (2 updates: K9 =
    2, K10 = K4 = 32), every launch of K2, K3, K9 and K10 their bf16 arm's;
    then cli eval of each checkpoint, which serves a bf16 policy through
    the module as the reference does (no acting kernel launches). Returns
    {family: launch counts of its cli train}."""
    import torch

    from drone_tpu_torch import cli

    out = {}
    for family, over, updates, want in (
            ("mlp", [], 3, {"K2": 3, "K3": 96, "K4": 96}),
            ("cnn", list(CNN_OVERRIDES), 2, {"K9": 2, "K10": 32, "K4": 32})):
        zero_counts()
        t0 = time.time()
        rc = cli.main(["train", str(cfg_path), *over,
                       f"run.compute_dtype={BF16}",
                       f"run.total_updates={updates}",
                       f"run.checkpoint_dir={tmp}", f"run.run_name={family}16"])
        torch.cuda.synchronize()
        c = counts()
        t_train = time.time() - t0
        zero_counts()
        rc2 = cli.main(["eval", str(cfg_path), *over[:1],
                        f"run.compute_dtype={BF16}",
                        f"run.resume_from={tmp}/{family}16/checkpoints"])
        torch.cuda.synchronize()
        e = counts()
        print(f"bf16 {family} path: cli train ({updates} updates) rc={rc} in "
              f"{t_train:.1f} s, launches {c}; cli eval rc={rc2}, launches "
              f"{e}", flush=True)
        if (rc, rc2) != (0, 0) or any(c[k] != v for k, v in want.items()):
            raise AssertionError(f"the bf16 {family} path launched {c}, "
                                 f"expected {want}")
        if any(c[k] != c[f"{k} bf16"] for k in BF16_ARMS):
            raise AssertionError(f"the bf16 {family} path ran an fp32 arm: "
                                 f"{c}")
        if any(e[k] for k in ("K5", "K11")):
            raise AssertionError(f"cli eval served a bf16 {family} policy "
                                 f"through an fp32 acting kernel: {e}")
        out[family] = c
    return out


def phase_bf16_learning_and_resume(tmp):
    """The bf16 learning gates under the fp32 gates' rules (the MLP's one
    run from seed 0, mlp_gate_run; the CNN's four runs from seeds 0-3,
    cnn_gate); and resume under bfloat16: train(4) == train(2) +
    resume(2) bitwise, for the MLP and the CNN. A failed gate is raised
    after the resume checks have run."""
    import torch

    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    t0 = time.time()
    updates, mean5, first5, finite = mlp_gate_run(0, BF16)
    print(f"bf16 MLP learning gate: mean reward of the last 5 updates "
          f"{mean5:.4f} after {updates} updates ({time.time() - t0:.1f} s); "
          f"first 5 {first5:.4f}; parameters finite {finite}", flush=True)
    mlp_ok = mean5 > MLP_GATE_REWARD and finite
    cnn_ok, rise = cnn_gate(GATE_SEEDS, BF16)
    print(f"bf16 CNN learning gate: mean reward rise over seeds "
          f"{list(GATE_SEEDS)} {rise:.4f}", flush=True)

    for family, over in (("mlp", ["run.hidden=32,32", "train.num_envs=4096"]),
                         ("cnn", ["run.policy=cnn", "train.num_envs=1024"])):
        def cfg_for(name, total, extra=()):
            return Config.default().with_overrides([
                *over, f"run.compute_dtype={BF16}", "train.horizon=16",
                "train.epochs=2", "train.num_minibatches=2",
                "run.log_interval=2", f"run.total_updates={total}",
                f"run.run_name={family}16_{name}",
                f"run.checkpoint_dir={tmp}", *extra])

        full, _ = train(cfg_for("full", 4))
        train(cfg_for("half", 2))
        resumed, _ = train(cfg_for("resumed", 4, [
            f"run.resume_from={tmp}/{family}16_half/checkpoints"]))
        torch.cuda.synchronize()

        def tensors(r):
            return [*r.params.state_dict().values(), *r.opt_state,
                    r.env_state.fstate(), r.env_state.step]

        ok = all(bitwise_equal(a, b) for a, b in zip(tensors(full),
                                                     tensors(resumed)))
        print(f"bf16 {family} resume on the card: train(4) == train(2) + "
              f"resume(2) bitwise: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"bf16 {family} resume is not bitwise")
    if not (mlp_ok and cnn_ok):
        raise AssertionError(f"a bf16 learning gate failed on the card (MLP "
                             f"{mlp_ok}, CNN {cnn_ok})")


def path_profile(cfg_path, tmp) -> int:
    """cli train on hover.toml under bfloat16 with run.profile_dir for 6
    updates: the trace of updates 3 to 5 must be written and hold K3's
    launches (update_kernel, 32 an update). Returns their count."""
    from drone_tpu_torch import cli

    prof = Path(tmp) / "prof"
    rc = cli.main(["train", str(cfg_path), f"run.compute_dtype={BF16}",
                   "run.total_updates=6", f"run.profile_dir={prof}",
                   f"run.checkpoint_dir={tmp}", "run.run_name=prof"])
    path = prof / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"] if path.exists() else []
    k3 = sum(1 for e in events if e.get("cat") == "kernel"
             and "drone::update_kernel" in e.get("name", ""))
    print(f"profile path: cli train run.profile_dir rc={rc}: {path} "
          f"({path.stat().st_size if path.exists() else 0} bytes) holds "
          f"{len(events)} events, {k3} launches of K3's update_kernel",
          flush=True)
    if rc != 0 or k3 != 3 * 32:
        raise AssertionError(f"the run.profile_dir trace holds {k3} launches "
                             f"of K3, expected 96")
    return k3


def bf16_bound(mma, other, nbytes):
    """The bound of a bf16 arm: (the least time in ms, what sets it), the
    larger of its products at the bf16 rate plus the rest at the fp32 rate,
    and the bytes over the HBM rate."""
    t_ops = mma / MMA_BF16_OPS_PER_S + other / FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_bf16(cfg, env, k3_inputs, k10_args) -> dict:
    """Times of the bf16 arms of K2 (hover.toml's rollout, 65,536 x 64), K3
    (its minibatch), K9 (65,536 x 128) and K10 (the CNN geometry's
    minibatch) by CUDA events, beside their fp32 arms' in this call, their
    bf16 plain versions and their bounds (the products at the bf16 rate,
    the rest at the fp32 rate); and one bf16 MLP and CNN update split and
    traced as in 11. Returns {name: (ms, plain_ms, bound_ms, bound_by,
    library_ms)}."""
    import torch

    from drone_tpu_torch.ops import cuda_acting_cnn as K9
    from drone_tpu_torch.ops import cuda_acting_traj as K2
    from drone_tpu_torch.ops import cuda_update as K3
    from drone_tpu_torch.ops import cuda_update_cnn as K10

    out, fp32_ms = {}, {}
    model, planes, advret, perm_mb, co, rbl = k3_inputs
    tc = cfg.train
    n, T, hidden, P = tc.num_envs, tc.horizon, model.hidden, model.flat.numel()
    state = env.init_batch(9, n)
    args = (state, model.flat, hidden, env.params, env.statics, T)
    _, _, lane = K2.traj_rollout_kernel(*args, compute_dtype=BF16)
    episodes = float(lane[1].sum())
    ms = cuda_ms(lambda: K2.traj_rollout_kernel(*args, compute_dtype=BF16),
                 reps=5)
    fp32_ms["K2"] = cuda_ms(lambda: K2.traj_rollout_kernel(*args), reps=5)
    t0 = time.time()
    K2.traj_rollout_plain(*args, compute_dtype=BF16)
    torch.cuda.synchronize()
    plain = (time.time() - t0) * 1e3
    ops = (n * T * (OPS_STEP + OPS_OBS + tower_ops(hidden, 4)
                    + tower_ops(hidden, 1) + OPS_NOISE_LOGP)
           + episodes * OPS_RESET)
    mma = n * T * (tower_mma_ops(hidden, 4) + tower_mma_ops(hidden, 1))
    nbytes = n * (2 * 25 * 4 + 5 * 4) + T * 21 * n * 4 + P * 4
    out["K2"] = (ms, plain, *bf16_bound(mma, ops - mma, nbytes), None)

    args3 = (planes, advret, perm_mb, model.flat, hidden, co, rbl,
             tc.ent_coef)
    samples = perm_mb.numel() * rbl * planes.shape[0]
    ms = cuda_ms(lambda: K3.ppo_update_kernel(*args3, compute_dtype=BF16),
                 reps=10)
    fp32_ms["K3"] = cuda_ms(lambda: K3.ppo_update_kernel(*args3), reps=10)
    plain = cuda_ms(lambda: K3.ppo_update_plain(*args3, compute_dtype=BF16),
                    reps=2)
    ops, mma = samples * update_ops(hidden), samples * update_mma_ops(hidden)
    out["K3"] = (ms, plain, *bf16_bound(
        mma, ops - mma, samples * 21 * 4 + P * 4 + (P + 8) * 4), None)

    cnn = cnn_policy(seed=2, log_std=0.0)
    cfg_cnn = cfg.with_overrides(list(CNN_OVERRIDES))
    Tc, Pc = cfg_cnn.train.horizon, cnn.flat.numel()
    state = env.init_batch(9, n)
    args9 = (state, cnn.flat, cnn.arch, env.params, env.statics, Tc)
    _, _, lane = K9.traj_cnn_rollout_kernel(*args9, compute_dtype=BF16)
    episodes = float(lane[1].sum())
    ms = cuda_ms(lambda: K9.traj_cnn_rollout_kernel(*args9,
                                                    compute_dtype=BF16),
                 reps=3, warm_up=False)
    fp32_ms["K9"] = cuda_ms(lambda: K9.traj_cnn_rollout_kernel(*args9),
                            reps=3)
    plain = host_ms(lambda d: K9.traj_cnn_rollout_plain(
        *args9[:-1], d, compute_dtype=BF16), 32, Tc)
    ops = (n * Tc * (OPS_STEP + OPS_OBS + cnn_ops(True) + OPS_NOISE_LOGP)
           + episodes * OPS_RESET)
    out["K9"] = (ms, plain, *bf16_bound(
        n * Tc * 2 * CNN_MACS, ops - n * Tc * 2 * CNN_MACS,
        n * (2 * 25 * 4 + 5 * 4) + Pc * 4 + Tc * 21 * n * 4), None)

    planes, perm_mb, rbl = k10_args[0], k10_args[2], k10_args[6]
    samples = perm_mb.numel() * rbl * planes.shape[0]
    ms = cuda_ms(lambda: K10.ppo_cnn_update_kernel(*k10_args,
                                                   compute_dtype=BF16),
                 reps=2, warm_up=False)
    fp32_ms["K10"] = cuda_ms(lambda: K10.ppo_cnn_update_kernel(*k10_args),
                             reps=2)
    plain = cuda_ms(lambda: K10.ppo_cnn_update_plain(*k10_args,
                                                     compute_dtype=BF16),
                    reps=1, warm_up=False)
    ops, mma = samples * cnn_update_ops(), samples * cnn_tower_mma_ops()
    out["K10"] = (ms, plain, *bf16_bound(
        mma, ops - mma, samples * 23 * 4 + Pc * 4 + (Pc + 8) * 4), None)

    for name, (ms, plain, bms, by, _) in out.items():
        print(f"{name} bf16: kernel {ms:.4f} ms (its fp32 arm in this call "
              f"{fp32_ms[name]:.4f} ms), plain {plain:.2f} ms, bound "
              f"{bms:.4f} ms ({by}; products at {MMA_BF16_OPS_PER_S:.3g} "
              f"op/s)", flush=True)
    split_update(cfg.with_overrides([f"run.compute_dtype={BF16}"]))
    split_update(cfg_cnn.with_overrides([f"run.compute_dtype={BF16}"]))
    return out


# ---------------------------------------------------------------------------
# The bf16 recurrent slice: K7's bf16 operand arm, both encoders
# ---------------------------------------------------------------------------

def check_k7_bf16(args, order) -> float:
    """K7's bf16 arm against its bf16 plain version on one minibatch
    (bf16_grads_verdict, the fp32 plain version beside it), two launches
    bitwise equal."""
    import torch

    from drone_tpu_torch.ops import cuda_update_lstm as K7

    kg, ks = K7.lstm_update_kernel(*args, compute_dtype=BF16)
    kg2, ks2 = K7.lstm_update_kernel(*args, compute_dtype=BF16)
    pg, ps = K7.lstm_update_plain(*args, compute_dtype=BF16)
    fg, fs = K7.lstm_update_plain(*args)
    torch.cuda.synchronize()
    check_repeat("K7 bf16", (kg, ks), (kg2, ks2))
    planes, perm_mb, rbl, bptt = args[0], args[3], args[7], args[8]
    return bf16_grads_verdict(
        f"K7 bf16 enc={enc_label(args[5][1])} minibatch ({perm_mb.numel()} "
        f"row blocks of {rbl} lanes x {planes.shape[0]} steps, bptt {bptt}; "
        f"two launches bitwise equal)", kg, ks, pg, ps, fg, fs, order)


def phase_k7_bf16(cfg, env, model=None, critic_scales=(2.0,)):
    """K7's bf16 arm (or its CNN arm's, for a CNN-LSTM model) against its
    bf16 plain version at the recurrent path's full-width minibatch, the
    planes and anchors written by K6 in fp32 as the path writes them: at
    their weights (K7's bf16 forward moves the ratios off 1 there, as the
    reference's does: the branches are printed) and off them, every branch
    of the head's subgradients taken at the first of critic_scales that
    takes them (lstm_head_branch_counts at bf16). Returns (the largest
    difference, the on-policy inputs for timing)."""
    from drone_tpu_torch.ops import cuda_update_lstm as K7

    model = model or lstm_policy()
    arch = (model.hidden, model.encoder)
    order = model.kernel_order()
    planes, advret, snap, perm_mb, co, rbl, bptt = lstm_minibatch(cfg, model,
                                                                  env)
    args = (planes, advret, snap, perm_mb, model.flat, arch, co, rbl, bptt,
            cfg.train.ent_coef)
    label = f"K7 bf16 enc={enc_label(model.encoder)}"
    n = K7.lstm_head_branch_counts(*args[:9], compute_dtype=BF16)
    print(f"{label} at the planes' weights (K6's fp32 rollout, K7's bf16 "
          f"forward): {n}", flush=True)
    err = check_k7_bf16(args, order)
    for critic_scale in critic_scales:
        theta = off_policy(model.flat, order, critic_scale=critic_scale)
        try:
            check_branches(f"{label} (critic noise {critic_scale})",
                           K7.lstm_head_branch_counts(
                               planes, advret, snap, perm_mb, theta, arch, co,
                               rbl, bptt, compute_dtype=BF16))
            break
        except AssertionError:
            if critic_scale == critic_scales[-1]:
                raise
    err = max(err, check_k7_bf16((*args[:4], theta, *args[5:]), order))
    return err, args


def path_bf16_lstm_training(cfg_path, tmp) -> dict:
    """cli train under run.compute_dtype=bfloat16 of run.policy=lstm and
    cnn_lstm at the recurrent geometry, 2 updates each: K6 = 2 (fp32, as
    the reference rolls out), K7 = K4 = 32, every K7 launch its bf16 arm's
    (the CNN arm's for cnn_lstm); then cli eval of each checkpoint, which
    serves the bf16-trained policy through K8 in fp32 as the reference
    does. Returns {family: launch counts of its cli train}."""
    import torch

    from drone_tpu_torch import cli

    out = {}
    for family, over in (("lstm", LSTM_OVERRIDES),
                         ("cnn_lstm", CNN_LSTM_OVERRIDES)):
        sfx = " cnn" if family == "cnn_lstm" else ""
        want = {"K6" + sfx: 2, "K7" + sfx: 32, "K7 bf16": 32, "K7": 32,
                "K4": 32}
        zero_counts()
        t0 = time.time()
        rc = cli.main(["train", str(cfg_path), *over,
                       f"run.compute_dtype={BF16}", "run.total_updates=2",
                       f"run.checkpoint_dir={tmp}",
                       f"run.run_name={family}16"])
        torch.cuda.synchronize()
        c = counts()
        t_train = time.time() - t0
        zero_counts()
        rc2 = cli.main(["eval", str(cfg_path), over[0],
                        f"run.compute_dtype={BF16}",
                        f"run.resume_from={tmp}/{family}16/checkpoints"])
        torch.cuda.synchronize()
        e = counts()
        print(f"bf16 {family} path: cli train (2 updates) rc={rc} in "
              f"{t_train:.1f} s, launches {c}; cli eval rc={rc2}, launches "
              f"{e}", flush=True)
        if (rc, rc2) != (0, 0) or any(c[k] != v for k, v in want.items()):
            raise AssertionError(f"the bf16 {family} path launched {c}, "
                                 f"expected {want}")
        if e["K8" + sfx] != 1:
            raise AssertionError(f"cli eval did not serve the bf16 {family} "
                                 f"policy through K8: {e}")
        out[family] = c
    return out


def phase_bf16_lstm_learning_and_resume(tmp):
    """The bf16 recurrent learning gates under the fp32 gates' rules (the
    LSTM's one run from seed 0, lstm_gate_run; the cnn_lstm's four runs
    from seeds 0-3, cnn_lstm_gate); and resume under bfloat16: train(4) ==
    train(2) + resume(2) bitwise, carry included, for both families. A
    failed gate is raised after the resume checks have run."""
    import torch

    from drone_tpu_torch.train import train
    from drone_tpu_torch.utils.config import Config

    t0 = time.time()
    run = lstm_gate_run(0, BF16)
    _, _, _, first, last5, finite = run
    lstm_ok = gate_passes(run, *GATES["lstm"][1:])
    print(f"bf16 LSTM learning gate: mean reward of the first 5 of 100 "
          f"updates {first:.4f}, of the last 5 {last5:.4f}; parameters finite "
          f"{finite} ({time.time() - t0:.1f} s): {lstm_ok}", flush=True)
    cl_ok, rise = cnn_lstm_gate(GATE_SEEDS, BF16)
    print(f"bf16 cnn_lstm learning gate: mean reward rise over seeds "
          f"{list(GATE_SEEDS)} {rise:.4f}: {cl_ok}", flush=True)

    for family, over in (("lstm", ["run.policy=lstm", "run.lstm_hidden=32",
                                   "run.hidden=32,32"]),
                         ("cnn_lstm", ["run.policy=cnn_lstm"])):
        def cfg_for(name, total, extra=()):
            return Config.default().with_overrides([
                *over, f"run.compute_dtype={BF16}", "train.num_envs=1024",
                "train.horizon=16", "train.bptt_horizon=8", "train.epochs=2",
                "train.num_minibatches=2", "run.log_interval=2",
                f"run.total_updates={total}",
                f"run.run_name={family}16_{name}",
                f"run.checkpoint_dir={tmp}", *extra])

        full, _ = train(cfg_for("full", 4))
        train(cfg_for("half", 2))
        resumed, _ = train(cfg_for("resumed", 4, [
            f"run.resume_from={tmp}/{family}16_half/checkpoints"]))
        torch.cuda.synchronize()

        def tensors(r):
            return [*r.params.state_dict().values(), *r.opt_state,
                    r.env_state.fstate(), r.env_state.step, *r.carry]

        ok = all(bitwise_equal(a, b) for a, b in zip(tensors(full),
                                                     tensors(resumed)))
        print(f"bf16 {family} resume on the card: train(4) == train(2) + "
              f"resume(2) bitwise: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"bf16 {family} resume is not bitwise")
    if not (lstm_ok and cl_ok):
        raise AssertionError(f"a bf16 recurrent learning gate failed on the "
                             f"card (LSTM {lstm_ok}, cnn_lstm {cl_ok})")


def time_bf16_lstm(cfg_lstm, cfg_cl, k7_args, k7c_args) -> dict:
    """Times of K7's bf16 arm, dense and CNN, on the full-width minibatches
    of phase_k7_bf16 by CUDA events, beside its fp32 arm's on the same
    inputs in this call, its bf16 plain version and its bound (the
    products at the bf16 rate, the rest at the fp32 rate; the scratch's
    bytes beside it); and one bf16 LSTM and one bf16 cnn_lstm update split
    and traced as in 11. Returns {name: (ms, plain_ms, bound_ms, bound_by,
    library_ms)}."""
    from drone_tpu_torch.models.lstm import is_cnn
    from drone_tpu_torch.ops import cuda_update_lstm as K7

    out = {}
    for name, args in (("K7", k7_args), ("K7 cnn", k7c_args)):
        planes, perm_mb, theta, (H, enc), rbl, bptt = (
            args[0], args[3], args[4], args[5], args[7], args[8])
        cnn = is_cnn(enc)
        T, P = planes.shape[0], theta.numel()
        samples = perm_mb.numel() * rbl * T
        reps = 2 if cnn else 3
        ms = cuda_ms(lambda: K7.lstm_update_kernel(*args, compute_dtype=BF16),
                     reps=reps, warm_up=False)
        fp32 = cuda_ms(lambda: K7.lstm_update_kernel(*args), reps=reps)
        plain = cuda_ms(lambda: K7.lstm_update_plain(*args,
                                                     compute_dtype=BF16),
                        reps=1, warm_up=False)
        nbytes = (samples * 23 * 4 + (T // bptt) * 2 * H * perm_mb.numel()
                  * rbl * 4 + P * 4 + (P + 8) * 4)
        ops = samples * bptt_ops(H, enc)
        mma = samples * (k7_mma_ops(H, enc)
                         + (cnn_tower_mma_ops() if cnn else 0))
        bms, by = bf16_bound(mma, ops - mma, nbytes)
        # the bf16 walk's own scratch and bf16x2 fragments
        scratch = samples * 4 * k7_scratch_floats(H, enc, BF16)
        with_scratch = max(
            (mma / MMA_BF16_OPS_PER_S + (ops - mma) / FP32_OPS_PER_S) * 1e3,
            (nbytes + scratch) / HBM_BYTES_PER_S * 1e3)
        l2 = samples * gate_l2_bytes(H, enc, True, BF16)
        out[name] = (ms, plain, bms, by, None)
        print(f"{name} bf16: kernel {ms:.4f} ms (its fp32 arm in this call "
              f"{fp32:.4f} ms), plain {plain:.2f} ms, bound {bms:.4f} ms "
              f"({by}; products at {MMA_BF16_OPS_PER_S:.3g} op/s), "
              f"{with_scratch:.4f} ms with the scratch's {scratch:.4g} "
              f"bytes; the walk's gate fragments {l2:.4g} L2 bytes",
              flush=True)
    split_update(cfg_lstm.with_overrides([f"run.compute_dtype={BF16}"]))
    split_update(cfg_cl.with_overrides([f"run.compute_dtype={BF16}"]))
    return out


# -- the env adapters, the C-runtime export and racing through cli train ----
# phase 53's cases: (task, integrator, lanes), each 64 steps of a seeded
# action stream over episodes of at most 24 steps (crashes and truncations
# both end them, and auto-resets run)
ADAPTER_CASES = (("hover", "euler", 4096), ("waypoint", "rk4", 256),
                 ("racing", "rk4", 256))
ADAPTER_STEPS = 64
ADAPTER_HORIZON = 24
SERIAL_LANES = 8
SERIAL_STEPS = 32   # a loop of one-lane steps: 8 env steps a step
PARTIAL_SUBS = 2
SPS_LANES = 65536


def same_trace(a, b) -> bool:
    """Two traces (lists of numpy arrays) equal bit for bit."""
    import numpy as np

    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and np.array_equal(np.ascontiguousarray(x).view(np.uint8),
                           np.ascontiguousarray(y).view(np.uint8))
        for x, y in zip(a, b))


def _step_record(o, r, te, tr, infos) -> list:
    import numpy as np

    return [np.array(o), np.array(r), np.array(te), np.array(tr),
            *(np.array(infos[k]) for k in sorted(infos))]


def vec_trace(v, acts) -> list:
    """A VecDrone's reset and sync steps through `acts`."""
    import numpy as np

    out = [np.array(v.reset()[0])]
    for a in acts:
        out += _step_record(*v.step(a))
    return out


def partial_trace(v, acts) -> list:
    """A partial-batch VecDrone through `acts`: every recv() of the async
    protocol (each sub-batch's reset and steps, FIFO), its env_ids among
    the infos. Each sub-batch's last send is never received."""
    out = []
    v.async_reset()
    sent = [0] * (v.num_envs // v.batch_size)
    for _ in range(len(sent) * (len(acts) + 1)):
        o, r, te, tr, infos = v.recv()
        out += _step_record(o, r, te, tr, infos)
        ids = infos["env_ids"]
        i = int(ids[0]) // v.batch_size
        v.send(acts[min(sent[i], len(acts) - 1)][ids])
        sent[i] += 1
    return out


def gym_trace(env, seed, acts) -> list:
    """A DroneGymnasium from reset(seed) through `acts`, reset after every
    episode's end."""
    import numpy as np

    out = [env.reset(seed=seed)[0]]
    for a in acts:
        obs, r, term, trunc, info = env.step(a)
        ep = info.get("episode", {"r": 0.0, "l": 0})
        out += [obs, np.float32([r, ep["r"]]), np.int32([term, trunc, ep["l"]])]
        if term or trunc:
            out.append(env.reset()[0])
    return out


def vector_gym_trace(env, seed, acts) -> list:
    import numpy as np

    out = [env.reset(seed=seed)[0]]
    for a in acts:
        out += _step_record(*env.step(a))
    out.append(env.reset()[0])  # the unseeded reset's next episodes
    return out


def swarm_trace(env, seed, acts) -> list:
    """A DroneSwarmParallel from reset(seed) until its roster is empty (or
    `acts` ends): each step's live agents, their outputs and episodes."""
    import numpy as np

    obs, _ = env.reset(seed=seed)
    out = [np.stack([obs[a] for a in env.possible_agents])]
    index = {a: i for i, a in enumerate(env.possible_agents)}
    for a in acts:
        if not env.agents:
            break
        obs, rew, term, trunc, infos = env.step(
            {name: a[index[name]] for name in env.agents})
        names = list(obs)
        ep = [infos[n].get("episode", {"r": 0.0, "l": 0}) for n in names]
        out += [np.int32([index[n] for n in names]),
                np.stack([obs[n] for n in names]),
                np.float32([rew[n] for n in names]),
                np.int32([[term[n], trunc[n], e["l"]]
                          for n, e in zip(names, ep)]),
                np.float32([e["r"] for e in ep]),
                np.int32([index[n] for n in env.agents])]
    return out


def phase_adapters() -> dict:
    """Phase 53: every env adapter on the card against the same adapter on
    the CPU (the same seed and numpy action stream), bitwise; send() queued
    under torch's host-sync check; VecDrone steps/s at 65,536 lanes.
    Returns the seconds and the steps/s."""
    import torch

    from drone_tpu_torch import emulation, multiagent, spaces, vector
    from drone_tpu_torch.prng import action_stream_np
    from drone_tpu_torch.types import default_params

    t0 = time.time()
    bases = [f"{c.__name__} over {c.__mro__[1].__module__}."
             f"{c.__mro__[1].__name__}"
             for c in (emulation.DroneGymnasium,
                       emulation.DroneVectorGymnasium,
                       multiagent.DroneSwarmParallel)]
    fallback = emulation.DroneGymnasium.__mro__[1] is object
    print(f"adapters: {'; '.join(bases)}; spaces "
          f"{type(spaces.action_space()).__module__}."
          f"{type(spaces.action_space()).__name__} "
          f"({'the fallback classes' if fallback else 'gymnasium'})",
          flush=True)
    checked = []
    for task, integ, n in ADAPTER_CASES:
        p = default_params(task, horizon=ADAPTER_HORIZON)
        kw = dict(task=task, integrator=integ, params=p)
        acts = action_stream_np(ADAPTER_STEPS, n, seed=3)
        runs = {
            "VecDrone jit": lambda d: vec_trace(
                vector.make(num_envs=n, seed=1, device=d, **kw), acts),
            "VecDrone partial batch": lambda d: partial_trace(
                vector.make(num_envs=n, seed=1, device=d,
                            batch_size=n // PARTIAL_SUBS, **kw), acts),
            "DroneVectorGymnasium": lambda d: vector_gym_trace(
                emulation.make_vector(n, seed=0, device=d, **kw), 2, acts),
            "DroneSwarmParallel": lambda d: swarm_trace(
                multiagent.make_swarm(n, seed=0, device=d, **kw), 2, acts),
            "DroneGymnasium": lambda d: gym_trace(
                emulation.make_gymnasium(device=d, **kw), 4, acts[:, 0]),
        }
        serial = acts[:SERIAL_STEPS, :SERIAL_LANES]
        for backend in vector.BACKENDS:
            runs[f"VecDrone {backend}, {SERIAL_LANES} lanes"] = (
                lambda d, b=backend: vec_trace(vector.make(
                    num_envs=SERIAL_LANES, seed=1, backend=b, device=d,
                    **kw), serial))
        traces = {}
        for name, run in runs.items():
            t1 = time.time()
            card = run("cuda")
            t2 = time.time()
            cpu = run("cpu")
            if not same_trace(card, cpu):
                raise AssertionError(f"{name} on {task}/{integ}: the card "
                                     f"and the CPU differ")
            traces[name] = card
            checked.append(f"{name} {task}/{integ} ({t2 - t1:.1f} s card, "
                           f"{time.time() - t2:.1f} s CPU)")
        if not same_trace(*(traces[f"VecDrone {b}, {SERIAL_LANES} lanes"]
                            for b in vector.BACKENDS)):
            raise AssertionError(f"the jit and serial backends differ on "
                                 f"{task}/{integ}")
    print(f"adapters bitwise on the card and the CPU: {'; '.join(checked)}",
          flush=True)

    # send() queues the step without a host sync, sync and partial batch
    acts = action_stream_np(2, 4096, seed=5)
    for bs in (None, 1024):
        v = vector.make("hover", num_envs=4096, batch_size=bs, device="cuda")
        if bs is None:
            v.reset()
            v.step(acts[0])
        else:
            v.async_reset()
            v.send(acts[0][v.recv()[4]["env_ids"]])
            ids = v.recv()[4]["env_ids"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            v.send(acts[1] if bs is None else acts[1][ids])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        v.recv()
    print("send() queued without a host sync (sync and partial batch)",
          flush=True)

    v = vector.make("hover", num_envs=SPS_LANES, seed=0, device="cuda")
    v.reset()
    a = action_stream_np(1, SPS_LANES, seed=7)[0]
    for _ in range(3):
        v.step(a)
    reps = 30
    t1 = time.time()
    for _ in range(reps):
        v.step(a)
    sps = SPS_LANES * reps / (time.time() - t1)
    seconds = time.time() - t0
    print(f"VecDrone hover/euler {SPS_LANES} lanes (backend jit, sync "
          f"step with its numpy buffers): {sps:.6g} steps/s on "
          f"{device_line()}; phase 53 {seconds:.1f} s", flush=True)
    return {"steps_per_s": sps, "seconds": seconds}


def build_native() -> Path:
    """native/libdronenet.so and native/drone_demo built from native/ and
    oracle/ with cc and the Makefile's CFLAGS, into build/native/."""
    mk = (ROOT / "native" / "Makefile").read_text()
    flags = re.search(r"^CFLAGS\s*=\s*(.+)$", mk, re.M).group(1).split()
    out = ROOT / "build" / "native"
    out.mkdir(parents=True, exist_ok=True)
    nat, orc = ROOT / "native", ROOT / "oracle"
    jobs = [subprocess.Popen(
                ["cc", *flags, "-o", str(out / "drone_demo"),
                 str(nat / "demo.c"), str(nat / "dronenet.c"),
                 str(orc / "drone_oracle.c"), "-lm"]),
            subprocess.Popen(
                ["cc", *flags, "-shared", "-fPIC", "-o",
                 str(out / "libdronenet.so"), str(nat / "dronenet.c"),
                 "-lm"])]
    if any(j.wait(timeout=120) != 0 for j in jobs):
        raise AssertionError("the C runtime did not build")
    return out


class CNet:
    """A DRNW file loaded by libdronenet (ctypes)."""

    def __init__(self, lib_path, drnw):
        import ctypes as ct

        lib = ct.CDLL(str(lib_path))
        lib.dronenet_load.argtypes = [ct.c_void_p, ct.c_char_p]
        lib.dronenet_load.restype = ct.c_int
        lib.dronenet_scratch_size.argtypes = [ct.c_void_p]
        lib.dronenet_scratch_size.restype = ct.c_int
        fp = ct.POINTER(ct.c_float)
        lib.dronenet_forward.argtypes = [ct.c_void_p, fp, fp, fp, fp]
        lib.dronenet_forward.restype = None
        lib.dronenet_free.argtypes = [ct.c_void_p]
        lib.dronenet_free.restype = None
        self.lib = lib
        self.net = ct.create_string_buffer(16 * 1024)  # > sizeof(DroneNet)
        if lib.dronenet_load(self.net, str(drnw).encode()) != 0:
            raise AssertionError(f"libdronenet could not load {drnw}")

    def forward(self, obs, state=None):
        import ctypes as ct

        import numpy as np

        fp = ct.POINTER(ct.c_float)
        scratch = np.zeros(self.lib.dronenet_scratch_size(self.net),
                           np.float32)
        out = np.zeros(4, np.float32)
        obs = np.ascontiguousarray(obs, np.float32)
        self.lib.dronenet_forward(
            self.net, obs.ctypes.data_as(fp), out.ctypes.data_as(fp),
            scratch.ctypes.data_as(fp),
            state.ctypes.data_as(fp) if state is not None else None)
        return out

    def close(self):
        self.lib.dronenet_free(self.net)


def unit_quat_obs(n, seed):
    import numpy as np

    obs = np.random.RandomState(seed).randn(n, 13).astype(np.float32)
    obs[:, 3:7] /= np.linalg.norm(obs[:, 3:7], axis=1, keepdims=True)
    return obs


def phase_export_c(tmp, native) -> float:
    """Phase 54: a checkpoint of each family (MLP [64, 64], LSTM 128 /
    (64,), the default patch CNN, the default CNN-LSTM; seeded, actions of
    order 1) exported to DRNW and run by the C forward (ctypes), held to
    the module's forward on the card at the reference tests' tolerances
    (tests/test_framework.py): the feed-forward families on 8 observations,
    the recurrent ones over 12 steps that carry the state, reset at step 6.
    Returns the seconds."""
    import numpy as np
    import torch

    from drone_tpu_torch.models import export_flat_weights
    from drone_tpu_torch.utils.checkpoint import Checkpointer

    t0 = time.time()
    families = {
        "mlp": (seeded_policy(seed=4, head_gain=1.0).cuda(), 1e-5, 1e-6),
        "lstm": (lstm_policy(seed=4), 2e-5, 2e-6),
        "cnn": (cnn_policy(seed=4), 1e-5, 1e-6),
        "cnn_lstm": (cnn_lstm_policy(seed=4), 2e-5, 2e-5),
    }
    for name, (model, rtol, atol) in families.items():
        ckpt = Checkpointer(Path(tmp) / f"export_{name}")
        ckpt.save(1, model)
        raw, _ = ckpt.restore_raw()
        drnw = Path(tmp) / f"{name}.drnw"
        export_flat_weights(raw["params"], str(drnw), model=model)
        net = CNet(native / "libdronenet.so", drnw)
        recurrent = name in ("lstm", "cnn_lstm")
        obs = unit_quat_obs(12 if recurrent else 8, seed=len(name))
        worst = 0.0
        with torch.no_grad():
            if recurrent:
                state = np.zeros(2 * model.hidden, np.float32)
                carry = model.initial_carry(1, "cuda")
                card, c_out = [], []
                for t in range(len(obs)):
                    if t == 6:  # an episode boundary on both sides
                        state[:] = 0.0
                        carry = model.initial_carry(1, "cuda")
                    mean, _, _, carry = model(
                        torch.from_numpy(obs[t:t + 1]).cuda(), carry)
                    card.append(mean[0].cpu().numpy())
                    c_out.append(net.forward(obs[t], state))
            else:
                mean, _, _ = model(torch.from_numpy(obs).cuda())
                card = list(mean.cpu().numpy())
                c_out = [net.forward(o) for o in obs]
        net.close()
        card, c_out = np.stack(card), np.stack(c_out)
        worst = float(np.max(np.abs(c_out - card)
                             / (atol + rtol * np.abs(card))))
        print(f"export {name}: DRNW {drnw.stat().st_size} bytes, C forward "
              f"against the module on the card: max |diff| "
              f"{float(np.abs(c_out - card).max()):.3g}, {worst:.3g} of the "
              f"tolerance (rtol {rtol}, atol {atol}); |mean| up to "
              f"{float(np.abs(card).max()):.3g}", flush=True)
        if not np.isfinite(card).all() or worst > 1.0:
            raise AssertionError(f"the C forward of the {name} export "
                                 f"disagrees with the module on the card")
    seconds = time.time() - t0
    print(f"phase 54 {seconds:.1f} s", flush=True)
    return seconds


def path_racing(tmp, native) -> dict:
    """Phase 55: `cli train configs/racing.toml run.total_updates=2` on the
    card (K2, K3 and K4 each launched, the losses finite), then `cli
    export` and the C demo for one racing/rk4 episode. Returns the launch
    counts and the seconds."""
    import ctypes as ct

    import numpy as np
    import torch

    from drone_tpu_torch import cli
    from drone_tpu_torch.models.export import CParams
    from drone_tpu_torch.types import default_params

    t0 = time.time()
    cfg_path = str(ROOT / "configs" / "racing.toml")
    where = [f"run.checkpoint_dir={tmp}", "run.log_interval=1"]
    zero_counts()
    rc = cli.main(["train", cfg_path, "run.total_updates=2", *where])
    torch.cuda.synchronize()
    c = counts()
    recs = [json.loads(line) for line in
            (Path(tmp) / "racing" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs]
    print(f"racing path: cli train configs/racing.toml (2 updates) rc={rc}; "
          f"launches {c}; losses {losses}", flush=True)
    # 2 updates of 4 epochs x 8 minibatches
    want = {"K2": 2, "K3": 64, "K4": 64}
    if rc != 0 or any(c[k] != v for k, v in want.items()):
        raise AssertionError(f"cli train of racing.toml launched {c}, "
                             f"expected {want}")
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"racing losses {losses}")

    out = Path(tmp) / "racing.drnw"
    rc = cli.main(["export", cfg_path, *where, "--out", str(out)])
    if rc != 0:
        raise AssertionError("cli export of the racing checkpoint failed")
    demo = subprocess.run(
        [str(native / "drone_demo"), str(out), f"{out}.params", "1", "2",
         "0", "1"], capture_output=True, text=True, cwd=tmp, timeout=120)
    print(f"C demo (1 racing/rk4 episode): rc={demo.returncode} "
          f"{demo.stdout.strip().splitlines()[-1:]}", flush=True)
    if demo.returncode != 0:
        raise AssertionError(f"the C demo failed: {demo.stderr[-2000:]}")
    rows = np.loadtxt(Path(tmp) / "trajectory.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    if not (len(rows) and np.isfinite(rows).all() and rows[-1, 8] == 1):
        raise AssertionError("trajectory.csv is empty, not finite or does "
                             "not end its episode")
    data = Path(f"{out}.params").read_bytes()
    cp = CParams.from_buffer_copy(data[12:12 + ct.sizeof(CParams)])
    want = default_params("racing")
    gates = np.array(cp.gates, np.float32).reshape(-1, 3)[:cp.n_gates]
    if cp.n_gates != int(want.n_gates) or not np.array_equal(
            gates, want.gates.numpy()[:int(want.n_gates)]):
        raise AssertionError(f"the .params gates {gates} are not racing's")
    seconds = time.time() - t0
    print(f"racing path: {len(rows)} C demo steps, the {cp.n_gates} gates "
          f"read back; phase 55 {seconds:.1f} s", flush=True)
    return {"counts": c, "seconds": seconds}


SWEEP_SPAWN_UPDATES = 10  # the workers=2 against workers=1 sweep's one rung


def path_sweep(tmp) -> dict:
    """Phase 56: `cli sweep configs/sweep_hover.toml --device cuda` in full
    (8 trials of 60 updates, the best 4 for 200 more; 4,096 envs, MLP [32,
    32]): every trial's score finite (a caught failure scores -inf), K2, K3
    and K4 launched by every trial (K2 once an update, K3 and K4 once an SGD
    step); `--resume` on the finished journal trains nothing; and a 2-trial
    sweep of one rung under suggester="random" gives bitwise the same scores
    with workers=2 (spawned processes on the card) as with workers=1.
    Returns the launch counts of the sweep and the seconds."""
    import contextlib
    import io

    import torch

    from drone_tpu_torch import cli, sweep
    from drone_tpu_torch.utils.config import Config

    t0 = time.time()
    cfg_path = ROOT / "configs" / "sweep_hover.toml"
    cfg = Config.from_toml(cfg_path)
    sgd = cfg.train.epochs * cfg.train.num_minibatches
    out = Path(tmp) / "sweep" / "results.json"
    where = [f"run.checkpoint_dir={Path(tmp) / 'sweep'}"]
    trials = []
    real = sweep._default_train_fn

    def counted(c, device="cuda"):
        # one trial's launches: zeroed before it, read after it
        zero_counts()
        try:
            return real(c, device=device)
        finally:
            torch.cuda.synchronize()
            trials.append((c.run.run_name, c.run.total_updates, counts()))

    sweep._default_train_fn = counted
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = cli.main(["sweep", str(cfg_path), *where, "--device", "cuda",
                           "--out", str(out)])
        t_sweep = time.time() - t0
        print("\n".join(line for line in log.getvalue().splitlines()
                        if not line.startswith("upd ")), flush=True)
        n_trained = len(trials)
        with contextlib.redirect_stdout(io.StringIO()):
            rc_resume = cli.main(["sweep", str(cfg_path), *where, "--device",
                                  "cuda", "--out", str(out), "--resume"])
    finally:
        sweep._default_train_fn = real
    results = json.loads(out.read_text())
    journal = [json.loads(line) for line in
               Path(f"{out}.jsonl").read_text().splitlines()]
    total = collections.Counter()
    for name, updates, c in trials[:n_trained]:
        total.update(c)
        want = {"K2": updates, "K3": updates * sgd, "K4": updates * sgd}
        if any(c[k] != v for k, v in want.items()):
            raise AssertionError(f"sweep trial {name} launched {c}, "
                                 f"expected {want}")
    scores = [r["score"] for r in journal]
    print(f"sweep path: cli sweep rc={rc} in {t_sweep:.1f} s, {n_trained} "
          f"trainings ({sum(u for _, u, _ in trials)} updates); journal "
          f"scores {scores}; launches {nonzero(total)}; --resume "
          f"rc={rc_resume} "
          f"trained {len(trials) - n_trained}", flush=True)
    rungs = cfg.sweep["rungs"]
    n_want = cfg.sweep["trials"] + int(cfg.sweep["trials"] * cfg.sweep["keep"])
    if rc != 0 or n_trained != n_want or len(journal) != n_want:
        raise AssertionError(f"the sweep trained {n_trained} trials and "
                             f"journaled {len(journal)}, expected {n_want}")
    if not all(math.isfinite(s) for s in scores):
        raise AssertionError(f"a sweep trial failed (score -inf): {scores}")
    if rc_resume != 0 or len(trials) != n_trained or json.loads(
            out.read_text()) != results:
        raise AssertionError("--resume on the finished journal trained again "
                             "or changed the results")
    if [r["rungs_completed"] for r in results[:4]] != [len(rungs)] * 4:
        raise AssertionError(f"ranking {results}")

    spawn = {}
    for workers in (2, 1):
        c = cfg.with_overrides([f"run.checkpoint_dir={tmp}/spawn{workers}"])
        c.sweep = dict(c.sweep, trials=2, rungs=[SWEEP_SPAWN_UPDATES],
                       suggester="random")
        t1 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            res = sweep.run_sweep(c, workers=workers, device="cuda")
        spawn[workers] = (sorted((json.dumps(r["point"], sort_keys=True),
                                  r["score"]) for r in res),
                          time.time() - t1)
    print(f"sweep workers=2 (spawned) {spawn[2][0]} in {spawn[2][1]:.1f} s; "
          f"workers=1 {spawn[1][0]} in {spawn[1][1]:.1f} s", flush=True)
    if spawn[2][0] != spawn[1][0] or not all(
            math.isfinite(s) for _, s in spawn[1][0]):
        raise AssertionError("the spawned sweep's scores differ from the "
                             "sequential sweep's")
    seconds = time.time() - t0
    updates = sum(u for _, u, _ in trials)
    return {"counts": dict(total), "seconds": seconds, "sweep_s": t_sweep,
            "updates": updates,
            "samples": updates * cfg.train.num_envs * cfg.train.horizon}


def path_autotune() -> dict:
    """Phase 57: `cli autotune configs/hover.toml --device cuda --iters 1`:
    every candidate of candidate_shapes measured (a warm-up and one timed
    update each), none failed, each on the megakernel trainer, K2, K3 and K4
    launched (K2 twice a candidate). Prints the ranked list. Returns the
    launch counts, the results and the seconds."""
    import contextlib
    import io

    import torch

    from drone_tpu_torch import cli
    from drone_tpu_torch.autotune import candidate_shapes
    from drone_tpu_torch.utils.config import Config

    cfg_path = ROOT / "configs" / "hover.toml"
    cands = candidate_shapes(Config.from_toml(cfg_path))
    t0 = time.time()
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = cli.main(["autotune", str(cfg_path), "--device", "cuda",
                       "--iters", "1"])
    torch.cuda.synchronize()
    c = counts()
    seconds = time.time() - t0
    lines = log.getvalue().splitlines()
    print("\n".join(line for line in lines if not line.startswith("[")),
          flush=True)
    results = json.loads(next(line for line in lines
                              if line.startswith("[{")))
    print(f"autotune path: rc={rc}, {len(results)} of {len(cands)} "
          f"candidates measured in {seconds:.1f} s; launches {nonzero(c)}",
          flush=True)
    for r in results:
        print(f"  {r['num_envs']:>7} envs x {r['num_minibatches']} "
              f"minibatches: {r['sps'] / 1e6:.3f} M samples/s "
              f"({r['trainer']})", flush=True)
    if rc != 0 or len(results) != len(cands) or any(
            "failed" in line for line in lines):
        raise AssertionError(f"autotune measured {len(results)} of "
                             f"{len(cands)} candidates")
    if any(r["trainer"] != "megakernel" for r in results):
        raise AssertionError("an autotune candidate left the megakernel "
                             "trainer")
    if c["K2"] != 2 * len(cands) or c["K3"] < c["K2"] or c["K4"] != c["K3"]:
        raise AssertionError(f"autotune launched {c}")
    return {"counts": c, "results": results, "seconds": seconds}


WATCH_STEPS = 200
WATCH_CPU_ROWS = 40
WATCH_CASES = (("mlp", ["env.task=racing", "env.integrator=rk4"]),
               ("lstm", ["run.policy=lstm", "env.params.horizon=60"]),
               ("cnn_lstm", ["run.policy=cnn_lstm", "env.params.horizon=60"]))


def phase_watch(tmp) -> dict:
    """Phase 58: the watch rollout (`viewer.watch_rollout`, what `cli
    watch` writes before it renders) on the card for 200 steps: mlp on
    racing/rk4 and lstm and cnn_lstm on hover (episodes of 60 steps), each
    from a seeded checkpoint. The CSV has the reference's header and finite
    values; the recurrent families' rows are those of the evaluation path
    (ppo_rnn.rollout_recurrent on the card, the carry zeroed at each done);
    the first 40 rows match a CPU watch rollout of the same checkpoint
    (done equal, positions within 1e-3). Renders a PNG when matplotlib
    imports. Returns the seconds of each rollout."""
    import numpy as np
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ppo_rnn import rollout_recurrent
    from drone_tpu_torch.utils.checkpoint import Checkpointer
    from drone_tpu_torch.utils.config import Config
    from drone_tpu_torch.viewer import CSV_HEADER, watch_rollout

    def rows_of(path):
        text = Path(path).read_text()
        if not text.startswith(CSV_HEADER):
            raise AssertionError(f"{path}: header {text.splitlines()[0]!r}")
        return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)

    try:
        from viz.viewer import load_csv, render
    except ImportError:
        render = None
    seconds = {}
    for policy, overrides in WATCH_CASES:
        if policy == "mlp":
            model = seeded_policy(seed=3, head_gain=1.0)
        elif policy == "lstm":
            model = lstm_policy(seed=3)
        else:
            model = cnn_lstm_policy(seed=3)
        ckpt = Path(tmp) / f"watch-{policy}"
        Checkpointer(ckpt).save(0, model)
        cfg = Config.default().with_overrides(
            [*overrides, f"run.resume_from={ckpt}"])
        csv_path = Path(tmp) / f"watch-{policy}.csv"
        zero_counts()
        t0 = time.time()
        gates = watch_rollout(cfg, str(csv_path), WATCH_STEPS, device="cuda")
        seconds[policy] = time.time() - t0
        rows = rows_of(csv_path)
        cpu_path = Path(tmp) / f"watch-{policy}-cpu.csv"
        watch_rollout(cfg, str(cpu_path), WATCH_CPU_ROWS, device="cpu")
        cpu = rows_of(cpu_path)
        dones = int(rows[:, 8].sum())
        if rows.shape != (WATCH_STEPS, 9) or not np.isfinite(rows).all():
            raise AssertionError(f"watch {policy}: rows {rows.shape}, finite "
                                 f"{np.isfinite(rows).all()}")
        head = rows[:WATCH_CPU_ROWS]
        pos_err = float(np.abs(head[:, 1:7] - cpu[:, 1:7]).max())
        if not np.array_equal(head[:, 8], cpu[:, 8]) or pos_err > 1e-3:
            raise AssertionError(f"watch {policy}: the card's first "
                                 f"{WATCH_CPU_ROWS} rows differ from the "
                                 f"CPU's by {pos_err:.3g}")
        note = ""
        if policy != "mlp":
            statics, params = cfg.env.build()
            env = DroneEnv(statics.task, statics.integrator, params,
                           device="cuda")
            model.eval()
            _, _, out = rollout_recurrent(model, env, env.init_batch(0, 1),
                                          model.initial_carry(1, env.device),
                                          WATCH_STEPS)
            done = (out.terminated | out.truncated)[:, 0].float().cpu().numpy()
            rel = out.obs[:, 0, :3].cpu().numpy()
            carry_err = float(np.abs(rows[:, 4:7] - rows[:, 1:4] - rel).max())
            if dones < 2 or not np.array_equal(rows[:, 8], done) \
                    or carry_err > 1e-3:
                raise AssertionError(
                    f"watch {policy}: {dones} episode ends, the rollout "
                    f"differs from the evaluation path's (its carry zeroed "
                    f"at each done) by {carry_err:.3g}")
            note = (f", the evaluation path's rows within {carry_err:.2g} "
                    f"(carry zeroed at each of the {dones} dones)")
        if policy == "mlp" and len(gates or ()) != 4:
            raise AssertionError(f"watch racing gates {gates}")
        rendered = "the render was not run (matplotlib does not import)"
        if render is not None:
            try:
                png = render(load_csv(csv_path),
                             str(csv_path.with_suffix(".png")), gates=gates)
                rendered = f"rendered {Path(png).stat().st_size} bytes"
            except ImportError:
                pass
        print(f"watch {policy}: {WATCH_STEPS} steps on the card in "
              f"{seconds[policy]:.2f} s, {dones} dones, the CPU's first "
              f"{WATCH_CPU_ROWS} rows within {pos_err:.2g}{note}; gates "
              f"{gates}; {rendered}; launches {nonzero(counts())}", flush=True)
    return seconds


def _dist_tier_updates(overrides, mesh, depth=2):
    """`depth` updates of hover.toml with `overrides` on the card through
    make_sharded_train_step (mesh None: the undistributed trainer). Returns
    (trainer kind, runner, metrics, step)."""
    import dataclasses

    from drone_tpu_torch import train
    from drone_tpu_torch.parallel import make_sharded_train_step
    from drone_tpu_torch.utils.config import Config

    cfg = Config.from_toml(ROOT / "configs" / "hover.toml").with_overrides(
        list(overrides))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_updates=cfg.run.total_updates))
    env, model = train.build_env_and_model(cfg, "cuda")
    kind = train.trainer_kind(cfg, model)
    recurrent = cfg.run.policy in ("lstm", "cnn_lstm")
    init = train.init_recurrent_runner if recurrent else train.init_runner
    runner = init(model, env, cfg.train, seed=cfg.run.seed)
    step = make_sharded_train_step(
        runner.params, env, cfg.train, mesh, trainer=train._TRAINERS[kind],
        recurrent=recurrent, policy=cfg.run.policy,
        compute_dtype=cfg.run.compute_dtype)
    m = None
    for _ in range(depth):
        runner, m = step(runner)
    return kind, runner, m, step


# the five tiers of phase 59, the later ones at a smaller depth than the
# reference's shapes
DIST_TIERS = (
    ("MLP megakernel", "megakernel", ()),
    ("CNN megakernel", "megakernel",
     ("run.policy=cnn", "train.num_envs=8192", "train.horizon=32",
      "train.num_minibatches=4")),
    ("LSTM megakernel", "megakernel",
     ("run.policy=lstm", "train.num_envs=16384", "train.horizon=32",
      "train.bptt_horizon=16", "train.num_minibatches=4")),
    ("hybrid", "hybrid",
     ("run.policy=lstm", "train.num_envs=16256", "train.horizon=32",
      "train.bptt_horizon=16", "train.num_minibatches=4")),
    ("scan", "scan",
     ("run.rollout=scan", "train.num_envs=8192", "train.horizon=32")),
)


def phase_world_of_one(port) -> dict:
    """Phases 59 and 61 in a NCCL process group of one rank on the card.

    59: two sharded updates (parallel.make_sharded_train_step: the advantage
    moments, each SGD step's gradient and the metrics through NCCL's
    all_reduce) of each tier bitwise equal to two undistributed updates in
    parameters, optimizer state, env state and metrics: the MLP megakernel
    trainer at hover.toml, the CNN and LSTM megakernel trainers, the
    recurrent hybrid tier and the scan trainer (smaller depths); then one
    more MLP update queued under torch.cuda.set_sync_debug_mode("error").
    61: ops.sharded's K1 and K5 on the rank's lanes (65,536, hover) bitwise
    equal to the unsharded kernels in final state and statistics.
    Returns the launch counts of the sharded runs, per tier, and the
    seconds."""
    import torch
    import torch.distributed as dist

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import act_rollout_cuda, rollout_cuda
    from drone_tpu_torch.ops.sharded import (
        sharded_act_rollout_cuda,
        sharded_rollout_cuda,
    )
    from drone_tpu_torch.parallel.mesh import make_mesh

    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cuda")
        tiers = {}
        for name, want_kind, overrides in DIST_TIERS:
            t1 = time.time()
            kind, a, ma, _ = _dist_tier_updates(overrides, None)
            zero_counts()
            _, b, mb, step = _dist_tier_updates(overrides, mesh)
            torch.cuda.synchronize()
            c = counts()
            same = (bitwise_equal(a.params.flat, b.params.flat)
                    and all(bitwise_equal(x, y)
                            for x, y in zip(a.opt_state, b.opt_state))
                    and bitwise_equal(a.env_state.fstate(),
                                      b.env_state.fstate())
                    and set(ma) == set(mb)
                    and all(bitwise_equal(ma[k], mb[k]) for k in ma))
            print(f"world of 1 over NCCL, {name} ({kind}): 2 sharded updates "
                  f"bitwise the undistributed: {same}; loss "
                  f"{float(mb['loss'])!r}; launches {nonzero(c)}; "
                  f"{time.time() - t1:.1f} s", flush=True)
            if kind != want_kind or not same:
                raise AssertionError(f"world of 1, {name}: kind {kind}, "
                                     f"bitwise {same}")
            tiers[name] = c
            if name == "MLP megakernel":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    b, m = step(b)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                print(f"  a third sharded MLP update queued with no host "
                      f"sync; loss {float(m['loss'])!r}", flush=True)

        env = DroneEnv(device="cuda")
        n, T = 65536, 256
        state = env.init_batch(0, n)
        policy = seeded_policy(seed=1).cuda()
        zero_counts()
        k1 = sharded_rollout_cuda(mesh, state, env.params, env.statics, T)
        k5 = sharded_act_rollout_cuda(mesh, state, policy, env.params,
                                      env.statics, T)
        torch.cuda.synchronize()
        sharded_counts = counts()
        w1 = rollout_cuda(state, env.params, env.statics, T)
        w5 = act_rollout_cuda(state, policy, env.params, env.statics, T)
        same = {k: bitwise_equal(g[0].fstate(), w[0].fstate())
                and all(bitwise_equal(g[1][s], w[1][s]) for s in w[1])
                for k, g, w in (("K1", k1, w1), ("K5", k5, w5))}
        print(f"world of 1: sharded K1 and K5 ({n} lanes x {T} steps) "
              f"bitwise the unsharded kernels {same}; episodes "
              f"{float(k1[1]['episodes']):.0f}, "
              f"{float(k5[1]['episodes']):.0f}; "
              f"launches {nonzero(sharded_counts)}", flush=True)
        if not all(same.values()) or sharded_counts["K1"] != 1 \
                or sharded_counts["K5"] != 1:
            raise AssertionError(f"sharded K1/K5 {same}, {sharded_counts}")
        tiers["sharded K1, K5"] = sharded_counts
    finally:
        dist.destroy_process_group()
    return {"counts": tiers, "seconds": time.time() - t0}


GLOO_LANES = 16384  # a rank's lanes in phase 60


def smoke_ranks(*args) -> list:
    """`python -m drone_tpu_torch.parallel._smoke_worker` as ranks 0 and 1
    of a Gloo group on a free port, the MLP megakernel trainer on the card,
    hover.toml at GLOO_LANES lanes a rank with `args` after it. Returns
    each rank's SMOKE_OK fields ({"loss": ..., "launches": [K2, K3, K4],
    ...})."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "drone_tpu_torch.parallel._smoke_worker",
         str(port), "2", str(pid), "pallas", "cuda", "gloo",
         "--config", str(ROOT / "configs" / "hover.toml"),
         f"train.num_envs={2 * GLOO_LANES}", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        if p.returncode != 0:
            raise AssertionError(f"smoke worker failed: {out[-3000:]}")
    lines = [line for o in outs for line in o.splitlines()
             if line.startswith("SMOKE_OK")]
    print("\n".join(lines), flush=True)
    if len(lines) != 2:
        raise AssertionError(f"two smoke workers printed {lines}")
    ranks = []
    for line in lines:
        f = dict(kv.split("=", 1) for kv in line.split()[1:])
        f["launches"] = [int(x) for x in f["launches"].split(",")]
        ranks.append(f)
    return ranks


def phase_gloo_ranks(tmp) -> dict:
    """Phase 60: two ranks sharing the card over Gloo (NCCL refuses two ranks
    on one device), each `python -m drone_tpu_torch.parallel._smoke_worker`
    through train.build on hover.toml's widths and horizon at 16,384 lanes
    a rank.

    Its own geometry, two updates: both ranks print the same loss and
    approx-KL bit for bit, on the megakernel trainer, each with K2 2, K3
    and K4 2 x epochs x minibatches launches. Then one update of one epoch
    of one minibatch with the clip off (the ranks' permutations only
    reorder the sums; the first moment is the averaged gradient): each
    rank's parameters, optimizer state and metrics against one
    undistributed update of the 32,768-lane global batch on the card,
    allclose at rtol 2e-5 / atol 1e-7 (metrics atol 1e-6: means of
    order-one terms), the ranks' lanes bitwise the global run's. Returns
    the launch counts summed over the ranks and the seconds."""
    import numpy as np
    import torch

    from drone_tpu_torch import train
    from drone_tpu_torch.utils.config import Config

    t0 = time.time()
    hover = Config.from_toml(ROOT / "configs" / "hover.toml")
    sgd = hover.train.epochs * hover.train.num_minibatches
    ranks = smoke_ranks("run.total_updates=2")
    same = (len({r["loss"] for r in ranks}) == 1
            and len({r["kl"] for r in ranks}) == 1)
    want = [2, 2 * sgd, 2 * sgd]
    if not same or any(r["kind"] != "megakernel" or r["launches"] != want
                       for r in ranks):
        raise AssertionError(f"two Gloo ranks: bitwise {same}, want "
                             f"megakernel launches {want}: {ranks}")
    total = collections.Counter(
        {k: sum(r["launches"][i] for r in ranks)
         for i, k in enumerate(("K2", "K3", "K4"))})
    print(f"two Gloo ranks on the card, hover.toml at {GLOO_LANES} lanes a "
          f"rank: loss {ranks[0]['loss']} on both; launches {want} a rank; "
          f"{time.time() - t0:.1f} s", flush=True)

    t1 = time.time()
    one = ["train.epochs=1", "train.num_minibatches=1",
           "train.max_grad_norm=1e9", "run.total_updates=1"]
    dump = Path(tmp) / "gloo_dump"
    dump.mkdir()
    ranks = smoke_ranks(*one, "--dump", str(dump))
    if any(r["launches"] != [1, 1, 1] for r in ranks):
        raise AssertionError(f"one update, launches {ranks}")
    total.update({k: 2 for k in ("K2", "K3", "K4")})
    cfg = hover.with_overrides([f"train.num_envs={2 * GLOO_LANES}"] + one)
    env, model, runner, step, cfg = train.build(cfg, "cuda")
    if step.mesh is not None or step.kind != "megakernel":
        raise AssertionError(f"the global run: {step.mesh}, {step.kind}")
    runner, m = step(runner)
    got = [torch.load(dump / f"rank{r}.pt", map_location="cuda")
           for r in range(2)]
    worst = 0.0

    def close(a, b, atol=1e-7):
        nonlocal worst
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        worst = max(worst, float(np.max(np.abs(a - b) / (atol + 2e-5
                                                         * np.abs(b)))))
        return bool(np.allclose(a, b, rtol=2e-5, atol=atol))

    ok = all(
        close(g["params"], runner.params.flat)
        and all(close(x, y) for x, y in zip(g["opt_state"],
                                            runner.opt_state))
        and set(g["metrics"]) == set(m)
        and all(close(g["metrics"][k], m[k], 1e-6) for k in m)
        for g in got)
    lanes = bitwise_equal(torch.cat([g["env_state"] for g in got]),
                          runner.env_state.fstate())
    replicated = bitwise_equal(got[0]["params"], got[1]["params"])
    print(f"two Gloo ranks x {GLOO_LANES} lanes against one update of the "
          f"{2 * GLOO_LANES}-lane global batch (one epoch, one minibatch, "
          f"no clip): allclose {ok} (worst |diff| / (atol + rtol |want|) "
          f"{worst:.3g}), lanes bitwise {lanes}, parameters replicated "
          f"{replicated}; loss {float(m['loss'])!r}; "
          f"{time.time() - t1:.1f} s", flush=True)
    if not (ok and lanes and replicated):
        raise AssertionError("two Gloo ranks differ from the global batch")
    seconds = time.time() - t0
    return {"counts": dict(total), "seconds": seconds}


def nonzero(c) -> dict:
    """The launch counts that are not 0."""
    return {k: v for k, v in c.items() if v}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Laps:
    """Host-clock seconds of each phase of the script: lap(name) closes the
    phase that ends there."""

    def __init__(self):
        self.t = time.time()
        self.seconds = {}

    def __call__(self, name):
        now = time.time()
        self.seconds[name] = round(now - self.t, 1)
        self.t = now


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from drone_tpu_torch import cli
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting, cuda_build, cuda_rollout
    from drone_tpu_torch.ops import rollout_cuda
    from drone_tpu_torch.train import evaluate
    from drone_tpu_torch.utils.checkpoint import Checkpointer
    from drone_tpu_torch.utils.config import Config

    t_start = time.time()
    lap = Laps()
    failed = []

    def gate(phase, tmp):
        # a learning gate's failure is recorded; the later phases still run
        try:
            phase(tmp)
        except AssertionError as e:
            failed.append(str(e))
            print(f"FAILED: {e}", flush=True)

    dev = device_line()
    print(dev, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    libs = cuda_build.build()
    print(f"built {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    for name, lib in libs.items():
        log = lib.with_suffix(".so.log").read_text().splitlines()
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in log if "Used " in line})
        spills = [line.strip() for line in log if "spill stores" in line
                  and " 0 bytes spill stores" not in line]
        print(f"  {name}: registers per kernel {regs}; spilling kernels: "
              f"{len(spills)} {spills}", flush=True)
    # the tensor-core kernels (K10, K7's both arms and its products, K11/K9
    # and both arms of K8/K6 on hover/euler, K3 on chip and off it, K5 and
    # K2 on hover/euler), with their dynamic shared memory at the main
    # paths' shapes (cnn_mma.cuh TF_SMEM, TB_SMEM, the bf16 arm's TFB_SMEM,
    # TBB_SMEM; the walk's, the acting arms' and the products' are the
    # wrappers' bptt_smem_bytes, act_smem_bytes and PRODUCT_SMEM(_BF16,
    # _ROUNDED);
    # the bf16 gWt product's mma.cuh GB_SMEM; K3's mma_layout and its bf16
    # arm's b16_layout, off chip at [128, 128]; K5's act_layout; K2's
    # traj_layout)
    from drone_tpu_torch.ops import cuda_acting_lstm as K8
    from drone_tpu_torch.ops import cuda_acting_traj as K2
    from drone_tpu_torch.ops import cuda_update as K3
    from drone_tpu_torch.ops import cuda_update_cnn as K10
    from drone_tpu_torch.ops import cuda_update_lstm as K7
    from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH

    smem = {"cnn_fwd_kernelILb0E": K10.TOWER_FWD_SMEM,
            "cnn_fwd_kernelILb1E": K10.TOWER_FWD_SMEM_BF16,
            "tower_fwd_kernelILb0E": K10.TOWER_FWD_SMEM,
            "tower_fwd_kernelILb1E": K10.TOWER_FWD_SMEM_BF16,
            "tower_bwd_kernelILb0E": K10.TOWER_BWD_SMEM,
            "tower_bwd_kernelILb1E": K10.TOWER_BWD_SMEM_BF16,
            "cnn_gemm_kernelILb1E": K7.PRODUCT_SMEM_BF16,
            "pack_tower_kernel": 0,
            "bptt_kernel<cnn>": K7.bptt_smem_bytes(128, KERNEL_ARCH),
            "bptt_kernel<dense>": K7.bptt_smem_bytes(128, (64,)),
            "bptt_kernel<cnn, bf16>": K7.bptt_smem_bytes(128, KERNEL_ARCH,
                                                         BF16),
            "bptt_kernel<dense, bf16>": K7.bptt_smem_bytes(128, (64,), BF16),
            "grad_mma_kernelILb0E": K7.PRODUCT_SMEM,
            "grad_mma_kernelILb1E": K7.PRODUCT_SMEM_BF16,
            "grad_rounded_kernel": K7.PRODUCT_SMEM_ROUNDED,
            "cnn_act_kernelILi0ELi0ELb0E": K10.TOWER_FWD_SMEM,
            "cnn_act_kernelILi0ELi0ELb1E": K10.TOWER_FWD_SMEM_BF16,
            "lstm_act_kernel<cnn>": K8.act_smem_bytes(128, KERNEL_ARCH),
            "lstm_act_kernel<dense>": K8.act_smem_bytes(128, (64,)),
            "pack_gates_kernel": 0, "pack_gates_t_kernel": 0,
            "update_kernelILb1ELb0E": K3.mma_layout((64, 64))["smem"],
            "update_kernelILb1ELb1E": K3.b16_layout((64, 64))["smem"],
            "update_kernelILb0ELb0E": K3.mma_layout((128, 128))["smem"],
            "update_kernelILb0ELb1E": K3.b16_layout((128, 128))["smem"],
            "pack_planes_kernel": 0, "pack_b16_kernel": 0,
            "act_kernelILi0ELi0ELb0E": cuda_acting.act_layout((64, 64))["smem"],
            "act_kernelILi0ELi0ELb1E": cuda_acting.act_layout((64, 64))["smem"],
            "traj_kernelILi0ELi0ELb0ELb0E": K2.traj_layout((64, 64))["smem"],
            "traj_kernelILi0ELi0ELb1ELb0E": K2.traj_layout((64, 64))["smem"],
            "traj_kernelILi0ELi0ELb1ELb1E": K2.traj_layout((64, 64),
                                                           BF16)["smem"],
            "pack_traj_kernel": 0, "pack_traj_b16_kernel": 0}
    # every one of them but the packing runs mma.sync: its SASS must hold
    # HMMA instructions
    keys = list(dict.fromkeys(k.split("<")[0] for k in smem))
    keys = [f"{k}ILi0ELi0E" if k == "lstm_act_kernel" else k for k in keys]
    mma = {}
    for name in ("update_cnn", "update_lstm", "acting_cnn", "acting_lstm",
                 "update", "acting", "acting_traj"):
        lib_mma = mma_counts(libs[name], keys)
        mma.update(lib_mma)
        for k, (regs, spill) in ptxas_report(libs[name], keys).items():
            if k in smem:
                print(f"  {name} {k}: {regs} registers, {smem[k]} bytes of "
                      f"dynamic shared memory, {lib_mma.get(k)} HMMA "
                      f"instructions; {spill}", flush=True)
    # K1's instances: rollout_kernel<task, integrator, provided actions>
    k1_keys = [f"rollout_kernelILi{t}ELi{i}ELb{a}E" for t in range(3)
               for i in range(2) for a in range(2)]
    for k, (regs, spill) in ptxas_report(libs["rollout"], k1_keys).items():
        t, i, a = (int(c) for c in re.findall(r"\d", k)[:3])
        print(f"  rollout_kernel<{('hover', 'waypoint', 'racing')[t]}, "
              f"{('euler', 'rk4')[i]}, "
              f"{('in-kernel', 'provided')[a]} actions>: {regs} registers; "
              f"{spill}", flush=True)
    k1_instr, k1_left_out = k1_instructions()
    print(f"  K1's probes (arithmetic SASS instructions beyond the set-up, "
          f"int32 ones beside them): {k1_instr}; left out of the bound: "
          f"{k1_left_out}", flush=True)
    no_mma = [k for k in smem if not k.startswith("pack_") and not mma.get(k)]
    if no_mma:
        failed.append(f"no HMMA instruction in {no_mma}")
        print(f"FAILED: no HMMA instruction in {no_mma}", flush=True)
    bf16_failures = bf16_build_report(libs)
    if bf16_failures:
        failed.append(f"bf16 arms: {bf16_failures}")
        print(f"FAILED: bf16 arms that are not what they say: "
              f"{bf16_failures}", flush=True)
    lap("build")

    k1_err = phase_k1()
    lap("K1 check")
    k5_err = phase_k5()
    lap("K5 check")

    cfg_path = ROOT / "configs" / "hover.toml"
    cfg = Config.from_toml(cfg_path)
    n = cfg.train.num_envs
    statics, params = cfg.env.build()
    env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
    horizon = int(env.params.horizon) + 1

    # -- path 1: the env engine --------------------------------------------
    state = env.init_batch(cfg.run.seed, n)
    zero_counts()
    final, stats = rollout_cuda(state, env.params, env.statics, horizon)
    torch.cuda.synchronize()
    engine_counts = counts()
    print(f"env engine path: {n} lanes x {horizon} steps, episodes "
          f"{float(stats['episodes']):.0f}, reward_sum "
          f"{float(stats['reward_sum']):.6g}, launches {engine_counts}",
          flush=True)
    if engine_counts["K1"] < 1:
        raise AssertionError("the env-engine path did not launch K1")
    if not (torch.isfinite(final.fstate()).all()
            and all(torch.isfinite(v) for v in stats.values())):
        raise AssertionError("env-engine path produced non-finite values")

    lap("env engine path")
    # -- path 2: serving (evaluate + cli eval) --------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(0, seeded_policy(seed=1))
        cfg_eval = cfg.with_overrides([f"run.resume_from={tmp}"])
        zero_counts()
        t0 = time.time()
        res = evaluate(cfg_eval, episodes=n)
        t_eval = time.time() - t0
        rc = cli.main(["eval", str(cfg_path), f"run.resume_from={tmp}"])
        torch.cuda.synchronize()
        serve_counts = counts()
        t0 = time.time()
        evaluate(cfg_eval, episodes=n)
        t_eval_warm = time.time() - t0
        print(f"serving path: evaluate({n} episodes) {res} in {t_eval:.3f} s "
              f"(again: {t_eval_warm:.3f} s); cli eval rc={rc}; launches "
              f"{serve_counts}", flush=True)
        if serve_counts["K5"] < 2 or rc != 0:
            raise AssertionError("the serving path did not launch K5 twice")
        if not all(v == v and abs(v) != float("inf") for v in res.values()):
            raise AssertionError("evaluate returned non-finite stats")
        if res["episodes"] < n or not 1.0 <= res["ep_length_mean"] <= horizon:
            raise AssertionError(f"implausible evaluate stats {res}")

        # -- the card against the CPU on a small input ------------------------
        small_gpu = evaluate(cfg_eval, episodes=512, device="cuda")
        small_cpu = evaluate(cfg_eval, episodes=512, device="cpu")
        print(f"evaluate(512) card {small_gpu} cpu {small_cpu}", flush=True)
        if (abs(small_gpu["episodes"] - small_cpu["episodes"])
                > 0.01 * small_cpu["episodes"]
                or abs(small_gpu["ep_return_mean"] - small_cpu["ep_return_mean"])
                > 0.01 * abs(small_cpu["ep_return_mean"])):
            raise AssertionError("evaluate on the card disagrees with the CPU")

    lap("MLP serving path")
    # -- times at the paths' shapes --------------------------------------------
    lane_steps = n * horizon
    k1_ms = cuda_ms(lambda: cuda_rollout.rollout_kernel(
        state, env.params, env.statics, horizon), reps=10)
    # the plain versions' host-bound loops at 100 steps, scaled
    k1_plain_ms = host_ms(lambda d: cuda_rollout.rollout_plain(
        state, env.params, env.statics, d), 100, horizon)
    k1_ops = (lane_steps * (OPS_STEP + OPS_RANDOM_ACTIONS)
              + float(stats["episodes"]) * OPS_RESET)
    k1_bytes = n * (2 * 25 * 4 + 5 * 4)  # state in and out, stats out

    policy = seeded_policy(seed=1).cuda()
    state = env.init_batch(cfg.run.seed + 1, n)
    _, k5_lane = cuda_acting.act_rollout_kernel(state, policy, env.params,
                                                env.statics, horizon)
    k5_episodes = float(k5_lane[1].sum())
    k5_ms = cuda_ms(lambda: cuda_acting.act_rollout_kernel(
        state, policy, env.params, env.statics, horizon), reps=5)
    k5_plain_ms = host_ms(lambda d: cuda_acting.act_rollout_plain(
        state, policy, env.params, env.statics, d), 100, horizon)
    k5_ops = (lane_steps * (OPS_STEP + OPS_OBS + tower_ops((64, 64)))
              + k5_episodes * OPS_RESET)
    k5_bytes = n * (2 * 25 * 4 + 5 * 4) + 4 * (13 * 64 + 64 * 64 + 64 * 4
                                             + 64 + 64 + 4)

    k1_bound, k1_by, k1_total, k1_int = k1_instruction_bound(
        k1_instr, lane_steps, float(stats["episodes"]), k1_bytes)
    k5_mma = lane_steps * tower_mma_ops((64, 64))
    k5_bound, k5_by = tensor_bound(k5_mma, k5_ops - k5_mma, k5_bytes)
    print(f"K1 {n} x {horizon}: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} "
          f"ms, bound {k1_bound:.4f} ms (by {k1_by}: {k1_total:.4g} "
          f"arithmetic instructions, {k1_int:.4g} of them int32); the "
          f"operation count's bound {bound(k1_ops, k1_bytes)[0]:.4f} ms ({k1_ops:.4g} "
          f"ops at 67 TFLOP/s)", flush=True)
    print(f"K5 {n} x {horizon}: kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.1f} "
          f"ms, bound {k5_bound:.4f} ms tensor-pipe ({k5_mma:.4g} of "
          f"{k5_ops:.4g} ops on the tensor cores), fp32 bound "
          f"{bound(k5_ops, k5_bytes)[0]:.4f} ms", flush=True)
    lap("K1, K5 times")
    # -- the training slice: K2, K3, K4 and the training path ----------------
    k2_err = phase_k2()
    lap("K2 check")
    k3_err, k4_err, inputs = phase_k3_k4(cfg, env)
    lap("K3, K4 checks")
    with tempfile.TemporaryDirectory() as tmp:
        train_counts = path_training(cfg_path, tmp)
        lap("MLP training path")
        gate(phase_learning_and_resume, tmp)
        lap("MLP learning gate, resume")
    times = time_training(cfg, env, inputs)
    lap("K2-K4 times, MLP update")
    # -- the LSTM slice: K8, K6, K7 and the LSTM paths -----------------------
    k8_err = phase_k8()
    lap("K8 check")
    k6_err = phase_k6()
    lap("K6 check")
    cfg_lstm = cfg.with_overrides(list(LSTM_OVERRIDES))
    k7_err, k7_args, k4_lstm_err = phase_k7_k4(cfg_lstm, env)
    k7_err = max(k7_err, phase_k7_shapes(cfg_lstm, env))
    lap("K7, K4 checks")
    lstm_serve_counts = path_lstm_serving(
        cfg.with_overrides(["run.policy=lstm"]), cfg_path)
    lap("LSTM serving path")
    with tempfile.TemporaryDirectory() as tmp:
        lstm_train_counts, _ = path_lstm_training(cfg_path, tmp)
        lap("LSTM training path")
        gate(phase_lstm_learning_and_resume, tmp)
        lap("LSTM learning gate, resume")
    lstm_times = time_lstm(cfg_lstm, env, k7_args)
    lap("K8, K6, K7 times, LSTM update")
    # -- the CNN slice: K11, K9, K10 and the CNN paths -----------------------
    k11_err = phase_k11()
    lap("K11 check")
    k9_err = phase_k9()
    lap("K9 check")
    cfg_cnn = cfg.with_overrides(list(CNN_OVERRIDES))
    k10_err, k10_args, k4_cnn_err = phase_k10_k4(cfg_cnn, env)
    lap("K10, K4 checks")
    cnn_serve_counts = path_cnn_serving(
        cfg.with_overrides(["run.policy=cnn"]), cfg_path)
    lap("CNN serving path")
    with tempfile.TemporaryDirectory() as tmp:
        cnn_train_counts = path_cnn_training(cfg_path, tmp)
        lap("CNN training path")
        gate(phase_cnn_learning_and_resume, tmp)
        lap("CNN learning gate, resume")
    cnn_times = time_cnn(cfg_cnn, env, k10_args)
    lap("K11, K9, K10 times, CNN update")
    # -- F5, and the pixel-recurrent slice: the CNN arms of K8, K6, K7 -----
    phase_f5(cfg_path)
    lap("F5")
    from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH

    k8c_err = phase_k8([
        ("hover", "euler", 128, KERNEL_ARCH, 65536, ((3, 2), (64, 40))),
        ("waypoint", "rk4", 128, KERNEL_ARCH, 8192 + 40, ((3, 2),)),
        ("hover", "euler", 36, KERNEL_ARCH, 4096 + 36, ((3, 2),))],
        name="K8 cnn arm")
    lap("K8 cnn check")
    k6c_err = phase_k6(cnn_lstm_policy(), name="K6 cnn arm")
    lap("K6 cnn check")
    cfg_cl = cfg.with_overrides(list(CNN_LSTM_OVERRIDES))
    # the CNN's critic noise (phase 21) until every branch is taken
    k7c_err, k7c_args, k4_cl_err = phase_k7_k4(cfg_cl, env, cnn_lstm_policy(),
                                    critic_scales=(2.0, 16.0, 64.0, 256.0))
    lap("K7 cnn, K4 checks")
    cl_serve_counts = path_lstm_serving(
        cfg.with_overrides(["run.policy=cnn_lstm"]), cfg_path,
        cnn_lstm_policy(seed=2, log_std=0.0))
    lap("cnn_lstm serving path")
    with tempfile.TemporaryDirectory() as tmp:
        cl_train_counts, _ = path_lstm_training(cfg_path, tmp,
                                                CNN_LSTM_OVERRIDES)
        lap("cnn_lstm training path")
        gate(phase_cnn_lstm_learning_and_resume, tmp)
        lap("cnn_lstm learning gate, resume")
    cl_times = time_lstm(cfg_cl, env, k7c_args,
                         cnn_lstm_policy(seed=2, log_std=0.0),
                         plain_depths=(10, 16))
    lap("K8, K6, K7 cnn times, cnn_lstm update")
    # -- the scan trainers, the hybrid tier and K4's wider envelope -------
    k4_wide_err = phase_k4_wide(cfg)
    lap("K4 wide check, parent digests")
    scan_err = phase_scan_vs_cpu()
    lap("scan updates, card against CPU")
    with tempfile.TemporaryDirectory() as tmp:
        scan_counts = path_scan_training(cfg_path, tmp)
        lap("scan, cnn_overlap and hybrid paths")
        phase_scan_resume(tmp)
        lap("scan resume, across trainers")
    scan_times = split_scan_update(cfg)
    lap("scan update split")
    gate(phase_trainer_equivalence, None)
    lap("trainer equivalence gate")
    print(f"scan slice: card against CPU within {scan_err:.3g} of each "
          f"tensor's max; path launches {scan_counts}; hover.toml scan "
          f"update {scan_times}", flush=True)
    bench_err = phase_bench_shapes(cfg, env)
    lap("bench shapes check")
    path_bench(cfg_path)
    lap("bench path")
    # -- the bf16 slice: the bf16 operand arms of K2, K3, K9 (K11) and K10,
    # bfloat16 training and run.profile_dir --------------------------------
    k2b_err = phase_k2_bf16()
    lap("K2 bf16 check")
    k3b_err, k3b_inputs = phase_k3_bf16(cfg, env)
    lap("K3 bf16 check")
    k9b_err = phase_k9_bf16()
    lap("K9, K11 bf16 checks")
    k10b_err, k10b_args = phase_k10_bf16(cfg_cnn, env)
    lap("K10 bf16 check")
    with tempfile.TemporaryDirectory() as tmp:
        bf16_counts = path_bf16_training(cfg_path, tmp)
        lap("bf16 MLP and CNN paths")
        gate(phase_bf16_learning_and_resume, tmp)
        lap("bf16 learning gates, resume")
        bf16_times = time_bf16(cfg, env, k3b_inputs, k10b_args)
        lap("bf16 times, updates")
        path_profile(cfg_path, tmp)
        lap("profile path")
    # -- the bf16 recurrent slice: K7's bf16 arm, both encoders -----------
    k7b_err, k7b_args = phase_k7_bf16(cfg_lstm, env)
    lap("K7 bf16 check")
    k7bc_err, k7bc_args = phase_k7_bf16(cfg_cl, env, cnn_lstm_policy(),
                                        critic_scales=(2.0, 16.0, 64.0,
                                                       256.0))
    lap("K7 bf16 cnn check")
    with tempfile.TemporaryDirectory() as tmp:
        bf16_rnn_counts = path_bf16_lstm_training(cfg_path, tmp)
        lap("bf16 lstm and cnn_lstm paths")
        gate(phase_bf16_lstm_learning_and_resume, tmp)
        lap("bf16 recurrent learning gates, resume")
    bf16_rnn_times = time_bf16_lstm(cfg_lstm, cfg_cl, k7b_args, k7bc_args)
    lap("K7 bf16 times, updates")
    # -- the env adapters, the C-runtime export, racing through cli train --
    adapters = phase_adapters()
    lap("adapters, card against CPU")
    native = build_native()
    with tempfile.TemporaryDirectory() as tmp:
        phase_export_c(tmp, native)
        lap("export against the C runtime")
        path_racing(tmp, native)
        lap("racing cli train, export, C demo")
    # -- the outer surfaces (sweep, autotune, watch), then distribution ---
    with tempfile.TemporaryDirectory() as tmp:
        swept = path_sweep(tmp)
        lap("sweep path")
        tuned = path_autotune()
        lap("autotune path")
        watched = phase_watch(tmp)
        lap("watch rollouts")
    one = phase_world_of_one(free_port())
    lap("world of 1 over NCCL, sharded K1 and K5")
    with tempfile.TemporaryDirectory() as tmp:
        gloo = phase_gloo_ranks(tmp)
    lap("two Gloo ranks on the card")
    # the new paths' launches, added to each kernel's count below
    extra = collections.Counter(swept["counts"])
    extra.update(tuned["counts"])
    for c in one["counts"].values():
        extra.update(c)
    extra.update(gloo["counts"])
    best = tuned["results"][0]
    print(f"VecDrone steps/s at {SPS_LANES} lanes: "
          f"{adapters['steps_per_s']:.6g} ({dev})", flush=True)
    print(f"sweep: {swept['updates']} updates in {swept['sweep_s']:.1f} s, "
          f"{swept['samples'] / swept['sweep_s']:.6g} "
          f"samples/s end to end ({dev})", flush=True)
    print(f"autotune: best {best['overrides']} {best['sps']:.6g} samples/s, "
          f"{len(tuned['results'])} candidates in {tuned['seconds']:.1f} s "
          f"({dev})", flush=True)
    print(f"watch seconds {watched}; world of 1 {one['seconds']:.1f} s; two "
          f"Gloo ranks {gloo['seconds']:.1f} s", flush=True)
    print(f"phase seconds: {lap.seconds}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms,
              bound_ms, bound_by, library_ms, notes=None):
        # notes (the fp32 bound beside the tensor-pipe one, the L2 and
        # scratch bytes) are counts, not measurements: they stay on the
        # kernel's own line above
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    kernels = [
        entry("K1 env rollout", "drone_tpu_torch/csrc/rollout.cu",
              "drone_tpu/ops/pallas_rollout.py:460",
              engine_counts["K1"] + extra["K1"],
              max(k1_err, bench_err["K1"]), k1_ms, k1_plain_ms, k1_bound,
              "bytes" if k1_by == "bytes" else "operations", None),
        entry("K2 trajectory rollout",
              "drone_tpu_torch/csrc/acting_traj.cu",
              "drone_tpu/ops/pallas_acting_traj.py:120",
              train_counts["K2"] + extra["K2"],
              max(k2_err, bench_err["K2"]), *times["K2"]),
        entry("K3 PPO update", "drone_tpu_torch/csrc/update.cu",
              "drone_tpu/ops/pallas_update.py:206",
              train_counts["K3"] + extra["K3"],
              max(k3_err, bench_err["K3"]), *times["K3"]),
        entry("K4 fused clip+adam", "drone_tpu_torch/csrc/update.cu",
              "drone_tpu/ops/pallas_update.py:456",
              train_counts["K4"] + extra["K4"],
              max(k4_err, k4_lstm_err, k4_cnn_err, k4_cl_err, k4_wide_err,
                  bench_err["K4"]), *times["K4"]),
        entry("K5 MLP acting", "drone_tpu_torch/csrc/acting.cu",
              "drone_tpu/ops/pallas_acting.py:109",
              serve_counts["K5"] + extra["K5"],
              max(k5_err, bench_err["K5"]), k5_ms, k5_plain_ms, k5_bound,
              k5_by, None),
        entry("K6 LSTM trajectory rollout",
              "drone_tpu_torch/csrc/acting_lstm.cu",
              "drone_tpu/ops/pallas_acting_lstm.py:335",
              lstm_train_counts["K6"] + extra["K6"], k6_err,
              *lstm_times["K6"]),
        entry("K7 LSTM truncated-BPTT update",
              "drone_tpu_torch/csrc/update_lstm.cu",
              "drone_tpu/ops/pallas_update_lstm.py:270",
              lstm_train_counts["K7"] + extra["K7"], k7_err,
              *lstm_times["K7"]),
        entry("K8 LSTM acting", "drone_tpu_torch/csrc/acting_lstm.cu",
              "drone_tpu/ops/pallas_acting_lstm.py:186",
              lstm_serve_counts["K8"], max(k8_err, bench_err["K8"]),
              *lstm_times["K8"]),
        entry("K9 CNN trajectory rollout",
              "drone_tpu_torch/csrc/acting_cnn.cu",
              "drone_tpu/ops/pallas_acting_cnn.py:271",
              cnn_train_counts["K9"] + extra["K9"], k9_err,
              *cnn_times["K9"]),
        entry("K10 CNN PPO update", "drone_tpu_torch/csrc/update_cnn.cu",
              "drone_tpu/ops/pallas_update_cnn.py:151",
              cnn_train_counts["K10"] + extra["K10"], k10_err,
              *cnn_times["K10"]),
        entry("K11 CNN acting", "drone_tpu_torch/csrc/acting_cnn.cu",
              "drone_tpu/ops/pallas_acting_cnn.py:434",
              cnn_serve_counts["K11"], max(k11_err, bench_err["K11"]),
              *cnn_times["K11"]),
        entry("K6 LSTM trajectory rollout, CNN-encoder arm",
              "drone_tpu_torch/csrc/acting_lstm.cu",
              "drone_tpu/ops/pallas_acting_lstm.py:335",
              cl_train_counts["K6 cnn"], k6c_err, *cl_times["K6"]),
        entry("K7 LSTM truncated-BPTT update, CNN-encoder arm",
              "drone_tpu_torch/csrc/update_lstm.cu",
              "drone_tpu/ops/pallas_update_lstm.py:270",
              cl_train_counts["K7 cnn"], k7c_err, *cl_times["K7"]),
        entry("K8 LSTM acting, CNN-encoder arm",
              "drone_tpu_torch/csrc/acting_lstm.cu",
              "drone_tpu/ops/pallas_acting_lstm.py:186",
              cl_serve_counts["K8 cnn"], max(k8c_err, bench_err["K8 cnn"]),
              *cl_times["K8"]),
        entry("K2 trajectory rollout, bf16 arm",
              "drone_tpu_torch/csrc/acting_traj.cu",
              "drone_tpu/ops/pallas_acting_traj.py:120",
              bf16_counts["mlp"]["K2 bf16"], k2b_err, *bf16_times["K2"]),
        entry("K3 PPO update, bf16 arm", "drone_tpu_torch/csrc/update.cu",
              "drone_tpu/ops/pallas_update.py:206",
              bf16_counts["mlp"]["K3 bf16"], k3b_err, *bf16_times["K3"]),
        entry("K9 CNN trajectory rollout, bf16 arm",
              "drone_tpu_torch/csrc/acting_cnn.cu",
              "drone_tpu/ops/pallas_acting_cnn.py:271",
              bf16_counts["cnn"]["K9 bf16"], k9b_err, *bf16_times["K9"]),
        entry("K10 CNN PPO update, bf16 arm",
              "drone_tpu_torch/csrc/update_cnn.cu",
              "drone_tpu/ops/pallas_update_cnn.py:151",
              bf16_counts["cnn"]["K10 bf16"], k10b_err, *bf16_times["K10"]),
        entry("K7 LSTM truncated-BPTT update, bf16 arm",
              "drone_tpu_torch/csrc/update_lstm.cu",
              "drone_tpu/ops/pallas_update_lstm.py:270",
              bf16_rnn_counts["lstm"]["K7 bf16"], k7b_err,
              *bf16_rnn_times["K7"]),
        entry("K7 LSTM truncated-BPTT update, CNN-encoder bf16 arm",
              "drone_tpu_torch/csrc/update_lstm.cu",
              "drone_tpu/ops/pallas_update_lstm.py:270",
              bf16_rnn_counts["cnn_lstm"]["K7 bf16"], k7bc_err,
              *bf16_rnn_times["K7 cnn"]),
    ]
    print(dev, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if failed:
        print(f"chip_smoke: failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
