#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hilo_mpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  card name and power limit; build every CUDA kernel from the
         sources in csrc/ (one nvcc per source, all started together): the
         tiled Riccati template for each (nx, nu) that phase 1 checks (phase
         11's (3, 1), (3, 3) and (3, 2) and phase 12's (1, 1) among them), the
         wide Riccati variant for phase 1's and phase 4's larger sizes, the
         FGM kernel, and the whole-solve interior point for the flagship
         problem and phase 1's three other row patterns (the soft-box problem
         of golden softcon_active among them, also phase 6's second
         controller) and for phase 11(a)'s Δu problem, whose cost has an
         x-u cross block (the CROSS build, its registers and spills
         printed), generated from the model (ops/codegen_cuda.py); its
         build time, registers, stack and spills (none in the Riccati builds
         but the tiled cap (8, 4), which only phase 1 runs; the flagship
         whole-solve builds held to the registers per thread they had before
         the emitted Hessians took the point, 104 in float32 with no spill
         and 191 in float64), each Riccati instance's tiles (TB, KC) or warps per
         scenario (the wide variant's group, also every group size phase
         1 times) and shared memory, each whole-solve
         build's tiles (TB, MINB, the region per scenario in a global
         scratch, no shared memory), and the FGM kernel's cluster design
         (blocks per cluster, scenarios per tile, rows and shared memory
         per block, threads) for each n phase 1 checks above 128; the FGM
         register design (csrc/fgm_boxqp_reg.cuh) for each n up to 64 that
         phases 1 and 4 run or time, with its registers, spills (none where
         the router takes it) and blocks per SM; the FGM tensor-core design
         (csrc/fgm_boxqp_tc.cuh) for each n padded to 8 that phases 1 and 4
         run or time (8..128), with its registers, spills (none asserted),
         warps, shared memory, blocks per SM and the tensor-core
         instructions of its SASS (cuobjdump -sass: HGMMA TF32); the
         whole-solve kernel on
         the traced problems of phases 1, 11(b) and 14 (ops/codegen_fx.py:
         the msd, golden pathfollow_soft's controller, the CSTR with a
         generic cost and a measurement term, the flagship, phase 15's
         hybrid physics + ANN problems and phase 16's GP hybrid), each
         build's registers and spills printed; the whole-solve kernel with
         an implicit step (csrc/implicit.cuh: phases 1 and 12(a)'s
         collocation flagship from the DSL, 12(b)'s golden dae_colloc
         model traced), registers and spills printed; the Riccati
         instances include phase 16's (6, 1) (the SMPC surrogate); the
         whole-solve kernel's last problem classes, registers and spills
         printed: the chain of 8 masses (nx = 17: 36 candidate box rows per
         stage and 34 terminal, two 32-bit row words; DSL), the CSTR under
         Radau d=2 with a path parameter (traced, the path state emitted
         around the implicit step) and golden smpc_chance's SMPC without
         chance rows at N=20 (traced, the 25-point GP's variance solve
         emitted; the GP in float32, whose weights the float32 trace
         rounds, so the float64 controller's problem is a second build).
Phase 1  each kernel against its plain PyTorch version on the card, at the
         shapes the main paths give it (for the Riccati kernel also a ragged
         last tile and chunk, (8, 4) at N=64 and inputs whose data_ptr is not
         16-byte aligned; the wide variant at (9, 2), (16, 4), (16, 8) and
         its cap (32, 16) on a ragged batch; the FGM kernels up to n = 512,
         through all three designs, with and without u0 and with infinite
         bounds, the tensor-core design also against its emulation
         (ops/cuda_kernels.py:fgm_boxqp_tf32x3, printed); at the flagship FGM
         shape the two n <= 128 designs against each other too; the
         whole-solve kernel in four row patterns,
         soft state bounds among them, its CROSS build on phase 11(a)'s
         problem, its traced build on phase 14(a)'s msd (whole_ip_traced,
         with the build's registers and spills) and its implicit build on
         the collocation flagship (whole_ip_implicit, the same), and at
         N=20 the last problem classes (the same three builds as phase 0:
         whole_ip_wide_rows, whole_ip_path_implicit, whole_ip_smpc, each
         timed beside its operations bound and plain version (one call):
         on 1024 scenarios float64
         with equal iterations and U to 1e-12 (1e-9 for the traced builds,
         1e-10 for the chain, whose binding velocity bounds amplify
         rounding to ~2e-12), the float64 run launching the float32 build
         (its text and numbers) against the float64 controller's plain
         version at the float32 controller's bounds, and float32 within the
         float32 plain version's distance from float64 plus 5e-4; at
         B=131072 float32 the same, both dtypes timed
         there beside the operations bound), and each timed at the shape of its
         main path (the wide variant at phase 4's (16, 8), B=1024, float64
         and float32, at B=16384, and in every group size at (9, 2),
         (16, 8) and the cap in both dtypes; the FGM
         kernel's cluster design at phase 4's n = 160, B=1024 and
         B=131072; the register design and the tensor-core design against
         each other at n in FGM_CROSSOVER_NS, B=131072, which sets
         FGM_REG_MAX_N (the router's pick within FGM_ROUTER_SLACK of the
         faster back to back, in device time with every call queued
         before the first starts, asserted), the tensor-core design's own
         row at n = 64,
         named fgm_boxqp_resident as its first design was),
         beside the least time the card could take for the same work (the
         Riccati kernel in float32 and float64, with its share of the bound
         and the bytes/s it reaches; the tensor-core design's bound is its
         three TF32 passes at PEAK_TF32, its float32-SIMT bound printed
         beside). Each kernel is timed as one call alone,
         its enqueue included (the "ms" of the kernels line), and as calls
         back to back, where the enqueue hides behind the previous call
         ("back_to_back_ms"); the whole-solve kernel also through the NMPC
         controller's prepared path, and the share of its lane-iterations
         that finished lanes of a warp leave idle.
Phase 2  the NMPC path at full width: the flagship CSTR NMPC (N=20, RK4,
         box-bounded input, quadratic tracking cost) through
         NMPC.setup(device="cuda") -> prepare_batch -> solve_batch_fn, cold
         and warm-started, on B=131072 scenarios; the Riccati kernel's launch
         count is read around exactly this run. The first 1024 scenarios are
         solved again with the plain LQ step in place of the kernel and
         compared.
Phase 3  the golden closed-loop fixture tests/golden/cstr_tracking.npz
         replayed through NMPC.optimize in float64 on the card.
Phase 4  the linear-MPC path at full width: a discrete double integrator
         (N=20, |u| <= 1) through Model(discrete=True).set_state_space ->
         LMPC.setup(device="cuda") -> optimize_batch_fgm on B=131072
         scenarios (the FGM kernel's launch count is read around exactly
         this run); the first 1024 scenarios again through the interior point
         (LMPC.optimize_batch, the Riccati kernel) and compared; the
         infinite-horizon LQR of the same model against SciPy's DARE. Then a
         second linear model: eight decoupled double integrators (nx=16,
         nu=8, N=20, |u| <= 1, P = Q), B=1024, whose interior point runs
         through the wide Riccati variant and whose FGM path (n = 160, at
         B=131072 with the plain comparison on its first 1024 scenarios)
         through the FGM kernel's cluster design, each against its plain
         counterpart and the two against each other. A third: four
         double integrators over 16 stages, whose FGM path (n = 64,
         B=131072) runs the tensor-core design, and a fourth, the first
         integrator over 16 stages (n = 16, B=131072), the register design
         (the flagship's own n = 20 now goes to the tensor cores). For each
         model the FGM call's wall is split into the copies (x0 in, cast to float32
         on the host and copied once; u out), the kernel and the rest, the
         rest by part (configuration key, checks, allocation, device
         context, the ctypes launch).
Phase 5  the golden fixture tests/golden/lmpc_di.npz replayed through
         LMPC.optimize in float64 on the card.
Phase 6  the whole-solve path at full width: the flagship NMPC with
         pallas_full=True through solve_batch_fn, cold and warm, on phase 2's
         B=131072 inputs; the whole-solve kernel's and the Riccati kernel's
         launch counts are read around exactly this run, and U is held
         against phase 2's on the jointly converged scenarios; the idle-lane
         share of the cold and the warm solve, and the kernel's share of
         the cold call. Then the soft-box controller of golden
         softcon_active (soft x_1 <= 0.27, w = 500, |u| <= 5) at the same
         options and inputs through both routes, the whole-solve kernel and
         the general path, each converged on >= 0.97, U held between them.

Phase 7  the MHE path at full width: the CSTR with the weights of the repo's
         own MHE check (tools/tpu_validation.py:165-180: horizon 10,
         Q = 1e-4, R = 1e-3, P0 = 0.1·I, p = ones(6), dt 0.1, default
         options, so the fast path) through
         MovingHorizonEstimator.setup(device="cuda") -> estimate_batch on
         B=131072 windows made from numpy RK4 plant runs (x_2 measured with
         noise, 11 rows), float32: one warm-up, the best of 3; windows/s,
         converged fraction, iterations, the RMS of x_est against the
         simulated state. Every Newton step is one launch of the Riccati
         kernel in its free-x0 mode (launches = iterations, read around one
         run), and the plain backward sweep runs 0 times; the first 1024
         windows again with the plain LQ step, compared. Then eight decoupled
         double integrators measured in position (nx = nu = 16), B=1024,
         float64: the wide variant's free-x0 mode, counted the same way.
Phase 8  the golden fixture tests/golden/mhe_cstr.npz replayed through
         MovingHorizonEstimator.estimate in float64 on the card.
Phase 9  the filters on the card, float64: EKF and UKF on the CSTR over the
         golden fixture's measurements, x and P at every step against the
         same filter on the CPU; the particle filter (4096 particles), its
         draw-explicit step fed draws made on the CPU, against the CPU.
Phase 10 the constrained general path: (a) the repo's own check
         tools/tpu_validation.py:55-80 at B=131072, float32: a mass-spring-
         damper (a model given as callables), N=20, NMPC defaults, soft
         |pos| <= 1, the hard stage row pos + 0.2 vel <= 1.05, x0 =
         0.2·N(0,1) from default_rng(1); converged >= 0.99, every Newton
         step one Riccati kernel launch and no plain sweep, the first 1024
         scenarios against the plain LQ step, solves/s, and one profiled cold
         solve (device busy time, idle share, launches per iteration);
         (b) the CSTR with the terminal equality x_N[0] = 0.3 (the augmented
         Lagrangian), N=15, B_CPU_CHECK scenarios, float64 on the card against the
         CPU, and float32 reported; (c) the golden fixture
         tests/golden/softcon_active.npz (its first GOLDEN_CARD_STEPS steps,
         as every golden of phases 11, 12, 15 and 16) replayed through NMPC.optimize in
         float64 on the card.
Phase 11 the augmented formulations: (a) phase 2's controller with golden
         du_tracking's input-change term (0.5) and Δu bounds ±0.5, the
         solver state (x, u_prev), u_prev = 0.5·N(0,1) clipped to ±5 from
         default_rng(2) through prepare_batch(u_prev=), B=131072, float32,
         cold and warm through the general path (the Riccati kernel at
         (3, 1)) and through pallas_full (the whole-solve kernel's CROSS
         build, 2 launches, no Riccati launch); solves/s, converged
         fraction, iterations, launches; max|U_whole − U_general| on the
         jointly converged, held to the general path's stray from its
         float64 answer plus 5e-4 (float32's stopping rule, phase 1); the
         first 1024 against the plain LQ step (float64 to 1e-9). (b) golden pathfollow_soft's controller (torch callables,
         max_iter 80) at B=131072, float32, x0 = 0.1·N(0,1) from
         default_rng(3): the Riccati kernel at (3, 3) under Mehrotra and
         convexify (launches = Newton steps, no plain sweep), the first 1024
         in float64 against the plain LQ step; under pure Newton steps
         pallas_full takes the whole-solve kernel (the traced route): no
         warning, one launch, no Riccati launch; then path following under
         Radau collocation d=2 (the flagship CSTR, create_path_variable(0,
         2, speed_ref=1, speed_weight=1), pure Newton) at B=B_LAST
         (8192) through both routes (phase 14's two_routes). (c) golden mintime's controller at
         B=4096, float64, x0 = [-1, 0] + [0.25, 0.15]·N(0,1) from
         default_rng(11): the converged fraction and the optimal dt range,
         the first B_CPU_CHECK against the CPU (equal iterations, <= 1e-9).
         (d) goldens du_tracking, pathfollow_soft and mintime replayed in
         float64 on the card (< 1e-4).
Phase 12 implicit integration (Newton-solved collocation and DAE stages on
         the general path, every Newton step of the interior point one
         Riccati kernel launch): (a) phase 2's flagship with Radau
         collocation of degree 3 (8 Newton steps per integrator step),
         B=131072, float32, cold and warm: solves/s, converged >= 0.97,
         iterations, Riccati launches = Newton steps and 0 plain sweeps, the
         wall by part and one profiled cold solve; max|U_colloc - U_rk4| on
         the jointly converged, held to the RK4 path's float32 stray from
         float64 + 1e-4; the first 1024 in float64 on the card against the
         CPU (equal iterations, <= 1e-9); then through pallas_full: the
         whole-solve kernel with the emitted collocation step (its Newton
         in the kernel, csrc/implicit.cuh), cold and warm, one launch per
         solve and no Riccati launch, solves/s, converged >= 0.97,
         iterations; U against the general path within the general path's
         float32 stray from float64 + 5e-4; the first 1024 through the
         float64 build against its plain version (equal iterations, <=
         1e-9). (b) golden dae_colloc's controller (a DAE model given as
         callables, N=12, Radau d=3, the NMPC defaults) at B_DAE_DEFAULTS, x0 =
         0.1 + 0.2·N(0,1) from default_rng(4), float32 at float32's tol
         1e-4 (the golden's 1e-9 is out of float32's reach), the Riccati
         kernel at (1, 1): converged >= 0.97, launches = Newton steps (2 per
         iteration under Mehrotra); the first B_CPU_CHECK at the golden's options in
         float64, card against CPU (<= 1e-9, equal iterations); the golden
         replayed in float64 on the card (< 1e-4); its model at
         FLAGSHIP's pure-Newton options through pallas_full (the traced
         build: the model's ode and alg traced into the emitted step) and
         the general path, as (a). (c) Seborg's CSTR
         (tests/test_library.py:24-30's parameters, dt 0.05, Radau d=3) as a
         fleet: 20 steps at T_cr = 300 from x0 = [0.5, 350, 300] + [0.05, 2,
         2]·N(0,1) (default_rng(5)), B=131072, float32, rollouts/s and the
         share of rollouts that stay bounded (>= 0.97; the rest are starts
         whose fixed Newton steps diverge at the ignition, as in the JAX
         package); the first 1024 in float64 on the card against the CPU
         on the rollouts bounded in both: per state <= 1e-9, or the CPU's
         own change from x0 moved by one ulp where that is larger, as it is
         for T near the ignition); a DAE with a quadrature, card against
         CPU. (d)
         EKF, UKF and PF on the DAE model, card against CPU in float64 at
         phase 9's bars.
Phase 13 the closed loop and the real-time entry points (each step of a
         loop one batched solve of all scenarios, every Newton step one
         Riccati kernel launch; launches read around each path and listed
         under phase13 keys in the kernels line): (a)
         parallel/closed_loop.py:fused_closed_loop_fn on the flagship
         controller and the CSTR plant, B=131072, 20 steps, float32: wall,
         scenario-steps/s, Riccati launches (= the sum over steps of each
         step's slowest iterations), converged share > 0.95, final
         |x - x_eq| < 3e-2 (tests/test_parallel.py's bar); the first 256 in
         float64 card against CPU (<= 1e-9, equal per-step iterations).
         (b) batched RTI (rti_prepare_batch / rti_feedback_batch) on the same
         fleet, warm, 20 steps: prepare ms (solve and gain), the gain alone,
         feedback ms, launches; the same loop with rti_gn_iterations=1 (one
         launch per prepare); the first 256 in float64 card against CPU,
         both modes. (c) fused_closed_loop_mhe_fn with phase 7's MHE
         (windows of mhe_cstr_windows, seed 6), B=32768, 10 steps: the
         window solves' free-x0 launches (= the sum over steps of each
         step's slowest window iterations; no wide launch, no plain sweep)
         beside the controller's, converged
         shares, the estimate's error; 64 scenarios card against CPU in
         float64. (d) fused_closed_loop_ekf_fn, B=131072, 20 steps,
         measurement noise 0.005 from a seeded CUDA generator: p99 final
         error < 3e-2 and estimate error < 2e-2 (the JAX test's bars, at
         the 99th percentile of the fleet), the same seed twice the same
         bits. (e) the flagship with E time-varying (a seeded table of 40,
         step 7), B=131072: the general path (Riccati kernel) and pallas_full
         (one whole-solve launch; the emitted problem reads p per stage),
         the kernel against its plain version and the two routes within 5e-4
         on the jointly converged. (f) parallel_riccati (log-depth scans,
         plain PyTorch: no Riccati launch, as the JAX solver bypasses its
         Pallas kernel) and bf16 storage of the linearization, each at
         B=131072 float32 beside the kernel route, card against CPU; the
         LQ step alone, the scans against the kernel route, at N = 20, 200,
         2000 for one scenario and for B·N = 131072·20.

Phase 14 the whole-solve kernel on traced problems (ops/codegen_fx.py: the
         problem functions traced with make_fx and written as C++, the
         costs' derivatives by nested dual numbers, csrc/traced.cuh), each at
         B=131072, float32, through pallas_full (exactly one whole-solve
         launch, no Riccati launch, no warning) and through the general path
         (the Riccati kernel): solves/s of both, converged >= 0.97, U within
         the general path's float32 stray from its float64 answer + 5e-4 on
         the jointly converged, the first 1024 through the kernel against its
         plain version (float64 equal iterations, 1e-9; float32 5e-4): (a)
         phase 10(a)'s msd as a callable with its soft |pos| <= 1, without
         the hard row, pure Newton options, x0 = 0.2·N(0,1) from
         default_rng(1); (b) golden pathfollow_soft's controller under pure
         Newton steps, x0 = 0.1·N(0,1) from default_rng(3), then the golden's
         25 steps replayed with every solve through the kernel's float64
         instance (WholeIPLaunch; max|u - u_gold| < 1e-4, 25 launches); (c)
         the flagship with a generic stage cost (x_1 - 0.3)^4 and a terminal
         measurement term; (d) the flagship written by both emitters
         (ops/codegen_cuda.py and the trace): equal iterations and U within
         1e-5 in float32, each build's kernel ms, registers and spills.

Phase 15 discrete inputs and the first half of machine learning (no
         kernel added): (a) phase 2's controller with E the output of golden
         hybrid_ann's frozen 2-8-1 tanh network (its weights rebuilt here from
         default_rng(42)), B=131072, float32, through the general path (the
         Riccati kernel) and pallas_full (the traced whole-solve kernel, the
         network emitted as C++), cold and warm: solves/s, converged >= 0.97,
         iterations, each kernel's launches (2 whole-solve, 0 Riccati on the
         kernel route), the routes within the general path's float32 stray
         + 5e-4, the kernel against its plain version on 1024 scenarios,
         kernel ms beside its bound, registers and spills; (b) the same with
         a 2-16-16-1 network: the traced build's kernel ms, bound, operations,
         registers and spills against (a)'s; (c) golden hybrid_ann (N=15,
         float64) replayed on the card through the general path (< 1e-4; the
         CPU's replay within 1e-9) and through the whole-solve kernel's
         float64 instance (< 1e-4, one launch per step); (d)
         tests/test_minlp.py's double integrator with u in {-1, 0, 1} (N=12,
         float64), a 25-step loop through optimize: ms per step (relaxed
         solve, the candidate batch: one solve_ocp of all 44 candidates on
         the Riccati kernel), candidates, feasible, mi_gap, Riccati launches
         per step; every move on a level and the final state within 1e-4 of
         [1, 0]; card against CPU the same picks and moves (1e-9); the exact
         mode at N=5 (243 candidates); (e) learned MPC: the teacher
         (optimize_batch of 65,536 CSTR states around the equilibrium, N=10,
         float32), a 2-32-32-1 tanh student trained on the card (batch 1024,
         50 epochs; epochs/s, median imitation error on 1,024 held-out
         states < 0.05), the student as a 40-step SimpleControlLoop policy
         (final error < 0.02), and predict at B=131072 (policies/s beside the
         teacher's solves/s).
Phase 16 Gaussian processes and stochastic MPC (no kernel added): (a)
         golden smpc_chance's SMPC (the 2-state model, its 25-point exact GP
         of a disturbance on x2 from x1, N=10, x1 <= 0.9 at level 0.95, |u|
         <= 2; the surrogate over [mu; vec(P)] has nx = 6) at B=B_SMPC,
         float32 (tol 1e-4; the GP, set up in float64, predicts in float64),
         x0 = [0.3, 0] + [0.2, 0.1]·N(0,1) from default_rng(16) with P0 =
         1e-4·I, cold and warm through the Riccati kernel at (6, 1):
         solves/s, converged >= 0.97, iterations, launches; the (6, 1)
         kernel against its plain version on this path's first LQ step
         (B=4096); B=512 in float64 (tol 1e-9) card against CPU (U to 1e-9
         where the iterations agree, >= 0.95 of them); the same SMPC
         without its chance row (N=20, its GP in float32, pure Newton) at
         B=B_LAST_SMPC (4096) through both routes (two_routes: the whole-solve kernel
         with the surrogate traced, the GP variance's triangular solve
         emitted). (b)
         examples/05_stochastic_smpc.py: its 30-point GP fitted on the card
         (L-BFGS-B) against the CPU's fit (float64, NLL to 1e-8 relative),
         then its feedback-gain SMPC (K = [1.0, 0.8], N=12, chance x1 <=
         0.85) through optimize_batch at B=B_SMPC, float32. (c) golden
         smpc_chance's first GOLDEN_CARD_STEPS steps replayed in float64 on
         the card (< 1e-4), its first
         SMPC_GOLDEN_CPU_STEPS steps on the CPU too (1e-9, equal iterations). (d) phase 2's
         controller with E a 16-point exact SE GP's posterior mean, both
         routes as phase 15(a) (the GP mean emitted as C++ by the trace).
         (e) exact predict at 131,072 queries card against CPU (float64,
         1e-10); GPArray.fit_model_batched (L-BFGS, 4 outputs x 256 points,
         50 iterations, float64) card against CPU (final NLLs to 1e-8
         relative); an SVGP minibatch Adam fit (4096 points, 32 inducing,
         batches of 256, 200 steps) on the card: time and ELBO.

Phase 17 dense programs, batches over devices and processes, the embedded
         export (no kernel added): (a) ops/programs.py on the card in
         float64: the constrained program of tests/test_programs_data.py:
         26-38 shifted by p (min |x - p|^2, x0 + x1 >= 1, |x| <= 5) at
         B=131072 values of p from default_rng(17), and a dense QP (n = 64,
         m = 32 rows A x <= 1, |x| <= 1; H SPD and A shared, c per program,
         default_rng(17)) at B=B_QP (cut from 8192: cuSOLVER's batched eigh
         takes the 64 x 64 matrices one at a time, timed here at B_QP x
         32, B_QP x 64 and 2·B_QP x 64); programs/s, converged >= 0.99,
         iterations; the first 256 of each card against CPU (the sweep:
         equal iterations, x to 1e-9; the QP at tol 1e-8: equal iterations
         on >= 0.95, x to 1e-6, its barrier systems' conditioning
         amplifying the two eigh's rounding, with the CPU against itself
         at c moved by 1e-15 logged beside; the QP at tol 1e-11: x to 1e-9,
         iterations equal on >= 0.9 and at most one apart); 16
         sweep programs against SciPy's SLSQP (1e-5). (b) parallel/: a
         mesh over the visible cards; phase 2's flagship and inputs through
         sharded_solve_fn(with_stats=True), in turns with the unsharded
         solve (U against phase 2's, equal bits on one card; the in-solve
         stats against convergence_stats; Riccati launches); phase 7's
         windows through estimate_batch(mesh=) against no mesh (free-x0
         launches); fused_closed_loop_fn on a sharded x0 (B=8192, 5 steps,
         __graft_entry__.py:163-192's controller), converged > 0.97; a
         world-size-1 NCCL group on a loopback TCP store (initialize,
         local_slice, global_batch, the all-reduced batch_stats and the
         all-gathered U against the host's), destroyed at the end. (c)
         embedded/: the CSTR NMPC (N=20) exported to C and compiled by the
         host's compiler, 12 steps against NMPC.optimize on the card in
         float64 (< 2e-4); the EKF (2e-5) and MHE (5e-4) exports against the
         port's filters on the card; PID, LQR and LMPC at
         tests/test_embedded.py's bars; the C and card times per step.
Phase 18 the host utilities (no kernel added; the Riccati kernels are
         registered operators): (a) Session(compilation_cache=) on a fresh
         directory: the flagship (2, 1) solve builds the Riccati library
         there (its nvcc time), a second build of the source is a hit (no
         nvcc), a corrupt library planted at (3, 1)'s path is rebuilt once by
         the build-cache guard and phase 11(a)'s Δu controller (3, 1) runs
         on the kernel (one read failure), and U equals the default
         directory's to the bit; (b) the registry: two flagship controllers
         at B=131072 float32 on the general path and two with pallas_full,
         one entry per configuration, U bitwise equal within each pair, the
         second controller's setup against the first's; (c) trace() around a
         cold+warm flagship pair: the Riccati kernel's __global__ name and
         its launches read from the trace (phase 2's 8), SolveTimer's stats
         over 5 warm solves; (d) export_model_step(batch=131072) on the card
         against the model's step, and export_nmpc_solver(flagship float64,
         batch=B_AOT) (its export time, the Riccati operator a node of the
         exported iteration), reloaded in a child process that builds no
         controller: max|ΔU| against the live solve_batch_fn, converged
         share. The kernels line's phase18_launches count the Riccati
         kernel's launches in (a)'s Δu solve, (c)'s pair and (d)'s live
         solve, and the child's in its two exported solves (max_iter each).
Phase 19 more than 32 box rows per stage: the chain of 8 masses on springs
         (tests/chain_model.py's copy: cubic stiffening, damping, a
         first-order actuator lag at the last mass; nx = 17, nu = 1, N=20,
         dt 0.5, |u| <= 1, |F| <= 1, v_5..v_8 >= -0.08, every mass pulled
         to -0.3) at B=B_LAST (8192), float32, through both routes (two_routes):
         solves/s, converged fraction, iterations, one whole-solve launch,
         U between routes within the general path's stray plus 5e-4.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result. Each phase prints its time, and the script its total, before
the kernels JSON object (the second-to-last line); the last line is
{"ok": true, "device": {...}}.
"""
import ctypes
import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN = 131072
N = 20
# the scenarios that phases 10(b), 11(c), 12(a) and 12(b) also solve on the
# host's CPU to hold the card against it
B_CPU_CHECK = 256
# the steps of each golden fixture that phases 10(c), 11(d), 12(b), 15(c)
# and 16(c) replay on the card: the first GOLDEN_CARD_STEPS (the CPU tests
# replay every step)
GOLDEN_CARD_STEPS = 10
# the SMPC batches of phase 16(a), (b)
B_SMPC = 32768


def golden_steps(data):
    """The golden fixture's steps that the card replays."""
    return min(GOLDEN_CARD_STEPS, data["U_gold"].shape[0])
GOLDEN = os.path.join(ROOT, "tests", "golden", "cstr_tracking.npz")
GOLDEN_LMPC = os.path.join(ROOT, "tests", "golden", "lmpc_di.npz")
GOLDEN_MHE = os.path.join(ROOT, "tests", "golden", "mhe_cstr.npz")
GOLDEN_SOFTCON = os.path.join(ROOT, "tests", "golden", "softcon_active.npz")
GOLDEN_DU = os.path.join(ROOT, "tests", "golden", "du_tracking.npz")
GOLDEN_PF = os.path.join(ROOT, "tests", "golden", "pathfollow_soft.npz")
GOLDEN_MT = os.path.join(ROOT, "tests", "golden", "mintime.npz")
GOLDEN_DAE = os.path.join(ROOT, "tests", "golden", "dae_colloc.npz")
GOLDEN_HYBRID = os.path.join(ROOT, "tests", "golden", "hybrid_ann.npz")
KERNELS = ("riccati_lq", "riccati_lq_wide", "fgm_boxqp", "fgm_boxqp_resident",
           "fgm_boxqp_column_blocks", "whole_ip", "riccati_lq_free_x0",
           "riccati_lq_wide_free_x0", "whole_ip_cross", "whole_ip_traced",
           "fgm_boxqp_registers", "whole_ip_implicit", "whole_ip_wide_rows",
           "whole_ip_path_implicit", "whole_ip_smpc")
# the tiled Riccati instances phase 1 checks; phase 11 runs (3, 1) (the
# Δu CSTR), (3, 3) (path following) and (3, 2) (minimum time), phase 16
# (6, 1) (the SMPC surrogate of a 2-state model)
RICCATI_SIZES = ((2, 1), (3, 2), (2, 3), (4, 1), (8, 4), (3, 1), (3, 3), (1, 1),
                 (6, 1))
# the free-x0 mode (MHE's nu = nx): the CSTR's (2, 2), with two estimated
# parameters (4, 2), the tiled cap (8, 4); the wide variant at (9, 9) and
# phase 7's (16, 16); phase 7's horizon and batches
RICCATI_FREE_SIZES = ((2, 2), (4, 2))
RICCATI_WIDE_FREE_SIZES = ((9, 9), (16, 16))
N_MHE = 10
# the wide variant: phase 1's sizes (phase 4's (16, 8) and the cap among
# them), phase 4's size, and the sizes timed in every group size
RICCATI_WIDE_SIZES = ((9, 2), (16, 4), (16, 8), (32, 16))
RICCATI_WIDE_PHASE4 = (16, 8)
RICCATI_WIDE_GROUP_SIZES = ((9, 2), (16, 8), (32, 16))
# phase 4's second model: eight decoupled double integrators; its interior
# point at B_WIDE, the wide variant also timed at the fleet shape B_FLEET
N_DI = 8
B_WIDE = 1024
B_FLEET = 16384
# the FGM sizes phase 1 checks above 128 (the cluster design) and up to 128
# (the register design up to FGM_REG_MAX_N, the tensor-core design above),
# the sizes at which it times the two n <= 128 designs against each other,
# and the size of the tensor-core design's own row in the kernels line
# (named fgm_boxqp_resident since its first design), which phase 4's third
# model reaches (four double integrators, N=16)
FGM_WIDE_NS = (129, 160, 256, 512)
FGM_NARROW_NS = (1, 6, 20, 24, 25, 32, 40, 64, 100, 128)
FGM_CROSSOVER_NS = tuple(range(1, 29)) + (32, 48, 64, 96, 128)
FGM_RESIDENT_N = 64
# phase 4's fourth linear model: the flagship integrator over this many
# stages (n = 16), whose FGM path the register design takes
N_REGISTERS = 16
# the router's pick must be the faster of the two n <= 128 designs back to
# back, or within this share of it. The router has one threshold: at
# n = 16, below it, the tensor-core design read 1.6-4.0% faster back to back
# in four runs (PERF.md §6), and at 19 the two lay 1.2-2.2% apart; one
# threshold off, at 20, the register design read 9.3-11% slower, which
# this share refuses. Both are device times (queued_time_ms): the register
# design makes more runtime calls per launch (the copy of H to constant
# memory, an event), and on a slow host its enqueue, not the card, set its
# back-to-back time at n = 16
FGM_ROUTER_SLACK = 0.06
# rounds in which the crossover times the two designs back to back
FGM_CROSSOVER_ROUNDS = 2
N_DI_RESIDENT = 4
N_RESIDENT = 16
# back-to-back timings run this many calls between two events, so the
# host's time to enqueue a call hides behind the previous one
INNER = 10
FGM_ITERS = 100
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, dense TF32 on them, float64, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps=10, warmup=3, inner=1):
    """Median device time of fn() over `reps` timed runs (CUDA events), each
    run `inner` calls back to back divided by `inner` (with inner=1 the
    host's time to enqueue the call is part of it)."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / inner)
    return float(np.median(ts))


def queued_time_ms(fn, reps=3, inner=INNER):
    """Median device time of fn() over `reps` runs of `inner` calls back to
    back, every call of a run enqueued before the first one starts: a sleep
    kernel holds the stream until then (doubled, and the run repeated, if
    the host had not enqueued them all by its end), so a slow host's
    enqueue is not part of it."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    ts, cycles = [], 20_000_000
    while len(ts) < reps:
        assert cycles <= 2 ** 31, "the host could not enqueue the calls within 1 s"
        torch.cuda._sleep(cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        queued = not e0.query()
        e1.record()
        torch.cuda.synchronize()
        if queued:
            ts.append(e0.elapsed_time(e1) / inner)
        else:
            cycles *= 2
    return float(np.median(ts))


def bound_ms(nbytes, flops, peak=PEAK_FP32):
    """Least time (ms) for the work on the card, and what bounds it: the
    larger of bytes over the memory rate and FLOPs over the peak of their
    type (float32 unless given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def riccati_lq_work(Bt, n, nx, nu, itemsize=4, free_x0=False):
    """(bytes, FLOPs) of one batched LQ solve: each input read once, each
    output written once; FLOPs of the backward sweep and the forward pass
    per stage, as the kernel computes them. With ``free_x0`` dx0 is not
    read, and each scenario factors P0 and solves for dx0 once."""
    per_stage_in = 2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu
    inputs = n * per_stage_in + nx * nx + (1 if free_x0 else 2) * nx
    outputs = (n + 1) * nx + n * (2 * nu + nx + nu * nx) + 1
    back = (2 * nx * nx + 2 * nx ** 3 + 2 * nx * nx * nu + 2 * nu * nu * nx
            + 2 * nu * nx * nx + 2 * nu * nx + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)
            + 2 * nx ** 3 + 2 * nx * nx * nu + 2 * nx * nx + 2 * nx * nu + 2 * nu)
    fwd = 2 * nu * nx + 2 * nx * nx + 2 * nx * nu + 2 * nx * nx
    arrival = nx ** 3 // 3 + 2 * nx * nx if free_x0 else 0
    return Bt * (inputs + outputs) * itemsize, Bt * (n * (back + fwd) + arrival)


def fgm_work(Bt, n, nx, iters, with_u0=False):
    """(bytes, FLOPs) of one batched FGM solve in float32: H, G, x0, lb, ub
    (and u0) read once, u written once; per scenario g = G x0 once, then per
    iteration H y (2n²) and the gradient step, clip and momentum (8n)."""
    nbytes = 4 * (n * n + n * nx + 2 * n + Bt * nx + Bt * n * (2 if with_u0 else 1))
    return nbytes, Bt * (2 * n * nx + iters * (2 * n * n + 8 * n))


def fgm_bound(Bt, n, nx, iters, design, with_u0=False):
    """(bound ms, what bounds it, float32-SIMT bound ms) of one batched FGM
    solve in `design`. The register and cluster designs run on float32
    FFMAs: fgm_work over PEAK_FP32, or the bytes. The tensor-core design
    runs the product H y as three TF32 passes (3xTF32): the larger of
    3·2n² per scenario-iteration at PEAK_TF32, the rest of the work (g and
    the 8n update) at PEAK_FP32 on other pipes, and the bytes; the
    float32-SIMT bound is returned beside it, so old and new read on one
    scale."""
    nbytes, flops = fgm_work(Bt, n, nx, iters, with_u0)
    simt_ms, simt_by = bound_ms(nbytes, flops)
    if design != "tensor":
        return simt_ms, simt_by, simt_ms
    t_tensor = 3 * 2 * n * n * Bt * iters / PEAK_TF32 * 1e3
    t_rest = Bt * (2 * n * nx + 8 * n * iters) / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    ms = max(t_tensor, t_rest, t_bytes)
    return ms, "bytes" if ms == t_bytes else "operations", simt_ms


def whole_ip_work(problem, dims, Bt, nt, iterations, itemsize=4):
    """(bytes, operations) of one whole-solve launch: theta, x0, X, U and the
    problem's numbers read once, the solution (X, U, lam, the active
    slacks and duals, mu, kkt, objective, iterations and two flags) written
    once; the operations of one iteration of one scenario, counted from the
    emitted code and the solver template (EmittedProblem.flops), times the
    iterations this run's scenarios took (the loop ends early)."""
    nx, nu, n = dims.nx, dims.nu, dims.N
    rows = len(problem.stage_rows) + len(problem.term_rows)
    inputs = (n + 1) * nt + nx + (n + 1) * nx + n * nu
    outputs = (n + 1) * nx + n * nu + n * nx + 2 * rows + 3
    nbytes = (Bt * (inputs + outputs) + problem.prm.size) * itemsize + Bt * (4 + 2)
    return nbytes, problem.flops * iterations


def lq_problem(Bt, n, nx, nu, dtype, seed=0, convex=False):
    """Random stagewise LQ problem (the generator of tests/test_pallas_kernels.py).
    ``convex`` scales each stage's S to spectral norm <= 0.5, so every stage
    cost (Q = I, R = 0.5·I) and P0 are positive definite, as the free-x0
    mode needs (tests/test_torch_riccati_free_x0.py:free_x0_problem)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((Bt, n, nx, nx))
    B = 0.3 * rng.standard_normal((Bt, n, nx, nu))
    Q = np.tile(np.eye(nx), (Bt, n, 1, 1))
    S = 0.1 * rng.standard_normal((Bt, n, nu, nx))
    if convex:
        norm = np.linalg.norm(S, ord=2, axis=(-2, -1))
        S = S * np.minimum(1.0, 0.5 / norm)[..., None, None]
    R = np.tile(0.5 * np.eye(nu), (Bt, n, 1, 1))
    q = rng.standard_normal((Bt, n, nx))
    r = rng.standard_normal((Bt, n, nu))
    c = 0.1 * rng.standard_normal((Bt, n, nx))
    Pt = np.tile(np.eye(nx), (Bt, 1, 1))
    pt = rng.standard_normal((Bt, nx))
    dx0 = rng.standard_normal((Bt, nx))
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
                 for a in (A, B, Q, S, R, q, r, c, Pt, pt, dx0))


# the option set of __graft_entry__._build_nmpc (the flagship batched solve)
FLAGSHIP = {"tol": 1e-4, "max_iter": 25, "convexify": False, "n_linesearch": 1,
            "mu_init": 1e-2, "mehrotra": False}


def flagship_x0s(B=B_MAIN):
    """The flagship batch: x0 = [0.2, 0.1] + 0.05·N(0,1) from default_rng(0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return (np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B_MAIN, 2)))[:B]


# the row patterns of the whole-solve checks: the flagship |u| <= 5; active
# state and terminal bounds (tests/test_pallas_ip.py:77-96); no bounds at
# all; the soft state bound of golden softcon_active (tests/golden_configs.py:
# build_softcon_active), active along the steady state
WHOLE_IP_BOUNDS = {
    "flagship": dict(u_lb=[-5.0], u_ub=[5.0]),
    "state_terminal_bounds": dict(u_lb=[-5.0], u_ub=[5.0], x_lb=[0.0, 0.0],
                                  x_ub=[0.29, 0.8]),
    "unconstrained": {},
    "softcon_active": dict(u_lb=[-5.0], u_ub=[5.0], x_ub=[0.27, float("inf")],
                           x_soft=True, soft_weight=500.0),
}
# the flagship whole-solve build's registers per thread (float32, float64)
# before the emitted Hessian functions took the point; phase 0 holds them
WHOLE_IP_FLAGSHIP_REGISTERS = (104, 191)


def build_cstr_nmpc(options, dtype, bounds=None, horizon=N, device="cuda"):
    import torch  # noqa: F401
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(**(WHOLE_IP_BOUNDS["flagship"] if bounds is None
                                else bounds))
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options},
               device=device, dtype=dtype)
    return nmpc


def build_du_nmpc(options, dtype, horizon=N, device="cuda"):
    """Phase 2's controller with golden du_tracking's input-change term
    (weight 0.5) and Δu bounds ±0.5: the Δu-augmented CSTR (solver state
    (x, u_prev), control Δu; nx, nu = 3, 1)."""
    import torch  # noqa: F401
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.quad_stage_cost.add_inputs_change(weights=0.5)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0], du_lb=[-0.5], du_ub=[0.5])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options},
               device=device, dtype=dtype)
    return nmpc


def du_u_prev(B=B_MAIN):
    """Phase 11(a)'s previous inputs: 0.5·N(0,1) clipped to ±5 from
    default_rng(2), (B, 1)."""
    import numpy as np
    rng = np.random.default_rng(2)
    return np.clip(0.5 * rng.standard_normal((B_MAIN, 1)), -5.0, 5.0)[:B]


def pathfollow_nmpc(options, dtype, device="cuda"):
    """Golden pathfollow_soft's controller (tests/golden_configs.py:118-150)
    with torch callables: a kinematic point on the path (th, sin th), a soft
    band py <= 0.7 (w = 50), path velocity in [0, 2] with speed reference 1."""
    import torch
    from hilo_mpc_tpu_torch import NMPC, Model
    m = Model(name="pt")
    m.set_dynamical_states(["px", "py"])
    m.set_inputs(["vx", "vy"])
    m.set_dynamical_equations(lambda x, u: u)
    nmpc = NMPC(m)
    nmpc.horizon = 12
    nmpc.quad_stage_cost.add_states(
        names=["px", "py"], weights=[20.0, 20.0], path_following=True,
        path_fn=lambda th: torch.stack([th, torch.sin(th)], dim=-1))
    nmpc.quad_stage_cost.add_inputs(weights=[0.05, 0.05])
    nmpc.set_box_constraints(u_lb=[-2.0, -2.0], u_ub=[2.0, 2.0])
    nmpc.add_stage_constraint(lambda x, u: x[..., 1] - 0.7, ub=0.0, n=1,
                              is_soft=True, weight=50.0)
    nmpc.create_path_variable(u_pf_lb=0.0, u_pf_ub=2.0, speed_ref=1.0,
                              speed_weight=1.0)
    nmpc.setup(options=options, device=device, dtype=dtype)
    return nmpc


# pure Newton steps, as the whole-solve kernel takes them (the flagship's
# options but the tolerance, which follows the dtype: 1e-4 in float32)
PURE_NEWTON = {"dt": 0.1, "max_iter": 25, "convexify": False, "n_linesearch": 1,
               "mu_init": 1e-2, "mehrotra": False}
# golden pathfollow_soft's options under pure Newton steps
PF_NEWTON = {"dt": 0.1, "max_iter": 80, "convexify": False, "n_linesearch": 1,
             "mehrotra": False}


def msd_traced_nmpc(dtype, device="cuda", horizon=N, options=None):
    """Phase 10(a)'s mass-spring-damper (tools/tpu_validation.py:55-80; a
    model given as a callable) with its soft |pos| <= 1 and without its hard
    row, at pure Newton options: the whole-solve kernel's traced route."""
    import torch
    from hilo_mpc_tpu_torch import NMPC, Model
    m = Model(name="msd")
    m.set_dynamical_states(["pos", "vel"])
    m.set_inputs("f")
    m.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -0.5 * x[..., 0] - 0.2 * x[..., 1] + u[..., 0]], dim=-1))
    nmpc = NMPC(m)
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[4.0, 1.0], ref=[0.9, 0.0])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-3.0], u_ub=[3.0], x_ub=[1.0, float("inf")],
                             x_lb=[-1.0, -float("inf")], x_soft=True)
    nmpc.setup(options={**PURE_NEWTON, **(options or {})}, device=device, dtype=dtype)
    return nmpc


def msd_x0s(B=B_MAIN):
    """Phase 10(a)'s batch: x0 = 0.2·N(0,1) from default_rng(1)."""
    import numpy as np
    return 0.2 * np.random.default_rng(1).standard_normal((B_MAIN, 2))[:B]


def cstr_generic_nmpc(dtype, device="cuda", options=None):
    """The flagship with a generic stage cost (x_1 - 0.3)^4 and a terminal
    measurement term (y = x_2 against 0.18, weight 1): the traced route's
    generic costs on the DSL model."""
    import torch  # noqa: F401
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.stage_cost.cost = lambda x: (x[..., 0] - 0.3) ** 4
    nmpc.quad_terminal_cost.add_measurements(weights=1.0, ref=[0.18])
    nmpc.set_box_constraints(**WHOLE_IP_BOUNDS["flagship"])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **FLAGSHIP,
                        **(options or {})}, device=device, dtype=dtype)
    return nmpc


def traced_problems():
    """{label: the emitted problem} of the traced builds phases 1, 11(b) and
    14 run (float32 controllers at their own theta width): the msd, golden
    pathfollow_soft's controller, the generic-cost CSTR and the flagship
    (phase 0 prints each build's registers)."""
    import torch
    from hilo_mpc_tpu_torch.ops.codegen_fx import emit_fx_problem
    f32 = torch.float32
    builders = {"msd": lambda: msd_traced_nmpc(f32),
                "pathfollow_soft": lambda: pathfollow_nmpc(PF_NEWTON, f32),
                "cstr_generic": lambda: cstr_generic_nmpc(f32),
                "flagship": lambda: build_cstr_nmpc(FLAGSHIP, f32)}
    out = {}
    for name, build in builders.items():
        nmpc = build()
        bnd = tuple(b.cpu().double().numpy() for b in nmpc._bounds)
        out[name] = emit_fx_problem(nmpc._funcs, nmpc._dims, bnd,
                                    nmpc._funcs.source.n_theta, nmpc._ip_opts)
    return out


def mintime_nmpc(dtype, device="cuda"):
    """Golden mintime's controller (tests/golden_configs.py:244-273): a
    rest-to-rest double-integrator transfer, N=16, |u| <= 1, the terminal
    equality x_N = 0, dt in [0.02, 0.6], RK4, tol 1e-9, max_iter 120."""
    import torch
    from hilo_mpc_tpu_torch import NMPC, Model
    m = Model(name="di")
    m.set_dynamical_states(["p", "v"])
    m.set_inputs("a")
    m.set_dynamical_equations(lambda x, u: torch.stack([x[..., 1], u[..., 0]], dim=-1))
    nmpc = NMPC(m)
    nmpc.horizon = 16
    nmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    nmpc.add_terminal_constraint(lambda x: x, lb=[0.0, 0.0], ub=[0.0, 0.0], n=2)
    nmpc.minimize_final_time(weight=1.0, dt_min=0.02, dt_max=0.6)
    nmpc.setup(options={"dt": 0.2, "integration_method": "rk4", "tol": 1e-9,
                        "max_iter": 120}, device=device, dtype=dtype)
    return nmpc


def phase1(report):
    """Each kernel vs its plain version on the card, each part timed."""
    for key in ("fgm_boxqp", "fgm_boxqp_resident", "fgm_boxqp_registers"):
        report.setdefault(key, {})
    for part, arg in ((phase1_riccati, "riccati_lq"),
                      (phase1_riccati_wide, "riccati_lq_wide"),
                      (phase1_riccati_free_x0, None), (phase1_fgm, None),
                      (phase1_fgm_cluster, "fgm_boxqp_column_blocks"),
                      (phase1_whole_ip, "whole_ip"), (phase1_whole_ip_cross, "whole_ip_cross"),
                      (phase1_whole_ip_traced, "whole_ip_traced"),
                      (phase1_whole_ip_implicit, "whole_ip_implicit"),
                      (phase1_last_classes, None)):
        t = time.perf_counter()
        part(report if arg is None else report.setdefault(arg, {}))
        log(f"{part.__name__} took {time.perf_counter() - t:.1f} s")


def idle_lane_share(iterations):
    """Share of lane-iterations that finished lanes leave idle in the
    whole-solve kernel, whose warps take 32 consecutive scenarios: the sum
    over warps of (the warp's most iterations - each lane's), over the sum
    of the lanes' iterations."""
    import torch
    it = iterations.to(torch.int64)
    warp = torch.arange(it.numel(), device=it.device) // 32
    most = torch.zeros(int(warp[-1]) + 1, dtype=it.dtype, device=it.device)
    most.scatter_reduce_(0, warp, it, "amax")
    return float((most[warp] - it).sum()) / max(float(it.sum()), 1.0)


def offset_views(args):
    """Copies of args that start one element into their storage, so their
    data_ptr is not 16-byte aligned (as for a view such as A[1:])."""
    import torch
    out = []
    for t in args:
        v = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
        v = v.view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 != 0
        out.append(v)
    return tuple(out)


def lq_tol(name, f32):
    """f32: the tolerances of tests/test_pallas_kernels.py:94-101 (lam and the
    summed cost_red carry more roundoff); f64: 1e-10."""
    if f32:
        return dict(rtol=1e-4, atol=1e-3 if name in ("lam", "cost_red") else 1e-4)
    return dict(rtol=1e-10, atol=1e-10)


def phase1_riccati(report):
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (riccati_lq_cuda,
                                                     riccati_lq_reference)
    names = ("dX", "dU", "lam", "K", "kff", "cost_red")
    f32, f64 = torch.float32, torch.float64
    max_err = 0.0
    # (B, N, nx, nu, dtype, inputs offset by one element)
    cases = [(1000, N, nx, nu, dt, False) for dt in (f32, f64)
             for nx, nu in RICCATI_SIZES]
    cases += [(B_MAIN, N, 2, 1, f32, False), (131071, 7, 2, 1, f32, False),
              (131071, 7, 2, 1, f64, False), (1000, 64, 8, 4, f64, False),
              (1000, 7, 2, 1, f32, True), (1000, 7, 2, 1, f64, True)]
    for Bt, n, nx, nu, dt, offset in cases:
        ref_args = lq_problem(Bt, n, nx, nu, dt)
        args = offset_views(ref_args) if offset else ref_args
        out = riccati_lq_cuda(*args, reg=1e-8)
        ref = riccati_lq_reference(*ref_args, reg=1e-8)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(names, out, ref):
            torch.testing.assert_close(a, b, **lq_tol(name, dt == f32))
            errs[name] = float((a - b).abs().max())
        max_err = max(max_err, max(errs.values()))
        log(f"phase1 riccati_lq B={Bt} N={n} nx={nx} nu={nu} {str(dt)[6:]}"
            f"{' unaligned inputs' if offset else ''}: max|kernel-plain| "
            + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    # the flagship shape (B=131072, N=20, nx=2, nu=1), timed in both dtypes
    for dt in (f32, f64):
        args = lq_problem(B_MAIN, N, 2, 1, dt)
        kernel = lambda: riccati_lq_cuda(*args, reg=1e-8)  # noqa: E731
        ms = cuda_time_ms(kernel)
        b2b_ms = cuda_time_ms(kernel, inner=INNER)
        plain_ms = cuda_time_ms(lambda: riccati_lq_reference(*args, reg=1e-8))
        nbytes, flops = riccati_lq_work(B_MAIN, N, 2, 1, itemsize=8 if dt == f64 else 4)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_FP64 if dt == f64 else PEAK_FP32)
        log(f"phase1 riccati_lq B={B_MAIN} N={N} nx=2 nu=1 {str(dt)[6:]}: kernel "
            f"{ms:.4f} ms one call, {b2b_ms:.4f} ms back to back ({INNER} calls "
            f"per run), plain {plain_ms:.4f} ms (median of 10 runs, CUDA events); "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB): {b_ms / ms:.1%} "
            f"of the bound one call, {b_ms / b2b_ms:.1%} back to back, "
            f"{nbytes / b2b_ms / 1e6:.1f} GB/s back to back")
        if dt == f32:
            report.update(max_abs_err=max_err, ms=ms, back_to_back_ms=b2b_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def phase1_riccati_wide(report):
    """The wide variant against the plain sweeps at (9, 2), (16, 4), (16, 8)
    and its cap (32, 16) on a ragged batch (B=1001), float32 (lq_tol) and
    float64 (1e-12); timed at phase 4's shape (B=1024, N=20, (16, 8),
    float64) and in float32, in every group size at (9, 2), (16, 8) and the
    cap in both dtypes, then at the fleet shape B=16384 (float64, its first
    1001 scenarios against the plain sweeps)."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (RICCATI_WIDE_GROUPS,
                                                     riccati_lq_reference,
                                                     riccati_lq_wide_cuda,
                                                     riccati_lq_wide_group)
    names = ("dX", "dU", "lam", "K", "kff", "cost_red")
    f32, f64 = torch.float32, torch.float64

    def check(out, ref, dt):
        errs = {}
        for name, a, b in zip(names, out, ref):
            tol = lq_tol(name, True) if dt == f32 else dict(rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(a, b, **tol)
            errs[name] = float((a - b).abs().max())
        return errs

    max_err = 0.0
    for nx, nu in RICCATI_WIDE_SIZES:
        for dt in (f32, f64):
            args = lq_problem(1001, N, nx, nu, dt, seed=3)
            out = riccati_lq_wide_cuda(*args, reg=1e-8)
            ref = riccati_lq_reference(*args, reg=1e-8)
            torch.cuda.synchronize()
            errs = check(out, ref, dt)
            if dt == f64:
                max_err = max(max_err, max(errs.values()))
            log(f"phase1 riccati_lq_wide B=1001 N={N} nx={nx} nu={nu} {str(dt)[6:]} "
                f"(G={riccati_lq_wide_group(nx, nu, dt)}): max|kernel-plain| "
                + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))

    nx, nu = RICCATI_WIDE_PHASE4

    def timed(Bt, dt, plain=True):
        args = lq_problem(Bt, N, nx, nu, dt)
        kernel = lambda: riccati_lq_wide_cuda(*args, reg=1e-8)  # noqa: E731
        ms = cuda_time_ms(kernel)
        b2b_ms = cuda_time_ms(kernel, inner=INNER)
        plain_ms = (cuda_time_ms(lambda: riccati_lq_reference(*args, reg=1e-8))
                    if plain else None)
        nbytes, flops = riccati_lq_work(Bt, N, nx, nu, itemsize=8 if dt == f64 else 4)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_FP64 if dt == f64 else PEAK_FP32)
        log(f"phase1 riccati_lq_wide B={Bt} N={N} nx={nx} nu={nu} {str(dt)[6:]} "
            f"G={riccati_lq_wide_group(nx, nu, dt)}: kernel {ms:.4f} ms one "
            f"call, {b2b_ms:.4f} ms back to back ({INNER} calls per run)"
            + ("" if plain_ms is None else f", plain {plain_ms:.4f} ms")
            + f" (median of 10 runs, CUDA events); bound {b_ms:.4f} ms ({b_by}, "
            f"{flops:.3e} FLOPs, {nbytes / 1e6:.1f} MB): {b_ms / ms:.1%} of the bound "
            f"one call, {b_ms / b2b_ms:.1%} back to back")
        return args, ms, b2b_ms, plain_ms, b_ms, b_by

    _, ms, b2b_ms, plain_ms, b_ms, b_by = timed(B_WIDE, f64)
    report.update(max_abs_err=max_err, ms=ms, back_to_back_ms=b2b_ms,
                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    timed(B_WIDE, f32)
    # every group size at (9, 2), phase 4's size and the cap, in both
    # dtypes, at B=1024: the readings riccati_lq_wide_group's rule rests on
    for size in RICCATI_WIDE_GROUP_SIZES:
        for dt in (f32, f64):
            args = lq_problem(B_WIDE, N, *size, dt)
            one, b2b = {}, {}
            for g in RICCATI_WIDE_GROUPS:
                kernel = lambda g=g: riccati_lq_wide_cuda(*args, reg=1e-8, group=g)  # noqa: E731
                one[g], b2b[g] = cuda_time_ms(kernel), cuda_time_ms(kernel, inner=INNER)
            chosen = riccati_lq_wide_group(*size, dt)
            log(f"phase1 riccati_lq_wide B={B_WIDE} N={N} (nx, nu)={size} "
                f"{str(dt)[6:]} by warps per scenario G (one call / back to back, "
                f"ms, median of 10 runs): "
                + ", ".join(f"G={g} {one[g]:.4f} / {b2b[g]:.4f}" for g in one)
                + f"; the chooser's G={chosen} ranks "
                f"{sorted(b2b.values()).index(b2b[chosen]) + 1} of {len(b2b)} back "
                f"to back")
            del args
    args = timed(B_FLEET, f64, plain=False)[0]
    out = riccati_lq_wide_cuda(*args, reg=1e-8)
    ref = riccati_lq_reference(*(a[:1001] for a in args), reg=1e-8)
    torch.cuda.synchronize()
    errs = check([o[:1001] for o in out], ref, f64)
    log(f"phase1 riccati_lq_wide B={B_FLEET} float64, first 1001 scenarios: "
        f"max|kernel-plain| " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    del args, out


def random_qp(n, nx=2, seed=0):
    """Random box-QP (the generator of tests/test_pallas_kernels.py:12-19)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return M @ M.T + np.eye(n), rng.normal(size=(n, nx)), -np.ones(n), np.ones(n)


def fgm_dev(a):
    import numpy as np
    import torch
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float32,
                           device="cuda").contiguous()


def fgm_tensor_distance(args, u, iters, u0=None, constants=None):
    """max|u - emulation| of a tensor-core design's answer u on the first
    1024 scenarios of args, the emulation being ops/cuda_kernels.py:
    fgm_boxqp_tf32x3 (its split and three float32 products)."""
    from hilo_mpc_tpu_torch.ops.cuda_kernels import fgm_boxqp_tf32x3
    sub = args[:2] + (args[2][:1024],) + args[3:5]
    emu = fgm_boxqp_tf32x3(*sub, iters, None if u0 is None else u0[:1024],
                           constants=constants)
    return float((u[:1024] - emu).abs().max())


def phase1_fgm(report):
    """The FGM kernels against the plain version at n in FGM_NARROW_NS (the
    register design and the tensor-core design), FGM_WIDE_NS and FGM_MAX_N
    (the cluster kernel), with and without u0 and infinite bounds, to 1e-4
    (the tensor-core design also against its emulation, printed); phase
    4's flagship QP (n=20, B=131072) and its register-design model (n=16)
    timed (fgm_lmpc_row); the two n <= 128 designs timed against each other
    (fgm_crossover); the tensor-core design's own row at n = FGM_RESIDENT_N,
    B=131072. Fills report["fgm_boxqp"], report["fgm_boxqp_registers"] and
    report["fgm_boxqp_resident"]."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (
        FGM_MAX_N, fgm_boxqp_cuda, fgm_boxqp_design, fgm_boxqp_reference)

    max_err = {"registers": 0.0, "tensor": 0.0, "cluster": 0.0}
    for n in sorted({*FGM_NARROW_NS, *FGM_WIDE_NS, FGM_MAX_N}):
        design = fgm_boxqp_design(n)[0]
        for with_u0 in (False, True):
            for inf in (False, True):
                H, G, lb, ub = random_qp(n)
                if inf:
                    lb[::2], ub[1::3] = -np.inf, np.inf
                rng = np.random.default_rng(1)
                x0 = rng.normal(size=(1000, 2))
                u0 = fgm_dev(0.1 * rng.normal(size=(1000, n))) if with_u0 else None
                args = (fgm_dev(H), fgm_dev(G), fgm_dev(x0), fgm_dev(lb), fgm_dev(ub),
                        200, u0)
                out = fgm_boxqp_cuda(*args)
                err = float((out - fgm_boxqp_reference(*args)).abs().max())
                emu = (f", max|kernel-emulation| = "
                       f"{fgm_tensor_distance(args[:5], out, 200, u0):.3e}"
                       if design == "tensor" else "")
                torch.cuda.synchronize()
                log(f"phase1 fgm_boxqp B=1000 n={n} ({design}) iters=200 u0={with_u0} "
                    f"inf_bounds={inf}: max|kernel-plain| = {err:.3e}{emu}")
                assert err <= 1e-4, err
                max_err[design] = max(max_err[design], err)
    # phase 4's condensed QPs: the flagship (n = N·nu = 20, nx = 2) and the
    # same integrator over N_REGISTERS stages, whose n the register design
    # takes
    fgm_lmpc_row(report["fgm_boxqp"], N, max_err)
    fgm_lmpc_row(report["fgm_boxqp_registers"], N_REGISTERS, max_err)
    report["fgm_boxqp_resident"]["max_abs_err"] = max_err["tensor"]
    fgm_crossover(report)


def fgm_lmpc_row(row, horizon, max_err):
    """Phase 4's double-integrator QP over `horizon` stages (n = horizon) at
    B=131072, 100 iterations, with the constants from its float64 H as
    LMPC.optimize_batch_fgm takes them, in the design the router picks:
    against the plain version (1e-4) and the other n <= 128 design; timed
    one call, back to back and through the wrapper, beside the plain
    version and the bound. Fills `row`."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (
        fgm_boxqp_cuda, fgm_boxqp_design, fgm_boxqp_launch, fgm_boxqp_reference,
        fgm_constants)
    H, G, lb, ub = build_di_lmpc(torch.float32, {}, setup=False,
                                 horizon=horizon).condensed_qp()
    n = H.shape[0]
    design = fgm_boxqp_design(n)[0]
    other = "tensor" if design == "registers" else "registers"
    consts = fgm_constants(H)
    x0 = np.random.default_rng(0).standard_normal((B_MAIN, 2))
    args = (fgm_dev(H), fgm_dev(G), fgm_dev(x0), fgm_dev(lb), fgm_dev(ub), FGM_ITERS)
    out = fgm_boxqp_cuda(*args, constants=consts)
    err = float((out - fgm_boxqp_reference(*args, constants=consts)).abs().max())
    same = float((out - fgm_boxqp_launch(*args, None, *consts, design=other)).abs().max())
    torch.cuda.synchronize()
    log(f"phase1 fgm_boxqp B={B_MAIN} n={n} iters={FGM_ITERS} (phase 4's QP, "
        f"{design}): max|kernel-plain| = {err:.3e}, max|{design} - {other}| = {same:.3e}")
    assert err <= 1e-4, err
    kernel = lambda: fgm_boxqp_launch(*args, None, *consts)  # noqa: E731
    ms = cuda_time_ms(kernel)
    b2b_ms = cuda_time_ms(kernel, inner=INNER)
    wrapper_ms = cuda_time_ms(lambda: fgm_boxqp_cuda(*args, constants=consts))
    plain_ms = cuda_time_ms(lambda: fgm_boxqp_reference(*args, constants=consts))
    b_ms, b_by, simt_ms = fgm_bound(B_MAIN, n, 2, FGM_ITERS, design)
    log(f"phase1 fgm_boxqp B={B_MAIN} n={n} nx=2 iters={FGM_ITERS} float32 "
        f"({design}): kernel {ms:.4f} ms one call, {b2b_ms:.4f} ms "
        f"back to back ({INNER} calls per run), wrapper {wrapper_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (median of 10 runs, CUDA events); bound {b_ms:.4f} ms "
        f"({b_by}): {b_ms / ms:.1%} of the bound one call, {b_ms / b2b_ms:.1%} back "
        f"to back; float32-SIMT bound {simt_ms:.4f} ms")
    row.update(max_abs_err=max(max_err[design], err), ms=ms, back_to_back_ms=b2b_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, design=design)


def fgm_crossover(report=None):
    """The two designs for n <= 128 (the register design up to
    FGM_REG_BUILD_MAX_N, and the tensor-core design) at each n of
    FGM_CROSSOVER_NS, B=131072, 100 iterations, on random_qp(n): each
    against the plain version on the first 1024 scenarios (1e-4; where the
    router takes the tensor-core design also with u0, with infinite bounds
    and with both, 200 iterations), timed one call (median of 5) and back to
    back (the median of FGM_CROSSOVER_ROUNDS rounds of queued_time_ms, the
    designs' order reversed from one round to the next), beside its bound;
    the router's pick must be the faster back to back at every n, or within
    FGM_ROUTER_SLACK of it (checked after all are printed). With a report,
    the tensor-core design's row at FGM_RESIDENT_N."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (
        FGM_REG_BUILD_MAX_N, FGM_REG_MAX_N, fgm_boxqp_design, fgm_boxqp_launch,
        fgm_boxqp_reference, fgm_constants)

    wrong = []
    for n in FGM_CROSSOVER_NS:
        # the register design builds up to FGM_REG_BUILD_MAX_N only
        designs = (["registers"] if n <= FGM_REG_BUILD_MAX_N else []) + ["tensor"]
        H, G, lb, ub = random_qp(n, seed=n)
        consts = fgm_constants(H)
        x0 = np.random.default_rng(n).standard_normal((B_MAIN, 2))
        args = (fgm_dev(H), fgm_dev(G), fgm_dev(x0), fgm_dev(lb), fgm_dev(ub), FGM_ITERS)
        sub = args[:2] + (args[2][:1024],) + args[3:]
        ref = fgm_boxqp_reference(*sub, constants=consts)
        kernels, checked = {}, {}
        for design in designs:
            kernel = lambda d=design: fgm_boxqp_launch(  # noqa: E731
                *args, None, *consts, design=d)
            out = kernel()
            err = float((out[:1024] - ref).abs().max())
            extra = ""
            if design == "tensor" and n > FGM_REG_MAX_N:
                lb_i, ub_i = lb.copy(), ub.copy()
                lb_i[::2], ub_i[1::3] = -np.inf, np.inf
                u0 = fgm_dev(0.1 * np.random.default_rng(n).normal(size=(1024, n)))
                for tag, bnd, u0_ in (("u0", (lb, ub), u0), ("inf", (lb_i, ub_i), None),
                                      ("u0+inf", (lb_i, ub_i), u0)):
                    case = sub[:3] + (fgm_dev(bnd[0]), fgm_dev(bnd[1]), 200)
                    e = float((fgm_boxqp_launch(*case, u0_, *consts, design=design)
                               - fgm_boxqp_reference(*case, u0_, constants=consts))
                              .abs().max())
                    err = max(err, e)
                    extra += f" {tag} {e:.3e}"
                extra = (f"; with 200 iterations{extra}; max|kernel-emulation| "
                         f"{fgm_tensor_distance(args[:5], out, FGM_ITERS, None, consts):.3e}")
            torch.cuda.synchronize()
            assert err <= 1e-4, (n, design, err)
            kernels[design], checked[design] = kernel, (err, extra)
        rounds = {design: [] for design in designs}
        for r in range(FGM_CROSSOVER_ROUNDS):
            for design in designs[::-1] if r % 2 else designs:
                rounds[design].append(queued_time_ms(kernels[design]))
        times = {}
        for design in designs:
            err, extra = checked[design]
            one = cuda_time_ms(kernels[design], reps=5, warmup=1)
            b2b = float(np.median(rounds[design]))
            times[design] = (one, b2b)
            b_ms, b_by, simt_ms = fgm_bound(B_MAIN, n, 2, FGM_ITERS, design)
            log(f"phase1 fgm_boxqp crossover B={B_MAIN} n={n} {design}: "
                f"max|kernel-plain| on the first 1024 = {err:.3e}{extra}; {one:.4f} ms "
                f"one call, {b2b:.4f} ms back to back (rounds "
                f"{', '.join(f'{t:.4f}' for t in rounds[design])}); bound {b_ms:.4f} ms "
                f"({b_by}): {b_ms / one:.1%} one call, {b_ms / b2b:.1%} back to back; "
                f"float32-SIMT bound {simt_ms:.4f} ms")
            if report is not None and design == "tensor" and n == FGM_RESIDENT_N:
                plain_ms = cuda_time_ms(
                    lambda: fgm_boxqp_reference(*args, constants=consts), reps=3)
                row = report["fgm_boxqp_resident"]
                row.update(max_abs_err=max(row.get("max_abs_err", 0.0), err), ms=one,
                           back_to_back_ms=b2b, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, float32_simt_bound_ms=simt_ms)
        fastest = min(times, key=lambda k: times[k][1])
        picked = fgm_boxqp_design(n)[0]
        behind = times[picked][1] / times[fastest][1] - 1.0
        log(f"phase1 fgm_boxqp crossover n={n}: fastest back to back {fastest}; "
            f"the router takes {picked} (FGM_REG_MAX_N = {FGM_REG_MAX_N}), "
            f"{behind:.1%} behind the fastest")
        if behind > FGM_ROUTER_SLACK:
            wrong.append((n, picked, times))
    assert not wrong, (f"the router's pick is more than {FGM_ROUTER_SLACK:.0%} behind "
                       f"the faster design back to back: {wrong}")


def phase1_fgm_cluster(report):
    """The FGM kernel above n = 128 (H resident over a thread-block cluster)
    at phase 4's second model (n = N·nu = 160, nx=16, 100 iterations),
    against its plain version: at B=1024, then at B=131072 (the plain
    comparison on the first 1024 scenarios). Timed as the flagship is at
    n=20."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (
        fgm_boxqp_cluster_rows, fgm_boxqp_cluster_smem_bytes, fgm_boxqp_cuda,
        fgm_boxqp_design, fgm_boxqp_launch, fgm_boxqp_reference, fgm_constants)

    H, G, lb, ub = wide_di_lmpc(torch.float32, {}).condensed_qp()
    n, nx = G.shape
    consts = fgm_constants(H)
    _, c, t = fgm_boxqp_design(n)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous()

    x0_all = np.random.default_rng(5).standard_normal((B_MAIN, nx))
    for Bt in (B_WIDE, B_MAIN):
        args = tuple(dev(a) for a in (H, G, x0_all[:Bt], lb, ub)) + (FGM_ITERS,)
        sub = args[:2] + (args[2][:1024],) + args[3:]
        err = float((fgm_boxqp_cuda(*args, constants=consts)[:1024]
                     - fgm_boxqp_reference(*sub, constants=consts)).abs().max())
        torch.cuda.synchronize()
        assert err <= 1e-4, err
        nbytes, flops = fgm_work(Bt, n, nx, FGM_ITERS)
        b_ms, b_by = bound_ms(nbytes, flops)
        kernel = lambda: fgm_boxqp_launch(*args, None, *consts)  # noqa: E731
        ms = cuda_time_ms(kernel)
        b2b_ms = cuda_time_ms(kernel, inner=INNER)
        plain_ms = cuda_time_ms(lambda: fgm_boxqp_reference(*args, constants=consts))
        log(f"phase1 fgm_boxqp B={Bt} n={n} nx={nx} iters={FGM_ITERS} float32 "
            f"(clusters of {c} blocks, tiles of {t} scenarios, "
            f"{fgm_boxqp_cluster_rows(n, c)} rows and "
            f"{fgm_boxqp_cluster_smem_bytes(n, c, t)} B per block, "
            f"{c * -(-Bt // t)} blocks): max|kernel-plain| on the first 1024 "
            f"= {err:.3e}; kernel {ms:.4f} ms one call, {b2b_ms:.4f} ms back to "
            f"back ({INNER} calls per run), plain {plain_ms:.4f} ms (median of 10 "
            f"runs, CUDA events); bound {b_ms:.4f} ms ({b_by}, {flops:.3e} FLOPs): "
            f"{b_ms / ms:.1%} of the bound one call, {b_ms / b2b_ms:.1%} back to back")
        if Bt == B_WIDE:
            report.update(max_abs_err=err, ms=ms, back_to_back_ms=b2b_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def phase1_whole_ip(report):
    """The whole-solve kernel against its plain version (solve_ocp with the
    plain LQ sweeps) on the first 1024 flagship scenarios, for the three row
    patterns, in float64 (the kernel's algebra: equal iterations, U to 1e-9)
    and float32 (the kernel's type: U to 5e-4 on the jointly converged
    scenarios; with active state bounds at tol 1e-4 the float32 plain version
    itself strays from the float64 answer by ~3e-3, so there the kernel is
    held to that stray plus 5e-4); then timed at B=131072 in float32."""
    import torch
    from hilo_mpc_tpu_torch.ops.codegen_cuda import WIP_MIN_BLOCKS, WIP_TB
    from hilo_mpc_tpu_torch.ops.whole_ip import (
        WholeIPLaunch, solve_ocp_full_cuda, solve_ocp_full_reference,
        whole_ip_problem)

    x0s = flagship_x0s(1024)
    for name, bounds in WHOLE_IP_BOUNDS.items():
        sols = {}
        for dt in (torch.float64, torch.float32):
            nmpc = build_cstr_nmpc(FLAGSHIP, dt, bounds)
            f = (nmpc._funcs, nmpc._dims, nmpc._bounds)
            args = nmpc.prepare_batch(x0s)
            k = solve_ocp_full_cuda(*f, *args, nmpc._ip_opts)
            r = solve_ocp_full_reference(*f, *args, nmpc._ip_opts)
            torch.cuda.synchronize()
            both = k.converged & r.converged
            err = float((k.U - r.U).abs()[both].max())
            eq = float((k.iterations == r.iterations).float().mean())
            log(f"phase1 whole_ip {name} B=1024 N={N} {str(dt)[6:]}: converged "
                f"kernel {float(k.converged.float().mean()):.4f} plain "
                f"{float(r.converged.float().mean()):.4f}, equal iterations "
                f"{eq:.4f}, max|U_kernel - U_plain| on the jointly converged "
                f"{err:.3e}")
            assert float(both.float().mean()) >= 0.95, name
            sols[dt] = (k, r, both, err)
        k64, r64, both64, err64 = sols[torch.float64]
        if name in ("flagship", "softcon_active"):
            assert torch.equal(k64.iterations, r64.iterations), name
            err64 = float((k64.U - r64.U).abs().max())
        assert torch.equal(k64.iterations[both64], r64.iterations[both64]), name
        # the soft penalty's branches (x > ub) see the plain version's point
        assert err64 <= (1e-12 if name == "softcon_active" else 1e-9), (name, err64)
        k32, r32, both32, err32 = sols[torch.float32]
        tol = 5e-4
        if name == "state_terminal_bounds":
            j = both32 & both64
            stray = float((r32.U.double() - r64.U).abs()[j].max())
            off = float((k32.U.double() - r64.U).abs()[j].max())
            log(f"phase1 whole_ip {name}: max|U - U_plain_f64| float32 plain "
                f"{stray:.3e}, float32 kernel {off:.3e}")
            assert off <= stray + tol, (off, stray)
        else:
            assert err32 <= tol, (name, err32)

    # the flagship shape, timed: the bare launch, the controller's prepared
    # path (NMPC with pallas_full), the per-call wrapper and the plain version
    nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
    ctl = build_cstr_nmpc({**FLAGSHIP, "pallas_full": True}, torch.float32)
    f, opts = (nmpc._funcs, nmpc._dims, nmpc._bounds), nmpc._ip_opts
    args = nmpc.prepare_batch(flagship_x0s())
    problem = whole_ip_problem(*f, args[0].shape[2], opts)
    launch = WholeIPLaunch(problem, nmpc._dims, torch.float32, args[0].device)
    kernel = lambda: launch.launch(*args, opts.mu_init)  # noqa: E731
    ms = cuda_time_ms(kernel)
    b2b_ms = cuda_time_ms(kernel, inner=INNER)
    path = ctl.solve_batch_fn()
    path_ms = cuda_time_ms(lambda: path(*args))
    wrapper_ms = cuda_time_ms(lambda: solve_ocp_full_cuda(*f, *args, opts))
    plain_ms = cuda_time_ms(lambda: solve_ocp_full_reference(*f, *args, opts))
    k = solve_ocp_full_cuda(*f, *args, opts)
    r = solve_ocp_full_reference(*f, *args, opts)
    p = path(*args)
    torch.cuda.synchronize()
    for a, b in zip(p, k):
        assert torch.equal(a, b), "the controller's prepared path and the wrapper differ"
    both = k.converged & r.converged
    err = float((k.U - r.U).abs()[both].max())
    its = int(k.iterations.sum())
    b_ms, b_by = bound_ms(*whole_ip_work(problem, nmpc._dims, B_MAIN,
                                         args[0].shape[2], its))
    log(f"phase1 whole_ip flagship B={B_MAIN} N={N} float32 (TB={WIP_TB}, "
        f"MINB={WIP_MIN_BLOCKS[0]}, {problem.region} values per scenario): "
        f"max|U_kernel - U_plain| on the jointly converged {err:.3e}; kernel "
        f"{ms:.4f} ms one call, {b2b_ms:.4f} ms back to back ({INNER} calls per "
        f"run), the controller's prepared path {path_ms:.4f} ms ({path_ms - ms:+.4f} "
        f"ms against the kernel one call), the per-call wrapper {wrapper_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of 10 runs, CUDA events); bound "
        f"{b_ms:.4f} ms ({b_by}; {problem.flops} operations per "
        f"scenario-iteration, {its} scenario-iterations): {b_ms / ms:.1%} of "
        f"the bound one call, {b_ms / b2b_ms:.1%} back to back")
    log(f"phase1 whole_ip flagship B={B_MAIN}: idle-lane share "
        f"{idle_lane_share(k.iterations):.4f} (iterations p50 "
        f"{float(k.iterations.float().median()):g} max {int(k.iterations.max())})")
    assert err <= 5e-4, err
    report.update(max_abs_err=err, ms=ms, back_to_back_ms=b2b_ms,
                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # the float64 instance at the same shape (its own register budget)
    args64 = [a.double() for a in args]
    launch64 = WholeIPLaunch(problem, nmpc._dims, torch.float64, args[0].device)
    kernel64 = lambda: launch64.launch(*args64, opts.mu_init)  # noqa: E731
    ms64 = cuda_time_ms(kernel64)
    b2b64 = cuda_time_ms(kernel64, inner=INNER)
    plain64 = cuda_time_ms(lambda: solve_ocp_full_reference(*f, *args64, opts), reps=3)
    k64 = launch64(*args64, opts.mu_init)
    b64, by64 = bound_ms(*whole_ip_work(problem, nmpc._dims, B_MAIN, args[0].shape[2],
                                        int(k64.iterations.sum()), itemsize=8),
                         PEAK_FP64)
    log(f"phase1 whole_ip flagship B={B_MAIN} N={N} float64 (MINB="
        f"{WIP_MIN_BLOCKS[1]}): kernel {ms64:.4f} ms one call, {b2b64:.4f} ms back "
        f"to back, plain {plain64:.4f} ms (median of 3 runs); bound {b64:.4f} ms "
        f"({by64}): {b64 / ms64:.1%} of the bound one call")

    # the soft-box problem (golden softcon_active's bounds) at the same shape
    soft = build_cstr_nmpc(FLAGSHIP, torch.float32, WHOLE_IP_BOUNDS["softcon_active"])
    fs, sopts = (soft._funcs, soft._dims, soft._bounds), soft._ip_opts
    sargs = soft.prepare_batch(flagship_x0s())
    sproblem = whole_ip_problem(*fs, sargs[0].shape[2], sopts)
    slaunch = WholeIPLaunch(sproblem, soft._dims, torch.float32, sargs[0].device)
    skernel = lambda: slaunch.launch(*sargs, sopts.mu_init)  # noqa: E731
    s_ms = cuda_time_ms(skernel)
    s_b2b = cuda_time_ms(skernel, inner=INNER)
    s_plain = cuda_time_ms(lambda: solve_ocp_full_reference(*fs, *sargs, sopts), reps=3)
    ks = slaunch.launch(*sargs, sopts.mu_init)
    rs = solve_ocp_full_reference(*fs, *sargs, sopts)
    torch.cuda.synchronize()
    both = ks.converged & rs.converged
    s_err = float((ks.U - rs.U).abs()[both].max())
    s_its = int(ks.iterations.sum())
    sb_ms, sb_by = bound_ms(*whole_ip_work(sproblem, soft._dims, B_MAIN,
                                           sargs[0].shape[2], s_its))
    active = float((rs.X[:, 1:, 0] > 0.27).any(dim=1).float().mean())
    log(f"phase1 whole_ip softcon_active B={B_MAIN} N={N} float32 ({sproblem.region} "
        f"values per scenario; the soft bound violated somewhere on the horizon "
        f"in {active:.4f} of the plain solutions): converged kernel "
        f"{float(ks.converged.float().mean()):.4f} plain "
        f"{float(rs.converged.float().mean()):.4f}, max|U_kernel - U_plain| on "
        f"the jointly converged {s_err:.3e}; kernel {s_ms:.4f} ms one call, "
        f"{s_b2b:.4f} ms back to back, plain {s_plain:.4f} ms (median of 3 runs); "
        f"bound {sb_ms:.4f} ms ({sb_by}; {sproblem.flops} operations per "
        f"scenario-iteration, {s_its} scenario-iterations): {sb_ms / s_ms:.1%} of "
        f"the bound one call; idle-lane share {idle_lane_share(ks.iterations):.4f} "
        f"(iterations p50 {float(ks.iterations.float().median()):g} max "
        f"{int(ks.iterations.max())})")
    assert float(both.float().mean()) >= 0.97 and s_err <= 5e-4, s_err
    report.update(soft_box_max_abs_err=s_err, soft_box_ms=s_ms,
                  soft_box_back_to_back_ms=s_b2b, soft_box_plain_ms=s_plain,
                  soft_box_bound_ms=sb_ms, soft_box_bound_by=sb_by)


def phase1_whole_ip_cross(report):
    """The whole-solve kernel with the cost's cross block (CROSS: phase
    11(a)'s Δu problem, nx, nu = 3, 1) against its plain version on the
    first 1024 scenarios: float64 (equal iterations, U to 1e-12) and float32
    (U to 5e-4 on the jointly converged). Then timed at B=131072 in both
    dtypes beside its operations bound. At that width float32's stopping
    rule (KKT error <= 1e-4) ends a few scenarios one iteration apart in the
    two routes, on an objective so flat along U that the two points lie
    ~2e-3 apart, each as far from the float64 plain answer: there the
    kernel is held to the float32 plain version's stray from the float64
    one plus 5e-4, as the state-bound pattern of phase1_whole_ip is."""
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import (WholeIPLaunch,
                                                 solve_ocp_full_reference,
                                                 whole_ip_problem)
    f32, f64 = torch.float32, torch.float64
    x0s, u_prev = flagship_x0s(), du_u_prev()
    ctl = {dt: build_du_nmpc(FLAGSHIP, dt) for dt in (f64, f32)}
    nmpc = ctl[f32]
    f, opts = (nmpc._funcs, nmpc._dims, nmpc._bounds), nmpc._ip_opts
    f_64 = (ctl[f64]._funcs, ctl[f64]._dims, ctl[f64]._bounds)
    args = nmpc.prepare_batch(x0s, u_prev=u_prev)
    args64 = [a.double() for a in args]
    problem = whole_ip_problem(*f, args[0].shape[2], opts)
    assert "static constexpr bool CROSS = true;" in problem.text
    launch = {dt: WholeIPLaunch(problem, nmpc._dims, dt, args[0].device)
              for dt in (f32, f64)}
    errs = {}
    for dt, a_dt, f_dt in ((f64, args64, f_64), (f32, args, f)):
        sub = [a[:1024] for a in a_dt]
        k = launch[dt](*sub, opts.mu_init)
        r = solve_ocp_full_reference(*f_dt, *sub, opts)
        torch.cuda.synchronize()
        both = k.converged & r.converged
        errs[dt] = float((k.U - r.U).abs()[both].max())
        log(f"phase1 whole_ip_cross (Δu CSTR, nx=3 nu=1, {problem.region} values per "
            f"scenario) B=1024 N={N} {str(dt)[6:]}: converged kernel "
            f"{float(k.converged.float().mean()):.4f} plain "
            f"{float(r.converged.float().mean()):.4f}, equal iterations "
            f"{float((k.iterations == r.iterations).float().mean()):.4f}, "
            f"max|U_kernel - U_plain| on the jointly converged {errs[dt]:.3e}")
        assert float(both.float().mean()) >= 0.97, dt
        if dt == f64:
            assert torch.equal(k.iterations, r.iterations)
            assert float((k.U - r.U).abs().max()) <= 1e-12, errs[dt]
    assert errs[f32] <= 5e-4, errs[f32]

    # B=131072, float32: timed, and held to the plain version's stray
    kernel = lambda: launch[f32].launch(*args, opts.mu_init)  # noqa: E731
    ms = cuda_time_ms(kernel)
    b2b_ms = cuda_time_ms(kernel, inner=INNER)
    plain_ms = cuda_time_ms(lambda: solve_ocp_full_reference(*f, *args, opts), reps=3)
    k = launch[f32].launch(*args, opts.mu_init)
    r = solve_ocp_full_reference(*f, *args, opts)
    r64 = solve_ocp_full_reference(*f_64, *args64, opts)
    torch.cuda.synchronize()
    both = k.converged & r.converged
    gap = (k.U - r.U).abs().amax(dim=(1, 2))[both]
    j = both & r64.converged
    stray = float((r.U.double() - r64.U).abs()[j].max())
    off = float((k.U.double() - r64.U).abs()[j].max())
    its = int(k.iterations.sum())
    b_ms, b_by = bound_ms(*whole_ip_work(problem, nmpc._dims, B_MAIN,
                                         args[0].shape[2], its))
    log(f"phase1 whole_ip_cross B={B_MAIN} N={N} float32: max|U_kernel - U_plain| on "
        f"the jointly converged {float(gap.max()):.3e} (above 5e-4 in "
        f"{int((gap > 5e-4).sum())} scenarios, equal iterations "
        f"{float((k.iterations == r.iterations).float().mean()):.4f}); against the "
        f"float64 plain version: plain {stray:.3e}, kernel {off:.3e}; kernel "
        f"{ms:.4f} ms one call, {b2b_ms:.4f} ms back to back, plain {plain_ms:.4f} ms "
        f"(median of 3 runs); bound {b_ms:.4f} ms ({b_by}; {problem.flops} operations "
        f"per scenario-iteration, {its} scenario-iterations): {b_ms / ms:.1%} of the "
        f"bound one call; idle-lane share {idle_lane_share(k.iterations):.4f} "
        f"(iterations p50 {float(k.iterations.float().median()):g} max "
        f"{int(k.iterations.max())})")
    assert off <= stray + 5e-4, (off, stray)
    report.update(max_abs_err=errs[f32], ms=ms, back_to_back_ms=b2b_ms,
                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  float64_max_abs_err=errs[f64])
    # the float64 instance at the same shape
    ms64 = cuda_time_ms(lambda: launch[f64].launch(*args64, opts.mu_init))
    k64 = launch[f64].launch(*args64, opts.mu_init)
    b64, by64 = bound_ms(*whole_ip_work(problem, nmpc._dims, B_MAIN, args[0].shape[2],
                                        int(k64.iterations.sum()), itemsize=8),
                         PEAK_FP64)
    log(f"phase1 whole_ip_cross B={B_MAIN} N={N} float64: kernel {ms64:.4f} ms one "
        f"call; bound {b64:.4f} ms ({by64}): {b64 / ms64:.1%} of the bound")
    report.update(float64_ms=ms64, float64_bound_ms=b64)


def traced_kernel_vs_plain(label, problem, ctl, args, tol64=1e-9):
    """The build of ``problem`` (the float32 controller ctl[float32]'s, whose
    options it holds) against its plain version on the first 1024 scenarios
    of ``args``, one build serving both dtypes: float64 launches the same
    text and numbers, held to the float64 controller's plain version at the
    float32 controller's bounds (the build's numbers: the chain's
    v >= -0.08 rounds to float32, and that active bound's 1.8e-9 moved U
    by 1.5e-7 on the card), with equal iterations and U to ``tol64`` (1e-9 for a traced
    build: the card fuses multiply-adds where the plain version's kernels do
    not); float32 on the jointly converged no further from the float64
    plain version than the float32 plain version is, plus 5e-4 (a float32
    GP's cancelling mean puts the SMPC's two float32 routes ~7e-3 apart).
    Returns the float32 kernel's largest distance from the float32 plain
    version there."""
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import WholeIPLaunch, solve_ocp_full_reference
    f32, f64 = torch.float32, torch.float64
    sols = {}
    opts = ctl[f32]._ip_opts                     # the options the problem holds
    for dt in (f64, f32):
        c = ctl[dt]
        bounds = type(c._bounds)(*(b.to(dt) for b in ctl[f32]._bounds))
        sub = [a[:1024].to(dt) for a in args]
        k = WholeIPLaunch(problem, c._dims, dt, sub[0].device)(*sub, opts.mu_init)
        r = solve_ocp_full_reference(c._funcs, c._dims, bounds, *sub, opts)
        torch.cuda.synchronize()
        both = k.converged & r.converged
        sols[dt] = (k, r, float((k.U - r.U).abs()[both].max()))
        log(f"{label} B=1024 {str(dt)[6:]}: converged kernel "
            f"{float(k.converged.float().mean()):.4f} plain "
            f"{float(r.converged.float().mean()):.4f}, equal iterations "
            f"{float((k.iterations == r.iterations).float().mean()):.4f}, "
            f"max|U_kernel - U_plain| on the jointly converged {sols[dt][2]:.3e}")
        assert float(both.float().mean()) >= 0.97, (label, dt)
    k64, r64, err64 = sols[f64]
    assert torch.equal(k64.iterations, r64.iterations), label
    assert float((k64.U - r64.U).abs().max()) <= tol64, (label, err64)
    k32, r32, err32 = sols[f32]
    j = k32.converged & r32.converged & r64.converged
    stray = float((r32.U.double() - r64.U).abs()[j].max())
    off = float((k32.U.double() - r64.U).abs()[j].max())
    log(f"{label} B=1024 float32 against the float64 plain version: plain "
        f"{stray:.3e}, kernel {off:.3e}")
    assert off <= stray + 5e-4, (label, off, stray)
    return err32


def build_registers(problem):
    """{"float32"|"float64": [registers, spill bytes]} of a whole-solve
    build (nvcc's -Xptxas -v log beside the library)."""
    from hilo_mpc_tpu_torch.ops import _build
    return whole_ip_registers(_build.source_library_path(problem.text) + ".log")


def phase1_whole_ip_traced(report):
    """The whole-solve kernel on a traced problem (phase 14(a)'s msd: a
    callable model, soft |pos| <= 1, pure Newton): against its plain version
    on the first 1024 scenarios in both dtypes; at B=131072 float32 timed
    beside its operations bound and held to the float32 plain version's
    stray from the float64 one plus 5e-4; its build's registers and spills
    (the Hessians by one nested dual pass)."""
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import (WholeIPLaunch,
                                                 solve_ocp_full_reference,
                                                 whole_ip_gate)
    f32, f64 = torch.float32, torch.float64
    ctl = {dt: msd_traced_nmpc(dt) for dt in (f64, f32)}
    nmpc = ctl[f32]
    problem, why = whole_ip_gate(nmpc._funcs, nmpc._dims, nmpc._bounds, nmpc._ip_opts,
                                 True)
    assert problem is not None and "codegen_fx.py" in problem.text, why
    args = nmpc.prepare_batch(msd_x0s())
    err = traced_kernel_vs_plain("phase1 whole_ip_traced (msd)", problem, ctl, args)
    f, opts = (nmpc._funcs, nmpc._dims, nmpc._bounds), nmpc._ip_opts
    f64_ = (ctl[f64]._funcs, ctl[f64]._dims, ctl[f64]._bounds)
    launch = WholeIPLaunch(problem, nmpc._dims, f32, args[0].device)
    kernel = lambda: launch.launch(*args, opts.mu_init)  # noqa: E731
    ms = cuda_time_ms(kernel)
    b2b_ms = cuda_time_ms(kernel, inner=INNER)
    plain_ms = cuda_time_ms(lambda: solve_ocp_full_reference(*f, *args, opts), reps=3)
    k = launch.launch(*args, opts.mu_init)
    r = solve_ocp_full_reference(*f, *args, opts)
    args64 = [a.double() for a in args]
    r64 = solve_ocp_full_reference(*f64_, *args64, ctl[f64]._ip_opts)
    torch.cuda.synchronize()
    both = k.converged & r.converged
    gap = float((k.U - r.U).abs()[both].max())
    j = both & r64.converged
    stray = float((r.U.double() - r64.U).abs()[j].max())
    off = float((k.U.double() - r64.U).abs()[j].max())
    its = int(k.iterations.sum())
    b_ms, b_by = bound_ms(*whole_ip_work(problem, nmpc._dims, B_MAIN,
                                         args[0].shape[2], its))
    regs = build_registers(problem)
    log(f"phase1 whole_ip_traced (msd, nx=2 nu=1, {problem.region} values per "
        f"scenario) B={B_MAIN} N={N} float32: converged kernel "
        f"{float(k.converged.float().mean()):.4f} plain "
        f"{float(r.converged.float().mean()):.4f}, max|U_kernel - U_plain| on the "
        f"jointly converged {gap:.3e}; against the float64 plain version: plain "
        f"{stray:.3e}, kernel {off:.3e}; kernel {ms:.4f} ms one call, {b2b_ms:.4f} "
        f"ms back to back, plain {plain_ms:.4f} ms (median of 3 runs); bound "
        f"{b_ms:.4f} ms ({b_by}; {problem.flops} operations per "
        f"scenario-iteration, {its} scenario-iterations): {b_ms / ms:.1%} of the "
        f"bound one call; idle-lane share {idle_lane_share(k.iterations):.4f} "
        f"(iterations p50 {float(k.iterations.float().median()):g} max "
        f"{int(k.iterations.max())}); registers float32 {regs['float32'][0]} "
        f"({regs['float32'][1]} bytes spilled), float64 {regs['float64'][0]} "
        f"({regs['float64'][1]} bytes spilled)")
    assert float(both.float().mean()) >= 0.97 and off <= stray + 5e-4, (off, stray)
    report.update(max_abs_err=err, ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by, float32_registers=regs["float32"],
                  float64_registers=regs["float64"])


# the flagship under Radau collocation of degree 3 (phases 1 and 12(a))
COLLOC_FLAGSHIP = {**FLAGSHIP, "integration_method": "collocation", "degree": 3}


def implicit_problems():
    """{label: emitted problem} of the whole-solve builds with an implicit
    step: the collocation flagship (DSL route, a Newton of 6 unknowns) and
    golden dae_colloc's model at FLAGSHIP's options (traced route, Radau d=3
    on x and z, 6 unknowns)."""
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import whole_ip_gate
    out = {}
    for label, ctl in (("collocation", build_cstr_nmpc(COLLOC_FLAGSHIP, torch.float32)),
                       ("dae_colloc", dae_nmpc(torch.float32, options=FLAGSHIP))):
        problem, why = whole_ip_gate(ctl._funcs, ctl._dims, ctl._bounds, ctl._ip_opts,
                                     True)
        assert problem is not None and "implicit.cuh" in problem.text, (label, why)
        out[label] = problem
    return out


# the whole-solve kernel's last problem classes (phases 0, 1, 11(b), 16(a)
# and 19): a chain of 8 masses (tests/chain_model.py's copy), the flagship
# CSTR under Radau d=2 with a path parameter, golden smpc_chance's SMPC
# without its chance row
CHAIN_MASSES, CHAIN_DT = 8, 0.5
CHAIN_K, CHAIN_K3, CHAIN_DAMP, CHAIN_TAU = 1.0, 0.5, 0.2, 0.5
CHAIN_V_MIN, CHAIN_U_MAX, CHAIN_P_REF = -0.08, 1.0, -0.3
CHAIN_W = (1.0, 1.0, 10.0)                # positions, velocities, input
PATH_COLLOC = {"dt": 0.1, "integration_method": "collocation", "degree": 2}
# the batches of the routes through both paths (phases 11(b), 19; 16(a) at
# B_LAST_SMPC), cut from B=131072 to keep the script inside its time limit
B_LAST, B_LAST_SMPC = 8192, 4096
SMPC_NEWTON = {"dt": 0.1, "tol": 1e-4, "max_iter": 25, "convexify": False,
               "n_linesearch": 1, "mehrotra": False}


def chain_equations():
    """The chain in the equation DSL: spring i (mass i-1 to mass i, the wall
    at 0) pulls with k d + k3 d³ + c Δv; the input drives F, which pushes
    the last mass. States p_1..p_8, v_1..v_8, F."""
    n, lines = CHAIN_MASSES, []
    for i in range(1, n + 1):
        p_prev = f"p_{i - 1}(t)" if i > 1 else "0"
        v_prev = f"v_{i - 1}(t)" if i > 1 else "0"
        lines.append(f"d_{i} = p_{i}(t) - {p_prev}")
        lines.append(f"s_{i} = {CHAIN_K}*d_{i} + {CHAIN_K3}*d_{i}**3 + "
                     f"{CHAIN_DAMP}*(v_{i}(t) - {v_prev})")
    lines += [f"dp_{i}/dt = v_{i}(t)" for i in range(1, n + 1)]
    lines += [f"dv_{i}/dt = s_{i + 1} - s_{i}" for i in range(1, n)]
    lines.append(f"dv_{n}/dt = F(t) - s_{n}")
    lines.append(f"dF/dt = (u(k) - F(t))/{CHAIN_TAU}")
    return "\n".join(lines)


def chain_nmpc(options, dtype, device="cuda", horizon=N):
    """The chain's NMPC: every mass pulled to CHAIN_P_REF, its velocity to
    0; |u| <= 1, |F| <= 1, v_5..v_8 >= CHAIN_V_MIN (stage rows 31..34,
    across the first word boundary)."""
    import numpy as np
    from hilo_mpc_tpu_torch import NMPC, Model
    n = CHAIN_MASSES
    m = Model(name="chain")
    m.set_equations(chain_equations())
    nmpc = NMPC(m)
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(names=[f"p_{i}" for i in range(1, n + 1)],
                                    weights=[CHAIN_W[0]] * n, ref=[CHAIN_P_REF] * n)
    nmpc.quad_stage_cost.add_states(names=[f"v_{i}" for i in range(1, n + 1)],
                                    weights=[CHAIN_W[1]] * n, ref=[0.0] * n)
    nmpc.quad_stage_cost.add_inputs(weights=CHAIN_W[2])
    x_lb, x_ub = np.full(2 * n + 1, -np.inf), np.full(2 * n + 1, np.inf)
    x_lb[n + 4:2 * n] = CHAIN_V_MIN
    x_lb[-1], x_ub[-1] = -CHAIN_U_MAX, CHAIN_U_MAX
    nmpc.set_box_constraints(x_lb=x_lb, x_ub=x_ub, u_lb=[-CHAIN_U_MAX],
                             u_ub=[CHAIN_U_MAX])
    nmpc.setup(options={**options, "dt": CHAIN_DT}, device=device, dtype=dtype)
    return nmpc


def chain_x0s(B=B_MAIN, seed=0):
    """Near rest: positions and velocities spread by 0.02 and 0.01 (the
    velocities kept above CHAIN_V_MIN / 2), F = 0. Drawn scenario by
    scenario, so chain_x0s(B)[:b] is chain_x0s(b): phase 19's batch is
    the first scenarios of phase 1's."""
    import numpy as np
    n = CHAIN_MASSES
    z = np.random.default_rng(seed).standard_normal((B, 2 * n))
    v = np.maximum(0.01 * z[:, n:], CHAIN_V_MIN / 2)
    return np.concatenate([0.02 * z[:, :n], v, np.zeros((B, 1))], axis=1)


def path_colloc_nmpc(options, dtype, device="cuda", horizon=N):
    """The flagship CSTR under Radau collocation d=2 with a path parameter
    (create_path_variable(0, 2, speed_ref=1, speed_weight=1))."""
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=list(X_EQ))
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.create_path_variable(0, 2, speed_ref=1, speed_weight=1)
    nmpc.setup(options={**options, **PATH_COLLOC}, device=device, dtype=dtype)
    return nmpc


def smpc_nochance_ctl(options, dtype, device="cuda", horizon=10):
    """Golden smpc_chance's controller without its chance row, its GP set up
    in float32: the whole-solve kernel computes in its own type, so a float32
    build takes the SMPC whose GP predicts in float32 (a float64 GP under a
    float32 controller predicts in float64, and the gate declines it), and
    both routes then compute the GP in float32. The float64 controller
    predicts with the same GP in float64, from the numbers the float32
    build's prm holds (the trace casts the GP's float64 state to float32,
    and the kernel casts prm to its type)."""
    import torch
    from hilo_mpc_tpu_torch import SMPC
    smpc = SMPC(smpc_lin_model(), gps={"x2": smpc_golden_gp(device, torch.float32)},
                dt=0.1)
    smpc.horizon = horizon
    smpc.quad_stage_cost.add_states(names=["x1", "x2"], weights=[5.0, 1.0],
                                    ref=[0.85, 0.0])
    smpc.quad_stage_cost.add_inputs(weights=0.05)
    smpc.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    return smpc.setup(options=options, device=device, dtype=dtype)


# label -> (the float32/float64 controller at N=20 by dtype, x0s, float64
# tolerance against the plain version, the plain version's timed calls, the
# float64 plain version's batch at B=131072, B_LAST64: the chain's and the
# SMPC's general path takes 12 s a call there, and the chain's float64
# linearization at B=131072 needs more than the card's 80 GB)
B_LAST64 = 8192
LAST_CLASSES = {
    # the chain's float64 kernel lies up to 1.8e-12 from its plain version
    # on an H100 (rounding, amplified through the small slacks of the
    # binding velocity bounds), above the 1e-12 bar of the other DSL
    # builds, so 1e-10
    "wide_rows": (lambda dt: chain_nmpc(FLAGSHIP, dt), lambda: chain_x0s(), 1e-10, 1,
                  B_LAST64),
    "path_implicit": (lambda dt: path_colloc_nmpc(FLAGSHIP, dt),
                      lambda: flagship_x0s(), 1e-9, 1, B_LAST64),
    "smpc": (lambda dt: smpc_nochance_ctl(SMPC_NEWTON, dt, horizon=N),
             lambda: smpc_x0s(B_MAIN), 1e-9, 1, B_LAST64),
}


@functools.lru_cache(maxsize=None)
def last_class_problems():
    """{label: emitted problem} of LAST_CLASSES' float32 controllers: the
    chain from the DSL (two row words), the path problem and the SMPC
    traced."""
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import whole_ip_gate
    out = {}
    for label, (build, *_) in LAST_CLASSES.items():
        ctl = build(torch.float32)
        problem, why = whole_ip_gate(ctl._funcs, ctl._dims, ctl._bounds, ctl._ip_opts,
                                     True)
        assert problem is not None, (label, why)
        assert ("RW = 2" in problem.text) == (label == "wide_rows"), label
        out[label] = problem
    return out


def phase1_last_classes(report):
    """The whole-solve kernel's last problem classes at N=20 (LAST_CLASSES),
    each through phase1_whole_ip_build: the chain (36 candidate box rows
    per stage), path following under collocation, the SMPC without chance
    rows."""
    problems = last_class_problems()
    for label, (build, x0s, tol64, plain_reps, b64) in LAST_CLASSES.items():
        t = time.perf_counter()
        phase1_whole_ip_build(report.setdefault(f"whole_ip_{label}", {}),
                              f"phase1 whole_ip_{label}", build, problems[label], x0s(),
                              tol64, plain_reps, b64=b64)
        log(f"phase1 whole_ip_{label} took {time.perf_counter() - t:.1f} s")


def phase1_whole_ip_build(report, label, build, problem, x0s, tol64=1e-9,
                          plain_reps=3, b64=None):
    """One whole-solve build against its plain version on the first 1024
    scenarios in both dtypes (float64: equal iterations, U to ``tol64``);
    at B=len(x0s) float32 timed one call and back to back beside its
    operations bound and the plain version (``plain_reps`` timed calls
    after one untimed; with one, that call alone, its answer kept; the
    kernel over 3 runs and not back to back where one call takes more than
    100 ms), held to the float32 plain version's stray from the float64 one
    plus 5e-4 (the float64 plain version on the first ``b64`` scenarios,
    default all: the chain's float64 linearization at B=131072 needs more
    than the card's 80 GB); the build's registers and spills."""
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import WholeIPLaunch, solve_ocp_full_reference
    f32, f64 = torch.float32, torch.float64
    ctl = {dt: build(dt) for dt in (f64, f32)}
    nmpc = ctl[f32]
    args = nmpc.prepare_batch(x0s)
    Bt = args[0].shape[0]
    err = traced_kernel_vs_plain(label, problem, ctl, args, tol64)
    f, opts = (nmpc._funcs, nmpc._dims, nmpc._bounds), nmpc._ip_opts
    launch = WholeIPLaunch(problem, nmpc._dims, f32, args[0].device)
    kernel = lambda: launch.launch(*args, opts.mu_init)  # noqa: E731
    # a kernel of most of a second (the chain's) is timed over 3 runs, and
    # not back to back: its launch costs nothing beside it
    slow = cuda_time_ms(kernel, reps=1, warmup=1) > 100.0
    ms = cuda_time_ms(kernel, reps=3 if slow else 10, warmup=0 if slow else 3)
    b2b_ms = None if slow else cuda_time_ms(kernel, reps=10, warmup=3, inner=INNER)
    kept = []
    plain_ms = cuda_time_ms(lambda: kept.append(solve_ocp_full_reference(*f, *args, opts)),
                            reps=plain_reps, warmup=int(plain_reps > 1))
    k = launch.launch(*args, opts.mu_init)
    r = kept[-1]
    kept.clear()
    n64 = b64 or Bt
    r64 = solve_ocp_full_reference(ctl[f64]._funcs, ctl[f64]._dims, ctl[f64]._bounds,
                                   *[a[:n64].double() for a in args], opts)
    torch.cuda.synchronize()
    both = k.converged & r.converged
    gap = float((k.U - r.U).abs()[both].max())
    j = both[:n64] & r64.converged
    stray = float((r.U[:n64].double() - r64.U).abs()[j].max())
    off = float((k.U[:n64].double() - r64.U).abs()[j].max())
    its = int(k.iterations.sum())
    b_ms, b_by = bound_ms(*whole_ip_work(problem, nmpc._dims, Bt, args[0].shape[2],
                                         its))
    regs = build_registers(problem)
    log(f"{label} (nx={nmpc._dims.nx} nu={nmpc._dims.nu}, {len(problem.stage_rows)} "
        f"stage and {len(problem.term_rows)} terminal rows, {problem.region} values per "
        f"scenario) B={Bt} N={nmpc._dims.N} float32: converged kernel "
        f"{float(k.converged.float().mean()):.4f} plain "
        f"{float(r.converged.float().mean()):.4f}, max|U_kernel - U_plain| on the "
        f"jointly converged {gap:.3e}; against the float64 plain version (first "
        f"{n64}): plain {stray:.3e}, kernel {off:.3e}; kernel {ms:.4f} ms one call, "
        + (f"{b2b_ms:.4f} ms back to back ({INNER} calls per run)" if b2b_ms else
           "not timed back to back")
        + f", plain {plain_ms:.4f} ms (median of {plain_reps} runs); bound {b_ms:.4f} "
        f"ms ({b_by}; {problem.flops} operations per scenario-iteration, {its} "
        f"scenario-iterations): {b_ms / ms:.1%} of the bound one call"
        + (f", {b_ms / b2b_ms:.1%} back to back" if b2b_ms else "") + "; "
        f"idle-lane share {idle_lane_share(k.iterations):.4f} (iterations p50 "
        f"{float(k.iterations.float().median()):g} max {int(k.iterations.max())}); "
        f"registers float32 {regs['float32'][0]} ({regs['float32'][1]} bytes "
        f"spilled), float64 {regs['float64'][0]} ({regs['float64'][1]} bytes "
        f"spilled)")
    assert float(both.float().mean()) >= 0.97 and off <= stray + 5e-4, (off, stray)
    report.update(max_abs_err=err, ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by, float32_registers=regs["float32"],
                  float64_registers=regs["float64"])


def phase1_whole_ip_implicit(report):
    """The whole-solve kernel with an emitted implicit step (the flagship
    under Radau collocation d=3: per stage and IP iteration 8 Newton steps
    of 6 unknowns on plain values, one tangent solve over the dual type),
    through phase1_whole_ip_build at B=131072."""
    phase1_whole_ip_build(report, "phase1 whole_ip_implicit (collocation)",
                          lambda dt: build_cstr_nmpc(COLLOC_FLAGSHIP, dt),
                          implicit_problems()["collocation"], flagship_x0s())


def phase2(report):
    """The main path at full width."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp
    from hilo_mpc_tpu_torch.ops.riccati import make_plain_lq_solver

    nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
    x0s = flagship_x0s()
    # untimed warm-up at a small batch (CUDA context, library handles)
    nmpc.solve_batch_fn()(*nmpc.prepare_batch(x0s[:256]))
    torch.cuda.synchronize()

    riccati_lq_cuda.launches = 0
    t0 = time.perf_counter()
    args = nmpc.prepare_batch(x0s)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = nmpc.solve_batch_fn()(*args)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    theta_B, xs0_B, _, _ = args
    X_w = torch.cat([sol.X[:, 1:], sol.X[:, -1:]], dim=1)
    X_w[:, 0] = xs0_B
    U_w = torch.cat([sol.U[:, 1:], sol.U[:, -1:]], dim=1)
    t0 = time.perf_counter()
    sol_w = nmpc.solve_batch_fn(warm=True)(theta_B, xs0_B, X_w, U_w)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    launches = riccati_lq_cuda.launches

    for name, s in (("cold", sol), ("warm", sol_w)):
        assert s.U.shape == (B_MAIN, N, 1) and s.X.shape == (B_MAIN, N + 1, 2)
        assert bool(torch.isfinite(s.U).all()) and bool(torch.isfinite(s.X).all())
        conv = float(s.converged.float().mean())
        assert conv >= 0.97, f"{name} converged fraction {conv}"
    assert launches > 0, "the main path never launched the riccati_lq kernel"
    conv_c = float(sol.converged.float().mean())
    conv_w = float(sol_w.converged.float().mean())
    it_c = float(sol.iterations.float().median())
    it_w = float(sol_w.iterations.float().median())
    log(f"phase2 main path B={B_MAIN} N={N} float32: prepare_batch {t_prep:.4f} s")
    log(f"phase2 cold: {B_MAIN / t_cold:.1f} solves/s ({t_cold:.4f} s wall), "
        f"converged {conv_c:.4f}, iterations p50 {it_c:g} max "
        f"{int(sol.iterations.max())}")
    log(f"phase2 warm: {B_MAIN / t_warm:.1f} solves/s ({t_warm:.4f} s wall), "
        f"converged {conv_w:.4f}, iterations p50 {it_w:g} max "
        f"{int(sol_w.iterations.max())}")
    log(f"phase2 riccati_lq launches in the NMPC path: {launches}")

    # the same solve with the plain LQ step in place of the kernel
    sub = tuple(a[:1024] for a in args)
    sol_ref = solve_ocp(nmpc._funcs, nmpc._dims, nmpc._bounds, *sub,
                        options=nmpc._ip_opts, mu0=nmpc._ip_opts.mu_init,
                        lq_solver=make_plain_lq_solver)
    dev = float((sol.U[:1024] - sol_ref.U).abs().max())
    log(f"phase2 first 1024 scenarios: max|U_kernel - U_plain| = {dev:.3e}")
    assert dev < 1e-3, dev
    report["riccati_lq"]["launches"] = launches
    report["phase2"] = sol


def phase3():
    """Golden closed-loop replay in float64 on the card."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    data = np.load(GOLDEN)
    X_meas, U_gold = data["X_meas"], data["U_gold"]
    nmpc = build_cstr_nmpc({"tol": 1e-9, "max_iter": 80}, torch.float64)
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    devs = []
    for k in range(U_gold.shape[0]):
        u = nmpc.optimize(X_meas[k])
        devs.append(float(np.abs(u - U_gold[k]).max()))
        assert nmpc.stats["converged"], (k, nmpc.stats)
    dt = time.perf_counter() - t0
    assert riccati_lq_cuda.launches > n0
    log(f"phase3 golden cstr_tracking float64: {len(devs)} steps in {dt:.2f} s, "
        f"max|u - u_gold| = {max(devs):.3e}")
    assert max(devs) < 1e-4, devs


DI_A = [[1.0, 0.1], [0.0, 1.0]]
DI_B = [[0.005], [0.1]]
DI_Q = [[2.0, 0.0], [0.0, 0.5]]
DI_R = [[0.1]]


def di_model():
    import numpy as np
    from hilo_mpc_tpu_torch import Model
    m = Model(name="lin", discrete=True)
    return m.set_state_space(A=np.array(DI_A), B=np.array(DI_B))


def build_di_lmpc(dtype, options, setup=True, horizon=N):
    """The LMPC of tools/tpu_validation.py:249-260 (discrete double
    integrator, dt 0.1, N=20, Q=diag(2, 0.5), R=0.1, |u| <= 1) with the
    terminal weight P = Q: without P the condensed QP weights x_N by Q while
    the interior point has no terminal cost, and the two answers differ by
    3.4e-3 (ROADMAP.md §C). `horizon` in place of N gives phase 4's
    register-design model."""
    import numpy as np
    from hilo_mpc_tpu_torch import LMPC
    lmpc = LMPC(di_model())
    lmpc.horizon = horizon
    lmpc.Q = np.array(DI_Q)
    lmpc.R = np.array(DI_R)
    lmpc.P = lmpc.Q
    lmpc.set_box_constraints(u_lb=[-1.0], u_ub=[1.0])
    if setup:
        lmpc.setup(options={"dt": 0.1, **options}, device="cuda", dtype=dtype)
    return lmpc


def fgm_wall_split(label, lmpc, x0s, reps=20, host_reps=200):
    """The wall of LMPC.optimize_batch_fgm split by part, host clock. `reps`
    calls timed whole (median, min, max), then `reps` calls taken step by
    step in the call's own order (medians): the configuration key
    (LMPC._fgm_problem), x0 to the card (the cast to float32 on the host and
    one copy), the wrapper until the launch returns, the wait for the
    kernel with the copy of u back, numpy. The kernel alone by CUDA events;
    u out is that wait less the kernel, and the rest is the wall less x0
    in, kernel and u out. The wrapper's host parts alone on an idle card
    (medians of `host_reps`): its checks, torch.empty of u, the device
    context with the current stream, and the ctypes call that enqueues the
    kernel."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops import cuda_kernels as ck

    def host_ms(fn, n, sync=True):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if sync:
                torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return ts

    wall = host_ms(lambda: lmpc.optimize_batch_fgm(x0s, iters=FGM_ITERS), reps)
    nu = lmpc._model.n_u
    steps = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        H, G, lb, ub, consts = lmpc._fgm_problem()
        t.append(time.perf_counter())
        x0 = lmpc._fgm_x0(x0s)
        t.append(time.perf_counter())
        U = ck.fgm_boxqp_cuda(H, G, x0, lb, ub, FGM_ITERS, constants=consts)
        t.append(time.perf_counter())
        u = U[:, :nu].cpu()
        t.append(time.perf_counter())
        u.numpy()
        t.append(time.perf_counter())
        steps.append(np.diff(t) * 1e3)
    key, x0_in, wrapper, wait_out, to_numpy = np.median(steps, axis=0)
    k_ms = cuda_time_ms(lambda: ck.fgm_boxqp_launch(H, G, x0, lb, ub, FGM_ITERS, None,
                                                    *consts), reps=5)
    w = float(np.median(wall))
    u_out = wait_out - k_ms
    rest = w - x0_in - k_ms - u_out

    Bt, n, nx = x0.shape[0], H.shape[0], G.shape[1]
    name, cluster, tile = ck.fgm_boxqp_design(n)
    dev = x0.device
    ptrs = (H.data_ptr(), G.data_ptr(), x0.data_ptr(), lb.data_ptr(), ub.data_ptr(),
            None, U.data_ptr())

    def context():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    stream = context()
    if name == "registers":
        fn = ck._fgm_reg_entry(n, False)
        call = lambda: fn(*ptrs, Bt, nx, FGM_ITERS, consts[0], consts[1],  # noqa: E731
                          stream)
    elif name == "tensor":
        fn = ck._fgm_tc_entry(ck.fgm_boxqp_tc_pad(n))
        call = lambda: fn(*ptrs, Bt, n, nx, FGM_ITERS, consts[0], consts[1],  # noqa: E731
                          stream)
    else:
        fn = ck._fgm_fn()
        call = lambda: fn(*ptrs, Bt, n, nx, FGM_ITERS, consts[0], consts[1],  # noqa: E731
                          cluster, tile, stream)
    alone = {
        "checks": lambda: ck._check_fgm(H, G, x0, lb, ub, FGM_ITERS, None, dev,
                                        ck.fgm_boxqp_design),
        "empty": lambda: torch.empty((Bt, n), dtype=torch.float32, device=dev),
        "context": context,
        "ctypes launch": call,
    }
    parts = {k: float(np.median(host_ms(f, host_reps, False))) for k, f in alone.items()}
    log(f"{label} optimize_batch_fgm wall split (B={x0s.shape[0]}, n={n}, {name}; "
        f"{reps} calls; host clock, kernel by CUDA events): wall {w:.4f} ms (min "
        f"{min(wall):.4f}, max {max(wall):.4f}) = x0 to the card {x0_in:.4f} ms (cast "
        f"and copy) + kernel {k_ms:.4f} ms + u to the host {u_out:.4f} ms + rest "
        f"{rest:.4f} ms; the rest step by step: configuration key {key:.4f}, wrapper "
        f"until the launch returns {wrapper:.4f}, numpy {to_numpy:.4f}, between steps "
        f"{rest - key - wrapper - to_numpy:.4f} ms; the wrapper's parts alone (medians "
        f"of {host_reps}, ms): " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))


def phase4(report):
    """The linear-MPC path at full width, its interior point and LQR."""
    import numpy as np
    import scipy.linalg
    import torch
    from hilo_mpc_tpu_torch import LQR
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (fgm_boxqp_cuda, fgm_constants,
                                                     riccati_lq_cuda)

    lmpc = build_di_lmpc(torch.float32, {})
    x0s = np.random.default_rng(0).standard_normal((B_MAIN, 2))
    t0 = time.perf_counter()
    lmpc.optimize_batch_fgm(x0s, iters=FGM_ITERS)      # untimed, full-size warm-up
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0

    fgm_boxqp_cuda.launches = 0
    t0 = time.perf_counter()
    u = lmpc.optimize_batch_fgm(x0s, iters=FGM_ITERS)
    t_fgm = time.perf_counter() - t0
    launches = fgm_boxqp_cuda.launches
    assert u.shape == (B_MAIN, 1), u.shape
    assert np.isfinite(u).all()
    assert launches > 0, "the LMPC path never launched the fgm_boxqp kernel"
    assert np.abs(u).max() <= 1.0 + 1e-6
    t0 = time.perf_counter()
    H = lmpc.condensed_qp()[0]
    t_cond = time.perf_counter() - t0
    t0 = time.perf_counter()
    fgm_constants(H)                  # as optimize_batch_fgm takes it: on the host
    t_spec = time.perf_counter() - t0
    log(f"phase4 LMPC.optimize_batch_fgm B={B_MAIN} N={N} iters={FGM_ITERS} "
        f"float32: {B_MAIN / t_fgm:.1f} solves/s ({t_fgm:.4f} s wall, x0 from "
        f"and u to the host included); fgm_boxqp launches {launches}; the first "
        f"call {t_first * 1e3:.3f} ms (condensing {t_cond * 1e3:.3f} ms and the "
        f"spectrum of H {t_spec * 1e3:.3f} ms when timed alone: once per "
        f"configuration)")
    fgm_wall_split("phase4 first model", lmpc, x0s)
    report["fgm_boxqp"]["launches"] = launches

    # the first 1024 scenarios through the interior point, float64 at
    # tol 1e-9 so that its own error is far below the comparison's
    ip = build_di_lmpc(torch.float64, {"tol": 1e-9, "max_iter": 80})
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    u_ip, sol = ip.optimize_batch(x0s[:1024])
    t_ip = time.perf_counter() - t0
    ric = riccati_lq_cuda.launches - n0
    assert bool(sol.converged.all()), "interior point did not converge"
    assert ric > 0, "LMPC.optimize_batch never launched the riccati_lq kernel"
    for iters in (FGM_ITERS, 2 * FGM_ITERS, 4 * FGM_ITERS, 8 * FGM_ITERS):
        dev = float(np.abs(lmpc.optimize_batch_fgm(x0s[:1024], iters=iters)
                           - u_ip).max())
        if dev <= 5e-4:
            break
    log(f"phase4 first 1024 scenarios: interior point float64 {t_ip:.3f} s, "
        f"iterations max {int(sol.iterations.max())}, riccati_lq launches {ric}; "
        f"FGM at {iters} iterations: max|u_fgm - u_ip| = {dev:.3e}")
    assert dev <= 5e-4, dev

    phase4_wide(report)
    phase4_resident(report)
    phase4_registers(report)

    lqr = LQR(di_model())
    lqr.horizon = None
    lqr.Q, lqr.R = np.array(DI_Q), np.array(DI_R)
    lqr.setup(dt=0.1, device="cuda", dtype=torch.float64)
    P_ref = scipy.linalg.solve_discrete_are(np.array(DI_A), np.array(DI_B),
                                            np.array(DI_Q), np.array(DI_R))
    dev_P = float(np.abs(lqr.P - P_ref).max())
    log(f"phase4 LQR infinite horizon float64: max|P - P_scipy| = {dev_P:.3e}")
    assert dev_P < 1e-6, dev_P


def wide_di_lmpc(dtype, options):
    """N_DI decoupled double integrators (nx=16, nu=8), N=20."""
    return decoupled_di_lmpc(N_DI, N, dtype, options)


def phase4_wide(report):
    """The second linear model: the interior point through the wide Riccati
    variant (B=1024) and the FGM path (n = 160, B=131072) through the FGM
    kernel's cluster design, each against its plain counterpart (the FGM
    path on its first 1024 scenarios, which are the interior point's),
    then the two paths."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (fgm_boxqp_cuda,
                                                     fgm_boxqp_design,
                                                     riccati_lq_wide_cuda)
    from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp
    from hilo_mpc_tpu_torch.ops.riccati import make_plain_lq_solver

    nx = 2 * N_DI
    x0s = np.random.default_rng(5).standard_normal((B_WIDE, nx))
    ip = wide_di_lmpc(torch.float64, {"tol": 1e-9, "max_iter": 80})
    ip.optimize_batch(x0s[:4])                    # untimed warm-up and build
    torch.cuda.synchronize()
    riccati_lq_wide_cuda.launches = 0
    t0 = time.perf_counter()
    u_ip, sol = ip.optimize_batch(x0s)
    t_ip = time.perf_counter() - t0
    launches = riccati_lq_wide_cuda.launches
    assert launches > 0, "LMPC.optimize_batch never launched the wide Riccati kernel"
    assert bool(sol.converged.all()), "interior point (nx=16) did not converge"
    args = ip.prepare_batch(x0s)
    plain = solve_ocp(ip._funcs, ip._dims, ip._bounds, *args, options=ip._ip_opts,
                      mu0=ip._ip_opts.mu_init, lq_solver=make_plain_lq_solver)
    torch.cuda.synchronize()
    eq = float((plain.iterations == sol.iterations).float().mean())
    dev_ip = float((sol.U - plain.U).abs().max())
    log(f"phase4 second model (nx={nx}, nu={N_DI}) B={B_WIDE} N={N} interior point "
        f"float64: t_ip {t_ip:.4f} s, iterations max {int(sol.iterations.max())}, "
        f"riccati_lq_wide launches {launches}; against the plain LQ step: equal "
        f"iterations {eq:.4f}, max|U_kernel - U_plain| = {dev_ip:.3e}")
    assert dev_ip <= 1e-8, dev_ip

    fgm = wide_di_lmpc(torch.float32, {})
    n = N * N_DI
    x0_fleet = np.random.default_rng(6).standard_normal((B_MAIN, nx))
    x0_fleet[:B_WIDE] = x0s
    fgm.optimize_batch_fgm(x0_fleet, iters=FGM_ITERS)     # untimed warm-up
    torch.cuda.synchronize()
    fgm_boxqp_cuda.launches = 0
    t0 = time.perf_counter()
    u_fleet = fgm.optimize_batch_fgm(x0_fleet, iters=FGM_ITERS)
    t_fgm = time.perf_counter() - t0
    ran = fgm_boxqp_cuda.launches
    assert u_fleet.shape == (B_MAIN, N_DI) and np.isfinite(u_fleet).all()
    assert np.abs(u_fleet).max() <= 1.0 + 1e-6
    u_ref = fgm.optimize_batch_fgm(x0s, iters=FGM_ITERS, backend="xla")
    dev_fgm = float(np.abs(u_fleet[:B_WIDE] - u_ref).max())
    log(f"phase4 second model optimize_batch_fgm n={n} {fgm_boxqp_design(n)} "
        f"B={B_MAIN} iters={FGM_ITERS} float32: {B_MAIN / t_fgm:.1f} solves/s "
        f"({t_fgm * 1e3:.3f} ms wall), fgm_boxqp launches {ran}; first {B_WIDE} "
        f"scenarios: max|u_kernel - u_plain| = {dev_fgm:.3e}")
    assert ran == 1 and dev_fgm <= 1e-4, (ran, dev_fgm)
    for iters in (FGM_ITERS, 2 * FGM_ITERS, 4 * FGM_ITERS, 8 * FGM_ITERS):
        dev = float(np.abs(fgm.optimize_batch_fgm(x0s, iters=iters) - u_ip).max())
        if dev <= 5e-4:
            break
    log(f"phase4 second model: FGM at {iters} iterations against the interior "
        f"point: max|u_fgm - u_ip| = {dev:.3e}")
    assert dev <= 5e-4, dev
    fgm_wall_split("phase4 second model", fgm, x0s)
    fgm_wall_split("phase4 second model", fgm, x0_fleet)
    report["riccati_lq_wide"]["launches"] = launches
    report["fgm_boxqp_column_blocks"]["launches"] = ran


def decoupled_di_lmpc(copies, horizon, dtype, options):
    """`copies` decoupled double integrators (the model of build_di_lmpc,
    block diagonal), Q, R and P = Q block diagonal, |u| <= 1."""
    import numpy as np
    import scipy.linalg
    from hilo_mpc_tpu_torch import LMPC, Model
    m = Model(name=f"lin{copies}", discrete=True)
    m.set_state_space(A=scipy.linalg.block_diag(*[np.array(DI_A)] * copies),
                      B=scipy.linalg.block_diag(*[np.array(DI_B)] * copies))
    lmpc = LMPC(m)
    lmpc.horizon = horizon
    lmpc.Q = scipy.linalg.block_diag(*[np.array(DI_Q)] * copies)
    lmpc.R = scipy.linalg.block_diag(*[np.array(DI_R)] * copies)
    lmpc.P = lmpc.Q
    lmpc.set_box_constraints(u_lb=[-1.0] * copies, u_ub=[1.0] * copies)
    lmpc.setup(options={"dt": 0.1, **options}, device="cuda", dtype=dtype)
    return lmpc


def phase4_fgm_model(report, label, fgm, x0s, n, design, key):
    """optimize_batch_fgm of one more linear model at B=131072: design (the
    router's pick for its n) launched once, the answer against the plain
    version on its first 1024 scenarios (1e-4), its launches into
    report[key], and the call's wall split."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import fgm_boxqp_cuda, fgm_boxqp_design

    assert fgm_boxqp_design(n)[0] == design, (n, design)
    nu = n // fgm.horizon
    fgm.optimize_batch_fgm(x0s, iters=FGM_ITERS)     # untimed warm-up
    torch.cuda.synchronize()
    fgm_boxqp_cuda.launches = 0
    t0 = time.perf_counter()
    u = fgm.optimize_batch_fgm(x0s, iters=FGM_ITERS)
    t_fgm = time.perf_counter() - t0
    ran = fgm_boxqp_cuda.launches
    assert u.shape == (B_MAIN, nu) and np.isfinite(u).all()
    assert np.abs(u).max() <= 1.0 + 1e-6
    ref = fgm.optimize_batch_fgm(x0s[:1024], iters=FGM_ITERS, backend="xla")
    dev = float(np.abs(u[:1024] - ref).max())
    log(f"phase4 {label} optimize_batch_fgm n={n} {fgm_boxqp_design(n)} "
        f"B={B_MAIN} iters={FGM_ITERS} float32: {B_MAIN / t_fgm:.1f} solves/s "
        f"({t_fgm * 1e3:.3f} ms wall), fgm_boxqp launches {ran}; first 1024 "
        f"scenarios: max|u_kernel - u_plain| = {dev:.3e}")
    assert ran == 1 and dev <= 1e-4, (ran, dev)
    report[key]["launches"] = ran
    fgm_wall_split(f"phase4 {label}", fgm, x0s)


def phase4_resident(report):
    """The third linear model: N_DI_RESIDENT decoupled double integrators
    over N_RESIDENT stages, so n = FGM_RESIDENT_N lies above the register
    design's range and the FGM path runs the tensor-core design."""
    import numpy as np
    import torch
    fgm = decoupled_di_lmpc(N_DI_RESIDENT, N_RESIDENT, torch.float32, {})
    assert N_RESIDENT * N_DI_RESIDENT == FGM_RESIDENT_N
    x0s = np.random.default_rng(7).standard_normal((B_MAIN, 2 * N_DI_RESIDENT))
    phase4_fgm_model(report, "third model", fgm, x0s, FGM_RESIDENT_N, "tensor",
                     "fgm_boxqp_resident")


def phase4_registers(report):
    """The fourth linear model: the flagship integrator over N_REGISTERS
    stages, so n = N_REGISTERS lies in the register design's range."""
    import numpy as np
    import torch
    fgm = build_di_lmpc(torch.float32, {}, horizon=N_REGISTERS)
    x0s = np.random.default_rng(0).standard_normal((B_MAIN, 2))
    phase4_fgm_model(report, "fourth model", fgm, x0s, N_REGISTERS, "registers",
                     "fgm_boxqp_registers")


def phase5():
    """Golden lmpc_di replay in float64 on the card (the configuration of
    tests/golden_configs.py:63-88)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import LMPC, Model
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    data = np.load(GOLDEN_LMPC)
    X_meas, U_gold = data["X_meas"], data["U_gold"]
    m = Model(discrete=True)
    m.set_state_space(A=np.array(DI_A), B=np.array([[0.5 * 0.1 ** 2], [0.1]]))
    lmpc = LMPC(m)
    lmpc.horizon = 15
    lmpc.Q = np.diag([2.0, 0.5])
    lmpc.R = np.array([[0.1]])
    lmpc.P = np.diag([8.0, 2.0])
    lmpc.set_box_constraints(u_lb=[-0.8], u_ub=[0.8], x_lb=[-np.inf, -0.6],
                             x_ub=[np.inf, 0.6])
    lmpc.setup(options={"dt": 0.1, "tol": 1e-9, "max_iter": 80}, device="cuda",
               dtype=torch.float64)
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    devs = []
    for k in range(U_gold.shape[0]):
        u = lmpc.optimize(X_meas[k])
        devs.append(float(np.abs(u - U_gold[k]).max()))
        assert lmpc.stats["converged"], (k, lmpc.stats)
    dt = time.perf_counter() - t0
    assert riccati_lq_cuda.launches > n0
    log(f"phase5 golden lmpc_di float64: {len(devs)} steps in {dt:.2f} s, "
        f"max|u - u_gold| = {max(devs):.3e}")
    assert max(devs) < 1e-4, devs


def phase6(report):
    """The whole-solve path at full width, on phase 2's inputs."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda

    nmpc = build_cstr_nmpc({**FLAGSHIP, "pallas_full": True}, torch.float32)
    x0s = flagship_x0s()
    nmpc.solve_batch_fn()(*nmpc.prepare_batch(x0s[:256]))   # untimed warm-up
    torch.cuda.synchronize()

    solve_ocp_full_cuda.launches = 0
    n_ric = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    args = nmpc.prepare_batch(x0s)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = nmpc.solve_batch_fn()(*args)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    theta_B, xs0_B, _, _ = args
    X_w = torch.cat([sol.X[:, 1:], sol.X[:, -1:]], dim=1)
    X_w[:, 0] = xs0_B
    U_w = torch.cat([sol.U[:, 1:], sol.U[:, -1:]], dim=1)
    t0 = time.perf_counter()
    sol_w = nmpc.solve_batch_fn(warm=True)(theta_B, xs0_B, X_w, U_w)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    launches = solve_ocp_full_cuda.launches
    ric = riccati_lq_cuda.launches - n_ric

    # the kernel alone on the cold inputs, through the controller's launch
    launch = next(iter(nmpc._wip["launch"].values()))
    k_ms = cuda_time_ms(lambda: launch.launch(*args, nmpc._mu_cold), reps=5)
    for name, s_, t in (("cold", sol, t_cold), ("warm", sol_w, t_warm)):
        assert s_.U.shape == (B_MAIN, N, 1) and s_.X.shape == (B_MAIN, N + 1, 2)
        assert bool(torch.isfinite(s_.U).all()) and bool(torch.isfinite(s_.X).all())
        conv = float(s_.converged.float().mean())
        assert conv >= 0.97, f"{name} converged fraction {conv}"
        log(f"phase6 {name}: {B_MAIN / t:.1f} solves/s ({t:.4f} s wall), "
            f"converged {conv:.4f}, iterations p50 "
            f"{float(s_.iterations.float().median()):g} max {int(s_.iterations.max())}, "
            f"idle-lane share {idle_lane_share(s_.iterations):.4f}")
    log(f"phase6 cold call split: kernel alone {k_ms:.4f} ms (CUDA events, median "
        f"of 5), the rest of the {t_cold * 1e3:.4f} ms wall {t_cold * 1e3 - k_ms:.4f} "
        f"ms (host work, casts, assembly)")
    assert launches == 2, f"whole_ip launches in the path: {launches}"
    assert ric == 0, f"the whole-solve path launched the Riccati kernel {ric} times"
    ref = report["phase2"]
    both = sol.converged & ref.converged
    dev = float((sol.U - ref.U).abs()[both].max())
    eq = float((sol.iterations == ref.iterations).float().mean())
    log(f"phase6 whole-solve path B={B_MAIN} N={N} float32: prepare_batch "
        f"{t_prep:.4f} s; whole_ip launches {launches}, riccati_lq launches {ric}; "
        f"max|U - U_phase2| on the jointly converged {dev:.3e}, equal iteration "
        f"counts {eq:.4f}")
    assert dev <= 5e-4, dev
    report["whole_ip"]["launches"] = launches
    phase6_soft(report, x0s)


def phase6_soft(report, x0s):
    """Golden softcon_active's controller at the flagship options on phase
    2's x0: the whole-solve kernel against the general path (the Riccati
    kernel every Newton step), float32."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda

    bounds = WHOLE_IP_BOUNDS["softcon_active"]
    whole = build_cstr_nmpc({**FLAGSHIP, "pallas_full": True}, torch.float32, bounds)
    general = build_cstr_nmpc(FLAGSHIP, torch.float32, bounds)
    args = whole.prepare_batch(x0s)
    for ctl in (whole, general):                          # untimed warm-up
        ctl.solve_batch_fn()(*[a[:256] for a in args])
    torch.cuda.synchronize()
    runs = {}
    for name, ctl in (("whole-solve kernel", whole), ("general path", general)):
        solve_ocp_full_cuda.launches = riccati_lq_cuda.launches = 0
        t0 = time.perf_counter()
        sol = ctl.solve_batch_fn()(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = (sol, solve_ocp_full_cuda.launches, riccati_lq_cuda.launches)
        conv = float(sol.converged.float().mean())
        log(f"phase6 softcon_active {name} B={B_MAIN} N={N} float32: "
            f"{B_MAIN / wall:.1f} solves/s ({wall:.4f} s wall), converged "
            f"{conv:.4f}, iterations p50 {float(sol.iterations.float().median()):g} "
            f"max {int(sol.iterations.max())}; whole_ip launches {runs[name][1]}, "
            f"riccati_lq launches {runs[name][2]}")
        assert sol.U.shape == (B_MAIN, N, 1) and bool(torch.isfinite(sol.U).all())
        assert conv >= 0.97, (name, conv)
    (sw, w_full, w_ric), (sg, g_full, g_ric) = runs.values()
    assert (w_full, w_ric) == (1, 0), (w_full, w_ric)
    # no Mehrotra at these options: one LQ solve per iteration of the loop
    assert g_full == 0 and g_ric == int(sg.iterations.max()), (g_full, g_ric)
    both = sw.converged & sg.converged
    dev = float((sw.U - sg.U).abs()[both].max())
    log(f"phase6 softcon_active: max|U_whole - U_general| on the jointly converged "
        f"{dev:.3e} ({float(both.float().mean()):.4f} of the scenarios)")
    assert dev <= 5e-4, dev
    report["whole_ip"]["soft_box_launches"] = w_full


def free_args(args):
    """The blocks of an LQ problem with dx0 taken out (the free-x0 mode)."""
    return tuple(args[:10]) + (None,)


def phase1_riccati_free_x0(report):
    """The free-x0 mode of both Riccati kernels (dx0=None) against the plain
    solve (ops/riccati.py:solve_lq, dx0 by torch.linalg.solve) on the card:
    the tiled kernel at MHE's (2, 2) on B=131072 and on a ragged last tile
    and chunk (B=131071, N=10 over chunks of 4), at (4, 2) and at the cap
    (8, 4) on a ragged tile; the wide variant at (9, 9) and (16, 16) on
    B=1001; both dtypes, lq_tol's tolerances. Timed at MHE's shape ((2, 2),
    B=131072, N=10, float32) and the wide variant at (16, 16), B=1024,
    float64, beside the bound without the dx0 read."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (riccati_lq_cuda,
                                                     riccati_lq_reference,
                                                     riccati_lq_wide_cuda)
    names = ("dX", "dU", "lam", "K", "kff", "cost_red")
    f32, f64 = torch.float32, torch.float64
    cases = [(riccati_lq_cuda, B_MAIN, 2, 2), (riccati_lq_cuda, 131071, 2, 2),
             (riccati_lq_cuda, 1000, 4, 2), (riccati_lq_cuda, 1001, 8, 4)]
    cases += [(riccati_lq_wide_cuda, 1001, nx, nu) for nx, nu in RICCATI_WIDE_FREE_SIZES]
    max_err = {riccati_lq_cuda: 0.0, riccati_lq_wide_cuda: 0.0}
    for kernel, Bt, nx, nu in cases:
        for dt in (f32, f64):
            args = free_args(lq_problem(Bt, N_MHE, nx, nu, dt, seed=9, convex=True))
            out = kernel(*args, reg=1e-8)
            ref = riccati_lq_reference(*args, reg=1e-8)
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in zip(names, out, ref):
                torch.testing.assert_close(a, b, **lq_tol(name, dt == f32))
                errs[name] = float((a - b).abs().max())
            max_err[kernel] = max(max_err[kernel], max(errs.values()))
            log(f"phase1 {kernel.__name__[:-5]} free x0 B={Bt} N={N_MHE} nx={nx} "
                f"nu={nu} {str(dt)[6:]}: max|kernel-plain| "
                + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
            del args, out, ref

    def timed(kernel, name, Bt, nx, nu, dt):
        args = free_args(lq_problem(Bt, N_MHE, nx, nu, dt, convex=True))
        run = lambda: kernel(*args, reg=1e-8)  # noqa: E731
        ms, b2b_ms = cuda_time_ms(run), cuda_time_ms(run, inner=INNER)
        plain_ms = cuda_time_ms(lambda: riccati_lq_reference(*args, reg=1e-8))
        nbytes, flops = riccati_lq_work(Bt, N_MHE, nx, nu, itemsize=8 if dt == f64 else 4,
                                        free_x0=True)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_FP64 if dt == f64 else PEAK_FP32)
        log(f"phase1 {name} B={Bt} N={N_MHE} nx={nx} nu={nu} {str(dt)[6:]}: kernel "
            f"{ms:.4f} ms one call, {b2b_ms:.4f} ms back to back ({INNER} calls per "
            f"run), plain {plain_ms:.4f} ms (median of 10 runs, CUDA events); bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / Bt:.0f} bytes per scenario, "
            f"{nbytes / 1e6:.1f} MB, no dx0 read): {b_ms / ms:.1%} of the bound one "
            f"call, {b_ms / b2b_ms:.1%} back to back")
        return dict(ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by)

    report["riccati_lq_free_x0"] = dict(
        max_abs_err=max_err[riccati_lq_cuda],
        **timed(riccati_lq_cuda, "riccati_lq free x0", B_MAIN, 2, 2, f32))
    report["riccati_lq_wide_free_x0"] = dict(
        max_abs_err=max_err[riccati_lq_wide_cuda],
        **timed(riccati_lq_wide_cuda, "riccati_lq_wide free x0", B_WIDE, 16, 16, f64))


def cstr_rk4_np(X, U, dt=0.1):
    """One RK4 step of the CSTR (p = ones(6)) for a batch of states (B, 2)
    and inputs (B, 1), in numpy."""
    import numpy as np

    def ode(X):
        r = (1.0 - X[:, 0]) * np.exp(-1.0 / (1.0 + X[:, 1]))
        return np.stack([-X[:, 0] + r, -X[:, 1] + r + U[:, 0]], axis=1)
    k1 = ode(X)
    k2 = ode(X + 0.5 * dt * k1)
    k3 = ode(X + 0.5 * dt * k2)
    k4 = ode(X + dt * k3)
    return X + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def mhe_cstr_windows(B, rows=N_MHE + 1, seed=0):
    """B realistic CSTR windows, the way __graft_entry__.py:136-152 makes
    them: plant runs by vectorised numpy RK4 from x0 = [0.2, 0.1] +
    0.03·N(0,1), inputs 0.2·sin + 0.05·N(0,1), x_2 measured with noise
    0.005·N(0,1), all from default_rng(seed). Row k pairs y_k with the input
    that produced x_k (the estimators' convention). Returns (Ys, Us, the
    arrival means: the true x0, the true state at the last row)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = np.array([0.2, 0.1]) + 0.03 * rng.standard_normal((B, 2))
    x0 = X.copy()
    Us = (0.2 * np.sin(np.linspace(0, 3, rows))[None, :, None]
          + 0.05 * rng.standard_normal((B, rows, 1)))
    Ys = np.zeros((B, rows, 1))
    for k in range(rows):
        if k:
            X = cstr_rk4_np(X, Us[:, k])
        Ys[:, k, 0] = X[:, 1] + 0.005 * rng.standard_normal(B)
    return Ys, Us, x0, X


def build_mhe(model, dtype, Q, R, P0, p=None, horizon=N_MHE, options=None):
    from hilo_mpc_tpu_torch import MHE
    mhe = MHE(model)
    mhe.horizon = horizon
    mhe.Q, mhe.R, mhe.P0 = Q, R, P0
    if p is not None:
        mhe.set_initial_parameter_values(p)
    mhe.setup(dt=0.1, options=options, device="cuda", dtype=dtype)
    return mhe


class count_calls:
    """Counts the calls of a module function for the length of a with block
    (the function is wrapped in the module and put back after)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def mhe_first_windows_plain(mhe, Ys, Us, x_arr, n):
    """The first n windows solved again with the plain LQ step."""
    import numpy as np
    from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp
    from hilo_mpc_tpu_torch.ops.riccati import make_plain_lq_solver
    theta = mhe._theta_batch(Ys[:n], Us[:n], x_arr[:n], mhe._p_vector(None))
    X_init = np.tile(x_arr[:n, None, :], (1, mhe.horizon + 1, 1))
    U_init = np.zeros((n, mhe.horizon, mhe.n_x))
    sol = solve_ocp(mhe._funcs, mhe._dims, mhe._bounds,
                    *(mhe._tensor(a) for a in (theta, x_arr[:n], X_init, U_init)),
                    options=mhe._ip_opts, fix_x0=False,
                    lq_solver=make_plain_lq_solver)
    return sol.X[:, -1, :mhe.n_x].cpu().numpy()


def mhe_wall_split(mhe, Ys, Us, x_arr):
    """One more estimate_batch call taken apart, host clock: the windows'
    theta in numpy, the four copies to the card (cast to the solver dtype),
    solve_ocp, x_est back to the host."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp
    B, n1 = Ys.shape[:2]
    t0 = time.perf_counter()
    theta = mhe._theta_batch(Ys, Us, x_arr, mhe._p_vector(None))
    X_init = np.tile(x_arr[:, None, :], (1, n1, 1))
    U_init = np.zeros((B, n1 - 1, mhe.n_x))
    t1 = time.perf_counter()
    dev = [mhe._tensor(a) for a in (theta, x_arr, X_init, U_init)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sol = solve_ocp(mhe._funcs, mhe._dims, mhe._bounds, *dev, options=mhe._ip_opts,
                    fix_x0=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sol.X[:, -1, :mhe.n_x].cpu().numpy()
    t4 = time.perf_counter()
    log(f"phase7 one call taken apart (host clock): theta in numpy {t1 - t0:.4f} s, "
        f"copies to the card {t2 - t1:.4f} s, solve_ocp {t3 - t2:.4f} s "
        f"({int(sol.iterations.max())} iterations), x_est back {t4 - t3:.4f} s")
    # the solve once more under torch.profiler (as tools/profile_torch_port.py
    # profiles NMPC)
    profile_solve("phase7 solve_ocp", lambda: solve_ocp(
        mhe._funcs, mhe._dims, mhe._bounds, *dev, options=mhe._ip_opts, fix_x0=False),
        int(sol.iterations.max()))


def phase7(report):
    """The MHE path at full width (module docstring)."""
    import numpy as np
    import scipy.linalg
    import torch
    from hilo_mpc_tpu_torch import Model
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    from hilo_mpc_tpu_torch.ops import riccati
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (riccati_lq_cuda,
                                                     riccati_lq_wide_cuda)

    mhe = build_mhe(cstr_schaffner_and_zeitz(), torch.float32, 1e-4, 1e-3,
                    0.1 * np.eye(2), p=[1.0] * 6)
    assert mhe.fast_path, "the CSTR measures x_2: the fast path"
    t0 = time.perf_counter()
    Ys, Us, x_arr, X_true = mhe_cstr_windows(B_MAIN)
    t_data = time.perf_counter() - t0
    mhe.estimate_batch(Ys, Us, x_arrivals=x_arr)            # untimed warm-up
    torch.cuda.synchronize()
    walls, runs = [], []
    for _ in range(3):
        riccati_lq_cuda.launches = riccati_lq_wide_cuda.launches = 0
        with count_calls(riccati, "backward_sweep") as sweeps:
            t0 = time.perf_counter()
            x_est, sol = mhe.estimate_batch(Ys, Us, x_arrivals=x_arr)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        iters = int(sol.iterations.max())
        runs.append((riccati_lq_cuda.launches, riccati_lq_wide_cuda.launches,
                     sweeps.calls, iters))
        assert runs[-1] == (iters, 0, 0, iters), (
            "launches, wide launches, plain backward sweeps, loop iterations", runs[-1])
    best = min(walls)
    conv = float(sol.converged.float().mean())
    assert x_est.shape == (B_MAIN, 2) and np.isfinite(x_est).all()
    rms = float(np.sqrt(np.mean((x_est - X_true) ** 2)))
    log(f"phase7 MHE CSTR B={B_MAIN} N={N_MHE} float32 (fast path, windows "
        f"made in {t_data:.2f} s): {B_MAIN / best:.1f} windows/s (best of 3: "
        f"{', '.join(f'{w:.4f}' for w in walls)} s wall), converged {conv:.4f}, "
        f"iterations p50 {float(sol.iterations.float().median()):g} max {iters}, "
        f"RMS(x_est - x_true) {rms:.3e}")
    log(f"phase7 riccati_lq launches per run {[r[0] for r in runs]} = loop "
        f"iterations {[r[3] for r in runs]}; plain backward sweeps "
        f"{[r[2] for r in runs]}")
    assert conv >= 0.97, f"converged fraction {conv}"
    mhe_wall_split(mhe, Ys, Us, x_arr)
    x_plain = mhe_first_windows_plain(mhe, Ys, Us, x_arr, 1024)
    dev = float(np.abs(x_est[:1024] - x_plain).max())
    log(f"phase7 first 1024 windows: max|x_est_kernel - x_est_plain| = {dev:.3e}")
    assert dev <= 5e-4, dev
    report["riccati_lq_free_x0"]["launches"] = runs[-1][0]

    # eight decoupled double integrators measured in position: nx = nu = 16,
    # the wide variant's free-x0 mode, float64 at B=1024
    A = scipy.linalg.block_diag(*[np.array(DI_A)] * N_DI)
    Bm = scipy.linalg.block_diag(*[np.array(DI_B)] * N_DI)
    C = np.kron(np.eye(N_DI), [[1.0, 0.0]])
    m = Model(name="di8", discrete=True).set_state_space(A=A, B=Bm, C=C)
    wide = build_mhe(m, torch.float64, 1e-4 * np.eye(2 * N_DI), 1e-3 * np.eye(N_DI),
                     0.1 * np.eye(2 * N_DI))
    rng = np.random.default_rng(8)
    X = rng.standard_normal((B_WIDE, 2 * N_DI))
    x0w = X.copy()
    Uw = 0.1 * rng.standard_normal((B_WIDE, N_MHE + 1, N_DI))
    Yw = np.zeros((B_WIDE, N_MHE + 1, N_DI))
    for k in range(N_MHE + 1):
        if k:
            X = X @ A.T + Uw[:, k] @ Bm.T + 1e-2 * rng.standard_normal(X.shape)
        Yw[:, k] = X @ C.T + 0.03 * rng.standard_normal((B_WIDE, N_DI))
    wide.estimate_batch(Yw, Uw, x_arrivals=x0w)              # untimed warm-up
    torch.cuda.synchronize()
    riccati_lq_cuda.launches = riccati_lq_wide_cuda.launches = 0
    with count_calls(riccati, "backward_sweep") as sweeps:
        t0 = time.perf_counter()
        xw, solw = wide.estimate_batch(Yw, Uw, x_arrivals=x0w)
        torch.cuda.synchronize()
        t_wide = time.perf_counter() - t0
    iters = int(solw.iterations.max())
    got = (riccati_lq_wide_cuda.launches, riccati_lq_cuda.launches, sweeps.calls)
    conv = float(solw.converged.float().mean())
    dev = float(np.abs(xw - mhe_first_windows_plain(wide, Yw, Uw, x0w, B_WIDE)).max())
    log(f"phase7 MHE eight double integrators (nx = nu = 16) B={B_WIDE} "
        f"N={N_MHE} float64: {B_WIDE / t_wide:.1f} windows/s ({t_wide:.4f} s "
        f"wall), converged {conv:.4f}, iterations max {iters}, RMS(x_est - "
        f"x_true) {float(np.sqrt(np.mean((xw - X) ** 2))):.3e}; riccati_lq_wide "
        f"launches {got[0]}, riccati_lq {got[1]}, plain backward sweeps "
        f"{got[2]}; max|x_est_kernel - x_est_plain| = {dev:.3e}")
    assert got == (iters, 0, 0), got
    assert conv >= 0.97 and dev <= 5e-4, (conv, dev)
    report["riccati_lq_wide_free_x0"]["launches"] = got[0]


def golden_mhe(device, dtype):
    """The port's twin of tests/golden_configs.py:build_mhe_cstr."""
    import numpy as np
    from hilo_mpc_tpu_torch import MHE
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    mhe = MHE(cstr_schaffner_and_zeitz())
    mhe.horizon = 8
    mhe.Q, mhe.R, mhe.P0 = 1e-3 * np.eye(2), np.array([[1e-4]]), 0.05 * np.eye(2)
    mhe.set_initial_parameter_values([1.0] * 6)
    mhe.setup(dt=0.1, options={"integration_method": "rk4", "tol": 1e-9,
                               "max_iter": 80}, device=device, dtype=dtype)
    mhe.set_initial_guess([0.25, 0.08])
    return mhe


def phase8():
    """Golden MHE replay in float64 on the card."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    data = np.load(GOLDEN_MHE)
    gold = {int(k): data["Xest_gold"][i] for i, k in enumerate(data["est_steps"])}
    mhe = golden_mhe("cuda", torch.float64)
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    devs = []
    for k, (y, u) in enumerate(zip(data["Ys"], data["Us"])):
        est = mhe.estimate(y=y, u=u)
        if est is None:
            assert k not in gold
            continue
        assert mhe.stats["converged"], (k, mhe.stats)
        devs.append(float(np.abs(est - gold[k]).max()))
    dt = time.perf_counter() - t0
    assert len(devs) == len(gold) and riccati_lq_cuda.launches > n0
    log(f"phase8 golden mhe_cstr float64: {len(devs)} estimates in {dt:.2f} s, "
        f"max|x_est - x_gold| = {max(devs):.3e}, riccati_lq launches "
        f"{riccati_lq_cuda.launches - n0}")
    assert max(devs) < 1e-4, devs


def phase9():
    """The filters on the card against the CPU, float64."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import EKF, PF, UKF
    from hilo_mpc_tpu_torch.estimation.pf import lhsnorm
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    f64 = torch.float64
    data = np.load(GOLDEN_MHE)
    Ys, Us = data["Ys"], data["Us"]
    # the UKF's default alpha = 1e-3 weights its means by ~1e6 that cancel
    # to one: another summation order on the card moves them by ~1e6 ulps,
    # so it takes 1e-8 where the EKF takes 1e-9
    for cls, tol in ((EKF, 1e-9), (UKF, 1e-8)):
        runs = []
        for device in ("cpu", "cuda"):
            f = cls(cstr_schaffner_and_zeitz())
            f.Q, f.R = 1e-3 * np.eye(2), np.array([[1e-4]])
            f.set_initial_parameter_values([1.0] * 6)
            f.setup(dt=0.1, device=device, dtype=f64)
            f.set_initial_guess([0.25, 0.08], P0=0.05 * np.eye(2))
            t0 = time.perf_counter()
            f.estimate(Ys, u=Us)
            runs.append((f, time.perf_counter() - t0))
        dev = {k: float(np.abs(runs[1][0].solution[k] - runs[0][0].solution[k]).max())
               for k in ("x", "P")}
        log(f"phase9 {cls.__name__} CSTR float64, {Ys.shape[0]} steps: card "
            f"{runs[1][1]:.3f} s, CPU {runs[0][1]:.3f} s; max|card - CPU| x "
            f"{dev['x']:.3e}, P {dev['P']:.3e}")
        assert max(dev.values()) <= tol, dev

    M = 4096
    out = []
    for device in ("cpu", "cuda"):
        kw = dict(dtype=f64, device=device)
        pf = PF(cstr_schaffner_and_zeitz(), n_particles=M, roughening=True)
        pf.Q, pf.R = 1e-4 * np.eye(2), np.array([[1e-4]])
        pf.setup(dt=0.1, device=device, dtype=f64)
        parts = torch.as_tensor(lhsnorm([0.25, 0.08], 0.05 * np.eye(2), M), **kw)
        draws = np.random.default_rng(9)          # the draws, made on the CPU
        p = torch.ones(6, **kw)
        for k in range(Ys.shape[0]):
            parts, x, _ = pf.step_draws(
                parts, torch.as_tensor(Us[k], **kw), p, torch.as_tensor(Ys[k], **kw),
                0.1 * k, torch.as_tensor(draws.standard_normal((M, 2)), **kw),
                torch.as_tensor(draws.random(), **kw),
                torch.as_tensor(draws.standard_normal((M, 2)), **kw))
        out.append((parts.cpu().numpy(), x.cpu().numpy()))
    dev_p = float(np.abs(out[1][0] - out[0][0]).max())
    dev_x = float(np.abs(out[1][1] - out[0][1]).max())
    log(f"phase9 PF CSTR float64, {M} particles, {Ys.shape[0]} steps with draws "
        f"made on the CPU: max|card - CPU| particles {dev_p:.3e}, x_est {dev_x:.3e}")
    assert max(dev_p, dev_x) <= 1e-9, (dev_p, dev_x)


def msd_nmpc(dtype, device="cuda"):
    """The controller of tools/tpu_validation.py:55-80 (nmpc_soft_and_custom):
    a mass-spring-damper given as callables, N=20, NMPC defaults, soft
    |pos| <= 1 and the hard stage row pos + 0.2 vel <= 1.05."""
    import numpy as np
    from hilo_mpc_tpu_torch import NMPC, Model
    m = Model(name="msd")
    m.set_dynamical_states(["pos", "vel"])
    m.set_inputs("f")
    m.set_dynamical_equations(
        lambda x, u: [x[..., 1], -0.5 * x[..., 0] - 0.2 * x[..., 1] + u[..., 0]])
    nmpc = NMPC(m)
    nmpc.horizon = 20
    nmpc.quad_stage_cost.add_states(weights=[4.0, 1.0], ref=[0.9, 0.0])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-3.0], u_ub=[3.0], x_ub=[1.0, np.inf],
                             x_lb=[-1.0, -np.inf], x_soft=True)
    nmpc.add_stage_constraint(lambda x, u: x[..., 0] + 0.2 * x[..., 1], ub=[1.05], n=1)
    nmpc.setup(options={"dt": 0.1}, device=device, dtype=dtype)
    return nmpc


def cstr_terminal_eq_nmpc(dtype, device="cuda"):
    """The CSTR tracking controller with the terminal equality x_N[0] = 0.3,
    N=15, NMPC defaults but max_iter 80 (the augmented Lagrangian's outer
    updates need more than 40 iterations on part of the batch)."""
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 15
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_parameters([1.0] * 6)
    nmpc.add_terminal_constraint(lambda x: x[..., 0], lb=0.3, ub=0.3, n=1)
    nmpc.setup(options={"dt": 0.1, "max_iter": 80}, device=device, dtype=dtype)
    return nmpc


def profile_solve(label, solve, iterations):
    """One solve under torch.profiler: wall, device busy time by kernel
    name, idle share, kernel launches per iteration of the loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "self_device_time_total", None) or e.self_cuda_time_total,
                    e.count, e.key) for e in prof.key_averages()
                   if "CUDA" in str(e.device_type)), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    n = sum(r[1] for r in rows)
    log(f"{label} profiled: wall {wall * 1e3:.2f} ms (profiler on), "
        f"device busy {busy:.2f} ms, idle share {1 - busy / (wall * 1e3):.3f}, "
        f"{n} kernel launches, {n / max(iterations, 1):.0f} per iteration; by "
        f"device time: " + "; ".join(f"{t / 1e3:.3f} ms x{c} {k[:60]}"
                                     for t, c, k in rows[:6]))


def phase10(report):
    """The constrained general path (module docstring)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops import riccati
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (riccati_lq_cuda,
                                                     riccati_lq_wide_cuda)
    from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp
    from hilo_mpc_tpu_torch.ops.riccati import make_plain_lq_solver

    # (a) soft and custom constraints at full width
    nmpc = msd_nmpc(torch.float32)
    d = nmpc._dims
    assert (d.n_h, d.n_hN, d.n_e, d.n_eN) == (1, 0, 0, 0), d
    assert not nmpc._ip_opts.const_cost_hessian
    x0s = 0.2 * np.random.default_rng(1).standard_normal((B_MAIN, 2))
    nmpc.solve_batch_fn()(*nmpc.prepare_batch(x0s[:256]))     # untimed warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = nmpc.prepare_batch(x0s)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    riccati_lq_cuda.launches = riccati_lq_wide_cuda.launches = 0
    with count_calls(riccati, "backward_sweep") as sweeps:
        t0 = time.perf_counter()
        sol = nmpc.solve_batch_fn()(*args)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
    launches = riccati_lq_cuda.launches
    loops = int(sol.iterations.max())
    # Mehrotra (on by default, no equality rows): predictor and corrector,
    # two Newton steps per iteration of the loop
    steps = 2 * loops
    conv = float(sol.converged.float().mean())
    assert sol.U.shape == (B_MAIN, 20, 1) and bool(torch.isfinite(sol.U).all())
    log(f"phase10 msd soft |pos| <= 1 + hard pos + 0.2 vel <= 1.05, B={B_MAIN} "
        f"N=20 float32, NMPC defaults: prepare_batch {t_prep:.4f} s; cold "
        f"{B_MAIN / t_cold:.1f} solves/s ({t_cold:.4f} s wall), converged {conv:.4f}, "
        f"iterations p50 {float(sol.iterations.float().median()):g} max {loops}; "
        f"riccati_lq launches {launches} = Newton steps {steps} (2 per iteration), "
        f"riccati_lq_wide {riccati_lq_wide_cuda.launches}, plain backward sweeps "
        f"{sweeps.calls}")
    assert conv >= 0.99, f"converged fraction {conv}"
    assert (launches, riccati_lq_wide_cuda.launches, sweeps.calls) == (steps, 0, 0)
    X = sol.X[sol.converged].float()
    pos, vel = X[:, 1:, 0], X[:, 1:, 1]
    log(f"phase10 msd: max pos {float(pos.max()):.4f} (soft bound 1), max "
        f"pos + 0.2 vel {float((pos + 0.2 * vel).max()):.5f} (hard row 1.05)")
    assert float((pos + 0.2 * vel).max()) <= 1.05 + 1e-3
    # the first 1024 scenarios with the plain LQ step: in float64 the two
    # routes agree to roundoff. In float32 each stops at its own point with
    # KKT error <= 1e-4 (the float32 default tolerance; float64's is 1e-6),
    # and the objective is flat enough along U there that two such points
    # lie up to ~1e-2 apart (objectives equal to ~1e-5 relative), so the
    # kernel is held to the plain version's stray from the float64 answer
    # plus 5e-4, as phase 1 holds active state bounds
    sub = tuple(a[:1024] for a in args)
    plain = {}
    for dt in (torch.float32, torch.float64):
        ctl = nmpc if dt == torch.float32 else msd_nmpc(dt)
        sub_dt = tuple(a.to(dt) for a in sub)
        plain[dt] = solve_ocp(ctl._funcs, ctl._dims, ctl._bounds, *sub_dt,
                              options=ctl._ip_opts, mu0=ctl._ip_opts.mu_init,
                              lq_solver=make_plain_lq_solver)
        if dt == torch.float64:
            k64 = ctl.solve_batch_fn()(*sub_dt)
    p32, p64 = plain[torch.float32], plain[torch.float64]
    dev64 = float((k64.U - p64.U).abs().max())
    j = sol.converged[:1024] & p32.converged & p64.converged
    dev = float((sol.U[:1024] - p32.U).abs()[j].max())
    stray = float((p32.U.double() - p64.U).abs()[j].max())
    off = float((sol.U[:1024].double() - p64.U).abs()[j].max())
    log(f"phase10 msd first 1024 scenarios: float64 max|U_kernel - U_plain| "
        f"{dev64:.3e} (equal iterations {bool(torch.equal(k64.iterations, p64.iterations))}); "
        f"float32 max|U_kernel - U_plain| {dev:.3e}, max|U - U_plain_f64| float32 "
        f"plain {stray:.3e}, float32 kernel {off:.3e}")
    assert dev64 <= 1e-9, dev64
    assert off <= stray + 5e-4, (off, stray)
    profile_solve("phase10 msd cold solve", lambda: nmpc.solve_batch_fn()(*args), loops)

    # (b) the augmented Lagrangian: card against CPU in float64, float32 told
    x0c = flagship_x0s(B_CPU_CHECK)
    sols = {}
    for dev_, dt in (("cpu", torch.float64), ("cuda", torch.float64),
                     ("cuda", torch.float32)):
        ctl = cstr_terminal_eq_nmpc(dt, device=dev_)
        assert (ctl._dims.n_eN, ctl._dims.n_e) == (1, 0)
        riccati_lq_cuda.launches = 0
        t0 = time.perf_counter()
        s_ = ctl.solve_batch_fn()(*ctl.prepare_batch(x0c))
        if dev_ == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sols[(dev_, dt)] = s_
        log(f"phase10 CSTR x_N[0] = 0.3 N=15 B={B_CPU_CHECK} {dev_} {str(dt)[6:]}: "
            f"{wall:.4f} s wall, converged {float(s_.converged.float().mean()):.4f}, "
            f"iterations p50 {float(s_.iterations.float().median()):g} max "
            f"{int(s_.iterations.max())}, riccati_lq launches {riccati_lq_cuda.launches}")
    c64, k64, k32 = (sols[k] for k in (("cpu", torch.float64), ("cuda", torch.float64),
                                       ("cuda", torch.float32)))
    assert float(c64.converged.float().mean()) >= 0.97
    assert torch.equal(k64.iterations.cpu(), c64.iterations)
    dev64 = float((k64.U.cpu() - c64.U).abs().max())
    both = (k32.converged & k64.converged).cpu()
    dev32 = float((k32.U.cpu().double() - c64.U).abs()[both].max()) if both.any() else float("nan")
    term = float((k64.X[:, -1, 0] - 0.3).abs()[k64.converged].max())
    log(f"phase10 CSTR x_N[0] = 0.3: max|U_card - U_cpu| float64 {dev64:.3e}, "
        f"max|x_N[0] - 0.3| {term:.3e}; float32 (not asserted): converged "
        f"{float(k32.converged.float().mean()):.4f}, max|U_f32 - U_f64| on the "
        f"jointly converged {dev32:.3e}")
    assert dev64 <= 1e-9, dev64

    # (c) golden softcon_active on the card in float64
    data = np.load(GOLDEN_SOFTCON)
    X_meas, U_gold = data["X_meas"], data["U_gold"]
    gold = build_cstr_nmpc({"tol": 1e-9, "max_iter": 80}, torch.float64,
                           WHOLE_IP_BOUNDS["softcon_active"], horizon=15)
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    devs = []
    for k in range(golden_steps(data)):
        u = gold.optimize(X_meas[k])
        devs.append(float(np.abs(u - U_gold[k]).max()))
        assert gold.stats["converged"], (k, gold.stats)
    assert riccati_lq_cuda.launches > n0
    log(f"phase10 golden softcon_active float64: {len(devs)} steps in "
        f"{time.perf_counter() - t0:.2f} s, max|u - u_gold| = {max(devs):.3e}")
    assert max(devs) < 1e-4, devs
    report["phase10"] = dict(converged=conv, solves_per_s=B_MAIN / t_cold)


def phase11(report):
    """The augmented formulations (module docstring)."""
    phase11_du(report)
    phase11_pathfollow(report)
    phase11_mintime(report)
    phase11_goldens()


def shifted(sol, xs0_B):
    """The warm start of phase 2: the solution shifted by one stage."""
    import torch
    X_w = torch.cat([sol.X[:, 1:], sol.X[:, -1:]], dim=1)
    X_w[:, 0] = xs0_B
    return X_w, torch.cat([sol.U[:, 1:], sol.U[:, -1:]], dim=1)


def phase11_du(report):
    """(a) Phase 2's flagship with the Δu term and bounds, each scenario's
    u_prev through prepare_batch(u_prev=), through the general path (the
    Riccati kernel at (3, 1)) and the whole-solve kernel (its CROSS build),
    cold and warm."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp
    from hilo_mpc_tpu_torch.ops.riccati import make_plain_lq_solver
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda

    f32 = torch.float32
    general = build_du_nmpc(FLAGSHIP, f32)
    whole = build_du_nmpc({**FLAGSHIP, "pallas_full": True}, f32)
    assert general._augment_du and (general._dims.nx, general._dims.nu) == (3, 1)
    x0s, u_prev = flagship_x0s(), du_u_prev()
    for ctl in (general, whole):                              # untimed warm-up
        ctl.solve_batch_fn()(*ctl.prepare_batch(x0s[:256], u_prev=u_prev[:256]))
    torch.cuda.synchronize()
    runs = {}
    for name, ctl in (("general path", general), ("whole-solve kernel", whole)):
        riccati_lq_cuda.launches = solve_ocp_full_cuda.launches = 0
        t0 = time.perf_counter()
        args = ctl.prepare_batch(x0s, u_prev=u_prev)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        t0 = time.perf_counter()
        sol = ctl.solve_batch_fn()(*args)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        X_w, U_w = shifted(sol, args[1])
        t0 = time.perf_counter()
        sol_w = ctl.solve_batch_fn(warm=True)(args[0], args[1], X_w, U_w)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        counts = (riccati_lq_cuda.launches, solve_ocp_full_cuda.launches)
        runs[name] = (args, sol, counts)
        for kind, s_, t in (("cold", sol, t_cold), ("warm", sol_w, t_warm)):
            assert s_.U.shape == (B_MAIN, N, 1) and s_.X.shape == (B_MAIN, N + 1, 3)
            assert bool(torch.isfinite(s_.U).all()) and bool(torch.isfinite(s_.X).all())
            conv = float(s_.converged.float().mean())
            log(f"phase11(a) Δu CSTR {name} B={B_MAIN} N={N} float32 {kind}: "
                f"{B_MAIN / t:.1f} solves/s ({t:.4f} s wall), converged {conv:.4f}, "
                f"iterations p50 {float(s_.iterations.float().median()):g} max "
                f"{int(s_.iterations.max())}")
            assert conv >= 0.97, (name, kind, conv)
        log(f"phase11(a) {name}: prepare_batch {t_prep:.4f} s; riccati_lq launches "
            f"{counts[0]}, whole_ip launches {counts[1]}")
        # u_prev rides in the state: the Δu bounds hold against it
        du0 = (sol.X[:, 1, 2] - args[1][:, 2])[sol.converged]
        assert float(du0.abs().max()) <= 0.5 + 1e-4
    (ga, gs, (g_ric, g_full)), (_, ws, (w_ric, w_full)) = runs.values()
    assert g_ric > 0 and g_full == 0, (g_ric, g_full)
    assert (w_ric, w_full) == (0, 2), (w_ric, w_full)
    # the two routes in float32 each stop at a point with KKT error <= 1e-4;
    # on the scenarios where the general path stops one iteration early the
    # objective is flat enough along U that the two points lie up to ~1.5e-3
    # apart (the host build at B=4096), both as far from the float64
    # answer. So the whole-solve kernel is held to the general path's stray
    # from the float64 answer plus 5e-4, as phase 10 holds its kernel
    both = gs.converged & ws.converged
    gap = (ws.U - gs.U).abs().amax(dim=(1, 2))[both]
    dev = float(gap.max())
    n64 = build_du_nmpc(FLAGSHIP, torch.float64)
    g64 = n64.solve_batch_fn()(*[a.double() for a in ga])
    j = both & g64.converged
    stray = float((gs.U.double() - g64.U).abs()[j].max())
    off = float((ws.U.double() - g64.U).abs()[j].max())
    log(f"phase11(a): max|U_whole - U_general| on the jointly converged {dev:.3e} "
        f"({float(both.float().mean()):.4f} of the scenarios; above 5e-4 in "
        f"{int((gap > 5e-4).sum())}, equal iterations in "
        f"{float((ws.iterations == gs.iterations).float().mean()):.4f}); against the "
        f"float64 general path: general {stray:.3e}, whole-solve {off:.3e}")
    assert off <= stray + 5e-4, (off, stray)
    # the first 1024 scenarios with the plain LQ step in place of the kernel,
    # in float64 (equal iterations, 1e-9) and float32 (reported)
    sub = tuple(a[:1024].double() for a in ga)
    ref = solve_ocp(n64._funcs, n64._dims, n64._bounds, *sub, options=n64._ip_opts,
                    mu0=n64._ip_opts.mu_init, lq_solver=make_plain_lq_solver)
    dev64 = float((g64.U[:1024] - ref.U).abs().max())
    sub32 = tuple(a[:1024] for a in ga)
    ref32 = solve_ocp(general._funcs, general._dims, general._bounds, *sub32,
                      options=general._ip_opts, mu0=general._ip_opts.mu_init,
                      lq_solver=make_plain_lq_solver)
    dev32 = float((gs.U[:1024] - ref32.U).abs().max())
    log(f"phase11(a) first 1024 scenarios: max|U_kernel - U_plain| float64 {dev64:.3e} "
        f"(equal iterations {bool(torch.equal(g64.iterations[:1024], ref.iterations))}), "
        f"float32 {dev32:.3e}")
    assert torch.equal(g64.iterations[:1024], ref.iterations) and dev64 <= 1e-9, dev64
    report["whole_ip_cross"]["launches"] = w_full
    report["riccati_lq"].setdefault("phase11_launches", {})["du_general"] = g_ric


def phase11_pathfollow(report):
    """(b) Golden pathfollow_soft's controller at B=131072, float32, NMPC
    defaults but max_iter 80: the general path through the Riccati kernel
    at (3, 3), soft rows and convexify; under pure Newton steps pallas_full
    takes the whole-solve kernel (phase 14(b) measures that route)."""
    import warnings

    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops import riccati
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.ops.ip_solver import solve_ocp
    from hilo_mpc_tpu_torch.ops.riccati import make_plain_lq_solver

    opts = {"dt": 0.1, "max_iter": 80}
    nmpc = pathfollow_nmpc(opts, torch.float32)
    assert (nmpc._dims.nx, nmpc._dims.nu) == (3, 3) and nmpc._path_following
    x0s = 0.1 * np.random.default_rng(3).standard_normal((B_MAIN, 2))
    nmpc.solve_batch_fn()(*nmpc.prepare_batch(x0s[:256]))   # untimed warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = nmpc.prepare_batch(x0s)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    riccati_lq_cuda.launches = 0
    with count_calls(riccati, "backward_sweep") as sweeps:
        t0 = time.perf_counter()
        sol = nmpc.solve_batch_fn()(*args)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
    launches, loops = riccati_lq_cuda.launches, int(sol.iterations.max())
    conv = float(sol.converged.float().mean())
    assert sol.U.shape == (B_MAIN, 12, 3) and bool(torch.isfinite(sol.U).all())
    log(f"phase11(b) pathfollow_soft B={B_MAIN} N=12 float32: prepare_batch "
        f"{t_prep:.4f} s; cold {B_MAIN / t_cold:.1f} solves/s ({t_cold:.4f} s wall), "
        f"converged {conv:.4f}, iterations p50 {float(sol.iterations.float().median()):g} "
        f"max {loops}; riccati_lq launches {launches} = Newton steps {2 * loops} "
        f"(Mehrotra: 2 per iteration), plain backward sweeps {sweeps.calls}")
    assert conv >= 0.97, conv
    assert (launches, sweeps.calls) == (2 * loops, 0), (launches, sweeps.calls)
    th = sol.X[sol.converged][:, 1:, 2]
    log(f"phase11(b): path parameter after one step p50 "
        f"{float(th[:, 0].median()):.4f}, at the horizon's end max {float(th[:, -1].max()):.4f}")
    # the first 1024 scenarios in float64: the kernel against the plain LQ step
    n64 = pathfollow_nmpc(opts, torch.float64)
    sub = tuple(a[:1024].double() for a in args)
    k64 = n64.solve_batch_fn()(*sub)
    p64 = solve_ocp(n64._funcs, n64._dims, n64._bounds, *sub, options=n64._ip_opts,
                    mu0=n64._ip_opts.mu_init, lq_solver=make_plain_lq_solver)
    dev64 = float((k64.U - p64.U).abs().max())
    log(f"phase11(b) first 1024 scenarios float64: max|U_kernel - U_plain| {dev64:.3e} "
        f"(equal iterations {bool(torch.equal(k64.iterations, p64.iterations))})")
    assert torch.equal(k64.iterations, p64.iterations) and dev64 <= 1e-9, dev64
    # pallas_full under pure Newton steps takes the whole-solve kernel (the
    # traced route), without a warning: one launch, no Riccati launch
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda
    pf = pathfollow_nmpc({**PF_NEWTON, "pallas_full": True}, torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = pf.solve_batch_fn()
    solve_ocp_full_cuda.launches = riccati_lq_cuda.launches = 0
    s_pf = fn(*pf.prepare_batch(x0s[:1024]))
    torch.cuda.synchronize()
    log(f"phase11(b) pallas_full under pure Newton steps: whole_ip launches "
        f"{solve_ocp_full_cuda.launches}, riccati_lq launches "
        f"{riccati_lq_cuda.launches}, converged {float(s_pf.converged.float().mean()):.4f}")
    assert (solve_ocp_full_cuda.launches, riccati_lq_cuda.launches) == (1, 0)
    report["riccati_lq"].setdefault("phase11_launches", {})["pathfollow"] = launches
    report["phase11_pathfollow"] = dict(converged=conv, solves_per_s=B_MAIN / t_cold)
    # path following with an implicit step: the path state emitted around the
    # collocation step, through both routes
    label = "phase11(b) path following under Radau collocation d=2"
    two_routes(label, lambda dt, o: path_colloc_nmpc({**FLAGSHIP, **(o or {})}, dt),
               flagship_x0s(B_LAST), report, check_plain=False)
    report["whole_ip_path_implicit"]["launches"] = report[label]["launches"]


def phase11_mintime(report):
    """(c) Golden mintime's controller at B=4096, float64: the card against
    the CPU on the first B_CPU_CHECK scenarios; the converged fraction and
    the optimal dt."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

    Bt = 4096
    rng = np.random.default_rng(11)
    x0s = np.array([-1.0, 0.0]) + np.array([0.25, 0.15]) * rng.standard_normal((Bt, 2))
    card = mintime_nmpc(torch.float64)
    assert (card._dims.nx, card._dims.nu, card._dims.n_eN) == (3, 2, 2)
    riccati_lq_cuda.launches = 0
    t0 = time.perf_counter()
    sol = card.solve_batch_fn()(*card.prepare_batch(x0s))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = riccati_lq_cuda.launches
    conv = float(sol.converged.float().mean())
    dt = sol.X[:, -1, -1][sol.converged]
    log(f"phase11(c) mintime B={Bt} N=16 float64: {Bt / wall:.1f} solves/s "
        f"({wall:.4f} s wall), converged {conv:.4f}, iterations p50 "
        f"{float(sol.iterations.float().median()):g} max {int(sol.iterations.max())}, "
        f"riccati_lq launches {launches}; optimal dt {float(dt.min()):.5f} .. "
        f"{float(dt.max()):.5f} (bounds 0.02 .. 0.6), final time "
        f"{16 * float(dt.min()):.4f} .. {16 * float(dt.max()):.4f}")
    assert launches > 0 and conv >= 0.97, (launches, conv)
    assert float(dt.min()) >= 0.02 - 1e-9 and float(dt.max()) <= 0.6 + 1e-9
    cpu = mintime_nmpc(torch.float64, device="cpu")
    t0 = time.perf_counter()
    ref = cpu.solve_batch_fn()(*cpu.prepare_batch(x0s[:B_CPU_CHECK]))
    t_cpu = time.perf_counter() - t0
    dev = float((sol.U[:B_CPU_CHECK].cpu() - ref.U).abs().max())
    eq = bool(torch.equal(sol.iterations[:B_CPU_CHECK].cpu(), ref.iterations))
    log(f"phase11(c) first {B_CPU_CHECK} scenarios: card against CPU max|ΔU| {dev:.3e}, equal "
        f"iterations {eq} (CPU {t_cpu:.2f} s)")
    assert eq and dev <= 1e-9, dev
    report["riccati_lq"].setdefault("phase11_launches", {})["mintime"] = launches


def phase11_goldens():
    """(d) Goldens du_tracking, pathfollow_soft and mintime through
    NMPC.optimize in float64 on the card."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    f64 = torch.float64
    cases = (("du_tracking", GOLDEN_DU, lambda: build_du_nmpc(
                 {"tol": 1e-9, "max_iter": 80}, f64, horizon=15)),
             ("pathfollow_soft", GOLDEN_PF, lambda: pathfollow_nmpc(
                 {"dt": 0.1, "tol": 1e-9, "max_iter": 80}, f64)),
             ("mintime", GOLDEN_MT, lambda: mintime_nmpc(f64)))
    for name, path, build in cases:
        data = np.load(path)
        ctl = build()
        n0 = riccati_lq_cuda.launches
        t0 = time.perf_counter()
        devs = []
        for k in range(golden_steps(data)):
            u = ctl.optimize(data["X_meas"][k])
            assert ctl.stats["converged"], (name, k, ctl.stats)
            devs.append(float(np.abs(u - data["U_gold"][k]).max()))
        assert riccati_lq_cuda.launches > n0
        log(f"phase11(d) golden {name} float64: {len(devs)} steps in "
            f"{time.perf_counter() - t0:.2f} s, max|u - u_gold| = {max(devs):.3e}")
        assert max(devs) < 1e-4, (name, devs)


# golden dae_colloc's model (tests/golden_configs.py:build_dae_colloc):
# x' = -x + z + u, 0 = z - 0.5 x - DAE_ALPHA z²
DAE_ALPHA = 0.05
DAE_OPTS = {"dt": 0.1, "integration_method": "collocation", "degree": 3,
            "tol": 1e-9, "max_iter": 80}
SEBORG_P = {"q_0": 100.0, "V": 100.0, "C_Af": 1.0, "k_0": 7.2e10, "E": 72750.0,
            "T_f": 350.0, "DeltaH_r": -5e4, "rho": 1000.0, "C_p": 0.239, "UA": 5e4,
            "tau": 2.0}


def dae_model():
    from hilo_mpc_tpu_torch import Model
    m = Model(name="dae")
    m.set_dynamical_states("x")
    m.set_algebraic_states("z")
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, z, u: -x + z + u)
    m.set_algebraic_equations(lambda x, z: z - 0.5 * x - DAE_ALPHA * z ** 2)
    return m


def dae_nmpc(dtype, device="cuda", options=None):
    """Golden dae_colloc's controller (N=12, Radau degree 3, |u| <= 2, the
    NMPC defaults at tol 1e-9, max_iter 80)."""
    from hilo_mpc_tpu_torch import NMPC
    nmpc = NMPC(dae_model())
    nmpc.horizon = 12
    nmpc.quad_stage_cost.add_states(weights=[10.0], ref=[0.5])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    nmpc.setup(options={**DAE_OPTS, **(options or {})}, device=device, dtype=dtype)
    return nmpc


def timed_batch(ctl, x0s, warm=False):
    """prepare_batch and one cold solve (and a warm one from its shift),
    each timed to the card's end: (args, cold, warm, seconds by part)."""
    import torch
    t0 = time.perf_counter()
    args = ctl.prepare_batch(x0s)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = ctl.solve_batch_fn()(*args)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    sol_w, t_warm = None, None
    if warm:
        X_w, U_w = shifted(sol, args[1])
        t0 = time.perf_counter()
        sol_w = ctl.solve_batch_fn(warm=True)(args[0], args[1], X_w, U_w)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
    return args, sol, sol_w, (t_prep, t_cold, t_warm)


def card_vs_cpu(label, build, x0s, tol=1e-9):
    """The same controller on the card and on the CPU in float64: max|ΔU|
    (<= tol) with equal iterations."""
    import torch
    sols, walls = {}, {}
    for dev in ("cpu", "cuda"):
        ctl = build(dev)
        t0 = time.perf_counter()
        sols[dev] = ctl.solve_batch_fn()(*ctl.prepare_batch(x0s))
        if dev == "cuda":
            torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    c, k = sols["cpu"], sols["cuda"]
    dev_u = float((k.U.cpu() - c.U).abs().max())
    same_it = bool(torch.equal(k.iterations.cpu(), c.iterations))
    log(f"{label} float64 B={x0s.shape[0]}: card {walls['cuda']:.3f} s, CPU "
        f"{walls['cpu']:.3f} s; converged {float(c.converged.float().mean()):.4f}, "
        f"iterations p50 {float(c.iterations.float().median()):g} max "
        f"{int(c.iterations.max())}; max|U_card - U_cpu| {dev_u:.3e}, equal "
        f"iterations {same_it}")
    assert same_it and dev_u <= tol, (label, dev_u, same_it)
    return c


def phase12(report):
    """Implicit integration (module docstring)."""
    phase12_colloc_flagship(report)
    phase12_dae(report)
    phase12_fleet()
    phase12_filters()


def phase12_colloc_flagship(report):
    """(a) The flagship under Radau collocation of degree 3."""
    import torch
    from hilo_mpc_tpu_torch.ops import riccati
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda, riccati_lq_wide_cuda
    f32, f64 = torch.float32, torch.float64
    colloc = COLLOC_FLAGSHIP
    ctl = build_cstr_nmpc(colloc, f32)
    x0s = flagship_x0s()
    ctl.solve_batch_fn()(*ctl.prepare_batch(x0s[:256]))       # untimed warm-up
    torch.cuda.synchronize()
    riccati_lq_cuda.launches = riccati_lq_wide_cuda.launches = 0
    with count_calls(riccati, "backward_sweep") as sweeps:
        args, sol, sol_w, (t_prep, t_cold, t_warm) = timed_batch(ctl, x0s, warm=True)
    launches = riccati_lq_cuda.launches
    steps = int(sol.iterations.max()) + int(sol_w.iterations.max())
    for kind, s_, t in (("cold", sol, t_cold), ("warm", sol_w, t_warm)):
        assert s_.U.shape == (B_MAIN, N, 1) and bool(torch.isfinite(s_.U).all())
        conv = float(s_.converged.float().mean())
        log(f"phase12(a) CSTR Radau collocation d=3 B={B_MAIN} N={N} float32 {kind}: "
            f"{B_MAIN / t:.1f} solves/s ({t:.4f} s wall), converged {conv:.4f}, "
            f"iterations p50 {float(s_.iterations.float().median()):g} max "
            f"{int(s_.iterations.max())}")
        assert conv >= 0.97, (kind, conv)
    log(f"phase12(a) wall: prepare_batch {t_prep:.4f} s, cold {t_cold:.4f} s, warm "
        f"{t_warm:.4f} s; riccati_lq launches {launches} = Newton steps {steps}, "
        f"riccati_lq_wide {riccati_lq_wide_cuda.launches}, plain backward sweeps "
        f"{sweeps.calls}")
    assert (launches, riccati_lq_wide_cuda.launches, sweeps.calls) == (steps, 0, 0)
    profile_solve("phase12(a) cold solve", lambda: ctl.solve_batch_fn()(*args),
                  int(sol.iterations.max()))
    # against the RK4 flagship: the two integrators agree to their truncation
    # error; held to the RK4 path's own float32 stray from float64 + 1e-4
    rk4 = build_cstr_nmpc(FLAGSHIP, f32)
    s_rk4 = rk4.solve_batch_fn()(*rk4.prepare_batch(x0s))
    s_64 = build_cstr_nmpc(FLAGSHIP, f64).solve_batch_fn()(
        *[a.double() for a in rk4.prepare_batch(x0s)])
    both = sol.converged & s_rk4.converged & s_64.converged
    dev = float((sol.U - s_rk4.U).abs()[both].max())
    stray = float((s_rk4.U.double() - s_64.U).abs()[both].max())
    log(f"phase12(a) max|U_colloc - U_rk4| {dev:.3e} on the jointly converged "
        f"({float(both.float().mean()):.4f}); the RK4 path's float32 stray {stray:.3e}")
    assert dev <= stray + 1e-4, (dev, stray)
    card_vs_cpu("phase12(a) card vs CPU",
                lambda d: build_cstr_nmpc(colloc, f64, device=d), x0s[:B_CPU_CHECK])
    # pallas_full: the whole-solve kernel with the emitted collocation step
    label = "phase12(a) pallas_full collocation"
    two_routes(label, lambda dt, o: build_cstr_nmpc({**colloc, **(o or {})}, dt), x0s,
               report, warm=True)
    r = report[label]
    assert r["route_gap"] <= r["stray"] + 5e-4, r
    report["whole_ip_implicit"]["launches"] = r["launches"] + r["warm_launches"]
    report["riccati_lq"].setdefault("phase12_launches", {})["colloc_flagship"] = launches


# golden dae_colloc's controller at the NMPC defaults (Mehrotra, up to 28
# iterations) on the general path; its pure-Newton run through both routes
# is at B_MAIN
B_DAE_DEFAULTS = 32768


def phase12_dae(report):
    """(b) Golden dae_colloc's controller at full width, card vs CPU, and
    the golden replayed."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops import riccati
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    f32, f64 = torch.float32, torch.float64
    x0s = 0.1 + 0.2 * np.random.default_rng(4).standard_normal((B_MAIN, 1))
    # float32 cannot reach the golden's KKT tolerance 1e-9 (no scenario
    # converges), so this run takes float32's 1e-4; at B_DAE_DEFAULTS
    ctl = dae_nmpc(f32, options={"tol": 1e-4})
    ctl.solve_batch_fn()(*ctl.prepare_batch(x0s[:256]))
    torch.cuda.synchronize()
    riccati_lq_cuda.launches = 0
    with count_calls(riccati, "backward_sweep") as sweeps:
        _, sol, _, (t_prep, t_cold, _) = timed_batch(ctl, x0s[:B_DAE_DEFAULTS])
    launches = riccati_lq_cuda.launches
    loops = int(sol.iterations.max())
    conv = float(sol.converged.float().mean())
    assert sol.U.shape == (B_DAE_DEFAULTS, 12, 1) and bool(torch.isfinite(sol.U).all())
    log(f"phase12(b) golden dae_colloc's controller B={B_DAE_DEFAULTS} N=12 float32 (tol "
        f"1e-4, NMPC defaults): prepare_batch {t_prep:.4f} s; cold "
        f"{B_DAE_DEFAULTS / t_cold:.1f} solves/s ({t_cold:.4f} s wall), converged {conv:.4f}, "
        f"iterations p50 {float(sol.iterations.float().median()):g} max {loops}; "
        f"riccati_lq launches {launches} = Newton steps {2 * loops} (Mehrotra: 2 per "
        f"iteration), plain backward sweeps {sweeps.calls}")
    assert conv >= 0.97, conv
    assert (launches, sweeps.calls) == (2 * loops, 0)
    card_vs_cpu("phase12(b) card vs CPU", lambda d: dae_nmpc(f64, device=d),
                x0s[:B_CPU_CHECK])
    data = np.load(GOLDEN_DAE)
    gold = dae_nmpc(f64)
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    devs, its = [], []
    for k in range(golden_steps(data)):
        u = gold.optimize(data["X_meas"][k])
        assert gold.stats["converged"], (k, gold.stats)
        devs.append(float(np.abs(u - data["U_gold"][k]).max()))
        its.append(gold.stats["iterations"])
    assert riccati_lq_cuda.launches > n0
    log(f"phase12(b) golden dae_colloc float64: {len(devs)} steps in "
        f"{time.perf_counter() - t0:.2f} s, iterations {min(its)}-{max(its)}, "
        f"max|u - u_gold| = {max(devs):.3e}")
    assert max(devs) < 1e-4, devs
    report["riccati_lq"].setdefault("phase12_launches", {})["dae_colloc"] = launches
    # its model at FLAGSHIP's pure-Newton options: the traced build
    label = "phase12(b) pallas_full dae_colloc"
    two_routes(label, lambda dt, o: dae_nmpc(dt, options={**FLAGSHIP, **(o or {})}),
               x0s, report)
    r = report[label]
    assert r["route_gap"] <= r["stray"] + 5e-4, r
    report["whole_ip_implicit"]["phase12_dae_launches"] = r["launches"]


def phase12_fleet():
    """(c) A plant fleet with a stiff model: Seborg's CSTR under Radau
    collocation, and a quadrature model, each card vs CPU."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import Model
    from hilo_mpc_tpu_torch.library import cstr_seborg
    f32, f64 = torch.float32, torch.float64
    x0s = np.array([0.5, 350.0, 300.0]) + np.array([0.05, 2.0, 2.0]) \
        * np.random.default_rng(5).standard_normal((B_MAIN, 3))
    U = np.full((20, 1), 300.0)

    def seborg(dtype, device="cuda"):
        m = cstr_seborg()
        m.setup(dt=0.05, integration_method="collocation", degree=3, device=device,
                dtype=dtype)
        m.set_initial_parameter_values([SEBORG_P[k] for k in m.parameters])
        return m

    m = seborg(f32)
    m.simulate(x0=x0s[:256], u=U)                                # warm-up
    t0 = time.perf_counter()
    out = m.simulate(x0=x0s, u=U)
    t = time.perf_counter() - t0
    X = out["x"]
    # a rollout is bounded while |C_A| <= 2 C_Af, 250 < T < 500 K and 250 <
    # T_c < 400 K at every step. A start near the unstable middle steady state
    # ignites within the run, and at dt 0.05 the collocation solution may dip
    # slightly below C_A = 0 there (the discretization's, not Newton's: 20
    # Newton steps dip as well); an unbounded rollout is one where the fixed
    # 8 Newton steps of a step diverged at the ignition (the JAX package's
    # step does the same: its rollouts of such starts run off unbounded).
    # There the result amplifies rounding without bound, so the card and the
    # CPU are compared on the rollouts bounded in both
    def bounded(X):
        return (np.isfinite(X).all(axis=(1, 2)) & (np.abs(X[..., 0]) <= 2.0).all(axis=1)
                & ((X[..., 1] > 250) & (X[..., 1] < 500)).all(axis=1)
                & ((X[..., 2] > 250) & (X[..., 2] < 400)).all(axis=1))
    ok = bounded(X)
    log(f"phase12(c) Seborg CSTR fleet, Radau d=3, dt 0.05, 20 steps, B={B_MAIN} "
        f"float32: {B_MAIN / t:.1f} rollouts/s ({t:.4f} s wall); bounded rollouts "
        f"{float(ok.mean()):.5f} ({int((~ok).sum())} not; ignited, T at step 20 > "
        f"370 K: {float((X[ok, -1, 1] > 370).mean()):.4f}), C_A at step 20 "
        f"{X[ok, -1, 0].min():.4f}..{X[ok, -1, 0].max():.4f}")
    assert ok.mean() >= 0.97, ok.mean()
    outs = [seborg(f64, d).simulate(x0=x0s[:1024], u=U)["x"] for d in ("cpu", "cuda")]
    # the problem's own amplification of rounding: the CPU's rollouts from
    # x0 moved by one ulp (starts near the unstable middle steady state
    # separate over the run)
    nudged = seborg(f64, "cpu").simulate(x0=x0s[:1024] * (1 + 2.0 ** -52), u=U)["x"]
    both = bounded(outs[0]) & bounded(outs[1]) & bounded(nudged)
    dev = np.abs(outs[1] - outs[0])[both].max(axis=(0, 1))
    ulp = np.abs(nudged - outs[0])[both].max(axis=(0, 1))
    log(f"phase12(c) Seborg float64 B=1024 card vs CPU: max|Δ| (C_A, T, T_c) "
        f"{dev[0]:.3e} {dev[1]:.3e} {dev[2]:.3e} on the {int(both.sum())} rollouts "
        f"bounded in both ({int((~both).sum())} not, the same "
        f"{bool(np.array_equal(bounded(outs[0]), bounded(outs[1])))}); the CPU "
        f"against itself from x0 moved by one ulp {ulp[0]:.3e} {ulp[1]:.3e} "
        f"{ulp[2]:.3e}")
    # 1e-9, or the problem's own one-ulp amplification where that is larger
    assert (dev <= np.maximum(1e-9, ulp)).all(), (dev, ulp)

    def quad_model(device):
        q = Model(name="quad")
        q.set_equations("dx/dt = -x(t) + z(t) + u(k)\n0 = z(t) - 0.5*x(t)\n"
                        "int = x(t)**2 + 0.1*u(k)**2")
        q.setup(dt=0.1, integration_method="collocation", degree=3, device=device,
                dtype=f64)
        return q
    xq = 1.0 + 0.1 * np.random.default_rng(6).standard_normal((1024, 1))
    Uq = np.full((10, 1), 0.2)
    qs = [quad_model(d).simulate(x0=xq, z0=0.5 * xq, u=Uq) for d in ("cpu", "cuda")]
    dev_q = max(float(np.abs(qs[1][k] - qs[0][k]).max()) for k in ("x", "z", "q"))
    log(f"phase12(c) DAE with a quadrature, Radau d=3, B=1024 float64, 10 steps: "
        f"card vs CPU max|Δ| over x, z, q {dev_q:.3e}; q at step 10 "
        f"{qs[1]['q'][:, -1, 0].min():.5f}..{qs[1]['q'][:, -1, 0].max():.5f}")
    assert dev_q <= 1e-9, dev_q


def phase12_filters():
    """(d) EKF, UKF and PF on the DAE model (RK4 with Newton-solved
    algebraic states), card vs CPU in float64, at phase 9's bars."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import EKF, PF, UKF
    from hilo_mpc_tpu_torch.estimation.pf import lhsnorm
    f64 = torch.float64
    rng = np.random.default_rng(8)
    Us = 0.3 * np.sin(np.linspace(0, 3, 30))[:, None]
    Ys = 0.4 + 0.05 * rng.standard_normal((30, 1))
    for cls, tol in ((EKF, 1e-9), (UKF, 1e-8)):
        runs = []
        for device in ("cpu", "cuda"):
            f = cls(dae_model())
            f.Q, f.R = 1e-4 * np.eye(1), np.array([[1e-3]])
            f.setup(dt=0.1, device=device, dtype=f64)
            f.set_initial_guess([0.3], P0=0.1 * np.eye(1))
            t0 = time.perf_counter()
            f.estimate(Ys, u=Us)
            runs.append((f, time.perf_counter() - t0))
        dev = {k: float(np.abs(runs[1][0].solution[k] - runs[0][0].solution[k]).max())
               for k in ("x", "P")}
        log(f"phase12(d) {cls.__name__} DAE float64, {Ys.shape[0]} steps: card "
            f"{runs[1][1]:.3f} s, CPU {runs[0][1]:.3f} s; max|card - CPU| x "
            f"{dev['x']:.3e}, P {dev['P']:.3e}")
        assert max(dev.values()) <= tol, dev
    M = 4096
    out = []
    for device in ("cpu", "cuda"):
        kw = dict(dtype=f64, device=device)
        pf = PF(dae_model(), n_particles=M, roughening=True)
        pf.Q, pf.R = 1e-4 * np.eye(1), np.array([[1e-3]])
        pf.setup(dt=0.1, device=device, dtype=f64)
        parts = torch.as_tensor(lhsnorm([0.3], 0.1 * np.eye(1), M), **kw)
        draws = np.random.default_rng(9)
        p = torch.zeros(0, **kw)
        for k in range(Ys.shape[0]):
            parts, x, _ = pf.step_draws(
                parts, torch.as_tensor(Us[k], **kw), p, torch.as_tensor(Ys[k], **kw),
                0.1 * k, torch.as_tensor(draws.standard_normal((M, 1)), **kw),
                torch.as_tensor(draws.random(), **kw),
                torch.as_tensor(draws.standard_normal((M, 1)), **kw))
        out.append((parts.cpu().numpy(), x.cpu().numpy()))
    dev_p = float(np.abs(out[1][0] - out[0][0]).max())
    dev_x = float(np.abs(out[1][1] - out[0][1]).max())
    log(f"phase12(d) PF DAE float64, {M} particles, {Ys.shape[0]} steps: max|card - "
        f"CPU| particles {dev_p:.3e}, x_est {dev_x:.3e}")
    assert max(dev_p, dev_x) <= 1e-9, (dev_p, dev_x)


X_EQ = (0.3, 0.18055)
# phase 13's fleets: the MHE loop's batch, each loop's steps, the scenarios
# held card against CPU
B_MHE_LOOP = 32768
STEPS_LOOP, STEPS_MHE_LOOP = 20, 10
B_CHECK, B_CHECK_MHE = 256, 64
# E of the time-varying-parameter CSTR: a seeded sequence of 40 values
TVP_E_SEED = 11


def cstr_plant(dtype, device="cuda"):
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4", device=device, dtype=dtype)
    return plant


def synced(fn):
    """fn()'s result and its wall time in seconds, the card synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def final_error(X):
    """Per-scenario distance of the last state from the set point."""
    import numpy as np
    return np.linalg.norm(np.asarray(X)[:, -1] - np.array(X_EQ), axis=1)


def loop_launches(iterations):
    """Launches a batched solve per step makes: its loop runs to the
    slowest scenario, one Riccati launch per iteration (B, steps) -> int."""
    return int(iterations.max(dim=0).values.sum())


def phase13(report):
    """The closed loop and the real-time entry points (module docstring)."""
    for part in (phase13_fused_loop, phase13_rti, phase13_mhe_loop, phase13_ekf_loop,
                 phase13_tvp, phase13_options, phase13_lq_horizons):
        t = time.perf_counter()
        part(report)
        log(f"{part.__name__} took {time.perf_counter() - t:.1f} s")


def phase13_fused_loop(report):
    """(a) fused_closed_loop_fn on the flagship fleet."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.parallel import fused_closed_loop_fn
    f32, f64 = torch.float32, torch.float64
    p = np.ones(6)
    x0s = flagship_x0s()
    fused_closed_loop_fn(build_cstr_nmpc(FLAGSHIP, f32), cstr_plant(f32), 1,
                         plant_p=p)(x0s[:256])                     # untimed warm-up
    run = fused_closed_loop_fn(build_cstr_nmpc(FLAGSHIP, f32), cstr_plant(f32),
                               STEPS_LOOP, plant_p=p)
    riccati_lq_cuda.launches = 0
    res, t = synced(lambda: run(x0s))
    launches = riccati_lq_cuda.launches
    assert res.X.shape == (B_MAIN, STEPS_LOOP + 1, 2) and bool(torch.isfinite(res.X).all())
    assert launches == loop_launches(res.iterations), (launches, loop_launches(res.iterations))
    conv = float(res.converged.float().mean())
    err = final_error(res.X.cpu())
    it = res.iterations.float()
    log(f"phase13(a) fused_closed_loop_fn flagship B={B_MAIN} N={N} {STEPS_LOOP} steps "
        f"float32: {t:.4f} s wall, {B_MAIN * STEPS_LOOP / t:.1f} scenario-steps/s "
        f"({t / STEPS_LOOP * 1e3:.2f} ms per step); riccati_lq launches {launches} "
        f"(= the steps' slowest iterations), converged {conv:.5f}, iterations per solve "
        f"p50 {float(it.median()):g} max {int(it.max())}; final |x - x_eq| p50 "
        f"{np.median(err):.3e} p99 {np.quantile(err, 0.99):.3e} max {err.max():.3e}")
    assert conv > 0.95, conv
    assert err.max() < 3e-2, err.max()
    out = {}
    for dev in ("cpu", "cuda"):
        r = fused_closed_loop_fn(build_cstr_nmpc(FLAGSHIP, f64, device=dev),
                                 cstr_plant(f64, dev), STEPS_LOOP, plant_p=p)(x0s[:B_CHECK])
        out[dev] = [v.cpu() for v in r]
    dev_x = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    dev_u = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    same_it = bool(torch.equal(out["cuda"][3], out["cpu"][3]))
    log(f"phase13(a) float64 B={B_CHECK}: max|X_card - X_cpu| {dev_x:.3e}, max|U_card - "
        f"U_cpu| {dev_u:.3e}, equal per-step iterations {same_it}")
    assert max(dev_x, dev_u) <= 1e-9 and same_it, (dev_x, dev_u, same_it)
    report["riccati_lq"].setdefault("phase13_launches", {})["fused_loop"] = launches
    report["phase13_loop"] = dict(seconds=t, steps_per_s=B_MAIN * STEPS_LOOP / t)


def rti_fleet(nmpc, plant, X, steps, warm=True):
    """A fleet closed loop by batched RTI: feedback, plant step, prepare at
    the new states (warm from each scenario's shifted solution). Returns
    the applied moves (steps, B, nu), the final states, and the prepare and
    feedback walls per step."""
    import numpy as np
    p = np.ones(6)
    nmpc.rti_prepare_batch(X)
    Us, t_prep, t_fb = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        U = nmpc.rti_feedback_batch(X)
        t_fb.append(time.perf_counter() - t0)
        Us.append(U)
        X = plant.simulate(x0=X, u=U[:, None, :], p=p, steps=1)["x"][:, -1]
        _, t = synced(lambda: nmpc.rti_prepare_batch(X, warm=warm))
        t_prep.append(t)
    return np.array(Us), X, t_prep, t_fb


def phase13_rti(report):
    """(b) Batched RTI on the flagship fleet, warm: full-solve prepares,
    then one-iteration prepares (rti_gn_iterations = 1)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    f32, f64 = torch.float32, torch.float64
    x0s = flagship_x0s()
    plant = cstr_plant(f32)
    warmup = build_cstr_nmpc(FLAGSHIP, f32)
    rti_fleet(warmup, plant, x0s[:256], 2)                        # untimed warm-up
    nmpc = build_cstr_nmpc(FLAGSHIP, f32)
    riccati_lq_cuda.launches = 0
    (_, X, t_prep, t_fb), t = synced(lambda: rti_fleet(nmpc, plant, x0s, STEPS_LOOP))
    launches = riccati_lq_cuda.launches
    conv = float(nmpc._rti_batch["converged"].mean())
    err = final_error(X[:, None])
    # the gain alone at the last prepare's solution
    X_prev, U_prev = nmpc._rti_batch_warm
    theta_B = nmpc.prepare_batch(X)[0]
    _, t_gain = synced(lambda: nmpc.rti_gain(X_prev, U_prev, theta_B))
    ms = np.array(t_prep) * 1e3
    log(f"phase13(b) batched RTI flagship B={B_MAIN} N={N} float32, {STEPS_LOOP} warm "
        f"steps: {t:.4f} s wall; prepare (solve + gain) p50 {np.median(ms):.2f} ms, min "
        f"{ms.min():.2f}, max {ms.max():.2f}; the gain alone {t_gain * 1e3:.2f} ms; "
        f"feedback (numpy, B scenarios) p50 {np.median(t_fb) * 1e3:.3f} ms; riccati_lq "
        f"launches {launches}; converged {conv:.5f}; final |x - x_eq| max {err.max():.3e}")
    assert launches > 0 and conv > 0.95 and err.max() < 3e-2, (launches, conv, err.max())
    # classical RTI: the same fleet loop with rti_gn_iterations = 1, one
    # interior-point iteration (one Riccati launch) per prepare
    gn = build_cstr_nmpc(FLAGSHIP, f32)
    gn.rti_gn_iterations = 1
    riccati_lq_cuda.launches = 0
    (_, X_gn, t_prep_gn, t_fb_gn), t_gn = synced(
        lambda: rti_fleet(gn, plant, x0s, STEPS_LOOP))
    gn_launches = riccati_lq_cuda.launches
    err_gn = final_error(X_gn[:, None])
    ms_gn = np.array(t_prep_gn) * 1e3
    log(f"phase13(b) rti_gn_iterations=1, {STEPS_LOOP} warm steps: {t_gn:.4f} s wall; "
        f"prepare (one iteration + gain) p50 {np.median(ms_gn):.2f} ms, min "
        f"{ms_gn.min():.2f}, max {ms_gn.max():.2f}; feedback p50 "
        f"{np.median(t_fb_gn) * 1e3:.3f} ms; riccati_lq launches {gn_launches} (one per "
        f"prepare); final |x - x_eq| p99 {np.quantile(err_gn, 0.99):.3e} max "
        f"{err_gn.max():.3e}")
    assert gn_launches == STEPS_LOOP + 1, gn_launches
    assert err_gn.max() < 3e-2, err_gn.max()
    for k in (None, 1):
        out = {}
        for dev in ("cpu", "cuda"):
            ctl = build_cstr_nmpc(FLAGSHIP, f64, device=dev)
            ctl.rti_gn_iterations = k
            U_d, X_d, _, _ = rti_fleet(ctl, cstr_plant(f64, dev), x0s[:B_CHECK], STEPS_LOOP)
            out[dev] = (U_d, X_d)
        dev_u = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
        dev_x = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
        log(f"phase13(b) rti_gn_iterations={k} float64 B={B_CHECK}, {STEPS_LOOP} steps: "
            f"max|U_card - U_cpu| {dev_u:.3e}, max|x_card - x_cpu| {dev_x:.3e}")
        assert max(dev_u, dev_x) <= 1e-9, (k, dev_u, dev_x)
    report["riccati_lq"].setdefault("phase13_launches", {}).update(
        batched_rti=launches, batched_rti_gn=gn_launches)
    report["phase13_rti"] = dict(prepare_ms=float(np.median(ms)),
                                 feedback_ms=float(np.median(t_fb)) * 1e3,
                                 gn_prepare_ms=float(np.median(ms_gn)))


def mhe_loop(dtype, device, B):
    """The MHE loop's pieces on ``device``: the run function (the flagship
    controller, phase 7's MHE, the CSTR plant) and its inputs (windows from
    numpy plant runs, mhe_cstr_windows)."""
    import numpy as np
    from hilo_mpc_tpu_torch import MHE
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    from hilo_mpc_tpu_torch.parallel import fused_closed_loop_mhe_fn
    mhe = MHE(cstr_schaffner_and_zeitz())
    mhe.horizon = N_MHE
    mhe.Q, mhe.R, mhe.P0 = 1e-4, 1e-3, 0.1 * np.eye(2)
    mhe.set_initial_parameter_values(np.ones(6))
    mhe.setup(dt=0.1, device=device, dtype=dtype)
    run = fused_closed_loop_mhe_fn(build_cstr_nmpc(FLAGSHIP, dtype, device=device),
                                   cstr_plant(dtype, device), mhe, STEPS_MHE_LOOP,
                                   plant_p=np.ones(6))
    Ys, Us, x0, X_last = mhe_cstr_windows(B, seed=6)
    return run, (X_last, Ys, Us, x0)


def phase13_mhe_loop(report):
    """(c) fused_closed_loop_mhe_fn: the controller and an MHE window solve
    per step, the window in the Riccati kernel's free-x0 mode."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops import riccati
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda, riccati_lq_wide_cuda
    f32, f64 = torch.float32, torch.float64
    run, inputs = mhe_loop(f32, "cuda", 256)
    run(*inputs)                                                   # untimed warm-up
    run, inputs = mhe_loop(f32, "cuda", B_MHE_LOOP)
    riccati_lq_cuda.launches = riccati_lq_cuda.free_x0_launches = 0
    riccati_lq_wide_cuda.launches = 0
    with count_calls(riccati, "backward_sweep") as sweeps:
        res, t = synced(lambda: run(*inputs))
    launches, free = riccati_lq_cuda.launches, riccati_lq_cuda.free_x0_launches
    got = (free, launches - free, riccati_lq_wide_cuda.launches, sweeps.calls)
    want = (loop_launches(res.mhe_iterations), loop_launches(res.iterations), 0, 0)
    conv, conv_m = float(res.converged.float().mean()), float(res.mhe_converged.float().mean())
    est = (res.X_est[:, -1] - res.X[:, -1]).abs().cpu().numpy()
    err = final_error(res.X.cpu())
    log(f"phase13(c) fused_closed_loop_mhe_fn B={B_MHE_LOOP} N={N}, window {N_MHE}, "
        f"{STEPS_MHE_LOOP} steps float32: {t:.4f} s wall, "
        f"{B_MHE_LOOP * STEPS_MHE_LOOP / t:.1f} scenario-steps/s; riccati_lq launches "
        f"{launches}, of them free-x0 {free} ({free / STEPS_MHE_LOOP:g} per step; = the "
        f"window solves' slowest iterations {want[0]}), the controller's {got[1]} (= "
        f"{want[1]}); riccati_lq_wide launches {got[2]}, plain backward sweeps "
        f"{got[3]}; controller converged {conv:.5f}, windows converged {conv_m:.5f}; final "
        f"|x_est - x| max {est.max():.3e} p99 {np.quantile(est, 0.99):.3e}; final |x - "
        f"x_eq| max {err.max():.3e}")
    assert got == want, ("free-x0, controller, wide launches, plain sweeps", got, want)
    assert conv > 0.95 and conv_m > 0.9, (conv, conv_m)
    out = {}
    for dev in ("cpu", "cuda"):
        run_d, inputs_d = mhe_loop(f64, dev, B_CHECK_MHE)
        out[dev] = [v.cpu() for v in run_d(*inputs_d)]
    dev_x = max(float((out["cuda"][k] - out["cpu"][k]).abs().max()) for k in (0, 1, 2))
    log(f"phase13(c) float64 B={B_CHECK_MHE}: max|card - CPU| over X, X_est, U {dev_x:.3e}")
    assert dev_x <= 1e-9, dev_x
    report["riccati_lq"].setdefault("phase13_launches", {})["mhe_loop_controller"] = got[1]
    report["riccati_lq_free_x0"]["phase13_launches"] = {"mhe_loop": free}


def phase13_ekf_loop(report):
    """(d) fused_closed_loop_ekf_fn with measurement noise from a seeded
    CUDA generator."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import EKF
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.parallel import fused_closed_loop_ekf_fn
    f32 = torch.float32

    def build(steps):
        ekf = EKF(cstr_schaffner_and_zeitz())
        ekf.Q, ekf.R = 1e-4 * np.eye(2), np.array([[1e-4]])
        ekf.set_initial_parameter_values(np.ones(6))
        ekf.setup(dt=0.1, device="cuda", dtype=f32)
        return fused_closed_loop_ekf_fn(build_cstr_nmpc(FLAGSHIP, f32), cstr_plant(f32),
                                        ekf, steps, plant_p=np.ones(6),
                                        meas_noise_std=np.array([0.005]))
    x0 = flagship_x0s()
    x_est0 = x0 + 0.02 * np.random.default_rng(7).standard_normal(x0.shape)
    P0 = 0.05 * np.eye(2)

    def gen(seed):
        return torch.Generator("cuda").manual_seed(seed)
    build(1)(x0[:256], x_est0[:256], P0, generator=gen(1))          # untimed warm-up
    run = build(STEPS_LOOP)
    riccati_lq_cuda.launches = 0
    res, t = synced(lambda: run(x0, x_est0, P0, generator=gen(0)))
    launches = riccati_lq_cuda.launches
    conv = float(res.converged.float().mean())
    err = final_error(res.X.cpu())
    est = (res.X_est[:, -1] - res.X[:, -1]).abs().cpu().numpy().max(axis=1)
    log(f"phase13(d) fused_closed_loop_ekf_fn B={B_MAIN} N={N} {STEPS_LOOP} steps "
        f"float32, measurement noise 0.005 (CUDA generator, seed 0): {t:.4f} s wall, "
        f"{B_MAIN * STEPS_LOOP / t:.1f} scenario-steps/s; riccati_lq launches {launches}; "
        f"converged {conv:.5f}; final |x - x_eq| p99 {np.quantile(err, 0.99):.3e} max "
        f"{err.max():.3e}; final |x_est - x| p99 {np.quantile(est, 0.99):.3e} max "
        f"{est.max():.3e}")
    assert launches == loop_launches(res.iterations) and conv > 0.95, (launches, conv)
    assert np.quantile(err, 0.99) < 3e-2 and np.quantile(est, 0.99) < 2e-2
    again = build(2)(x0[:1024], x_est0[:1024], P0, generator=gen(0))
    first = build(2)(x0[:1024], x_est0[:1024], P0, generator=gen(0))
    same = all(torch.equal(a, b) for a, b in zip(again, first))
    log(f"phase13(d) the same generator seed twice (B=1024, 2 steps): the same bits {same}")
    assert same
    report["riccati_lq"].setdefault("phase13_launches", {})["ekf_loop"] = launches


def tvp_nmpc(options, dtype, device="cuda"):
    """The flagship controller with E time-varying: a seeded sequence of 40
    values (1 + 0.1 sin + 0.02 N(0,1), default_rng(TVP_E_SEED)), read at
    the closed-loop step and wrapping around."""
    import numpy as np
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    E = (1.0 + 0.1 * np.sin(np.linspace(0.0, 6.0, 40))
         + 0.02 * np.random.default_rng(TVP_E_SEED).standard_normal(40))
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=list(X_EQ))
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.set_time_varying_parameters(["E"], {"E": E})
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options},
               device=device, dtype=dtype)
    return nmpc


def phase13_tvp(report):
    """(e) A time-varying-parameter CSTR through the general path and
    through pallas_full (the emitted problem reads p per stage from
    theta), the whole-solve kernel against its plain version."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda, solve_ocp_full_reference
    f32 = torch.float32
    x0s = flagship_x0s()
    gen = tvp_nmpc(FLAGSHIP, f32)
    whole = tvp_nmpc({**FLAGSHIP, "pallas_full": True}, f32)
    for ctl in (gen, whole):
        ctl._step_count = 7              # seven steps into the table
        ctl.solve_batch_fn()(*ctl.prepare_batch(x0s[:256]))    # untimed warm-up
    args = gen.prepare_batch(x0s)
    assert torch.equal(args[0], whole.prepare_batch(x0s[:1])[0][0].expand_as(args[0]))
    assert len(set(args[0][0, :, 2 + 5].tolist())) > 1   # E varies along the horizon
    riccati_lq_cuda.launches = solve_ocp_full_cuda.launches = 0
    sol_g, t_g = synced(lambda: gen.solve_batch_fn()(*args))
    ric = riccati_lq_cuda.launches
    sol_w, t_w = synced(lambda: whole.solve_batch_fn()(*args))
    wip = solve_ocp_full_cuda.launches
    assert wip == 1 and riccati_lq_cuda.launches == ric, (wip, riccati_lq_cuda.launches, ric)
    plain, t_p = synced(lambda: solve_ocp_full_reference(whole._funcs, whole._dims,
                                                         whole._bounds, *args,
                                                         whole._ip_opts))
    both = sol_w.converged & plain.converged
    dev_k = float((sol_w.U - plain.U).abs()[both].max())
    both_r = sol_w.converged & sol_g.converged
    dev_r = float((sol_w.U - sol_g.U).abs()[both_r].max())
    conv_g, conv_w = float(sol_g.converged.float().mean()), float(sol_w.converged.float().mean())
    log(f"phase13(e) tvp CSTR (E from a table of 40, step 7) B={B_MAIN} N={N} float32: "
        f"general path {t_g:.4f} s ({B_MAIN / t_g:.1f} solves/s, riccati_lq launches {ric}, "
        f"converged {conv_g:.5f}); pallas_full {t_w * 1e3:.3f} ms ({B_MAIN / t_w:.1f} "
        f"solves/s, whole_ip launches {wip}, converged {conv_w:.5f}); its plain version "
        f"{t_p:.4f} s; max|U_kernel - U_plain| {dev_k:.3e} and max|U_whole - U_general| "
        f"{dev_r:.3e} on the jointly converged ({float(both.float().mean()):.5f}, "
        f"{float(both_r.float().mean()):.5f})")
    assert min(conv_g, conv_w) >= 0.97 and dev_k <= 5e-4 and dev_r <= 5e-4, \
        (conv_g, conv_w, dev_k, dev_r)
    report["riccati_lq"].setdefault("phase13_launches", {})["tvp_general"] = ric
    report["whole_ip"]["phase13_launches"] = {"tvp": wip}


def phase13_options(report):
    """(f) parallel_riccati and bf16 storage on the flagship, card against
    CPU; the parallel route launches no Riccati kernel (as the JAX solver
    launches no Pallas kernel under the option)."""
    import dataclasses
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    f32, f64 = torch.float32, torch.float64
    x0s = flagship_x0s()
    base = build_cstr_nmpc(FLAGSHIP, f32)
    args = base.prepare_batch(x0s)
    ref, t_ref = synced(lambda: base.solve_batch_fn()(*args))
    rows = {}
    for name, extra in (("parallel_riccati", {"parallel_riccati": True}),
                        ("bf16 storage", {"lin_storage_dtype": "bfloat16"})):
        ctl = build_cstr_nmpc({**FLAGSHIP, **extra}, f32)
        ctl.solve_batch_fn()(*ctl.prepare_batch(x0s[:256]))       # untimed warm-up
        riccati_lq_cuda.launches = 0
        sol, t = synced(lambda: ctl.solve_batch_fn()(*args))
        ric = riccati_lq_cuda.launches
        both = sol.converged & ref.converged
        dev = float((sol.U - ref.U).abs()[both].max())
        rows[name] = (sol, ric)
        log(f"phase13(f) {name} flagship B={B_MAIN} float32: {t:.4f} s ({B_MAIN / t:.1f} "
            f"solves/s; the Riccati-kernel route {t_ref:.4f} s), riccati_lq launches {ric}, "
            f"converged {float(sol.converged.float().mean()):.5f}, iterations max "
            f"{int(sol.iterations.max())}; max|U - U_kernel route| on the jointly "
            f"converged {dev:.3e}")
        # bf16-rounded blocks make each Newton step inexact, and some
        # scenarios stall above tol 1e-4, as on the JAX package's route
        assert float(sol.converged.float().mean()) >= (0.95 if "bf16" in name else 0.97)
    assert rows["parallel_riccati"][1] == 0 and rows["bf16 storage"][1] > 0
    # card against CPU: the parallel route in float64 (<= 1e-9, equal
    # iterations); bf16 storage in float32 within the CPU's own bf16 stray
    # from its float32 route + 1e-4; float64 ignores bf16 storage bit for bit
    card_vs_cpu("phase13(f) parallel_riccati card vs CPU",
                lambda d: build_cstr_nmpc({**FLAGSHIP, "parallel_riccati": True}, f64,
                                          device=d), x0s[:B_CHECK])
    sub = x0s[:B_CHECK]
    out = {}
    for dev in ("cpu", "cuda"):
        for name, extra in (("f32", {}), ("bf16", {"lin_storage_dtype": "bfloat16"})):
            ctl = build_cstr_nmpc({**FLAGSHIP, **extra}, f32, device=dev)
            out[dev, name] = ctl.solve_batch_fn()(*ctl.prepare_batch(sub)).U.cpu()
    stray = float((out["cpu", "bf16"] - out["cpu", "f32"]).abs().max())
    dev_bf = float((out["cuda", "bf16"] - out["cpu", "bf16"]).abs().max())
    b64 = build_cstr_nmpc(FLAGSHIP, f64)
    s64 = build_cstr_nmpc({**FLAGSHIP, "lin_storage_dtype": "bfloat16"}, f64)
    a64 = b64.prepare_batch(sub)
    same = all(torch.equal(a, b) for a, b in zip(b64.solve_batch_fn()(*a64),
                                                 s64.solve_batch_fn()(*a64)))
    log(f"phase13(f) bf16 storage B={B_CHECK} float32: max|U_card - U_cpu| {dev_bf:.3e} "
        f"(the CPU's bf16 stray from float32 {stray:.3e}); float64 ignores it bit for bit "
        f"on the card: {same}")
    assert dev_bf <= stray + 1e-4 and same, (dev_bf, stray, same)
    assert dataclasses.asdict(s64._ip_opts)["lin_storage_dtype"] == "bfloat16"
    report["riccati_lq"].setdefault("phase13_launches", {})["bf16_storage"] = \
        rows["bf16 storage"][1]


# (N, B) of the LQ-step comparison: one scenario, and B·N = 131072·20
LQ_HORIZONS = ((20, 1), (20, 131072), (200, 1), (200, 13107), (2000, 1), (2000, 1310))


def phase13_lq_horizons(report):
    """(f) The LQ step alone at the flagship widths (nx, nu) = (2, 1):
    ``parallel_riccati``'s doubling scans (ops/riccati.py:solve_lq_parallel)
    against the Riccati kernel's route (make_lq_solver) over horizons the
    scans are meant for, one scenario and B·N = 131072·20, on phase 1's
    random problems (CUDA events, median of 3 after one untimed call)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.riccati import make_lq_solver, solve_lq_parallel
    kernel = make_lq_solver(reg=1e-8)
    rows = report["phase13_lq_ms"] = {}
    for N_h, B in LQ_HORIZONS:
        args = lq_problem(B, N_h, 2, 1, torch.float32, seed=N_h + B)
        times, outs = {}, {}
        for name, fn in (("kernel", kernel),
                         ("scans", lambda *a: solve_lq_parallel(*a, reg=1e-8))):
            outs[name] = fn(*args)
            ev = []
            for _ in range(3):
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                t0.record()
                fn(*args)
                t1.record()
                torch.cuda.synchronize()
                ev.append(t0.elapsed_time(t1))
            times[name] = float(np.median(ev))
        dU_k, dU_s = outs["kernel"].dU, outs["scans"].dU
        scale = float(dU_k.abs().max())
        dev = float((dU_k - dU_s).abs().max())
        log(f"phase13(f) LQ step N={N_h} B={B} (2, 1) float32: Riccati kernel route "
            f"{times['kernel']:.4f} ms, parallel_riccati's scans {times['scans']:.4f} ms "
            f"({times['scans'] / times['kernel']:.2f}x); max|dU_scans - dU_kernel| "
            f"{dev:.3e} (max|dU| {scale:.3e})")
        assert bool(torch.isfinite(dU_s).all()) and dev <= 1e-3 * max(scale, 1.0), \
            (N_h, B, dev, scale)
        rows[f"N={N_h} B={B}"] = (times["kernel"], times["scans"])


def phase14(report):
    """The whole-solve kernel on traced problems (ops/codegen_fx.py)."""
    phase14_msd(report)
    phase14_pathfollow(report)
    phase14_cstr_generic(report)
    phase14_two_emitters(report)


def two_routes(label, build, x0s, report, warm=False, check_plain=True):
    """A problem at B=len(x0s) (131072 unless a phase cuts it), float32,
    through pallas_full (exactly
    one whole-solve launch, no Riccati launch, no warning) and through the
    general path (the Riccati kernel): solves/s of both, each converged on
    >= 0.97, U within the general path's float32 stray from its float64
    answer plus 5e-4 on the jointly converged; the first 1024 through the
    kernel against its plain version (``check_plain`` False where phase 1
    holds the same build to its plain version on the same first 1024
    scenarios).
    ``warm``: also a warm solve through the kernel from the cold solution
    shifted (one launch, no Riccati launch, converged >= 0.97). Returns the
    kernel route's solution. The Riccati launches count both Riccati
    kernels (the wide one above (8, 4): the chain's (17, 1))."""
    import warnings

    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda, riccati_lq_wide_cuda
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda
    f32, f64 = torch.float32, torch.float64
    t_start = time.perf_counter()
    whole, general = build(f32, {"pallas_full": True}), build(f32, None)
    args = whole.prepare_batch(x0s)
    Bt = args[0].shape[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = whole.solve_batch_fn()
    for f in (fn, general.solve_batch_fn()):                   # untimed warm-up
        f(*[a[:256] for a in args])
    torch.cuda.synchronize()
    runs = {}
    for name, f in (("whole-solve kernel", fn), ("general path", general.solve_batch_fn())):
        solve_ocp_full_cuda.launches = riccati_lq_cuda.launches = 0
        riccati_lq_wide_cuda.launches = 0
        t0 = time.perf_counter()
        sol = f(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = (sol, wall, solve_ocp_full_cuda.launches,
                      riccati_lq_cuda.launches + riccati_lq_wide_cuda.launches)
        conv = float(sol.converged.float().mean())
        log(f"{label} {name} B={Bt} float32: {Bt / wall:.1f} solves/s "
            f"({wall:.4f} s wall), converged {conv:.4f}, iterations p50 "
            f"{float(sol.iterations.float().median()):g} max "
            f"{int(sol.iterations.max())}; whole_ip launches {runs[name][2]}, "
            f"riccati_lq launches {runs[name][3]}")
        assert bool(torch.isfinite(sol.U).all()) and conv >= 0.97, (label, name, conv)
    (sw, tw, w_full, w_ric), (sg, tg, g_full, g_ric) = runs.values()
    assert (w_full, w_ric) == (1, 0), (label, w_full, w_ric)
    assert g_full == 0 and g_ric > 0, (label, g_full, g_ric)
    extra = {}
    if warm:
        X_w, U_w = shifted(sw, args[1])
        solve_ocp_full_cuda.launches = riccati_lq_cuda.launches = 0
        riccati_lq_wide_cuda.launches = 0
        t0 = time.perf_counter()
        s_w = whole.solve_batch_fn(warm=True)(args[0], args[1], X_w, U_w)
        torch.cuda.synchronize()
        t_w = time.perf_counter() - t0
        conv = float(s_w.converged.float().mean())
        launches = (solve_ocp_full_cuda.launches,
                    riccati_lq_cuda.launches + riccati_lq_wide_cuda.launches)
        log(f"{label} whole-solve kernel warm B={Bt} float32: {Bt / t_w:.1f} "
            f"solves/s ({t_w:.4f} s wall), converged {conv:.4f}, iterations p50 "
            f"{float(s_w.iterations.float().median()):g} max "
            f"{int(s_w.iterations.max())}; whole_ip launches {launches[0]}, "
            f"riccati_lq launches {launches[1]}")
        assert bool(torch.isfinite(s_w.U).all()) and conv >= 0.97, (label, conv)
        assert launches == (1, 0), (label, launches)
        extra = dict(warm_solves_per_s=Bt / t_w, warm_launches=launches[0])
    g64 = build(f64, None)
    s64 = g64.solve_batch_fn()(*[a.double() for a in args])
    torch.cuda.synchronize()
    j = sw.converged & sg.converged & s64.converged
    dev = float((sw.U - sg.U).abs()[j].max())
    stray = float((sg.U.double() - s64.U).abs()[j].max())
    off = float((sw.U.double() - s64.U).abs()[j].max())
    log(f"{label}: max|U_whole - U_general| {dev:.3e} on the jointly converged "
        f"({float(j.float().mean()):.4f}); against the float64 general path: "
        f"general {stray:.3e}, kernel {off:.3e}; the kernel route "
        f"{tg / tw:.1f}x the general path's solves/s")
    assert off <= stray + 5e-4, (label, off, stray)
    problem = whole._wip["problem"]
    if check_plain:
        err = traced_kernel_vs_plain(f"{label} kernel vs plain", problem,
                                     {f32: whole, f64: g64}, args)
    else:
        # phase 1 held this build to its plain version on these first 1024
        err = None
        assert problem.text in {p.text for p in last_class_problems().values()}, label
    report[label] = dict(whole_solves_per_s=Bt / tw, general_solves_per_s=Bt / tg,
                         max_abs_err=err, route_gap=dev, stray=stray, launches=w_full,
                         **extra)
    log(f"{label} took {time.perf_counter() - t_start:.1f} s")
    return sw


def phase14_msd(report):
    """(a) phase 10(a)'s msd as a callable, soft |pos| <= 1, no hard row."""
    def build(dt, options):
        return msd_traced_nmpc(dt, options=options)
    two_routes("phase14(a) msd", build, msd_x0s(), report)
    report["whole_ip_traced"]["launches"] = report["phase14(a) msd"]["launches"]


def phase14_pathfollow(report):
    """(b) golden pathfollow_soft's controller under pure Newton steps at
    B=131072; then its 25-step loop replayed with every solve through the
    whole-solve kernel's float64 instance (max|u - u_gold| < 1e-4)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import (WholeIPLaunch, solve_ocp_full_cuda,
                                                 whole_ip_gate)

    def build(dt, options):
        return pathfollow_nmpc({**PF_NEWTON, **(options or {})}, dt)
    x0s = 0.1 * np.random.default_rng(3).standard_normal((B_MAIN, 2))
    two_routes("phase14(b) pathfollow_soft", build, x0s, report)
    data = np.load(GOLDEN_PF)
    tn = pathfollow_nmpc({**PF_NEWTON, "tol": 1e-9}, torch.float64)
    problem, why = whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is not None, why
    launch = WholeIPLaunch(problem, tn._dims, torch.float64, tn._bounds.lbx.device)
    tn._solve = lambda th, x0, X, U, mu0, options=None: launch(th, x0, X, U, mu0)
    solve_ocp_full_cuda.launches = 0
    devs, its = [], []
    for k in range(data["U_gold"].shape[0]):
        u = tn.optimize(data["X_meas"][k])
        assert tn.stats["converged"], (k, tn.stats)
        devs.append(float(np.abs(u - data["U_gold"][k]).max()))
        its.append(tn.stats["iterations"])
    log(f"phase14(b) golden pathfollow_soft replayed through the whole-solve "
        f"kernel's float64 instance: max|u - u_gold| {max(devs):.3e} over "
        f"{len(devs)} steps, {solve_ocp_full_cuda.launches} launches, iterations "
        f"{its}")
    assert max(devs) < 1e-4 and solve_ocp_full_cuda.launches == len(devs), devs
    report["phase14(b) pathfollow_soft"]["golden_max_abs_err"] = max(devs)


def phase14_cstr_generic(report):
    """(c) the flagship with a generic stage cost and a terminal measurement
    term."""
    def build(dt, options):
        return cstr_generic_nmpc(dt, options=options)
    two_routes("phase14(c) cstr_generic", build, flagship_x0s(), report)


def phase14_two_emitters(report):
    """(d) the flagship written by both emitters (ops/codegen_cuda.py's DSL
    route and ops/codegen_fx.py's trace), float32 at B=131072: equal
    iterations and U within 1e-5; each build's kernel ms, registers and
    spills."""
    import torch
    from hilo_mpc_tpu_torch.ops.codegen_fx import emit_fx_problem
    from hilo_mpc_tpu_torch.ops.whole_ip import WholeIPLaunch, whole_ip_problem
    nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
    args = nmpc.prepare_batch(flagship_x0s())
    nt, opts = args[0].shape[2], nmpc._ip_opts
    bnd = tuple(b.cpu().double().numpy() for b in nmpc._bounds)
    problems = {"dsl": whole_ip_problem(nmpc._funcs, nmpc._dims, nmpc._bounds, nt, opts),
                "traced": emit_fx_problem(nmpc._funcs, nmpc._dims, bnd, nt, opts)}
    assert "codegen_cuda.py" in problems["dsl"].text
    sols, out = {}, {}
    for name, problem in problems.items():
        launch = WholeIPLaunch(problem, nmpc._dims, torch.float32, args[0].device)
        ms = cuda_time_ms(lambda: launch.launch(*args, opts.mu_init))
        sols[name] = launch.launch(*args, opts.mu_init)
        regs = build_registers(problem)
        out[name] = dict(ms=ms, registers=regs["float32"], flops=problem.flops)
        log(f"phase14(d) flagship, {name} route: kernel {ms:.4f} ms one call, "
            f"{problem.flops} operations per scenario-iteration; registers "
            f"float32 {regs['float32'][0]} ({regs['float32'][1]} bytes spilled), "
            f"float64 {regs['float64'][0]} ({regs['float64'][1]} bytes spilled)")
    torch.cuda.synchronize()
    a, b = sols["dsl"], sols["traced"]
    dev = float((a.U - b.U).abs().max())
    eq = bool(torch.equal(a.iterations, b.iterations))
    log(f"phase14(d): equal iterations {eq}, max|U_dsl - U_traced| {dev:.3e}")
    assert eq and dev <= 1e-5, (eq, dev)
    report["phase14(d) two emitters"] = out


# the hybrid flagship's network for E (tests/golden_configs.py:152-170): a
# 2-8-1 tanh net whose weights are 0.3·N(0,1), biases 0.1·N(0,1) from
# default_rng(42), the output bias shifted by 1.0; phase 15(b) the same
# construction at 2-16-16-1
HYBRID_HIDDEN = {"a": (8,), "b": (16, 16)}
# phase 15's closed loops: the discrete-input double integrator's steps and
# horizon (tests/test_minlp.py), learned MPC's teacher batch, horizon,
# training and loop (tests/test_learned_mpc.py at fleet size)
MI_STEPS, MI_N, MI_LEVELS = 25, 12, (-1.0, 0.0, 1.0)
LEARNED_B, LEARNED_N, LEARNED_BATCH, LEARNED_EPOCHS, LEARNED_HELD_OUT = (
    65536, 10, 1024, 50, 1024)


def fixed_ann(hidden, device="cuda"):
    """The golden hybrid_ann's frozen network (weights rebuilt here from
    default_rng(42), as tests/golden_configs.py:_fixed_ann makes them),
    float64; ``hidden`` the widths of its tanh layers."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import ANN, Dense
    ann = ANN(["x_1", "x_2"], ["E"])
    ann.add_layers([Dense(h, activation="tanh") for h in hidden])
    ann.setup(normalize=False, device=device, dtype=torch.float64)
    rng = np.random.default_rng(42)
    params = [{"W": 0.3 * rng.standard_normal(tuple(p["W"].shape)),
               "b": 0.1 * rng.standard_normal(tuple(p["b"].shape))}
              for p in ann._params]
    params[-1]["b"] = params[-1]["b"] + 1.0
    ann._params = params
    return ann


def hybrid_nmpc(options, dtype, hidden=HYBRID_HIDDEN["a"], horizon=N, device="cuda"):
    """Phase 2's controller on the hybrid CSTR: E is the network's output,
    the other five parameters as before."""
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz() + fixed_ann(hidden, device))
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 5)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options},
               device=device, dtype=dtype)
    return nmpc


# golden hybrid_ann's options (tests/golden_configs.py:build_hybrid_ann); the
# whole-solve kernel takes them with pure Newton steps
HYBRID_GOLDEN = {"tol": 1e-9, "max_iter": 80}
HYBRID_GOLDEN_NEWTON = {**HYBRID_GOLDEN, "convexify": False, "n_linesearch": 1,
                        "mehrotra": False}


def hybrid_problems(device="cuda"):
    """{label: the emitted problem} of phase 15's traced builds: (a) the
    hybrid flagship, (b) its 2-16-16-1 variant (float32 controllers), (c)
    golden hybrid_ann's controller under pure Newton steps (N=15); and phase
    16(d)'s GP hybrid flagship."""
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import whole_ip_problem
    f32 = torch.float32
    builders = {"hybrid_2-8-1": lambda: hybrid_nmpc(FLAGSHIP, f32, device=device),
                "gp_hybrid": lambda: gp_hybrid_nmpc(FLAGSHIP, f32, device=device),
                "hybrid_2-16-16-1": lambda: hybrid_nmpc(FLAGSHIP, f32, HYBRID_HIDDEN["b"],
                                                        device=device),
                "hybrid_golden": lambda: hybrid_nmpc(HYBRID_GOLDEN_NEWTON, f32,
                                                     horizon=15, device=device)}
    out = {}
    for name, build in builders.items():
        nmpc = build()
        out[name] = whole_ip_problem(nmpc._funcs, nmpc._dims, nmpc._bounds,
                                     nmpc._funcs.source.n_theta, nmpc._ip_opts)
    return out


def phase15(report):
    """Discrete inputs and the first half of machine learning (module
    docstring)."""
    for part in (phase15_hybrid, phase15_wide_net, phase15_golden, phase15_discrete,
                 phase15_learned):
        t = time.perf_counter()
        part(report)
        log(f"{part.__name__} took {time.perf_counter() - t:.1f} s")


def phase15_hybrid(report):
    """(a) The hybrid flagship at B=131072, float32, through the general path
    and pallas_full, cold and warm."""
    g_ric, w_full, out = hybrid_routes(
        "phase15(a)", "hybrid flagship (2-8-1 tanh for E)",
        lambda options, dtype: hybrid_nmpc(options, dtype))
    report["riccati_lq"].setdefault("phase15_launches", {})["hybrid_general"] = g_ric
    report["whole_ip_traced"]["phase15_launches"] = {"hybrid": w_full}
    report["phase15(a)"] = out


def hybrid_routes(tag, what, build):
    """A hybrid flagship (``build(options, dtype)``) at B=131072, float32,
    through the general path and pallas_full, cold and warm: solves/s,
    converged >= 0.97, launches, the routes within the general path's
    float32 stray + 5e-4, the kernel against its plain version, kernel ms
    beside its bound, registers and spills. Returns (Riccati launches of
    the general path, whole-solve launches, the kernel's figures)."""
    import warnings

    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda
    f32, f64 = torch.float32, torch.float64
    general = build(FLAGSHIP, f32)
    whole = build({**FLAGSHIP, "pallas_full": True}, f32)
    x0s = flagship_x0s()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        whole.solve_batch_fn()(*whole.prepare_batch(x0s[:256]))   # untimed warm-up
    general.solve_batch_fn()(*general.prepare_batch(x0s[:256]))
    torch.cuda.synchronize()
    runs = {}
    for name, ctl in (("general path", general), ("whole-solve kernel", whole)):
        riccati_lq_cuda.launches = solve_ocp_full_cuda.launches = 0
        args, sol, sol_w, (t_prep, t_cold, t_warm) = timed_batch(ctl, x0s, warm=True)
        counts = (riccati_lq_cuda.launches, solve_ocp_full_cuda.launches)
        runs[name] = (args, sol, counts, t_cold)
        for kind, s_, t in (("cold", sol, t_cold), ("warm", sol_w, t_warm)):
            assert bool(torch.isfinite(s_.U).all()) and bool(torch.isfinite(s_.X).all())
            conv = float(s_.converged.float().mean())
            log(f"{tag} {what} {name} B={B_MAIN} "
                f"N={N} float32 {kind}: {B_MAIN / t:.1f} solves/s ({t:.4f} s wall), "
                f"converged {conv:.4f}, iterations p50 "
                f"{float(s_.iterations.float().median()):g} max {int(s_.iterations.max())}")
            assert conv >= 0.97, (name, kind, conv)
        log(f"{tag} {name}: prepare_batch {t_prep:.4f} s; riccati_lq launches "
            f"{counts[0]}, whole_ip launches {counts[1]}")
    (ga, gs, (g_ric, g_full), tg), (_, ws, (w_ric, w_full), tw) = runs.values()
    assert g_ric > 0 and g_full == 0, (g_ric, g_full)
    assert (w_ric, w_full) == (0, 2), (w_ric, w_full)
    # the routes are held as phase 11 holds them: the kernel within the
    # general path's float32 stray from the float64 answer plus 5e-4
    both = gs.converged & ws.converged
    dev = float((ws.U - gs.U).abs()[both].max())
    g64 = build(FLAGSHIP, f64)
    s64 = g64.solve_batch_fn()(*[a.double() for a in ga])
    torch.cuda.synchronize()
    j = both & s64.converged
    stray = float((gs.U.double() - s64.U).abs()[j].max())
    off = float((ws.U.double() - s64.U).abs()[j].max())
    log(f"{tag}: max|U_whole - U_general| on the jointly converged {dev:.3e} "
        f"({float(both.float().mean()):.4f}); against the float64 general path: "
        f"general {stray:.3e}, whole-solve {off:.3e}; the kernel route "
        f"{tg / tw:.1f}x the general path's cold solves/s")
    assert off <= stray + 5e-4, (off, stray)
    problem = whole._wip["problem"]
    err = traced_kernel_vs_plain(f"{tag} kernel vs plain", problem,
                                 {f32: whole, f64: g64}, ga)
    k_ms, bound, by = traced_kernel_ms(whole, ga, ws.iterations)
    regs = build_registers(problem)
    log(f"{tag} the traced build: kernel {k_ms:.4f} ms one call (cold "
        f"inputs), bound {bound:.4f} ms ({by}; {bound / k_ms:.1%}), "
        f"{problem.flops} operations per scenario-iteration; registers "
        f"float32 {regs['float32'][0]} ({regs['float32'][1]} bytes spilled), float64 "
        f"{regs['float64'][0]} ({regs['float64'][1]} bytes spilled)")
    return g_ric, w_full, dict(kernel_ms=k_ms, bound_ms=bound, flops=problem.flops,
                               registers=regs["float32"], max_abs_err=err)


def traced_kernel_ms(ctl, args, iterations):
    """(kernel ms one call, bound ms, what bounds it) of a controller's
    prepared whole-solve launch on ``args``, the bound from the operations
    of the iterations this run's scenarios took."""
    launch = next(iter(ctl._wip["launch"].values()))
    k_ms = cuda_time_ms(lambda: launch.launch(*args, ctl._mu_cold), reps=5)
    nbytes, flops = whole_ip_work(ctl._wip["problem"], ctl._dims, args[0].shape[0],
                                  args[0].shape[2], int(iterations.sum()))
    return (k_ms,) + bound_ms(nbytes, flops)


def phase15_wide_net(report):
    """(b) The same controller with a 2-16-16-1 network for E: the traced
    build's kernel ms, registers and spills beside (a)'s."""
    import warnings

    import torch
    f32, f64 = torch.float32, torch.float64
    whole = hybrid_nmpc({**FLAGSHIP, "pallas_full": True}, f32, HYBRID_HIDDEN["b"])
    args = whole.prepare_batch(flagship_x0s())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sol = whole.solve_batch_fn()(*args)
    torch.cuda.synchronize()
    conv = float(sol.converged.float().mean())
    problem = whole._wip["problem"]
    k_ms, bound, by = traced_kernel_ms(whole, args, sol.iterations)
    regs = build_registers(problem)
    a = report["phase15(a)"]
    log(f"phase15(b) hybrid flagship with a 2-16-16-1 tanh net, B={B_MAIN} float32: "
        f"converged {conv:.4f}, iterations p50 {float(sol.iterations.float().median()):g} "
        f"max {int(sol.iterations.max())}; kernel {k_ms:.4f} ms one call against (a)'s "
        f"{a['kernel_ms']:.4f} ({k_ms / a['kernel_ms']:.2f}x), bound {bound:.4f} ms ({by}; "
        f"{bound / k_ms:.1%}) against {a['bound_ms']:.4f}; {problem.flops} "
        f"operations per scenario-iteration against {a['flops']} "
        f"({problem.flops / a['flops']:.2f}x); registers float32 {regs['float32'][0]} "
        f"({regs['float32'][1]} bytes spilled) against {a['registers'][0]} "
        f"({a['registers'][1]}), float64 {regs['float64'][0]} ({regs['float64'][1]} "
        f"bytes spilled)")
    assert conv >= 0.97, conv
    g64 = hybrid_nmpc(FLAGSHIP, f64, HYBRID_HIDDEN["b"])
    traced_kernel_vs_plain("phase15(b) kernel vs plain", problem, {f32: whole, f64: g64},
                           args)
    report["phase15(b)"] = dict(kernel_ms=k_ms, flops=problem.flops,
                                registers=regs["float32"])


def phase15_golden(report):
    """(c) Golden hybrid_ann (N=15, tol 1e-9, float64) replayed on the card
    through the general path and through the whole-solve kernel's float64
    instance; the general path's replay on the CPU too."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.whole_ip import (WholeIPLaunch, solve_ocp_full_cuda,
                                                 whole_ip_gate)
    data = np.load(GOLDEN_HYBRID)
    f64 = torch.float64

    def replay(ctl):
        us, its = [], []
        for k in range(golden_steps(data)):
            us.append(ctl.optimize(data["X_meas"][k]))
            assert ctl.stats["converged"], (k, ctl.stats)
            its.append(ctl.stats["iterations"])
        return np.array(us), its
    walls, us = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        us[dev], its = replay(hybrid_nmpc(HYBRID_GOLDEN, f64, horizon=15, device=dev))
        walls[dev] = time.perf_counter() - t0
    u_gold = data["U_gold"][:golden_steps(data)]
    gold = float(np.abs(us["cuda"] - u_gold).max())
    cpu = float(np.abs(us["cuda"] - us["cpu"]).max())
    log(f"phase15(c) golden hybrid_ann (N=15, float64) general path: card "
        f"{walls['cuda']:.2f} s, CPU {walls['cpu']:.2f} s for {len(us['cuda'])} steps; "
        f"max|u - u_gold| {gold:.3e}, max|u_card - u_cpu| {cpu:.3e}; iterations {its}")
    assert gold < 1e-4 and cpu <= 1e-9, (gold, cpu)
    tn = hybrid_nmpc(HYBRID_GOLDEN_NEWTON, f64, horizon=15)
    problem, why = whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is not None, why
    launch = WholeIPLaunch(problem, tn._dims, f64, tn._bounds.lbx.device)
    tn._solve = lambda th, x0, X, U, mu0, options=None: launch(th, x0, X, U, mu0)
    solve_ocp_full_cuda.launches = 0
    u_k = replay(tn)[0]
    dev_k = float(np.abs(u_k - u_gold).max())
    log(f"phase15(c) golden hybrid_ann through the whole-solve kernel's float64 "
        f"instance: max|u - u_gold| {dev_k:.3e}, {solve_ocp_full_cuda.launches} "
        f"launches, max|u_kernel - u_general| {float(np.abs(u_k - us['cuda']).max()):.3e}")
    assert dev_k < 1e-4 and solve_ocp_full_cuda.launches == len(u_k), dev_k
    report["phase15(c)"] = dict(golden_max_abs_err=gold, kernel_golden_max_abs_err=dev_k,
                                card_vs_cpu=cpu)


def di_discrete_nmpc(device, horizon=MI_N, levels=MI_LEVELS, **opts):
    """tests/test_minlp.py's double integrator (dt 0.2) with u on the
    levels, float64."""
    import torch
    from hilo_mpc_tpu_torch import NMPC, Model
    m = Model()
    m.set_dynamical_states(["p", "v"])
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: torch.stack([x[..., 1], u[..., 0]], -1))
    c = NMPC(m)
    c.horizon = horizon
    c.quad_stage_cost.add_states(["p", "v"], weights=[10.0, 1.0], ref=[1.0, 0.0])
    c.quad_stage_cost.add_inputs("u", weights=0.1)
    c.quad_terminal_cost.add_states(["p", "v"], weights=[50.0, 5.0], ref=[1.0, 0.0])
    c.set_box_constraints(u_lb=min(levels), u_ub=max(levels))
    c.set_discrete_inputs("u", levels=list(levels))
    return c.setup(options={"dt": 0.2, "tol": 1e-6, **opts}, device=device,
                   dtype=torch.float64)


def discrete_loop(ctl, steps=MI_STEPS, timed=False):
    """The closed loop of tests/test_minlp.py (the plant the exact double
    integrator): moves, picks, stats per step, and (on the card) the wall
    of each step's candidate solve and its Riccati launches."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    refine, cand = ctl._mi_refine, []

    def timed_refine(*a):
        n0 = riccati_lq_cuda.launches
        out, t = synced(lambda: refine(*a))
        cand.append((t, riccati_lq_cuda.launches - n0))
        return out
    if timed:
        ctl._mi_refine = timed_refine
    x, us, stats, walls, launches = np.zeros(2), [], [], [], []
    for _ in range(steps):
        n0 = riccati_lq_cuda.launches
        u, t = synced(lambda: ctl.optimize(x)) if timed else (ctl.optimize(x), 0.0)
        walls.append(t)
        launches.append(riccati_lq_cuda.launches - n0)
        us.append(u)
        stats.append(dict(ctl.stats))
        x = np.array([x[0] + 0.2 * x[1] + 0.02 * u[0], x[1] + 0.2 * u[0]])
    return np.array(us), stats, x, walls, cand, launches


def phase15_discrete(report):
    """(d) Discrete inputs on the card: the 25-step loop (relaxed solve, then
    every candidate in one batched solve on the Riccati kernel), card
    against CPU; the exact mode at N=5."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    di_discrete_nmpc("cuda", horizon=4).optimize(np.zeros(2))        # untimed warm-up
    torch.cuda.synchronize()
    card = di_discrete_nmpc("cuda")
    us, stats, x, walls, cand, launches = discrete_loop(card, timed=True)
    us_cpu, stats_cpu, _, _, _, _ = discrete_loop(di_discrete_nmpc("cpu"))
    on_level = float(np.min(np.abs(us[:, :, None] - np.array(MI_LEVELS)), axis=2).max())
    picks = [s["mi_pick"] for s in stats]
    same = picks == [s["mi_pick"] for s in stats_cpu]
    du = float(np.abs(us - us_cpu).max())
    t_cand = np.array([c[0] for c in cand])
    relaxed = np.array(walls) - t_cand
    log(f"phase15(d) discrete inputs (levels {MI_LEVELS}, N={MI_N}, float64) "
        f"{MI_STEPS}-step loop on the card: {np.median(walls) * 1e3:.2f} ms per step "
        f"(median; relaxed solve {np.median(relaxed) * 1e3:.2f}, candidate solve "
        f"{np.median(t_cand) * 1e3:.2f}); C = {stats[0]['mi_candidates']}, feasible "
        f"{[s['mi_feasible'] for s in stats]}, mi_gap max "
        f"{max(s['mi_gap'] for s in stats):.3e}; riccati_lq launches per step "
        f"{launches} (the candidate solve's {[c[1] for c in cand]})")
    log(f"phase15(d): every move on a level (max distance {on_level:.1e}); final state "
        f"{x}; card against CPU: the same picks {same} ({picks}), max|Δu| {du:.3e}")
    assert on_level < 1e-12 and np.abs(x - [1.0, 0.0]).max() < 1e-4, (on_level, x)
    assert same and du <= 1e-9, (picks, du)
    assert all(c[1] > 0 for c in cand), cand
    exact = di_discrete_nmpc("cuda", horizon=5, levels=(-1.0, 0.0, 1.0))
    assert exact._mi["cand_enum"].shape == (243, 5, 1)
    n0 = riccati_lq_cuda.launches
    u, t = synced(lambda: exact.optimize(np.zeros(2)))
    log(f"phase15(d) exact mode N=5: {exact.stats['mi_candidates']} candidates, "
        f"{exact.stats['mi_feasible']} feasible, pick {exact.stats['mi_pick']}, u0 "
        f"{u[0]:g}, {t * 1e3:.1f} ms, riccati_lq launches {riccati_lq_cuda.launches - n0}")
    assert exact.stats["mi_candidates"] == 243 and u[0] in MI_LEVELS
    report["riccati_lq"].setdefault("phase15_launches", {})["discrete_loop"] = int(
        sum(launches))
    report["phase15(d)"] = dict(ms_per_step=float(np.median(walls)) * 1e3,
                                candidate_ms=float(np.median(t_cand)) * 1e3)


def phase15_learned(report):
    """(e) Learned MPC on the card: the teacher's batched solves, the student
    trained on the card, the student as a closed-loop policy, and its
    predictions at B=131072."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import ANN, NMPC, Dense, SimpleControlLoop
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    f32 = torch.float32
    eq = np.array(X_EQ)
    teacher = NMPC(cstr_schaffner_and_zeitz())
    teacher.horizon = LEARNED_N
    teacher.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=list(X_EQ))
    teacher.quad_stage_cost.add_inputs(weights=0.1)
    teacher.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    teacher.set_parameters([1.0] * 6)
    teacher.setup(options={"dt": 0.1}, device="cuda", dtype=f32)
    rng = np.random.default_rng(0)
    X_train = eq + rng.uniform(-0.15, 0.15, size=(LEARNED_B, 2))
    X_test = eq + rng.uniform(-0.1, 0.1, size=(LEARNED_HELD_OUT, 2))
    teacher.optimize_batch(X_train[:256])                            # untimed warm-up
    n0 = riccati_lq_cuda.launches
    (U_train, sol), t_teach = synced(lambda: teacher.optimize_batch(X_train))
    n_teach = riccati_lq_cuda.launches - n0
    conv = float(sol.converged.float().mean())
    U_test, _ = teacher.optimize_batch(X_test)
    ann = ANN(["x_1", "x_2"], ["u"])
    ann.add_layers([Dense(32, activation="tanh"), Dense(32, activation="tanh")])
    ann.setup(device="cuda", dtype=f32)
    _, t_train = synced(lambda: ann.train(batch_size=LEARNED_BATCH, epochs=LEARNED_EPOCHS,
                                          X=X_train, y=U_train, patience=60))
    err = float(np.median(np.abs(ann.predict(X_test) - U_test)))
    plant = cstr_plant(torch.float64)
    plant.set_initial_conditions([0.25, 0.12])
    plant.set_initial_parameter_values([1.0] * 6)
    _, t_loop = synced(lambda: SimpleControlLoop(plant, ann).run(40))
    final = float(np.linalg.norm(plant.solution["x:f"] - eq))
    X_big = eq + rng.uniform(-0.15, 0.15, size=(B_MAIN, 2))
    ann.predict(X_big[:256])
    _, t_pred = synced(lambda: ann.predict(X_big))
    fn, X_dev = ann.predict_fn(), torch.as_tensor(X_big, dtype=f32, device="cuda")
    with torch.no_grad():
        ms_dev = cuda_time_ms(lambda: fn(X_dev), reps=10)
    log(f"phase15(e) learned MPC: teacher optimize_batch B={LEARNED_B} N={LEARNED_N} "
        f"float32 {LEARNED_B / t_teach:.1f} solves/s ({t_teach:.4f} s), converged "
        f"{conv:.4f}, riccati_lq launches {n_teach}")
    log(f"phase15(e) student 2-32-32-1 tanh trained on the card: {LEARNED_EPOCHS} epochs "
        f"(batch {LEARNED_BATCH}, {max(1, int(LEARNED_B * 0.8) // LEARNED_BATCH)} steps "
        f"each) in {t_train:.2f} s, {LEARNED_EPOCHS / t_train:.2f} epochs/s; median "
        f"imitation error on {LEARNED_HELD_OUT} held-out states {err:.4f}; final loss "
        f"{float(ann.history['loss'][-1]):.3e}")
    log(f"phase15(e) the student as a 40-step SimpleControlLoop policy: {t_loop:.2f} s, "
        f"final |x - x_eq| {final:.4f}; predict at B={B_MAIN}: {B_MAIN / t_pred:.1f} "
        f"policies/s (numpy in and out, {t_pred * 1e3:.2f} ms), the network alone "
        f"{ms_dev:.4f} ms ({B_MAIN / ms_dev * 1e3:.3e} policies/s) against the "
        f"teacher's {LEARNED_B / t_teach:.1f} solves/s")
    assert conv > 0.98 and err < 0.05 and final < 0.02, (conv, err, final)
    report["riccati_lq"].setdefault("phase15_launches", {})["learned_teacher"] = n_teach


# phase 16: Gaussian processes and stochastic MPC. The golden smpc_chance
# problem (tests/golden_configs.py:build_smpc_chance), its spread of initial
# states, the card-against-CPU batch, the msd of examples/05_stochastic_smpc.py,
# the GP hybrid's training set and phase 16(e)'s GP work
SMPC_B_CHECK = 512
# the golden's steps that phase 16(c) also runs on the CPU
SMPC_GOLDEN_CPU_STEPS = 10
SMPC_X0, SMPC_SPREAD = (0.3, 0.0), (0.2, 0.1)
SMPC_GOLDEN = {"dt": 0.1, "tol": 1e-9, "max_iter": 80}
# the float32 controller, at the float32 tolerance of every other cell (the
# GP, set up in float64, predicts in float64: ml/gp/gp.py:predict_fn)
SMPC_F32 = {"dt": 0.1, "max_iter": 25, "tol": 1e-4}
GP_ARRAY_G, GP_ARRAY_N, GP_ARRAY_ITERS = 4, 256, 50
SVGP_N, SVGP_M, SVGP_BATCH, SVGP_STEPS = 4096, 32, 256, 200


def smpc_lin_model():
    """The golden's nominal model: a damped oscillator, callable, batch-first."""
    import torch
    from hilo_mpc_tpu_torch import Model
    m = Model(name="lin")
    m.set_dynamical_states(["x1", "x2"])
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -0.5 * x[..., 0] - 0.4 * x[..., 1] + u[..., 0]], dim=-1))
    return m


def smpc_golden_gp(device, dtype=None):
    """The golden's 25-point exact GP of the disturbance on x2 from x1, set
    up in float64 unless ``dtype`` says otherwise."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import GP
    rng = np.random.default_rng(3)
    X = np.linspace(-1.5, 1.5, 25)[:, None]
    y = 0.05 * np.sin(2 * X[:, 0]) + 0.02 * rng.standard_normal(25)
    gp = GP(["x1"], ["d"], noise_variance=0.02, device=device,
            dtype=dtype or torch.float64)
    gp.set_training_data(X, y)
    return gp.setup()


def smpc_chance_ctl(options, dtype, device="cuda"):
    """Golden smpc_chance's controller: N=10, x1 <= 0.9 at level 0.95, |u| <= 2."""
    import numpy as np
    from hilo_mpc_tpu_torch import SMPC
    smpc = SMPC(smpc_lin_model(), gps={"x2": smpc_golden_gp(device)}, dt=0.1)
    smpc.horizon = 10
    smpc.quad_stage_cost.add_states(names=["x1", "x2"], weights=[5.0, 1.0],
                                    ref=[0.85, 0.0])
    smpc.quad_stage_cost.add_inputs(weights=0.05)
    smpc.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    smpc.set_box_chance_constraints(x_ub=[0.9, np.inf], level=0.95)
    return smpc.setup(options=options, device=device, dtype=dtype)


def smpc_x0s(B, seed=16):
    """Initial states around the golden's x0, with P0 = 1e-4·I: (B, 6)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.asarray(SMPC_X0) + np.asarray(SMPC_SPREAD) * rng.standard_normal((B, 2))
    return np.concatenate([x, np.tile(1e-4 * np.eye(2).ravel(), (B, 1))], axis=1)


def phase16(report):
    """Gaussian processes and stochastic MPC (module docstring)."""
    for part in (phase16_smpc, phase16_feedback, phase16_golden, phase16_gp_hybrid,
                 phase16_gp_work):
        t = time.perf_counter()
        part(report)
        log(f"{part.__name__} took {time.perf_counter() - t:.1f} s")


def lq_of_solve(ctl, args):
    """The arguments of the first Riccati launch of one solve of ``args``
    (a spy in place of the kernel's wrapper, its launches not counted)."""
    import torch
    from hilo_mpc_tpu_torch.ops import cuda_kernels as ck
    kernel, seen = ck.riccati_lq_cuda, []

    def spy(*a, **kw):
        if not seen:
            seen.append([t.clone() if torch.is_tensor(t) else t for t in a])
        return kernel(*a, **kw)

    spy.launches = spy.free_x0_launches = 0
    ck.riccati_lq_cuda = spy
    try:
        ctl.solve_batch_fn()(*args)
    finally:
        ck.riccati_lq_cuda = kernel
    return seen[0]


def phase16_smpc(report):
    """(a) Golden smpc_chance's SMPC at B=B_SMPC, float32: the surrogate
    (nx = 6, nu = 1) through the Riccati kernel, cold and warm; the (6, 1)
    kernel against its plain version on this path's own LQ data; the
    card against the CPU at B=512 in float64; the SMPC without its chance
    row through both routes (the whole-solve kernel on the traced
    surrogate)."""
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (riccati_lq_cuda,
                                                     riccati_lq_reference)
    f32, f64 = torch.float32, torch.float64
    ctl = smpc_chance_ctl(SMPC_F32, f32)
    x0s = smpc_x0s(B_SMPC)
    lq = lq_of_solve(ctl, ctl.prepare_batch(x0s[:4096]))
    riccati_lq_cuda.launches = 0
    args, sol, sol_w, (t_prep, t_cold, t_warm) = timed_batch(ctl, x0s, warm=True)
    launches = riccati_lq_cuda.launches
    for kind, s_, t in (("cold", sol, t_cold), ("warm", sol_w, t_warm)):
        assert bool(torch.isfinite(s_.U).all()), kind
        conv = float(s_.converged.float().mean())
        log(f"phase16(a) SMPC golden smpc_chance (surrogate nx=6, N=10, chance "
            f"x1 <= 0.9 at 0.95) B={B_SMPC} float32 {kind}: {B_SMPC / t:.1f} solves/s "
            f"({t:.4f} s wall), converged {conv:.4f}, iterations p50 "
            f"{float(s_.iterations.float().median()):g} max {int(s_.iterations.max())}")
        assert conv >= 0.97, (kind, conv)
    log(f"phase16(a) prepare_batch {t_prep:.4f} s; riccati_lq launches {launches} "
        f"(cold + warm)")
    assert launches > 0
    P = sol.X[..., 2:].reshape(*sol.X.shape[:-1], 2, 2)
    assert bool((torch.diagonal(P, dim1=-2, dim2=-1)[sol.converged] >= -1e-6).all())
    ref = riccati_lq_reference(*lq, reg=1e-8)
    out = riccati_lq_cuda(*lq, reg=1e-8)
    torch.cuda.synchronize()
    names = ("dX", "dU", "lam", "K", "kff", "cost_red")
    errs = {}
    for name, a, b in zip(names, out, ref):
        torch.testing.assert_close(a, b, **lq_tol(name, True))
        errs[name] = float((a - b).abs().max())
    err = max(errs.values())
    Bt = lq[0].shape[0]
    ms = cuda_time_ms(lambda: riccati_lq_cuda(*lq, reg=1e-8))
    plain_ms = cuda_time_ms(lambda: riccati_lq_reference(*lq, reg=1e-8))
    b_ms, b_by = bound_ms(*riccati_lq_work(Bt, 10, 6, 1))
    log(f"phase16(a) riccati_lq (6, 1) on this path's first LQ step, B={Bt} N=10 "
        f"float32: max|kernel - plain| " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
        + f" (phase 1's tolerances); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%})")
    smpc_card_vs_cpu(x0s[:SMPC_B_CHECK])
    report["riccati_lq"].setdefault("phase16_launches", {})["smpc"] = launches
    report["phase16(a)"] = dict(riccati_6x1_max_abs_err=err, riccati_6x1_ms=ms)
    label = "phase16(a) SMPC without chance rows"
    two_routes(label, lambda dt, o: smpc_nochance_ctl({**SMPC_NEWTON, **(o or {})}, dt,
                                                      horizon=N),
               x0s[:B_LAST_SMPC], report, check_plain=False)
    report["whole_ip_smpc"]["launches"] = report[label]["launches"]


def smpc_card_vs_cpu(x0s):
    """Golden smpc_chance's controller (tol 1e-9, float64) on the card and
    on the CPU from the same prepared inputs: every scenario converged in
    both, U within 1e-9 where the iteration counts agree; a scenario whose
    KKT error lands on the tolerance on one side stops one iteration apart,
    and there U is held to 1e-7 (the share printed)."""
    import torch
    sols, walls = {}, {}
    for dev in ("cpu", "cuda"):
        ctl = smpc_chance_ctl(SMPC_GOLDEN, torch.float64, dev)
        t0 = time.perf_counter()
        sols[dev] = ctl.solve_batch_fn()(*ctl.prepare_batch(x0s))
        if dev == "cuda":
            torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    c, k = sols["cpu"], sols["cuda"]
    same = k.iterations.cpu() == c.iterations
    du = (k.U.cpu() - c.U).abs().flatten(1).amax(dim=1)
    eq = float(du[same].max())
    off = float(du[~same].max()) if bool((~same).any()) else 0.0
    log(f"phase16(a) SMPC card vs CPU float64 B={x0s.shape[0]}: card {walls['cuda']:.3f} "
        f"s, CPU {walls['cpu']:.3f} s; converged card "
        f"{float(k.converged.float().mean()):.4f} CPU {float(c.converged.float().mean()):.4f}, "
        f"iterations p50 {float(c.iterations.float().median()):g} max "
        f"{int(c.iterations.max())}; equal iterations on {float(same.float().mean()):.4f}, "
        f"max|U_card - U_cpu| there {eq:.3e}, elsewhere {off:.3e}")
    assert bool(c.converged.all()) and bool(k.converged.all())
    assert float(same.float().mean()) >= 0.95 and eq <= 1e-9 and off <= 1e-7, (eq, off)


def msd_smpc_gp(device):
    """examples/05_stochastic_smpc.py's 30-point GP of a friction residual,
    float64 (not fitted)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import GP
    rng = np.random.default_rng(0)
    V = rng.uniform(-1.5, 1.5, size=(30, 1))
    resid = -0.08 * np.tanh(3.0 * V[:, 0]) + 0.01 * rng.standard_normal(30)
    gp = GP(["vel"], ["d_vel"], noise_variance=1e-4, device=device, dtype=torch.float64)
    gp.set_training_data(V, resid)
    return gp.setup()


def phase16_feedback(report):
    """(b) examples/05_stochastic_smpc.py: the GP fitted on the card against
    the CPU (float64), then the feedback-gain SMPC (N=12) on B=131072 (float32
    at (a)'s options)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import SMPC, Model
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    gps, walls = {}, {}
    for dev in ("cuda", "cpu"):
        gps[dev] = msd_smpc_gp(dev)
        t0 = time.perf_counter()
        gps[dev].fit_model()
        walls[dev] = time.perf_counter() - t0
    nll = {d: -g.log_marginal_likelihood for d, g in gps.items()}
    rel = abs(nll["cuda"] - nll["cpu"]) / abs(nll["cpu"])
    hp = max(float(np.abs(a.value - b.value).max()) for a, b in
             zip(gps["cuda"].hyperparameters, gps["cpu"].hyperparameters))
    log(f"phase16(b) GP fit (30 points, SE, L-BFGS-B on torch's gradient) float64: "
        f"card {walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s; NLL card "
        f"{nll['cuda']:.12g} CPU {nll['cpu']:.12g} (relative {rel:.3e}), "
        f"hyperparameters max|Δ| {hp:.3e}")
    assert rel <= 1e-8, rel
    m = Model(name="msd")
    m.set_dynamical_states(["pos", "vel"])
    m.set_inputs("f")
    m.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -0.6 * x[..., 0] - 0.4 * x[..., 1] + u[..., 0]], dim=-1))
    smpc = SMPC(m, gps={"vel": gps["cuda"]}, feedback_gain=np.array([[1.0, 0.8]]),
                dt=0.1)
    smpc.horizon = 12
    smpc.quad_stage_cost.add_states(names=["pos", "vel"], weights=[5.0, 1.0],
                                    ref=[0.8, 0.0])
    smpc.quad_stage_cost.add_inputs(weights=0.1)
    smpc.set_box_constraints(u_lb=-2.0, u_ub=2.0)
    smpc.set_box_chance_constraints(x_ub=[0.85, np.inf], level=0.95)
    smpc.set_initial_covariance(np.eye(2) * 1e-4)
    smpc.setup(options=SMPC_F32, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(0)
    x0s = np.zeros((B_SMPC, 6))
    x0s[:, :2] = rng.normal([0.0, 0.0], [0.2, 0.1], size=(B_SMPC, 2))
    x0s[:, 2:] = np.tile(np.eye(2).ravel() * 1e-4, (B_SMPC, 1))
    smpc.optimize_batch(x0s[:256])
    riccati_lq_cuda.launches = 0
    t0 = time.perf_counter()
    u, sol = smpc.optimize_batch(x0s)
    t = time.perf_counter() - t0
    conv = float(sol.converged.float().mean())
    log(f"phase16(b) feedback-gain SMPC (K = [1.0, 0.8], N=12) optimize_batch "
        f"B={B_SMPC} float32: {B_SMPC / t:.1f} solves/s ({t:.4f} s wall), converged "
        f"{conv:.4f}, iterations p50 {float(sol.iterations.float().median()):g} max "
        f"{int(sol.iterations.max())}; riccati_lq launches {riccati_lq_cuda.launches}")
    assert np.all(np.isfinite(u)) and conv >= 0.9, conv
    report["riccati_lq"].setdefault("phase16_launches", {})[
        "smpc_feedback"] = riccati_lq_cuda.launches


def phase16_golden(report):
    """(c) Golden smpc_chance replayed in float64 on the card (its first
    GOLDEN_CARD_STEPS steps) and its first SMPC_GOLDEN_CPU_STEPS steps on
    the CPU."""
    import numpy as np
    import torch
    data = np.load(os.path.join(ROOT, "tests", "golden", "smpc_chance.npz"))
    us, walls, its = {}, {}, {}
    for dev, steps in (("cuda", golden_steps(data)), ("cpu", SMPC_GOLDEN_CPU_STEPS)):
        ctl = smpc_chance_ctl(SMPC_GOLDEN, torch.float64, dev)
        t0 = time.perf_counter()
        u_dev, it = [], []
        for k in range(steps):
            u_dev.append(ctl.optimize(data["X_meas"][k]))
            assert ctl.stats["converged"], (dev, k, ctl.stats)
            it.append(ctl.stats["iterations"])
        walls[dev], us[dev], its[dev] = time.perf_counter() - t0, np.array(u_dev), it
    n_cpu = SMPC_GOLDEN_CPU_STEPS
    gold = float(np.abs(us["cuda"] - data["U_gold"][:golden_steps(data)]).max())
    cpu = float(np.abs(us["cuda"][:n_cpu] - us["cpu"]).max())
    same = its["cuda"][:n_cpu] == its["cpu"]
    log(f"phase16(c) golden smpc_chance (N=10, float64): card {walls['cuda']:.2f} s for "
        f"{len(us['cuda'])} steps, max|u - u_gold| {gold:.3e}; the CPU's first {n_cpu} "
        f"steps {walls['cpu']:.2f} s, max|u_card - u_cpu| {cpu:.3e}, iterations equal "
        f"{same}")
    assert gold < 1e-4 and cpu <= 1e-9 and same, (gold, cpu)
    report["phase16(c)"] = dict(golden_max_abs_err=gold, card_vs_cpu=cpu)


def gp_hybrid_gp(device="cuda"):
    """An exact SE-kernel GP of the CSTR's E from the states (16 points,
    float64)."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import GP
    rng = np.random.default_rng(5)
    X = rng.uniform([0.0, 0.0], [0.6, 0.4], (16, 2))
    y = 1.0 + 0.1 * np.sin(4.0 * X[:, 0]) - 0.05 * X[:, 1]
    gp = GP(["x_1", "x_2"], ["E"], noise_variance=0.01, device=device,
            dtype=torch.float64)
    gp.set_training_data(X, y)
    return gp.setup()


def gp_hybrid_nmpc(options, dtype, device="cuda"):
    """Phase 2's controller on the CSTR whose E is the GP's posterior mean."""
    from hilo_mpc_tpu_torch import NMPC
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    nmpc = NMPC(cstr_schaffner_and_zeitz() + gp_hybrid_gp(device))
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 5)
    return nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options},
                      device=device, dtype=dtype)


def phase16_gp_hybrid(report):
    """(d) The CSTR flagship with E the GP's posterior mean, through the
    general path and through pallas_full (the traced whole-solve kernel)."""
    g_ric, w_full, out = hybrid_routes("phase16(d)", "GP hybrid flagship (E a 16-point "
                                       "SE GP's mean)", gp_hybrid_nmpc)
    report["riccati_lq"].setdefault("phase16_launches", {})["gp_hybrid_general"] = g_ric
    report["whole_ip_traced"]["phase16_launches"] = {"gp_hybrid": w_full}
    report["phase16(d)"] = out


def phase16_gp_work(report):
    """(e) Exact predict at B=131072 queries, GPArray's batched L-BFGS fit
    and an SVGP minibatch fit, each on the card (float64), the first two
    against the CPU."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import GP, GPArray
    rng = np.random.default_rng(17)
    Xq = rng.uniform([0.0, 0.0], [0.6, 0.4], (B_MAIN, 2))
    out = {}
    for dev in ("cuda", "cpu"):
        gp = gp_hybrid_gp(dev)
        gp.predict(Xq[:1024])
        t0 = time.perf_counter()
        out[dev] = gp.predict(Xq)
        out[dev + "_s"] = time.perf_counter() - t0
    dmu = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    dvar = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    log(f"phase16(e) exact predict B={B_MAIN} float64: card {out['cuda_s']:.4f} s "
        f"({B_MAIN / out['cuda_s']:.0f} queries/s), CPU {out['cpu_s']:.4f} s; "
        f"max|Δmu| {dmu:.3e}, max|Δvar| {dvar:.3e}")
    assert dmu <= 1e-10 and dvar <= 1e-10, (dmu, dvar)

    X = rng.uniform(-2.0, 2.0, (GP_ARRAY_N, 2))
    ys = [np.sin((g + 1) * X[:, 0]) + 0.3 * X[:, 1] ** 2
          + 0.05 * rng.standard_normal(GP_ARRAY_N) for g in range(GP_ARRAY_G)]
    fits, walls = {}, {}
    for dev in ("cuda", "cpu"):
        arr = GPArray(GP_ARRAY_G)
        for g, y in enumerate(ys):
            arr[g] = GP(["a", "b"], ["y"], noise_variance=0.3, device=dev,
                        dtype=torch.float64)
            arr[g].set_training_data(X, y)
        t0 = time.perf_counter()
        arr.fit_model_batched(max_iter=GP_ARRAY_ITERS, solver="lbfgs")
        walls[dev], fits[dev] = time.perf_counter() - t0, arr.last_fit_nll
    rel = float(np.abs(fits["cuda"] / fits["cpu"] - 1.0).max())
    log(f"phase16(e) GPArray.fit_model_batched lbfgs {GP_ARRAY_G} outputs x "
        f"{GP_ARRAY_N} points, {GP_ARRAY_ITERS} iterations float64: card "
        f"{walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s; final NLLs card "
        f"{np.round(fits['cuda'], 6).tolist()}, relative to the CPU's {rel:.3e}")
    assert rel <= 1e-8, rel

    Xs = rng.uniform(-3.0, 3.0, (SVGP_N, 1))
    ysv = np.sin(2.0 * Xs[:, 0]) + 0.1 * rng.standard_normal(SVGP_N)
    gp = GP(["a"], ["y"], noise_variance=0.3, inference="svgp", device="cuda",
            dtype=torch.float64,
            inference_options={"n_inducing": SVGP_M, "batch_size": SVGP_BATCH,
                               "fit_seed": 0})
    gp.set_training_data(Xs, ysv)
    elbo0 = gp.log_marginal_likelihood
    t0 = time.perf_counter()
    gp.fit_model(max_iter=SVGP_STEPS, learning_rate=5e-2)
    t = time.perf_counter() - t0
    elbo = gp.log_marginal_likelihood
    log(f"phase16(e) SVGP minibatch Adam fit (n={SVGP_N}, m={SVGP_M}, batch "
        f"{SVGP_BATCH}, {SVGP_STEPS} steps) float64 on the card: {t:.3f} s "
        f"({SVGP_STEPS / t:.1f} steps/s); full-batch ELBO {elbo0:.6g} -> {elbo:.6g}")
    assert np.isfinite(elbo) and elbo > elbo0, (elbo0, elbo)
    report["phase16(e)"] = dict(predict_s=out["cuda_s"], gparray_s=walls["cuda"],
                                svgp_s=t)


# phase 17: dense programs (float64), the batch split over the visible
# cards, a world-size-1 NCCL group and the embedded C export
# the dense QP's batch: above n = 32 cuSOLVER's batched eigh takes the
# matrices one at a time (0.75 ms per 64 x 64 float64 matrix on the H100,
# phase 17(a)), so every iteration costs ~0.2 s at 256, 0.77 s at 1024 and
# ~6 s at 8192
B_QP = 256
N_QP, M_QP = 64, 32
B_FUSED, STEPS_FUSED = 8192, 5
B_GROUP = 16384
GRAFT_OPTS = {"tol": 1e-3, "max_iter": 8, "convexify": False, "n_linesearch": 1,
              "mu_init": 1e-2, "mehrotra": False}
CSTR_DSL = """
dx_1/dt = -a_1*x_1(t) + b_1*r
dx_2/dt = -a_2*x_2(t) + b_2*r + g*u(k)
y(k) = x_2(t)
r = (1 - x_1(t))*exp(-E/(1 + x_2(t)))
"""


def phase17(report):
    """Dense programs, batches over devices and processes, the embedded
    export (module docstring)."""
    for part in (phase17_programs, phase17_sharded, phase17_group, phase17_embedded):
        t = time.perf_counter()
        part(report)
        log(f"{part.__name__} took {time.perf_counter() - t:.1f} s")


def sweep_program(device):
    """min |x - p|^2 s.t. x0 + x1 >= 1 (tests/test_programs_data.py:26-38
    shifted by p), float64."""
    import torch
    from hilo_mpc_tpu_torch import NLP
    nlp = NLP()
    nlp.set_decision_variables(2).set_parameters(2)
    nlp.set_objective(lambda x, p: torch.sum((x - p) ** 2))
    nlp.set_constraints(lambda x: x[0] + x[1], lb=1.0)
    return nlp.setup(device=device)


def dense_qp(device, tol=1e-8):
    """min 1/2 x'Hx + c'x s.t. |x| <= 1, A x <= 1: H (SPD) and A shared,
    from default_rng(17), c the program's parameter; and the B_QP values
    of c from the same stream. ``tol`` the interior point's KKT tolerance."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import QP
    rng = np.random.default_rng(17)
    M = rng.standard_normal((N_QP, N_QP))
    H = M @ M.T / N_QP + np.eye(N_QP)
    A = rng.standard_normal((M_QP, N_QP))
    C = rng.standard_normal((B_QP, N_QP))
    Ht = torch.as_tensor(H, dtype=torch.float64, device=device)
    qp = QP()
    qp.set_decision_variables(N_QP).set_parameters(N_QP)
    qp.set_objective(lambda x, p: 0.5 * x @ Ht @ x + p @ x)
    qp.set_linear_constraints(A=A, ub=1.0)
    return qp.setup(options={"tol": tol}, device=device), C


def program_check(label, sol, cpu, seconds, x_tol, f_tol):
    """Log programs/s, the converged share, iterations and the first
    programs card against CPU (x, f, iterations); assert the bars: x within
    ``x_tol``, f within ``f_tol`` relative, equal iterations on >= 0.95 of them
    (a program whose KKT error lands within rounding of tol stops one
    iteration apart on the two devices)."""
    B = sol.x.shape[0]
    conv = float(sol.converged.double().mean())
    it = sol.iterations.float()
    n = cpu.x.shape[0]
    same = sol.iterations[:n].cpu() == cpu.iterations
    err = (sol.x[:n].cpu() - cpu.x).abs().amax(dim=1)
    dev_same = float(err[same].max()) if bool(same.any()) else 0.0
    dev_rest = float(err[~same].max()) if not bool(same.all()) else 0.0
    f_rel = float(((sol.f[:n].cpu() - cpu.f).abs() / cpu.f.abs().clamp(min=1.0)).max())
    share = float(same.double().mean())
    log(f"phase17(a) {label} B={B} float64: {B / seconds:.1f} programs/s ({seconds:.4f} s "
        f"wall), converged {conv:.5f}, iterations p50 {float(it.median()):g} max "
        f"{int(it.max())}; first {n} card vs CPU: equal iterations on {share:.4f}, "
        f"max|x_card - x_cpu| {dev_same:.3e} there and {dev_rest:.3e} on the rest, "
        f"max|f_card - f_cpu| / max(1, |f|) {f_rel:.3e}")
    assert conv >= 0.99 and share >= 0.95 and max(dev_same, dev_rest) <= x_tol, (
        conv, share, dev_same, dev_rest)
    assert f_rel <= f_tol, f_rel
    return B / seconds, share


def phase17_programs(report):
    """(a) The parameter sweep at B=131072 and the dense QP (n = 64, m = 32)
    on the card in float64, card against CPU, the sweep against SLSQP."""
    import numpy as np
    from scipy.optimize import minimize
    P = np.random.default_rng(17).uniform(-2.0, 2.0, (B_MAIN, 2))
    box = dict(lbx=[-5.0, -5.0], ubx=[5.0, 5.0])
    card, cpu = sweep_program("cuda"), sweep_program("cpu")
    card.solve_batch(x0=np.zeros((256, 2)), p=P[:256], **box)       # untimed warm-up
    sol, t = synced(lambda: card.solve_batch(x0=np.zeros((B_MAIN, 2)), p=P, **box))
    ref = cpu.solve_batch(x0=np.zeros((B_CHECK, 2)), p=P[:B_CHECK], **box)
    sweep_rate, sweep_same = program_check("parameter sweep (n=2, m=1)", sol, ref, t, 1e-9,
                                            1e-12)
    assert sweep_same == 1.0, sweep_same
    dev = 0.0
    for i in range(16):
        p = P[i]
        # SLSQP's default ftol (1e-6) left it 3.7e-4 off the projection
        # here (H100 host); at 1e-12 it is a reference
        res = minimize(lambda x: float(np.sum((x - p) ** 2)), np.zeros(2), method="SLSQP",
                       bounds=[(-5.0, 5.0)] * 2, options={"ftol": 1e-12, "maxiter": 200},
                       constraints=[{"type": "ineq", "fun": lambda x: x[0] + x[1] - 1.0}])
        dev = max(dev, float(np.abs(sol.x[i].cpu().numpy() - res.x).max()))
    log(f"phase17(a) first 16 programs against SciPy's SLSQP (ftol 1e-12): max|x - "
        f"x_slsqp| {dev:.3e}")
    assert dev <= 1e-5, dev
    (card, C), (cpu, _) = dense_qp("cuda"), dense_qp("cpu")
    box = dict(lbx=-np.ones(N_QP), ubx=np.ones(N_QP))
    card.solve_batch(x0=np.zeros((8, N_QP)), p=C[:8], **box)        # untimed warm-up
    sol, t = synced(lambda: card.solve_batch(x0=np.zeros((B_QP, N_QP)), p=C, **box))
    x0c = np.zeros((B_CHECK, N_QP))
    ref = cpu.solve_batch(x0=x0c, p=C[:B_CHECK], **box)
    # the QP's barrier Newton systems near the solution have condition
    # numbers ~1e10 (z/s of the active rows), so at the KKT tolerance 1e-8
    # the card's and the CPU's eigh rounding leaves x ~3e-8 apart; held
    # here to 1e-6 (f to 1e-7 relative), and to 1e-9 at tol 1e-11 below
    qp_rate, qp_same = program_check(f"dense QP (n={N_QP}, m={M_QP})", sol, ref, t, 1e-6,
                                     1e-7)
    # two witnesses that the gap is rounding: the CPU against itself with c
    # moved by 1e-15 relative, and both devices at the tighter tol 1e-11
    C_moved = C[:B_CHECK] * (1.0 + 1e-15 * np.random.default_rng(1).standard_normal(
        (B_CHECK, N_QP)))
    moved, t_moved = synced(lambda: cpu.solve_batch(x0=x0c, p=C_moved, **box))
    same = moved.iterations == ref.iterations
    log(f"phase17(a) dense QP tol 1e-8, the CPU against itself with c moved by 1e-15 "
        f"relative: equal iterations on {float(same.double().mean()):.4f}, max|dx| "
        f"{float((moved.x - ref.x).abs().max()):.3e} ({t_moved:.2f} s)")
    (card, _), (cpu, _) = dense_qp("cuda", 1e-11), dense_qp("cpu", 1e-11)
    tight, t_card = synced(lambda: card.solve_batch(x0=x0c, p=C[:B_CHECK], **box))
    tight_ref, t_cpu = synced(lambda: cpu.solve_batch(x0=x0c, p=C[:B_CHECK], **box))
    d_it = (tight.iterations.cpu() - tight_ref.iterations).abs()
    dx = float((tight.x.cpu() - tight_ref.x).abs().max())
    df = float(((tight.f.cpu() - tight_ref.f).abs() / tight_ref.f.abs().clamp(min=1.0)).max())
    tight_same = float((d_it == 0).double().mean())
    log(f"phase17(a) dense QP tol 1e-11, first {B_CHECK} card vs CPU: converged "
        f"{float(tight.converged.double().mean()):.4f}/"
        f"{float(tight_ref.converged.double().mean()):.4f}, equal iterations on "
        f"{tight_same:.4f} (max |d it| {int(d_it.max())}), max|x_card - x_cpu| {dx:.3e}, "
        f"max|f_card - f_cpu| / max(1, |f|) {df:.3e} (card {t_card:.2f} s, CPU "
        f"{t_cpu:.2f} s)")
    # a program whose KKT error lands within rounding of tol stops one
    # iteration apart, with x still within the bar (the extra iteration
    # moves it by less than the rounding between the devices)
    assert bool(tight.converged.all()) and bool(tight_ref.converged.all())
    assert dx <= 1e-9 and df <= 1e-12 and int(d_it.max()) <= 1 and tight_same >= 0.9, (
        dx, df, tight_same)
    # the eigenvalue clip's library call at the QP's shapes: above n = 32
    # cuSOLVER's batched eigh takes the matrices one at a time, so a batch
    # of 2·B_QP costs 2x that of B_QP
    import torch
    from hilo_mpc_tpu_torch.ops.ip_solver import _eigh
    eigh_s = {}
    for B, n in ((B_QP, 32), (B_QP, N_QP), (2 * B_QP, N_QP)):
        M = torch.randn(B, n, n, dtype=torch.float64, device="cuda")
        M = M @ M.transpose(1, 2)
        _eigh(M[:8])
        eigh_s[f"{B}x{n}"] = synced(lambda: _eigh(M))[1]
    log(f"phase17(a) batched eigh of float64 matrices: " + ", ".join(
        f"{k} {v:.4f} s ({v / int(k.split('x')[0]) * 1e3:.4f} ms per matrix)"
        for k, v in eigh_s.items()))
    report["phase17(a)"] = dict(sweep_programs_per_s=sweep_rate, qp_programs_per_s=qp_rate,
                                qp_equal_iterations=qp_same, qp_tight_dx=dx,
                                qp_tight_equal_iterations=tight_same, eigh_s=eigh_s)


def phase17_sharded(report):
    """(b) The batch split over the visible cards: phase 2's flagship
    through sharded_solve_fn (U against phase 2's, the in-solve stats
    against the host's), phase 7's MHE windows through
    estimate_batch(mesh=), the fused loop on a sharded x0."""
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.parallel import (convergence_stats, fused_closed_loop_fn,
                                             make_mesh, shard_batch, sharded_solve_fn)
    f32 = torch.float32
    mesh = make_mesh()
    log(f"phase17(b) mesh over the visible cards: {mesh.size} "
        f"({', '.join(torch.cuda.get_device_name(d) for d in mesh.devices.flat)})")
    nmpc = build_cstr_nmpc(FLAGSHIP, f32)
    args = nmpc.prepare_batch(flagship_x0s())
    one, split = nmpc.solve_batch_fn(), sharded_solve_fn(nmpc, mesh, with_stats=True)
    small = [a[:256 * mesh.size] for a in args]
    one(*small)
    split(*small)                                                    # untimed warm-ups
    walls, launches = {"one": [], "sharded": []}, {}
    for kind in ("one", "sharded", "sharded", "one"):
        riccati_lq_cuda.launches = 0
        out, t = synced(lambda: (one if kind == "one" else split)(*args))
        walls[kind].append(t)
        launches[kind] = riccati_lq_cuda.launches
        if kind == "sharded":
            sol, stats = out
    U = torch.cat([u.to(args[0].device) for u in sol.U.shards])
    U2 = report["phase2"].U
    same = bool(torch.equal(U, U2))
    dev = float((U - U2).abs().max())
    host = convergence_stats(sol)
    pairs = {k: (float(stats[k]), float(host[k])) for k in host}
    log(f"phase17(b) sharded flagship B={B_MAIN} float32 over {mesh.size} shard(s): "
        f"{B_MAIN / min(walls['sharded']):.1f} solves/s (walls "
        f"{', '.join(f'{w:.4f}' for w in walls['sharded'])} s) against the unsharded "
        f"solve's {B_MAIN / min(walls['one']):.1f} (walls "
        f"{', '.join(f'{w:.4f}' for w in walls['one'])} s), in turns; riccati_lq launches "
        f"{launches['sharded']} (unsharded {launches['one']}); U against phase 2's: equal "
        f"bits {same}, max|dU| {dev:.3e}")
    log(f"phase17(b) batch_stats against convergence_stats: " + ", ".join(
        f"{k} {a:g}/{b:g}" for k, (a, b) in pairs.items()))
    assert launches["sharded"] > 0
    if mesh.size == 1:
        assert same and launches["sharded"] == launches["one"], (dev, launches)
    for k, (a, b) in pairs.items():
        assert a == b or (k == "kkt_p50" and abs(a - b) <= 1e-6 * abs(b)), (k, a, b)

    mhe = build_mhe(cstr_schaffner_and_zeitz(), f32, 1e-4, 1e-3, 0.1 * np.eye(2),
                    p=[1.0] * 6)
    Ys, Us, x_arr, _ = mhe_cstr_windows(B_MAIN)
    w = 256 * mesh.size
    mhe.estimate_batch(Ys[:w], Us[:w], x_arrivals=x_arr[:w], mesh=mesh)   # warm-up
    runs, mhe_walls = {}, {"one": [], "mesh": []}
    for kind in ("one", "mesh", "mesh", "one"):
        riccati_lq_cuda.launches = riccati_lq_cuda.free_x0_launches = 0
        runs[kind] = synced(lambda: mhe.estimate_batch(
            Ys, Us, x_arrivals=x_arr, mesh=mesh if kind == "mesh" else None))
        runs[kind] += (riccati_lq_cuda.free_x0_launches,)
        mhe_walls[kind].append(runs[kind][1])
    (x1, s1), _, l1 = runs["one"]
    (x2, s2), _, l2 = runs["mesh"]
    t2 = min(mhe_walls["mesh"])
    conv = float(np.asarray(s2.converged).mean())
    mdev = float(np.abs(x2 - x1).max())
    log(f"phase17(b) MHE estimate_batch(mesh=) B={B_MAIN} float32: walls "
        f"{', '.join(f'{w:.4f}' for w in mhe_walls['mesh'])} s against "
        f"{', '.join(f'{w:.4f}' for w in mhe_walls['one'])} s without a mesh, in turns; "
        f"free-x0 launches {l2} ({l1}); converged {conv:.4f}; max|x_est_mesh - x_est| "
        f"{mdev:.3e}")
    assert l2 > 0 and conv >= 0.97, (l2, conv)
    if mesh.size == 1:
        assert mdev == 0.0 and l1 == l2, (mdev, l1, l2)

    ctrl = build_cstr_nmpc(GRAFT_OPTS, f32, horizon=4)
    run = fused_closed_loop_fn(ctrl, cstr_plant(f32), STEPS_FUSED, plant_p=np.ones(6))
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(17).standard_normal(
        (B_FUSED, 2))
    x0t = torch.as_tensor(x0s, dtype=f32, device="cuda")
    run(shard_batch(x0t[:256 * mesh.size], mesh))                  # untimed warm-up
    riccati_lq_cuda.launches = 0
    res, t = synced(lambda: run(shard_batch(x0t, mesh)))
    loop_l = riccati_lq_cuda.launches
    ref, t1 = synced(lambda: run(x0t))
    conv = float(np.asarray(res.converged).mean())
    X = torch.cat([x.to(x0t.device) for x in res.X.shards])
    ldev = float((X - ref.X).abs().max())
    log(f"phase17(b) fused_closed_loop_fn on a sharded x0, B={B_FUSED}, {STEPS_FUSED} "
        f"steps, N=4 float32: {t:.4f} s wall ({t1:.4f} s unsharded), riccati_lq "
        f"launches {loop_l}, converged {conv:.5f}, max|X_sharded - X| {ldev:.3e}")
    assert conv > 0.97 and loop_l > 0, (conv, loop_l)
    if mesh.size == 1:
        assert ldev == 0.0, ldev
    report["riccati_lq"].setdefault("phase17_launches", {}).update(
        sharded_flagship=launches["sharded"], fused_loop=loop_l)
    report["riccati_lq_free_x0"].setdefault("phase17_launches", {})["sharded_mhe"] = l2
    report["phase17(b)"] = dict(sharded_s=min(walls["sharded"]), one_s=min(walls["one"]),
                                mhe_s=t2, loop_s=t)


def phase17_group(report):
    """(b) A world-size-1 NCCL group on a loopback TCP store: initialize,
    local_slice, global_batch and the all-reduced batch_stats against the
    host's figures; the group destroyed at the end."""
    import socket
    import torch
    import torch.distributed
    from hilo_mpc_tpu_torch.parallel import convergence_stats, sharded_solve_fn
    from hilo_mpc_tpu_torch.parallel import distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    multi = dist.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda", timeout_s=60)
    t_init = time.perf_counter() - t0
    try:
        assert multi is False and dist.in_group() and dist.initialize() is False
        assert torch.distributed.get_backend() == "nccl"
        sl = dist.local_slice(B_GROUP)
        assert sl == slice(0, B_GROUP), sl
        mesh = dist.global_mesh()
        nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
        args = dist.global_batch(nmpc.prepare_batch(flagship_x0s(B_GROUP)[sl]), mesh)
        assert args[1].in_group and args[1].offset == 0 and args[1].global_rows == B_GROUP
        (sol, stats), t = synced(lambda: sharded_solve_fn(nmpc, mesh, with_stats=True)(*args))
        host = convergence_stats(sol)
        gathered = dist.all_gather_rows(torch.cat(sol.U.shards))
        same_u = bool(torch.equal(gathered, torch.cat(sol.U.shards)))
        bad = [k for k in host if float(stats[k]) != float(host[k])
               and not (k == "kkt_p50" and abs(float(stats[k]) - host[k]) <= 1e-6 * host[k])]
        log(f"phase17(b) NCCL group of 1 on 127.0.0.1:{port} (set up in {t_init:.2f} s): "
            f"local_slice {sl}, global batch {args[1].global_rows} rows at offset "
            f"{args[1].offset}; solve {t:.4f} s; all-reduced stats "
            f"{ {k: float(v) for k, v in stats.items()} } against the host's: differing "
            f"{bad}; all-gathered U equal {same_u}")
        assert not bad and same_u, (bad, same_u)
    finally:
        torch.distributed.destroy_process_group()
    assert not dist.in_group()


def cstr_dsl_model():
    from hilo_mpc_tpu_torch import Model
    m = Model(name="cstr")
    m.set_equations(CSTR_DSL)
    return m


def phase17_embedded(report):
    """(c) The embedded C export compiled by the host's compiler, each
    against the port's controller or estimator on the card (float64)."""
    import tempfile
    import numpy as np
    import torch
    from hilo_mpc_tpu_torch import EKF, LMPC, LQR, MHE, PID
    from hilo_mpc_tpu_torch.embedded import (compile_shared, find_c_compiler,
                                             generate_ekf_c, generate_mhe_c,
                                             generate_nmpc_c, load_ekf, load_mhe,
                                             load_nmpc, setup_solver)
    f64 = torch.float64
    cc = find_c_compiler()
    work = tempfile.mkdtemp(prefix="chip_smoke_embedded_")
    out = {}
    nmpc = build_cstr_nmpc({}, f64)
    t0 = time.perf_counter()
    src = generate_nmpc_c(nmpc, os.path.join(work, "nmpc.c"))
    t1 = time.perf_counter()
    cstep = load_nmpc(compile_shared(src), 2, 1)
    t2 = time.perf_counter()
    plant = cstr_plant(f64, "cpu")
    plant.set_initial_conditions([0.2, 0.1])
    plant.set_initial_parameter_values([1.0] * 6)
    x, du, tc, tg = np.array([0.2, 0.1]), 0.0, [], []
    for _ in range(12):
        a = time.perf_counter()
        u_c = cstep(x)
        b = time.perf_counter()
        u_g = np.asarray(nmpc.optimize(x)).ravel()
        c = time.perf_counter()
        tc.append(b - a)
        tg.append(c - b)
        du = max(du, abs(float(u_c[0]) - float(u_g[0])))
        x = plant.simulate(u=u_g, steps=1)["x"][-1]
    log(f"phase17(c) NMPC (CSTR, N=20) exported to C ({t1 - t0:.3f} s) and compiled by "
        f"{cc} ({t2 - t1:.3f} s); 12 steps: C {np.median(tc) * 1e3:.3f} ms per step, "
        f"NMPC.optimize on the card {np.median(tg) * 1e3:.2f} ms per step (medians); "
        f"max|u_C - u_card| {du:.3e}")
    assert du < 2e-4, du
    out.update(nmpc_c_ms=np.median(tc) * 1e3, nmpc_card_ms=np.median(tg) * 1e3, nmpc_du=du)

    ekf = EKF(cstr_dsl_model())
    ekf.Q, ekf.R = np.diag([1e-4, 2e-4]), np.array([[1e-4]])
    ekf.set_initial_parameter_values([1.0] * 6)
    ekf.setup(dt=0.1, device="cuda", dtype=f64)
    step_c = load_ekf(compile_shared(generate_ekf_c(ekf, os.path.join(work, "ekf.c"))),
                      nx=2, ny=1, nu=1)
    step = ekf.step_fn()
    g = lambda a: torch.as_tensor(np.asarray(a, float), dtype=f64, device="cuda")  # noqa: E731
    rng = np.random.default_rng(0)
    xh, Ph = np.array([0.25, 0.08]), 0.05 * np.eye(2)
    xc, Pc, xt, dev, tc, tg = xh.copy(), Ph.copy(), np.array([0.2, 0.1]), 0.0, [], []
    for k in range(30):
        u = np.array([0.3 * np.sin(0.2 * k)])
        xt = plant.simulate(x0=xt, u=u, steps=1)["x"][-1]
        y = np.array([xt[1] + 0.002 * rng.standard_normal()])
        a = time.perf_counter()
        x_n, P_n, _ = step(g(xh), g(Ph), g(u), g(np.ones(6)), g(y), k * 0.1)
        xh, Ph = x_n.cpu().numpy(), P_n.cpu().numpy()
        b = time.perf_counter()
        xc, Pc = step_c(xc, Pc, u, y, t=k * 0.1)
        c = time.perf_counter()
        tg.append(b - a)
        tc.append(c - b)
        dev = max(dev, float(np.abs(xc - xh).max()), float(np.abs(Pc - Ph).max()))
    log(f"phase17(c) EKF exported to C, 30 steps against the EKF on the card: max|x, P "
        f"deviation| {dev:.3e}; C {np.median(tc) * 1e3:.4f} ms per step, the card's "
        f"step {np.median(tg) * 1e3:.3f} ms")
    assert dev < 2e-5, dev
    out.update(ekf_dev=dev, ekf_c_ms=np.median(tc) * 1e3, ekf_card_ms=np.median(tg) * 1e3)

    Nw = 6
    mhe = MHE(cstr_dsl_model())
    mhe.horizon = Nw
    mhe.Q, mhe.R, mhe.P0 = 1e-3 * np.eye(2), np.array([[1e-3]]), 0.05 * np.eye(2)
    mhe.set_initial_parameter_values([1.0] * 6)
    mhe.setup(dt=0.1, options={"tol": 1e-9, "max_iter": 60}, device="cuda", dtype=f64)
    mhe.set_initial_guess([0.25, 0.08])
    solve_c = load_mhe(compile_shared(generate_mhe_c(mhe, os.path.join(work, "mhe.c"))),
                       nx=2, ny=1, nu=1, N=Nw)
    rng = np.random.default_rng(0)
    xt, Us, Ys = np.array([0.2, 0.1]), [], []
    for k in range(16):
        u = np.array([0.3 * np.sin(0.25 * k)])
        Ys.append([xt[1] + 0.003 * rng.standard_normal()])
        xt = plant.simulate(x0=xt, u=u, steps=1)["x"][-1]
        Us.append(u)
    Us, Ys = np.array(Us), np.array(Ys)
    x_card, tg = [], []
    for k in range(len(Us)):
        a = time.perf_counter()
        est = mhe.estimate(y=Ys[k], u=Us[k])
        tg.append(time.perf_counter() - a)
        if est is not None:
            x_card.append(np.asarray(est, dtype=float))
    x_c, x_arr, tc = [], np.array([0.25, 0.08]), []
    for k in range(Nw, len(Us)):
        a = time.perf_counter()
        xe, x_arr = solve_c(Ys[k - Nw:k + 1], Us[k - Nw + 1:k + 1], x_arr, t=(k - Nw) * 0.1)
        tc.append(time.perf_counter() - a)
        x_c.append(xe)
    dev = float(np.abs(np.array(x_c) - np.array(x_card)).max())
    log(f"phase17(c) MHE (N=6) exported to C, {len(x_c)} windows against the MHE on the "
        f"card: max|x_C - x_card| {dev:.3e}; C {np.median(tc) * 1e3:.3f} ms per window, "
        f"the card's estimate {np.median(tg[Nw:]) * 1e3:.2f} ms")
    assert len(x_c) == len(x_card) and dev < 5e-4, dev
    out.update(mhe_dev=dev, mhe_c_ms=np.median(tc) * 1e3,
               mhe_card_ms=np.median(tg[Nw:]) * 1e3)

    pid = PID(k_p=1.3, t_i=0.7, t_d=0.05)
    pid.set_output_limits(-2.0, 2.0)
    pid.setup(dt=0.1)
    pid.set_point = [1.0]
    pid_c = setup_solver(pid, workdir=work)
    rng = np.random.default_rng(0)
    d_pid = max(float(np.abs(pid_c([pv]) - pid.call([pv])).max())
                for pv in rng.normal(size=20))
    lqr = LQR(embedded_di_model())
    lqr.horizon = 20
    lqr.Q, lqr.R = np.eye(2), 0.1 * np.eye(1)
    lqr.setup(device="cuda", dtype=f64)
    lqr_c = setup_solver(lqr, workdir=work)
    d_lqr = max(float(np.abs(lqr_c(x) - lqr.call(x)).max())
                for x in ([1.0, 0.0], [-0.5, 0.3], [0.2, -0.7]))
    lmpc = LMPC(embedded_di_model())
    lmpc.horizon = 10
    lmpc.Q, lmpc.R = np.diag([5.0, 1.0]), np.array([[0.5]])
    lmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    lmpc.setup(options={"dt": 0.1, "tol": 1e-10}, device="cuda", dtype=f64)
    lmpc_c = setup_solver(lmpc, fgm_iters=300)
    d_lmpc = 0.0
    for x in ([1.0, 0.0], [2.0, -1.0], [-1.5, 0.5]):
        u_c = lmpc_c(np.asarray(x))
        u_g = lmpc.optimize(np.asarray(x))
        lmpc._warm = None
        lmpc._u_old[:] = 0
        d_lmpc = max(d_lmpc, float(np.abs(u_c - u_g).max()))
    log(f"phase17(c) PID, LQR and LMPC exported to C against the port's controllers (LQR "
        f"and LMPC on the card): max|du| {d_pid:.3e}, {d_lqr:.3e}, {d_lmpc:.3e} (bars "
        f"1e-12, 1e-12, 2e-4)")
    assert d_pid < 1e-12 and d_lqr < 1e-12 and d_lmpc < 2e-4, (d_pid, d_lqr, d_lmpc)
    report["phase17(c)"] = out


B_AOT = 2048
# the child process of phase 18(d): the exported solve, reloaded with no
# model code and no controller
AOT_CHILD = """
import sys, time, torch
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.aot import load_function
t0 = time.perf_counter()
fn = load_function(sys.argv[1])
t1 = time.perf_counter()
args = [a.cuda() for a in torch.load(sys.argv[2])]
X, U, conv, kkt = fn(*args)
torch.cuda.synchronize()
t2 = time.perf_counter()
X, U, conv, kkt = fn(*args)
torch.cuda.synchronize()
t3 = time.perf_counter()
torch.save({"U": U.cpu(), "converged": conv.cpu()}, sys.argv[3])
print(f"load {t1 - t0:.3f} s, first solve {t2 - t1:.3f} s, second {t3 - t2:.4f} s, "
      f"riccati_lq launches {riccati_lq_cuda.launches}")
"""


def phase18(report):
    """The host utilities on the main path."""
    phase18_session(report)
    phase18_registry(report)
    phase18_profiling(report)
    phase18_aot(report)


def phase18_session(report):
    """(a) The kernel build cache in a fresh directory and its guard."""
    import shutil
    import tempfile
    import torch
    from hilo_mpc_tpu_torch import Session
    from hilo_mpc_tpu_torch.ops import _build
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda, riccati_lq_source
    from hilo_mpc_tpu_torch.utils.cache_guard import (cache_guard_status,
                                                      uninstall_cache_crash_guard)
    x0s = flagship_x0s(B_AOT)
    ref = build_cstr_nmpc(FLAGSHIP, torch.float32)
    U_default = ref.solve_batch_fn()(*ref.prepare_batch(x0s)).U
    cache = tempfile.mkdtemp(prefix="chip_smoke_build_cache_")
    try:
        with Session(compilation_cache=cache):
            nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
            args = nmpc.prepare_batch(x0s)
            riccati_lq_cuda.launches = 0
            sol, t_first = synced(lambda: nmpc.solve_batch_fn()(*args))
            _, t_second = synced(lambda: nmpc.solve_batch_fn()(*args))
            lib = _build.source_library_path(riccati_lq_source(2, 1))
            assert lib.startswith(cache) and riccati_lq_cuda.launches > 0, lib
            with open(lib + ".log") as fh:
                nvcc_line = fh.readline()
            mtime = os.path.getmtime(lib)
            t0 = time.perf_counter()
            again = _build.source_library_path(riccati_lq_source(2, 1))
            t_hit = time.perf_counter() - t0
            assert again == lib and os.path.getmtime(lib) == mtime
            same = bool(torch.equal(sol.U, U_default))
            log(f"phase18(a) Session(compilation_cache={cache}): the flagship (2, 1) "
                f"solve at B={B_AOT} built {os.path.relpath(lib, cache)} there (first "
                f"solve {t_first:.2f} s against {t_second:.4f} s warm: nvcc "
                f"{t_first - t_second:.2f} s; {nvcc_line.split()[0]}); a second build "
                f"of the source: a hit in {t_hit * 1e3:.2f} ms, the library untouched; "
                f"U bitwise equal to the default directory's solve: {same}")
            assert same
            du = build_du_nmpc(FLAGSHIP, torch.float32)
            text = riccati_lq_source(3, 1)
            _, sha = _build._gen_source(text)
            bad = os.path.join(_build.get_build_dir(), "gen", f"lib{sha}.so")
            with open(bad, "wb") as fh:
                fh.write(b"\x7fELF not a library")
            before = cache_guard_status()
            riccati_lq_cuda.launches = 0
            du_args = du.prepare_batch(x0s, u_prev=du_u_prev(B_AOT))
            sol_du, t_du = synced(lambda: du.solve_batch_fn()(*du_args))
            status = cache_guard_status()
            conv = float(sol_du.converged.float().mean())
            log(f"phase18(a) a corrupt library planted at (3, 1)'s path: the guard "
                f"rebuilt it ({t_du:.2f} s with the build); status before "
                f"{before}, after {status}; the Δu solve (3, 1) launched the kernel "
                f"{riccati_lq_cuda.launches} times, converged {conv:.4f}")
            assert status["read_failures"] == before["read_failures"] + 1, status
            assert status["rebuilds"] == before["rebuilds"] + 1, status
            assert riccati_lq_cuda.launches > 0 and conv >= 0.97
            report["riccati_lq"].setdefault("phase18_launches", {})["session_du"] = \
                riccati_lq_cuda.launches
    finally:
        _build.set_build_dir(None)
        uninstall_cache_crash_guard()
        shutil.rmtree(cache, ignore_errors=True)
    report["phase18(a)"] = dict(nvcc_s=t_first - t_second, hit_ms=t_hit * 1e3)


def phase18_registry(report):
    """(b) Two controllers per configuration share one registry entry."""
    import torch
    from hilo_mpc_tpu_torch import clear_trace_registry, trace_registry_stats
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda
    clear_trace_registry()
    x0s = flagship_x0s()
    out = {}
    for label, opts in (("general", FLAGSHIP), ("pallas_full", {**FLAGSHIP,
                                                                 "pallas_full": True})):
        sols, setups = [], []
        entries = trace_registry_stats()["entries"]
        for _ in range(2):
            t0 = time.perf_counter()
            nmpc = build_cstr_nmpc(opts, torch.float32)
            fn = nmpc.solve_batch_fn()
            setups.append(time.perf_counter() - t0)
            n0 = solve_ocp_full_cuda.launches
            sol, t = synced(lambda: fn(*nmpc.prepare_batch(x0s)))
            sols.append((sol, t, solve_ocp_full_cuda.launches - n0))
        grown = trace_registry_stats()["entries"] - entries
        same = bool(torch.equal(sols[0][0].U, sols[1][0].U))
        log(f"phase18(b) {label}: two flagship controllers at B={B_MAIN} float32: "
            f"registry entries +{grown}; setup (setup() and solve_batch_fn()) "
            f"{setups[0]:.4f} s then {setups[1]:.4f} s; solves {sols[0][1]:.4f} s and "
            f"{sols[1][1]:.4f} s (whole-solve launches {sols[0][2]}, {sols[1][2]}); "
            f"U bitwise equal {same}")
        assert grown == 1 and same
        if label == "pallas_full":
            assert sols[0][2] == sols[1][2] == 1
        out[label] = dict(setup_s=setups, solve_s=[s[1] for s in sols])
    report["phase18(b)"] = out


def phase18_profiling(report):
    """(c) trace() and SolveTimer on the flagship."""
    import tempfile
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.utils.profiling import SolveTimer, trace
    nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32)
    args = nmpc.prepare_batch(flagship_x0s())
    theta_B, xs0_B, _, _ = args
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    riccati_lq_cuda.launches = 0
    with trace(log_dir):
        sol = nmpc.solve_batch_fn()(*args)
        X_w = torch.cat([sol.X[:, 1:], sol.X[:, -1:]], dim=1)
        X_w[:, 0] = xs0_B
        U_w = torch.cat([sol.U[:, 1:], sol.U[:, -1:]], dim=1)
        nmpc.solve_batch_fn(warm=True)(theta_B, xs0_B, X_w, U_w)
    launches = riccati_lq_cuda.launches
    events = trace.last.key_averages()
    kernel = [e for e in events if "riccati_lq_kernel" in e.key]
    op = [e for e in events if e.key == "hilo_mpc_tpu_torch::riccati_lq"]
    n_kernel = sum(e.count for e in kernel)
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    with open(os.path.join(log_dir, files[0])) as fh:
        in_file = "riccati_lq_kernel" in fh.read()
    log(f"phase18(c) trace() of a cold+warm flagship pair at B={B_MAIN}: {files[0]} "
        f"written; CUDA kernel {kernel[0].key[:90] if kernel else None} x{n_kernel} "
        f"(the kernel's count {launches}, phase 2's {report['riccati_lq'].get('launches')}); "
        f"operator hilo_mpc_tpu_torch::riccati_lq x{sum(e.count for e in op)}; the kernel "
        f"named in the trace file: {in_file}")
    assert n_kernel == launches and in_file and launches > 0
    if "launches" in report["riccati_lq"]:
        assert launches == report["riccati_lq"]["launches"], launches
    timer = SolveTimer()
    for _ in range(5):
        held = []
        with timer.measure(result=held):
            held.append(nmpc.solve_batch_fn(warm=True)(theta_B, xs0_B, X_w, U_w).U)
    stats = timer.stats()
    log(f"phase18(c) SolveTimer over 5 warm solves at B={B_MAIN}: {stats}")
    assert stats["n"] == 5
    report["phase18(c)"] = dict(trace_launches=n_kernel, timer=stats)
    report["riccati_lq"].setdefault("phase18_launches", {})["trace_pair"] = launches


def phase18_aot(report):
    """(d) The exported model step and NMPC solve; the solve reloaded in a
    child process."""
    import tempfile
    import zipfile
    import torch
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    from hilo_mpc_tpu_torch.utils.aot import (export_model_step, export_nmpc_solver,
                                              load_function)
    work = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    plant = cstr_plant(torch.float32)
    t0 = time.perf_counter()
    path = export_model_step(plant, os.path.join(work, "step.pt2"), batch=B_MAIN)
    t_step = time.perf_counter() - t0
    fn = load_function(path)
    g = torch.Generator("cuda").manual_seed(0)
    x = 0.2 + 0.05 * torch.randn(B_MAIN, 2, device="cuda", generator=g)
    u = torch.randn(B_MAIN, 1, device="cuda", generator=g)
    p = torch.ones(B_MAIN, 6, device="cuda")
    z = x[:, :0]
    got = fn(x, z, u, p)
    want = plant.step_fn(x, z, u, p, 0.0, plant.dt)
    d_step = max(float((a - b).abs().max()) for a, b in zip(got, want) if a.numel())
    log(f"phase18(d) export_model_step(batch={B_MAIN}) on the card in {t_step:.2f} s; "
        f"reloaded against the model's step: max|Δ| {d_step:.3e}")
    assert d_step <= 1e-6, d_step

    nmpc = build_cstr_nmpc(FLAGSHIP, torch.float64)
    args = nmpc.prepare_batch(flagship_x0s(B_AOT))
    n0 = riccati_lq_cuda.launches
    t0 = time.perf_counter()
    path = export_nmpc_solver(nmpc, os.path.join(work, "solver.zip"), batch=B_AOT)
    t_export = time.perf_counter() - t0
    with zipfile.ZipFile(path) as zf:
        with zipfile.ZipFile(zf.open("step.pt2")) as step:
            graph = b"".join(step.read(n) for n in step.namelist() if n.endswith(".json"))
    has_op = b"hilo_mpc_tpu_torch.riccati_lq" in graph
    log(f"phase18(d) export_nmpc_solver(flagship float64, batch={B_AOT}) in {t_export:.2f} "
        f"s ({os.path.getsize(path) / 1e6:.2f} MB, {riccati_lq_cuda.launches - n0} kernel "
        f"launches while exporting); the exported iteration names "
        f"hilo_mpc_tpu_torch::riccati_lq: {has_op}")
    assert has_op
    n0 = riccati_lq_cuda.launches
    live = nmpc.solve_batch_fn()(*args)
    report["riccati_lq"].setdefault("phase18_launches", {})["aot_live"] = \
        riccati_lq_cuda.launches - n0
    inputs, result = os.path.join(work, "inputs.pt"), os.path.join(work, "result.pt")
    torch.save([a.cpu() for a in args], inputs)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", AOT_CHILD, path, inputs, result],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": ROOT})
    t_child = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = torch.load(result)
    dU = float((out["U"] - live.U.cpu()).abs().max())
    conv = float(out["converged"].float().mean())
    log(f"phase18(d) the exported solve in a child process that builds no controller "
        f"({t_child:.1f} s in all: {proc.stdout.strip()}): max|U_exported - U_live| "
        f"{dU:.3e}, converged {conv:.4f} (live {float(live.converged.float().mean()):.4f})")
    assert dU <= 1e-10, dU
    child_launches = int(proc.stdout.rsplit("launches", 1)[1])
    assert child_launches == 2 * nmpc._ip_opts.max_iter, child_launches
    report["riccati_lq"]["phase18_launches"]["aot_exported_child"] = child_launches
    report["phase18(d)"] = dict(step_export_s=t_step, step_dev=d_step,
                                solver_export_s=t_export, child_s=t_child, dU=dU,
                                converged=conv)


def phase19(report):
    """More than 32 box rows per stage: the chain of 8 masses (nx = 17, 36
    candidate rows per stage, two row words) at B=B_LAST, N=20, float32,
    through both routes."""
    label = "phase19 chain of 8 masses"
    two_routes(label, lambda dt, o: chain_nmpc({**FLAGSHIP, **(o or {})}, dt),
               chain_x0s(B_LAST), report, check_plain=False)
    report["whole_ip_wide_rows"]["launches"] = report[label]["launches"]


def embedded_di_model(dt=0.1):
    """tests/test_embedded.py's double integrator measured in position."""
    from hilo_mpc_tpu_torch import Model
    m = Model(discrete=True)
    return m.set_state_space(A=[[1.0, dt], [0.0, 1.0]], B=[[0.5 * dt ** 2], [dt]],
                             C=[[1.0, 0.0]])


def whole_ip_registers(log_path):
    """{"float32"|"float64": [registers per thread, spill store bytes]} of
    the whole-solve kernel in a build's ptxas log."""
    out, cur = {}, None
    with open(log_path) as fh:
        for line in fh:
            if "Compiling entry function" in line:
                cur = (("float32" if "whole_ip_kernelIf" in line else "float64")
                       if "whole_ip_kernel" in line else None)
            elif cur and cur not in out and "spill stores" in line:
                out[cur] = [None, int(line.split("bytes spill stores")[0].split(",")[-1])]
            elif cur and "Used" in line and "registers" in line:
                out[cur][0] = int(line.split("Used")[1].split("registers")[0])
                cur = None
    return out


def sass_mma(lib):
    """The tensor-core instructions in a built library's SASS, by opcode
    and count (cuobjdump -sass), or why they could not be read."""
    from hilo_mpc_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "cuobjdump not found beside nvcc, not read"
    proc = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        return f"cuobjdump failed ({proc.stderr.strip()[:200]})"
    ops = {}
    for line in proc.stdout.splitlines():
        if "MMA" in line and "/*" in line:
            op = line.split("*/")[1].split()[0] if "*/" in line else "?"
            ops[op] = ops.get(op, 0) + 1
    return ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())) or "no MMA instruction"


def host_probe():
    """Seconds of a fixed single-core host workload (a Python loop and a
    numpy sort), to tell a slow host from a fast one across runs."""
    import numpy as np
    t = time.perf_counter()
    sum(i * i for i in range(2_000_000))
    np.sort(np.random.default_rng(0).standard_normal(4_000_000))
    return time.perf_counter() - t


def build_jobs():
    """(label, build function, its argument) for every kernel the phases
    launch."""
    import torch
    from hilo_mpc_tpu_torch.ops import _build
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (FGM_NARROW_MAX_N,
                                                     FGM_REG_BUILD_MAX_N,
                                                     RICCATI_WIDE_GROUPS,
                                                     fgm_boxqp_source,
                                                     fgm_boxqp_tc_pad,
                                                     fgm_boxqp_tc_source,
                                                     riccati_lq_source,
                                                     riccati_lq_wide_source)
    from hilo_mpc_tpu_torch.ops.whole_ip import whole_ip_problem

    jobs = [(f"riccati_lq nx={nx} nu={nu}", _build.source_library_path,
             riccati_lq_source(nx, nu))
            for nx, nu in RICCATI_SIZES + RICCATI_FREE_SIZES]
    jobs += [(f"riccati_lq_wide nx={nx} nu={nu}", _build.source_library_path,
              riccati_lq_wide_source(nx, nu))
             for nx, nu in RICCATI_WIDE_SIZES + RICCATI_WIDE_FREE_SIZES]
    # every group size phase 1 times
    jobs += [(f"riccati_lq_wide nx={nx} nu={nu} G={g}", _build.source_library_path,
              riccati_lq_wide_source(nx, nu, g))
             for nx, nu in RICCATI_WIDE_GROUP_SIZES for g in RICCATI_WIDE_GROUPS]
    jobs.append(("fgm_boxqp", _build.library_path, "fgm_boxqp"))
    # the register design at every n phases 1 and 4 run or time
    jobs += [(f"fgm_boxqp_reg n={n}", _build.source_library_path, fgm_boxqp_source(n))
             for n in sorted({*FGM_NARROW_NS, *FGM_CROSSOVER_NS})
             if n <= FGM_REG_BUILD_MAX_N]
    # the tensor-core design at every padded n phases 1 and 4 run or time
    jobs += [(f"fgm_boxqp_tc n_pad={p}", _build.source_library_path,
              fgm_boxqp_tc_source(p))
             for p in sorted({fgm_boxqp_tc_pad(n) for n in (*FGM_NARROW_NS,
                                                            *FGM_CROSSOVER_NS)
                              if n <= FGM_NARROW_MAX_N})]
    for name, bounds in WHOLE_IP_BOUNDS.items():
        nmpc = build_cstr_nmpc(FLAGSHIP, torch.float32, bounds)
        nt = nmpc.prepare_batch(flagship_x0s(1))[0].shape[2]
        problem = whole_ip_problem(nmpc._funcs, nmpc._dims, nmpc._bounds, nt,
                                   nmpc._ip_opts)
        jobs.append((f"whole_ip {name} ({problem.region} values per scenario)",
                     _build.source_library_path, problem.text))
    # the cross block's build: phase 11(a)'s Δu problem (phases 1 and 11)
    du = build_du_nmpc(FLAGSHIP, torch.float32)
    nt = du.prepare_batch(flagship_x0s(1), u_prev=du_u_prev(1))[0].shape[2]
    problem = whole_ip_problem(du._funcs, du._dims, du._bounds, nt, du._ip_opts)
    jobs.append((f"whole_ip du_cross, CROSS ({problem.region} values per scenario)",
                 _build.source_library_path, problem.text))
    # the traced route (ops/codegen_fx.py): phases 1, 11(b) and 14
    for label, problem in traced_problems().items():
        jobs.append((f"whole_ip traced {label} ({problem.region} values per scenario)",
                     _build.source_library_path, problem.text))
    # the implicit steps of phases 1 and 12 (the collocation flagship from
    # the DSL, golden dae_colloc's model traced)
    for label, problem in implicit_problems().items():
        jobs.append((f"whole_ip implicit {label} ({problem.region} values per scenario)",
                     _build.source_library_path, problem.text))
    # the hybrid physics + ANN problems of phase 15 and phase 16's GP hybrid
    # (traced as well)
    for label, problem in hybrid_problems().items():
        jobs.append((f"whole_ip traced {label} ({problem.region} values per scenario)",
                     _build.source_library_path, problem.text))
    # the last problem classes (phases 1, 11(b), 16(a) and 19)
    for label, problem in last_class_problems().items():
        jobs.append((f"whole_ip last {label} ({problem.region} values per scenario, "
                     f"{len(problem.text)} characters)", _build.source_library_path,
                     problem.text))
    return jobs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hilo_mpc_tpu_torch.ops.codegen_cuda import WIP_MIN_BLOCKS, WIP_TB
    from hilo_mpc_tpu_torch.ops.cuda_kernels import (
        FGM_REG_MAX_N, fgm_boxqp_cluster_rows,
        fgm_boxqp_cluster_smem_bytes, fgm_boxqp_design, fgm_boxqp_reg_layout,
        fgm_boxqp_tc_built_layout, fgm_boxqp_tc_layout,
        riccati_lq_layout, riccati_lq_wide_layout)
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"phase0 device: {device_name}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    log(smi)
    log(f"phase0 host probe: {host_probe():.3f} s")
    t0 = time.perf_counter()
    jobs = build_jobs()
    log(f"phase0 emitted the builds' sources in {time.perf_counter() - t0:.1f} s")

    def build(job):
        t = time.perf_counter()
        lib = job[1](job[2])
        return job[0], lib, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build, jobs))
    log(f"phase0 built {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc each, all started together)")
    for label, lib, secs in built:
        log(f"  {label}: {os.path.relpath(lib, ROOT)} in {secs:.1f} s")
        with open(lib + ".log") as fh:
            entry = ""
            for line in fh:
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log("    " + line.strip())
                if "Compiling entry function" in line:
                    entry = line
                # the Riccati and FGM kernels are built to spill nothing
                # (the register design where the router takes it; the tiled
                # Riccati kernel but at its cap (8, 4), which only phase 1
                # runs and which spills in both dtypes, and (6, 1)'s float64
                # instance, 8 bytes, which phase 16 runs for its float64
                # checks; its float32 instance, the SMPC flagship's, spills
                # nothing)
                reg_n = (int(label.split("n=")[1]) if label.startswith("fgm_boxqp_reg")
                         else 0)
                f64_6x1 = label == "riccati_lq nx=6 nu=1" and "kernelIdLi6" in entry
                if (label.startswith(("riccati_lq", "fgm_boxqp"))
                        and label != "riccati_lq nx=8 nu=4" and not f64_6x1
                        and reg_n <= FGM_REG_MAX_N and "spill stores" in line):
                    assert line.split("bytes spill stores")[0].split(",")[-1].strip() == "0", \
                        (label, line)
        if label.startswith("whole_ip flagship"):
            regs = whole_ip_registers(lib + ".log")
            log(f"    flagship registers per thread: float32 {regs['float32'][0]} "
                f"({regs['float32'][1]} bytes spilled), float64 {regs['float64'][0]}; "
                f"at most {WHOLE_IP_FLAGSHIP_REGISTERS[0]} and "
                f"{WHOLE_IP_FLAGSHIP_REGISTERS[1]}")
            assert regs["float32"][0] <= WHOLE_IP_FLAGSHIP_REGISTERS[0], regs
            assert regs["float32"][1] == 0, regs
            assert regs["float64"][0] <= WHOLE_IP_FLAGSHIP_REGISTERS[1], regs
        if label.startswith("whole_ip traced"):
            regs = whole_ip_registers(lib + ".log")
            log(f"    traced build registers per thread: float32 {regs['float32'][0]} "
                f"({regs['float32'][1]} bytes spilled), float64 "
                f"{regs['float64'][0]} ({regs['float64'][1]} bytes spilled)")
        if label.startswith("whole_ip last"):
            regs = whole_ip_registers(lib + ".log")
            log(f"    last-class build registers per thread: float32 {regs['float32'][0]} "
                f"({regs['float32'][1]} bytes spilled), float64 "
                f"{regs['float64'][0]} ({regs['float64'][1]} bytes spilled)")
        if label.startswith("whole_ip implicit"):
            regs = whole_ip_registers(lib + ".log")
            log(f"    implicit build registers per thread: float32 {regs['float32'][0]} "
                f"({regs['float32'][1]} bytes spilled), float64 "
                f"{regs['float64'][0]} ({regs['float64'][1]} bytes spilled)")
        if label.startswith("whole_ip du_cross"):
            regs = whole_ip_registers(lib + ".log")
            log(f"    CROSS build (nx=3, nu=1) registers per thread: float32 "
                f"{regs['float32'][0]} ({regs['float32'][1]} bytes spilled), float64 "
                f"{regs['float64'][0]} ({regs['float64'][1]} bytes spilled)")
        dts = (torch.float32, torch.float64)
        if label.startswith("riccati_lq_wide"):
            handle = ctypes.CDLL(lib)
            log("    " + ", ".join(
                f"{str(dt)[6:]}: a block of {lay[0]} warps per scenario, {lay[1]} "
                f"bytes of dynamic shared memory" for dt in dts
                for lay in [riccati_lq_wide_layout(handle, dt)]))
        elif label.startswith("fgm_boxqp_reg"):
            tpb, spb, per_sm, _ = fgm_boxqp_reg_layout(ctypes.CDLL(lib))
            blocks = -(-B_MAIN // spb)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            log(f"    {tpb} threads and {spb} scenarios per block, {per_sm} blocks "
                f"resident per SM; at B={B_MAIN} {blocks} blocks, "
                f"{blocks / sms:.2f} per SM ({blocks / (sms * per_sm):.2f} rounds)")
        elif label.startswith("fgm_boxqp_tc"):
            n_pad = int(label.split("n_pad=")[1])
            lay = fgm_boxqp_tc_built_layout(ctypes.CDLL(lib))
            assert lay[:3] == fgm_boxqp_tc_layout(n_pad), (lay, n_pad)
            blocks = -(-B_MAIN // lay[1])
            log(f"    {lay[0]} warps ({lay[0] // 4} warpgroups), {lay[1]} scenarios "
                f"and {lay[2]} bytes of dynamic shared memory per block, {lay[3]} "
                f"blocks resident per SM; at B={B_MAIN} {blocks} blocks; SASS: "
                f"{sass_mma(lib)}")
        elif label == "fgm_boxqp":
            for n in FGM_WIDE_NS:
                _, c, t = fgm_boxqp_design(n)
                rows = fgm_boxqp_cluster_rows(n, c)
                log(f"    n={n}: clusters of {c} blocks, tiles of {t} scenarios, "
                    f"{rows} rows of H and {fgm_boxqp_cluster_smem_bytes(n, c, t)} "
                    f"bytes of dynamic shared memory per block, "
                    f"{(rows // 4) * (t // 2)} threads per block, "
                    f"{c * -(-B_WIDE // t)} blocks at B={B_WIDE}")
        elif label.startswith("riccati_lq"):
            handle = ctypes.CDLL(lib)
            log("    " + ", ".join(
                f"{str(dt)[6:]}: (TB, KC) = {tuple(lay[:2])}, {lay[2]} bytes of "
                f"dynamic shared memory" for dt in dts
                for lay in [riccati_lq_layout(handle, dt)]))
        elif label.startswith("whole_ip"):
            log(f"    tiles of {WIP_TB} scenarios, {WIP_MIN_BLOCKS[0]} (float32) and "
                f"{WIP_MIN_BLOCKS[1]} (float64) blocks per SM (__launch_bounds__), "
                f"the region scenario-minor in a global scratch, 0 bytes of "
                f"dynamic shared memory")

    log(f"phase0 took {time.perf_counter() - T_START:.1f} s")
    report = {}
    for phase in (phase1, phase2, phase3, phase4, phase5, phase6, phase7, phase8,
                  phase9, phase10, phase11, phase12, phase13, phase14, phase15,
                  phase16, phase17, phase18, phase19):
        t = time.perf_counter()
        phase(report) if phase.__code__.co_argcount else phase()
        log(f"{phase.__name__} took {time.perf_counter() - t:.1f} s")
    log(f"chip_smoke total {time.perf_counter() - T_START:.1f} s (builds included)")
    free_x0 = ("hilo_mpc_tpu/ops/pallas_kernels.py:169 with the free-x0 solve at "
               "hilo_mpc_tpu/ops/ip_solver.py:633-642")
    replaces = {"riccati_lq": "hilo_mpc_tpu/ops/pallas_kernels.py:169",
                "riccati_lq_wide": "hilo_mpc_tpu/ops/pallas_kernels.py:169",
                "riccati_lq_free_x0": free_x0, "riccati_lq_wide_free_x0": free_x0,
                "fgm_boxqp": "hilo_mpc_tpu/ops/pallas_kernels.py:26",
                "fgm_boxqp_resident": "hilo_mpc_tpu/ops/pallas_kernels.py:26",
                "fgm_boxqp_registers": "hilo_mpc_tpu/ops/pallas_kernels.py:26",
                "fgm_boxqp_column_blocks": "hilo_mpc_tpu/ops/pallas_kernels.py:26",
                "whole_ip": "hilo_mpc_tpu/ops/pallas_ip.py:143",
                "whole_ip_cross": "hilo_mpc_tpu/ops/pallas_ip.py:143 with the cost's "
                                  "cross block at :571",
                "whole_ip_traced": "hilo_mpc_tpu/ops/pallas_ip.py:143 with the traced "
                                   "model and cost of :215-322",
                "whole_ip_implicit": "hilo_mpc_tpu/ops/pallas_ip.py:143 with an implicit "
                                     "integrator step (hilo_mpc_tpu/core/integrators.py:"
                                     "96-118, 249-357)",
                "whole_ip_wide_rows": "hilo_mpc_tpu/ops/pallas_ip.py:143 with more than 32 "
                                      "box rows per stage (_stage_rows, :95-121)",
                "whole_ip_path_implicit": "hilo_mpc_tpu/ops/pallas_ip.py:143 with a path "
                                          "parameter and an implicit integrator step",
                "whole_ip_smpc": "hilo_mpc_tpu/ops/pallas_ip.py:143 on the SMPC surrogate "
                                 "(hilo_mpc_tpu/control/smpc.py)"}
    sources = {"riccati_lq": "riccati_lq.cuh", "riccati_lq_wide": "riccati_lq_wide.cuh",
               "riccati_lq_free_x0": "riccati_lq.cuh",
               "riccati_lq_wide_free_x0": "riccati_lq_wide.cuh",
               # the flagship (n = 20) in the design the router gives it
               "fgm_boxqp": {"registers": "fgm_boxqp_reg.cuh",
                             "tensor": "fgm_boxqp_tc.cuh"}[report["fgm_boxqp"]["design"]],
               "fgm_boxqp_resident": "fgm_boxqp_tc.cuh",
               "fgm_boxqp_registers": "fgm_boxqp_reg.cuh",
               "fgm_boxqp_column_blocks": "fgm_boxqp.cu",
               "whole_ip": "whole_ip.cuh", "whole_ip_cross": "whole_ip.cuh",
               "whole_ip_traced": "whole_ip.cuh", "whole_ip_implicit": "implicit.cuh",
               "whole_ip_wide_rows": "whole_ip.cuh", "whole_ip_path_implicit": "implicit.cuh",
               "whole_ip_smpc": "traced.cuh"}
    kernels = []
    for name in KERNELS:
        r = report[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"hilo_mpc_tpu_torch/csrc/{sources[name]}",
                        "replaces": replaces[name], "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "back_to_back_ms": r["back_to_back_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        # the whole-solve kernel's soft-box problem, the
                        # CROSS build's float64 instance, phases 11-13's,
                        # 15's and 16's launches
                        **{k: v for k, v in r.items()
                           if k.startswith(("soft_box", "float32_registers",
                                            "float64", "phase11", "phase12",
                                            "phase13", "phase15", "phase16", "phase17",
                                            "phase18",
                                            "float32_simt"))},
                        # ("fgm_boxqp_column_blocks" is the FGM kernel above
                        # n = 128, "fgm_boxqp_resident" the tensor-core
                        # design up to 128, names kept from their first
                        # designs)
                        # no single PyTorch call computes any of them:
                        # a batched LQ solve, a projected gradient method, a
                        # batched NLP
                        "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
