"""Smoke run of the PyTorch/CUDA port (fdtd2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA device is required (there is no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them, and the cards
   ``nvidia-smi -L`` lists.
2. Build: compiles K1 and K2 from fdtd2d_tpu_torch/ops/csrc/ with nvcc (one
   nvcc per source, in parallel) and prints ptxas' registers and spills per
   kernel. The phase fails unless build.log holds ttiled_sweep's report
   with no spill and the static shared memory the planner budgets
   (fdtd_ttiled.STATIC_SMEM_BYTES), and a report of every variant of K1's
   resident kernel (resident_steps) with no spill and the registers the
   planner plans with; each variant's layout is held to the planner's
   (fdtd_fused._check_layout). Then K2's dynamic shared memory per block at
   the 4096^2 plan (ptxas reports static shared memory only), and the
   largest square K1's resident planner admits on this card ("the resident
   limit": 1034^2 on an H100).
3. K1 vs its plain version on an odd non-square grid (203x157) with a
   seeded random medium, Ricker and sinusoidal sources, in both modes:
   streaming, and resident at the planner's tile grid and at forced grids of
   9 x 7 and 16 x 8 tiles, whose seams cross every Mur band (a 5 x 5 corner
   lies in one tile by construction). Each runs once as one call and once as
   two chunks with a step offset:
   - from a zero state, 300 steps, source at the centre and at (7, 9): the
     source's timing and place. In 300 steps the wave spreads about 45
     cells, so these runs leave most of the Mur bands near zero;
   - from a seeded random state, 60 steps, source at (rows-8, cols-10): the
     four Mur bands, the four corners and the cells the step never writes.
     Before the comparison counts, each band and each corner must hold a
     field of at least 1e-3 of max |Ez|, so that a wrong value there shows
     as an error about 100 times the tolerance.
   The float32 kernel is held against the float64 plain version on the same
   card, fed the same float32-rounded coefficients and state; the chunked
   run must equal the single run, and every resident run the streaming one,
   bit for bit. The launch counter must advance by one per resident call
   and two per streaming step.
4. The 2048^2 bench scene through ``simulate`` with 10 frames of 2000 steps:
   with ``backend="auto"``, which must resolve to "ttiled" (the K2 counter
   advances by that run's sweeps, K1's by nothing), and with
   ``backend="fused"``, K1's streaming mode (two launches a step, counted).
   Fields and snapshots must be finite and non-zero. Then 200 steps of the
   same scene on both and on the float64 plain path: the interior and the
   source at full size (in 200 steps the wave from the centre reaches no
   Mur band; phase 3 checks those).
16. K1's main path, the resident mode: ``simulate(backend="auto")`` on the
   bench scene at the resident limit, 2000 steps in 10 frames: "auto" must
   resolve to "fused" and the counters show one resident launch a frame and
   no other; fields and snapshots finite and non-zero; 200 steps against the
   float64 plain path. Then the CLI's default rollout, ``fdtd --size 200
   --steps 1000 --frames 200 --device cuda``, in this process: 200 resident
   launches, a finite non-zero max |Ez|; and 200 steps of it in 5-step
   frames against the float64 plain path. Also asserts what "auto" picks at
   200^2, the resident limit, 2048^2 and 4096^2. (Runs between phases 4
   and 5.)
5. Time: GCells/s of K1's streaming mode and of the plain float32 torch path
   at 2048^2 through ``simulate``, 1000 steps per timed run after a warm-up,
   CUDA events, in turns (plain, kernel, kernel, plain).
6. K2 (the temporally tiled kernel) vs its plain versions on the 203x157
   medium of phase 3, with forced small tiles so that tile seams cross every
   band and corner and windows of non-edge tiles hold band cells (7x10
   tiles at K = 7: TH - K = 0 and TW - K = 3 < 6), K = 7 and K = 3, which
   divide none of the step counts. Sources at the centre, in the halo overlap
   of four tiles (15, 21) and in corner tiles; zero states (300 steps) and
   random states (60 and 62 steps, band and corner coverage asserted as in
   phase 3). Then a 400x360 seeded medium and random state at the planner's
   plan (60 steps, source at the centre): 15 of its 35 tiles are interior,
   with full 80x96 windows and seams between them. Every random-state case
   prints its count of interior tiles (those the kernel's register body
   steps) and fails if it is 0. The float32 kernel is held to the float64
   plain step and to the tile emulation (the same tiles) run in float64 on
   the kernel's float32 inputs, both within the tolerance, and to itself run
   in two chunks, bit for bit: each cell's value at each step comes from the
   same expression on the same inputs, whichever tile or body computes it. (A float32 emulation is no
   yardstick at 1e-5: on the zero-state sinusoidal case with the source at
   (15, 21) the float32 plain arithmetic is itself 7.2e-06 from float64 in
   Hy, and the kernel's FMA rounding differs from it in the other direction.)
7. K3 mode (K2 at K = 1, entry fdtd_multistep_blocked): the cases of phase 6
   at K = 1 (the 400x360 case at the planner's K = 1 tiles).
8. The slice at full size: the 4096^2 bench scene (bench.py's fdtd4096 row:
   2048 steps, backend auto) through ``simulate(backend="auto")`` with 8
   frames: it must resolve to "ttiled", and the K2 counter must advance by
   the sweeps of that run; fields and snapshots finite and non-zero, in the
   staggered shapes. Then 200 steps against the float64 plain path. The
   8192^2 scene (fdtd8192: 512 steps, backend ttiled) once with the same
   checks, and 50 steps against float64. K3 through its entry point on the
   2048^2 scene: 200 steps, its counter advancing by 200, against phase 4's
   float64 run. Each prints its plan and count of interior tiles, which must
   be above 0.
9. Time: ms a step of K2, K1 (streaming there) and the plain float32 path
   at 4096^2 and 8192^2, and of K2, K3 mode, K1 and plain at 2048^2, through
   the op-level entry points with the state on the card; CUDA events after a
   warm-up, in turns (plain, K1, K2[, K3, K3], K2, K1, plain). K2's and K3's
   ms a step are printed beside their share of two bounds: the roofline
   (five inputs read and three outputs written once, 11 float32 operations
   a cell a step at 67 TFLOP/s, 3.35 TB/s) and the HBM traffic of the
   kernel's own plan. Then K1's resident and streaming modes beside K2
   (tools/bench_fused.py's ``time_modes``: in turns, twice each) at 128^2,
   200^2, 256^2, 512^2, 768^2, 1024^2, the resident limit, 1536^2, 2048^2
   and 2304^2, each at 5, 8 and 200 steps a call, printed beside what "auto"
   picks there; and the plain step at the resident limit.

10. FDFD operator on the ``fdfd512`` scene (bench.py:126-134: 512^2, dx
    1e-3 m, omega 17e9, a 2.5x block, PML 40): the complex64 apply and
    diagonal on the card against the complex128 ones on the CPU (<= 1e-5
    relative); the five-point form against apply in complex128 on the card
    (<= 1e-12).
11. ``fdfd512`` (bench.py:137-164) through ``DirectSolver``: the factor
    time (the first ``torch.linalg.inv`` call's start-up apart), a warm-up
    and a timed warm solve with ``rhs_scale=1.0, refine_target=1e-6``;
    ``trace[-2] < 1e-5`` as the bench asserts; the returned complex128
    iterate's true residual recomputed on the CPU with the plain complex128
    operator (<= 1e-6). At 128^2 (the bench's CPU size) the refined field
    against scipy's spsolve of the matrix assembled from the complex128
    five-point coefficients (<= 1e-5). TF32 must be off.
12. ``direct1024`` and ``direct1024batched`` (bench.py:228-270) on the hard
    binary scene: factor time, a timed warm solve to 1e-6, then 16 sources
    from ``default_rng(0)`` through ``solve_batched``, timed per source; the
    worst true residual < 1e-5; each batched field against its single solve
    (<= 1e-5 relative in the 2-norm).
40. (Runs right after phase 12, on its 1024^2 factor.) The backsolve's
    row-sweep kernel (ops/fdfd_rowsweep.py) against its plain version, the
    torch loop, at K = 16 and K = 1: relative error (<= 2e-5 in the 2-norm;
    both complex64, summed in another order), two launches a solve, ms a
    pass (one direction, one read of W) of each by CUDA events in turns,
    and the kernel's share of the pass's floor (W read once, b or z read
    and z or x written once, at 3.35 TB/s; 8 float32 operations a complex
    multiply-add at 67 TFLOP/s); then seven warm ``DirectSolver.solve``
    calls to 1e-6 at 1024^2 on the host clock.
41. (Runs right after phase 40, on its 1024^2 solver.) The refinement's
    residual kernels (ops/fdfd_residual.py) on the main path first: the
    counters over phase 40's seven warm ``solve`` calls and over one
    ``solve_batched`` of 16 point sources to 1e-6 (the fdfd-hard cell's
    shape) must read one residual pass a trace entry of the refinement and
    one update a round, and are printed. Then at 1024^2 and 2048^2 with 16
    sources, on the hard binary scene's complex128 operator: a residual pass and an update
    against their plain versions (||r|| within 1e-13 relative, r / ||r||
    within 2 complex64 units of the last place, the update within 1e-15),
    one count of each a call; then ms a call of each by CUDA events, in
    turns with torch's chain that fdfd/refine.py runs off the card (the
    operator's residual, scaled_norm, divide and cast; x + ||r|| d), beside
    the floors at 3.35 TB/s: a pass 40 bytes a point for one sweep (x and b
    read, r / ||r|| written), 72 for two (the kernels' design), the update
    40 (x and d read, x written).
13. The checkpointed mode at 512^2, stride 32: its raw complex64 backsolve
    against the stored-factor one (<= 1e-5), its refined residual (<= 1e-6),
    factor and warm-solve times. It runs right after phase 11, while that
    phase's stored factors are still on the card, and before phase 12.
14. ``fdfd512iter`` (bench.py:167-194): FDM-FGMRES, restart 20, tol 1e-6,
    maxiter 3000, a timed warm solve; relative residual < 1e-4 (and its
    complex128 residual on the CPU), iterations.
15. The CLI: ``python -m fdtd2d_tpu_torch.cli fdfd --size 512 --solver
    direct|krylov --device cuda --out ""``; direct's f64-iterate residual
    <= --tol, krylov's residual < 10 --tol.
Each FDFD phase checks before it prints a time, and reads the peak device
memory (``torch.cuda.max_memory_allocated``) after its work.

17. K2's block mode (the TPU kernel's sharded mode) at small sizes, through
    the sharded rollout with every block of the mesh on the one card
    (tools/bench_sharded.py's ``block_parity``): the 203x157 and 400x360
    media and random states of phases 3 and 6 cut into 2x2, 1x4, 4x1 and 3x2
    blocks that do not divide them evenly, forced small tiles at 203x157 so
    that seams cross bands, corners and block boundaries, the planner's
    tiles at 400x360; thin blocks whose ghost cells hold a neighbour's Mur
    band (64 rows over 8, 60 over 6, 44x52 over 4x4); the source on the
    corner where four blocks meet, inside a ghost region and outside three
    blocks' arrays; 61 steps, a multiple of no K used. The float32 kernel
    against the float64 plain step (<= 1e-5), against its emulation in
    float64 on the same tiles (<= 1e-5) and against single-device K2
    (expected bit for bit; the max abs difference is printed and more than
    1e-5 relative fails); one launch a block a sweep, counted.
18. The sharded slice at full width (``full_size`` there): the 8192^2 bench
    scene (bench.py:85-91, 512 steps, no frames) through
    ``simulate_sharded(backend="auto")`` on a 2x2 and on a 4x1 mesh of
    ``cuda:0``, and 4096^2 (2048 steps) with 8 frames on a 1D mesh of 4: the
    block-mode counter read before and after (every sweep of every block is a
    launch; single-device K2's and K1's counters do not move), fields
    and snapshots finite and non-zero in the staggered shapes, equal to
    single-device ``simulate(auto)`` within 1e-5 relative (the max abs
    difference printed), 50 steps against the float64 plain step. Then ms a
    step (CUDA events after a warm-up, in turns with the single device) of
    the whole call and of its steady state, the host's time to enqueue a
    step, launches and strip copies a sweep, the share of the blocks' plan
    traffic, and the peak device memory; and the block mode's plain version
    (the same rollout loop with the plain step on each block's array) at 8192^2
    on 2x2 blocks. All blocks share the one card: no copy between two cards
    is made and no scaling is measured. (Phases 17 and 18 run between
    phases 9 and 10.)
19. The adjoint on the card (fdfd/autodiff.py): at 32^2 in complex128, the
    gradients of a phase-sensitive loss of ``solve_helmholtz_differentiable``
    in eps, mu and a complex source against dense ``torch.linalg.solve``
    autograd of the densified operator, each <= 1e-6 of max |grad|; a batched
    solve of an operator stacked over 3 omegas against three single solves,
    <= 1e-12 in complex128 and <= 1e-5 in complex64, with equal per-member
    iterations.
20. Inverse design at full width (apps/inverse_design.py): ``optimize`` of
    ``lowpass_problem(N=250, n_freqs=10)`` (the CLI's default ``invdes``),
    complex64, Adam lr 0.05, opt_tol 1e-4, 5 steps: a finite history with
    min(history) < history[0], the design in [1, 3], 10 finite final
    responses; seconds a warm step. Then three steps as ``optimize`` takes
    them (tools/profile_fdfd.py's ``invdes_steps``), the last under
    torch.profiler: forward and adjoint FGMRES iterations per member, peak
    device memory, launches an FGMRES iteration, device busy share. Then, in
    complex128 at solver tol 1e-10, the step-0 gradient against a central
    finite difference of the loss along one seeded direction (<= 1e-4
    relative). Then ``python -m fdtd2d_tpu_torch.cli invdes --size 250
    --steps 3 --freqs 10 --device cuda --out ""`` (a finite final loss), and
    ``decade_lowpass_problem(N=848, n_freqs=10)`` (the 10-100 GHz sweep)
    through ``invdes_steps``: a cold step, a warm one and a profiled one,
    with the same figures. (Phases 19 and 20 run after phase 15.)
21. Tiled Schwarz (fdfd/tiled.py): at 160^2 (tests/test_tiled.py's scene,
    patches of 64, padding 24, local PML 10) in complex128, the refined
    ``TiledSolver`` solve and ``run_fdfd_tiled``'s additive and
    multiplicative sweeps on the card against the port's CPU run (<= 1e-6;
    equal outer iterations and probe decision). Then bench.py's
    ``tiled1024`` and ``tiled1024approx`` rows at full size
    (tools/profile_fdfd.py's ``tiled_cell``: the 1.5x block scene, 17 GHz,
    dx 1 mm, 100 patches of 160^2): a cold, a timed warm and a profiled warm
    solve; ``trace[-2] < 1e-5`` (exact) and ``trace[-1] < 1e-2`` (approx),
    with the returned field's true residual recomputed in complex128; the
    probe's contractions and decision, outer iterations a round, seconds,
    launches an outer iteration, busy share and peak memory.
22. The time domain (fdfd/timedomain.py): one wave run at 96^2 on the card
    against the CPU's (<= 1e-4); ms a wave step at 4096^2 (CUDA events over
    200 steps) beside its bound (36 B a cell at 3.35 TB/s: 0.180 ms) and
    launches a step (20 steps under torch.profiler); one timed 4096^2
    application with its residual; then ``timedomain4096`` (2.5 transits,
    refined to ``trace[-2] < 1e-6``) after a small warm-up solve. Where
    ``TD4096_ROUNDS`` applications would take the script past 420 s (the
    later phases, 31-36 among them, take about 600 s more), the solve runs
    at 2048^2 and the 4096^2 solve is left to ``tools/profile_fdfd.py
    --paths timedomain --size 4096``.
23. The CLI: ``tiled --size 512`` and ``fdfd --size 512 --solver
    timedomain``, ``--device cuda --out ""``, each in its own process; the
    refined iterate's residual <= 1e-6 in each.
24. Surrogate datagen (models/datagen.py, tools/bench_surrogate.py): the
    scene-batched direct factor (one factor set a scene, each block row one
    batched inverse over 4 x B blocks) in complex64 on the card, refined
    once, against the port's complex128 solve on the CPU at 48^2, batch 3,
    PML 8 (<= 1e-5, true residuals < 1e-5); then ``generate_dataset`` at the
    CLI's default 250^2, batch 64: a cold batch, then 128 samples timed
    (warm samples/s; worst true float64 residual < 1e-5), one batch's split
    into factor, solve, refinement and host check, and peak memory.
25. The train step (models/train.py): one small-UNet step on the card
    against the CPU (loss, gradients, BatchNorm statistics, parameters;
    TF32 off: 1e-5, 1e-4 of the largest gradient, 1e-5; TF32 convolutions as
    the port runs float32: 1e-3, 0.2, 1e-2, since TF32's 10-bit inputs move
    a first-layer weight gradient by up to 7.5% of the largest); then ``UNet2D()`` at 256^2, batch 8 (bench.py's trainstep cell) in
    float32 and bf16: ms a step (CUDA events, 20 steps after 5, in turns f32,
    bf16, bf16, f32), FLOPs by FlopCounterMode, the share of the bf16 peak
    (989 TFLOP/s) and of the TF32 peak (495) for float32, peak memory, a
    torch.profiler window, and one 64-step ``train_epoch``.
26. Inference: 50-step chains at 256^2, batch 8, deterministic and
    stochastic, ``regress`` and a two-member ``ensemble_inference``: finite
    and in physical units.
27. The CLI on cuda, a process each: ``datagen --size 64 --samples 32
    --batch 16 --pml 8`` (residual < 1e-4; phase 24 holds 1e-5), ``train --epochs 2 --batch 8
    --ckpt-dir ...``, ``infer --steps 10 --out ""``.
38. (Runs after phase 27.) The surrogate's readout on cuda, a process
    each, on phase 27's dataset and checkpoint (64^2, epsilon): ``python -m
    fdtd2d_tpu_torch.apps.surrogate_report`` on the last 8 scenes (rc 0,
    the npz keys of an epsilon report, every value finite) and ``python -m
    fdtd2d_tpu_torch.apps.surrogate_diagnose`` (rc 0, finite per-t probes).
28. The compressed (HODLR) direct mode (fdfd/compressed.py): at 160^2
    (tests/test_direct.py's scene, 24 GHz, PML 20, rank 10, leaf 16) on
    the card and on the CPU, the raw backsolve within 1e-2 (q = 0) and
    3e-3 (q = 1) of the full store, the refined iterate below 1e-8, and the
    card's refined iterate within 1e-6 of the CPU's. Then ``direct2048``
    (bench.py:274-303, not cut: the hard scene, seed 3, 17 GHz, PML 40,
    rank 20, leaf 128, power_iters 1): factor seconds, the store (8.32 GB,
    equal to the plan's count), factor peak and growth; cold and warm
    solves to 1e-6 (``trace[-2] < 1e-5``); the warm solve stacked (the
    default) and as a loop over the four sublattices of the same factors
    (what ``stacked_solve=False`` solves). At the end of the script,
    ``direct2048stored``: plain ``DirectSolver()`` at 2048^2 (the 34.4 GB
    store), factor, peak and warm solve, cut when the compressed factor
    plus two of its solves would take the script past 1080 s (the cut is
    printed).
29. The HPS mode (fdfd/hps.py): at 64^2 the raw complex64 residual on the
    card and the CPU (< 5e-5); then ``DirectSolver(hps=True, hps_leaf=8)``
    on the hard scene at 512^2 and 1024^2 (17 GHz, PML 40): factor seconds,
    the store equal to ``predicted_factor_bytes``, peak, warm solve to 1e-6
    within the mode's 40 rounds, rounds and contraction a round.
42. (Runs right after phase 29.) The HPS level kernel (ops/fdfd_hps.py)
    at 2048^2 on the fdfd-hps benchmark scene (hard binary, seed 7,
    contrast 3, PML 40): one ``solve_batched`` of 16 point sources to 1e-6
    must count 2 (levels + 1) launches an inner solve; then at K = 16 and
    K = 1 on random right-hand sides, the kernel path of ``hps_solve``
    against the torch path (``_solve_cols``, cuBLAS) (<= 1e-5 relative in a
    right-hand side's 2-norm), ms of the whole inner solve of each in
    turns, and of the kernel's up and down launches (CUDA events around
    each), beside the floor (Y and twice E read at 3.35 TB/s) and the
    roofline's least time (portbench/hps_readers.py's count: the larger of
    Y + E and the right-hand sides at 3.35 TB/s and 8 K (Y + 2 E) float32
    operations at 67 TFLOP/s).
30. The sublattice-sharded direct solve (parallel/direct_sharded.py) on
    meshes of 4 and 2 x cuda:0 at 512^2, stored, checkpointed (stride 32)
    and compressed (rank 20), against the single-device solve of its mode
    that batches alike (per sublattice for 4 entries, stacked for 2): the
    raw backsolve <= 1e-6 (stored, checkpointed; whether bit for bit); the
    compressed raw backsolve reported, within 1e-2 of the stored one, and
    its solve refined to 1e-10 <= 1e-6 from the single-device one.
37. (Runs after phase 30, before 31-36, whose gates then leave it its
    time.) The port's bench through its CLI, ``python -m
    fdtd2d_tpu_torch.cli bench --only fdfd512,fdfd512iter,fdtd2048``: a
    child process a row, each row checked before it prints (fdtd2048 holds
    K2 at 2048^2 to the float64 plain step over 200 steps from zero and 20
    steps once the pulse has reached every Mur band and corner); rc 0,
    three JSON lines, fdtd2048 last on K2 (``"backend": "ttiled"``), the
    card's name on each; fdfd512iter's iterations equal to phase 14's (the
    same solve), its seconds printed beside phase 14's.
31. The sharded FDFD solve (parallel/sharded.py) on meshes of cuda:0: the
    block matvec on (4,) and (2, 2) meshes at 512^2 (the fdfd512 scene)
    against ``op.apply``, <= 1e-13 in complex128 (complex64 printed); then
    ``solve_fdfd_sharded`` at fdfd512iter's configuration (FDM, restart 20,
    tol 1e-6, maxiter 3000) on (2, 2): the true complex128 residual < 1e-4
    and <= 1e-4 from the single-device iterate; seconds of each solve,
    iterations, launches an iteration (one restart cycle under
    torch.profiler) and the FDM's gathers and bytes; the single device's
    solve is phase 14's. Where the sharded solve would take the phases past
    ``MULTIDEVICE_END_S``, maxiter is cut (printed) and the iterate is held
    to finite values only.
32. ``run_fdfd_tiled_sharded`` at tiled1024 (the 1.5x block scene, patches
    of 100, padding 30, solver tol 1e-4, maxiter 300, refined to 1e-6) on 4 x
    cuda:0: ``trace[-2] < 1e-5``, <= 1e-4 from the single-device two-level
    solve with the patch level forced on; warm seconds (phase 21 built the
    same FDM factors), rounds, outer iterations, peak; beside it the single device with patches and
    with its probe's choice (the coarse level alone at this contrast).
33. ``TimeDomainSolverSharded`` on (4, 2) meshes of cuda:0: at 96^2 (PML 16)
    against the CPU's single-device application (<= 1e-4); one 2048^2
    application cut to 300 steps against the card's single-device one
    (<= 1e-5) with ms a wave step of each; a solve to ``trace[-2] < 1e-6``
    at 2048^2, halved down to 256^2 while ``TD_ROUNDS`` applications would
    take phases 31-36 past ``MULTIDEVICE_END_S`` (the cut is printed).
34. ``train_step_dp``: ``UNet2D()`` at 256^2, global batch 8, the
    reference recipe, TF32 convolutions, 3 steps on 2 gloo ranks of cuda:0
    (spawned processes), against the single-device ``train_step`` on the
    same batch and draws, held to phase 25's TF32 bounds (loss 1e-3,
    BatchNorm statistics 1e-2, parameters 1e-5 of each tensor's largest
    entry plus 2 lr a step) and the ranks' parameters equal; ms a step
    beside the single device's (the ranks share one card: no scaling). With
    two cards visible, 2 nccl ranks on two cards as well.
35. ``simulate_batched``: 8 scenes at 1024^2, 200 steps, per-scene sources,
    against per-scene ``simulate(backend='torch')`` (<= 1e-6; bit for bit
    printed); ``solve_fdfd`` with bicgstab (tol 1e-6) and gmres at 512^2
    with FDM, in complex128: the true residual < 1e-5 (GMRES at tol 1e-6
    stops at x0 under JAX's stopping rule, printed, so it runs at 1e-6
    times ||M b|| / ||b||).
36. ``parallel/dryrun.py::dryrun_multichip(["cuda:0"] * 8)``: every stage
    of the JAX dry run, each held to its single-device call; then on all
    visible cards where there are more than one.
39. (Runs last, after ``direct2048stored``, so that it never takes that
    leg's time.) The JAX repo's example workflows, each through its ``run``
    function in ``fdtd2d_tpu_torch/apps`` on cuda: the ring resonator and
    tiled vs direct at 512^2 (the scripts' size: each global FGMRES solve
    ``converged`` as the package defines it, a relative residual under
    10 tol, which tiled vs direct's meets at its maxiter of 600 as the JAX
    package's does; the tiled iterate at a true 1e-8; the fields within
    1e-3 of each other); the FDTD video at 200^2, 1000 steps, 200 frames (the script's
    size), which ``auto`` must run on K1's resident mode, one launch a
    frame and no K2 launch, its frames within 1e-5 of the plain float64
    rollout on the card (phase 16's bound); the rank study at 256^2 (every
    rank within its block, the rank-k errors in (0, 1]); direct_large at
    512^2 in its three modes (stride 64), both solves and the 8-source
    sweep at a true 1e-8; the decade driver on ``lowpass_problem(N=250)``
    for 3 steps with the binarized response (finite, positive). Cut, and
    the cut printed, where its ~60 s would take the script past 1140 s.

Tolerance: 1e-5 relative (max |kernel - plain| / max |plain|), the bound of
the float64 oracle tests (tests/test_fdtd_oracle.py). The kernel and the
plain path differ in rounding only: nvcc contracts a + b*c into FMA and
CUDA's expf differs from the plain path's exp in the last bits, both far
inside that bound at float32.

Before its last line the script prints one JSON object with each kernel's
launches (counted in its main-path run of phase 16, K1, 8, K2 and K3, or 18,
K2's block mode: 8192^2 on 2x2 blocks),
error, times, roofline bound and share of it (K1: the resident mode at the
resident limit, its streaming mode's numbers under "streaming"; K2 and K3
also their plan; no single PyTorch call computes a leapfrog step, so
library_ms is null), one with the GCells/s of phase 5, one with phase 9's
table of K1's modes, one with the times, errors, plan-traffic
bounds and tile counts of phases 6-9, one with the parity and the cells of
phases 17-18,
one with the times, residuals and peak memory of phases 10-15, 40 and 41, one
(``invdes``) with the errors, times, iterations, launches and peak memory
of phases 19-20, one (``tiled_timedomain``) with the parity, probe, times,
iterations, rounds, launches and peak memory of phases 21-23, one
(``surrogate``) with the parity, rates, times, FLOPs, profile and peak
memory of phases 24-27 and the readout of phase 38 (no TPU kernel lies on the surrogate's path: its
convolutions are cuDNN's, and the ``kernels`` line is unchanged), one
(``direct_modes``) with the parity, times, stores, rounds and peak memory of
phases 28-30 (no TPU kernel lies on this path either), one
(``multidevice``) with the parity, times, iterations, launches, gathers,
rounds and peak memory of phases 31-36 (no ``pl.pallas_call`` lies on them;
K2's block mode runs in the dry run's stages 1, 4b and 4b'), one
(``bench``) with phase 37's three rows, one (``examples``) with phase 39's
numbers (K1 is the one TPU kernel on those paths: the ``kernels`` line is
unchanged), and the nvidia-smi line; its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
COVER = 1e-3  # least field in each Mur band and corner, relative to max |Ez|
DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73   # vacuum impedance: scales the random H to the random Ez
# Roofline of a leapfrog step on an H100 SXM at its 700 W limit (NVIDIA's
# data sheet): 3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor
# cores; 11 float32 operations a cell a step (H: 2 x (sub, mul, add); Ez:
# 3 subs, a mul, an add).
HBM_BYTES_S, F32_FLOPS, FLOPS_PER_CELL_STEP = 3.35e12, 67e12, 11
# tensors a later phase compares with (not printed)
KEPT = {}


def roofline_ms(N: int, steps: int):
    """(ms a step, "bytes" or "operations"): the least time a call of
    ``steps`` steps on an N x N grid takes, its five inputs read once and its
    three outputs written once (32 B a cell), its operations at the float32
    peak; per step."""
    by_bytes = 32 * N * N / HBM_BYTES_S
    by_ops = FLOPS_PER_CELL_STEP * N * N * steps / F32_FLOPS
    return max(by_bytes, by_ops) / steps * 1e3, ("bytes" if by_bytes > by_ops else "operations")


def plan_bound_ms(fdtd_ttiled, N: int, K: int, TH: int, TW: int) -> float:
    """ms a step of K2's (or K3's, K = 1) own HBM traffic at 3.35 TB/s: each
    sweep reads five fields over every window and writes three over the
    owned cells, (5 (1 + redundancy) + 3) x 4 B a cell per K steps."""
    per_cell = (5 * (1 + fdtd_ttiled.redundancy(N, N, K, TH, TW)) + 3) * 4 / K
    return per_cell * N * N / HBM_BYTES_S * 1e3


def roofline_entry(bounds: dict) -> dict:
    """The keys of phase 9's bounds of K2 or K3 that the ``kernels`` line
    carries; the plan-traffic bound stays in the ``ttiled`` line."""
    return {k: bounds[k] for k in ("plan", "bound_ms", "bound_by", "share_of_bound")}


def launches_since(before: dict, *kernels: str) -> tuple:
    """Each FDTD kernel's launches since the counters' snapshot ``before``
    (``"k1"``, ``"k1_resident"``, ``"k2_sweeps"``, ``"k2_block_sweeps"``,
    ``"k3"``; utils/trace.py)."""
    from fdtd2d_tpu_torch.utils import trace

    return tuple(trace.delta(before, f"fdtd.kernels.{k}") for k in kernels)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((x.double() - ref).abs().max() / ref.abs().max())


def max_abs_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref.double()).abs().max())


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float, what: str = "ok"):
    print(f"   {what} ({time.perf_counter() - t0:.2f} s)", flush=True)


def boundary_cover(Ez: torch.Tensor, band: int) -> float:
    """Smallest max |Ez| over the four Mur bands and the four corners,
    relative to max |Ez| over the grid."""
    b = band
    parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
             Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
    return float(min(p.abs().max() for p in parts) / Ez.abs().max())


def check_fields(fields, snaps, N: int, nframes: int):
    """Finite, non-zero fields (and snapshots) in the staggered shapes."""
    Ez, Hx, Hy = fields
    if nframes and (snaps is None or tuple(snaps.shape) != (nframes, N, N)):
        raise AssertionError(f"snapshots: {None if snaps is None else tuple(snaps.shape)}")
    named = (("Ez", Ez), ("Hx", Hx), ("Hy", Hy)) + ((("snapshots", snaps),) if nframes else ())
    for name, t in named:
        if not bool(torch.isfinite(t).all()) or float(t.abs().max()) == 0.0:
            raise AssertionError(f"{name} is not finite and non-zero")
    if tuple(Hx.shape) != (N, N - 1) or tuple(Hy.shape) != (N - 1, N):
        raise AssertionError("staggered shapes not kept")


def against_plain(kern, plain, what: str):
    """Relative errors of (Ez, Hx, Hy) against the float64 plain fields;
    raises above TOL. Returns (errors by name, max absolute error)."""
    errs = {name: rel_err(k, p) for name, k, p in zip(("Ez", "Hx", "Hy"), kern, plain)}
    if not all(e <= TOL for e in errs.values()):
        raise AssertionError(f"{what}: relative errors {errs} exceed {TOL}")
    return errs, max(max_abs_err(k, p) for k, p in zip(kern, plain))


def tiled_edge_cases(kernel, emulate, plain, states, cases, band, interior):
    """Phases 6 and 7: ``kernel``/``emulate``/``plain`` run
    (fields, nsteps, offset, source, kind, K, tile) -> fields; ``interior``
    (K, tile) counts the tiles that the kernel's register body steps. Returns
    the worst relative error (against the float64 plain step and against the
    emulation), the least band/corner coverage of the random states, and the
    least count of interior tiles over the random-state cases, which must
    be above 0."""
    worst, least_cover, least_interior = 0.0, 1.0, None
    for K, tile, start, nsteps, split, sources in cases:
        n_interior = interior(K, tile)
        if start.startswith("random"):
            least_interior = n_interior if least_interior is None else min(least_interior,
                                                                           n_interior)
            if not n_interior > 0:
                raise AssertionError(f"K={K}, tiles {tile}: no interior tile")
        for (sx, sy), kind_ in ((s, k) for s in sources for k in ("ricker", "sinusoidal")):
            case = (f"K={K}, tiles {tile} ({n_interior} interior), {start} state, "
                    f"{nsteps} steps, source {(sx, sy)}, {kind_}")
            args = ((sx, sy), kind_, K, tile)
            single = kernel(states[start], nsteps, 0, *args)
            chunked = kernel(kernel(states[start], split, 0, *args), nsteps - split,
                             split, *args)
            emu = emulate(states[start], nsteps, 0, *args)
            ref = plain(states[start], nsteps, 0, *args)
            torch.cuda.synchronize()
            if start.startswith("random"):
                cover = boundary_cover(ref[0], band)
                least_cover = min(least_cover, cover)
                if not cover >= COVER:
                    raise AssertionError(f"{case}: a Mur band or corner holds only "
                                         f"{cover:.2e} of max |Ez| (< {COVER})")
            case_worst = {"float64 plain": 0.0, "float64 tile emulation": 0.0}
            for name, k, c, e, p in zip(("Ez", "Hx", "Hy"), single, chunked, emu, ref):
                if k.shape != p.shape:
                    raise AssertionError(f"{name}: shape {tuple(k.shape)} != {tuple(p.shape)}")
                if not torch.equal(k, c):
                    raise AssertionError(f"{name}: chunked run differs from one run ({case})")
                for against, err in (("float64 plain", rel_err(k, p)),
                                     ("float64 tile emulation", rel_err(k, e))):
                    case_worst[against] = max(case_worst[against], err)
                    if not err <= TOL:
                        raise AssertionError(f"{name}: relative error {err:.3e} against "
                                             f"the {against} > {TOL} ({case})")
            worst = max(worst, *case_worst.values())
            print(f"   {case}: ok, relative error " +
                  ", ".join(f"{v:.3e} vs the {k}" for k, v in case_worst.items()))
    return worst, least_cover, least_interior


def time_in_turns(order, runs, cells: int, steps: int):
    """GCells/s of each named run, timed with CUDA events after a warm-up,
    one timed run per appearance in ``order``."""
    from fdtd2d_tpu_torch.utils.metrics import throughput_gcells

    timed = {name: [] for name in order}
    for name in order:
        timed[name].append(throughput_gcells(cells, steps, runs[name], repeats=1, warmup=1))
    return timed


def bench_scene(N: int, constants):
    """The bench scene of bench.py's fdtd rows: a 4x dielectric block."""
    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = np.full((N, N), constants.MU_0, np.float32)
    return eps, mu


def fdfd512_scene(N: int, omega: float, constants):
    """The scene of bench.py's fdfd512 rows: a 2.5x block, and a point
    source that already carries -1j*omega."""
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex128)
    src[N // 2, N // 2] = -1j * omega
    return eps, mu, src


def complex_rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max |ref| in complex128, on x's device."""
    ref = ref.to(x.device, torch.complex128)
    return float((x.to(torch.complex128) - ref).abs().max() / ref.abs().max())


def norm_rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to(ref.dtype) - ref) / torch.linalg.vector_norm(ref))


def cpu_residual(op128_cpu, b, x) -> float:
    """True relative residual of ``x`` with the plain complex128 operator
    on the CPU."""
    b = b.cpu().to(torch.complex128)
    r = op128_cpu.residual(b, x.cpu().to(torch.complex128))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def timed(fn, dev):
    """(result, seconds) of ``fn()`` on the host clock, the device
    synchronized before and after."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9


def rowsweep_floor_ms(groups: int, nr: int, nc: int, K: int) -> float:
    """The least time of one pass of the row sweep (one direction) on an
    H100 at 700 W: all of W read once, b (or z) read once and z (or x)
    written once, against 3.35 TB/s; 8 float32 operations a complex
    multiply-add, against 67 TFLOP/s."""
    moved = 8 * groups * nr * (nc * nc + 2 * K * nc)
    flops = 8 * groups * nr * nc * nc * K
    return 1e3 * max(moved / HBM_BYTES_S, flops / F32_FLOPS)


def events_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` by CUDA events over ``reps`` calls,
    after one call to warm up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rowsweep_phase(dev, solver, src) -> dict:
    """Phase 40 (right after phase 12, on its 1024^2 solver): the row-sweep
    kernel against its plain version, the torch loop, at K = 16 (the
    benchmark's batch) and K = 1 (``DirectSolver.solve``): their agreement,
    ms a pass (one direction, one read of W) of each by CUDA events in
    turns, and the kernel's share of the pass's floor; then seven warm
    ``solver.solve(src)`` calls to 1e-6 on the host clock."""
    from fdtd2d_tpu_torch.ops import fdfd_rowsweep as rs, fdtd_fused
    from fdtd2d_tpu_torch.utils import trace

    t0 = phase("40. the row-sweep kernel at 1024^2 vs the torch loop, K = 16 and K = 1")
    f = solver.factors.stacked
    groups, nr, nc = f.Ws.shape[0], f.Ws.shape[-3], f.Ws.shape[-1]
    nv, sv = f.nvals.contiguous(), f.svals.contiguous()
    out = {}
    for K in (16, 1):
        rng = np.random.default_rng(K)
        shape = (groups, K, nr, nc)
        b = torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                         dtype=torch.complex64, device=dev)
        runs = {"kernel": lambda: rs.row_sweep(f.Ws, nv, sv, b),
                "plain": lambda: rs.row_sweep_reference(f.Ws, nv, sv, b)}
        before = trace.counters()
        x_kernel = runs["kernel"]()
        torch.cuda.synchronize(dev)
        launches = trace.delta(before, "fdfd.kernels.row_sweeps")
        err = norm_rel(x_kernel, runs["plain"]())
        if launches != 2 or not err <= 2e-5:   # tests/test_torch_cuda.py's ROWSWEEP_TOL
            raise AssertionError(f"row sweep at K = {K}: {launches} launches, relative error "
                                 f"{err:.3e} against the torch loop")
        ms = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            ms[name].append(events_ms(runs[name], 10 if name == "kernel" else 2) / 2)
        floor = rowsweep_floor_ms(groups, nr, nc, K)
        best = min(ms["kernel"])
        plan = rs.plan_row_sweep(groups, nr, nc, K, *fdtd_fused.device_numbers(dev)[::2])
        out[f"K{K}"] = {"plan": dataclasses.asdict(plan),
                        "kernel_ms_a_pass": ms["kernel"], "plain_ms_a_pass": ms["plain"],
                        "floor_ms_a_pass": floor, "floor_share": floor / best,
                        "rel_err_vs_plain": err, "launches_a_solve": launches}
        print(f"   K = {K}: kernel {[f'{t:.3f}' for t in ms['kernel']]} ms a pass, loop "
              f"{[f'{t:.3f}' for t in ms['plain']]}, floor {floor:.3f} ms "
              f"({100 * floor / best:.1f}% of it), kernel vs loop {err:.3e}")
        del b, x_kernel
    before = trace.counters()
    solves = [timed(lambda: solver.solve(src, refine_target=1e-6), dev) for _ in range(7)]
    out["solve_1024_s"] = solve_s = [t for _, t in solves]
    # solve's trace: one entry a residual pass, then the downcast's residual
    out["solve_1024_counts"] = main_path_counts(before, [len(tr) - 1 for (_, tr), _ in solves],
                                                "phase 40's seven warm solve calls")
    done(t0, f"DirectSolver.solve at 1024^2: {[f'{t:.4f}' for t in solve_s]} s")
    return out


def main_path_counts(before: dict, passes: list, what: str) -> dict:
    """The residual kernels' counters since ``before``, over refinements
    whose traces held ``passes`` entries (one a residual pass, the last
    after the last update): they must read one pass an entry and one update
    a round."""
    from fdtd2d_tpu_torch.utils import trace

    got = {"residual_passes": trace.delta(before, "fdfd.kernels.residual_passes"),
           "refine_updates": trace.delta(before, "fdfd.kernels.refine_updates")}
    want = {"residual_passes": sum(passes), "refine_updates": sum(passes) - len(passes)}
    if got != want:
        raise AssertionError(f"{what}: the kernels counted {got}, the refinements ran {want}")
    print(f"   {what}: {got['residual_passes']} residual passes and {got['refine_updates']} "
          f"updates by the kernels, one a pass and one a round of the refinements")
    return got


def residual_phase(dev, solver) -> dict:
    """Phase 41 (right after phase 40, on its 1024^2 solver): the main
    path's counts over one ``solve_batched`` of 16 sources; then the
    refinement's residual kernels against their plain versions and torch's
    chain at 1024^2 and 2048^2, 16 sources; ms a call by CUDA events in
    turns, beside the floors."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd.refine import scaled_norm
    from fdtd2d_tpu_torch.ops import fdfd_residual as fr
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator
    from fdtd2d_tpu_torch.utils import trace

    t0 = phase("41. the residual kernels on the main path, then at 1024^2 and 2048^2, 16 "
               "sources, vs torch's chain")
    N = solver.op64.shape[0]
    ij = np.random.default_rng(41).integers(N // 4, 3 * N // 4, size=(16, 2))
    srcs = np.zeros((16, N, N))
    srcs[np.arange(16), ij[:, 0], ij[:, 1]] = 1.0
    before = trace.counters()
    _, res, tr = solver.solve_batched(srcs, refine_target=1e-6)
    if not float(res.max()) <= 1e-6:
        raise AssertionError(f"solve_batched of 16 sources at {N}^2: residuals {res}")
    out = {"solve_batched_1024_counts": main_path_counts(
        before, [len(tr)], f"solve_batched of 16 sources at {N}^2, trace "
                           f"{[f'{t:.2e}' for t in tr]}")}
    del srcs
    for N in (1024, 2048):
        eps, mu, _ = hard_binary_scene(N)
        op = make_operator(eps, mu, 1e-3, 1e-3, 17e9, dtype=torch.complex128, device=dev)
        g = torch.Generator(device=dev).manual_seed(N)
        shape = (16, N, N)
        x = torch.randn(shape, dtype=torch.complex128, device=dev, generator=g)
        b = torch.randn(shape, dtype=torch.complex128, device=dev, generator=g) * 1e10
        d = torch.randn(shape, dtype=torch.complex64, device=dev, generator=g)
        rn = torch.rand(16, dtype=torch.float64, device=dev) * 1e6

        def chain_pass():
            r = op.residual(b, x)
            n = scaled_norm(r, batched=True)
            safe = torch.where(n == 0, torch.ones_like(n), n)
            return (r / safe[:, None, None]).to(torch.complex64), n

        before = trace.counters()
        rc, norms = fr.residual_pass(op, b, x)
        x_upd = fr.update(x.clone(), rn, d)
        torch.cuda.synchronize(dev)
        counts = (trace.delta(before, "fdfd.kernels.residual_passes"),
                  trace.delta(before, "fdfd.kernels.refine_updates"))
        want_rc, want_norms = fr.residual_pass_reference(op, b, x)
        norm_err = float(((norms - want_norms).abs() / want_norms).max())
        spacing = torch.tensor(np.spacing(np.abs(torch.view_as_real(want_rc).cpu().numpy())),
                               dtype=torch.float64, device=dev)
        ulps = float(((torch.view_as_real(rc).double() - torch.view_as_real(want_rc).double())
                      .abs() / spacing).max())
        want_x = fr.update_reference(x.clone(), rn, d)
        upd_err = float(((x_upd - want_x).abs() / want_x.abs()).max())
        if counts != (1, 1) or not (norm_err <= 1e-13 and ulps <= 2.0 and upd_err <= 1e-15):
            raise AssertionError(f"residual kernels at {N}^2: counts {counts}, norms {norm_err:.3e}, "
                                 f"r / ||r|| {ulps} ulps, update {upd_err:.3e} against plain")
        del rc, norms, want_rc, want_norms, spacing, x_upd, want_x
        runs = {"kernel": lambda: fr.residual_pass(op, b, x),
                "chain": chain_pass,
                "update_kernel": lambda: fr.update(x, rn, d),
                "update_chain": lambda: x + rn[:, None, None] * d.to(torch.complex128)}
        ms = {k: [] for k in runs}
        for name in ("chain", "kernel", "kernel", "chain",
                     "update_chain", "update_kernel", "update_kernel", "update_chain"):
            ms[name].append(events_ms(runs[name], 10 if "kernel" in name else 3))
        points = 16 * N * N
        floors = {"pass_one_sweep": points * 40 / HBM_BYTES_S * 1e3,
                  "pass_two_sweeps": points * 72 / HBM_BYTES_S * 1e3,
                  "update": points * 40 / HBM_BYTES_S * 1e3}
        out[f"{N}"] = {"ms": ms, "floor_ms": floors, "norm_rel_err": norm_err,
                       "rhs_ulps": ulps, "update_rel_err": upd_err,
                       "pass_share_of_two_sweep_floor": floors["pass_two_sweeps"] / min(ms["kernel"]),
                       "update_share_of_floor": floors["update"] / min(ms["update_kernel"])}
        print(f"   {N}^2, K = 16: pass kernel {[f'{t:.3f}' for t in ms['kernel']]} ms, chain "
              f"{[f'{t:.3f}' for t in ms['chain']]}; floors {floors['pass_one_sweep']:.3f} (one "
              f"sweep) / {floors['pass_two_sweeps']:.3f} (two); update kernel "
              f"{[f'{t:.3f}' for t in ms['update_kernel']]}, chain "
              f"{[f'{t:.3f}' for t in ms['update_chain']]}, floor {floors['update']:.3f}")
        del op, x, b, d, rn
        torch.cuda.empty_cache()
    done(t0)
    return out


def fdfd_phases(dev) -> dict:
    """Phases 10-15: the FDFD path on the card. Returns the numbers of the
    ``{"fdfd": ...}`` line."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver, five_point_coefficients
    from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    out = {}
    dx, omega, N = 1e-3, 17e9, 512
    eps, mu, src = fdfd512_scene(N, omega, constants)

    # -- 10. operator -------------------------------------------------------------
    t0 = phase("10. FDFD operator, fdfd512 scene: c64 on the card vs c128 on the CPU")
    torch.cuda.reset_peak_memory_stats(dev)
    op32 = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex64, device=dev)
    op128 = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex128, device=dev)
    op128_cpu = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex128, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    errs = {"apply_c64": complex_rel_err(op32.apply(x.to(dev, torch.complex64)), op128_cpu.apply(x)),
            "diagonal_c64": complex_rel_err(op32.diagonal(), op128_cpu.diagonal())}
    d, e, w, s_, n = five_point_coefficients(op128)
    xd = x.to(dev)
    shifted = (torch.nn.functional.pad(xd[:, 2:], (0, 2)), torch.nn.functional.pad(xd[:, :-2], (2, 0)),
               torch.nn.functional.pad(xd[2:], (0, 0, 0, 2)), torch.nn.functional.pad(xd[:-2], (0, 0, 2, 0)))
    five = d * xd + e * shifted[0] + w * shifted[1] + s_ * shifted[2] + n * shifted[3]
    errs["five_point_c128"] = complex_rel_err(five, op128.apply(xd))
    for name, bound in (("apply_c64", TOL), ("diagonal_c64", TOL), ("five_point_c128", 1e-12)):
        if not errs[name] <= bound:
            raise AssertionError(f"operator {name}: relative error {errs[name]:.3e} > {bound}")
    out["operator"] = {"rel_err": errs, "peak_gb": peak_gb(dev)}
    del op128, d, e, w, s_, n, five, shifted, xd
    done(t0, ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # -- 11. fdfd512, direct ----------------------------------------------------------
    t0 = phase("11. fdfd512: DirectSolver at 512^2, refine to 1e-6, rhs_scale 1.0")
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the pivotless c64 block-LU needs full-fp32 matmuls")
    _, inv_startup_s = timed(lambda: torch.linalg.inv(
        torch.eye(8, dtype=torch.complex64, device=dev)), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    solver, factor_s = timed(lambda: DirectSolver(eps, mu, dx, dx, omega, device=dev), dev)
    kw = dict(rhs_scale=1.0, refine_target=1e-6)
    (_, trace_first), first_s = timed(lambda: solver.solve(src, **kw), dev)
    (x512, trace), solve_s = timed(lambda: solver.solve(src, **kw), dev)
    if not trace[-2] < 1e-5 or not trace[-2] <= kw["refine_target"]:
        raise AssertionError(f"direct 512^2 solve did not converge: {trace}")
    (x512_64, trace64), split_s = timed(lambda: solver.solve(src, return_split=True, **kw), dev)
    b512 = torch.tensor(src)
    res_cpu = cpu_residual(op128_cpu, b512, x512_64)
    if not res_cpu <= 1e-6:
        raise AssertionError(f"the returned c128 iterate's CPU residual is {res_cpu:.3e}")
    peak = peak_gb(dev)
    # bench.py's CPU size: the refined field against scipy's spsolve
    n128 = 128
    eps_s, mu_s, src_s = fdfd512_scene(n128, omega, constants)
    small = DirectSolver(eps_s, mu_s, dx, dx, omega, device=dev)
    xs64, _ = small.solve(src_s, rhs_scale=1.0, refine_target=1e-10, return_split=True)
    coeffs = [c.numpy().ravel() for c in five_point_coefficients(
        make_operator(eps_s, mu_s, dx, dx, omega, dtype=torch.complex128, device="cpu"))]
    d_, e_, w_, s2, n2 = coeffs
    off = 2 * n128
    A = sp.diags([d_, e_[:-2], w_[2:], s2[:-off], n2[off:]], [0, 2, -2, off, -off], format="csc")
    x_sp = spla.spsolve(A, src_s.ravel()).reshape(n128, n128)
    err_sp = complex_rel_err(xs64.cpu(), torch.tensor(x_sp))
    if not err_sp <= TOL:
        raise AssertionError(f"128^2 direct vs spsolve: relative error {err_sp:.3e} > {TOL}")
    out["fdfd512"] = {"inv_startup_s": inv_startup_s, "factor_s": factor_s,
                      "first_solve_s": first_s, "warm_solve_s": solve_s,
                      "warm_solve_split_s": split_s, "trace": trace, "trace_first": trace_first,
                      "cpu_c128_residual": res_cpu, "factor_growth": solver.factor_growth,
                      "peak_gb": peak, "spsolve_128_rel_err": err_sp}
    done(t0, f"factor {factor_s:.3f} s (first inv {inv_startup_s:.3f} s), warm solve "
             f"{solve_s:.4f} s, trace {[f'{t:.2e}' for t in trace]}, CPU c128 residual "
             f"{res_cpu:.3e}, 128^2 vs spsolve {err_sp:.3e}, peak {peak:.3f} GB")

    # -- 13 needs phase 11's solver: the checkpointed mode at 512^2 --------------------
    t0 = phase("13. checkpointed DirectSolver at 512^2, stride 32")
    torch.cuda.reset_peak_memory_stats(dev)
    ckpt, ck_factor_s = timed(lambda: DirectSolver(eps, mu, dx, dx, omega, checkpointed=True,
                                                   stride=32, device=dev), dev)
    unit = torch.tensor(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)),
                        dtype=torch.complex64, device=dev)
    unit = unit / torch.linalg.vector_norm(unit)
    raw_err = complex_rel_err(ckpt._solve(unit), solver._solve(unit))
    if not raw_err <= TOL:
        raise AssertionError(f"checkpointed raw backsolve vs stored factors: {raw_err:.3e}")
    ckpt.solve(src, **kw)
    (_, ck_trace), ck_solve_s = timed(lambda: ckpt.solve(src, **kw), dev)
    if not ck_trace[-2] <= 1e-6:
        raise AssertionError(f"checkpointed refined residual: {ck_trace}")
    out["ckpt512"] = {"stride": 32, "factor_s": ck_factor_s, "warm_solve_s": ck_solve_s,
                      "raw_backsolve_rel_err": raw_err, "trace": ck_trace,
                      "peak_gb": peak_gb(dev)}
    del ckpt, solver, x512, x512_64, unit
    torch.cuda.empty_cache()
    done(t0, f"factor {ck_factor_s:.3f} s, warm solve {ck_solve_s:.4f} s, raw backsolve vs "
             f"stored {raw_err:.3e}, trace {[f'{t:.2e}' for t in ck_trace]}")

    # -- 12. direct1024 and direct1024batched -----------------------------------------
    t0 = phase("12. direct1024 / direct1024batched: hard binary scene at 1024^2")
    N2, B = 1024, 16
    eps2, mu2, src2 = hard_binary_scene(N2)
    torch.cuda.reset_peak_memory_stats(dev)
    solver2, factor2_s = timed(lambda: DirectSolver(eps2, mu2, dx, dx, omega, device=dev), dev)
    factor_peak = peak_gb(dev)
    solver2.solve(src2, refine_target=1e-6)
    (_, trace2), solve2_s = timed(lambda: solver2.solve(src2, refine_target=1e-6), dev)
    if not trace2[-2] < 1e-5:
        raise AssertionError(f"direct 1024^2 solve did not converge: {trace2}")
    rng0 = np.random.default_rng(0)
    ij = rng0.integers(N2 // 4, 3 * N2 // 4, size=(B, 2))
    srcs = np.zeros((B, N2, N2))
    srcs[np.arange(B), ij[:, 0], ij[:, 1]] = 1.0
    solver2.solve_batched(srcs, refine_target=1e-6)
    torch.cuda.reset_peak_memory_stats(dev)
    (xb, per_sample, trace_b), batched_s = timed(
        lambda: solver2.solve_batched(srcs, refine_target=1e-6), dev)
    batched_peak = peak_gb(dev)
    worst = float(per_sample.max())
    if not worst < 1e-5:
        raise AssertionError(f"batched direct solve did not converge: {worst}")
    singles = []
    for i in range(B):
        xi, _ = solver2.solve(srcs[i], refine_target=1e-6)
        singles.append(norm_rel(xb[i], xi))
    if not max(singles) <= TOL:
        raise AssertionError(f"batched vs single solves: {max(singles):.3e} > {TOL}")
    out["direct1024"] = {"factor_s": factor2_s, "warm_solve_s": solve2_s, "trace": trace2,
                         "factor_growth": solver2.factor_growth,
                         "factor_peak_gb": factor_peak}
    out["direct1024batched"] = {"sources": B, "warm_s": batched_s,
                                "warm_per_source_s": batched_s / B, "trace": trace_b,
                                "worst_residual": worst,
                                "batched_vs_single_rel_err": max(singles),
                                "peak_gb": batched_peak}
    del xb
    done(t0, f"factor {factor2_s:.3f} s (peak {factor_peak:.3f} GB), warm solve {solve2_s:.4f} s "
             f"{[f'{t:.2e}' for t in trace2]}; batched {B}: {batched_s / B:.4f} s a source, "
             f"worst {worst:.3e}, vs singles {max(singles):.3e}, peak {batched_peak:.3f} GB")
    out["rowsweep1024"] = rowsweep_phase(dev, solver2, src2)
    out["residual"] = residual_phase(dev, solver2)
    del solver2
    torch.cuda.empty_cache()

    # -- 14. fdfd512iter --------------------------------------------------------------
    t0 = phase("14. fdfd512iter: FDM-FGMRES at 512^2, restart 20")
    torch.cuda.reset_peak_memory_stats(dev)
    b32 = torch.tensor(src, dtype=torch.complex64, device=dev)
    M, _ = resolve_preconditioner(op32, "fdm")
    kwi = dict(preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
    solve_fdfd(op32, b32, **kwi)
    res_it, iter_s = timed(lambda: solve_fdfd(op32, b32, **kwi), dev)
    if not res_it.relative_residual < 1e-4:
        raise AssertionError(f"fdfd512iter residual {res_it.relative_residual}")
    it_cpu = cpu_residual(op128_cpu, b512, res_it.x)
    KEPT["fdfd512iter"] = (res_it.x, iter_s, res_it.iterations)   # phase 31's single device
    out["fdfd512iter"] = {"warm_solve_s": iter_s, "relative_residual": res_it.relative_residual,
                          "cpu_c128_residual": it_cpu, "iterations": res_it.iterations,
                          "converged": res_it.converged, "peak_gb": peak_gb(dev)}
    done(t0, f"warm solve {iter_s:.4f} s, {res_it.iterations} iterations, residual "
             f"{res_it.relative_residual:.3e} (c128 on the CPU {it_cpu:.3e})")

    # -- 15. the CLI --------------------------------------------------------------------
    t0 = phase("15. CLI: fdtd2d_tpu_torch.cli fdfd --size 512 --device cuda --out ''")
    tol = 1e-6
    cli = {}
    for solver_name in ("direct", "krylov"):
        cmd = [sys.executable, "-m", "fdtd2d_tpu_torch.cli", "fdfd", "--size", "512",
               "--solver", solver_name, "--tol", str(tol), "--device", "cuda", "--out", ""]
        t_cli = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t_cli
        if proc.returncode != 0:
            raise AssertionError(f"CLI {solver_name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        m = re.search(r"^relative residual: (\S+)(?: \(f64 iterate: (\S+)\))?$",
                      proc.stdout, re.M)
        if m is None:
            raise AssertionError(f"CLI {solver_name} printed no residual: {proc.stdout!r}")
        first = float(m.group(1))
        if solver_name == "direct":
            iterate = float(m.group(2))
            if not iterate <= tol:
                raise AssertionError(f"CLI direct: f64-iterate residual {iterate} > {tol}")
            cli[solver_name] = {"residual": first, "f64_iterate_residual": iterate}
        else:
            if not first < 10 * tol:
                raise AssertionError(f"CLI krylov: residual {first} >= {10 * tol}")
            cli[solver_name] = {"residual": first}
        cli[solver_name]["process_s"] = seconds
        print(f"   {solver_name}: {proc.stdout.strip()} ({seconds:.1f} s)")
    out["cli"] = cli
    done(t0)
    return out


def adjoint_phase(dev) -> dict:
    """Phase 19: the adjoint solve's gradients and the batched solve on the
    card, against dense autograd and single solves."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdfd.autodiff import solve_helmholtz_differentiable
    from fdtd2d_tpu_torch.fdfd.solver import solve_fdfd
    from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner_for, stack_preconditioners
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator, stack_operators

    t0 = phase("19. the adjoint on the card: eps, mu and complex-source gradients at 32^2 vs "
               "dense autograd; a batched F = 3 solve vs three single solves")
    N, dx, omega, pml, c128 = 32, 1e-3, 17e9, 8, torch.complex128
    rng = np.random.default_rng(5)

    def t(a):
        return torch.tensor(a, device=dev)

    eps = t(constants.EPSILON_0 * (1.0 + rng.random((N, N))))
    mu = t(np.full((N, N), constants.MU_0))
    b = t(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    w = t(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))

    def op_of(e, m, om=omega, dtype=c128):
        return make_operator(e, m, dx, dx, om, pml_thickness=pml, dtype=dtype, device=dev)

    M = fdm_preconditioner_for(op_of(eps, mu))

    def loss(x):  # not invariant to a global phase: sees a conjugated gradient
        x = x * 1e12
        return (w * x).sum().real + (x.abs() ** 2).sum() * 1e-2

    def custom(e, m, s):
        return loss(solve_helmholtz_differentiable(op_of(e, m), s, preconditioner=M,
                                                   tol=1e-12, maxiter=400))

    def dense(e, m, s):
        eye = torch.eye(N * N, dtype=c128, device=dev).reshape(N * N, N, N)
        A = op_of(e, m).apply(eye).reshape(N * N, -1).T
        return loss(torch.linalg.solve(A, s.reshape(-1)).reshape(N, N))

    def grads(fn):
        leaves = [a.clone().requires_grad_(True) for a in (eps, mu, b)]
        return torch.autograd.grad(fn(*leaves), leaves)

    errs = {name: float((g - r).abs().max() / r.abs().max())
            for name, g, r in zip(("eps", "mu", "source"), grads(custom), grads(dense))}
    for name, err in errs.items():
        if not err <= 1e-6:
            raise AssertionError(f"adjoint {name} gradient vs dense autograd: {err:.3e} > 1e-6")

    omegas = (12e9, 17e9, 23e9)
    eps_b = t(constants.EPSILON_0 * (1.0 + 2.0 * rng.random((N, N))))
    src = np.zeros((N, N))
    src[N // 3, N // 2] = 1.0
    batched = {}
    for dtype, tol, bound in ((c128, 1e-10, 1e-12), (torch.complex64, 1e-5, 1e-5)):
        ops = [op_of(eps_b, mu, om, dtype) for om in omegas]
        op = stack_operators(ops)
        Ms = stack_preconditioners([fdm_preconditioner_for(o) for o in ops])
        bs = torch.stack([t(-1j * om * src) for om in omegas])
        kw = dict(tol=tol, maxiter=400, restart=10)
        res = solve_fdfd(op, bs, preconditioner=Ms, **kw)
        singles = [solve_fdfd(o, bf, **kw) for o, bf in zip(ops, bs)]
        err = max(complex_rel_err(res.x[f], s.x) for f, s in enumerate(singles))
        its = [s.iterations for s in singles]
        if not (err <= bound and res.iterations == its):
            raise AssertionError(f"batched {dtype} solve vs single solves: {err:.3e} (<= {bound}), "
                                 f"iterations {res.iterations} vs {its}")
        batched[str(dtype).split(".")[-1]] = {"rel_err": err, "iterations": res.iterations,
                                              "residuals": res.relative_residual}
    done(t0, "gradients vs dense " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
         "; batched vs single " + ", ".join(f"{k} {v['rel_err']:.3e} {v['iterations']}"
                                             for k, v in batched.items()))
    return {"gradient_rel_err": errs, "batched": batched}


def invdes_phases(dev, profile_fdfd) -> dict:
    """Phase 20: inverse design at 250^2 x 10 frequencies (optimize, the
    profiled step, the finite-difference check, the CLI) and the 848^2
    decade sweep. Returns the ``invdes250`` and ``invdes848`` cells."""
    from fdtd2d_tpu_torch.apps.inverse_design import (
        decade_lowpass_problem, lowpass_problem, make_response_fn, optimize)

    traces = ROOT / "build" / "invdes_traces"  # git-ignored; summarized, then removed
    traces.mkdir(parents=True, exist_ok=True)

    def steps_summary(problem, name):
        steps = profile_fdfd.invdes_steps(problem, 3, trace=traces / f"{name}.json")
        (traces / f"{name}.json").unlink()
        prof = steps[-1].pop("profile")
        last = steps[-1]
        if not all(np.isfinite(s["loss"]) for s in steps):
            raise AssertionError(f"{name}: a loss is not finite: {steps}")
        return {"steps": steps, "warm_step_s": steps[1]["seconds"],
                "forward_iterations": last["forward_iterations"],
                "adjoint_iterations": last["adjoint_iterations"],
                "worst_residual": max(last["forward_residual"] + last["adjoint_residual"]),
                "peak_gb": max(s["peak_gb"] for s in steps),
                "launches_per_iteration": prof["launches_per_iteration"],
                "profiled": {**{k: prof[k] for k in ("wall_ms", "device_busy_ms", "busy_share",
                                                     "launches")},
                             "kernels": {k[:80]: v for k, v in
                                         list(prof["kernels"].items())[:8]}}}

    def say(cell):
        return (f"warm step {cell['warm_step_s']:.3f} s; iterations a member forward "
                f"{cell['forward_iterations']}, adjoint {cell['adjoint_iterations']} (worst "
                f"residual {cell['worst_residual']:.2e}); "
                f"{cell['launches_per_iteration']:.1f} launches an iteration, busy "
                f"{cell['profiled']['busy_share']:.3f}; peak {cell['peak_gb']:.3f} GB")

    t0 = phase("20. inverse design: optimize(lowpass_problem(N=250, n_freqs=10)), complex64, "
               "Adam lr 0.05, opt_tol 1e-4, 5 steps; the profiled step; the gradient vs "
               "finite differences; the CLI; the 848^2 decade sweep")
    problem = lowpass_problem(N=250, n_freqs=10, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stamps = []
    (design, resp, history), optimize_s = timed(lambda: optimize(
        problem, steps=5, lr=0.05, opt_tol=1e-4, log_every=1,
        callback=lambda *a: stamps.append(time.perf_counter())), dev)
    if not (all(np.isfinite(history)) and min(history) < history[0]):
        raise AssertionError(f"invdes250: the loss did not decrease: {history}")
    if not (float(design.min()) >= 1.0 and float(design.max()) <= 3.0):
        raise AssertionError("invdes250: the design left [1, 3]")
    if not (resp.shape == (len(problem.omegas),) and bool(torch.isfinite(resp).all())):
        raise AssertionError(f"invdes250: final responses {resp}")
    cell = {"optimize": {"history": history, "seconds": optimize_s,
                         "warm_step_s": (stamps[4] - stamps[1]) / 3,
                         "responses": resp.tolist(), "peak_gb": peak_gb(dev)}}
    cell.update(steps_summary(problem, "invdes250"))

    # the step-0 gradient against a central difference, complex128 at tol 1e-10
    tight = dataclasses.replace(problem, tol=1e-10, maxiter=2000)
    _, loss = make_response_fn(tight, torch.complex128)
    design0 = torch.full(design.shape, 2.0, dtype=torch.float64, device=dev)
    _, grad, xs = loss.value_and_grad(design0)
    direction = torch.randn(design.shape, generator=torch.Generator().manual_seed(0),
                            dtype=torch.float64).to(dev)
    h = 1e-3
    with torch.no_grad():
        fd = (float(loss(design0 + h * direction, xs))
              - float(loss(design0 - h * direction, xs))) / (2 * h)
    analytic = float((grad * direction).sum())
    fd_err = abs(fd - analytic) / abs(analytic)
    if not fd_err <= 1e-4:
        raise AssertionError(f"invdes250: gradient {analytic} vs finite difference {fd}: "
                             f"{fd_err:.3e} > 1e-4")
    cell["finite_difference"] = {"h": h, "fd": fd, "analytic": analytic, "rel_err": fd_err,
                                 "forward_iterations": loss.info["forward_iterations"]}
    del loss, grad, xs
    torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "fdtd2d_tpu_torch.cli", "invdes", "--size", "250", "--steps",
           "3", "--freqs", "10", "--device", "cuda", "--out", ""]
    t_cli = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t_cli
    m = re.search(r"^final loss: (\S+)$", proc.stdout, re.M)
    if proc.returncode != 0 or m is None or not np.isfinite(float(m.group(1))):
        raise AssertionError(f"CLI invdes exited {proc.returncode}: {proc.stdout!r} "
                             f"{proc.stderr[-2000:]}")
    cell["cli"] = {"final_loss": float(m.group(1)), "process_s": cli_s}
    print(f"   invdes250: optimize 5 steps {optimize_s:.3f} s, history "
          f"{[f'{v:.6f}' for v in history]}, warm step {cell['optimize']['warm_step_s']:.3f} s; "
          f"{say(cell)}; gradient vs finite difference {fd_err:.3e}; CLI final loss "
          f"{m.group(1)} ({cli_s:.1f} s)")

    decade = decade_lowpass_problem(N=848, n_freqs=10, device=dev)
    cell848 = steps_summary(decade, "invdes848")
    traces.rmdir()
    losses = [f"{step['loss']:.6f}" for step in cell848["steps"]]
    print(f"   invdes848: losses {losses}, {say(cell848)}")
    done(t0)
    return {"invdes250": cell, "invdes848": cell848}


def tiled_phase(dev, profile_fdfd) -> dict:
    """Phase 21: the tiled Schwarz solver on the card, against the port's
    CPU run at 160^2 in complex128, then bench.py's tiled1024 and
    tiled1024approx rows at full size (tools/profile_fdfd.py's
    ``tiled_cell``)."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver, run_fdfd_tiled

    t0 = phase("21. tiled Schwarz: 160^2 on the card vs the CPU in complex128 (krylov, "
               "additive, multiplicative); tiled1024 and tiled1024approx at full size")
    N, dx, omega = 160, 1e-3, 17e9
    eps = np.full((N, N), constants.EPSILON_0)
    eps[60:100, 40:70] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    src[N // 2, N // 2] = 10.0
    small = dict(patch_size=64, padding=24, pml_thickness=10, dtype=torch.complex128)
    runs = {}
    for where in (dev, "cpu"):
        solver = TiledSolver(eps, mu, dx, dx, omega, device=where, **small)
        x, trace = solver.solve(src, solver_tol=1e-8, solver_maxiter=120, refine_target=1e-10)
        runs[str(where)] = (x.cpu(), trace, solver.outer_iterations, solver._patch_decision)
    (x_d, trace_d, its_d, dec_d), (x_c, _, its_c, dec_c) = runs.values()
    parity = {"krylov": complex_rel_err(x_d, x_c)}
    if not (parity["krylov"] <= 1e-6 and trace_d[-2] <= 1e-10 and its_d == its_c
            and dec_d == dec_c):
        raise AssertionError(f"tiled 160^2 c128: card vs CPU {parity['krylov']:.3e}, trace "
                             f"{trace_d}, outer iterations {its_d} vs {its_c}")
    stationary = dict(n_passes=2, relax=0.5, tol=1e-9, solver_tol=1e-6, solver_maxiter=60)
    for mode in ("additive", "multiplicative"):
        (xa, da), (xb, db) = (run_fdfd_tiled(eps, mu, dx, dx, omega, src, mode=mode,
                                             device=where, **small, **stationary)
                              for where in (dev, "cpu"))
        parity[mode] = complex_rel_err(xa.cpu(), xb)
        if not (parity[mode] <= 1e-6 and np.allclose(da, db, rtol=1e-6, atol=0)):
            raise AssertionError(f"tiled {mode} 160^2 c128: card vs CPU {parity[mode]:.3e}, "
                                 f"deltas {da} vs {db}")
    traces = ROOT / "build" / "schwarz_traces"  # git-ignored; summarized, then removed
    traces.mkdir(parents=True, exist_ok=True)
    cells = {}
    for name, approx in (("tiled1024", False), ("tiled1024approx", True)):
        trace = traces / f"{name}.json"
        cell = profile_fdfd.tiled_cell(1024, approx=approx, dev=dev, trace=trace)
        trace.unlink()
        res = cell["trace"]
        ok = (res[-1] < 1e-2 and cell["c128_residual"] < 1e-2 if approx else
              res[-2] < 1e-5 and abs(cell["c128_residual"] - res[-1]) <= 1e-3 * res[-1])
        if not ok:
            raise AssertionError(f"{name}: trace {res}, complex128 residual of the returned "
                                 f"field {cell['c128_residual']:.3e}")
        cell["profiled"]["kernels"] = {k[:80]: v for k, v in
                                       list(cell["profiled"]["kernels"].items())[:8]}
        cells[name] = cell
        print(f"   {name}: {cell['patches']} patches of {cell['window']}^2, probe coarse "
              f"{cell['probe']['coarse']:.4f} two-level {cell['probe']['two_level']:.4f} -> "
              f"{cell['probe']['decision']}; cold {cell['cold_solve_s']:.3f} s, warm "
              f"{cell['warm_solve_s']:.3f} s; trace {[f'{t:.2e}' for t in res]}, outer "
              f"iterations {cell['outer_iterations']} (restart {cell['outer_restart']}); "
              f"c128 residual {cell['c128_residual']:.3e}; "
              f"{cell['launches_per_outer_iteration']:.1f} launches an outer iteration, busy "
              f"{cell['busy_share_unprofiled']:.3f} ({cell['profiled']['busy_share']:.3f} "
              f"profiled); peak {cell['peak_gb']:.3f} GB")
    traces.rmdir()
    done(t0, "160^2 card vs CPU " + ", ".join(f"{k} {v:.3e}" for k, v in parity.items()) +
         f"; outer iterations {its_d}")
    return {"parity_160_c128": parity, "outer_iterations_160": its_d, **cells}


# refinement rounds of timedomain4096 to 1e-6 (14 in the first H100 run; the
# contraction a round falls from 1.3e-2 to 0.7, so the first round does not
# predict the count)
TD4096_ROUNDS = 15


def timedomain_phase(dev, profile_fdfd, t_script: float, budget_s: float = 420.0) -> dict:
    """Phase 22: the time-domain solver on the card: one wave run at 96^2
    against the CPU's, ms a wave step at 4096^2 beside its bound, one timed
    4096^2 application with its residual, and bench.py's timedomain4096
    solve, at 2048^2 where TD4096_ROUNDS applications at 4096^2 would take
    the script past ``budget_s`` (the phases after it take about 600 s more;
    the 4096^2 solve is then tools/profile_fdfd.py's ``--paths timedomain
    --size 4096``)."""
    from fdtd2d_tpu_torch.fdfd.direct import split_sublattices
    from fdtd2d_tpu_torch.fdfd.timedomain import TimeDomainSolver, build_wave_bundle, wave_run

    t0 = phase("22. time domain: a 96^2 wave run vs the CPU; ms a wave step at 4096^2; "
               "timedomain4096 (transits 2.5, refined to 1e-6)")
    omega, dx, out = 17e9, 1e-3, {}
    eps, mu, src = profile_fdfd.block_scene(96)
    b = torch.tensor(-1j * omega * src, dtype=torch.complex64)
    b_sub = torch.stack(split_sublattices(b / torch.linalg.vector_norm(b)))
    x = {str(where): wave_run(build_wave_bundle(eps, mu, dx, dx, omega, device=where),
                              b_sub.to(where)).cpu() for where in (dev, "cpu")}
    out["wave_run_96_rel_err"] = complex_rel_err(*x.values())
    if not out["wave_run_96_rel_err"] <= 1e-4:
        raise AssertionError(f"wave_run 96^2 card vs CPU: {out['wave_run_96_rel_err']:.3e}")

    N = 4096
    eps, mu, src = profile_fdfd.block_scene(N)
    torch.cuda.reset_peak_memory_stats(dev)
    solver = TimeDomainSolver(eps, mu, dx, dx, omega, transits=2.5, device=dev)
    trace = ROOT / "build" / "wave_step.json"
    trace.parent.mkdir(exist_ok=True)
    step = {"ms": profile_fdfd.wave_step_ms(solver.bundle),
            "bound_ms": profile_fdfd.WAVE_STEP_BYTES * N * N / profile_fdfd.HBM_BYTES_S * 1e3,
            **{k: v for k, v in profile_fdfd.wave_step_profile(solver.bundle, trace).items()
               if k in ("launches_per_step", "busy_share", "device_busy_ms", "wall_ms")}}
    trace.unlink()
    step["share_of_bound"] = step["bound_ms"] / step["ms"]
    out["step_4096"] = step
    print(f"   wave step at {N}^2: {step['ms']:.4f} ms (bound {step['bound_ms']:.4f} ms: "
          f"{profile_fdfd.WAVE_STEP_BYTES} B a cell at 3.35 TB/s; share "
          f"{step['share_of_bound']:.3f}), {step['launches_per_step']:.1f} launches a step, "
          f"busy {step['busy_share']:.3f} under the profiler")

    e256, m256, s256 = profile_fdfd.block_scene(256)  # warm-up: no compile to amortize
    TimeDomainSolver(e256, m256, dx, dx, omega, device=dev).solve(s256, refine_target=1e-6)
    b64 = torch.as_tensor(src, device=dev).to(torch.complex128) * (-1j * omega)
    unit = b64 / torch.linalg.vector_norm(b64)
    first, app_s = timed(lambda: solver.precondition(unit.to(torch.complex64)), dev)
    contraction = float(torch.linalg.vector_norm(solver.op64.residual(unit, first.to(
        torch.complex128))))
    estimate = TD4096_ROUNDS * app_s
    out["first_application_4096"] = {"seconds": app_s, "contraction": contraction,
                                     "steps": solver.steps_per_apply,
                                     "estimated_solve_s": estimate}
    print(f"   first application at {N}^2: {solver.steps_per_apply} steps in {app_s:.2f} s, "
          f"residual {contraction:.3e} of the unit right-hand side; a solve to 1e-6 of "
          f"{TD4096_ROUNDS} rounds: about {estimate:.0f} s")
    if time.perf_counter() - t_script + estimate > budget_s:
        N = 2048
        eps, mu, src = profile_fdfd.block_scene(N)
        solver = TimeDomainSolver(eps, mu, dx, dx, omega, transits=2.5, device=dev)
    (x, res), solve_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
    if not (res[-2] < 1e-6 and bool(torch.isfinite(x).all())):
        raise AssertionError(f"timedomain {N}^2 did not converge: {res}")
    out["solve"] = {"size": N, "seconds": solve_s, "trace": res, "rounds": len(res) - 2,
                    "steps_per_apply": solver.steps_per_apply, "peak_gb": peak_gb(dev)}
    del solver, first, x
    torch.cuda.empty_cache()
    done(t0, f"96^2 wave run vs CPU {out['wave_run_96_rel_err']:.3e}; timedomain{N}: "
             f"{solve_s:.2f} s, {len(res) - 2} rounds of {out['solve']['steps_per_apply']} "
             f"steps, trace {[f'{t:.2e}' for t in res]}")
    return out


def schwarz_cli_phase() -> dict:
    """Phase 23: ``tiled --size 512`` and ``fdfd --size 512 --solver
    timedomain`` on the card, each in its own process."""
    t0 = phase("23. CLI: tiled --size 512 and fdfd --size 512 --solver timedomain, "
               "--device cuda --out ''")
    cli = {}
    for name, args in (("tiled", ["tiled", "--size", "512"]),
                       ("timedomain", ["fdfd", "--size", "512", "--solver", "timedomain"])):
        cmd = [sys.executable, "-m", "fdtd2d_tpu_torch.cli", *args, "--device", "cuda",
               "--out", ""]
        t_cli = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t_cli
        if proc.returncode != 0:
            raise AssertionError(f"CLI {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        if name == "tiled":
            m = re.search(r"^convergence trace: \[(.*)\]$", proc.stdout, re.M)
            values = [float(v.strip("'")) for v in m.group(1).split(", ")] if m else []
            ok = len(values) >= 3 and values[-2] <= 1e-6
            cli[name] = {"trace": values}
        else:
            m = re.search(r"^relative residual: (\S+) \(f64 iterate: (\S+);", proc.stdout, re.M)
            ok = m is not None and float(m.group(2)) <= 1e-6
            cli[name] = {"residual": float(m.group(1)), "f64_iterate_residual": float(m.group(2))
                         } if m else {}
        if not ok:
            raise AssertionError(f"CLI {name} printed no converged residual: {proc.stdout!r}")
        cli[name]["process_s"] = seconds
        print(f"   {name}: {proc.stdout.strip()} ({seconds:.1f} s)")
    done(t0)
    return cli


def surrogate_phases(dev, bench_surrogate) -> dict:
    """Phases 24-27: the diffusion surrogate on the card (datagen, the train
    step, inference, the CLI). Returns the ``{"surrogate": ...}`` line."""
    out = {}
    t0 = phase("24. surrogate datagen: the scene-batched factor at 48^2 vs the CPU in "
               "complex128; generate_dataset at 250^2, batch 64")
    cell = bench_surrogate.datagen_cell(dev)
    out["datagen"] = {"parity": bench_surrogate.factor_parity(dev), "cell": cell}
    done(t0, f"{cell['warm_samples_per_s']:.2f} samples/s warm, worst true residual "
             f"{cell['worst_true_residual']:.3e}, split {cell['split_s_one_batch']}, peak "
             f"{cell['peak_gb']:.2f} GB; parity {out['datagen']['parity']}")
    t0 = phase("25. the train step: small UNet on the card vs the CPU; UNet2D() at 256^2, "
               "batch 8, float32 (TF32) and bf16")
    out["train"] = {"parity": bench_surrogate.train_parity(dev)}
    cell, states = bench_surrogate.train_cell(dev, ROOT / "build" / "train_step.json")
    out["train"]["cell"] = cell
    done(t0, f"ms a step {cell['ms_per_step']}, {cell['flops_per_step'] / 1e12:.3f} TFLOP a "
             f"step, bf16 {cell['mfu_bfloat16_vs_bfloat16_peak']:.3f} of its peak, f32 "
             f"{cell['mfu_float32_vs_tf32_peak']:.3f} of the TF32 peak, peak {cell['peak_gb_in_steps']} "
             f"GB, busy {[p['busy_share'] for p in cell['profile'].values()]}")
    t0 = phase("26. inference: 50-step chains at 256^2, batch 8; regress; a 2-member ensemble")
    out["infer"] = bench_surrogate.infer_cell(dev, states["bfloat16"])
    del states
    torch.cuda.empty_cache()
    done(t0, ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in out["infer"].items()))
    t0 = phase("27. CLI: datagen, train, infer on cuda, a process each")
    out["cli"] = bench_surrogate.cli_cell(ROOT / "build" / "surrogate_cli")
    done(t0, ", ".join(f"{k} {v['process_s']:.1f} s" for k, v in out["cli"].items()))
    t0 = phase("38. the surrogate's readout on cuda, a process each: apps.surrogate_report "
               "(holdout 8, epsilon) and apps.surrogate_diagnose on phase 27's run")
    out["readout"] = bench_surrogate.readout_cell(ROOT / "build" / "surrogate_cli")
    done(t0, ", ".join(f"{k} {v['process_s']:.1f} s" for k, v in out["readout"].items())
         + f"; ensemble corr mean {out['readout']['report']['corr_mean']['corr_e']:.4f}")
    return out


# direct2048's HODLR store (rank 20, leaf 128: 3 levels): 4 sublattices x 1024
# rows x 253,952 complex64 entries; the stored factors' 4 x 1024 x 1024^2
DIRECT2048_STORE_BYTES = 8_321_499_136
STORED2048_BYTES = 34_359_738_368


def hodlr_plan_bytes(comp, N: int, rank: int, leaf: int, itemsize: int = 8) -> int:
    """Bytes of an N x N grid's HODLR store, counted from the plan alone."""
    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=leaf, rank=rank)
    m = nc >> L
    row = (1 << L) * m * m + sum(4 * (1 << (lev - 1)) * (nc >> lev) * rank
                                 for lev in range(1, L + 1))
    return 4 * (N // 2) * row * itemsize


def contraction(trace) -> float:
    """Geometric mean of the residual's contraction a refinement round,
    after the first correction."""
    rounds = len(trace) - 2
    return (trace[-2] / trace[1]) ** (1 / (rounds - 1)) if rounds > 1 else float("nan")


def compressed_phase(dev) -> tuple:
    """Phase 28: the compressed mode at 160^2 on the card against the CPU,
    then direct2048 at full size. Returns its numbers, the time the stored
    2048^2 factor and two solves should take (the compressed factor
    recomputes every stored inverse) and the 2048^2 scene."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd import compressed as comp
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    t0 = phase("28. compressed (HODLR) DirectSolver: 160^2 on the card vs the CPU; direct2048 "
               "(rank 20, leaf 128, power_iters 1) at full size, solved stacked and as a loop")
    out, dx = {}, 1e-3
    N, omega = 160, 24e9
    eps, mu, src = hard_binary_scene(N, seed=3, sigma=4.0, source_amp=10.0)
    rhs = torch.tensor(-1j * omega * src, dtype=torch.complex64)
    rhs /= torch.linalg.vector_norm(rhs)
    small, refined = {}, {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        x_full = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=20, device=where)._solve(
            rhs.to(where))
        for q, bound in ((0, 1e-2), (1, 3e-3)):
            s = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=20, compressed=True, rank=10,
                             leaf=16, power_iters=q, device=where)
            raw = norm_rel(s._solve(rhs.to(where)), x_full)
            x64, trace = s.solve(src, refine_target=1e-9, return_split=True)
            if not (raw < bound and trace[-1] < 1e-8):
                raise AssertionError(f"compressed 160^2 on the {label}, q={q}: raw backsolve vs "
                                     f"the full store {raw:.3e} (bound {bound}), trace {trace}")
            small[f"{label}_q{q}"] = {"raw_vs_full_store": raw, "trace": trace}
            refined[(label, q)] = x64.cpu()
    for q in (0, 1):
        small[f"card_vs_cpu_refined_q{q}"] = norm_rel(refined[("card", q)], refined[("cpu", q)])
        if not small[f"card_vs_cpu_refined_q{q}"] <= 1e-6:
            raise AssertionError(f"compressed 160^2 refined, card vs CPU: {small}")
    out["parity_160"] = small
    print(f"   160^2: raw vs full store " + ", ".join(
        f"{k} {v['raw_vs_full_store']:.3e}" for k, v in small.items() if isinstance(v, dict))
        +
        f"; refined card vs CPU {small['card_vs_cpu_refined_q0']:.3e} (q 0), "
        f"{small['card_vs_cpu_refined_q1']:.3e} (q 1)")

    N, omega = 2048, 17e9
    scene = hard_binary_scene(N, seed=3, source_amp=10.0)
    eps, mu, src = scene
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    solver, factor_s = timed(lambda: DirectSolver(
        eps, mu, dx, dx, omega, pml_thickness=40, compressed=True, rank=20, leaf=128,
        power_iters=1, device=dev), dev)
    factor_peak = peak_gb(dev)
    plan_bytes = hodlr_plan_bytes(comp, N, 20, 128)
    if not solver.compressed_bytes == plan_bytes == DIRECT2048_STORE_BYTES:
        raise AssertionError(f"direct2048 store {solver.compressed_bytes} B, plan {plan_bytes} B")
    (_, trace_cold), cold_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
    (x, trace), warm_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
    if not (trace[-2] < 1e-5 and trace[-2] <= 1e-6 and bool(torch.isfinite(x).all())):
        raise AssertionError(f"direct2048 did not converge: {trace}")
    stacked = solver.factors
    solver.factors = comp.sublattice_views(stacked.stacked, stacked.shape)
    try:
        (x_loop, trace_loop), loop_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
    finally:
        solver.factors = stacked
    loop_vs_stacked = norm_rel(x_loop, x)
    if not (trace_loop[-2] <= 1e-6 and loop_vs_stacked <= 1e-5):
        raise AssertionError(f"direct2048 loop solve: {trace_loop}, vs stacked {loop_vs_stacked}")
    out["direct2048"] = {
        "rank": 20, "leaf": 128, "power_iters": 1, "factor_s": factor_s,
        "store_bytes": solver.compressed_bytes, "factor_peak_gb": factor_peak,
        "factor_growth": solver.factor_growth, "cold_solve_s": cold_s, "trace_cold": trace_cold,
        "warm_solve_stacked_s": warm_s, "trace": trace, "rounds": len(trace) - 2,
        "warm_solve_loop_s": loop_s, "trace_loop": trace_loop,
        "loop_vs_stacked_rel_err": loop_vs_stacked, "peak_gb": peak_gb(dev)}
    del solver, stacked, x, x_loop
    torch.cuda.empty_cache()
    done(t0, f"direct2048: factor {factor_s:.2f} s, store {plan_bytes / 1e9:.3f} GB, factor peak "
             f"{factor_peak:.2f} GB, growth {out['direct2048']['factor_growth']:.3e}; solve to "
             f"1e-6 cold {cold_s:.3f} s, warm stacked (the default) {warm_s:.3f} s, warm as a loop "
             f"over the four sublattices {loop_s:.3f} s; {len(trace) - 2} inner solves, trace "
             f"{[f'{t:.2e}' for t in trace]}")
    return out, factor_s + 2 * warm_s, scene


def stored2048_phase(dev, scene, estimate_s: float, t_script: float,
                     budget_s: float = 1080.0) -> dict:
    """Phase 28, continued: direct2048stored, plain DirectSolver() at 2048^2
    (the 34.4 GB store). Cut when the estimate (the compressed factor plus
    two of its warm solves) would take the script past ``budget_s``."""
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    t0 = phase("28, continued. direct2048stored: DirectSolver() at 2048^2, the 34.4 GB store")
    elapsed = time.perf_counter() - t_script
    if elapsed + estimate_s > budget_s:
        done(t0, f"cut: {elapsed:.0f} s into the script, the factor and solves would take about "
                 f"{estimate_s:.0f} s more, past {budget_s:.0f} s")
        return {"cut": True, "elapsed_s": elapsed, "estimate_s": estimate_s}
    eps, mu, src = scene
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    solver, factor_s = timed(lambda: DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=40,
                                                  device=dev), dev)
    factor_peak = peak_gb(dev)
    store = solver.factors.stacked.Ws.numel() * solver.factors.stacked.Ws.element_size()
    if store != STORED2048_BYTES:
        raise AssertionError(f"direct2048stored store {store} B")
    (_, trace_cold), cold_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
    (x, trace), warm_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
    if not (trace[-2] <= 1e-6 and bool(torch.isfinite(x).all())):
        raise AssertionError(f"direct2048stored did not converge: {trace}")
    out = {"cut": False, "factor_s": factor_s, "store_bytes": store,
           "factor_peak_gb": factor_peak, "factor_growth": solver.factor_growth,
           "cold_solve_s": cold_s, "trace_cold": trace_cold, "warm_solve_s": warm_s,
           "trace": trace, "rounds": len(trace) - 2, "estimate_s": estimate_s}
    del solver, x
    torch.cuda.empty_cache()
    done(t0, f"factor {factor_s:.2f} s (estimate {estimate_s:.0f} s for all), store "
             f"{store / 1e9:.2f} GB, peak {factor_peak:.2f} GB; solve to 1e-6 cold {cold_s:.3f} s, "
             f"warm {warm_s:.3f} s, trace {[f'{t:.2e}' for t in trace]}")
    return out


def hps_phase(dev) -> dict:
    """Phase 29: the HPS factor at 64^2 on the card against the CPU, then
    DirectSolver(hps=True) at 512^2 and 1024^2."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    t0 = phase("29. HPS DirectSolver: 64^2 on the card vs the CPU; the hard scene at 512^2 and "
               "1024^2 (hps_leaf 8), refined to 1e-6 within 40 rounds")
    out, dx, omega = {}, 1e-3, 17e9
    eps, mu, src = hard_binary_scene(64, seed=3, sigma=4.0, source_amp=10.0)
    xs = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        op = make_operator(eps, mu, dx, dx, omega, pml_thickness=12, device=where)
        b = torch.tensor(-1j * omega * src, dtype=torch.complex64, device=where)
        xs[label] = hps.hps_solve(hps.hps_factor(op, m=8), b)
        res = norm_rel(op.apply(xs[label]), b)
        if not res < 5e-5:
            raise AssertionError(f"HPS 64^2 raw complex64 residual on the {label}: {res:.3e}")
        out[f"raw_residual_64_{label}"] = res
    out["card_vs_cpu_64"] = norm_rel(xs["card"].cpu(), xs["cpu"])
    for N in (512, 1024):
        eps, mu, src = hard_binary_scene(N, seed=3, source_amp=10.0)
        torch.cuda.reset_peak_memory_stats(dev)
        solver, factor_s = timed(lambda: DirectSolver(eps, mu, dx, dx, omega, pml_thickness=40,
                                                      hps=True, hps_leaf=8, device=dev), dev)
        factor_peak = peak_gb(dev)
        if solver.hps_bytes != hps.predicted_factor_bytes(N, 8):
            raise AssertionError(f"hps{N}: {solver.hps_bytes} B, predicted "
                                 f"{hps.predicted_factor_bytes(N, 8)}")
        (_, trace_cold), cold_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
        (x, trace), warm_s = timed(lambda: solver.solve(src, refine_target=1e-6), dev)
        if not (trace[-2] <= 1e-6 and bool(torch.isfinite(x).all())):
            raise AssertionError(f"hps{N} did not reach 1e-6 in 40 rounds: {trace}")
        out[f"hps{N}"] = {"factor_s": factor_s, "store_bytes": solver.hps_bytes,
                          "factor_peak_gb": factor_peak, "factor_growth": solver.factor_growth,
                          "cold_solve_s": cold_s, "warm_solve_s": warm_s, "trace": trace,
                          "trace_cold": trace_cold, "rounds": len(trace) - 2,
                          "contraction": contraction(trace), "peak_gb": peak_gb(dev)}
        del solver, x
        torch.cuda.empty_cache()
        print(f"   hps{N}: factor {factor_s:.3f} s, store {out[f'hps{N}']['store_bytes'] / 1e9:.3f} "
              f"GB, peak {factor_peak:.3f} GB; warm solve {warm_s:.3f} s (cold {cold_s:.3f}), "
              f"{len(trace) - 2} rounds, contraction {out[f'hps{N}']['contraction']:.3f} a round")
    done(t0, f"64^2: raw residual card {out['raw_residual_64_card']:.3e}, CPU "
             f"{out['raw_residual_64_cpu']:.3e}, card vs CPU {out['card_vs_cpu_64']:.3e}")
    return out


def hps_sweep_phase(dev) -> dict:
    """Phase 42 (right after phase 29): the HPS level kernel at 2048^2 on
    the fdfd-hps scene: the main path's launch count, the kernel against
    the torch path at K = 16 and K = 1, ms of each in turns and of the
    kernel's launches by direction, beside the floor and the roofline."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver
    from fdtd2d_tpu_torch.ops import fdfd_hps
    from fdtd2d_tpu_torch.utils import trace

    t0 = phase("42. the HPS level kernel at 2048^2 vs the torch path, K = 16 and K = 1")
    N = 2048
    eps, mu, _ = hard_binary_scene(N, seed=7, contrast=3.0)
    solver = DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=40, hps=True, hps_leaf=8,
                          device=dev)
    f = solver.factors
    plan = hps.build_plan(N // 2, N // 2, 8)
    launches = 2 * (len(plan.merges) + 1)
    plain_rule = hps._on_card
    ij = np.random.default_rng(42).integers(N // 4, 3 * N // 4, size=(16, 2))
    srcs = np.zeros((16, N, N))
    srcs[np.arange(16), ij[:, 0], ij[:, 1]] = 1.0
    before = trace.counters()
    _, res, tr = solver.solve_batched(srcs, refine_target=1e-6, return_split=True)
    inner = trace.delta(before, "fdfd.backsolve")
    counted = trace.delta(before, "fdfd.kernels.hps_sweeps")
    if counted != launches * inner or not float(res.max()) <= 1e-6:
        raise AssertionError(f"solve_batched at {N}^2: {counted} kernel launches for {inner} "
                             f"inner solves ({launches} each), residuals {res}")
    hps._on_card = lambda f_, b_: False
    try:
        _, res_torch, tr_torch = solver.solve_batched(srcs, refine_target=1e-6, return_split=True)
    finally:
        hps._on_card = plain_rule
    if len(tr) > len(tr_torch):
        raise AssertionError(f"the kernel's refinement took more rounds than the torch path's: "
                             f"{tr} against {tr_torch}")
    out = {"solve_batched_trace": list(tr), "torch_path_trace": list(tr_torch),
           "launches_an_inner_solve": launches}
    print(f"   solve_batched of 16 sources: {inner} inner solves, {counted} level-kernel "
          f"launches, trace {[f'{t:.2e}' for t in tr]}; the torch path's "
          f"{[f'{t:.2e}' for t in tr_torch]}")
    del srcs
    # complex64 entries of every stored Y (the root's inverse included) and E
    y = sum(lev.Y.numel() for lev in (f.stacked.leaf, *f.stacked.levels)) + f.stacked.Yroot.numel()
    e = sum(lev.E.numel() for lev in (f.stacked.leaf, *f.stacked.levels))
    for K in (16, 1):
        gen = torch.Generator(device=dev).manual_seed(K)
        b = torch.randn(K, N, N, dtype=torch.complex64, device=dev, generator=gen)
        x = hps.hps_solve(f, b)
        hps._on_card = lambda f_, b_: False
        try:
            x_torch = hps.hps_solve(f, b)
            ms = {"kernel": [], "torch": []}
            for name in ("torch", "kernel", "kernel", "torch"):
                if name == "torch":
                    ms[name].append(events_ms(lambda: hps.hps_solve(f, b), 3))
                else:
                    hps._on_card = plain_rule
                    ms[name].append(events_ms(lambda: hps.hps_solve(f, b), 10))
                    hps._on_card = lambda f_, b_: False
        finally:
            hps._on_card = plain_rule
        err = float((torch.linalg.vector_norm(x - x_torch, dim=(1, 2))
                     / torch.linalg.vector_norm(x_torch, dim=(1, 2))).max())
        # the two sum in another order, and the raw complex64 solve at 2048^2
        # is far from exact (the torch path's first refinement round leaves
        # ~0.15): the difference is of the solves' own error
        if not err <= 0.05:
            raise AssertionError(f"HPS kernel at K = {K}: {err:.3e} from the torch path")
        # each launch's device time, by events around it
        marks, launch = [], fdfd_hps.launch

        def marked(lp, *a, **k):
            s, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            launch(lp, *a, **k)
            e_.record()
            marks.append((lp, s, e_))

        fdfd_hps.launch = marked
        try:
            hps.hps_solve(f, b)
            torch.cuda.synchronize(dev)
        finally:
            fdfd_hps.launch = launch
        by = {"up": 0.0, "down": 0.0}
        levels = []
        for lp, s, e_ in marks:
            t = s.elapsed_time(e_)
            by["down" if lp.down else "up"] += t
            levels.append({"down": lp.down, "nJ": lp.nJ, "nR": lp.nR, "items": lp.items,
                           "tc": lp.tc, "blocks": lp.blocks, "ms": t})
        floor = 8 * (y + 2 * e) / HBM_BYTES_S * 1e3
        least = 1e3 * max(8 * (y + e + 2 * K * N * N) / HBM_BYTES_S,
                          8 * K * (y + 2 * e) / F32_FLOPS)
        best = min(ms["kernel"])
        out[f"K{K}"] = {"kernel_ms": ms["kernel"], "torch_ms": ms["torch"], "up_ms": by["up"],
                        "down_ms": by["down"], "levels": levels, "floor_ms_y_2e": floor,
                        "roofline_least_ms": least, "floor_share": floor / best,
                        "roofline_share": least / best, "rel_err_vs_torch": err}
        print(f"   K = {K}: inner solve kernel {[f'{t:.3f}' for t in ms['kernel']]} ms, torch "
              f"{[f'{t:.3f}' for t in ms['torch']]}; launches up {by['up']:.3f} + down "
              f"{by['down']:.3f} ms; Y + 2E floor {floor:.3f} ms ({100 * floor / best:.1f}%), "
              f"roofline {least:.3f} ms ({100 * least / best:.1f}%); vs torch {err:.3e}")
        print("   " + "; ".join(f"{'dn' if v['down'] else 'up'} {v['nJ']}x{v['nR']} "
                                 f"{v['ms']:.3f}" for v in levels))
        del b, x, x_torch
    del solver, f
    torch.cuda.empty_cache()
    done(t0)
    return out


def sharded_direct_phase(dev) -> dict:
    """Phase 30: factor_sharded on meshes of cuda:0 (4 and 2 entries) at
    512^2 in the stored, checkpointed and compressed modes, each against the
    single-device solve of its mode that batches as the mesh does (one
    sublattice a call for 4 entries, stacked for 2). The stored and
    checkpointed raw backsolves are held to <= 1e-6. The compressed one is
    as accurate as its range finder, and two runs that round differently
    (the card's batched QR and products depend on the batch) truncate
    differently: its raw difference is reported, it is held to the stored
    backsolve on the same mesh (the same batching, so the same rounding of
    the dense recursion) at <= 1e-5, and the solve refined to 1e-10 with
    the sharded factors is held to the one with the single-device factors
    at <= 1e-6.

    Batching: the card inverts one block (cuSOLVER) and a batch of blocks
    (cuBLAS batched LU) with different, equally backward-stable rounding,
    and the pivotless complex64 recursion carries that to ~1e-4 in the
    solution. Every raw solve is therefore also read against the complex128
    stacked solve (held <= 1e-3), and the compressed factor one sublattice
    at a time against the batched one is held to the dense store's own
    spread between the two (plus 1e-5): the compressed path adds only its
    truncation."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd import compressed as comp
    from fdtd2d_tpu_torch.fdfd.direct import (
        StackedFactors, factor, factor_checkpointed, factor_stacked, solve_checkpointed,
        solve_factored, solve_stacked, stack_coefficients)
    from fdtd2d_tpu_torch.fdfd.refine import refine
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator
    from fdtd2d_tpu_torch.parallel import factor_sharded, make_mesh, solve_factored_sharded

    t0 = phase("30. factor_sharded on meshes of 4 and 2 x cuda:0 at 512^2 (stored, checkpointed "
               "stride 32, compressed rank 20) vs the single-device solve of each mode")
    N, omega = 512, 17e9
    eps, mu, src = hard_binary_scene(N, seed=3, source_amp=10.0)
    op = make_operator(eps, mu, 1e-3, 1e-3, omega, pml_thickness=40, device=dev)
    op64 = make_operator(eps, mu, 1e-3, 1e-3, omega, pml_thickness=40, dtype=torch.complex128,
                         device=dev)
    b64 = torch.tensor(-1j * omega * src, device=dev)
    b = (b64 / torch.linalg.vector_norm(b64)).to(torch.complex64)
    nc = op.shape[1] // 2
    L = comp.hodlr_plan(nc, leaf=128, rank=20)
    om = comp.make_test_matrices(nc, L, 20, device=dev)
    x_stored = solve_stacked(factor_stacked(op), b)
    b64 = b64 / torch.linalg.vector_norm(b64)
    x_c128 = solve_stacked(factor_stacked(op64), b64)
    x_stored_loop = solve_factored(factor(op), b)
    batching = {"stored_loop_vs_stacked": norm_rel(x_stored_loop, x_stored),
                "stored_stacked_vs_c128": norm_rel(x_stored, x_c128),
                "stored_loop_vs_c128": norm_rel(x_stored_loop, x_c128)}

    def compressed_loop():
        f = comp.factor_compressed(op, om, L=L, q=1)
        return lambda r: comp.solve_compressed(f, r)

    def compressed_stacked():
        f = StackedFactors(stacked=comp.factor_compressed_stacked(
            stack_coefficients(op), om, L=L, q=1), shape=op.shape)
        return lambda r: solve_stacked(f, r)

    def solver_of(f, solve):
        return lambda r: solve(f, r)

    modes = {   # kw, single-device solve per sublattice (4 entries), stacked (2)
        "stored": ({}, lambda: solver_of(factor(op), solve_factored),
                   lambda: solver_of(factor_stacked(op), solve_stacked)),
        "checkpointed": (dict(checkpointed=True, stride=32),
                         lambda: solver_of(factor_checkpointed(op, 32), solve_checkpointed),
                         lambda: solver_of(factor_stacked(op, checkpointed=True, stride=32),
                                           solve_stacked)),
        "compressed": (dict(compressed=True, rank=20, leaf=128, power_iters=1),
                       compressed_loop, compressed_stacked),
    }
    out, got_of, ref_of = {}, {}, {}
    for mode, (kw, per_sublattice, stacked) in modes.items():
        for entries, single in ((4, per_sublattice()), (2, stacked())):
            mesh = make_mesh((entries,), axis_names=("s",), devices=[dev] * entries)
            f, factor_s = timed(lambda: factor_sharded(op, mesh, **kw), dev)
            got, ref = solve_factored_sharded(f, b), single(b)
            got_of[mode, entries], ref_of[mode, entries] = got, ref
            rec = {"raw_rel_err": norm_rel(got, ref), "bit_for_bit": bool(torch.equal(got, ref)),
                   "raw_vs_c128": norm_rel(got, x_c128), "factor_s": factor_s}
            ok = rec["raw_vs_c128"] <= 1e-3
            if mode == "compressed":
                rec["raw_vs_stored_stacked"] = norm_rel(got, x_stored)
                rec["raw_vs_stored_same_mesh"] = norm_rel(got, got_of["stored", entries])
                x_sh = refine(op64, b64, lambda r: solve_factored_sharded(f, r), target=1e-10)
                x_1 = refine(op64, b64, single, target=1e-10)
                rec["refined_rel_err"] = norm_rel(x_sh.x, x_1.x)
                rec["refined_residuals"] = [x_sh.relative_residual, x_1.relative_residual]
                ok = ok and rec["raw_vs_stored_same_mesh"] <= 1e-5 and rec["refined_rel_err"] <= 1e-6
            else:
                ok = ok and rec["raw_rel_err"] <= 1e-6
            out[f"{mode}_{entries}"] = rec
            if not ok:
                raise AssertionError(f"sharded {mode} on {entries} entries vs single device: {rec}")
            del f, single
        torch.cuda.empty_cache()
    # the compressed factor one sublattice a call (bench.py's stacked_solve=False)
    # against the batched one, beside the dense store's own spread
    batching["compressed_loop_vs_stacked"] = norm_rel(ref_of["compressed", 4],
                                                      ref_of["compressed", 2])
    batching["compressed_loop_vs_stored_loop"] = norm_rel(ref_of["compressed", 4], x_stored_loop)
    out["batching"] = batching
    if not (batching["compressed_loop_vs_stacked"] <= batching["stored_loop_vs_stacked"] + 1e-5
            and batching["compressed_loop_vs_stored_loop"] <= 1e-5
            and max(batching["stored_stacked_vs_c128"], batching["stored_loop_vs_c128"]) <= 1e-3):
        raise AssertionError(f"sharded direct, batching: {batching}")
    print("   " + ", ".join(
        f"{k} {v['raw_rel_err']:.3e}{' (bit for bit)' if v['bit_for_bit'] else ''}"
        + (f" (same mesh's stored {v['raw_vs_stored_same_mesh']:.3e}, refined "
           f"{v['refined_rel_err']:.3e})" if "refined_rel_err" in v else "")
        + f" [c128 {v['raw_vs_c128']:.3e}]"
        for k, v in out.items() if k != "batching"))
    done(t0, "one sublattice a call vs batched: " + ", ".join(
        f"{k} {v:.3e}" for k, v in batching.items()))
    return out


def bench_phase() -> dict:
    """Phase 37: the port's bench through its CLI, three rows in child
    processes. Returns the numbers of the ``{"bench": ...}`` line."""
    rows_asked = "fdfd512,fdfd512iter,fdtd2048"
    t0 = phase(f"37. CLI: fdtd2d_tpu_torch.cli bench --only {rows_asked} (a child "
               "process a row)")
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "fdtd2d_tpu_torch.cli", "bench", "--only", rows_asked]
    t_start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t_start
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    if [row.get("metric") for row in rows] != ["fdfd_512sq_solve", "fdfd_512sq_iterative_solve",
                                               "fdtd_yee_updates_2048x2048"]:
        raise AssertionError(f"bench printed {proc.stdout!r}")
    if rows[-1]["backend"] != "ttiled" or not all(row.get("card") for row in rows):
        raise AssertionError(f"bench's rows: {rows}")
    # phase 14 ran the same FDM-FGMRES solve in this process
    _, phase14_s, phase14_its = KEPT["fdfd512iter"]
    if rows[1]["iterations"] != phase14_its:
        raise AssertionError(f"fdfd512iter: the bench's {rows[1]['iterations']} iterations, "
                             f"phase 14's {phase14_its}")
    for row in rows:
        print("   " + json.dumps(row))
    done(t0, f"{seconds:.1f} s for three rows, three child processes; fdfd512iter "
             f"{rows[1]['value']} s and {rows[1]['iterations']} iterations (phase 14: "
             f"{phase14_s:.3f} s, {phase14_its})")
    return {"rows": rows, "seconds": seconds,
            "phase14_fdfd512iter": {"seconds": phase14_s, "iterations": phase14_its}}


# -- phases 31-36: the multi-device legs, every mesh entry on the one card ------------------

# The script's end that phases 31-36 plan for: a gated part runs in full where
# the time so far, its estimate and what the later phases take (``reserve_s``)
# stay under it, else it is cut and the cut printed (direct2048stored, after
# them, has its own gate at 1080 s). On an H100 at 700 W phases 1-30 take
# about 680 s, phase 37 (run before 31) some 50 s more, and 31-36 about 200 s
# at their least: 900 keeps the script near 930 s of its 1200 s limit.
MULTIDEVICE_END_S = 900.0
# refinement rounds of the time-domain solve to 1e-6 (10-11 at 256^2-2048^2 on
# an H100)
TD_ROUNDS = 12


def left_s(t_script: float, reserve_s: float) -> float:
    """Seconds a gated part may take before MULTIDEVICE_END_S, the later
    phases' ``reserve_s`` kept back."""
    return MULTIDEVICE_END_S - reserve_s - (time.perf_counter() - t_script)


def profiled_launches(fn, dev, profile_fdfd, name: str) -> int:
    """Kernel launches of ``fn()`` under torch.profiler (its Chrome trace is
    written under build/ and removed)."""
    trace = ROOT / "build" / f"{name}.json"
    trace.parent.mkdir(exist_ok=True)
    with torch.profiler.profile(activities=profile_fdfd.ACTIVITIES) as prof:
        _, secs = timed(fn, dev)
    prof.export_chrome_trace(str(trace))
    summary = profile_fdfd.window_summary(trace, secs)
    trace.unlink()
    return summary["launches"]


def sharded_fdfd_phase(dev, profile_fdfd, t_script: float, reserve_s: float) -> dict:
    """Phase 31: the block matvec on (4,) and (2, 2) meshes of the card at
    512^2 against op.apply (complex128 <= 1e-13; complex64 printed), then
    solve_fdfd_sharded at fdfd512iter's configuration on (2, 2) beside the
    single-device solve."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator
    from fdtd2d_tpu_torch.parallel import make_mesh, shard_operator, sharded, solve_fdfd_sharded

    t0 = phase("31. sharded FDFD: the block matvec on (4,) and (2, 2) meshes of cuda:0 at 512^2; "
               "solve_fdfd_sharded at fdfd512iter's configuration on (2, 2)")
    N, omega, dx = 512, 17e9, 1e-3
    eps, mu, src = fdfd512_scene(N, omega, constants)
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    out = {"matvec_rel_err": {}}
    for dtype in (torch.complex128, torch.complex64):
        op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40, dtype=dtype, device=dev)
        x = torch.tensor(xh, dtype=dtype, device=dev)
        want = op.apply(x)
        for shape in ((4,), (2, 2)):
            sop = shard_operator(op, make_mesh(shape, devices=[dev] * 4))
            err = complex_rel_err(sop.layout.gather(sop.apply(sop.layout.scatter(x))), want)
            out["matvec_rel_err"][f"{shape} {str(dtype)[6:]}"] = err
            if dtype == torch.complex128 and not err <= 1e-13:
                raise AssertionError(f"sharded matvec on {shape} in complex128: {err:.3e}")
    print("   matvec vs op.apply: " + ", ".join(f"{k} {v:.3e}"
                                               for k, v in out["matvec_rel_err"].items()))
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40, device=dev)
    M, _ = resolve_preconditioner(op, "fdm")
    b = torch.tensor(src, dtype=torch.complex64, device=dev)
    mesh = make_mesh((2, 2), devices=[dev] * 4)
    kw = dict(preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
    cycle = {**kw, "maxiter": 20}
    solve_fdfd_sharded(op, b, mesh, **cycle)   # warm-up: one restart cycle
    _, cycle_s = timed(lambda: solve_fdfd_sharded(op, b, mesh, **cycle), dev)
    launches = {"single": profiled_launches(lambda: solve_fdfd(op, b, **cycle), dev,
                                            profile_fdfd, "fgmres_cycle") / 20,
                "sharded": profiled_launches(lambda: solve_fdfd_sharded(op, b, mesh, **cycle),
                                             dev, profile_fdfd, "fgmres_cycle_sharded") / 20}
    # the single device's warm fdfd512iter solve is phase 14's
    single_x, single_s, single_its = KEPT.pop("fdfd512iter")
    estimate, left = cycle_s * kw["maxiter"] / 20, left_s(t_script, reserve_s)
    if estimate > left:
        kw["maxiter"] = 20 * max(int(left / cycle_s), 5)
        print(f"   cut: the sharded solve would take about {estimate:.0f} s, {left:.0f} s are "
              f"left; maxiter 3000 -> {kw['maxiter']} (the iterate is then held to the true "
              f"residual only)")
    sharded.fdm_gathers = sharded.fdm_gather_bytes = sharded.strip_copies = 0
    got, sharded_s = timed(lambda: solve_fdfd_sharded(op, b, mesh, **kw), dev)
    op128 = make_operator(eps, mu, dx, dx, omega, pml_thickness=40, dtype=torch.complex128,
                          device=dev)
    b128 = b.to(torch.complex128)
    true_res = float(torch.linalg.vector_norm(op128.residual(b128, got.x.to(torch.complex128)))
                     / torch.linalg.vector_norm(b128))
    diff = complex_rel_err(got.x, single_x)
    full = kw["maxiter"] == 3000
    out["solve"] = {
        "mesh": [2, 2], "maxiter": kw["maxiter"], "restart": 20, "tol": 1e-6,
        "sharded_s": sharded_s, "single_device_s_phase_14": single_s,
        "iterations": got.iterations, "single_iterations": single_its,
        "true_c128_residual": true_res, "rel_err_to_single_device": diff,
        "launches_per_iteration": launches, "fdm_gathers": sharded.fdm_gathers,
        "fdm_gather_bytes": sharded.fdm_gather_bytes,
        "strip_copies_per_iteration": sharded.strip_copies / max(got.iterations, 1)}
    if not ((true_res < 1e-4 and diff <= 1e-4) if full else bool(torch.isfinite(got.x).all())):
        raise AssertionError(f"solve_fdfd_sharded at fdfd512iter: {out['solve']}")
    done(t0, f"matvec c128 <= 1e-13; fdfd512iter on (2, 2): {sharded_s:.2f} s (single device "
             f"{single_s:.2f} s, phase 14), {got.iterations} iterations, true residual "
             f"{true_res:.2e}, {diff:.2e} from the single device; launches an iteration "
             f"{launches['sharded']:.0f} (single {launches['single']:.0f}); "
             f"{sharded.fdm_gathers} FDM gathers, {sharded.fdm_gather_bytes / 1e9:.2f} GB")
    return out


def sharded_tiled_phase(dev, profile_fdfd) -> dict:
    """Phase 32: run_fdfd_tiled_sharded at tiled1024 on 4 x cuda:0 against
    the single-device two-level solve with the patch level forced on, and
    that solver's coarse level alone (its probe's choice)."""
    from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver
    from fdtd2d_tpu_torch.parallel import make_mesh, tiled_sharded
    from fdtd2d_tpu_torch.parallel.tiled_sharded import run_fdfd_tiled_sharded

    t0 = phase("32. run_fdfd_tiled_sharded at tiled1024 on 4 x cuda:0 (the patch level at full "
               "size) vs the single-device two-level solve, patches forced on")
    N, omega, dx = 1024, 17e9, 1e-3
    eps, mu, src = profile_fdfd.block_scene(N)
    geo = dict(patch_size=100, padding=30, pml_thickness=10, global_pml_thickness=40,
               inner_iters=8)
    kw = dict(solver_tol=1e-4, solver_maxiter=300, refine_target=1e-6)
    mesh = make_mesh((4,), axis_names=("p",), devices=[dev] * 4)
    torch.cuda.reset_peak_memory_stats(dev)
    tiled_sharded.applications = 0
    # warm: phase 21's tiled1024 built the same FDM factors (cached on the host)
    (x, trace), warm_s = timed(lambda: run_fdfd_tiled_sharded(eps, mu, dx, dx, omega, src, mesh,
                                                              **geo, **kw), dev)
    peak = peak_gb(dev)
    solver = TiledSolver(eps, mu, dx, dx, omega, outer_restart=30, device=dev, **geo)
    (want, wtrace), forced_s = timed(lambda: solver.solve(src, adaptive=False, **kw), dev)
    forced_its = list(solver.outer_iterations)
    (_, ctrace), coarse_s = timed(lambda: solver.solve(src, adaptive=True, **kw), dev)
    diff = complex_rel_err(x, want)
    out = {"geometry": geo, **kw, "patches": len(solver.origins), "mesh": [4],
           "warm_s": warm_s, "trace": trace, "rounds": len(trace) - 2,
           "outer_iterations": tiled_sharded.applications, "peak_gb": peak,
           "rel_err_to_single_device": diff,
           "single_device_patches_forced": {"seconds": forced_s, "trace": wtrace,
                                            "outer_iterations": forced_its},
           "single_device_probe": {"decision": "two-level" if solver._patch_decision
                                   else "coarse-only", "contractions": solver._patch_probe,
                                   "seconds": coarse_s, "trace": ctrace,
                                   "outer_iterations": list(solver.outer_iterations)}}
    out["patch_level_beats_coarse"] = forced_s < coarse_s
    if not (trace[-2] < 1e-5 and diff <= 1e-4 and bool(torch.isfinite(x).all())):
        raise AssertionError(f"sharded tiled1024: {out}")
    del solver, x, want
    torch.cuda.empty_cache()
    done(t0, f"warm {warm_s:.2f} s, {len(trace) - 2} rounds, "
             f"{tiled_sharded.applications} outer iterations, peak {peak:.2f} GB, trace "
             f"{[f'{t:.2e}' for t in trace]}, {diff:.2e} from the single device; single device "
             f"with patches {forced_s:.2f} s {forced_its}, coarse level alone {coarse_s:.2f} s "
             f"({out['single_device_probe']['decision']}): the patch level "
             f"{'beats' if out['patch_level_beats_coarse'] else 'does not beat'} it")
    return out


def sharded_timedomain_phase(dev, profile_fdfd, t_script: float, reserve_s: float) -> dict:
    """Phase 33: TimeDomainSolverSharded on (4, 2) meshes of the card: a 96^2
    application against the CPU's single-device one (<= 1e-4); one 2048^2
    application (cut to 300 steps) against the card's single-device one
    (<= 1e-5) with ms a wave step of each; a solve to 1e-6 at the largest
    of 2048^2, 1024^2, 512^2 and 256^2 that the time estimate admits."""
    from fdtd2d_tpu_torch.fdfd.timedomain import TimeDomainSolver
    from fdtd2d_tpu_torch.parallel import make_mesh, timedomain_sharded
    from fdtd2d_tpu_torch.parallel.timedomain_sharded import TimeDomainSolverSharded

    t0 = phase("33. TimeDomainSolverSharded on (4, 2) meshes of cuda:0: 96^2 vs the CPU, one "
               "2048^2 application vs the single device, a solve to 1e-6")
    omega, dx, out = 17e9, 1e-3, {}
    mesh = make_mesh((4, 2), axis_names=("sub", "c"), devices=[dev] * 8)
    axes = dict(sub_axis="sub", col_axis="c")
    # at 96^2 a column block holds 24 sublattice columns: PML 16 (strips of 8)
    eps, mu, src = profile_fdfd.block_scene(96)
    b = torch.tensor(-1j * omega * src, dtype=torch.complex64)
    b = b / torch.linalg.vector_norm(b)
    card = TimeDomainSolverSharded(eps, mu, dx, dx, omega, mesh, pml_thickness=16, device=dev,
                                   **axes).precondition(b.to(dev))
    cpu = TimeDomainSolver(eps, mu, dx, dx, omega, pml_thickness=16, device="cpu").precondition(b)
    out["rel_err_96_vs_cpu"] = complex_rel_err(card.cpu(), cpu)
    if not out["rel_err_96_vs_cpu"] <= 1e-4:
        raise AssertionError(f"sharded wave run 96^2 vs the CPU: {out['rel_err_96_vs_cpu']:.3e}")

    # one application at 2048^2, cut to APPLY_STEPS steps (a settled solve's
    # applications are 4284 steps: the time estimate scales them)
    N, APPLY_STEPS = 2048, 300
    eps, mu, src = profile_fdfd.block_scene(N)
    cut = dict(transits=2.5, steps_override=APPLY_STEPS, device=dev)
    single = TimeDomainSolver(eps, mu, dx, dx, omega, **cut)
    shd = TimeDomainSolverSharded(eps, mu, dx, dx, omega, mesh, **cut, **axes)
    unit = torch.tensor(src, dtype=torch.complex64, device=dev)
    single.precondition(unit)   # warm-up: both at 2048^2
    shd.precondition(unit)
    want, single_s = timed(lambda: single.precondition(unit), dev)
    timedomain_sharded.strip_copies = 0
    got, sharded_s = timed(lambda: shd.precondition(unit), dev)
    steps = single.steps_per_apply
    ms_step = sharded_s / steps * 1e3
    out["application_2048"] = {
        "steps": steps, "rel_err_to_single_device": complex_rel_err(got, want),
        "equal": bool(torch.equal(got, want)), "sharded_s": sharded_s, "single_device_s": single_s,
        "sharded_ms_per_step": ms_step, "single_device_ms_per_step": single_s / steps * 1e3,
        "strip_copies_per_step": timedomain_sharded.strip_copies / steps}
    if not out["application_2048"]["rel_err_to_single_device"] <= 1e-5:
        raise AssertionError(f"sharded application at 2048^2: {out['application_2048']}")
    del single, shd, got, want
    torch.cuda.empty_cache()
    print(f"   one application at 2048^2 ({steps} steps): sharded {ms_step:.3f} ms a step, single "
          f"device {single_s / steps * 1e3:.3f} ms a step; equal: "
          f"{out['application_2048']['equal']}")

    # the solve: the 8 blocks' step is launch bound (about the same ms at every
    # size), so a solve takes about TD_ROUNDS x its steps an application x
    # ms_step; the largest size whose estimate fits what is left is solved,
    # 256^2 at least (the least whose two column blocks hold the strips of
    # the PML of 40)
    left = left_s(t_script, reserve_s)
    size = shd = estimate = None
    for n in (256, 512, 1024, 2048):
        eps, mu, src_n = profile_fdfd.block_scene(n)
        cand = TimeDomainSolverSharded(eps, mu, dx, dx, omega, mesh, transits=2.5, device=dev,
                                       **axes)
        est = TD_ROUNDS * cand.steps_per_apply * ms_step / 1e3
        if shd is not None and est > left:
            break
        size, shd, estimate, src = n, cand, est, src_n
    if size != N:
        print(f"   cut: {left:.0f} s left; solving at {size}^2 (about {estimate:.0f} s), not "
              f"{N}^2")
    torch.cuda.reset_peak_memory_stats(dev)
    (x, trace), solve_s = timed(lambda: shd.solve(src, refine_target=1e-6), dev)
    out["solve"] = {"size": size, "cut_from": N if size != N else None, "seconds": solve_s,
                    "estimate_s": estimate, "trace": trace, "rounds": len(trace) - 2,
                    "steps_per_apply": shd.steps_per_apply, "peak_gb": peak_gb(dev)}
    if not (trace[-2] < 1e-6 and bool(torch.isfinite(x).all())):
        raise AssertionError(f"sharded timedomain{size} did not converge: {trace}")
    del shd, x
    torch.cuda.empty_cache()
    done(t0, f"96^2 vs CPU {out['rel_err_96_vs_cpu']:.3e}; timedomain{size} on (4, 2): "
             f"{solve_s:.2f} s, {len(trace) - 2} rounds of {out['solve']['steps_per_apply']} "
             f"steps, trace {[f'{t:.2e}' for t in trace]}")
    return out


def dp_train_phase(dev) -> dict:
    """Phase 34: the data-parallel train step at full width (UNet2D() at
    256^2, global batch 8, the reference recipe, TF32 convolutions) on 2
    gloo ranks of cuda:0, 3 steps, against the single-device train_step on
    the same batch and draws; 2 nccl ranks on 2 cards where there are."""
    from fdtd2d_tpu_torch.parallel import train_dp

    t0 = phase("34. train_step_dp at full width: UNet2D() at 256^2, global batch 8, 2 gloo ranks "
               "on cuda:0, 3 steps, vs the single-device train_step")
    spec = dict(model={}, dtype=torch.float32, seed=0, steps=3,
                batch=train_dp.random_batch(8, 256), recipe={}, devices=[str(dev)] * 2)
    lr = 3e-5
    out = {}
    pairs = [("gloo, one card", [str(dev)] * 2)]
    if torch.cuda.device_count() > 1:
        pairs.append(("nccl, two cards", ["cuda:0", "cuda:1"]))
    ref = train_dp.reference_steps(spec, dev)
    for name, devices in pairs:
        work = ROOT / "build" / f"ranks_{devices[-1].replace(':', '')}"
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        ranks = train_dp.train_ranks([{**spec, "devices": devices}], str(work), timeout=300)[0]
        shutil.rmtree(work)
        # phase 25's TF32 bounds (card against CPU): the loss 1e-3 relative,
        # the BatchNorm statistics 1e-2 relative, each parameter tensor within
        # 1e-5 of its largest entry plus 2 lr a step
        loss_err = max(abs(a - c) / abs(c) for r in ranks for a, c in zip(r["losses"],
                                                                          ref["losses"]))
        stat_err = max(float((r["params"][k] - v).abs().max() / v.abs().max())
                       for r in ranks for k, v in ref["params"].items() if "running" in k)
        param_ok = all(float((r["params"][k] - v).abs().max())
                       <= 1e-5 * float(v.abs().max()) + 2 * lr * spec["steps"]
                       for r in ranks for k, v in ref["params"].items()
                       if "running" not in k and v.is_floating_point())
        same = train_dp.max_param_diff(ranks[0]["params"], ranks[1]["params"])
        out[name] = {"devices": devices, "backend": train_dp.backend_for(devices),
                     "losses": [r["losses"] for r in ranks], "loss_rel_err": loss_err,
                     "batch_stats_rel_err": stat_err, "params_within_bound": param_ok,
                     "rank_param_diff": same,
                     "ms_per_step": [[s * 1e3 for s in r["seconds"]] for r in ranks]}
        if not (loss_err <= 1e-3 and stat_err <= 1e-2 and param_ok and same == 0.0):
            raise AssertionError(f"train_step_dp ({name}): {out[name]}")
        print(f"   {name}: losses {ranks[0]['losses']}, {loss_err:.2e} from the single device, "
              f"statistics {stat_err:.2e}; ms a step (last) "
              f"{[round(r['seconds'][-1] * 1e3, 2) for r in ranks]}")
    out["single_device"] = {"losses": ref["losses"],
                            "ms_per_step": [s * 1e3 for s in ref["seconds"]]}
    done(t0, f"single device {ref['seconds'][-1] * 1e3:.2f} ms a step (last of 3); the ranks "
             f"share one card: no scaling")
    return out


def batched_and_methods_phase(dev) -> dict:
    """Phase 35: simulate_batched (B = 8 at 1024^2, 200 steps, per-scene
    sources) against per-scene simulate(backend='torch'); solve_fdfd with
    bicgstab and gmres at 512^2 with FDM, in complex128."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate, simulate_batched
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    t0 = phase("35. simulate_batched (8 scenes at 1024^2, 200 steps) vs per-scene simulate; "
               "solve_fdfd bicgstab and gmres at 512^2 with FDM")
    N, B = 1024, 8
    rng = np.random.default_rng(5)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((B, N, N)))
    mu = np.full((B, N, N), constants.MU_0)
    sources = [(int(x), int(y)) for x, y in rng.integers(100, N - 100, (B, 2))]
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=sources[0], source_fc=FC,
                     backend="torch", device=str(dev))
    (Ez, Hx, Hy), batched_s = timed(lambda: simulate_batched(eps, mu, cfg, sources)[0], dev)
    worst, equal, per_s = 0.0, True, 0.0
    for k in range(B):
        (e, hx, hy), secs = timed(lambda: simulate(
            eps[k], mu[k], dataclasses.replace(cfg, source_xy=sources[k]))[0], dev)
        per_s += secs
        for a, c in ((Ez[k], e), (Hx[k], hx), (Hy[k], hy)):
            worst = max(worst, rel_err(a, c))
            equal &= bool(torch.equal(a, c))
    out = {"simulate_batched": {"scenes": B, "size": N, "steps": 200, "rel_err": worst,
                                "bit_for_bit": equal, "batched_s": batched_s,
                                "per_scene_total_s": per_s}}
    if not worst <= 1e-6:
        raise AssertionError(f"simulate_batched vs per-scene simulate: {worst:.3e}")
    del Ez, Hx, Hy
    print(f"   simulate_batched: {worst:.3e} from per-scene simulate (bit for bit: {equal}); "
          f"{batched_s:.3f} s batched, {per_s:.3f} s scene by scene")

    M512, omega, dx = 512, 17e9, 1e-3
    e5, m5, s5 = fdfd512_scene(M512, omega, constants)
    # complex128: in complex64 FDM-BiCGSTAB does not settle on this scene
    # (nor does the JAX package's: its residual wanders in both)
    op = make_operator(e5, m5, dx, dx, omega, pml_thickness=40, dtype=torch.complex128,
                       device=dev)
    M, _ = resolve_preconditioner(op, "fdm")
    b = torch.tensor(s5, dtype=torch.complex128, device=dev)
    # GMRES stops when ||M (b - A x)|| <= tol ||b||, as JAX's does: with the FDM
    # inverse shrinking norms by ||M b|| / ||b||, tol 1e-6 stops it at x0, so it
    # runs at tol 1e-6 times that ratio (the preconditioned residual down 1e6)
    ratio = float(torch.linalg.vector_norm(M(b)) / torch.linalg.vector_norm(b))
    at_default = solve_fdfd(op, b, method="gmres", preconditioner=M, tol=1e-6, maxiter=2)
    out["gmres_at_tol_1e-6"] = {"iterations": at_default.iterations,
                                "relative_residual": at_default.relative_residual}
    for method, tol, maxiter in (("bicgstab", 1e-6, 2000), ("gmres", 1e-6 * ratio, 50)):
        res, secs = timed(lambda: solve_fdfd(op, b, method=method, preconditioner=M, tol=tol,
                                             maxiter=maxiter, restart=20), dev)
        true_res = float(torch.linalg.vector_norm(op.residual(b, res.x))
                         / torch.linalg.vector_norm(b))
        out[method] = {"dtype": "complex128", "tol": tol, "maxiter": maxiter, "seconds": secs,
                       "iterations": res.iterations, "relative_residual": res.relative_residual,
                       "true_c128_residual": true_res}
        if not (true_res < 1e-5 and bool(torch.isfinite(res.x).all())):
            raise AssertionError(f"solve_fdfd({method}) at 512^2: {out[method]}")
        print(f"   {method} (tol {tol:.1e}): {secs:.3f} s, {res.iterations} iterations, "
              f"true residual {true_res:.2e}")
    out["fdm_norm_ratio"] = ratio
    done(t0, f"gmres at tol 1e-6 stops at x0 ({at_default.iterations} iterations: "
             f"||M b|| / ||b|| = {ratio:.2e}), as JAX's stopping rule does")
    return out


def dryrun_phase() -> dict:
    """Phase 36: parallel/dryrun.py on 8 entries of cuda:0, then on every
    visible card (cycled to 8 entries) where there is more than one."""
    from fdtd2d_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = phase("36. dryrun_multichip(['cuda:0'] * 8)")
    work = ROOT / "build" / "dryrun"
    work.mkdir(parents=True, exist_ok=True)
    out = {"cuda:0 x 8": dryrun_multichip(["cuda:0"] * 8, workdir=str(work))}
    count = torch.cuda.device_count()
    if count > 1:
        devices = [f"cuda:{i % count}" for i in range(8)]
        out[f"{count} cards"] = dryrun_multichip(devices, workdir=str(work))
    shutil.rmtree(work)
    done(t0, f"{len(out['cuda:0 x 8'])} stages within their bounds; "
             + ("one card: no copy between two cards ran" if count == 1
                else f"{count} cards: strips and gathers crossed cards"))
    return out


def multidevice_phases(dev, profile_fdfd, t_script: float) -> dict:
    """Phases 31-36; returns the numbers of the ``{"multidevice": ...}``
    line."""
    t_start = time.perf_counter()
    out = {"sharded_fdfd": sharded_fdfd_phase(dev, profile_fdfd, t_script, reserve_s=170.0),
           "sharded_tiled": sharded_tiled_phase(dev, profile_fdfd),
           "sharded_timedomain": sharded_timedomain_phase(dev, profile_fdfd, t_script,
                                                          reserve_s=100.0),
           "train_dp": dp_train_phase(dev),
           "batched_and_methods": batched_and_methods_phase(dev),
           "dryrun": dryrun_phase()}
    out["phases_31_36_s"] = time.perf_counter() - t_start
    return out


def examples_phase(dev, t_script: float, budget_s: float = 1140.0,
                   estimate_s: float = 60.0) -> dict:
    """Phase 39: the example workflows through their ``run`` functions on
    the card (see the module's docstring). The drivers print the JAX
    scripts' lines; those are kept out of this script's output."""
    from fdtd2d_tpu_torch.apps import (direct_large, fdtd_video, inverse_design_decade,
                                       rank_study, ring_resonator, tiled_vs_direct)
    from fdtd2d_tpu_torch.apps.inverse_design import lowpass_problem
    from fdtd2d_tpu_torch.fdtd.simulate import simulate
    from fdtd2d_tpu_torch.utils import trace

    t0 = phase("39. the examples on the card: ring and tiled vs direct at 512^2, the FDTD video "
               "at 200^2 (1000 steps, 200 frames) vs the plain rollout, rank study at 256^2, "
               "direct_large at 512^2 in three modes, the decade driver on "
               "lowpass_problem(N=250) for 3 steps")
    elapsed = time.perf_counter() - t_script
    if elapsed + estimate_s > budget_s:
        done(t0, f"cut: {elapsed:.0f} s into the script, its ~{estimate_s:.0f} s would take it "
                 f"past {budget_s:.0f} s")
        return {"cut": True, "elapsed_s": elapsed}
    printed = io.StringIO()
    out, seconds = {}, {}

    def run(name, fn):
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            numbers = fn()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t
        return numbers

    ring = run("ring_resonator", lambda: ring_resonator.run(device=dev))
    x = ring["arrays"]["x"]
    if not (ring["converged"] and ring["relative_residual"] < 1e-4 and np.isfinite(x).all()
            and ring["max_abs_Ez"] > 0):
        raise AssertionError(f"ring_resonator: {ring}")
    tvd = run("tiled_vs_direct", lambda: tiled_vs_direct.run(device=dev))
    if not (tvd["direct_converged"] and tvd["tiled_iterate_residual"] <= 1e-8
            and tvd["field_error"] < 1e-3):
        raise AssertionError(f"tiled_vs_direct: {tvd}")

    before = trace.counters()
    video = run("fdtd_video", lambda: fdtd_video.run(device=dev))
    nframes = video["nframes"]
    k1, k1_resident, k2 = launches_since(before, "k1", "k1_resident", "k2_sweeps")
    if (video["backend"], video["k1_resident_launches"], k1, k1_resident, k2) != (
            "fused", nframes, 2 * nframes, 2 * nframes, 0):
        raise AssertionError(f"fdtd_video: auto -> {video['backend']}, {k1} K1 launches "
                             f"({k1_resident} resident), {k2} K2; expected K1 resident, one "
                             f"launch a frame of each of the two rollouts")
    eps, mu = fdtd_video.box_scene()
    plain_cfg = dataclasses.replace(fdtd_video.config(device="cuda"), backend="torch",
                                    dtype=torch.float64)
    _, plain = simulate(eps, mu, plain_cfg)
    video_err = rel_err(torch.as_tensor(video["arrays"]["frames"], device=dev), plain)
    if not video_err <= TOL:
        raise AssertionError(f"fdtd_video: frames {video_err:.3e} from the float64 plain "
                             f"rollout (bound {TOL})")
    del plain

    ranks = run("rank_study", lambda: rank_study.run(N=256, device=dev))
    table = ranks["arrays"]["ranks"]
    nb = np.array([ranks["nc"] >> lev for lev in rank_study.LEVELS])[None, :, None, None]
    errs = list(ranks["global_rank_errors"].values())
    if not ((table >= 1).all() and (table <= nb).all()
            and all(0.0 < e <= 1.0 for e in errs[:2])):
        raise AssertionError(f"rank_study at 256^2: ranks {table.tolist()}, errors {errs}")

    direct = {}
    for mode in direct_large.MODES:
        d = run(f"direct_large_{mode}", lambda: direct_large.run(N=512, stride=64, mode=mode,
                                                                 device=dev))
        if not (d["iterate_residual"] <= 1e-8 and d["sweep_worst_residual"] <= 1e-8
                and np.isfinite(d["arrays"]["x"]).all()):
            raise AssertionError(f"direct_large {mode} at 512^2: trace {d['trace']}, sweep "
                                 f"{d['sweep_trace']}")
        direct[mode] = {k: v for k, v in d.items() if k != "arrays"}
        torch.cuda.empty_cache()

    decade = run("inverse_design_decade", lambda: inverse_design_decade.run(
        lowpass_problem(N=250, device=dev), steps=3, device=dev))
    resp = np.array([decade["response"], decade["response_binary"]])
    if not (decade["steps_done"] == 3 and np.isfinite(decade["history"]).all()
            and np.isfinite(resp).all() and (resp > 0).all()):
        raise AssertionError(f"inverse_design_decade on lowpass_problem(N=250): {decade}")

    for numbers in (ring, tvd, video, ranks, decade):
        numbers.pop("arrays")
    out = {"ring_resonator": ring, "tiled_vs_direct": tvd,
           "fdtd_video": {**video, "rel_err_vs_plain_float64": video_err},
           "rank_study_256": ranks, "direct_large_512": direct,
           "inverse_design_lowpass250": decade, "seconds": seconds,
           "phase_s": time.perf_counter() - t0}
    done(t0, f"ring residual {ring['relative_residual']:.2e} ({ring['iterations']} iterations); "
             f"tiled iterate {tvd['tiled_iterate_residual']:.2e}, field error "
             f"{tvd['field_error']:.2e}; video on K1 resident, {video['rollout_ms']:.2f} ms, "
             f"{video_err:.2e} from float64; direct_large 512^2 warm s " +
             ", ".join(f"{m} {v['warm_s']:.3f}" for m, v in direct.items()) +
             f"; decade driver {decade['s_per_step_median_warm']:.3f} s a warm step; " +
             ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return out


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    t_script = time.perf_counter()
    t0 = phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import fdtd2d_tpu_torch
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.core.grid import grid_init
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, resolve_backend, simulate
    from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, precompute_coefficients
    from fdtd2d_tpu_torch.ops import _build, fdtd_blocked, fdtd_fused, fdtd_ttiled
    from fdtd2d_tpu_torch import cli
    from fdtd2d_tpu_torch.utils import trace
    from fdtd2d_tpu_torch.utils.metrics import Timer, device_info, throughput_gcells

    def tool(name):
        spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    bench_fused = tool("bench_fused")      # phase 9 times K1's modes with its time_modes
    bench_sharded = tool("bench_sharded")  # phases 17 and 18 are its block_parity, full_size
    pkg_root = Path(fdtd2d_tpu_torch.__file__).resolve().parents[1]
    if pkg_root != ROOT:
        raise RuntimeError(f"fdtd2d_tpu_torch was imported from {pkg_root}, "
                           f"not from this checkout ({ROOT})")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    info = device_info()
    kind = torch.cuda.get_device_name(0)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    print("   " + subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True,
                                 check=True).stdout.strip().replace("\n", "\n   "))
    done(t0)

    # -- 2. build -------------------------------------------------------------
    t0 = phase("2. build K1 and K2 with nvcc")
    with Timer() as build_timer:
        lib_path = _build.build()
        _build.load()
    log = (lib_path.parent / "build.log")
    if not log.exists():
        raise AssertionError(f"no ptxas report beside the library: {log} is missing")
    kernel_name, ttiled_smem, ttiled_spills, resident_registers = "?", None, 0, []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            kernel_name = next((k for k in ("h_update", "e_update", "resident_steps",
                                            "ttiled_sweep", "row_sweep", "residual_sweep",
                                            "residual_norm_sweep", "residual_combine",
                                            "refine_update") if k in line),
                               line.strip())
        elif "registers" in line or "spill" in line:
            print(f"   ptxas {kernel_name}: {line.strip()}")
            if kernel_name == "row_sweep" and "spill" in line and (
                    "0 bytes spill stores, 0 bytes spill loads" not in line):
                raise AssertionError(f"ptxas spills in row_sweep: {line.strip()}")
            if kernel_name not in ("ttiled_sweep", "resident_steps"):
                continue
            if "spill" in line:
                ttiled_spills += kernel_name == "ttiled_sweep"
                if "0 bytes spill stores, 0 bytes spill loads" not in line:
                    raise AssertionError(f"ptxas spills in {kernel_name}: {line.strip()}")
            if "registers" in line:
                if kernel_name == "resident_steps":
                    resident_registers.append(int(re.search(r"Used (\d+) registers", line).group(1)))
                    continue
                m = re.search(r"(\d+) bytes smem", line)
                ttiled_smem = int(m.group(1)) if m else 0
    if ttiled_spills == 0 or ttiled_smem is None:
        raise AssertionError(f"{log} holds no register and spill report of ttiled_sweep")
    planned_registers = sorted(v.registers for v in fdtd_fused.VARIANTS)
    if sorted(resident_registers) != planned_registers:
        raise AssertionError(f"{log} reports resident_steps variants of {resident_registers} "
                             f"registers; the planner's variants hold {planned_registers} "
                             f"(fdtd_fused.VARIANTS)")
    if ttiled_smem != fdtd_ttiled.STATIC_SMEM_BYTES:
        raise AssertionError(f"ptxas reports {ttiled_smem} B of static shared memory in "
                             f"ttiled_sweep; the planner budgets "
                             f"{fdtd_ttiled.STATIC_SMEM_BYTES} B (STATIC_SMEM_BYTES)")
    K, TH, TW = fdtd_ttiled.pick_sweep_depth(4096, 4096)
    smem = fdtd_ttiled.smem_bytes(fdtd_ttiled.window_extent(4096, TH, K),
                                  fdtd_ttiled.window_extent(4096, TW, K))
    print(f"   ttiled_sweep at 4096^2 (K={K}, {TH}x{TW} tiles): {smem} B of dynamic "
          f"shared memory a block, {fdtd_ttiled.STATIC_SMEM_BYTES} B static "
          f"(one 480-thread block an SM; budget {fdtd_ttiled.SMEM_BUDGET} B dynamic)")
    numbers = fdtd_fused.device_numbers(dev)
    for variant in fdtd_fused.VARIANTS:
        fdtd_fused._check_layout(variant, dev)  # the built kernel is the planner's
    admitted = [n for n in range(fdtd_fused.MIN_SIDE, 2049)
                if bench_fused.resident_plan(n, n, dev) is not None]
    limit = max(admitted)
    print(f"   resident_steps: {len(fdtd_fused.VARIANTS)} variants of {planned_registers} "
          f"registers, no spill; device numbers {numbers}; the largest square the resident "
          f"planner admits is {limit}^2")
    done(t0, f"built {lib_path.relative_to(ROOT)} in {build_timer.seconds:.2f} s")

    # -- 3. kernel vs plain version, edge cases --------------------------------
    t0 = phase("3. K1, streaming and resident, vs plain float64, 203x157")
    rows, cols = 203, 157
    rng = np.random.default_rng(0)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    eps[0, 0] = constants.EPSILON_0
    mu = np.full((rows, cols), constants.MU_0)
    # The float64 plain run takes the kernel's float32 coefficients and
    # state, so that the comparison measures the kernel's arithmetic and not
    # the rounding of its inputs to float32.
    coeffs32 = precompute_coefficients(torch.tensor(eps, device=dev),
                                       torch.tensor(mu, device=dev), DT, DX,
                                       torch.float32)
    coeffs = {torch.float32: coeffs32,
              torch.float64: tuple(c.double() for c in coeffs32)}
    states = {"zero": grid_init(rows, cols, torch.float32, dev),
              "random": tuple(torch.tensor(rng.standard_normal(shape), device=dev,
                                           dtype=torch.float32) / scale
                              for shape, scale in (((rows, cols), 1.0),
                                                   ((rows, cols - 1), Z0),
                                                   ((rows - 1, cols), Z0)))}
    cases = (("zero", 300, 137, ((rows // 2, cols // 2), (7, 9))),
             ("random", 60, 27, ((rows - 8, cols - 10),)))
    # K1's modes: streaming; resident at the planner's tile grid and at two
    # forced ones, 9 x 7 and 16 x 8 tiles (of 22-23 x 22-23 and 12-13 x 19-20
    # cells), whose seams cross every Mur band. A 5 x 5 corner lies in one tile
    # by construction (tiles own at least 6 cells a side).
    k1_modes = (("streaming", None), ("resident", None), ("resident", (9, 7)),
                ("resident", (16, 8)))
    worst, least_cover = 0.0, 1.0
    for start, nsteps, split, sources in cases:
        for (sx, sy), kind_ in ((s, k) for s in sources for k in ("ricker", "sinusoidal")):
            def run(dtype, n, offset, fields, mode=None, tiles=None):
                ce, ch, coef = coeffs[dtype]
                fields = tuple(f.to(dtype) for f in fields)
                args = (*fields, ce, ch, coef, DT, FC, sx, sy, n, kind_, offset)
                if dtype == torch.float64:
                    return fdtd_fused.fdtd_multistep_fused_reference(*args)
                return fdtd_fused.fdtd_multistep_fused(*args, mode=mode, tiles=tiles)

            case = f"{start} state, {nsteps} steps, source {(sx, sy)}, {kind_}"
            plain = run(torch.float64, nsteps, 0, states[start])
            if start == "random":
                cover = boundary_cover(plain[0], MUR_BAND)
                least_cover = min(least_cover, cover)
                if not cover >= COVER:
                    raise AssertionError(f"{case}: a Mur band or corner holds only "
                                         f"{cover:.2e} of max |Ez| (< {COVER})")
            case_worst, first = 0.0, None
            for mode, tiles in k1_modes:
                what = f"{mode}{'' if tiles is None else f' {tiles[0]}x{tiles[1]} tiles'}"
                before = trace.counters()
                single = run(torch.float32, nsteps, 0, states[start], mode, tiles)
                chunked = run(torch.float32, nsteps - split, split,
                              run(torch.float32, split, 0, states[start], mode, tiles),
                              mode, tiles)
                torch.cuda.synchronize()
                counted = launches_since(before, "k1", "k1_resident")
                if counted != ((3, 3) if mode == "resident" else (4 * nsteps, 0)):
                    raise AssertionError(f"{what}: counted {counted} launches ({case})")
                first = first or single
                for name, k, c, f, p in zip(("Ez", "Hx", "Hy"), single, chunked, first, plain):
                    if k.shape != p.shape:
                        raise AssertionError(f"{name}: shape {tuple(k.shape)} != "
                                             f"{tuple(p.shape)}")
                    if not torch.equal(k, c):
                        raise AssertionError(f"{name}: {what} chunked run differs from one "
                                             f"run ({case})")
                    if not torch.equal(k, f):
                        raise AssertionError(f"{name}: {what} differs from streaming ({case})")
                    err = rel_err(k, p)
                    case_worst = max(case_worst, err)
                    if not err <= TOL:
                        raise AssertionError(f"{name}: {what}: relative error {err:.3e} > "
                                             f"{TOL} ({case})")
            worst = max(worst, case_worst)
            print(f"   {case}: ok in {len(k1_modes)} modes and tile grids (resident == "
                  f"streaming, chunked == single), relative error {case_worst:.3e}")
    done(t0, f"worst relative error {worst:.3e} <= {TOL}; chunked == single; "
             f"random state: each band and corner >= {least_cover:.3e} of max |Ez|")

    # -- 4. the slice at full size --------------------------------------------
    t0 = phase("4. simulate on the 2048^2 bench scene: backend 'auto' (K2), then 'fused' "
               "(K1 streaming)")
    N = 2048
    eps, mu = bench_scene(N, constants)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=2000, source_xy=(N // 2, N // 2),
                     source_fc=FC, nframes=10, backend="auto", device="cuda")
    per_frame = cfg.nsteps // cfg.nframes
    backend = resolve_backend(cfg.backend, (N, N), cfg.device, per_frame)
    if backend != "ttiled":
        raise AssertionError(f"backend 'auto' resolved to {backend!r} at 2048^2, not 'ttiled'")
    K2048 = fdtd_ttiled.pick_sweep_depth(N, N)[0]
    before = trace.counters()
    auto_fields, auto_snaps = simulate(eps, mu, cfg)
    torch.cuda.synchronize()
    k2_launches_2048, k1 = launches_since(before, "k2_sweeps", "k1")
    if (k2_launches_2048, k1) != (cfg.nframes * -(-per_frame // K2048), 0):
        raise AssertionError(f"auto at 2048^2: {k2_launches_2048} K2 and {k1} "
                             f"K1 launches, expected {cfg.nframes * -(-per_frame // K2048)} "
                             f"and 0")
    check_fields(auto_fields, auto_snaps, N, cfg.nframes)
    del auto_snaps
    before = trace.counters()
    (Ez, Hx, Hy), snaps = simulate(eps, mu, dataclasses.replace(cfg, backend="fused"))
    torch.cuda.synchronize()
    streaming_launches, k1_resident, k2 = launches_since(before, "k1", "k1_resident",
                                                         "k2_sweeps")
    if (streaming_launches, k1_resident, k2) != (2 * cfg.nsteps, 0, 0):
        raise AssertionError(f"fused at 2048^2: K1 launch counter advanced by "
                             f"{streaming_launches} ({k1_resident} resident), "
                             f"expected {2 * cfg.nsteps} streaming launches")
    check_fields((Ez, Hx, Hy), snaps, N, cfg.nframes)
    k2_equals_k1 = all(torch.equal(a, f) for a, f in zip(auto_fields, (Ez, Hx, Hy)))
    del snaps, auto_fields
    print(f"   auto -> ttiled: {k2_launches_2048} K2 launches; fused: {streaming_launches} K1 "
          f"launches (two a step); K2's fields equal K1's bit for bit: {k2_equals_k1}; "
          f"max |Ez| = {float(Ez.abs().max()):.4e}")

    short = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=(N // 2, N // 2),
                       source_fc=FC, backend="fused", device="cuda")
    plain_cfg = dataclasses.replace(short, backend="torch", dtype=torch.float64)
    kern, _ = simulate(eps, mu, short)
    auto_kern, _ = simulate(eps, mu, dataclasses.replace(short, backend="auto"))
    plain, _ = simulate(eps.astype(np.float64), mu.astype(np.float64), plain_cfg)
    torch.cuda.synchronize()
    errs, streaming_abs_err = against_plain(kern, plain, "2048^2 200-step, K1 streaming")
    against_plain(auto_kern, plain, "2048^2 200-step, auto")
    del auto_kern
    done(t0, "200 steps vs float64 plain: " +
         ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # -- 16. K1's main path: the resident mode -----------------------------------
    t0 = phase(f"16. K1 resident: simulate(backend='auto') at {limit}^2, and the CLI's "
               f"default rollout")
    eps_l, mu_l = bench_scene(limit, constants)
    cfg_l = FDTDConfig(dt=DT, dx=DX, nsteps=2000, source_xy=(limit // 2, limit // 2),
                       source_fc=FC, nframes=10, backend="auto", device="cuda")
    for shape, per_call, want in (((200, 200), 5, "fused"), ((limit, limit), 200, "fused"),
                                  ((2048, 2048), 200, "ttiled"), ((4096, 4096), 256, "ttiled")):
        got = resolve_backend("auto", shape, "cuda", per_call)
        if got != want:
            raise AssertionError(f"backend 'auto' resolved to {got!r} at {shape} with "
                                 f"{per_call} steps a call, not {want!r}")
    before = trace.counters()
    fields_l, snaps_l = simulate(eps_l, mu_l, cfg_l)
    torch.cuda.synchronize()
    main_launches, k1_resident, k2 = launches_since(before, "k1", "k1_resident", "k2_sweeps")
    if (main_launches, k1_resident, k2) != (cfg_l.nframes, cfg_l.nframes, 0):
        raise AssertionError(f"auto at {limit}^2: {main_launches} K1 launches "
                             f"({k1_resident} resident), {k2} K2 launches; expected one "
                             f"resident launch a frame, {cfg_l.nframes}")
    check_fields(fields_l, snaps_l, limit, cfg_l.nframes)
    short_l = dataclasses.replace(cfg_l, nsteps=200, nframes=0)
    kern_l, _ = simulate(eps_l, mu_l, short_l)
    plain_l, _ = simulate(eps_l.astype(np.float64), mu_l.astype(np.float64),
                          dataclasses.replace(short_l, backend="torch", dtype=torch.float64))
    torch.cuda.synchronize()
    errs_l, abs_err = against_plain(kern_l, plain_l, f"{limit}^2 200-step, K1 resident")
    print(f"   {limit}^2 auto -> fused, resident plan "
          f"{bench_fused.resident_plan(limit, limit, dev)}: {main_launches} launches for "
          f"{cfg_l.nsteps} steps in {cfg_l.nframes} frames; 200 steps vs float64: " +
          ", ".join(f"{k} {v:.3e}" for k, v in errs_l.items()))
    del fields_l, snaps_l, kern_l, plain_l

    before = trace.counters()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["fdtd", "--size", "200", "--steps", "1000", "--frames", "200",
                  "--device", "cuda"])
    torch.cuda.synchronize()
    cli_launches, k1_resident, k2 = launches_since(before, "k1", "k1_resident", "k2_sweeps")
    if (cli_launches, k1_resident, k2) != (200, 200, 0):
        raise AssertionError(f"the CLI's default rollout: {cli_launches} K1 launches "
                             f"({k1_resident} resident), {k2} K2; expected 200 resident "
                             f"launches")
    m = re.search(r"^max \|Ez\| = (\S+)$", printed.getvalue(), re.M)
    if m is None or not 0.0 < float(m.group(1)) < float("inf"):
        raise AssertionError(f"the CLI printed no finite non-zero max |Ez|: "
                             f"{printed.getvalue()!r}")
    vac = np.full((200, 200), constants.EPSILON_0, np.float32), np.full(
        (200, 200), constants.MU_0, np.float32)
    cfg_c = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=(100, 100), source_fc=FC,
                       nframes=40, backend="auto", device="cuda")
    kern_c, snaps_c = simulate(*vac, cfg_c)
    plain_c, plain_snaps_c = simulate(*(a.astype(np.float64) for a in vac),
                                      dataclasses.replace(cfg_c, backend="torch",
                                                          dtype=torch.float64))
    torch.cuda.synchronize()
    errs_c, _ = against_plain(kern_c, plain_c, "200^2 200-step in 5-step frames, K1 resident")
    if not rel_err(snaps_c[-1], plain_snaps_c[-1]) <= TOL:
        raise AssertionError("200^2: the last frame differs from the float64 plain path's")
    done(t0, f"CLI fdtd --size 200 --steps 1000 --frames 200: {cli_launches} resident "
             f"launches, {printed.getvalue().strip().splitlines()[-1]}; 200 steps in 5-step "
             f"frames vs float64: " + ", ".join(f"{k} {v:.3e}" for k, v in errs_c.items()))

    # -- 5. time ----------------------------------------------------------------
    t0 = phase("5. GCells/s at 2048^2 (K1 streaming, plain), 1000 steps per run, CUDA events")
    steps = 1000
    # scene already on the card: the timed runs hold no host-to-device copy
    eps_d, mu_d = torch.tensor(eps, device=dev), torch.tensor(mu, device=dev)
    timed = {"torch": [], "fused": []}
    for backend in ("torch", "fused", "fused", "torch"):
        run_cfg = FDTDConfig(dt=DT, dx=DX, nsteps=steps, source_xy=(N // 2, N // 2),
                             source_fc=FC, backend=backend, device="cuda")
        start = (Ez, Hx, Hy)
        timed[backend].append(throughput_gcells(
            N * N, steps, lambda: simulate(eps_d, mu_d, run_cfg, state=start),
            repeats=1, warmup=1))
    kernel_gcells, plain_gcells = max(timed["fused"]), max(timed["torch"])
    done(t0, f"kernel {timed['fused']} GCells/s, plain torch {timed['torch']} GCells/s")

    def step_ms(gcells, n=N):
        return n * n / (gcells * 1e9) * 1e3

    # -- 6. K2 vs its plain versions, edge cases ---------------------------------
    t0 = phase("6. K2 vs the float64 plain step and tile emulation, 203x157 and 400x360")
    # A 400x360 grid at the planner's plan: 15 of its 35 tiles are interior,
    # with full 80 x 96 windows and seams between them, the shape the
    # register body runs at 2048^2 and up; its own seeded medium and state.
    r4, c4 = 400, 360
    rng4 = np.random.default_rng(4)
    eps4 = constants.EPSILON_0 * (1.0 + 3.0 * rng4.random((r4, c4)))
    c32 = precompute_coefficients(torch.tensor(eps4, device=dev),
                                  torch.tensor(np.full((r4, c4), constants.MU_0), device=dev),
                                  DT, DX, torch.float32)
    media = {(rows, cols): coeffs,
             (r4, c4): {torch.float32: c32, torch.float64: tuple(c.double() for c in c32)}}
    states["random400"] = tuple(torch.tensor(rng4.standard_normal(shape), device=dev,
                                             dtype=torch.float32) / scale
                                for shape, scale in (((r4, c4), 1.0), ((r4, c4 - 1), Z0),
                                                     ((r4 - 1, c4), Z0)))

    def tiled_runner(fn, dtype):
        def run(fields, n, offset, src, kind_, K, tile):
            ce, ch, coef = media[tuple(fields[0].shape)][dtype]
            fields = tuple(f.to(dtype) for f in fields)
            return fn(*fields, ce, ch, coef, DT, FC, *src, n, kind_, offset, K=K, tile=tile)
        return run

    def plain_runner(fields, n, offset, src, kind_, K, tile):
        ce, ch, coef = media[tuple(fields[0].shape)][torch.float64]
        return fdtd_fused.fdtd_multistep_fused_reference(
            *(f.double() for f in fields), ce, ch, coef, DT, FC, *src, n, kind_, offset)

    def interior_of(start):
        shape = tuple(states[start][0].shape)
        return lambda K, tile: fdtd_ttiled.interior_tiles(
            *shape, *fdtd_ttiled.resolve_plan(*shape, K, tile))

    emulate = tiled_runner(fdtd_ttiled.fdtd_multistep_ttiled_reference, torch.float64)
    k2_cases = ((7, (7, 10), "zero", 300, 137, ((rows // 2, cols // 2), (15, 21), (3, 4))),
                (7, (7, 10), "random", 60, 27, ((rows - 3, cols - 2),)),
                (3, (13, 16), "random", 62, 29, ((2, 3),)),
                (None, None, "random400", 60, 27, ((r4 // 2, c4 // 2),)))

    def tiled_cases(kernel, cases):
        """tiled_edge_cases over cases on two grids; the worst error, least
        cover and least count of interior tiles of all."""
        results = [tiled_edge_cases(kernel, emulate, plain_runner, states, (case,), MUR_BAND,
                                    interior_of(case[2])) for case in cases]
        return (max(r[0] for r in results), min(r[1] for r in results),
                min(r[2] for r in results if r[2] is not None))

    k2_worst, k2_cover, k2_interior = tiled_cases(
        tiled_runner(fdtd_ttiled.fdtd_multistep_ttiled, torch.float32), k2_cases)
    done(t0, f"worst relative error {k2_worst:.3e} <= {TOL}; chunked == single; "
             f"random state: each band and corner >= {k2_cover:.3e} of max |Ez|; "
             f"interior tiles in every random case (least {k2_interior})")

    # -- 7. K3 mode vs its plain versions, edge cases ----------------------------
    t0 = phase("7. K3 mode (K2 at K = 1) vs the float64 plain step and emulation, "
               "203x157 and 400x360")

    def blocked_runner(fields, n, offset, src, kind_, K, tile):
        ce, ch, coef = media[tuple(fields[0].shape)][torch.float32]
        return fdtd_blocked.fdtd_multistep_blocked(*fields, ce, ch, coef, DT, FC, *src,
                                                   n, kind_, offset, tile=tile)

    k3_cases = tuple((1, tile, start, n, split, srcs)
                     for _, tile, start, n, split, srcs in k2_cases)
    k3_worst, k3_cover, k3_interior = tiled_cases(blocked_runner, k3_cases)
    done(t0, f"worst relative error {k3_worst:.3e} <= {TOL}; chunked == single; "
             f"random state: each band and corner >= {k3_cover:.3e} of max |Ez|; "
             f"interior tiles in every random case (least {k3_interior})")

    # -- 8. the slice at full size: 4096^2 and 8192^2 on K2, K3 at 2048^2 ---------
    t0 = phase("8. simulate(backend='auto') on the 4096^2 bench scene; 8192^2; K3")
    big = {}
    for n_big, nsteps_big, backend_big, nframes_big, parity_steps in (
            (4096, 2048, "auto", 8, 200), (8192, 512, "ttiled", 0, 50)):
        eps_b, mu_b = bench_scene(n_big, constants)
        cfg_b = FDTDConfig(dt=DT, dx=DX, nsteps=nsteps_big, source_xy=(n_big // 2, n_big // 2),
                           source_fc=FC, nframes=nframes_big, backend=backend_big,
                           device="cuda")
        resolved = resolve_backend(cfg_b.backend, (n_big, n_big), cfg_b.device)
        if resolved != "ttiled":
            raise AssertionError(f"backend {backend_big!r} resolved to {resolved!r} "
                                 f"at {n_big}^2, not 'ttiled'")
        K, TH, TW = fdtd_ttiled.pick_sweep_depth(n_big, n_big)
        n_interior = fdtd_ttiled.interior_tiles(n_big, n_big, K, TH, TW)
        if not n_interior > 0:
            raise AssertionError(f"no interior tile at {n_big}^2")
        per_frame = nsteps_big // nframes_big if nframes_big else nsteps_big
        expected = (nsteps_big // per_frame) * -(-per_frame // K)
        before = trace.counters()
        fields_b, snaps_b = simulate(eps_b, mu_b, cfg_b)
        torch.cuda.synchronize()
        (sweeps,) = launches_since(before, "k2_sweeps")
        if sweeps != expected:
            raise AssertionError(f"K2 launch counter advanced by {sweeps} at {n_big}^2, "
                                 f"expected {expected}")
        check_fields(fields_b, snaps_b, n_big, nframes_big)
        del snaps_b
        short_b = dataclasses.replace(cfg_b, nsteps=parity_steps, nframes=0)
        kern_b, _ = simulate(eps_b, mu_b, short_b)
        plain_b, _ = simulate(eps_b.astype(np.float64), mu_b.astype(np.float64),
                              dataclasses.replace(short_b, backend="torch",
                                                  dtype=torch.float64))
        torch.cuda.synchronize()
        errs_b, abs_b = against_plain(kern_b, plain_b, f"{n_big}^2 {parity_steps}-step")
        del kern_b, plain_b
        torch.cuda.empty_cache()
        big[n_big] = {"fields": fields_b, "eps": eps_b, "mu": mu_b, "sweeps": sweeps,
                      "plan": [K, TH, TW], "interior_tiles": n_interior,
                      "tiles": len(fdtd_ttiled.tile_order(n_big, n_big, K, TH, TW)[0]),
                      "rel_err": errs_b, "abs_err": abs_b, "parity_steps": parity_steps}
        print(f"   {n_big}^2 {backend_big} -> ttiled, plan K={K} tiles {TH}x{TW} "
              f"({n_interior} of {big[n_big]['tiles']} interior): "
              f"{sweeps} K2 launches for {nsteps_big} steps; {parity_steps} steps vs "
              f"float64: " + ", ".join(f"{k} {v:.3e}" for k, v in errs_b.items()))
    k2_main_launches = big[4096]["sweeps"]

    before = trace.counters()
    ce2, ch2, coef2 = precompute_coefficients(torch.tensor(eps, device=dev),
                                              torch.tensor(mu, device=dev), DT, DX)
    k3_out = fdtd_blocked.fdtd_multistep_blocked(
        *grid_init(N, N, torch.float32, dev), ce2, ch2, coef2, DT, FC, N // 2, N // 2,
        200, "ricker", 0)
    torch.cuda.synchronize()
    (k3_main_launches,) = launches_since(before, "k3")
    if k3_main_launches != 200:
        raise AssertionError(f"K3 launch counter advanced by {k3_main_launches}, expected 200")
    k3_errs, k3_abs = against_plain(k3_out, plain, "K3 2048^2 200-step")
    k3_plan = fdtd_ttiled.resolve_plan(N, N, 1)
    k3_interior = fdtd_ttiled.interior_tiles(N, N, *k3_plan)
    if not k3_interior > 0:
        raise AssertionError("no interior tile for K3 mode at 2048^2")
    done(t0, f"K3 at 2048^2 (tiles {k3_plan[1]}x{k3_plan[2]}, {k3_interior} interior): "
             f"{k3_main_launches} launches, 200 steps vs float64: " +
             ", ".join(f"{k} {v:.3e}" for k, v in k3_errs.items()))

    # -- 9. time: K2, K1, plain (and K3) ------------------------------------------
    t0 = phase("9. ms a step of K2, K1, K3 mode and plain, CUDA events, in turns")

    def op_runs(n, fields, ce_, ch_, coef_, steps):
        args = (ce_, ch_, coef_, DT, FC, n // 2, n // 2, steps, "ricker", 0)
        return {"plain": lambda: fdtd_fused.fdtd_multistep_fused_reference(*fields, *args),
                "K1": lambda: fdtd_fused.fdtd_multistep_fused(*fields, *args),
                "K2": lambda: fdtd_ttiled.fdtd_multistep_ttiled(*fields, *args),
                "K3": lambda: fdtd_blocked.fdtd_multistep_blocked(*fields, *args)}

    times = {}
    order_small = ("plain", "K1", "K2", "K3", "K3", "K2", "K1", "plain")
    order_big = ("plain", "K1", "K2", "K2", "K1", "plain")
    for n_t, steps_t, order in ((2048, 1000, order_small), (4096, 500, order_big),
                                (8192, 200, order_big)):
        if n_t == 2048:
            fields_t, ce_t, ch_t, coef_t = (Ez, Hx, Hy), ce2, ch2, coef2
        else:
            fields_t = big[n_t]["fields"]
            ce_t, ch_t, coef_t = precompute_coefficients(
                torch.tensor(big[n_t]["eps"], device=dev),
                torch.tensor(big[n_t]["mu"], device=dev), DT, DX)
        timed_t = time_in_turns(order, op_runs(n_t, fields_t, ce_t, ch_t, coef_t, steps_t),
                                n_t * n_t, steps_t)
        best = {name: max(v) for name, v in timed_t.items()}
        times[n_t] = {"steps_per_run": steps_t, "order": list(order), "gcells": timed_t,
                      "ms_per_step": {name: step_ms(g, n_t) for name, g in best.items()}}
        print(f"   {n_t}^2, {steps_t} steps a run: " + "; ".join(
            f"{name} {times[n_t]['ms_per_step'][name]:.5f} ms ({', '.join(f'{g:.3f}' for g in v)}"
            f" GCells/s)" for name, v in timed_t.items()))
        # K2's (and K3's) share of its bounds: the roofline (inputs read and
        # outputs written once, 11 operations a cell a step) and its plan's
        # own HBM traffic
        bounds = {}
        for name, K_t in (("K2", None), ("K3", 1)):
            if name not in timed_t:
                continue
            plan_t = fdtd_ttiled.resolve_plan(n_t, n_t, K_t)
            roof, roof_by = roofline_ms(n_t, steps_t)
            ms_t = times[n_t]["ms_per_step"][name]
            bounds[name] = {"plan": list(plan_t), "bound_ms": roof, "bound_by": roof_by,
                            "share_of_bound": roof / ms_t,
                            "plan_bound_ms": plan_bound_ms(fdtd_ttiled, n_t, *plan_t),
                            "share_of_plan_bound":
                                plan_bound_ms(fdtd_ttiled, n_t, *plan_t) / ms_t}
            print(f"   {n_t}^2 {name} (K={plan_t[0]}, {plan_t[1]}x{plan_t[2]}): "
                  f"{ms_t:.5f} ms a step, {bounds[name]['share_of_bound']:.3f} of its "
                  f"{roof:.5f} ms roofline ({roof_by}), "
                  f"{bounds[name]['share_of_plan_bound']:.3f} of its plan's "
                  f"{bounds[name]['plan_bound_ms']:.5f} ms of HBM traffic")
        times[n_t]["bounds"] = bounds
        del ce_t, ch_t
        torch.cuda.empty_cache()
    # K1's two modes beside K2 over the sizes and call lengths that simulate's
    # "auto" rule was set from (tools/bench_fused.py's method), and the plain
    # step at the resident limit
    sizes5 = sorted({128, 200, 256, 512, 768, 1024, limit, 1536, 2048, 2304})
    modes = {}
    for n_t in sizes5:
        row = bench_fused.time_modes(n_t, (5, 8, 200), 1000, dev,
                                     plain_at=(200,) if n_t == limit else ())
        best = {steps_t: {name: min(v) for name, v in timed_t.items()}
                for steps_t, timed_t in row["ms_per_step"].items()}
        picks = {steps_t: resolve_backend("auto", (n_t, n_t), "cuda", steps_t)
                 for steps_t in best}
        modes[n_t] = {**row, "best_ms_per_step": best, "auto": picks}
        print(f"   {n_t}^2, resident plan {row['resident_plan']}: " + "; ".join(
            f"{steps_t} steps a call: " + ", ".join(f"{name} {ms_t:.5f}"
                                                    for name, ms_t in b.items()) +
            f" ms (auto: {picks[steps_t]})" for steps_t, b in best.items()))
        torch.cuda.empty_cache()
    k1 = {"limit": limit, "ms": modes[limit]["best_ms_per_step"][200]["resident"],
          "plain_ms": modes[limit]["best_ms_per_step"][200]["plain"]}
    k1["bound_ms"], k1["bound_by"] = roofline_ms(limit, 200)
    k1["share_of_bound"] = k1["bound_ms"] / k1["ms"]
    k1["streaming"] = {
        n_t: {"ms": times[n_t]["ms_per_step"]["K1"],
              "bound_ms": roofline_ms(n_t, times[n_t]["steps_per_run"])[0],
              "share_of_bound": roofline_ms(n_t, times[n_t]["steps_per_run"])[0]
              / times[n_t]["ms_per_step"]["K1"],
              "plan_bound_ms": 44 * n_t * n_t / HBM_BYTES_S * 1e3,
              "share_of_plan_bound": 44 * n_t * n_t / HBM_BYTES_S * 1e3
              / times[n_t]["ms_per_step"]["K1"]} for n_t in times}
    print(f"   K1 resident at {limit}^2, 200 steps a call: {k1['ms']:.5f} ms a step, "
          f"{k1['share_of_bound']:.4f} of its {k1['bound_ms']:.6f} ms roofline "
          f"({k1['bound_by']}); plain {k1['plain_ms']:.5f}. K1 streaming: " + "; ".join(
              f"{n_t}^2 {v['ms']:.5f} ms, {v['share_of_bound']:.4f} of the roofline, "
              f"{v['share_of_plan_bound']:.3f} of its plan's {v['plan_bound_ms']:.4f} ms"
              for n_t, v in k1["streaming"].items()))
    done(t0)
    # free the FDTD fields before the FDFD phases read peak device memory
    for d in big.values():
        del d["fields"]
    del fields_t, Ez, Hx, Hy, kern, plain, k3_out, ce2, ch2, coef2, eps_d, mu_d
    torch.cuda.empty_cache()

    # -- 17, 18. K2's block mode and the sharded slice ------------------------------
    t0 = phase("17. K2 block mode vs the float64 plain step, its emulation and single-device "
               "K2: 2x2, 1x4, 4x1, 3x2 and thin blocks on the one card")
    block_parity = bench_sharded.block_parity(dev)
    done(t0, f"{block_parity['cases']} cases, worst relative error " + ", ".join(
        f"{v:.3e} vs the {k}" for k, v in block_parity["worst_rel_err"].items()) +
        f" (<= {TOL}); max abs difference to single-device K2 "
        f"{block_parity['max_abs_diff_to_single_device']:.3e}; each band and corner >= "
        f"{block_parity['least_cover']:.3e} of max |Ez|")
    t0 = phase("18. simulate_sharded(backend='auto') on meshes of cuda:0: 8192^2 on 2x2 and "
               "4x1 blocks, 4096^2 with 8 frames on 4 row blocks")
    sharded_cells = [bench_sharded.full_size(dev, n_s, shape_s, steps_s, frames_s)
                     for n_s, shape_s, steps_s, frames_s in (
                         (8192, (2, 2), 512, 0), (8192, (4, 1), 512, 0), (4096, (4,), 2048, 8))]
    torch.cuda.empty_cache()
    block_main = sharded_cells[0]
    block_plain_ms = bench_sharded.plain_engine_ms(dev, 8192, (2, 2))
    block_bound_ms, block_bound_by = roofline_ms(8192, block_main["nsteps"])
    torch.cuda.empty_cache()
    done(t0, f"the block mode's plain version at 8192^2 on 2x2 blocks: {block_plain_ms:.5f} ms "
             f"a step; all blocks shared one card: no copy between two cards, no scaling")

    fdfd = fdfd_phases(dev)
    profile_fdfd = tool("profile_fdfd")
    invdes = {"adjoint": adjoint_phase(dev), **invdes_phases(dev, profile_fdfd)}
    schwarz = {"tiled": tiled_phase(dev, profile_fdfd),
               "timedomain": timedomain_phase(dev, profile_fdfd, t_script),
               "cli": schwarz_cli_phase()}
    t_surrogate = time.perf_counter()
    surrogate = surrogate_phases(dev, tool("bench_surrogate"))
    surrogate["phases_24_27_38_s"] = time.perf_counter() - t_surrogate
    t_direct = time.perf_counter()
    direct_modes, stored_estimate_s, scene2048 = compressed_phase(dev)
    direct_modes["hps"] = hps_phase(dev)
    direct_modes["hps_sweep"] = hps_sweep_phase(dev)
    direct_modes["sharded_512"] = sharded_direct_phase(dev)
    direct_modes["phases_28_30_s"] = time.perf_counter() - t_direct
    bench_rows = bench_phase()
    multidevice = multidevice_phases(dev, profile_fdfd, t_script)
    direct_modes["direct2048stored"] = stored2048_phase(dev, scene2048, stored_estimate_s,
                                                        t_script)
    examples = examples_phase(dev, t_script)

    print(json.dumps({"kernels": [{
        "name": "fdtd_fused (K1)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_fused.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd.py:42",
        "launches": main_launches, "max_abs_err": abs_err,
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "share_of_bound": k1["share_of_bound"],
        "library_ms": None,
        "ms_unit": f"per leapfrog step at {limit}x{limit}, float32, resident mode, 200 steps "
                   f"a call (one cooperative launch a call); launches: simulate(auto), 2000 "
                   f"steps in 10 frames; no single PyTorch call computes a leapfrog step",
        "cli_200_launches": cli_launches,
        "streaming": {"launches_2048_2000_steps": streaming_launches,
                      "max_abs_err_2048_200_steps": streaming_abs_err,
                      "ms_simulate_2048": step_ms(kernel_gcells),
                      "plain_ms_simulate_2048": step_ms(plain_gcells), **k1["streaming"]},
    }, {
        "name": "fdtd_ttiled (K2)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_ttiled.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd_ttiled.py:70",
        "launches": k2_main_launches, "max_abs_err": big[4096]["abs_err"],
        "ms": times[4096]["ms_per_step"]["K2"], "plain_ms": times[4096]["ms_per_step"]["plain"],
        **roofline_entry(times[4096]["bounds"]["K2"]), "library_ms": None,
        "ms_unit": "per leapfrog step at 4096x4096, float32 (one launch per sweep of K steps)",
    }, {
        "name": "fdtd_blocked (K3, K2 at K=1)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_ttiled.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd_blocked.py:80",
        "launches": k3_main_launches, "max_abs_err": k3_abs,
        "ms": times[2048]["ms_per_step"]["K3"], "plain_ms": times[2048]["ms_per_step"]["plain"],
        **roofline_entry(times[2048]["bounds"]["K3"]), "library_ms": None,
        "ms_unit": "per leapfrog step at 2048x2048, float32 (one launch a step)",
    }, {
        "name": "fdtd_ttiled block mode (K2, sharded mode)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_ttiled.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd_ttiled.py:70",
        "launches": block_main["launches"], "max_abs_err": block_main["max_abs_err_float64"],
        "ms": block_main["sharded_steady_ms_per_step"], "plain_ms": block_plain_ms,
        "plan": block_main["plan"], "bound_ms": block_bound_ms, "bound_by": block_bound_by,
        "share_of_bound": block_bound_ms / block_main["sharded_steady_ms_per_step"],
        "library_ms": None,
        "ms_unit": "per leapfrog step at 8192x8192 on 2x2 blocks of the one card, float32, "
                   "steady state of simulate_sharded(auto) (one launch a block a sweep of K "
                   "steps, a halo exchange of 8 strip copies a sweep); launches: 512 steps; "
                   "plain_ms: the same rollout loop with the plain step on each block's array",
    }]}))
    print(json.dumps({"fdtd2048": {
        "k1_plan_bound_ms": 44 * N * N / HBM_BYTES_S * 1e3,
        "kernel_gcells": timed["fused"], "plain_torch_gcells": timed["torch"],
        "steps_per_run": steps, "order": ["plain", "kernel", "kernel", "plain"],
        "card": info["name"], "power_limit": info["power_limit"],
        "edge_case_worst_rel_err": worst, "edge_case_least_cover": least_cover,
        "rel_err_2048_200": errs,
    }}))
    print(json.dumps({"fused": {
        "card": info["name"], "power_limit": info["power_limit"], "device_numbers": numbers,
        "resident_limit": limit, "k2_launches_auto_2048": k2_launches_2048,
        "k2_equals_k1_2048_2000_steps": k2_equals_k1,
        "rel_err_limit_200": errs_l, "rel_err_200_in_5_step_frames": errs_c,
        "modes": modes,
    }}))
    print(json.dumps({"ttiled": {
        "card": info["name"], "power_limit": info["power_limit"],
        "times": times, "k2_edge_case_worst_rel_err": k2_worst,
        "k3_edge_case_worst_rel_err": k3_worst,
        "edge_case_least_interior_tiles": min(k2_interior, k3_interior),
        "edge_case_least_cover": min(k2_cover, k3_cover),
        "full_size": {n_b: {k: v for k, v in d.items() if k not in ("fields", "eps", "mu")}
                      for n_b, d in big.items()},
        "k3_2048_200": {"rel_err": k3_errs, "abs_err": k3_abs},
    }}))
    print(json.dumps({"sharded": {
        "card": info["name"], "power_limit": info["power_limit"], "cards_used": 1,
        "parity": block_parity, "cells": sharded_cells, "plain_ms_8192_2x2": block_plain_ms,
    }}))
    print(json.dumps({"fdfd": {"card": info["name"], "power_limit": info["power_limit"],
                               **fdfd}}))
    print(json.dumps({"invdes": {"card": info["name"], "power_limit": info["power_limit"],
                                 **invdes}}))
    print(json.dumps({"tiled_timedomain": {"card": info["name"],
                                           "power_limit": info["power_limit"], **schwarz}}))
    print(json.dumps({"surrogate": {"card": info["name"], "power_limit": info["power_limit"],
                                    **surrogate}}))
    print(json.dumps({"direct_modes": {"card": info["name"], "power_limit": info["power_limit"],
                                       **direct_modes}}))
    print(json.dumps({"multidevice": {"card": info["name"], "power_limit": info["power_limit"],
                                      "cards_visible": torch.cuda.device_count(), **multidevice}}))
    print(json.dumps({"bench": {"card": info["name"], "power_limit": info["power_limit"],
                                **bench_rows}}))
    print(json.dumps({"examples": {"card": info["name"], "power_limit": info["power_limit"],
                                   **examples}}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
