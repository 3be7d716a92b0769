#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_montecarlo_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the fused integrate kernel from ``tpu_montecarlo_torch/csrc``
   and print the build seconds and nvcc's register report (the MCMC
   kernel's two integrand sets build at the same time, in parallel);
3. hold the kernel against its plain PyTorch version on the card, for the
   uniform, normal and exponential families at 2**24 samples: every mean
   within rel 1e-5 + abs 1e-6 (the two draw the same samples; the margin
   covers erfinv/libm last-bit differences and float32 summation order);
4. drive the main path, ``integrate(bench fns, Distribution.normal(0, 1),
   n_samples=1e9, seed=42)``, and check each of the 8 moments against its
   closed form within 6 sigma, and that the kernel's launch count rose;
5. at the main path's shape, 1e9 samples under N(0, 1): hold the kernel
   against the plain version with the same tolerance, time both (CUDA
   events), time ``integrate()`` end to end (host clock), count the bound
   on the running build and, beside it, on the SASS of the kernel before
   its redesign (``tools/sass``), and read the device idle share of warm
   calls from one ``torch.profiler`` window;
6. finish building the MCMC kernel (``csrc/mcmc.cu``, one library per
   integrand set, mode and family pair, all started in phase 2) and print
   nvcc's register and spill report;
7. hold the MCMC kernel against its plain version on the card in every
   mode (independence under three family pairs, random walk, adaptive
   walk, error bars) at 4096 chains x (200 + 1000) steps: no chain splits
   (ends more than 1e-3 apart), acceptance within 1e-3, means within 0.2
   standard errors + 1e-6, error bars within rel 1e-3;
8. drive the MCMC main path, ``integrate_mcmc([x*x], N(0, 1), N(0, 2),
   n_steps=10_000, n_chains=4096, n_burnin=1_000, seed=42,
   return_stderr=True)``: E[x^2] within 6 standard errors of 1, and the
   launch counts of the chain kernel and of its pilot kernel rose;
9. at the main path's configuration (error bars on, so pilot kernel and
   chain kernel): hold the kernel against the plain version as in phase 7
   at 4096 x (200 + 1000) steps (the plain version timed in that run),
   time the kernel at the main path's shape (CUDA events) and time
   ``integrate_mcmc()`` end to end (host clock), in chain-steps/s counted
   as 4096 x (10_000 + 1_000); the kernel without
   error bars and the kernel of an adaptive walk on N(0, 1)
   (``RandomWalk(adapt=True)``) at the same shape are timed beside them,
   and the pipe and latency bounds computed;
10. finish building the nd integrate kernel (``csrc/integrate_nd.cu``) for
    c9's and c9c's integrand sets and print nvcc's register and spill
    report;
11. hold the nd kernel against its plain version on the card at 2**24
    samples in every mode: c9's set (N(0,1) x U(0,1) x Exp(2)) in mc,
    antithetic, qmc, and mc and antithetic with error bars; c9c's in qmc.
    Means within rel 1e-5 + abs 1e-6, error bars within rel 1e-4;
12. drive nd main path 1, ``integrate([x*y*z, x*x+y+z], [N(0,1), U(0,1),
    Exp(2)], n_samples=1e9, seed=42)``: both means within 6 sigma of
    their closed forms (0, 2), and the nd kernel's launch count rose;
13. drive nd main path 2, ``integrate([exp(x)*exp(y)], [U(0,1)]*2,
    n_samples=1e9, method="qmc", return_stderr=True, qmc_rotations=8)``:
    within 6 rQMC standard errors of (e - 1)^2 plus 4 float32 ulp (the
    rotations' float32 means can agree bit for bit), the 8 rotations one
    batched launch; then each of the 8 rotations again at its own grid
    (2**27 points) and seed: the kernel against the plain version (rel
    1e-5 + abs 1e-6), and the spread of the rotations' float64 means (from
    the kernel's float32 block rows) above 0 and 10x below the plain-MC
    error at 1e9; the batched launch's rows against the 8 launches', bit
    for bit; and time one rotation's kernel and the batched launch (CUDA
    events);
14. at main path 1's shape: hold the nd kernel against the plain version,
    time both (CUDA events) and ``integrate()`` end to end (host clock),
    in d-vector samples/s counted as ``benchmarks/run_all.py:339`` counts
    them (requested samples), count the bound as phase 5 does, and read
    the device idle share of warm calls from one ``torch.profiler``
    window;
15. finish building the nd MCMC kernel (``csrc/mcmc_nd.cu``) for c9d's,
    c9e's and c10b's sets and phase 16's (one library per integrand set,
    target, mode and family tuple, all started in phase 2) and print
    nvcc's register and spill report;
16. hold the nd MCMC kernel against its plain version on the card in every
    mode (independence under a product and under c9e's joint target,
    random and adaptive walk on the joint target, error bars, a d = 1
    joint target, d = 4) at 4096 chains x (200 + 1000) steps, with phase
    7's gates (no chain splits);
17. drive the nd MCMC main path, c9e: ``integrate_mcmc([x*y], joint
    log density of a bivariate normal with rho = 0.8, [N(0,2)]*2,
    n_steps=10_000, n_chains=4096, n_burnin=1_000, seed=42,
    return_stderr=True)``: E[xy] within 6 standard errors of 0.8; then
    c9d (``[x*x+y*y]`` under N(0,1)^2, E = 2) and c10b (a random walk on
    c9e's target, E[xy] = 0.8) at the same shape.  Each call's kernel and
    pilot kernel launch counts must rise;
18. at c9e's configuration: hold the nd kernel against the plain version
    once at 4096 x (200 + 1000) steps (the plain version timed in that
    run, CUDA events), at its shape time the kernel and c10b's walk
    kernel (CUDA events) and
    ``integrate_mcmc()`` end to end (host clock) in chain-steps/s counted
    as 4096 x (10_000 + 1_000), compute its pipe and latency bounds, and
    read the device idle share of warm calls of c9e and of the 1-D MCMC
    main path from one ``torch.profiler`` window each;
19. finish building the tempered MCMC kernel (``csrc/mcmc_pt.cu``) for
    c12's and c12c's programs, their ladder-layout twins and phase 20's
    (one library per integrand set, target, mode, rung count, family
    tuple and layout, all started in phase 2) and print nvcc's register
    and spill report;
20. hold the tempered kernel against its plain version on the card in
    every mode (adaptive walk on c12's mixture target, T = 4; a fixed walk
    on a 1-D Distribution target, T = 3; independence N(0, 6) on the
    mixture, T = 4; independence on a 2-D product, T = 2; a walk on c9e's
    joint target, T = 5; error bars in walk and independence mode) at
    4096 chains x (200 + 1000) steps, with phase 7's gates and the swap
    rates within 1e-3 (at most 1 % of the ladders split);
21. drive the tempered main path, c12: ``integrate_mcmc([x, x*x],
    logmix, RandomWalk(step_size=0.5, adapt=True, init_range=(3, 5)),
    temperatures=[1, 2, 4, 8], return_stderr=True, **MCMC_MAIN)``: E[x]
    within 6 standard errors of 0 and E[x^2] of 17, the swap rate in
    (0, 1), and the launch counts of the chain kernel and of its pilot
    kernel rose; then c12c (independence N(0, 6)) at the same shape;
22. at c12's configuration: hold the tempered kernel against the plain
    version once at 4096 x (200 + 1000) steps (the plain version timed in
    that run, CUDA events), at its shape
    hold c12's and c12c's default layouts bit for bit against their
    ladder layouts (rows and final states), time the kernel, c12c's and
    both ladder layouts (CUDA events) and ``integrate_mcmc()`` end to end
    (host clock) in lane-steps/s (4 rungs x 4096 x 11,000, the unit of
    ``benchmarks/run_all.py:508-529``) and chain-steps/s, compute its pipe
    bound (over the T x chains / 32 warps of the step's independent rung
    moves) and latency bound on the ladder layout's build, print the
    running build's counts beside them, and read the device idle share of
    warm c12 calls from one ``torch.profiler`` window;
23. time the pipe probe's IMAD + FFMA mix (``tools/pipe_rates.cu``; all
    its mixes: ``tools/pipe_probe.py``), print each SASS opcode's rate
    per SM per clock, and fail if it runs above the bounds' pipe model
    by more than 3 %;
24. finish building the 1-D integrate kernel's mode libraries (antithetic,
    qmc, mc with error bars, antithetic with error bars, and config 4's
    importance set with error bars; all started in phase 2) and print
    nvcc's register and spill report;
25. hold each mode's kernel against its plain version on the card at 2**22
    samples under U(-1,2), N(0.5,1.5) and Exp(2), and config 4's
    importance set under its proposal: means within rel 1e-5 + abs 1e-6,
    error bars within rel 1e-4 + abs 1e-9, each absolute term times the
    column's size (its mean |value| on the pilot grid, or |mean| if
    larger);
26. the bench set at 2**30 samples under N(0, 1) in each mode and one
    rotation of rQMC (8 x 2**27, ``integrate(method="qmc",
    return_stderr=True)``): time the kernel and the plain version (CUDA
    events), hold the two outputs together with phase 25's tolerances,
    time the ``integrate()`` call end to end (host clock), and count the
    bound on the running build, per sample drawn (per pair under
    antithetic); every later timing of this kernel (phases 27 and 29)
    holds its outputs so too;
27. drive the importance-sampling main path at BASELINE.md
    config 4, ``integrate_importance_sampling([x > 4], N(0,1), N(4,1.5),
    n_samples=1e8, return_stderr=True, return_diagnostics=True)``: the
    estimate within 6 standard errors of P(X > 4) = 3.1671e-5, the
    weight diagnostics (ESS) printed, and the launch count rose; then
    time its kernel, plain version and call as phase 26 does, read the
    device idle share of warm calls, and time the same set at 2**30;
28. finish building the 1-D kernel's CUSTOM and table-weight libraries
    (all started in phase 2), then hold each against its plain version at
    2**22 samples with phase 25's tolerances: the bench set on the
    stratified route (Beta(2, 5)), the gap-respecting one (a mixture of
    U(-3,-1) and U(1,3)) and the knot-exact one (Student-t(5)), each in
    mc, antithetic and qmc, mc and antithetic with error bars; and
    importance sets whose target is a pdf table (under a uniform and under
    a table proposal) and whose q is the sampler's own density, with error
    bars, antithetic error bars and qmc;
29. drive BASELINE.md config 3, ``integrate([x, x*x], Distribution.beta(2,
    5, table_size=512), n_samples=1e7)`` and ``integrate([x], triangular
    from_pdf on [0, 2], table_size=512)``: each estimate within 6 standard
    errors of its closed form (2/7, 6/56; 1) and the Beta ones within
    BASELINE's 0.01, printed with its z-score, and the launch count rose;
    then time each one's kernel, plain version and call as phase 26 does,
    read the idle share of warm Beta calls, and time the bench set under
    Beta(2, 5) at 2**30 and an importance set with a table target at 2**30,
    each with its bound (the bound counts the arithmetic pipes; the table
    loads are left out of it);
30. finish building the three MCMC kernels' CUSTOM-table libraries (one
    per program, route and layout, all started in phase 2) and hold each
    table route against its plain version at 4096 chains x (200 + 1000)
    steps with phase 7's gates (the swap rates within 1e-3): the 1-D
    kernel's table target, sampler-mode and gapped proposals, walks and
    error bars; the nd kernel's CUSTOM dimensions first and last
    (sampler-mode, gapped, a table target under a walk); the tempered
    kernel's table target and sampler-mode dimensions;
31. drive BASELINE.md config 5, ``integrate_mcmc([x*x], from_pdf(bimodal,
    support=(-6, 6)), U(-6, 6), n_steps=10_000, n_chains=4096,
    n_burnin=1_000, return_stderr=True)``: E[x^2] within 6 standard errors
    of 5 and within BASELINE's 0.2, the launch counts (set to 0 just
    before) rose; then hold the kernel against its plain version at that
    shape, time both (CUDA events) and the warm call (host clock), read
    the idle share of warm calls and count the bounds (the table loads
    left out);
32. the same for c9f, ``integrate_mcmc([x*y], [Beta(2,5), N(0,1)],
    [Beta(2,5), N(0,2)], ...)``: E[xy] within 6 standard errors of 0;
33. the same for c12d, ``integrate_mcmc([x, x*x], from_pdf(bimodal),
    from_pdf(exp(-0.5 (x/3)^2), support=(-7, 7)), temperatures=[1, 2, 4,
    8], ...)``: E[x] and E[x^2] within 6 standard errors of 0 and 5;
34. the seven extended families (lognormal, Cauchy, Laplace, logistic,
    Gumbel, Weibull, Pareto; libraries of their own, all started in phase
    2): the bench set under each in every 1-D mode against the plain
    version at 2**22 (phase 25's tolerances), then ``integrate(bench fns,
    <family>, n_samples=2**30)`` for each, counted (at least one launch
    per family, finite means), and each family's kernel at 2**30 timed
    with its bound, as phase 26 times a mode, beside its plain version
    at 2**22, where it is held against it;
35. the 1-D MCMC kernel's family checks (Cauchy, Gumbel, Weibull, Pareto
    and lognormal targets; Cauchy, Pareto and Gumbel proposals; a walk and
    an adaptive walk) at phase 30's size and gates, then c5b's shape with a
    Laplace(3, 1) target and a Logistic(0, 2) proposal as phase 31 runs
    config 5 (E[x] = 3, E[x^2] = 11 within 6 standard errors);
36. the nd kernel with every family as a dimension (four and three beside
    N(0, 1) at a time) against its plain version at 2**24 in mc,
    antithetic, qmc and with error bars; then c9's shape (2**30) over
    Lognormal(0, 0.5) x Gumbel(1, 0.5) through ``integrate()``, counted,
    within 6 sigma of its closed forms, against the plain version, timed
    and bounded as phase 14;
37. the nd and tempered kernels' family checks (an adaptive walk on
    Cauchy x Laplace, Weibull x Logistic proposals for Lognormal x Gumbel,
    Cauchy proposals under a T = 2 ladder, a T = 3 walk on Gumbel), then
    c9e's shape over Laplace(3, 1) x Gumbel(1, 0.5) (E[xy] = 3 (1 +
    gamma / 2), E[x + y] = 4 + gamma / 2) and c12's ladder and walk on a
    Laplace(3, 1) target (E[x] = 3, E[x^2] = 11), each as phase 31;
38. the JAX package's parity checks of the families
    (``benchmarks/tpu_parity.py:803-849``, copied): six family means at
    4e6 samples within 2 % and 6 error bars, the Cauchy(2, 1.5) CDF at 2,
    0.5 and 3.5 within 0.005, a Laplace(3, 1) MCMC target from a
    Logistic(0, 2) proposal within 0.1, Weibull(1.5, 2) QMC within 0.005;
    and the wall time phases 34-38 add;
39. the nd kernel over CUSTOM dimensions and with importance weights
    (libraries of their own, one per program and tuple of routes, all
    started in phase 2): each route (strata, strata mirrored, flat, flat
    under qmc, gapped strata, flat gapped, knots) and each weight kind
    (traced, uniform-grid and irregular-grid tables, the sampler's
    density on the stratified and on the flat route; d = 3 with three
    CUSTOM dimensions) against its plain version at 2**22: means within
    rel 1e-5 + abs 1e-6 and error bars within rel 1e-4 + abs 1e-9, each
    absolute term times the column's size;
40. c9b, ``integrate([x*y], [Beta(2,5), U(0,1)], n_samples=1e7)``,
    counted from 0: 1/7 within 6 sigma and the reference's 0.01; its
    kernel against the plain version, timed, bounded (the table loads
    left out), the warm call and the idle share of warm calls;
41. c9's set at 2**30 with its normal dimension made CUSTOM (Beta(2,5) x
    U(0,1) x Exp(2)), counted, within 6 sigma of its closed forms, timed
    and bounded beside c9's phase-14 time;
42. nd importance sampling of a rare event,
    ``integrate_importance_sampling([(x > 3)(y > 3)], [N(0,1)]*2,
    [N(3.5,1.5)]*2, n_samples=1e8, return_stderr=True,
    return_diagnostics=True)``, counted: within 6 standard errors of
    Phi-bar(3)^2 = 1.8222e-6; timed, bounded, the idle share;
43. nd importance sampling with table and sampler weights, ``[x*y*y]``
    under [Beta(2,5) pdf table, N(0,1)] from [Beta(1.5,3), N(0,1.5)] at
    2**30 with error bars, counted: 2/7 within 6 standard errors; timed
    and bounded; and the wall time phases 39-43 add;
44. split-R-hat, ESS and DRAWS thinned draws at c5b's shape through
    ``integrate_mcmc``, counted from 0: R-hat in (0.99, 1.02), the draws'
    mean of x^2 within 6 x stderr x sqrt(stride) of the value, values and
    error bars bit-equal to the run without the outputs; the kernel
    against its plain version at that shape (R-hat rel 1e-4, ESS rel
    1e-3, the draws chain for chain), timed with and without the outputs;
    then a run at MCMC_CHECK's shape with REMAINDER_DRAWS draws (steps
    left past the last draw) whose buffer's guard rows must stay as they
    were, against its plain version;
45. ``tests/test_diagnostics.py:33``'s slow-mixing run: R-hat > 1.1;
46. phase 44 at c9e's shape, and the draws' x-y correlation within 0.02
    of 0.8;
47. phase 44 at c12's shape (cold-rung R-hat below 1.05, the cold draws'
    share with x > 0 within 0.05 of 0.5, the swap rate unchanged), its
    remainder run on rungs on lanes and on the ladder layout;
48-53. HMC (c11, c11c; c11b, c12b) and chain state (c5b, c9e), each
    kernel held against its plain version at MCMC_CHECK's depth (the
    plain version timed there) and timed at SHORT_MCMC's shape, the
    state phases' resumed segment at STATE_STEPS;
54-59. the serving handles, built as a user builds them: ``compile_
    integrate`` over the bench set at 1e9 a job with ``seed_batch=8`` (54)
    and over eight ``pack_param_batch`` N(m, s) rows at 2**27 with error
    bars (55); config 3 at 1e7 with ``seed_batch=64`` (56); config 4's
    ``compile_importance_sampling`` at 1e8 with ``seed_batch=8`` and error
    bars (57); c9's set at 1e9 with ``seed_batch=4`` and four
    ``pack_param_batch_nd`` rows at 2**27 (58); ``compile_mcmc`` at c5b's
    shape, 4096 x (1,000 + 2,000) with error bars and ``seed_batch=4``,
    four N(m, s) targets under four ``pack_random_walk_batch`` adaptive
    walks, and c11's HMC at ``seed_batch=2`` (59).  Each: one warm call is
    one batched launch (counted), each rep of a batched launch is the
    unbatched launch with its seed and row, bit for bit (its rows; for
    MCMC its block rows and final states), each element of the handle the
    unbatched handle's, bit for bit; the batched and the unbatched launch
    timed (CUDA events), the bound (an integrate batch's R times the
    unbatched launch's; an MCMC batch's below), the warm call (host clock, enqueue and synchronised) and its idle share in
    one profiler window, and beside the integrate ones the unbatched
    public call's;
60-63. the nd and tempered ``compile_mcmc`` handles, as phase 59 at
    4096 x (1,000 + 2,000) with error bars: c9e and c9d with
    ``seed_batch=4`` (60); c9e with ``seed_batch=4`` and 300 draws (61);
    c9d's set over four ``pack_param_batch_nd`` rows of targets and
    proposals, and four ``pack_random_walk_batch_nd`` adaptive walks
    (62); c12, c12b (HMC), c12c and c12d (tables) with ``seed_batch=2``
    through tempered handles (63), the ladders' rows and cold final
    states bit for bit.  An MCMC batch's bound is max(R jobs' pipes on
    all their warps, one job's latency x waves of resident warps), counted
    on a one-lane build of its group (1-D, nd; the build that runs beside
    it) or on the ladder layout's build (tempered);
64-67. sets wider than one launch takes and control variates, each
    group's library started in phase 2, each cell through its public
    call counted from 0 (one launch a group, its passes over one stream
    or one set of chains), every pass held against its plain version on
    the card and timed (CUDA events) and bounded on its own build beside
    nvcc's spills: c7 (``benchmarks/run_all.py:262-292``), 128 and 256
    bins of Beta(2, 5)'s 2048-entry table at 2**27 through
    ``compile_integrate`` (one and two launches), the bins within 6 sigma
    of the masses, and K = 256's per-function rate against K = 128's (64);
    the 128 bins with error bars (65); K = 254 over c5b's and c9e's shapes
    and 252 over c12's at 4 096 x (200 + 1 000) with error bars through
    ``integrate_mcmc`` (two groups each; each pass against its plain
    version at 4 096 x (20 + 100); the passes' final states and accept
    and swap counts bit for bit) (66); control variates, exp(x/2) and 31
    shifted copies under N(0, 1) with the controls x, x^2, x^3 and sin x at
    2**24, 174 composed integrands in two passes, and with error bars 206
    against the plain run's (67).
68-71. the CUSTOM tables the JAX package runs on its XLA sweep, their
    libraries started in phase 2: every new route of the three MCMC
    kernels (knots: a knot-exact proposal with its full, irregular log
    table; full: an inverse of 1,000 knots with a uniform or an
    irregular q-table; the irregular target table under a walk and HMC,
    in 1-D, nd and tempered) against its plain version chain for chain at
    4 096 x (200 + 1 000), the 1-D full routes and HMC on the irregular
    target also timed and bounded there (68); then through
    ``integrate_mcmc``, each
    counted from 0, within 6 error bars and 0.2 of its closed form, held
    to its plain version at 4 096 x (200 + 1 000), timed and bounded at
    its shape: [x^2] on N(0, 1)
    from Student-t(5) at 4 096 x (1 000 + 10 000), E = 1, and an adaptive
    walk on a spiky irregular table at 4 096 x (1 000 + 2 000), E[x] = 2
    (69); c9f with dimension 1's proposal Student-t(5, 0, 2), E[xy] = 0
    (70); c12d with the Student-t(5, 0, 3) proposal and with a gapped one
    (the tempered kernel's gapped route), E[x] = 0, E[x^2] = 5 (71), the
    last three at 4 096 x (1 000 + 2 000).  Their bounds count the knot
    searches: each search's loop body in the SASS (the innermost loops in
    the sample loop) at floor(log2(n + 1)) levels over n knots, the
    fewest a search takes, and on a walk's carried chain one dependent
    instruction a level.
72-75. ``expectation_fn`` and ``adapt_proposal``, their libraries started
    in phase 2 and their spills printed: the bench set's estimator under
    N(0, 1) at 2**30 with ``params.requires_grad``, counted from 0 (one
    launch of kernel 1's gradient build), its values ``integrate()``'s bit
    for bit, its gradients within GRAD_Z standard errors (batch means over
    the launch's block rows) of the closed forms, timed and bounded on the
    gradient build's SASS (72); the gradient build in each method under
    N(0, 1) and under each extended family in mc at 2**22, its value sums
    the value build's bit for bit, means and gradients against the plain
    version (GRAD_RTOL) (73); c9's nd estimator at 2**30 as phase 72 (one
    launch of kernel 2's gradient build), each method at 2**22 against the
    plain version, timed and bounded (74); ``adapt_proposal([x > 4],
    N(0, 1), support=(-8, 8))`` at its defaults on the card, its edges
    within ADAPT_EDGE_TOL of the same call's on the host, then config 4 at
    1e8 from the learned proposal through the public call, counted (kernel
    1's strata route, the sampler's density as q), within 6 standard
    errors of P(X > 4), its error bar against the fixed N(4, 1.5)
    proposal's, its kernel timed and bounded as phase 27's (75).

The three MCMC kernels' latency bounds are the steps times the carried
chain of one step (the dependent instructions per step on a cycle of
registers one iteration carries into the next), and their pipe bounds
count the function's parallel work: the whole card under an independence
proposal, the chains' (or rung moves') warps for a walk.  A 1-D or nd
build that spreads a chain over L lanes runs each decision on every lane,
so their bounds count a one-lane build of the same group, the function's
own instructions; the running build's count is printed beside it.  A
tempered build of rungs on lanes repeats each pair's swap decision on
both of its lanes (and runs padding lanes), so its bounds count the
ladder layout's build, one thread per ladder.

Each kernel's bound is the least time the card could take at the main
path's shape: from the built library's SASS (``cuobjdump -sass``, read by
``card_bound`` and the functions it calls), the instructions per sample of each
arithmetic pipe (fma, its IMAD half, alu, xu) on the cheapest path
through the sample loop, over that pipe's rate on the card's SMs at the
SM clock read under load (``nvidia-smi``); the busiest pipe sets it.
The time to issue every instruction of the loop is printed beside it.

Prints the kernel record as one JSON line before the last, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no CUDA device is available or the port is not importable.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

# The cells: integrands, densities, shapes, closed forms, tolerances.
sys.path.insert(0, str(Path(__file__).resolve().parent))
from smoke_cells import *  # noqa: E402,F403


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    import torch

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


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def clock_under_load(fn, ms: float) -> float:
    """SM clock (MHz) read while about a second of ``fn`` launches runs."""
    import torch

    for _ in range(max(20, int(1000.0 / max(ms, 1e-3)))):
        fn()
    mhz = float(smi("clocks.sm"))
    torch.cuda.synchronize()
    return mhz


def idle_share(call, n_calls: int = 10, windows: int = 3,
               floor_ms: float = 0.0):
    """Device idle share of ``n_calls`` warm ``call()``s in one
    ``torch.profiler`` window: busy is the union of the device intervals
    (kernels, copies) the profiler recorded, wall the host clock around
    the window.  A window that traces no device time (as some of c9b's
    did late in this script, never in a process of its own,
    tools/idle_probe.py) is taken again, up to ``windows`` in all.
    ``floor_ms`` is the device time a call needs at least (its kernels'
    CUDA-event times): a window whose busy time falls short of
    ``n_calls`` of it lost device events, and its share is not kept.
    Prints and returns the share, or None when no window saw device
    time or the window lost events."""
    import inspect

    import torch
    from torch.profiler import ProfilerActivity, profile

    keep = ({"acc_events": True} if "acc_events"
            in inspect.signature(profile).parameters else {})
    call()
    torch.cuda.synchronize()
    for window in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **keep) as prof:
            t0 = time.perf_counter()
            for _ in range(n_calls):
                call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA
        )
        busy_us, end = 0.0, -math.inf
        for start, stop in spans:
            if stop > end:
                busy_us += stop - max(start, end)
                end = stop
        if busy_us > 0.0:
            break
        print(f"  device idle share: window {window} traced no device time")
    else:
        print("  device idle share: not measured (no device time traced)")
        return None
    share = 1.0 - busy_us / wall_us
    print(f"  device idle share of {n_calls} warm calls, one profiled "
          f"window: wall {wall_us / 1e3:.3f} ms, busy {busy_us / 1e3:.3f} ms,"
          f" idle {share:.2%} ({wall_us / n_calls / 1e3:.3f} ms per call "
          f"under the profiler)")
    if busy_us < 0.98 * n_calls * floor_ms * 1e3:
        print(f"  the window lost device events: busy {busy_us / 1e3:.3f} ms"
              f" under {n_calls} x {floor_ms:.4f} ms of kernel (CUDA events);"
              " its idle share is not kept")
        return None
    return share


# -- The bounds: per-pipe instruction counts of a kernel's SASS sample loop --
#
# ``cuobjdump -sass`` lists a built library's machine code.  For one kernel
# function the code below finds its loops (a backward branch and the
# instructions between its target and it) and counts, along the cheapest
# path through one iteration, the instructions of each arithmetic pipe,
# per thread (a warp instruction is 32 lane-operations):
#
# * fma: float32 add, multiply, fused multiply-add, compare and select,
#   Hopper's integer add VIADD, and integer multiply-add (IMAD, also as a
#   move; IMUL compiles to it);
# * fmaheavy: IMAD alone, which only half of the fma pipe's lanes run;
# * alu: 32-bit integer and logic operations (IADD3, LOP3, SHF, ISETP,
#   LEA, ...) and float32 min/max (FMNMX);
# * xu: MUFU special functions and type conversions (I2F, F2I, FRND).
#
# Their rates per SM per clock, 128, 64, 64 and 16, are the CUDA C++
# Programming Guide's arithmetic-instruction throughput table for compute
# capability 9.0 (32-bit integer multiply-add at 64); so an fma-pipe time
# is max(IMAD / 64, (FP32 + IMAD) / 128).  Which instruction takes which
# pipe is what the pipe probe (tools/pipe_probe.py) showed on an H100:
# IMAD alone runs at 64 per SM per clock, beside LOP3 at 55 + 55 (two
# pipes) and beside FFMA at 45 + 45 (90, under the shared 128); FMNMX
# beside LOP3 at 31 + 31 (one pipe of 64); ptxas splits a stream of adds
# into IADD3 and VIADD, which run at 53 + 53 (two pipes).  Phase 23 runs
# the probe's IMAD + FFMA mix and fails if it beats this model.  The bound
# is the busiest pipe's time.  Loads, moves and branches use no
# arithmetic pipe; ``issue`` (every instruction, four
# schedulers issuing one warp instruction per clock each) is reported
# beside the bound and is not part of it.  The cheapest path makes the
# count a lower bound whatever branches a run takes (a rare slow path,
# such as sinf's argument reduction, is skipped).  One iteration's samples
# are its uint32 -> float32 conversions (one per uniform, the 24-bit
# mantissa) over the conversions per sample; logf and sinf convert signed
# integers and division converts with .RP, so neither counts.
#
# An MCMC chain is a recurrence: each step's decision reads the state the
# step before carried out.  Besides the pipes, its least time is the
# steps times the carried chain of one step (``carried``: the most
# dependent instructions per iteration along a cycle of registers that
# one iteration carries into the next, ``carried_depth``) times
# LATENCY_CYCLES.  What an iteration computes from no carried register
# (the draws, from the loop counter and the seed) is ready whenever it is
# needed, so it is not on that chain.  ``chain`` (the longest run of
# dependent instructions within one iteration, carried or not) is printed
# beside it.  The pipes count the function's own parallel work: the whole
# card where every chain-step's draws are independent of every other
# (independence proposals), and the chains' warps where a step waits on
# the one before (walks; ``function_warps``).

# The integrate kernels' SASS before their redesign (tools/integrate_sweep.py
# --sass on commit e1fa41d's tree, an H100 build): phases 5 and 14 print
# the bound counted on it beside the running build's, like for like with
# the runs before the redesign.
PARENT_SASS = Path(__file__).resolve().parent / "tools" / "sass"
PARENT_TWIN = "the build before the redesign (tools/sass, commit e1fa41d)"
PIPE_RATES = {"fma": 128, "fmaheavy": 64, "alu": 64, "xu": 16}
SCHEDULERS_PER_SM = 4
# How far a probe mix may run above the model's ceiling before phase 23
# fails: the SM clock is read, not set, and IMAD alone reads 64.3 of 64.
# A mix that broke a pipe class (IMAD as two fma slots: 134 of 128) runs
# well above it.
PROBE_TOLERANCE = 0.03
# The least clocks between an arithmetic instruction and one that reads its
# result: the fixed-latency FP32 and INT32 pipes' depth on Volta through
# Hopper SMs, as published microbenchmarks report it.  Assumed, not
# measured here; MUFU, conversions and shared loads take longer, so the
# chain's time is a lower bound.
LATENCY_CYCLES = 4
_FMA_HEAVY = {"IMAD", "IMAD32I", "IMUL", "IMUL32I"}
_FMA = {
    "FADD", "FADD32I", "FMUL", "FMUL32I", "FFMA", "FFMA32I", "FSEL", "FSET",
    "FSETP", "FSWZADD", "VIADD", *_FMA_HEAVY,
}
_ALU = {
    "BFE", "BFI", "BMSK", "FMNMX", "IABS", "IADD", "IADD3", "IADD32I",
    "IMNMX", "ISCADD", "ISETP", "LEA", "LOP", "LOP3", "LOP32I", "PRMT",
    "SEL", "SGXT", "SHF", "SHL", "SHR", "VIMNMX",
}
_XU = {
    "BREV", "F2F", "F2FP", "F2I", "FLO", "FRND", "I2F", "I2FP", "I2I",
    "MUFU", "POPC",
}
_PIPES = (("fma", _FMA), ("fmaheavy", _FMA_HEAVY), ("alu", _ALU),
          ("xu", _XU))
_COUNTED = (*PIPE_RATES, "issue", "conversions")
_TERMINAL = ("EXIT", "RET", "BRX", "JMX")
_SASS_INSTR = re.compile(r"/\*([0-9a-fA-F]+)\*/\s+([^;]*?)\s*;")
_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_REG = re.compile(r"\bU?[RP]\d+\b")
_NO_DEST = {"RED", "BRA", "JMP", "EXIT", "RET", "BAR", "BSYNC", "BSSY",
            "WARPSYNC", "NOP", "CALL"}
# What a loop counter's update may take: an induction register steps by a
# loop-invariant amount in at most two of these.
_INDUCTION = {"IADD3", "IADD", "IADD32I", "VIADD", "IMAD", "LEA", "MOV",
              "UIADD3", "UMOV", "ULEA", "UIMAD"}


@dataclass(frozen=True)
class Instr:
    addr: int
    predicated: bool
    opcode: str  # full, e.g. "IMAD.WIDE.U32"
    operands: str
    guard: str = ""  # the predicate register of "@P0" or "@!P0"

    @property
    def base(self) -> str:
        return self.opcode.split(".")[0]

    def branch_target(self):
        if self.base not in ("BRA", "JMP"):
            return None
        m = re.search(r"0x([0-9a-fA-F]+)", self.operands)
        if m is None:
            raise ValueError(f"branch without an address: {self}")
        return int(m.group(1), 16)


@dataclass(frozen=True)
class LoopCount:
    """One loop: its address range and, per class, the instructions on
    the cheapest path through one iteration; ``path``, the addresses of
    the instructions on the path with the fewest (issue)."""

    start: int
    end: int
    counts: dict
    path: tuple = ()


def pipe_of(opcode: str) -> tuple:
    """The arithmetic pipes an instruction takes one slot of each (IMAD:
    fma and fmaheavy), or () for none."""
    base = opcode.split(".")[0]
    return tuple(pipe for pipe, ops in _PIPES if base in ops)


def is_uniform_conversion(opcode: str) -> bool:
    """uint32 -> float32, as ``float(mantissa)`` compiles (``I2F.U32``,
    ``I2FP.F32.U32``; not the ``.RP`` reciprocal of integer division)."""
    parts = opcode.split(".")
    return (parts[0] in ("I2F", "I2FP") and "U32" in parts
            and not {"F64", "F16", "RP"} & set(parts))


def parse_functions(listing: str) -> dict:
    """The instructions of each function of a ``cuobjdump -sass``
    listing, by (mangled) name."""
    out, current = {}, None
    for line in listing.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _SASS_INSTR.search(line)
        if m is None or current is None or not m.group(2).split():
            continue
        text = m.group(2).split()
        pred = text[0].startswith("@")
        guard = text[0].lstrip("@!") if pred else ""
        if pred:
            text = text[1:]
        current.append(Instr(int(m.group(1), 16), pred, text[0],
                             " ".join(text[1:]), guard))
    return out


def loop_counts(instrs) -> list:
    """Each loop of a function, in address order, with its per-class
    counts on the cheapest path from the loop's first block to a block
    that branches back to it (blocks in address order, forward edges
    only, so a nested loop's body counts once or, where a branch skips
    it, not at all)."""
    index = {ins.addr: i for i, ins in enumerate(instrs)}
    leaders = {0}
    for i, ins in enumerate(instrs):
        target = ins.branch_target()
        if target is not None and target in index:
            leaders.add(index[target])
        if target is not None or ins.base in _TERMINAL:
            leaders.add(i + 1)
    starts = sorted(s for s in leaders if s < len(instrs))
    bounds = [(s, (starts[n + 1] if n + 1 < len(starts) else len(instrs)) - 1)
              for n, s in enumerate(starts)]
    block_of = {s: n for n, (s, _) in enumerate(bounds)}
    succs, cost = [], []
    for n, (first, last) in enumerate(bounds):
        ins, out = instrs[last], []
        target = ins.branch_target()
        if target is not None and target in index:
            out.append(block_of[index[target]])
        falls = (target is None and ins.base not in _TERMINAL) or ins.predicated
        if falls and n + 1 < len(bounds):
            out.append(n + 1)
        succs.append(out)
        c = dict.fromkeys(_COUNTED, 0)
        for i in instrs[first:last + 1]:
            c["issue"] += 1
            c["conversions"] += is_uniform_conversion(i.opcode)
            for pipe in pipe_of(i.opcode):
                c[pipe] += 1
        cost.append(c)
    latches = {}
    for n, out in enumerate(succs):
        for s in out:
            if s <= n:  # a backward edge n -> s: s heads a loop
                latches.setdefault(s, []).append(n)
    result = []
    for h in sorted(latches):
        end = max(latches[h])
        counts, path = {}, None
        for cls in _COUNTED:
            dist, pred = {h: cost[h][cls]}, {}
            for n in range(h, end + 1):
                for s in succs[n] if n in dist else ():
                    if n < s <= end and dist[n] + cost[s][cls] < dist.get(
                            s, math.inf):
                        dist[s], pred[s] = dist[n] + cost[s][cls], n
            last = min((n for n in latches[h] if n in dist), key=dist.get)
            counts[cls] = dist[last]
            if cls == "issue":
                path = [last]
                while path[-1] != h:
                    path.append(pred[path[-1]])
        body = [i for b in reversed(path)
                for i in instrs[bounds[b][0]:bounds[b][1] + 1]]
        counts["chain"] = chain_depth(body)
        counts["carried"] = carried_depth(body)
        result.append(LoopCount(instrs[bounds[h][0]].addr,
                                instrs[bounds[end][1]].addr, counts,
                                tuple(i.addr for i in body)))
    return result


def chain_depth(instrs) -> int:
    """The longest chain of dependent instructions in straight-line
    ``instrs``: each reads a register (R, P, UR, UP) that the one before
    it wrote.  Values from before the first instruction count as ready,
    and an instruction's destination is its first operand (after any
    ``PT``), so a second destination (IMAD.WIDE's high word) is missed:
    both keep the count a lower bound."""
    depth, longest = {}, 0
    for ins in instrs:
        toks = [t.strip() for t in ins.operands.split(",")]
        while toks and toks[0] == "PT":
            toks.pop(0)
        dest = None
        if (toks and _SASS_REG.fullmatch(toks[0])
                and not ins.base.startswith("ST") and ins.base not in _NO_DEST):
            dest, toks = toks[0], toks[1:]
        d = 1 + max((depth.get(r, 0) for t in toks
                     for r in _SASS_REG.findall(t)), default=0)
        if dest is not None:
            depth[dest] = d
        longest = max(longest, d)
    return longest


def _dest_and_sources(ins):
    """(destination register or None, source registers) of ``ins``, as
    ``chain_depth`` reads them; a guarded instruction also reads its guard
    and, since it may keep it, its destination's old value."""
    toks = [t.strip() for t in ins.operands.split(",")]
    while toks and toks[0] == "PT":
        toks.pop(0)
    dest = None
    if (toks and _SASS_REG.fullmatch(toks[0])
            and not ins.base.startswith("ST") and ins.base not in _NO_DEST):
        dest, toks = toks[0], toks[1:]
    srcs = [r for t in toks for r in _SASS_REG.findall(t)]
    if ins.guard and _SASS_REG.fullmatch(ins.guard):
        srcs.append(ins.guard)
    if ins.predicated and dest is not None:
        srcs.append(dest)
    return dest, srcs


def carried_depth(instrs) -> float:
    """The carried chain of one iteration of straight-line ``instrs`` (a
    loop body): the most dependent instructions per iteration on a cycle
    of carried registers, those the body reads before it writes them.
    The weight of an edge a -> b is the longest dependent path from a's
    value at the iteration's start to b's at its end; a cycle of k edges
    spans k iterations, and the count is the largest mean over cycles
    (Karp's algorithm).  A path that leaves the cycles (a sum of f(x) in
    which x is carried) overlaps later iterations and does not count.
    Values computed from no carried register count as ready, and so do
    induction registers (a loop counter: a carried register that steps
    by a loop-invariant amount in at most two additions or moves), since
    a whole run of their values can be had ahead."""
    parsed = [_dest_and_sources(ins) for ins in instrs]
    written = {d for d, _ in parsed if d is not None}
    seen, carried = set(), []
    for (dest, srcs), ins in zip(parsed, instrs):
        for r in srcs:
            if r in written and r not in seen and r not in carried:
                carried.append(r)
        if dest is not None:
            seen.add(dest)

    def longest_from(seeds):
        """Per register, the longest path from any of ``seeds`` (at the
        iteration's start) to its value at the end, or -inf."""
        depth = dict.fromkeys(seeds, 0)
        for (dest, srcs), ins in zip(parsed, instrs):
            if dest is None:
                continue
            d = max((depth.get(r, -math.inf) for r in srcs),
                    default=-math.inf)
            depth[dest] = d + 1
        return depth

    reach = {c: longest_from([c]) for c in carried}

    def is_induction(r):
        """r steps by a loop-invariant amount: its end value depends on no
        other carried register, through at most two additions or moves."""
        if any(c != r and reach[c].get(r, -math.inf) > -math.inf
               for c in carried):
            return False
        depth, bad = {r: 0}, set()
        for (dest, srcs), ins in zip(parsed, instrs):
            if dest is None:
                continue
            hit = [x for x in srcs if x in depth]
            bad.discard(dest)
            if not hit:
                depth.pop(dest, None)
                continue
            depth[dest] = 1 + max(depth[x] for x in hit)
            if ins.base not in _INDUCTION or any(x in bad for x in hit):
                bad.add(dest)
        return r in depth and r not in bad and depth[r] <= 2

    nodes = [r for r in carried if not is_induction(r)]
    weight = {a: {b: w for b, w in reach[a].items()
                  if b in nodes and w > -math.inf} for a in nodes}
    n = len(nodes)
    if n == 0:
        return 0
    # Karp: best[k][v] is the heaviest walk of exactly k edges ending at v.
    best = [dict.fromkeys(nodes, 0.0)]
    for _ in range(n):
        prev, cur = best[-1], dict.fromkeys(nodes, -math.inf)
        for a in nodes:
            if prev[a] == -math.inf:
                continue
            for b, w in weight[a].items():
                cur[b] = max(cur[b], prev[a] + w)
        best.append(cur)
    means = [min((best[n][v] - best[k][v]) / (n - k)
                 for k in range(n) if best[k][v] > -math.inf)
             for v in nodes if best[n][v] > -math.inf]
    return max(means, default=0)


def sample_loops(instrs) -> list:
    """The loops that draw samples: those converting uniforms on their
    cheapest path, less those that hold another such loop (a tile loop
    around the sample loop)."""
    drawing = [lp for lp in loop_counts(instrs) if lp.counts["conversions"]]
    return [lp for lp in drawing
            if not any(lp.start < o.start <= lp.end
                       for o in drawing if o is not lp)]


def search_levels(loops, loop, levels: float) -> tuple:
    """(counts, found): the pipe and issue instructions that ``levels``
    more iterations of the knot searches nested in the sample loop
    ``loop`` run, each at the fewest of the innermost loops that ``loop``
    holds (the binary searches); levels that ``loop``'s cheapest path
    already runs once are taken off.  ``found`` is how many innermost
    loops it holds (0: nothing added)."""
    inner = [o for o in loops if loop.start < o.start and o.end <= loop.end]
    inner = [o for o in inner
             if not any(o.start < i.start and i.end <= o.end for i in inner)]
    if not inner or levels <= 0:
        return {}, len(inner)
    on_path = sum(o.start in loop.path for o in inner)
    times = max(levels - on_path, 0.0)
    return ({k: times * min(o.counts[k] for o in inner)
             for k in (*PIPE_RATES, "issue")}, len(inner))


def per_sample(listing: str, function: str, conversions_per_sample: int,
               lanes: int = 1, searches=None):
    """(dearest, cheapest) per-class instructions per sample over the
    sample loops of the kernel function whose mangled name contains
    ``function``.  One iteration draws ``conversions /
    conversions_per_sample`` samples on each of a unit's ``lanes``
    threads (MCMC: the lanes of one chain), and runs that many times
    ``lanes`` units one after another: the pipe and issue counts, summed
    over the lanes, are per unit, and ``chain`` and ``carried`` per unit
    of that sequence.  ``searches``, the knot search levels one unit runs
    (searches x levels each), adds their loop bodies
    (:func:`search_levels`), and ``search_loops``, the innermost loops
    found per iteration (0: none counted)."""
    funcs = [ins for name, ins in parse_functions(listing).items()
             if function in name]
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} functions match {function!r}")
    loops = loop_counts(funcs[0])
    rows = []
    for loop in sample_loops(funcs[0]):
        n, rest = divmod(loop.counts["conversions"], conversions_per_sample)
        if rest:
            raise ValueError(
                f"a loop of {function!r} converts {loop.counts['conversions']}"
                f" uniforms, not a multiple of {conversions_per_sample}")
        counts = dict(loop.counts)
        if searches:
            extra, found = search_levels(loops, loop, searches * n)
            for k, v in extra.items():
                counts[k] += v
            counts["search_loops"] = found
        rows.append({k: v / (n * lanes if k in ("chain", "carried") else n)
                     for k, v in counts.items()})
    if not rows:
        raise ValueError(f"no sample loop in {function!r}")
    return ({k: max(r[k] for r in rows) for k in rows[0]},
            {k: min(r[k] for r in rows) for k in rows[0]})


def bound_ms(counts, units: float, sms: int, clock_mhz: float, warps=None):
    """(least milliseconds, pipe) for ``units`` samples (or chain-steps)
    of ``counts`` per unit on ``sms`` SMs at ``clock_mhz``: the busiest
    arithmetic pipe's time.  With ``warps`` given (a kernel of fewer warps
    than the card has schedulers), only ``warps`` schedulers work, each
    with a quarter of its SM's pipes."""
    busy = sms if warps is None else min(warps, SCHEDULERS_PER_SM * sms) / 4
    times = {pipe: counts[pipe] * units / (rate * busy * clock_mhz * 1e6) * 1e3
             for pipe, rate in PIPE_RATES.items()}
    pipe = max(times, key=times.get)
    return times[pipe], pipe


def issue_ms(counts, units: float, sms: int, clock_mhz: float, warps=None):
    """Milliseconds to issue ``counts["issue"]`` instructions per unit, one
    warp instruction per scheduler per clock: a diagnostic beside the
    bound, since it counts loop control, moves and branches too."""
    schedulers = SCHEDULERS_PER_SM * sms
    if warps is not None:
        schedulers = min(warps, schedulers)
    return counts["issue"] * units / (32 * schedulers * clock_mhz * 1e6) * 1e3


def latency_ms(chain: float, steps: int, clock_mhz: float) -> float:
    """Milliseconds for ``steps`` serial steps of a ``chain``-instruction
    dependent chain each, at LATENCY_CYCLES per instruction."""
    return chain * steps * LATENCY_CYCLES / (clock_mhz * 1e6) * 1e3


def sass_listing(lib) -> str:
    """``cuobjdump -sass`` of a built library (the CUDA toolkit's)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if exe is None:
        fail("cuobjdump not found: the SASS cannot be read")
    return subprocess.run([exe, "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout


def function_warps(mode, chains: int, rungs: int = 1):
    """The warps of an MCMC function's parallel work (``bound_ms``'s
    ``warps``): None (the whole card) when every chain-step's draws are
    independent of every other, as under an independence proposal; else
    the rung moves that one step makes at once, rungs x chains lanes."""
    if int(mode) == 0:  # independence
        return None
    return rungs * chains // 32


def card_bound(lib, function: str, conversions: int, units: float,
               clock_mhz: float, warps=None, weights=None, lanes: int = 1,
               listing=None, searches=None):
    """The bound of ``units`` units of a built kernel on this card:
    ``(bound_ms, pipe, issue_ms, counts)``.  Counts are the dearest sample
    loop's per unit, or with ``weights = (w_dear, w_cheap)`` the
    weighted mean of the dearest and the cheapest loop's; ``lanes`` and
    ``searches`` as ``per_sample``'s.  ``listing``, a SASS listing, takes
    the place of ``lib``'s (a build that is not in this checkout)."""
    import torch

    if listing is None:
        listing = sass_listing(lib)
    dear, cheap = per_sample(listing, function, conversions, lanes, searches)
    counts = dear
    if weights is not None:
        counts = {k: (weights[0] * dear[k] + weights[1] * cheap[k])
                  / sum(weights) for k in dear}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms, pipe = bound_ms(counts, units, sms, clock_mhz, warps)
    return ms, pipe, issue_ms(counts, units, sms, clock_mhz, warps), counts


def print_bound(bound, clock_mhz: float, unit: str, own=None,
                twin: str = "the one-lane build",
                why: str = ", whose lanes repeat decisions") -> None:
    """Prints a bound; ``own``, the bound counted on the build that runs
    (``bound`` then comes from its ``twin``), beside it."""
    ms, pipe, issue, counts = bound
    per = ", ".join(f"{k} {v:g}" for k, v in counts.items())
    print(f"  bound {ms:.3f} ms ({pipe} pipe) at {clock_mhz:.0f} MHz under "
          f"load; issue {issue:.3f} ms (diagnostic); per {unit} on the "
          f"cheapest path: {per}")
    if own is not None:
        mine = ", ".join(f"{k} {v:g}" for k, v in own[3].items())
        print(f"  (counted on {twin}; the build that runs{why}: pipes "
              f"{own[0]:.3f} ms ({own[1]}), issue {own[2]:.3f} ms; per "
              f"{unit} on the cheapest path: {mine})")


def print_parent_bound(bound, unit: str) -> None:
    """Prints the bound counted on PARENT_TWIN, beside the running
    build's."""
    ms, pipe, issue, counts = bound
    per = ", ".join(f"{k} {v:g}" for k, v in counts.items())
    print(f"  like for like, on {PARENT_TWIN}: pipes {ms:.3f} ms ({pipe}), "
          f"issue {issue:.3f} ms; per {unit} on the cheapest path: {per}")


def print_latency(bound, steps: int, clock_mhz: float) -> float:
    """Prints and returns an MCMC kernel's latency bound: ``steps`` steps
    of ``bound``'s carried chain per step at LATENCY_CYCLES each."""
    counts = bound[3]
    ms = latency_ms(counts["carried"], steps, clock_mhz)
    print(f"  latency bound {ms:.3f} ms: {steps} steps per chain x "
          f"{counts['carried']:g} carried dependent instructions per step "
          f"(longest chain within one step {counts['chain']:g}) x "
          f"{LATENCY_CYCLES} clocks; the larger of it and the pipe bound "
          f"applies")
    return ms


def bound_by(bound, latency: float) -> str:
    """What limits an MCMC record's ``bound_ms``, max(pipes, latency):
    "latency" where the carried chain's latency bound is the larger, else
    "operations" (the pipe bound)."""
    return "latency" if latency > bound[0] else "operations"


# The pipe probe (tools/pipe_rates.cu): its mixes' Op bits, by name.
PIPE_PROBE = Path(__file__).resolve().parent / "tools" / "pipe_rates.cu"
_PIPE_OPS = {1: "IMAD", 2: "IMUL", 4: "IADD3", 8: "LOP3", 16: "FFMA",
             32: "FMNMX"}


def load_pipe_probe():
    """Builds (once) and loads the pipe probe."""
    import ctypes

    from tpu_montecarlo_torch.ops.build import load_kernel_library

    lib = load_kernel_library(str(PIPE_PROBE), "")
    lib.tmc_pipe_mix.argtypes = [ctypes.c_int]
    lib.tmc_pipe_mix.restype = ctypes.c_int
    lib.tmc_pipe_rates.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.tmc_pipe_rates.restype = ctypes.c_int
    return lib


def ceiling_shares(rates: dict) -> dict:
    """Per pipe (and issue, four schedulers of 32 lanes), the share of its
    rate per SM per clock that ``rates`` ({opcode: thread instructions
    per SM per clock}) take under the model of ``pipe_of``: above 1, the
    loop ran faster than the model allows."""
    use = dict.fromkeys((*PIPE_RATES, "issue"), 0.0)
    for op, r in rates.items():
        for pipe in pipe_of(op):
            use[pipe] += r
        use["issue"] += r
    rate = {**PIPE_RATES, "issue": 32 * SCHEDULERS_PER_SM}
    return {pipe: use[pipe] / rate[pipe] for pipe in use}


def pipe_rates(lib, card: str, names=None) -> dict:
    """Times each mix of the pipe probe (those named in ``names``, or all)
    on the whole card and prints, per mix, each SASS opcode's rate in its
    loop (thread instructions per SM per clock, counted from the loop's
    SASS and the SM clock under load) and each pipe's share of its rate
    under the bounds' model.  Fails if a mix runs above the model's
    ceiling by more than PROBE_TOLERANCE.  Returns ``{mix name: {opcode:
    rate}}``."""
    import torch

    funcs = parse_functions(sass_listing(lib))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters, threads = sms * 8, 20_000, 256
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(f"pipe rates on {card}, {blocks} blocks of {threads} threads x "
          f"{iters} rounds (thread instructions per SM per clock):")
    rates = {}
    mix = 0
    while (ops := lib.tmc_pipe_mix(mix)) >= 0:
        name = "+".join(v for k, v in _PIPE_OPS.items() if ops & k)
        mix += 1
        if names is not None and name not in names:
            continue
        (instrs,) = [v for k, v in funcs.items()
                     if f"pipe_kernelILi{ops}EE" in k]
        loop = max(loop_counts(instrs), key=lambda lp: lp.counts["issue"])
        body = [i for i in instrs if loop.start <= i.addr <= loop.end]
        n_op = {}
        for ins in body:
            n_op[ins.base] = n_op.get(ins.base, 0) + 1

        def run(mix=mix - 1):
            err = lib.tmc_pipe_rates(mix, blocks, iters, out.data_ptr(),
                                     stream)
            if err != 0:
                fail(f"pipe probe launch failed: {lib.tmc_error_string(err)}")

        ms = time_ms(run, reps=5)
        mhz = clock_under_load(run, ms)
        per = blocks * threads * iters / (ms * 1e-3 * mhz * 1e6 * sms)
        rates[name] = {op: n * per for op, n in n_op.items()}
        shares = ceiling_shares(rates[name])
        print(f"  {name}: {ms:.3f} ms at {mhz:.0f} MHz; loop "
              + ", ".join(f"{op} {n}" for op, n in sorted(n_op.items()))
              + "; per SM per clock "
              + ", ".join(f"{op} {r:.1f}" for op, r in rates[name].items())
              + "; share of the model's rate "
              + ", ".join(f"{p} {v:.3f}" for p, v in shares.items()))
        over = {p: v for p, v in shares.items() if v > 1 + PROBE_TOLERANCE}
        if over:
            fail(f"pipe probe: {name} runs above the bounds' model: {over}")
    if names is not None and set(names) - set(rates):
        fail(f"pipe probe: no mix {sorted(set(names) - set(rates))}")
    return rates


def main() -> int:
    t_main = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        import tpu_montecarlo_torch as tm
        from tpu_montecarlo_torch.api.cache import GLOBAL_CACHE, fns_key
        from tpu_montecarlo_torch.api.device import sampling_tables
        from tpu_montecarlo_torch.api.integrate import cv_composed
        from tpu_montecarlo_torch.api.passes import (
            check_same_chains,
            split_groups,
        )
        from tpu_montecarlo_torch.api.mcmc_nd import dim_tables as nd_dim_tables
        from tpu_montecarlo_torch.api.results import _unit_integrand
        from tpu_montecarlo_torch.ops.integrate_kernel import (
            SAMPLER,
            IntegrateConfig,
            IntegrateProgram,
            integrate_batch_rows,
            integrate_cuda,
            integrate_grad_cuda,
            integrate_grad_reference,
            integrate_reference,
            integrate_rows,
            library_route,
            pilot_values,
            plan_grid,
        )
        from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
            IntegrateNdProgram,
            NdConfig,
            finish_stderr,
            integrate_nd_batch_rows,
            integrate_nd_cuda,
            integrate_nd_grad_cuda,
            integrate_nd_grad_reference,
            integrate_nd_reference,
            integrate_nd_rows,
            nd_routes as nk_routes,
            pilot_row,
            )
        from tpu_montecarlo_torch.ops.mcmc_kernel import (
            MAX_FUNCTIONS as MCMC_MAX_FUNCTIONS,
            ChainStart,
            Layout,
            McmcConfig,
            McmcProgram,
            Mode,
            mcmc_batch,
            mcmc_cuda,
            mcmc_diagnostics,
            mcmc_finish,
            mcmc_reference,
            plan_chains,
            plan_mcmc_grid,
        )
        from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
            McmcNdProgram,
            mcmc_nd_batch,
            mcmc_nd_cuda,
            mcmc_nd_reference,
        )
        from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
            LADDER_LAYOUT,
            MAX_PT_FUNCTIONS,
            McmcPtProgram,
            PtLayout,
            mcmc_pt_batch,
            mcmc_pt_cuda,
            mcmc_pt_reference,
            pt_finish,
        )
        from tpu_montecarlo_torch.ops.mcmc_tables import KnotTable
        from tpu_montecarlo_torch.sampling import (
            DistKind,
            dist_spec_of,
            transform_grad_from_u,
        )
        from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan
    except ImportError as e:
        print(f"tpu_montecarlo_torch is not importable: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. The card.
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. Build: the programs the main paths will take from the cache.  The
    # MCMC kernel's two integrand sets build in parallel with this one.
    traced = tuple(tm.trace_function(f) for f in BENCH_FNS)
    program = GLOBAL_CACHE.get_or_build(
        ("integrate", fns_key(traced)), lambda: IntegrateProgram(traced)
    )
    mcmc_traced = tuple(tm.trace_function(f) for f in MCMC_MAIN_FNS)
    mcmc_program = GLOBAL_CACHE.get_or_build(
        ("mcmc", fns_key(mcmc_traced)), lambda: McmcProgram(mcmc_traced)
    )
    check_program = McmcProgram(
        tuple(tm.trace_function(f) for f in MCMC_CHECK_FNS)
    )
    # The 1-D kernel compiles in its mode and families: one library per
    # configuration of phase 7, of the main path and of the adaptive walk
    # timed beside it.
    n, u, e = DistKind.NORMAL, DistKind.UNIFORM, DistKind.EXPONENTIAL
    walk = [0.8, -2.3, 2.3, 0.44]
    mcmc_cases = [
        ("independence N(0,2)->N(0,1)", Mode.INDEPENDENCE, n, n,
         [0.0, 2.0, 0, 0, 0.0, 1.0], False),
        ("independence U(0,6)->Exp(1.5)", Mode.INDEPENDENCE, u, e,
         [0.0, 6.0, 0, 0, 1.5, 0.0], False),
        ("independence Exp(1)->Exp(2)", Mode.INDEPENDENCE, e, e,
         [1.0, 0.0, 0, 0, 2.0, 0.0], False),
        ("random walk ->N(0,1)", Mode.RANDOM_WALK, n, n,
         walk + [0.0, 1.0], False),
        ("adaptive walk ->N(0,1)", Mode.ADAPTIVE, n, n,
         walk + [0.0, 1.0], False),
        ("independence N(0,2)->N(0,1), stderr", Mode.INDEPENDENCE, n, n,
         [0.0, 2.0, 0, 0, 0.0, 1.0], True),
        ("adaptive walk ->U(-1,2), stderr", Mode.ADAPTIVE, u, u,
         [0.5, -1.0, 2.0, 0.44, -1.0, 2.0], True),
    ]
    mcmc_main_cfg = McmcConfig(Mode.INDEPENDENCE, n, n, MCMC_MAIN["n_steps"],
                               MCMC_MAIN["n_burnin"], with_stderr=True)
    # The adaptive walk at the main shape: RandomWalk(adapt=True) on N(0,1).
    walk_main_cfg = replace(mcmc_main_cfg, mode=Mode.ADAPTIVE)
    walk_main_row = [*tm.RandomWalk(adapt=True).pack_params(
        tm.Distribution.normal(0.0, 1.0)), 0.0, 1.0]
    # The bounds count the function's own work on a one-lane build of the
    # main path's layout: a build of L lanes runs each decision L times.
    mcmc_count_program = McmcProgram(mcmc_traced, layout=Layout(
        1, mcmc_program.layout_for(mcmc_main_cfg).group))
    mcmc_libraries = {
        (id(prog), cfg.compiled): (prog, cfg) for prog, cfg in [
            (mcmc_program, mcmc_main_cfg), (mcmc_program, walk_main_cfg),
            (mcmc_count_program, mcmc_main_cfg),
            *((check_program, McmcConfig(mode, prop, targ, 1, 0))
              for _, mode, prop, targ, _, _ in mcmc_cases)]
    }
    nd_dists = [tm.Distribution.normal(0.0, 1.0),
                tm.Distribution.uniform(0.0, 1.0),
                tm.Distribution.exponential(2.0)]
    qmc_dists = [tm.Distribution.uniform(0.0, 1.0)] * 2
    nd_kinds = tuple(dist_spec_of(d).kind for d in nd_dists)
    qmc_kinds = tuple(dist_spec_of(d).kind for d in qmc_dists)
    nd_traced = tuple(tm.trace_function(f, 3) for f in ND_FNS)
    qmc_traced = tuple(tm.trace_function(f, 2) for f in QMC_FNS)
    nd_program = GLOBAL_CACHE.get_or_build(
        ("integrate_nd", fns_key(nd_traced), nd_kinds),
        lambda: IntegrateNdProgram(nd_traced, nd_kinds),
    )
    qmc_program = GLOBAL_CACHE.get_or_build(
        ("integrate_nd", fns_key(qmc_traced), qmc_kinds),
        lambda: IntegrateNdProgram(qmc_traced, qmc_kinds),
    )

    # The nd MCMC programs, each (program, config, params) as the public
    # path packs them: c9d's, c9e's and c10b's at the main shape (the
    # public calls of phase 17 take them from the cache), and phase 16's.
    integ = tm.MonteCarloIntegrator()
    n01 = tm.Distribution.normal(0.0, 1.0)
    n02 = tm.Distribution.normal(0.0, 2.0)
    c10b_walk = tm.RandomWalk(step_size=1.0, target_accept=0.234,
                              init_range=(-4.0, 4.0))
    # name: (functions, target, proposal, closed form of E[f])
    nd_mcmc_cells = {
        "c9e": (C9E_FNS, c9e_target(), [n02, n02], 0.8),
        "c9d": (C9D_FNS, [n01, n01], [n02, n02], 2.0),
        "c10b": (C9E_FNS, c9e_target(), c10b_walk, 0.8),
    }

    def nd_mcmc_setup(fns, target, proposal, n_steps, n_burnin, stderr):
        parsed = integ._parse_nd_mcmc_args(target, proposal)
        return integ._nd_mcmc_kernel_program(fns, proposal, parsed, n_steps,
                                             n_burnin, stderr)

    nd_mcmc_main = {
        name: nd_mcmc_setup(fns, target, proposal, MCMC_MAIN["n_steps"],
                            MCMC_MAIN["n_burnin"], True)
        for name, (fns, target, proposal, _) in nd_mcmc_cells.items()
    }
    c9e_prog, c9e_cfg, _ = nd_mcmc_main["c9e"]
    nd_count_program = McmcNdProgram(c9e_prog.fns, c9e_cfg, c9e_prog.target,
                                     layout=Layout(1, c9e_prog.layout.group))
    walk2 = dict(step_size=1.0, target_accept=0.234, init_range=(-4.0, 4.0))
    f1, f2, f4 = (ND_MCMC_CHECK_FNS[d] for d in (1, 2, 4))
    nd_mcmc_cases = [
        ("independence N(0,3) x Exp(1) -> N(0.5,1.5) x Exp(1.5)", f2,
         [tm.Distribution.normal(0.5, 1.5), tm.Distribution.exponential(1.5)],
         [tm.Distribution.normal(0.0, 3.0), tm.Distribution.exponential(1.0)],
         False),
        ("independence N(0,2)^2 -> c9e joint", f2, c9e_target(), [n02, n02],
         False),
        ("random walk -> c9e joint", f2, c9e_target(),
         tm.RandomWalk(**walk2), False),
        ("adaptive walk -> c9e joint", f2, c9e_target(),
         tm.RandomWalk(adapt=True, **walk2), False),
        ("independence N(0,2)^2 -> c9e joint, stderr", f2, c9e_target(),
         [n02, n02], True),
        ("d=1: independence N(0,2) -> joint N(0,1), stderr", f1,
         normal_target(), [n02], True),
        ("d=4: adaptive walk -> N x Exp x U x N, stderr", f4,
         [tm.Distribution.normal(0.5, 1.5), tm.Distribution.exponential(1.5),
          tm.Distribution.uniform(-1.0, 2.0), tm.Distribution.normal(-1.0, 0.5)],
         tm.RandomWalk(step_size=[1.0, 0.6, 0.8, 0.4], adapt=True), True),
    ]
    nd_mcmc_checks = [
        (name, nd_mcmc_setup(fns, target, proposal, MCMC_CHECK["n_steps"],
                             MCMC_CHECK["n_burnin"], stderr))
        for name, fns, target, proposal, stderr in nd_mcmc_cases
    ]

    # The tempered programs, each (program, config, params, ladder) as the
    # public path packs them: c12's and c12c's at the main shape (phase
    # 21's public calls take them from the cache), and phase 20's.
    c12_walk = tm.RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0))
    n06 = tm.Distribution.normal(0.0, 6.0)
    pt_cells = {"c12": c12_walk, "c12c": n06}

    def pt_setup(fns, target, proposal, temps, n_steps, n_burnin, stderr):
        parsed = integ._parse_nd_mcmc_args(target, proposal)
        return integ._pt_kernel_program(
            fns, proposal, parsed, tuple(1.0 / t for t in temps), n_steps,
            n_burnin, stderr)

    pt_main = {
        name: pt_setup(PT_FNS, logmix, proposal, PT_LADDER,
                       MCMC_MAIN["n_steps"], MCMC_MAIN["n_burnin"], True)
        for name, proposal in pt_cells.items()
    }
    # Each main program's ladder layout, one thread per ladder: the layout
    # the defaults are held against bit for bit, and the build whose SASS
    # holds the function's own instructions (the bounds).
    pt_ladders = {
        name: McmcPtProgram(prog.fns, cfg, prog.target, layout=LADDER_LAYOUT)
        for name, (prog, cfg, _, _) in pt_main.items()
    }
    pt_cases = [
        ("adaptive walk -> logmix, T=4", PT_FNS, logmix, c12_walk,
         PT_LADDER, False),
        ("walk -> N(1,2), T=3", PT_FNS, tm.Distribution.normal(1.0, 2.0),
         tm.RandomWalk(step_size=1.0, init_range=(-3.0, 5.0)),
         [1.0, 3.0, 9.0], False),
        ("independence N(0,6) -> logmix, T=4", PT_FNS, logmix, n06,
         PT_LADDER, False),
        ("independence N(0.5,1.5) x Exp(1) -> U(-1,2) x Exp(1.5), T=2", f2,
         [tm.Distribution.uniform(-1.0, 2.0), tm.Distribution.exponential(1.5)],
         [tm.Distribution.normal(0.5, 1.5), tm.Distribution.exponential(1.0)],
         [1.0, 2.5], False),
        ("walk -> c9e joint, T=5", f2, c9e_target(), tm.RandomWalk(**walk2),
         [1.0, 2.0, 4.0, 8.0, 16.0], False),
        ("adaptive walk -> logmix, T=4, stderr", PT_FNS, logmix, c12_walk,
         PT_LADDER, True),
        ("independence N(0,6) -> logmix, T=4, stderr", PT_FNS, logmix, n06,
         PT_LADDER, True),
    ]
    pt_checks = [
        (name, pt_setup(fns, target, proposal, temps, MCMC_CHECK["n_steps"],
                        MCMC_CHECK["n_burnin"], stderr))
        for name, fns, target, proposal, temps, stderr in pt_cases
    ]

    def timed_build(build):
        start = time.perf_counter()
        return build(), time.perf_counter() - start

    # One nvcc per kernel source and integrand set, all started together.
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=24)
    mcmc_builds = [
        pool.submit(timed_build, lambda p=p, c=c: p.library(c))
        for p, c in mcmc_libraries.values()
    ]
    nd_builds = [
        pool.submit(timed_build, p.library) for p in (nd_program, qmc_program)
    ]
    nd_mcmc_programs = list({
        id(prog): prog for prog, _, _ in
        [*nd_mcmc_main.values(), *(setup for _, setup in nd_mcmc_checks),
         (nd_count_program, None, None)]
    }.values())
    nd_mcmc_builds = [pool.submit(timed_build, p.library)
                      for p in nd_mcmc_programs]
    pt_programs = list({
        id(prog): prog for prog in
        [*(setup[0] for setup in pt_main.values()), *pt_ladders.values(),
         *(setup[0] for _, setup in pt_checks)]
    }.values())
    pt_builds = [pool.submit(timed_build, p.library) for p in pt_programs]
    probe_build = pool.submit(load_pipe_probe)
    # The 1-D kernel's new modes: one library per mode for the bench set,
    # and config 4's importance set (its integrand, the weight's unit
    # integrand of the diagnostics, and the two densities) with error
    # bars, as the public path builds it (phase 27 takes it from the
    # cache).
    mode_cfgs = {name: IntegrateConfig(*mode) for name, mode in MODES_1D.items()}
    MC_CFG = IntegrateConfig()
    is_target = tm.Distribution.normal(0.0, 1.0)
    is_proposal = tm.Distribution.normal(4.0, 1.5)
    is_program = integ._integrate_program(
        integ._trace_user_functions(IS_FNS) + (_unit_integrand(),),
        integ._is_weight(is_target, is_proposal),
    )
    is_cfg = IntegrateConfig("mc", True)
    mode_builds = {
        name: pool.submit(timed_build, lambda c=cfg: program.library(c))
        for name, cfg in mode_cfgs.items()
    }
    mode_builds["is"] = pool.submit(timed_build,
                                    lambda: is_program.library(is_cfg))
    # Phase 57's importance handle: config 4's set without the weight's
    # unit integrand, with error bars, as compile_importance_sampling
    # builds it.
    is_handle_program = integ._integrate_program(
        integ._trace_user_functions(IS_FNS),
        integ._is_weight(is_target, is_proposal))
    mode_builds["is_handle"] = pool.submit(
        timed_build, lambda: is_handle_program.library(is_cfg))
    # CUSTOM tables and table weights (phases 28-29): one library per
    # program, mode and route, as the public paths build them.
    custom_dists = {
        "strata": tm.Distribution.beta(2.0, 5.0),
        "gapped": tm.Distribution.mixture([tm.Distribution.uniform(-3.0, -1.0),
                                           tm.Distribution.uniform(1.0, 3.0)]),
        "knots": tm.Distribution.student_t(5.0),
    }
    custom_modes = {"mc": IntegrateConfig(), **mode_cfgs}
    table_target = tm.Distribution.from_pdf(untraceable_pdf, support=(-1.0, 1.0))
    u_2 = tm.Distribution.uniform(-2.0, 2.0)
    custom_is_fns = integ._trace_user_functions(CUSTOM_IS_FNS) + (_unit_integrand(),)
    # name: (program, proposal, modes)
    custom_is = {
        "table p, U(-2,2) q": (integ._integrate_program(
            custom_is_fns, integ._is_weight(table_target, u_2)), u_2,
            ("mc_stderr", "antithetic_stderr", "qmc")),
        "N(0.3,0.1) p, Beta(2,5)'s sampler q": (integ._integrate_program(
            custom_is_fns, (tm.trace_function(
                tm.Distribution.normal(0.3, 0.1)._pdf_func), SAMPLER)),
            custom_dists["strata"], ("mc_stderr", "antithetic_stderr", "qmc")),
        "table p, table q": (integ._integrate_program(
            custom_is_fns, integ._is_weight(table_target, table_target)),
            table_target, ("mc_stderr",)),
    }
    c3_beta = tm.Distribution.beta(2.0, 5.0, table_size=512)
    c3_tri = tm.Distribution.from_pdf(tri_pdf, support=(0.0, 2.0),
                                      table_size=512)
    c3_beta_program = integ._integrate_program(
        integ._trace_user_functions(C3_BETA_FNS))
    c3_tri_program = integ._integrate_program(
        integ._trace_user_functions(C3_TRI_FNS))
    # The importance set with a table target timed at 2**30: E[x] under a
    # Beta(2, 5) pdf table from a U(0, 1) proposal.
    grid_x = np.linspace(0.0, 1.0, 2048)
    is_table_target = tm.Distribution.from_pdf_table(
        grid_x, 30.0 * grid_x * (1.0 - grid_x) ** 4)
    is_table_proposal = tm.Distribution.uniform(0.0, 1.0)
    is_table_program = integ._integrate_program(
        integ._trace_user_functions(C3_TRI_FNS),
        integ._is_weight(is_table_target, is_table_proposal))

    def route_of(prog, dist):
        """The CUSTOM route ``prog`` draws ``dist`` on, or None."""
        spec_ = dist_spec_of(dist)
        if spec_.kind != DistKind.CUSTOM:
            return None
        return sampling_tables(dist, spec_, dev, with_pdf=prog.sampler).route

    custom_libs = {(id(prog), cfg, route): (prog, cfg, route)
                   for prog, cfg, route in [
        *((program, c, route_of(program, d)) for d in custom_dists.values()
          for c in custom_modes.values()),
        *((prog, custom_modes[m], route_of(prog, q))
          for prog, q, ms in custom_is.values() for m in ms),
        (c3_beta_program, MC_CFG, route_of(c3_beta_program, c3_beta)),
        (c3_tri_program, MC_CFG, route_of(c3_tri_program, c3_tri)),
        (is_table_program, IntegrateConfig("mc", True), None),
    ]}
    custom_builds = [
        pool.submit(timed_build, lambda p=p, c=c, r=r: p.library(c, r))
        for p, c, r in custom_libs.values()]

    # MCMC over CUSTOM tables (phases 30-33): config 5, c9f and c12d at the
    # main shape (their public calls take the programs from the cache),
    # each with the build its bound counts, and every table route held
    # against its plain version at phase 7's size; each run set up as the
    # public path sets it up (routes, parameter rows, device tables).
    c5_target = tm.Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    c5_proposal = tm.Distribution.uniform(-6.0, 6.0)
    beta25 = tm.Distribution.beta(2.0, 5.0)
    c9f_target, c9f_proposal = [beta25, n01], [beta25, n02]
    c12d_proposal = tm.Distribution.from_pdf(wide_pdf, support=(-7.0, 7.0))
    table_walk = tm.RandomWalk(step_size=1.0, adapt=True,
                               init_range=(-3.0, 3.0))

    def custom_mcmc_setup(fns, target, proposal, temps, n_steps, n_burnin,
                          stderr):
        """{"kernel", "plain"}: callables of a grid, and "program", "cfg",
        "k", "wrapper", "tabs" (its CUSTOM tables) and "bound_program"
        (the build the bounds count: one lane of the same group, or the
        ladder layout)."""
        parsed = integ._parse_nd_mcmc_args(target, proposal)
        if temps is not None:
            prog, cfg, params, ladder = integ._pt_kernel_program(
                fns, proposal, parsed, tuple(1.0 / t for t in temps),
                n_steps, n_burnin, stderr)
            tabs = nd_dim_tables(parsed[0], parsed[1], parsed[3], dev)
            return dict(
                kernel=lambda g: mcmc_pt_cuda(prog, cfg, params, ladder, SEED,
                                              g, tabs),
                plain=lambda g: mcmc_pt_reference(
                    prog.torch_fns, prog.torch_target, cfg, params, ladder,
                    SEED, g, tabs),
                program=prog, cfg=cfg, k=len(fns), wrapper=mcmc_pt_cuda,
                tabs=tabs, bound_program=McmcPtProgram(prog.fns, cfg, prog.target,
                                            layout=LADDER_LAYOUT))
        if parsed[2] is None and parsed[3] == 1:  # the 1-D kernel
            prog, cfg, params, tabs = integ._mcmc_kernel_program(
                integ._trace_user_functions(fns), target, proposal, n_steps,
                n_burnin, stderr)
            return dict(
                kernel=lambda g: mcmc_cuda(prog, cfg, params, SEED, g, tabs),
                plain=lambda g: mcmc_reference(prog.torch_fns, cfg, params,
                                               SEED, g, tabs),
                program=prog, cfg=cfg, k=len(fns), wrapper=mcmc_cuda,
                tabs=tabs, bound_program=McmcProgram(prog.fns, layout=Layout(
                    1, prog.layout_for(cfg).group)))
        prog, cfg, params = integ._nd_mcmc_kernel_program(
            fns, proposal, parsed, n_steps, n_burnin, stderr)
        tabs = nd_dim_tables(parsed[0], parsed[1], parsed[3], dev)
        return dict(
            kernel=lambda g: mcmc_nd_cuda(prog, cfg, params, SEED, g, tabs),
            plain=lambda g: mcmc_nd_reference(
                prog.torch_fns, prog.torch_target, cfg, params, SEED, g, tabs),
            program=prog, cfg=cfg, k=len(fns), wrapper=mcmc_nd_cuda,
            tabs=tabs, bound_program=McmcNdProgram(prog.fns, cfg, prog.target,
                                        layout=Layout(1, prog.layout.group)))

    # name: (functions, target, proposal, temperatures, closed forms)
    custom_mcmc_cells = {
        "config5": (C5_FNS, c5_target, c5_proposal, None, C5_EXACT),
        "c9f": (C9F_FNS, c9f_target, c9f_proposal, None, C9F_EXACT),
        "c12d": (C12D_FNS, c5_target, c12d_proposal, PT_LADDER, C12D_EXACT),
    }
    custom_mcmc_main = {
        name: custom_mcmc_setup(fns, target, proposal, temps,
                                SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"],
                                True)
        for name, (fns, target, proposal, temps, _) in custom_mcmc_cells.items()
    }
    f2c = ND_MCMC_CHECK_FNS[2][:2]
    custom_mcmc_cases = [
        ("1-D: config 5's table target under U(-6,6)", PT_FNS, c5_target,
         c5_proposal, None, False),
        ("1-D: Beta(2,5) sampler-mode proposal -> Beta(2,5), stderr", PT_FNS,
         beta25, beta25, None, True),
        ("1-D: gapped proposal -> table target", PT_FNS, c5_target,
         wide_gap(tm), None, False),
        ("1-D: walk -> table target", PT_FNS, c5_target,
         tm.RandomWalk(step_size=1.5), None, False),
        ("1-D: adaptive walk -> table target, stderr", PT_FNS, c5_target,
         table_walk, None, True),
        ("nd: c9f's sampler-mode dimension 0, stderr", f2c, c9f_target,
         c9f_proposal, None, True),
        ("nd: gapped proposal dimension last -> table target", f2c,
         [n01, c5_target], [n02, wide_gap(tm)], None, False),
        ("nd: adaptive walk -> table x N(0,1)", f2c, [c5_target, n01],
         table_walk, None, False),
        ("tempered: c12d's table target and proposal, T=4, stderr", PT_FNS,
         c5_target, c12d_proposal, PT_LADDER, True),
        ("tempered: adaptive walk -> table target, T=2", PT_FNS, c5_target,
         table_walk, [1.0, 2.0], False),
        ("tempered: sampler-mode dimension 0, T=2, stderr", f2c, c9f_target,
         c9f_proposal, [1.0, 2.5], True),
    ]
    custom_mcmc_checks = [
        (name, custom_mcmc_setup(fns, target, proposal, temps,
                                 MCMC_CHECK["n_steps"],
                                 MCMC_CHECK["n_burnin"], stderr))
        for name, fns, target, proposal, temps, stderr in custom_mcmc_cases
    ]

    def custom_mcmc_library(setup, bound=False):
        prog = setup["bound_program" if bound else "program"]
        return (prog.library(setup["cfg"]) if isinstance(prog, McmcProgram)
                else prog.library())

    custom_mcmc_builds = [
        pool.submit(timed_build, lambda s=s, b=b: custom_mcmc_library(s, b))
        for s, b in [*((s, b) for s in custom_mcmc_main.values()
                       for b in (False, True)),
                     *((s, False) for _, s in custom_mcmc_checks)]]

    # The tables the JAX package runs on its XLA sweep (phases 68-71),
    # started here: the cells' builds (and their one-lane and ladder twins
    # for the bounds), then each new route of the three kernels against its
    # plain version at MCMC_CHECK's shape.
    t5 = tm.Distribution.student_t(5.0)
    spike, gap_q = spiky_table(tm), outer_gap(tm)
    spike_walk = tm.RandomWalk(step_size=0.8, adapt=True,
                               init_range=(1.0, 3.0))
    # name: (phase, functions, target, proposal, temperatures, closed
    # forms, shape)
    xla_cells = {
        "c5b_t5": (69, MCMC_MAIN_FNS, n01, t5, None, [1.0], MCMC_MAIN),
        "spiky_walk": (69, SPIKE_FNS, spike, spike_walk, None, SPIKE_EXACT,
                       SHORT_MCMC),
        "c9f_t5": (70, C9F_FNS, c9f_target,
                   [beta25, tm.Distribution.student_t(5.0, 0.0, 2.0)], None,
                   C9F_EXACT, SHORT_MCMC),
        "c12d_t5": (71, C12D_FNS, c5_target,
                    tm.Distribution.student_t(5.0, 0.0, 3.0), PT_LADDER,
                    C12D_EXACT, SHORT_MCMC),
        "c12d_gapped": (71, C12D_FNS, c5_target, gap_q, PT_LADDER,
                        C12D_EXACT, SHORT_MCMC),
    }
    xla_main = {
        name: custom_mcmc_setup(fns, target, proposal, temps,
                                shape["n_steps"], shape["n_burnin"], True)
        for name, (_, fns, target, proposal, temps, _, shape)
        in xla_cells.items()}
    xla_cases = [
        ("1-D: the gapped mixture as proposal (knots) and target (irregular)",
         PT_FNS, tm.Distribution.mixture([tm.Distribution.uniform(-3.0, -1.0),
                                          tm.Distribution.uniform(1.0, 3.0)]),
         tm.Distribution.mixture([tm.Distribution.uniform(-3.0, -1.0),
                                  tm.Distribution.uniform(1.0, 3.0)]),
         None, False),
        ("1-D: a 1,000-knot inverse (full, uniform q) -> Beta(2,5)", PT_FNS,
         beta25, short_inverse(tm, tm.Distribution.beta(2.0, 5.0)), None,
         False),
        ("1-D: the spiky table's 1,000-knot inverse (full, irregular q)",
         PT_FNS, tm.Distribution.normal(2.0, 0.8),
         short_inverse(tm, spiky_table(tm)), None, False),
        ("1-D: HMC on the spiky table (irregular target, knot slopes)",
         PT_FNS, spike, tm.HMC(step_size=0.2, n_leapfrog=4,
                               init_range=(1.0, 3.0)), None, False),
        ("nd: full route with an irregular target dimension", f2c,
         [spike, n01], [short_inverse(tm, spiky_table(tm)), n02], None, False),
        ("tempered: full route -> irregular target, T=2", PT_FNS, spike,
         short_inverse(tm, spiky_table(tm)), [1.0, 2.0], False),
        ("tempered: adaptive walk -> irregular target, T=2", PT_FNS, spike,
         spike_walk, [1.0, 2.0], False),
    ]
    xla_checks = [
        (name, custom_mcmc_setup(fns, target, proposal, temps,
                                 MCMC_CHECK["n_steps"],
                                 MCMC_CHECK["n_burnin"], stderr))
        for name, fns, target, proposal, temps, stderr in xla_cases]
    # The checks phase 68 also times and bounds at their shape, by their
    # record's name: the full route with a uniform and with an irregular
    # q-table, and HMC on an irregular target.
    xla_timed = {xla_cases[1][0]: "full_uniform_q",
                 xla_cases[2][0]: "full_irregular_q",
                 xla_cases[3][0]: "hmc_irregular_target"}
    # The wide sets and control variates (phases 64-67), each group's
    # library started here as the public paths make it: c7's K = 128 and
    # 256 histograms over Beta(2, 5)'s 2048-entry table (one and two groups
    # of 128) and the K = 128 one with error bars; the K = 254 and 252 MCMC
    # sets over c5b, c9e and c12 (groups of 127 and 126) with error bars,
    # each group with the build its bound counts where that differs (the
    # tempered ladder; the 1-D and nd groups run one lane a chain); the
    # control-variate set's composed groups, 174 integrands and 206 with
    # error bars.
    c7_beta = tm.Distribution.beta(2.0, 5.0, table_size=C7_TABLE_SIZE)
    c7_groups = {k: integ._integrate_groups(tuple(
        tm.trace_function(f) for f in hist_fns(k))) for k in (128, 256)}
    c7_route = route_of(c7_groups[128][0], c7_beta)
    stderr_cfg = IntegrateConfig("mc", True)
    wide_mcmc_cells = {
        "c5b": (n01, n02, None, mcmc_cuda),
        "c9e": (c9e_target(), [n02, n02], None, mcmc_nd_cuda),
        "c12": (logmix, c12_walk, PT_LADDER, mcmc_pt_cuda),
    }

    def wide_mcmc_setups(shape):
        """Each wide MCMC cell's groups as ``custom_mcmc_setup`` sets them
        up at ``shape`` (one program per group: the libraries do not
        depend on the depth)."""
        return {
            name: [custom_mcmc_setup(group, target, proposal, temps,
                                     shape["n_steps"], shape["n_burnin"], True)
                   for group in split_groups(
                       tuple(tm.trace_function(f, 2 if name == "c9e" else 1)
                             for f in WIDE_MCMC_FNS[name]),
                       MCMC_MAX_FUNCTIONS if temps is None
                       else MAX_PT_FUNCTIONS)]
            for name, (target, proposal, temps, _) in wide_mcmc_cells.items()}

    wide_mcmc = wide_mcmc_setups(MCMC_CHECK)
    cv_traced = tuple(tm.trace_function(f) for f in CV_FNS)
    cv_controls = tuple(tm.trace_function(g) for g, _ in CV_CONTROLS)
    cv_groups = {
        stderr: integ._integrate_groups(
            cv_composed(cv_traced, cv_controls, [n01], stderr)[0])
        for stderr in (False, True)}

    def one_lane(setup):
        """Whether the group's running build runs one lane a chain (its
        bound counts that build)."""
        prog_ = setup["program"]
        if isinstance(prog_, McmcProgram):
            return prog_.layout_for(setup["cfg"]).lanes == 1
        return isinstance(prog_, McmcNdProgram) and not isinstance(
            prog_, McmcPtProgram) and prog_.layout.lanes == 1

    wide_libs = [
        *(lambda p=p, c=c: p.library(c, c7_route) for p, c in
          [*((p, MC_CFG) for k in (128, 256) for p in c7_groups[k]),
           (c7_groups[128][0], stderr_cfg)]),
        *(lambda s=s, b=b: custom_mcmc_library(s, b)
          for setups in wide_mcmc.values() for s in setups
          for b in ((False,) if one_lane(s) else (False, True))),
        *(lambda p=p: p.library(MC_CFG)
          for groups in cv_groups.values() for p in groups),
    ]
    wide_builds = [pool.submit(timed_build, b) for b in wide_libs]

    # The extended families (phases 34-38), each library started here: the
    # bench set's own library per family and 1-D mode; the family cells at
    # the main shapes (c5b's, c9's, c9e's and c12's, each with the build
    # its bound counts) and the family checks of the three MCMC kernels and
    # the nd kernel; the parity checks' sets as their public calls build
    # them.
    family_dists = {name: getattr(tm.Distribution, name)(*args)
                    for name, args in FAMILY_ARGS.items()}
    family_kinds = {name: dist_spec_of(d).kind
                    for name, d in family_dists.items()}
    family_cfgs = {"mc": MC_CFG, **mode_cfgs}
    fam_laplace = tm.Distribution.laplace(3.0, 1.0)
    fam_gumbel = tm.Distribution.gumbel(1.0, 0.5)
    # name: (functions, target, proposal, temperatures, closed forms)
    family_mcmc_cells = {
        "c5b_family": (FAM_C5B_FNS, fam_laplace,
                       tm.Distribution.logistic(0.0, 2.0), None,
                       FAM_C5B_EXACT),
        "c9e_family": (FAM_ND_FNS, [fam_laplace, fam_gumbel],
                       [tm.Distribution.logistic(3.0, 1.0),
                        tm.Distribution.gumbel(1.0, 0.8)], None,
                       FAM_ND_EXACT),
        "c12_family": (FAM_PT_FNS, fam_laplace, c12_walk, PT_LADDER,
                       FAM_PT_EXACT),
    }
    family_mcmc_main = {
        name: custom_mcmc_setup(fns, target, proposal, temps,
                                SHORT_MCMC["n_steps"],
                                SHORT_MCMC["n_burnin"], True)
        for name, (fns, target, proposal, temps, _)
        in family_mcmc_cells.items()
    }
    fam = family_dists
    family_mcmc_cases = [
        ("1-D: Cauchy(0,2) -> Cauchy(0,1)", PT_FNS, fam["cauchy"],
         tm.Distribution.cauchy(0.0, 2.0), None, False),
        ("1-D: walk -> Gumbel(1,0.5)", PT_FNS, fam["gumbel"],
         tm.RandomWalk(step_size=0.6), None, False),
        ("1-D: Pareto(0.2,1.5) -> Weibull(1.5,2)", PT_FNS, fam["weibull"],
         tm.Distribution.pareto(0.2, 1.5), None, False),
        ("1-D: adaptive walk -> Pareto(1,3), stderr", PT_FNS, fam["pareto"],
         tm.RandomWalk(adapt=True), None, True),
        ("1-D: Gumbel(1,0.6) -> Lognormal(0,0.5)", PT_FNS, fam["lognormal"],
         tm.Distribution.gumbel(1.0, 0.6), None, False),
        ("nd: adaptive walk -> Cauchy(0,1) x Laplace(3,1)", f2c,
         [fam["cauchy"], fam_laplace],
         tm.RandomWalk(step_size=[2.0, 1.0], adapt=True), None, False),
        ("nd: Weibull(1.5,2) x Logistic(1,1) -> Lognormal x Gumbel, stderr",
         f2c, [fam["lognormal"], fam_gumbel],
         [fam["weibull"], tm.Distribution.logistic(1.0, 1.0)], None, True),
        ("tempered: Cauchy proposals -> Laplace(3,1) x Logistic(0,2), T=2",
         f2c, [fam_laplace, fam["logistic"]],
         [tm.Distribution.cauchy(3.0, 1.0), tm.Distribution.cauchy(0.0, 2.0)],
         [1.0, 2.5], False),
        ("tempered: adaptive walk -> Gumbel(1,0.5), T=3, stderr", PT_FNS,
         fam_gumbel, tm.RandomWalk(step_size=0.5, adapt=True,
                                   init_range=(0.0, 2.0)),
         [1.0, 2.0, 4.0], True),
    ]
    family_mcmc_checks = [
        (name, custom_mcmc_setup(fns, target, proposal, temps,
                                 MCMC_CHECK["n_steps"],
                                 MCMC_CHECK["n_burnin"], stderr))
        for name, fns, target, proposal, temps, stderr in family_mcmc_cases
    ]
    # nd: c9's shape over Lognormal(0,0.5) x Gumbel(1,0.5), and every
    # family as a dimension, four and three (beside N(0,1)) at a time.
    fam_c9_dists = [fam["lognormal"], fam["gumbel"]]
    fam_c9_kinds = tuple(dist_spec_of(d).kind for d in fam_c9_dists)
    fam_c9_traced = tuple(tm.trace_function(f, 2) for f in FAM_C9_FNS)
    fam_c9_program = GLOBAL_CACHE.get_or_build(
        ("integrate_nd", fns_key(fam_c9_traced), fam_c9_kinds),
        lambda: IntegrateNdProgram(fam_c9_traced, fam_c9_kinds))
    fam_nd_fns = [lambda a, b, c, d: np.exp(-a * a) * c + d,
                  lambda a, b, c, d: (b > 1.0) + a * d]
    fam_nd_dims = [
        [fam[n] for n in ("lognormal", "cauchy", "laplace", "logistic")],
        [fam[n] for n in ("gumbel", "weibull", "pareto")] + [n01],
    ]
    fam_nd_programs = [
        IntegrateNdProgram(tuple(tm.trace_function(f, 4) for f in fam_nd_fns),
                           tuple(dist_spec_of(d).kind for d in dims))
        for dims in fam_nd_dims]
    # The parity checks' sets (phase 38), as their public calls build them.
    parity_mean_program = integ._integrate_program(
        integ._trace_user_functions(PARITY_MEAN_FNS))
    parity_cauchy_program = integ._integrate_program(
        integ._trace_user_functions(PARITY_CAUCHY_FNS))
    parity_mcmc = integ._mcmc_kernel_program(
        integ._trace_user_functions(PARITY_MEAN_FNS), fam_laplace,
        tm.Distribution.logistic(0.0, 2.0), 4000, 500, False)
    family_libs = [
        *((program, c, k) for k in family_kinds.values()
          for c in family_cfgs.values()),
        *((parity_mean_program, IntegrateConfig("mc", True),
           family_kinds[name]) for name, _, _ in PARITY_MEANS),
        (parity_cauchy_program, MC_CFG, DistKind.CAUCHY),
        (parity_mean_program, mode_cfgs["qmc"], DistKind.WEIBULL),
    ]
    family_builds = [
        *(pool.submit(timed_build, lambda p=p, c=c, k=k: p.library(c, k))
          for p, c, k in family_libs),
        *(pool.submit(timed_build, lambda s=s, b=b: custom_mcmc_library(s, b))
          for s, b in [*((s, b) for s in family_mcmc_main.values()
                         for b in (False, True)),
                       *((s, False) for _, s in family_mcmc_checks)]),
        *(pool.submit(timed_build, p.library)
          for p in [fam_c9_program, *fam_nd_programs]),
        pool.submit(timed_build,
                    lambda: parity_mcmc[0].library(parity_mcmc[1])),
    ]
    # nd over CUSTOM dimensions and nd importance sets (phases 39-43): one
    # library per program and tuple of routes, every route and weight kind
    # of phase 39 and the main paths' programs as their public calls build
    # them (they take the programs from the cache).
    from tpu_montecarlo_torch.api.device import nd_tables
    D = tm.Distribution
    beta_tab = beta25_table(tm)
    u01, e2 = D.uniform(0.0, 1.0), D.exponential(2.0)
    beta33, beta153 = D.beta(3.0, 3.0), D.beta(1.5, 3.0)
    grid_g = np.linspace(0.0, 1.0, 2048)
    gapped_u = D.from_pdf_table(grid_g, np.where(
        (grid_g > 0.4) & (grid_g < 0.6), 0.0, 1.0))
    student5 = D.student_t(5.0)
    spiky_x = np.unique(np.concatenate([np.linspace(0.0, 1.0, 300),
                                        0.5 + np.geomspace(1e-5, 1e-3, 60)]))
    spiky = D.from_pdf_table(spiky_x, 1.0 + 50.0 * np.exp(
        -(((spiky_x - 0.5) / 1e-5) ** 2)))
    nd_f2 = [lambda x, y: x * y, lambda x, y: x + y * y]
    nd_f3 = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y - z]
    all_modes = [("mc", False), ("antithetic", False), ("qmc", False),
                 ("mc", True), ("antithetic", True)]
    # name: (functions, proposals, targets or None, modes); an importance
    # set carries the diagnostics' weight column.
    nd_new_cases = {
        "strata, Beta(2,5) x U(0,1)": (nd_f2, [beta25, u01], None, all_modes),
        "strata + flat, Beta(2,5) x Beta(3,3)": (
            nd_f2, [beta25, beta33], None,
            [("mc", False), ("antithetic", True), ("qmc", False)]),
        "gapped strata, gapped x U(0,1)": (
            nd_f2, [gapped_u, u01], None, [("mc", False), ("antithetic", True)]),
        "flat gapped, U(0,1) x gapped": (nd_f2, [u01, gapped_u], None,
                                         [("mc", True)]),
        "knots, Student-t(5) x N(0,1)": (nd_f2, [student5, n01], None,
                                         [("mc", True), ("qmc", False)]),
        "IS traced, N(3.5,1.5)^2 -> N(0,1)^2": (
            ND_RARE_FNS, [D.normal(3.5, 1.5)] * 2, [n01, n01],
            [("mc", True), ("antithetic", False), ("qmc", False)]),
        "IS table p, sampler q": (
            ND_TS_FNS, [beta153, D.normal(0.0, 1.5)], [beta_tab, n01],
            [("mc", False), ("antithetic", True), ("qmc", False)]),
        "IS two sampler q (strata, flat)": (
            nd_f2, [beta153, beta33], [beta25, beta_tab], [("mc", True)]),
        "IS three CUSTOM dims, d=3": (
            nd_f3, [beta153, beta33, D.beta(2.0, 2.0)],
            [beta_tab, beta25, D.beta(2.0, 2.0)], [("mc", True)]),
        "IS knot p, U(0,1) x N(0,1)": (nd_f2, [u01, n01], [spiky, n01],
                                       [("mc", True)]),
        "IS heavy and gapped q": (
            nd_f2, [student5, gapped_u], [n01, u01], [("mc", True)]),
    }

    def nd_new_program(fns, props, targs, diagnostics=True):
        """The program as integrate() or integrate_importance_sampling()
        builds it (with the diagnostics' weight column unless told
        otherwise), from the cache."""
        traced_ = integ._trace_user_functions(fns, n_args=len(props))
        kinds_ = tuple(dist_spec_of(q).kind for q in props)
        if targs is None:
            return integ._nd_program(traced_, kinds_)
        weight_ = tuple(integ._is_weight_dim(t, q)
                        for t, q in zip(targs, props))
        unit = (_unit_integrand(len(props)),) if diagnostics else ()
        return integ._nd_program(traced_ + unit, kinds_, weight_)

    def nd_new_setup(prog, props, method, stderr):
        cfg_ = NdConfig(prog.kinds, method, stderr)
        return cfg_, nd_tables(props, cfg_, dev, prog.sampler_dims)

    nd_new_checks = [
        (case, nd_prog, nd_props, *nd_new_setup(nd_prog, nd_props, *mode))
        for case, nd_prog, nd_props, modes_ in (
            (c, nd_new_program(f, q, t), q, m)
            for c, (f, q, t, m) in nd_new_cases.items())
        for mode in modes_]
    nd_new_main = {
        "c9b": (nd_new_program(C9B_FNS, [beta25, u01], None), [beta25, u01],
                "mc", False),
        "c9_custom": (nd_new_program(ND_FNS, [beta25, u01, e2], None),
                      [beta25, u01, e2], "mc", False),
        "rare": (nd_new_program(ND_RARE_FNS, [D.normal(3.5, 1.5)] * 2,
                                [n01, n01]), [D.normal(3.5, 1.5)] * 2,
                 "mc", True),
    }
    ts_props = [beta153, D.normal(0.0, 1.5)]
    nd_new_main["table_sampler"] = (
        nd_new_program(ND_TS_FNS, ts_props, [beta_tab, n01],
                       diagnostics=False), ts_props, "mc", True)
    nd_new_libs = {(id(c[1]), nk_routes(*c[3:])): c[1] for c in nd_new_checks}
    nd_new_libs.update(
        ((id(m[0]), nk_routes(*nd_new_setup(*m))), m[0])
        for m in nd_new_main.values())
    nd_new_builds = [
        pool.submit(timed_build, lambda p=p, r=r: p.library(r))
        for (_, r), p in nd_new_libs.items()]
    # Split-R-hat, ESS and thinned draws (phases 44-47): c5b, c9e and c12
    # with both outputs, as their public calls build them (they take the
    # programs from the cache); the slow-mixing run's; c12's ladder layout
    # with both.
    c5b_out = integ._mcmc_kernel_program(
        mcmc_traced, n01, n02, SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"],
        True, True, DRAWS)
    slow_out = integ._mcmc_kernel_program(
        integ._trace_user_functions(SLOW_FNS), n01,
        tm.Distribution.normal(*SLOW_PROPOSAL),
        SLOW_RUN["n_steps"], SLOW_RUN["n_burnin"], False, True, 0)
    c9e_fns_, c9e_target_, c9e_proposal_, _ = nd_mcmc_cells["c9e"]
    c9e_out = integ._nd_mcmc_kernel_program(
        c9e_fns_, c9e_proposal_,
        integ._parse_nd_mcmc_args(c9e_target_, c9e_proposal_),
        SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"], True, True, DRAWS)
    c12_parsed = integ._parse_nd_mcmc_args(logmix, c12_walk)
    c12_out = integ._pt_kernel_program(
        PT_FNS, c12_walk, c12_parsed, tuple(1.0 / t for t in PT_LADDER),
        SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"], True, True, DRAWS)
    c12_ladder_out = McmcPtProgram(c12_out[0].fns, c12_out[1],
                                   c12_out[0].target, layout=LADDER_LAYOUT)
    outputs_builds = [
        pool.submit(timed_build, build) for build in [
            lambda: c5b_out[0].library(c5b_out[1]),
            lambda: slow_out[0].library(slow_out[1]),
            c9e_out[0].library, c12_out[0].library, c12_ladder_out.library]]
    # HMC and chain state (phases 48-51): c11 and c11c as their public calls
    # build them, and at the other groups of HMC_GROUPS; c5b's and c9e's
    # two-call runs, fresh (with_state) and resumed (use_init_state).
    hmc_out = {}
    for name, (fns, step, _) in HMC_CELLS.items():
        hmc_ = tm.HMC(step_size=step, n_leapfrog=HMC_LEAPFROG, adapt=True)
        target_ = n01 if name == "c11" else beta25
        prog, cfg, params, tabs = integ._mcmc_kernel_program(
            integ._trace_user_functions(fns), target_, hmc_,
            SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"], False)
        group = prog.layout_for(cfg).group
        hmc_out[name] = dict(
            fns=fns, target=target_, hmc=hmc_, program=prog, cfg=cfg,
            params=params, tables=tabs,
            layouts={g: prog if g == group else McmcProgram(
                prog.fns, layout=Layout(1, g)) for g in HMC_GROUPS})
    c9e_parsed = integ._parse_nd_mcmc_args(c9e_target_, c9e_proposal_)
    state_out = {}
    for resume in (False, True):
        burn = 0 if resume else MCMC_MAIN["n_burnin"]
        state_out["c5b", resume] = integ._mcmc_kernel_program(
            mcmc_traced, n01, n02, STATE_STEPS, burn, False,
            with_state=True, use_init_state=resume)
        state_out["c9e", resume] = integ._nd_mcmc_kernel_program(
            c9e_fns_, c9e_proposal_, c9e_parsed, STATE_STEPS, burn, False,
            with_state=True, use_init_state=resume)
    hmc_state_builds = [
        pool.submit(timed_build, build) for build in [
            *(lambda p=p, c=o["cfg"]: p.library(c)
              for o in hmc_out.values() for p in o["layouts"].values()),
            *(lambda o=o: o[0].library(o[1])
              for key, o in state_out.items() if key[0] == "c5b"),
            *(o[0].library for key, o in state_out.items()
              if key[0] == "c9e")]]
    # nd and tempered HMC (phases 52-53): c11b and c12b as their public
    # calls build them, and at each layout they are timed at.
    hmc_nd_out = {}
    for name, cell in HMC_ND_CELLS.items():
        hmc_ = tm.HMC(**cell["hmc"])
        target_ = cell["target"]()
        parsed_ = integ._parse_nd_mcmc_args(target_, hmc_)
        shape_ = (SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"], True)
        if cell["temps"] is None:
            prog, cfg, params = integ._nd_mcmc_kernel_program(
                cell["fns"], hmc_, parsed_, *shape_)
            ladder = None
            layouts = {f"(1, {g})": McmcNdProgram(prog.fns, cfg, prog.target,
                                                  layout=Layout(1, g))
                       for g in HMC_GROUPS}
        else:
            prog, cfg, params, ladder = integ._pt_kernel_program(
                cell["fns"], hmc_, parsed_,
                tuple(1.0 / t for t in cell["temps"]), *shape_)
            t_lanes = prog.layout.rung_lanes
            layouts = {str(tuple(lay)): McmcPtProgram(prog.fns, cfg,
                                                      prog.target, layout=lay)
                       for lay in [PtLayout(t_lanes, 1, g)
                                   for g in HMC_GROUPS] + [LADDER_LAYOUT]}
        layouts = {k: prog if p.layout == prog.layout else p
                   for k, p in layouts.items()}
        hmc_nd_out[name] = dict(target=target_, hmc=hmc_, program=prog,
                                cfg=cfg, params=params, ladder=ladder,
                                layouts=layouts)
    hmc_nd_builds = [
        pool.submit(timed_build, p.library)
        for o in hmc_nd_out.values() for p in o["layouts"].values()]
    # Phase 68's libraries last: the queue builds them after every earlier
    # phase's.
    xla_builds = [
        pool.submit(timed_build, lambda s=s, b=b: custom_mcmc_library(s, b))
        for s, b in [*((s, b) for s in xla_main.values()
                       for b in (False, True)),
                     *((s, False) for _, s in xla_checks),
                     *((s, True) for n, s in xla_checks if n in xla_timed)]]
    # expectation_fn's gradient builds (phases 72-74) after them: the bench
    # set's in each method and under each extended family, c9's nd set's;
    # and the importance set of phase 75's learned proposal (the public
    # path's program: IS_FNS weighted by the target's traced density over
    # the CUSTOM proposal's own sampling density, on the strata route), its
    # table learned here on the host.
    grad_cfgs = {m: IntegrateConfig(m, grad=True)
                 for m in ("mc", "antithetic", "qmc")}
    grad_routes = [(grad_cfgs[m], None) for m in grad_cfgs] + [
        (grad_cfgs["mc"], kind) for kind in family_kinds.values()]
    grad_builds = [
        *(pool.submit(timed_build, lambda c=c, r=r: program.library(c, r))
          for c, r in grad_routes),
        pool.submit(timed_build, lambda: nd_program.library(None, True))]
    adapt_cpu, adapt_cpu_hist = tm.adapt_proposal(
        IS_FNS[0], is_target, support=ADAPT_SUPPORT, device="cpu",
        return_history=True)
    adapt_program = integ._integrate_program(
        integ._trace_user_functions(IS_FNS),
        integ._is_weight(is_target, adapt_cpu))
    grad_builds.append(pool.submit(
        timed_build, lambda: adapt_program.library(is_cfg, "strata")))
    lib = program.library()
    build_s = time.perf_counter() - t0
    print(f"phase 2: built the integrate kernel in {build_s:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. Kernel against the plain version, three families, 2**24 samples.
    grid = plan_grid(make_integrate_plan(CHECK_SAMPLES).actual_samples)
    families = [
        tm.Distribution.uniform(-1.0, 2.0),
        tm.Distribution.normal(0.5, 1.5),
        tm.Distribution.exponential(2.0),
    ]

    def kernel_vs_plain(dist, grid, phase: str) -> float:
        """Means of the kernel and of the plain version on the same
        samples; fails unless they agree.  Returns the max abs diff."""
        spec = dist_spec_of(dist)
        params = torch.tensor(spec.params, device=dev)
        n = grid.actual_samples
        got = integrate_cuda(program, spec.kind, params, SEED, grid)
        want = integrate_reference(
            program.torch_values, spec.kind, params, SEED, grid
        )
        got = got.double().cpu().numpy() / n
        want = want.double().cpu().numpy() / n
        err = np.abs(got - want)
        name = f"{spec.kind.name.lower()} at {n} samples"
        print(f"phase {phase}: {name}: kernel {got}")
        print(f"         plain  {want}  max|diff| {err.max():.3e}")
        if not np.all(np.isfinite(got)):
            fail(f"{name}: non-finite kernel means {got}")
        if not np.all(err <= RTOL * np.abs(want) + ATOL):
            fail(f"{name}: kernel and plain version disagree")
        return float(err.max())

    max_abs_err = max(kernel_vs_plain(d, grid, "3") for d in families)

    # 4. The main path, through the public API, counted.
    integrate_cuda.launches = 0
    t0 = time.perf_counter()
    result = tm.integrate(
        BENCH_FNS, tm.Distribution.normal(0.0, 1.0),
        n_samples=MAIN_SAMPLES, seed=SEED,
    )
    main_s = time.perf_counter() - t0
    launches = integrate_cuda.launches
    main_grid = plan_grid(make_integrate_plan(MAIN_SAMPLES).actual_samples)
    n_main = main_grid.actual_samples
    print(f"phase 4: integrate(8 fns, N(0,1), n_samples={MAIN_SAMPLES}) "
          f"drew {n_main} samples in {main_s:.3f} s (host clock), "
          f"{launches} kernel launch(es)")
    if launches < 1:
        fail("the main path did not launch the integrate kernel")
    values = np.asarray(result.values)
    if values.shape != (len(BENCH_FNS),) or not np.all(np.isfinite(values)):
        fail(f"bad main-path result {values!r}")
    for j, (v, mu, var) in enumerate(zip(values, BENCH_MEANS, BENCH_VARS)):
        sigma = math.sqrt(var / n_main)
        z = (v - mu) / sigma
        print(f"  f{j}: {v:+.7f}  closed form {mu:+.7f}  z = {z:+.2f}")
        if abs(z) > 6.0:
            fail(f"f{j} is {z:.1f} sigma from its closed form")

    # 5. Kernel and plain version at the main path's shape: 1e9 samples.
    normal = tm.Distribution.normal(0.0, 1.0)
    max_abs_err = max(max_abs_err, kernel_vs_plain(normal, main_grid, "5"))
    spec = dist_spec_of(normal)
    params = torch.tensor(spec.params, device=dev)
    ms = time_ms(
        lambda: integrate_cuda(program, spec.kind, params, SEED, main_grid),
        reps=10,
    )
    plain_ms = time_ms(
        lambda: integrate_reference(
            program.torch_values, spec.kind, params, SEED, main_grid
        ),
        reps=2,
    )
    # End to end, as a user calls it (tracing, planning, cached program,
    # launch, second-pass sum, copy of the means to the host).
    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        tm.integrate(BENCH_FNS, normal, n_samples=MAIN_SAMPLES, seed=SEED)
        call_s.append(time.perf_counter() - t0)
    call_ms = float(np.median(call_s)) * 1e3
    print(f"phase 5: {n_main} samples, K=8, N(0,1) on {card}: kernel "
          f"{ms:.3f} ms ({n_main / ms * 1e3:.4e} samples/s), plain "
          f"{plain_ms:.3f} ms ({n_main / plain_ms * 1e3:.4e} samples/s), "
          f"integrate() end to end {call_ms:.3f} ms median of 5, host clock "
          f"({n_main / call_ms * 1e3:.4e} samples/s)")
    mhz = clock_under_load(
        lambda: integrate_cuda(program, spec.kind, params, SEED, main_grid), ms
    )
    # The bound of the build that runs; beside it, like for like with
    # earlier runs, the count on the SASS of the kernel before its
    # redesign, stored in the checkout.
    integrate_bound = card_bound(lib, "integrate_kernelILi1EE", 1, n_main,
                                 mhz)
    integrate_parent = card_bound(
        None, "integrate_kernelILi1EE", 1, n_main, mhz,
        listing=(PARENT_SASS / "integrate_n.sass").read_text())
    print_bound(integrate_bound, mhz, "sample")
    print_parent_bound(integrate_parent, "sample")
    idle_share(lambda: tm.integrate(BENCH_FNS, normal,
                                    n_samples=MAIN_SAMPLES, seed=SEED))

    # 6. The MCMC kernel's builds, started in phase 2.
    built = [b.result() for b in mcmc_builds]
    pool.shutdown()
    print(f"phase 6: built the MCMC kernel for {len(built)} integrand sets,"
          " modes, families and layouts ([x*x]: c5b, its one-lane build "
          "for the bound and the adaptive walk; 4 functions: phase 7's) in "
          + ", ".join(f"{sec:.1f}" for _, sec in built)
          + " s (in parallel with phase 2)")
    for mcmc_lib, _ in built:
        for line in mcmc_lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 7. MCMC kernel against the plain version in every mode.
    def mcmc_vs_plain(prog, cfg, row, grid, phase: str):
        """Runs the kernel and the plain version on the same chains and
        fails unless they agree (tolerances in the docstring).  Returns
        (the max abs difference of the means, the plain version's
        milliseconds by CUDA events)."""
        params = torch.tensor(row, dtype=torch.float32, device=dev)
        got = mcmc_cuda(prog, cfg, params, SEED, grid)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mcmc_reference(prog.torch_fns, cfg, params, SEED, grid)
        end.record()
        end.synchronize()
        err = chains_agree(got, want, grid, cfg, len(prog.fns), phase)
        return err, start.elapsed_time(end)

    def chains_agree(got, want, grid, cfg, k, phase: str,
                     max_split: float = 0.0) -> float:
        """Fails unless two runs of the same chains (kernel and plain
        version, 1-D or nd) agree: no more than ``max_split`` of the
        chains split (none, but for the tempered kernel).  Returns the max
        abs difference of the means."""
        # A chain splits when any of its dimensions ends apart.
        x_k = got.x_final.reshape(-1, grid.chains_actual)
        x_p = want.x_final.reshape(-1, grid.chains_actual)
        split = float(
            ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0)
            .float().mean()
        )
        v_k, a_k, s_k = mcmc_finish(got, grid, cfg, k)
        v_p, a_p, s_p = mcmc_finish(want, grid, cfg, k)
        # Every block carries its SS and centroid rows: the error bars of
        # a run of any config (a stateful one's as stateless).
        _, _, se = mcmc_finish(want, grid, replace(
            cfg, with_stderr=True, with_state=False, use_init_state=False), k)
        v_k, v_p, se = (t.double().cpu().numpy() for t in (v_k, v_p, se))
        err = np.abs(v_k - v_p)
        print(f"phase {phase}: kernel {v_k} acc {float(a_k):.6f}")
        print(f"         plain  {v_p} acc {float(a_p):.6f}  max|diff| "
              f"{err.max():.3e} ({(err / se).max():.3f} stderr), "
              f"split chains {split:.4%}")
        if not (np.all(np.isfinite(v_k)) and torch.isfinite(x_k).all()):
            fail(f"phase {phase}: non-finite kernel output")
        if split > max_split:
            fail(f"phase {phase}: {split:.4%} of the chains split")
        if abs(float(a_k) - float(a_p)) > 1e-3:
            fail(f"phase {phase}: acceptance rates disagree")
        if not np.all(err < 0.2 * se + 1e-6):
            fail(f"phase {phase}: kernel and plain means disagree")
        if cfg.with_stderr:
            s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
            print(f"         stderr kernel {s_k} plain {s_p}")
            if not np.allclose(s_k, s_p, rtol=STDERR_RTOL, atol=0.0):
                fail(f"phase {phase}: error bars disagree")
        return float(err.max())

    check_grid = plan_mcmc_grid(plan_chains(MCMC_CHECK["n_chains"], None))
    mcmc_err = 0.0
    for name, mode, prop, targ, row, stderr in mcmc_cases:
        print(f"phase 7: {name}, {check_grid.chains_actual} chains x "
              f"({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) steps")
        cfg = McmcConfig(mode, prop, targ, MCMC_CHECK["n_steps"],
                         MCMC_CHECK["n_burnin"], stderr)
        mcmc_err = max(mcmc_err, mcmc_vs_plain(
            check_program, cfg, row, check_grid, "7")[0])

    # 8. The MCMC main path, through the public API, counted.
    target, proposal = tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(0.0, 2.0)
    mcmc_cuda.launches = mcmc_cuda.pilot_launches = 0
    t0 = time.perf_counter()
    r = tm.integrate_mcmc(MCMC_MAIN_FNS, target, proposal,
                          return_stderr=True, **MCMC_MAIN)
    main_s = time.perf_counter() - t0
    mcmc_launches = mcmc_cuda.launches
    pilot_launches = mcmc_cuda.pilot_launches
    chain_steps = MCMC_MAIN["n_chains"] * (
        MCMC_MAIN["n_steps"] + MCMC_MAIN["n_burnin"]
    )
    print(f"phase 8: integrate_mcmc([x*x], N(0,1), N(0,2), {MCMC_MAIN}, "
          f"return_stderr=True) in {main_s:.3f} s (host clock), "
          f"{mcmc_launches} chain kernel and {pilot_launches} pilot kernel "
          f"launch(es)")
    if mcmc_launches < 1:
        fail("the MCMC main path did not launch the MCMC kernel")
    if pilot_launches < 1:
        fail("the MCMC main path did not launch the pilot kernel")
    v, se = np.asarray(r.values), np.asarray(r.stderr)
    if v.shape != (1,) or not (np.all(np.isfinite(v)) and np.all(se > 0)):
        fail(f"bad MCMC main-path result {v!r} +- {se!r}")
    z = (v[0] - 1.0) / se[0]
    print(f"  E[x^2] = {v[0]:.6f} +- {se[0]:.6f} (z = {z:+.2f}), "
          f"acceptance {r.acceptance_rate:.4f}, n_samples {r.n_samples}")
    if abs(z) > 6.0 or not 0.0 < r.acceptance_rate < 1.0:
        fail("the MCMC main path's E[x^2] is not within 6 stderr of 1")

    # 9. Kernel and plain version at the main path's shape and
    # configuration: with error bars, as phase 8 ran it.
    main_grid = plan_mcmc_grid(plan_chains(MCMC_MAIN["n_chains"], None))
    main_cfg = mcmc_main_cfg
    main_row = [0.0, 2.0, 0.0, 0.0, 0.0, 1.0]
    # The plain version is timed in the run that holds the kernel to it,
    # at MCMC_CHECK's depth (the kernel is timed at the main shape below):
    # at 4096 x 11,000 the three main paths' plain versions took 100 s of
    # the script's 1,200 on a slow host.
    plain_depth = dict(n_steps=MCMC_CHECK["n_steps"],
                       n_burnin=MCMC_CHECK["n_burnin"])
    plain_steps = main_grid.chains_actual * (MCMC_CHECK["n_steps"]
                                             + MCMC_CHECK["n_burnin"])
    err, mcmc_plain_ms = mcmc_vs_plain(mcmc_program,
                                       replace(main_cfg, **plain_depth),
                                       main_row, main_grid, "9")
    mcmc_err = max(mcmc_err, err)
    params = torch.tensor(main_row, dtype=torch.float32, device=dev)
    mcmc_ms = time_ms(
        lambda: mcmc_cuda(mcmc_program, main_cfg, params, SEED, main_grid),
        reps=10,
    )
    no_stderr_cfg = replace(main_cfg, with_stderr=False)
    mcmc_no_stderr_ms = time_ms(
        lambda: mcmc_cuda(mcmc_program, no_stderr_cfg, params, SEED,
                          main_grid),
        reps=10,
    )
    walk_params = torch.tensor(walk_main_row, dtype=torch.float32, device=dev)
    mcmc_walk_ms = time_ms(
        lambda: mcmc_cuda(mcmc_program, walk_main_cfg, walk_params, SEED,
                          main_grid),
        reps=10,
    )
    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        tm.integrate_mcmc(MCMC_MAIN_FNS, target, proposal,
                          return_stderr=True, **MCMC_MAIN)
        call_s.append(time.perf_counter() - t0)
    mcmc_call_ms = float(np.median(call_s)) * 1e3
    print(f"phase 9: {main_grid.chains_actual} chains x "
          f"({MCMC_MAIN['n_burnin']} + {MCMC_MAIN['n_steps']}) steps, "
          f"[x*x], N(0,2)->N(0,1), stderr, on {card}: kernel "
          f"{mcmc_ms:.3f} ms ({chain_steps / mcmc_ms * 1e3:.4e} "
          f"chain-steps/s; without stderr {mcmc_no_stderr_ms:.3f} ms; "
          f"RandomWalk(adapt=True) -> N(0,1) {mcmc_walk_ms:.3f} ms; layout "
          f"{tuple(mcmc_program.layout_for(main_cfg))}), "
          f"plain {mcmc_plain_ms:.3f} ms at ({MCMC_CHECK['n_burnin']} + "
          f"{MCMC_CHECK['n_steps']}) steps "
          f"({plain_steps / mcmc_plain_ms * 1e3:.4e} chain-steps/s), "
          f"integrate_mcmc() end to end {mcmc_call_ms:.3f} ms median of 5, "
          f"host clock ({chain_steps / mcmc_call_ms * 1e3:.4e} "
          f"chain-steps/s)")
    # Bound: burn-in steps at the cheapest loop's count, sampling steps at
    # the dearest's (the sampling loop also evaluates the integrands); an
    # independence step's draws depend on no other step, so the pipes of
    # the whole card count.
    mhz = clock_under_load(
        lambda: mcmc_cuda(mcmc_program, main_cfg, params, SEED, main_grid),
        mcmc_ms,
    )
    mcmc_bound, own = (card_bound(
        lib, "mcmc_kernel", 2, chain_steps, mhz,
        warps=function_warps(main_cfg.mode, main_grid.chains_actual),
        weights=(MCMC_MAIN["n_steps"], MCMC_MAIN["n_burnin"]), lanes=lanes,
    ) for lib, lanes in (
        (mcmc_count_program.library(main_cfg), 1),
        (mcmc_program.library(main_cfg),
         mcmc_program.layout_for(main_cfg).lanes)))
    print_bound(mcmc_bound, mhz, "chain-step", own)
    steps = MCMC_MAIN["n_steps"] + MCMC_MAIN["n_burnin"]
    mcmc_latency = print_latency(mcmc_bound, steps, mhz)

    # 10. The nd kernel's builds, started in phase 2.
    built = [b.result() for b in nd_builds]
    pool.shutdown()
    print("phase 10: built the nd kernel for c9's and c9c's sets in "
          + " and ".join(f"{sec:.1f}" for _, sec in built)
          + " s (in parallel with phase 2)")
    for nd_lib, _ in built:
        for line in nd_lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 11. nd kernel against the plain version in every mode, 2**24.
    def nd_vs_plain(prog, dists, method, with_stderr, n, phase):
        """Means (and error bars) of the nd kernel and of the plain
        version on the same samples; fails unless they agree.  Returns
        the max abs diff of the means."""
        kinds = tuple(dist_spec_of(d).kind for d in dists)
        cfg = NdConfig(kinds, method, with_stderr)
        grid = plan_grid(make_integrate_plan(n).actual_samples, method)
        params = torch.tensor(
            np.stack([dist_spec_of(d).params for d in dists]), device=dev
        )
        pilot = pilot_row(prog.torch_fns, kinds, params) if with_stderr else None
        got = integrate_nd_cuda(prog, cfg, params, SEED, grid, pilot)
        torch.cuda.synchronize()
        want = integrate_nd_reference(prog.torch_fns, cfg, params, SEED, grid,
                                      pilot)
        if with_stderr:
            (m_k, s_k), (m_p, s_p) = (
                finish_stderr(t[0], t[1], pilot, grid, cfg.antithetic)
                for t in (got, want)
            )
        else:
            m_k, m_p = (t / float(np.float32(grid.actual_samples))
                        for t in (got, want))
        m_k, m_p = m_k.double().cpu().numpy(), m_p.double().cpu().numpy()
        err = np.abs(m_k - m_p)
        name = (f"{method}{' + stderr' if with_stderr else ''}, d={cfg.d}, "
                f"{grid.actual_samples} samples")
        print(f"phase {phase}: {name}: kernel {m_k}")
        print(f"          plain  {m_p}  max|diff| {err.max():.3e}")
        if not np.all(np.isfinite(m_k)):
            fail(f"nd {name}: non-finite kernel means {m_k}")
        if not np.all(err <= RTOL * np.abs(m_p) + ATOL):
            fail(f"nd {name}: kernel and plain version disagree")
        if with_stderr:
            s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
            print(f"          stderr kernel {s_k} plain {s_p}")
            if not (np.all(s_k > 0) and np.allclose(
                    s_k, s_p, rtol=ND_STDERR_RTOL, atol=0.0)):
                fail(f"nd {name}: error bars disagree")
        return float(err.max())

    nd_err = 0.0
    for method, with_stderr in (("mc", False), ("antithetic", False),
                                ("qmc", False), ("mc", True),
                                ("antithetic", True)):
        nd_err = max(nd_err, nd_vs_plain(nd_program, nd_dists, method,
                                         with_stderr, CHECK_SAMPLES, "11"))
    nd_err = max(nd_err, nd_vs_plain(qmc_program, qmc_dists, "qmc", False,
                                     CHECK_SAMPLES, "11"))

    # 12. nd main path 1 through the public API, counted.
    integrate_nd_cuda.launches = 0
    t0 = time.perf_counter()
    result = tm.integrate(ND_FNS, nd_dists, n_samples=MAIN_SAMPLES, seed=SEED)
    main_s = time.perf_counter() - t0
    nd_launches = integrate_nd_cuda.launches
    nd_grid = plan_grid(make_integrate_plan(MAIN_SAMPLES).actual_samples)
    n_nd = nd_grid.actual_samples
    print(f"phase 12: integrate([x*y*z, x*x+y+z], [N(0,1), U(0,1), Exp(2)], "
          f"n_samples={MAIN_SAMPLES}) drew {n_nd} samples in {main_s:.3f} s "
          f"(host clock), {nd_launches} kernel launch(es)")
    if nd_launches < 1:
        fail("nd main path 1 did not launch the nd kernel")
    values = np.asarray(result.values)
    if values.shape != (2,) or not np.all(np.isfinite(values)):
        fail(f"bad nd main-path result {values!r}")
    for j, (v, mu, var) in enumerate(zip(values, ND_MEANS, ND_VARS)):
        z = (v - mu) / math.sqrt(var / n_nd)
        print(f"  f{j}: {v:+.7f}  closed form {mu:+.7f}  z = {z:+.2f}")
        if abs(z) > 6.0:
            fail(f"nd f{j} is {z:.1f} sigma from its closed form")

    # 13. nd main path 2: randomized Sobol QMC, counted.
    integrate_nd_cuda.launches = 0
    t0 = time.perf_counter()
    result = tm.integrate(QMC_FNS, qmc_dists, n_samples=MAIN_SAMPLES,
                          seed=SEED, method="qmc", return_stderr=True,
                          qmc_rotations=QMC_ROTATIONS)
    main_s = time.perf_counter() - t0
    qmc_launches = integrate_nd_cuda.launches
    v, se = float(result.values[0]), float(result.stderr[0])
    mc_se = math.sqrt(QMC_VAR / MAIN_SAMPLES)
    # Each rotation's mean is float32, as in the JAX package; at 2**27
    # points a rotation's error is far below the float32 spacing of the
    # mean, so the rotations may agree bit for bit (stderr 0).  The check
    # allows that resolution: 4 float32 ulp of (e - 1)^2.
    f32_floor = 4.0 * float(np.spacing(np.float32(QMC_MEAN)))
    print(f"phase 13: integrate([exp(x)*exp(y)], [U(0,1)]*2, n_samples="
          f"{MAIN_SAMPLES}, qmc, {QMC_ROTATIONS} rotations) in {main_s:.3f} s "
          f"(host clock), {qmc_launches} kernel launch(es): {v:.9f} +- "
          f"{se:.3e} (closed form {QMC_MEAN:.9f}, off by "
          f"{v - QMC_MEAN:+.3e}; float32 floor {f32_floor:.3e}); plain-MC "
          f"stderr at 1e9 {mc_se:.3e}")
    if qmc_launches != 1:
        fail("nd main path 2 did not run its rotations as one batched "
             "launch of the nd kernel")
    if not (math.isfinite(v) and se >= 0
            and abs(v - QMC_MEAN) <= 6 * se + f32_floor):
        fail("nd main path 2 is not within 6 rQMC standard errors "
             "(plus the float32 floor)")
    # Each rotation again, at the main path's own grid and seeds (derived
    # as api/integrate.py derives them): the kernel's sums against the
    # plain version's, and the rotations' spread from float64 sums of the
    # kernel's float32 block rows, which resolve what the float32 means
    # cannot: distinct rotations (spread > 0) and an rQMC error 10x below
    # plain MC's at 1e9.
    rot_grid = plan_grid(make_integrate_plan(
        -(-MAIN_SAMPLES // QMC_ROTATIONS)).actual_samples, "qmc")
    n_rot = rot_grid.actual_samples
    rot_seeds = np.uint32(SEED) + np.uint32(0x9E3779B9) * np.arange(
        QMC_ROTATIONS, dtype=np.uint32)
    qmc_cfg = NdConfig(qmc_kinds, "qmc")
    qmc_params = torch.tensor(
        np.stack([dist_spec_of(d).params for d in qmc_dists]), device=dev)
    means32, means64, rot_rows = [], [], []
    for s in rot_seeds:
        rows = integrate_nd_rows(qmc_program, qmc_cfg, qmc_params, int(s),
                                 rot_grid)
        rot_rows.append(rows)
        got = float((rows.sum(dim=0) / float(np.float32(n_rot)))[0])
        want = float(integrate_nd_reference(
            qmc_program.torch_fns, qmc_cfg, qmc_params, int(s), rot_grid,
        )[0]) / n_rot
        means32.append(got)
        means64.append(float(rows[:, 0].double().sum()) / n_rot)
        print(f"  rotation seed {int(s)}: kernel {got:.9f} plain {want:.9f} "
              f"|diff| {abs(got - want):.3e}; float64 sum of rows "
              f"{means64[-1]:.12f}")
        if not abs(got - want) <= RTOL * abs(want) + ATOL:
            fail(f"rotation seed {int(s)}: kernel and plain version disagree")
        nd_err = max(nd_err, abs(got - want))
    rot_ms = time_ms(lambda: integrate_nd_rows(
        qmc_program, qmc_cfg, qmc_params, int(rot_seeds[0]), rot_grid),
        reps=10)
    print(f"  one rotation's kernel ({n_rot} points, CUDA events, mean of 10 "
          f"launches): {rot_ms:.4f} ms")
    # The rotations as the main path runs them: one launch of 8 reps, each
    # rep's rows the rotation's own launch's above, bit for bit.
    rot_words = torch.from_numpy(rot_seeds.view(np.int32)).to(dev)
    rot_batch = integrate_nd_batch_rows(qmc_program, qmc_cfg, qmc_params,
                                        rot_words, rot_grid)
    for r, rows in enumerate(rot_rows):
        if not torch.equal(rot_batch[r], rows):
            fail(f"phase 13: rotation {r} of the batched launch is not its "
                 "own launch's, bit for bit")
    rot_batch_ms = time_ms(lambda: integrate_nd_batch_rows(
        qmc_program, qmc_cfg, qmc_params, rot_words, rot_grid), reps=10)
    print(f"  the {QMC_ROTATIONS} rotations in one batched launch, each bit "
          f"for bit its own launch: {rot_batch_ms:.4f} ms (CUDA events, mean "
          f"of 10) against {QMC_ROTATIONS} x {rot_ms:.4f} = "
          f"{QMC_ROTATIONS * rot_ms:.4f} ms")
    se64 = float(np.std(means64, ddof=1) / math.sqrt(QMC_ROTATIONS))
    print(f"  {QMC_ROTATIONS} rotations of {n_rot} points: stderr of the "
          f"float64 rotation means {se64:.3e}, 10x below plain MC's "
          f"{mc_se:.3e}: {se64 * 10 <= mc_se}")
    if abs(float(np.mean(means32)) - v) > np.spacing(np.float32(QMC_MEAN)):
        fail("the rotations run again do not give main path 2's value")
    if not (0.0 < se64 and se64 * 10 <= mc_se):
        fail("the rotations' spread is zero or not 10x below plain MC's")

    # 14. nd kernel and plain version at main path 1's shape, timed.
    nd_cfg = NdConfig(nd_kinds)
    nd_params = torch.tensor(
        np.stack([dist_spec_of(d).params for d in nd_dists]), device=dev
    )
    nd_err = max(nd_err, nd_vs_plain(nd_program, nd_dists, "mc", False,
                                     MAIN_SAMPLES, "14"))
    nd_ms = time_ms(
        lambda: integrate_nd_cuda(nd_program, nd_cfg, nd_params, SEED,
                                  nd_grid),
        reps=10,
    )
    nd_plain_ms = time_ms(
        lambda: integrate_nd_reference(nd_program.torch_fns, nd_cfg,
                                       nd_params, SEED, nd_grid),
        reps=1,
    )
    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        tm.integrate(ND_FNS, nd_dists, n_samples=MAIN_SAMPLES, seed=SEED)
        call_s.append(time.perf_counter() - t0)
    nd_call_ms = float(np.median(call_s)) * 1e3
    print(f"phase 14: {n_nd} samples, d=3, K=2 on {card}: kernel "
          f"{nd_ms:.3f} ms ({MAIN_SAMPLES / nd_ms * 1e3:.4e} d-vector "
          f"samples/s as run_all.py counts them, "
          f"{n_nd / nd_ms * 1e3:.4e} drawn), plain {nd_plain_ms:.3f} ms "
          f"({MAIN_SAMPLES / nd_plain_ms * 1e3:.4e}), integrate() end to "
          f"end {nd_call_ms:.3f} ms median of 5, host clock "
          f"({MAIN_SAMPLES / nd_call_ms * 1e3:.4e})")
    mhz = clock_under_load(
        lambda: integrate_nd_cuda(nd_program, nd_cfg, nd_params, SEED,
                                  nd_grid),
        nd_ms,
    )
    nd_bound = card_bound(nd_program.library(),
                          "integrate_nd_kernelILi0ELb0EE", 3, n_nd, mhz)
    nd_parent = card_bound(
        None, "integrate_nd_kernelILi0ELb0EE", 3, n_nd, mhz,
        listing=(PARENT_SASS / "integrate_nd_c9.sass").read_text())
    print_bound(nd_bound, mhz, "sample")
    print_parent_bound(nd_parent, "sample")
    idle_share(lambda: tm.integrate(ND_FNS, nd_dists,
                                    n_samples=MAIN_SAMPLES, seed=SEED))

    # 15. The nd MCMC kernel's builds, started in phase 2.
    built = [b.result() for b in nd_mcmc_builds]
    pool.shutdown()
    print(f"phase 15: built the nd MCMC kernel for {len(built)} sets (c9d, "
          "c9e, c9e's one-lane build for the bound, c10b and phase 16's) in "
          + ", ".join(f"{sec:.1f}" for _, sec in built)
          + " s (in parallel with phase 2)")
    for nd_mcmc_lib, _ in built:
        for line in nd_mcmc_lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 16. nd MCMC kernel against the plain version in every mode.
    def nd_mcmc_vs_plain(prog, cfg, params, grid, phase: str):
        """The kernel against the plain version on the same chains, as
        phase 7.  Returns (max abs difference of the means, the plain
        version's milliseconds by CUDA events)."""
        got = mcmc_nd_cuda(prog, cfg, params, SEED, grid)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mcmc_nd_reference(prog.torch_fns, prog.torch_target, cfg,
                                 params, SEED, grid)
        end.record()
        end.synchronize()
        err = chains_agree(got, want, grid, cfg, len(prog.fns), phase)
        return err, start.elapsed_time(end)

    nd_mcmc_err = 0.0
    for name, (prog, cfg, params) in nd_mcmc_checks:
        print(f"phase 16: {name}, {check_grid.chains_actual} chains x "
              f"({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) steps")
        nd_mcmc_err = max(nd_mcmc_err, nd_mcmc_vs_plain(
            prog, cfg, params, check_grid, "16")[0])

    # 17. The nd MCMC main path (c9e), then c9d and c10b, through the
    # public API, each counted.
    for name, (fns, nd_target, nd_proposal, exact) in nd_mcmc_cells.items():
        mcmc_nd_cuda.launches = mcmc_nd_cuda.pilot_launches = 0
        t0 = time.perf_counter()
        r = tm.integrate_mcmc(fns, nd_target, nd_proposal, return_stderr=True,
                              **MCMC_MAIN)
        main_s = time.perf_counter() - t0
        launches_nd = mcmc_nd_cuda.launches, mcmc_nd_cuda.pilot_launches
        print(f"phase 17: {name}, integrate_mcmc({MCMC_MAIN}, "
              f"return_stderr=True) in {main_s:.3f} s (host clock), "
              f"{launches_nd[0]} chain kernel and {launches_nd[1]} pilot "
              "kernel launch(es)")
        if launches_nd[0] < 1 or launches_nd[1] < 1:
            fail(f"{name} did not launch the nd MCMC kernel and its pilot")
        v, se = np.asarray(r.values), np.asarray(r.stderr)
        if v.shape != (1,) or not (np.all(np.isfinite(v)) and np.all(se > 0)):
            fail(f"bad {name} result {v!r} +- {se!r}")
        z = (v[0] - exact) / se[0]
        print(f"  E[f] = {v[0]:.6f} +- {se[0]:.6f}, closed form {exact} "
              f"(z = {z:+.2f}), acceptance {r.acceptance_rate:.4f}, "
              f"n_samples {r.n_samples}")
        if abs(z) > 6.0 or not 0.0 < r.acceptance_rate < 1.0:
            fail(f"{name}: E[f] is not within 6 stderr of {exact}")
        if name == "c9e":
            nd_mcmc_launches, nd_pilot_launches = launches_nd

    # 18. nd kernel and plain version at c9e's shape and configuration.
    prog, cfg, params = nd_mcmc_main["c9e"]
    main_grid = plan_mcmc_grid(plan_chains(MCMC_MAIN["n_chains"], None))
    err, nd_mcmc_plain_ms = nd_mcmc_vs_plain(
        prog, replace(cfg, **plain_depth), params, main_grid, "18")
    nd_mcmc_err = max(nd_mcmc_err, err)
    nd_mcmc_ms = time_ms(
        lambda: mcmc_nd_cuda(prog, cfg, params, SEED, main_grid), reps=10
    )
    nd_mcmc_layout = list(prog.layout)
    walk_prog, walk_cfg, walk_params = nd_mcmc_main["c10b"]
    c10b_ms = time_ms(
        lambda: mcmc_nd_cuda(walk_prog, walk_cfg, walk_params, SEED,
                             main_grid),
        reps=10,
    )
    c9e_fns, c9e_joint, c9e_proposal, _ = nd_mcmc_cells["c9e"]

    def c9e_call():
        return tm.integrate_mcmc(c9e_fns, c9e_joint, c9e_proposal,
                                 return_stderr=True, **MCMC_MAIN)

    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        c9e_call()
        call_s.append(time.perf_counter() - t0)
    nd_mcmc_call_ms = float(np.median(call_s)) * 1e3
    print(f"phase 18: {main_grid.chains_actual} chains x "
          f"({MCMC_MAIN['n_burnin']} + {MCMC_MAIN['n_steps']}) steps, c9e "
          f"[x*y], N(0,2)^2 -> joint, stderr, on {card}: kernel "
          f"{nd_mcmc_ms:.3f} ms ({chain_steps / nd_mcmc_ms * 1e3:.4e} "
          f"chain-steps/s; c10b's walk {c10b_ms:.3f} ms; layout "
          f"{tuple(nd_mcmc_layout)}), plain {nd_mcmc_plain_ms:.3f} ms at "
          f"({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) steps "
          f"({plain_steps / nd_mcmc_plain_ms * 1e3:.4e} chain-steps/s), "
          f"integrate_mcmc() end to end {nd_mcmc_call_ms:.3f} ms median of "
          f"5, host clock ({chain_steps / nd_mcmc_call_ms * 1e3:.4e} "
          f"chain-steps/s)")
    # Bounds as phase 9's: d + 1 uniform conversions per step.
    mhz = clock_under_load(
        lambda: mcmc_nd_cuda(prog, cfg, params, SEED, main_grid), nd_mcmc_ms
    )
    nd_mcmc_bound, own = (card_bound(
        p.library(), "mcmc_nd_kernel", cfg.d + 1, chain_steps, mhz,
        warps=function_warps(cfg.mode, main_grid.chains_actual),
        weights=(MCMC_MAIN["n_steps"], MCMC_MAIN["n_burnin"]),
        lanes=p.layout.lanes,
    ) for p in (nd_count_program, prog))
    print_bound(nd_mcmc_bound, mhz, "chain-step", own)
    nd_mcmc_latency = print_latency(nd_mcmc_bound, steps, mhz)
    print("  c9e:", end="")
    idle_share(c9e_call)
    print("  1-D MCMC main path (c5b):", end="")
    idle_share(lambda: tm.integrate_mcmc(MCMC_MAIN_FNS, target, proposal,
                                         return_stderr=True, **MCMC_MAIN))

    # 19. The tempered kernel's builds, started in phase 2.
    built = [b.result() for b in pt_builds]
    pool.shutdown()
    print(f"phase 19: built the tempered MCMC kernel for {len(built)} sets "
          "(c12, c12c, their ladder layouts and phase 20's) in "
          + ", ".join(f"{sec:.1f}" for _, sec in built)
          + " s (in parallel with phase 2)")
    for pt_lib, _ in built:
        for line in pt_lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 20. Tempered kernel against the plain version in every mode.
    def pt_vs_plain(prog, cfg, params, ladder, grid, phase: str):
        """The kernel against the plain version on the same ladders, as
        phase 7, and their swap rates within 1e-3.  Returns (max abs
        difference of the means, the plain version's milliseconds by CUDA
        events, the kernel's swap rate)."""
        got = mcmc_pt_cuda(prog, cfg, params, ladder, SEED, grid)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = mcmc_pt_reference(prog.torch_fns, prog.torch_target, cfg,
                                 params, ladder, SEED, grid)
        end.record()
        end.synchronize()
        k = len(prog.fns)
        err = chains_agree(got, want, grid, cfg, k, phase, max_split=0.01)
        w_k, w_p = (float(pt_finish(t, grid, cfg, k)[2]) for t in (got, want))
        print(f"         swap rate kernel {w_k:.6f} plain {w_p:.6f}")
        if not (0.0 < w_k < 1.0 and abs(w_k - w_p) <= 1e-3):
            fail(f"phase {phase}: swap rates disagree or are not in (0, 1)")
        return err, start.elapsed_time(end), w_k

    pt_err = 0.0
    for name, (prog, cfg, params, ladder) in pt_checks:
        print(f"phase 20: {name}, {check_grid.chains_actual} chains x "
              f"({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) steps")
        pt_err = max(pt_err, pt_vs_plain(prog, cfg, params, ladder,
                                         check_grid, "20")[0])

    # 21. The tempered main path (c12), then c12c, through the public API,
    # each counted.
    def pt_call(proposal):
        return tm.integrate_mcmc(PT_FNS, logmix, proposal,
                                 temperatures=PT_LADDER, return_stderr=True,
                                 **MCMC_MAIN)

    for name, pt_proposal in pt_cells.items():
        mcmc_pt_cuda.launches = mcmc_pt_cuda.pilot_launches = 0
        t0 = time.perf_counter()
        r = pt_call(pt_proposal)
        main_s = time.perf_counter() - t0
        launches_pt = mcmc_pt_cuda.launches, mcmc_pt_cuda.pilot_launches
        swap = r.diagnostics["swap_rate"]
        print(f"phase 21: {name}, integrate_mcmc([x, x*x], logmix, "
              f"temperatures={PT_LADDER}, {MCMC_MAIN}, return_stderr=True) "
              f"in {main_s:.3f} s (host clock), {launches_pt[0]} chain kernel "
              f"and {launches_pt[1]} pilot kernel launch(es)")
        if launches_pt[0] < 1 or launches_pt[1] < 1:
            fail(f"{name} did not launch the tempered kernel and its pilot")
        v, se = np.asarray(r.values), np.asarray(r.stderr)
        if v.shape != (2,) or not (np.all(np.isfinite(v)) and np.all(se > 0)):
            fail(f"bad {name} result {v!r} +- {se!r}")
        z = (v - np.asarray(PT_EXACT)) / se
        print(f"  E[x] = {v[0]:.6f} +- {se[0]:.6f} (z = {z[0]:+.2f}), "
              f"E[x^2] = {v[1]:.6f} +- {se[1]:.6f} (z = {z[1]:+.2f}), "
              f"acceptance {r.acceptance_rate:.4f}, swap rate {swap:.4f}, "
              f"n_samples {r.n_samples}")
        if np.any(np.abs(z) > 6.0) or not 0.0 < r.acceptance_rate < 1.0:
            fail(f"{name}: E[x], E[x^2] are not within 6 stderr of 0, 17")
        if not 0.0 < swap < 1.0:
            fail(f"{name}: swap rate {swap} is not in (0, 1)")
        if name == "c12":
            pt_launches, pt_pilot_launches = launches_pt
            pt_swap = swap

    # 22. Tempered kernel and plain version at c12's shape and
    # configuration.
    prog, cfg, params, ladder = pt_main["c12"]
    err, pt_plain_ms, _ = pt_vs_plain(prog, replace(cfg, **plain_depth),
                                      params, ladder, main_grid, "22")
    pt_err = max(pt_err, err)
    # Each main program's default layout against its ladder layout: the
    # same ladders bit for bit; and the kernel times of both.
    pt_times = {}
    for name, (p_def, c_def, par, lad) in pt_main.items():
        runs = {}
        for how, p_run in (("default", p_def), ("ladder", pt_ladders[name])):
            def run(p_run=p_run):
                return mcmc_pt_cuda(p_run, c_def, par, lad, SEED, main_grid)
            runs[how] = run()
            pt_times[name, how] = time_ms(run, reps=10)
        torch.cuda.synchronize()
        same = (torch.equal(runs["default"].rows, runs["ladder"].rows)
                and torch.equal(runs["default"].x_final,
                                runs["ladder"].x_final))
        print(f"phase 22: {name}: layout {tuple(p_def.layout)} "
              f"{pt_times[name, 'default']:.4f} ms, ladder layout "
              f"{pt_times[name, 'ladder']:.4f} ms; rows and final states "
              f"{'bit-equal' if same else 'DIFFER'}")
        if not same:
            fail(f"phase 22: {name}'s layout {tuple(p_def.layout)} and the "
                 "ladder layout run different ladders")
    pt_ms = pt_times["c12", "default"]
    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        pt_call(c12_walk)
        call_s.append(time.perf_counter() - t0)
    pt_call_ms = float(np.median(call_s)) * 1e3
    lane_steps = cfg.n_temps * chain_steps
    print(f"phase 22: {main_grid.chains_actual} chains x {cfg.n_temps} rungs "
          f"x ({MCMC_MAIN['n_burnin']} + {MCMC_MAIN['n_steps']}) steps, c12 "
          f"[x, x*x], adaptive walk -> logmix, stderr, on {card}: kernel "
          f"{pt_ms:.3f} ms ({lane_steps / pt_ms * 1e3:.4e} lane-steps/s, "
          f"{chain_steps / pt_ms * 1e3:.4e} chain-steps/s), plain "
          f"{pt_plain_ms:.3f} ms at ({MCMC_CHECK['n_burnin']} + "
          f"{MCMC_CHECK['n_steps']}) steps "
          f"({cfg.n_temps * plain_steps / pt_plain_ms * 1e3:.4e} "
          f"lane-steps/s), integrate_mcmc() end to end {pt_call_ms:.3f} ms "
          f"median of 5, host clock ({lane_steps / pt_call_ms * 1e3:.4e} "
          f"lane-steps/s)")
    # Bounds as phase 18's, per chain-step (every rung of the ladder), on
    # the ladder layout's build: T rungs' d + 1 uniform conversions and, on
    # the cheapest path, the parity with fewer pairs' swap draws.  The T
    # rung moves of a step are independent, so the work spans T x chains
    # lanes (4 x 4096: 512 warps).  A build of rungs on lanes converts, on
    # each rung lane, its rung's d + 1 uniforms and its pair's swap
    # uniform; a chain-step is T' rung lanes of L lanes each.
    mhz = clock_under_load(
        lambda: mcmc_pt_cuda(prog, cfg, params, ladder, SEED, main_grid),
        pt_ms,
    )
    pt_warps = function_warps(cfg.mode, main_grid.chains_actual, cfg.n_temps)
    pt_weights = (MCMC_MAIN["n_steps"], MCMC_MAIN["n_burnin"])
    pt_conversions = cfg.n_temps * (cfg.d + 1) + (cfg.n_temps - 1) // 2
    pt_bound = card_bound(
        pt_ladders["c12"].library(), "mcmc_pt_kernel", pt_conversions,
        chain_steps, mhz, warps=pt_warps, weights=pt_weights,
    )
    own = None
    if prog.layout != LADDER_LAYOUT:
        own = card_bound(
            prog.library(), "mcmc_pt_kernel", cfg.d + 2,
            chain_steps * prog.layout.rung_lanes, mhz, warps=pt_warps,
            weights=pt_weights, lanes=prog.layout.lanes,
        )
        own = (*own[:3], {k: (v * prog.layout.rung_lanes
                              if k not in ("chain", "carried") else v)
                          for k, v in own[3].items()})
    print_bound(pt_bound, mhz, "chain-step", own,
                twin="the ladder layout's build")
    pt_latency = print_latency(pt_bound, steps, mhz)
    print("  c12:", end="")
    idle_share(lambda: pt_call(c12_walk))

    # 23. The bounds' pipe model against the probe mix that tells IMAD's
    # classes apart (tools/pipe_probe.py runs every mix).
    print("phase 23:", end=" ")
    pipe_rates(probe_build.result(), card, ["IMAD+FFMA"])

    # 24. The 1-D kernel's mode libraries, started in phase 2.
    mode_libs = {}
    for name, build in mode_builds.items():
        mode_libs[name], sec = build.result()
        print(f"phase 24: built the integrate kernel's {name} library in "
              f"{sec:.1f} s (in parallel with phase 2)")
        for line in mode_libs[name].build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 25. Each mode's kernel against its plain version at 2**22 samples,
    # three families; config 4's importance set under its proposal.
    def tables_of(prog, dist):
        """The device tables of a CUSTOM ``dist`` for ``prog``, or None."""
        spec_ = dist_spec_of(dist)
        if spec_.kind != DistKind.CUSTOM:
            return None
        return sampling_tables(dist, spec_, dev, with_pdf=prog.sampler)

    def outputs_agree(prog, spec, params, tables, cfg, grid, pilot, got, want,
                      name: str) -> float:
        """Fails unless the kernel's sums ``got`` and the plain version's
        ``want`` give the same means (and error bars) within phase 25's
        tolerances, each scaled by its column's size.  Returns the max abs
        diff of the means."""
        size = pilot_values(lambda *a: [v.abs() for v in prog.torch_values(*a)],
                            spec.kind, params, tables).double().cpu().numpy()
        if cfg.with_stderr:
            (m_k, s_k), (m_p, s_p) = (
                [t.double().cpu().numpy() for t in
                 finish_stderr(o[0], o[1], pilot, grid, cfg.antithetic)]
                for o in (got, want))
        else:
            n_f = float(np.float32(grid.actual_samples))
            m_k, m_p = ((o / n_f).double().cpu().numpy() for o in (got, want))
        err = np.abs(m_k - m_p)
        size = np.maximum(size, np.abs(m_p))
        print(f"{name}: kernel {m_k}")
        print(f"         plain  {m_p}  max|diff| {err.max():.3e}, "
              f"max|diff|/size {np.max(err / np.maximum(size, 1e-30)):.3e}")
        if not np.all(np.isfinite(m_k)):
            fail(f"{name}: non-finite kernel means {m_k}")
        if not np.all(err <= RTOL * np.abs(m_p) + ATOL * size):
            fail(f"{name}: kernel and plain version disagree")
        if cfg.with_stderr:
            print(f"         stderr kernel {s_k} plain {s_p}")
            # Equal error bars agree, infinite and NaN ones too: a Cauchy
            # column of x^3 or x^4 squares past float32 on both sides.
            with np.errstate(invalid="ignore"):
                close = (s_k == s_p) | (np.isnan(s_k) & np.isnan(s_p)) | (
                    np.abs(s_k - s_p)
                    <= STDERR_1D_RTOL * np.abs(s_p) + STDERR_1D_ATOL * size)
            if not (np.array_equal(s_k > 0, s_p > 0) and np.all(close)):
                fail(f"{name}: error bars disagree")
        return float(err.max())

    def mode_vs_plain(prog, dist, cfg, n, phase: str) -> float:
        """The kernel and the plain version on the same samples, held
        together by ``outputs_agree``."""
        spec = dist_spec_of(dist)
        params = torch.tensor(spec.params, device=dev)
        tables = tables_of(prog, dist)
        grid = plan_grid(make_integrate_plan(n).actual_samples, cfg.method)
        pilot = (pilot_values(prog.torch_values, spec.kind, params, tables)
                 if cfg.with_stderr else None)
        got = integrate_cuda(prog, spec.kind, params, SEED, grid, cfg, pilot,
                             tables)
        want = integrate_reference(prog.torch_values, spec.kind, params, SEED,
                                   grid, cfg, pilot, tables)
        route = "" if tables is None else f" ({tables.route})"
        name = (f"{cfg.method}{', stderr' if cfg.with_stderr else ''}, "
                f"{spec.kind.name.lower()}{route} at {grid.actual_samples} "
                "samples")
        return outputs_agree(prog, spec, params, tables, cfg, grid, pilot,
                             got, want, f"phase {phase}: {name}")

    mode_err = max(mode_vs_plain(program, d, cfg, MODE_CHECK_SAMPLES, "25")
                   for cfg in mode_cfgs.values() for d in families)
    mode_err = max(mode_err, mode_vs_plain(is_program, is_proposal, is_cfg,
                                           MODE_CHECK_SAMPLES, "25"))
    max_abs_err = max(max_abs_err, mode_err)

    # 26. The bench set at 2**30 samples under N(0, 1) in each mode: kernel
    # and plain version (CUDA events), held together as in phase 25, the
    # bound per sample drawn (per pair under antithetic) on the running
    # build, and integrate() end to end (host clock); then rQMC as
    # integrate() runs it.
    def mode_times(prog, cfg, lib_, spec_, n, call, label: str,
                   tables=None, check_n=None) -> dict:
        """The kernel at ``n`` samples timed and bounded, held against (and
        beside) its plain version at ``n``, or at ``check_n`` if given."""
        params_ = torch.tensor(spec_.params, device=dev)
        grid_ = plan_grid(make_integrate_plan(n).actual_samples, cfg.method)
        check_grid_ = grid_ if check_n is None else plan_grid(
            make_integrate_plan(check_n).actual_samples, cfg.method)
        pilot = (pilot_values(prog.torch_values, spec_.kind, params_, tables)
                 if cfg.with_stderr else None)
        out = {}

        def run(g=grid_):
            out["kernel"] = integrate_cuda(prog, spec_.kind, params_, SEED,
                                           g, cfg, pilot, tables)

        def plain():
            out["plain"] = integrate_reference(
                prog.torch_values, spec_.kind, params_, SEED, check_grid_,
                cfg, pilot, tables)

        k_ms = time_ms(run, reps=10)
        if check_grid_ is not grid_:
            run(check_grid_)
        p_ms = time_ms(plain, reps=1)
        err = outputs_agree(prog, spec_, params_, tables, cfg, check_grid_,
                            pilot, out["kernel"], out["plain"],
                            f"{label}, {check_grid_.actual_samples} samples")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        c_ms = float(np.median(walls)) * 1e3
        drawn = grid_.actual_samples
        units = drawn // 2 if cfg.antithetic else drawn
        mhz_ = clock_under_load(run, k_ms)
        bound = card_bound(lib_, f"integrate_kernelILi{int(spec_.kind)}EE",
                           1, units, mhz_)
        print(f"{label}, {drawn} samples on {card}: kernel "
              f"{k_ms:.3f} ms ({drawn / k_ms * 1e3:.4e} samples/s), plain "
              f"{p_ms:.3f} ms"
              + ("" if check_n is None
                 else f" at {check_grid_.actual_samples} samples")
              + f", call end to end {c_ms:.3f} ms median of 3, host clock")
        print_bound(bound, mhz_, "pair" if cfg.antithetic else "sample")
        return {"samples": drawn, "ms": k_ms, "plain_ms": p_ms,
                **({} if check_n is None
                   else {"plain_samples": check_grid_.actual_samples}),
                "call_ms": c_ms, "bound_ms": bound[0], "bound_pipe": bound[1],
                "issue_ms": bound[2], "max_abs_err": err}

    modes = {}
    for name, (method, stderr) in MODES_1D.items():
        modes[name] = mode_times(
            program, mode_cfgs[name], mode_libs[name], spec, MODE_SAMPLES,
            lambda m=method, e=stderr: tm.integrate(
                BENCH_FNS, normal, n_samples=MODE_SAMPLES, seed=SEED,
                method=m, return_stderr=e),
            f"phase 26: K=8, N(0,1), {name}")
    rot_n = plan_grid(make_integrate_plan(-(-MODE_SAMPLES // RQMC_ROTATIONS))
                      .actual_samples, "qmc").actual_samples
    rqmc = mode_times(
        program, mode_cfgs["qmc"], mode_libs["qmc"], spec,
        -(-MODE_SAMPLES // RQMC_ROTATIONS),
        lambda: tm.integrate(BENCH_FNS, normal, n_samples=MODE_SAMPLES,
                             seed=SEED, method="qmc", return_stderr=True,
                             qmc_rotations=RQMC_ROTATIONS),
        f"phase 26: K=8, N(0,1), one rQMC rotation of {RQMC_ROTATIONS} (the "
        f"call: all {RQMC_ROTATIONS})")
    rqmc.update(rotations=RQMC_ROTATIONS, rotation_samples=rot_n)
    modes["rqmc"] = rqmc

    # 27. The importance-sampling main path at config 4, through
    # the public API, counted; then its kernel at 1e8 and 2**30 samples.
    integrate_cuda.launches = 0
    t0 = time.perf_counter()
    is_result = tm.integrate_importance_sampling(
        IS_FNS, is_target, is_proposal, n_samples=IS_SAMPLES, seed=SEED,
        return_stderr=True, return_diagnostics=True)
    is_s = time.perf_counter() - t0
    is_launches = integrate_cuda.launches
    v, se = float(is_result.values[0]), float(is_result.stderr[0])
    diag = is_result.diagnostics
    print(f"phase 27: integrate_importance_sampling([x > 4], N(0,1), "
          f"N(4,1.5), n_samples={IS_SAMPLES}, return_stderr=True, "
          f"return_diagnostics=True) in {is_s:.3f} s (host clock), "
          f"{is_launches} kernel launch(es)")
    print(f"  P(X > 4) = {v:.7e} +- {se:.3e}, exact {IS_EXACT:.7e}, "
          f"z = {(v - IS_EXACT) / se:+.2f}; ESS {diag['ess']:.1f} of "
          f"{IS_SAMPLES} ({diag['ess'] / IS_SAMPLES:.4%}), mean weight "
          f"{diag['mean_weight']:.6f}, weight cv {diag['weight_cv']:.4f}")
    if is_launches < 1:
        fail("the importance-sampling path did not launch the integrate "
             "kernel")
    if not (math.isfinite(v) and se > 0 and abs(v - IS_EXACT) <= 6 * se):
        fail("config 4 is not within 6 standard errors of P(X > 4)")
    if not (0 < diag["ess"] <= IS_SAMPLES and math.isfinite(diag["weight_cv"])):
        fail(f"bad weight diagnostics {diag}")
    is_spec = dist_spec_of(is_proposal)

    def is_call():
        tm.integrate_importance_sampling(
            IS_FNS, is_target, is_proposal, n_samples=IS_SAMPLES, seed=SEED,
            return_stderr=True, return_diagnostics=True)

    modes["is_config4"] = mode_times(
        is_program, is_cfg, mode_libs["is"], is_spec, IS_SAMPLES, is_call,
        "phase 27: config 4, [x > 4] and the weight, N(0,1) from N(4,1.5), "
        "stderr")
    modes["is_config4"]["idle_share"] = idle_share(is_call)
    modes["is_2e30"] = mode_times(
        is_program, is_cfg, mode_libs["is"], is_spec, MODE_SAMPLES,
        lambda: tm.integrate_importance_sampling(
            IS_FNS, is_target, is_proposal, n_samples=MODE_SAMPLES, seed=SEED,
            return_stderr=True, return_diagnostics=True),
        "phase 27: config 4's set at 2**30")

    # 28. CUSTOM tables and table weights: the libraries started in phase
    # 2, then each route and weight mode against its plain version.
    built = [b.result() for b in custom_builds]
    print(f"phase 28: built the integrate kernel's CUSTOM and table-weight "
          f"libraries for {len(built)} programs and modes, "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for lib_, _ in built:
        for line in lib_.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    custom_err = max(
        mode_vs_plain(program, d, cfg, MODE_CHECK_SAMPLES, "28")
        for d in custom_dists.values() for cfg in custom_modes.values())
    for label, (prog_, q, ms_) in custom_is.items():
        print(f"phase 28: importance set, {label}:")
        custom_err = max(custom_err, *(
            mode_vs_plain(prog_, q, custom_modes[m], MODE_CHECK_SAMPLES, "28")
            for m in ms_))
    max_abs_err = max(max_abs_err, custom_err)

    # 29. BASELINE.md config 3 through the public API, counted; then its
    # kernels, the bench set under Beta(2, 5) and an importance set with a
    # table target at 2**30, with their bounds.
    integrate_cuda.launches = 0
    t0 = time.perf_counter()
    c3_beta_result = tm.integrate(C3_BETA_FNS, c3_beta, n_samples=C3_SAMPLES,
                                  seed=SEED)
    c3_tri_result = tm.integrate(C3_TRI_FNS, c3_tri, n_samples=C3_SAMPLES,
                                 seed=SEED)
    c3_s = time.perf_counter() - t0
    custom_launches = integrate_cuda.launches
    c3_n = plan_grid(make_integrate_plan(C3_SAMPLES).actual_samples).actual_samples
    print(f"phase 29: config 3, integrate([x, x*x], Beta(2,5) 512-bin "
          f"table) and integrate([x], triangular from_pdf 512-bin table), "
          f"n_samples={C3_SAMPLES} each ({c3_n} drawn), in {c3_s:.3f} s "
          f"(host clock), {custom_launches} kernel launch(es)")
    if custom_launches < 2:
        fail("config 3 did not launch the integrate kernel for each set")
    for label, res, means, vars_, tol in (
            ("Beta(2,5)", c3_beta_result, C3_BETA_MEANS, C3_BETA_VARS,
             C3_TOLERANCE),
            ("triangular", c3_tri_result, C3_TRI_MEANS, C3_TRI_VARS, None)):
        vals = np.asarray(res.values)
        if vals.shape != (len(means),) or not np.all(np.isfinite(vals)):
            fail(f"bad config 3 result {vals!r}")
        for j, (v, mu, var) in enumerate(zip(vals, means, vars_)):
            z = (v - mu) / math.sqrt(var / c3_n)
            print(f"  {label} f{j}: {v:.7f}  closed form {mu:.7f}  z = "
                  f"{z:+.3f} (iid standard error; the strata make the "
                  "estimate closer)")
            if abs(z) > 6.0 or (tol is not None and abs(v - mu) > tol):
                fail(f"config 3 {label} f{j} is off its closed form")

    def c3_call(dist, fns):
        return lambda: tm.integrate(fns, dist, n_samples=C3_SAMPLES, seed=SEED)

    for key, prog_, dist_, fns_ in (
            ("config3_beta", c3_beta_program, c3_beta, C3_BETA_FNS),
            ("config3_triangular", c3_tri_program, c3_tri, C3_TRI_FNS)):
        modes[key] = mode_times(
            prog_, MC_CFG, prog_.library(MC_CFG, route_of(prog_, dist_)),
            dist_spec_of(dist_), C3_SAMPLES,
            c3_call(dist_, fns_), f"phase 29: {key}, strata",
            tables=tables_of(prog_, dist_))
    modes["config3_beta"]["idle_share"] = idle_share(c3_call(c3_beta,
                                                             C3_BETA_FNS))
    beta = custom_dists["strata"]
    modes["beta_k8_2e30"] = mode_times(
        program, MC_CFG, program.library(MC_CFG, route_of(program, beta)),
        dist_spec_of(beta),
        MODE_SAMPLES, lambda: tm.integrate(BENCH_FNS, beta,
                                           n_samples=MODE_SAMPLES, seed=SEED),
        "phase 29: K=8, Beta(2,5) (strata), mc", tables=tables_of(program, beta))
    is_table_cfg = IntegrateConfig("mc", True)
    is_table_result = tm.integrate_importance_sampling(
        C3_TRI_FNS, is_table_target, is_table_proposal,
        n_samples=MODE_SAMPLES, seed=SEED, return_stderr=True)
    v, se = float(is_table_result.values[0]), float(is_table_result.stderr[0])
    print(f"phase 29: importance set, E[x] under a Beta(2,5) pdf table from "
          f"U(0,1), {MODE_SAMPLES} samples: {v:.7f} +- {se:.2e}, closed "
          f"form {2.0 / 7.0:.7f}")
    if not (math.isfinite(v) and se > 0 and abs(v - 2.0 / 7.0) <= C3_TOLERANCE):
        fail("the table-weighted importance set is off its closed form")
    modes["is_table_2e30"] = mode_times(
        is_table_program, is_table_cfg, is_table_program.library(is_table_cfg),
        dist_spec_of(is_table_proposal), MODE_SAMPLES,
        lambda: tm.integrate_importance_sampling(
            C3_TRI_FNS, is_table_target, is_table_proposal,
            n_samples=MODE_SAMPLES, seed=SEED, return_stderr=True),
        "phase 29: [x], Beta(2,5) pdf-table target from U(0,1), stderr")

    max_abs_err = max(max_abs_err, *(m["max_abs_err"] for m in modes.values()))

    # 30. MCMC over CUSTOM tables: the libraries started in phase 2, then
    # every table route of the three MCMC kernels against its plain
    # version at phase 7's size.
    built = [b.result() for b in custom_mcmc_builds]
    print(f"phase 30: built the MCMC kernels' CUSTOM-table libraries for "
          f"{len(built)} programs, routes and layouts, "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for lib_, _ in built:
        for line in lib_.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    def custom_vs_plain(setup, grid, phase: str):
        """The kernel against the plain version on the same chains, as
        phases 7, 16 and 20.  Returns (max abs difference of the means,
        the plain version's milliseconds by CUDA events)."""
        got = setup["kernel"](grid)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = setup["plain"](grid)
        end.record()
        end.synchronize()
        cfg_, k_ = setup["cfg"], setup["k"]
        tempered = setup["wrapper"] is mcmc_pt_cuda
        err = chains_agree(got, want, grid, cfg_, k_, phase,
                           max_split=0.01 if tempered else 0.0)
        if tempered:
            w_k, w_p = (float(pt_finish(t, grid, cfg_, k_)[2])
                        for t in (got, want))
            print(f"         swap rate kernel {w_k:.6f} plain {w_p:.6f}")
            if not (0.0 < w_k < 1.0 and abs(w_k - w_p) <= 1e-3):
                fail(f"phase {phase}: swap rates disagree")
        return err, start.elapsed_time(end)

    custom_mcmc_err = 0.0
    for name, setup in custom_mcmc_checks:
        print(f"phase 30: {name}, {check_grid.chains_actual} chains x "
              f"({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) steps")
        custom_mcmc_err = max(custom_mcmc_err,
                              custom_vs_plain(setup, check_grid, "30")[0])

    # 31-33. Config 5 (1-D), c9f (nd) and c12d (tempered) through the
    # public API, each counted from 0, held to its closed forms; then each
    # kernel against its plain version at that shape (the plain version
    # timed in that run), the kernel timed (CUDA events), the
    # warm call timed (host clock, median of 5), the idle share of warm
    # calls and the bounds.  The bounds count the arithmetic pipes of the
    # build's SASS and leave the table loads out: under an independence
    # proposal every load is x-free; under a walk the target's two loads
    # sit on the carried chain, whose latency bound counts 4 clocks per
    # dependent instruction and none for a load.
    def knot_searches(setup):
        """(searches, on_chain, levels): the knot searches one chain-step
        of ``setup``'s run makes (per dimension and rung, one for a
        knot-exact draw, one for an irregular q-table at the candidate,
        one for an irregular target table, under HMC L slopes and a
        value), those of them on a walk's carried chain (the target's: one
        a step, L under HMC) and the fewest levels any of them takes,
        floor(log2(n + 1)) over n knots."""
        cfg, tabs = setup["cfg"], setup["tabs"]
        leap = getattr(cfg, "hmc_leapfrog", 0)
        walk = int(cfg.mode) != 0
        searches = on_chain = 0
        sizes = []
        for t in (tabs if isinstance(tabs, list) else [tabs]):
            for role, tab in (("inv", None if t is None else t.inv),
                              ("q", None if t is None else t.q),
                              ("targ", None if t is None else t.targ)):
                if not isinstance(tab, KnotTable):
                    continue
                sizes.append(tab.keys.shape[0])
                if role == "targ":
                    searches += leap + 1 if leap else 1
                    on_chain += (leap or 1) if walk else 0
                else:
                    searches += 1
        rungs = getattr(cfg, "n_temps", 1)
        levels = min((n + 1).bit_length() - 1 for n in sizes) if sizes else 0
        return searches * rungs, on_chain * rungs, levels

    def chain_bound(setup, shape, ms, grid, temps):
        """The bounds of ``setup``'s kernel at ``shape`` on ``grid``, timed
        at ``ms``: the pipes of the one-lane (tempered: ladder) build's
        SASS, its knot searches' loop bodies added at their fewest levels,
        and the carried chain's latency, a walk's searches on it at one
        dependent instruction a level; prints them and returns the
        record's fields.  Table loads are left out."""
        wrapper, cfg = setup["wrapper"], setup["cfg"]
        depth = shape["n_steps"] + shape["n_burnin"]
        c_steps = shape["n_chains"] * depth
        rungs = 1 if temps is None else cfg.n_temps
        mhz = clock_under_load(lambda s=setup: s["kernel"](grid), ms)
        conversions = (2 if wrapper is mcmc_cuda else
                       cfg.d + 1 if wrapper is mcmc_nd_cuda else
                       cfg.n_temps * (cfg.d + 1) + (cfg.n_temps - 1) // 2)
        function = {mcmc_cuda: "mcmc_kernel", mcmc_nd_cuda: "mcmc_nd_kernel",
                    mcmc_pt_cuda: "mcmc_pt_kernel"}[wrapper]
        searches, on_chain, levels = knot_searches(setup)
        bound_c = card_bound(
            custom_mcmc_library(setup, bound=True), function, conversions,
            c_steps, mhz,
            warps=function_warps(cfg.mode, grid.chains_actual, rungs),
            weights=(shape["n_steps"], shape["n_burnin"]),
            searches=searches * levels)
        print_bound(bound_c, mhz, "chain-step")
        roles = cfg.roles  # per dimension but on the 1-D kernel
        tables = (any(roles) if wrapper is mcmc_cuda
                  else any(any(r_) for r_ in roles))
        print(f"  (counted on {'the ladder layout' if temps else 'a one-lane'}"
              " build of the same program"
              + ("; the table loads are left out of both bounds)"
                 if tables else ")"))
        latency_c = print_latency(bound_c, depth, mhz)
        out = {}
        if searches:
            found = bound_c[3].get("search_loops", 0)
            search_lat = latency_ms(on_chain * levels, depth, mhz)
            latency_c += search_lat
            print(f"  knot searches: {searches} a chain-step of at least "
                  f"{levels} levels, {found:g} search loops found per unit "
                  f"in the SASS ({'added to' if found else 'none in'} the "
                  f"pipe count); {on_chain} on the carried chain, "
                  f"{search_lat:.3f} ms more latency")
            out = {"knot_searches": searches, "knot_levels": levels,
                   "search_loops": found, "knot_search_ms": search_lat}
        return {"bound_ms": max(bound_c[0], latency_c),
                "bound_by": bound_by(bound_c, latency_c),
                "bound_pipe": bound_c[1], "pipe_bound_ms": bound_c[0],
                "issue_ms": bound_c[2], "latency_ms": latency_c, **out,
                **({"bound_leaves_out": "table loads"} if tables else {})}

    def mcmc_cell(phase, name, cell, setup, tolerance=None, shape=MCMC_MAIN,
                  check=None):
        """One MCMC cell of ``shape`` (MCMC_MAIN's unless given) through
        its public call, timed and bounded, and against its plain version
        at that shape, or at ``check``'s (the cell's program: the library
        does not depend on the depth); returns its record."""
        fns, target, proposal, temps, exact = cell
        depth = shape["n_steps"] + shape["n_burnin"]
        c_steps = shape["n_chains"] * depth
        wrapper, cfg, k = setup["wrapper"], setup["cfg"], setup["k"]
        extra = {} if temps is None else {"temperatures": temps}

        def call(fns=fns, target=target, proposal=proposal, extra=extra):
            return tm.integrate_mcmc(fns, target, proposal, return_stderr=True,
                                     **extra, **shape)

        wrapper.launches = wrapper.pilot_launches = 0
        t0 = time.perf_counter()
        r = call()
        main_s = time.perf_counter() - t0
        launches_c = wrapper.launches, wrapper.pilot_launches
        print(f"phase {phase}: {name}, integrate_mcmc({shape}, "
              f"return_stderr=True{', temperatures=' + str(temps) if temps else ''})"
              f" in {main_s:.3f} s (host clock), {launches_c[0]} chain "
              f"kernel and {launches_c[1]} pilot kernel launch(es)")
        if launches_c[0] < 1 or launches_c[1] < 1:
            fail(f"{name} did not launch its MCMC kernel and its pilot")
        v, se = np.asarray(r.values), np.asarray(r.stderr)
        if v.shape != (len(exact),) or not (np.all(np.isfinite(v))
                                            and np.all(se > 0)):
            fail(f"bad {name} result {v!r} +- {se!r}")
        z = (v - np.asarray(exact)) / se
        swap = (r.diagnostics or {}).get("swap_rate")
        print("  " + ", ".join(
            f"E[f{j}] = {v[j]:.6f} +- {se[j]:.6f} (closed form {exact[j]}, "
            f"z = {z[j]:+.2f})" for j in range(len(exact)))
            + f", acceptance {r.acceptance_rate:.4f}"
            + ("" if swap is None else f", swap rate {swap:.4f}")
            + f", n_samples {r.n_samples}")
        if name in ("config5", "c12d"):
            # The bimodal table's own moments (the sampled target, its
            # 128-knot log table on (-6, 6)), beside the closed forms.
            own = table_moments(target, range(3 - len(exact), 3))
            print("  against the tabulated target's own moments: " + ", ".join(
                f"E[f{j}] {own[j]:.6f} (z = {(v[j] - own[j]) / se[j]:+.2f})"
                for j in range(len(exact))))
        if np.any(np.abs(z) > 6.0) or not 0.0 < r.acceptance_rate < 1.0:
            fail(f"{name}: the estimates are not within 6 stderr of {exact}")
        if tolerance is not None and np.any(np.abs(v - exact) > tolerance):
            fail(f"{name}: the estimates are off by more than {tolerance}")
        if swap is not None and not 0.0 < swap < 1.0:
            fail(f"{name}: swap rate {swap} is not in (0, 1)")
        check = check or shape
        err, plain_ms_c = custom_vs_plain(
            setup if check is shape else custom_mcmc_setup(
                fns, target, proposal, temps, check["n_steps"],
                check["n_burnin"], True),
            main_grid if check is shape else check_grid, str(phase))
        ms_c = time_ms(lambda s=setup: s["kernel"](main_grid), reps=10)
        call_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            call_s.append(time.perf_counter() - t0)
        call_ms = float(np.median(call_s)) * 1e3
        rungs = 1 if temps is None else cfg.n_temps
        print(f"phase {phase}: {main_grid.chains_actual} chains"
              f"{'' if temps is None else f' x {rungs} rungs'} x "
              f"({shape['n_burnin']} + {shape['n_steps']}) steps, "
              f"{name}, stderr, on {card}: kernel {ms_c:.3f} ms "
              f"({c_steps / ms_c * 1e3:.4e} chain-steps/s), plain "
              f"{plain_ms_c:.3f} ms at ({check['n_burnin']} + "
              f"{check['n_steps']}) steps, integrate_mcmc() end to end "
              f"{call_ms:.3f} ms median of 5, host clock")
        bounds = chain_bound(setup, shape, ms_c, main_grid, temps)
        print(f"  {name}:", end="")
        return {
            "launches": launches_c[0], "pilot_launches": launches_c[1],
            "n_steps": shape["n_steps"], "max_abs_err": err, "ms": ms_c,
            "plain_ms": plain_ms_c,
            "plain_steps": [check["n_burnin"], check["n_steps"]],
            "call_ms": call_ms, **bounds, "library_ms": None,
            "idle_share": idle_share(call), "values": v.tolist(),
            "stderr": se.tolist(),
            **({} if swap is None else {"swap_rate": swap}),
        }

    custom_mcmc = {}
    for phase, (name, cell) in zip((31, 32, 33), custom_mcmc_cells.items()):
        custom_mcmc[name] = mcmc_cell(
            phase, name, cell, custom_mcmc_main[name],
            C5_TOLERANCE if name == "config5" else None, shape=SHORT_MCMC)
        custom_mcmc[name]["max_abs_err"] = max(
            custom_mcmc[name]["max_abs_err"], custom_mcmc_err)

    # 34-38. The extended families: their libraries (started in phase 2),
    # kernel 1 under each family in every mode against its plain version,
    # the bench set under each at 2**30 through integrate(), counted,
    # timed and bounded; the family cells of the MCMC, nd and tempered
    # kernels at their main shapes; the JAX package's parity checks.
    t_families = time.perf_counter()
    built = [b.result() for b in family_builds]
    print(f"phase 34: built the extended families' {len(built)} libraries, "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2), waited "
          f"{time.perf_counter() - t_families:.1f} s for the last")
    for lib_, _ in built:
        for line in lib_.build_log.splitlines():
            if "spill" in line and " 0 bytes spill" not in line:
                print(f"  ptxas: {line.strip()}")
    family_err = max(
        mode_vs_plain(program, d, cfg, MODE_CHECK_SAMPLES, "34")
        for d in family_dists.values() for cfg in family_cfgs.values())
    integrate_cuda.launches = 0
    family_results = {
        name: tm.integrate(BENCH_FNS, d, n_samples=MODE_SAMPLES, seed=SEED)
        for name, d in family_dists.items()}
    family_launches = integrate_cuda.launches
    print(f"phase 34: integrate(8 fns, <family>, n_samples={MODE_SAMPLES}) "
          f"for the {len(family_dists)} families, {family_launches} kernel "
          "launch(es): E[x] " + ", ".join(
              f"{name} {float(r.values[0]):.6g}"
              for name, r in family_results.items()))
    if family_launches < len(family_dists):
        fail("the families did not each launch the integrate kernel")
    for name, r in family_results.items():
        vals = np.asarray(r.values)
        if vals.shape != (len(BENCH_FNS),) or not np.all(np.isfinite(vals)):
            fail(f"bad {name} result {vals!r}")
    family_times = {}
    for name, d in family_dists.items():
        family_times[name] = mode_times(
            program, MC_CFG, program.library(MC_CFG, family_kinds[name]),
            dist_spec_of(d), MODE_SAMPLES,
            lambda d=d: tm.integrate(BENCH_FNS, d, n_samples=MODE_SAMPLES,
                                     seed=SEED),
            f"phase 34: K=8, {name}{FAMILY_ARGS[name]}, mc",
            check_n=MODE_CHECK_SAMPLES)
        family_times[name]["args"] = list(FAMILY_ARGS[name])
    # Kept apart from the kernel's max_abs_err: a Cauchy column of x^4 is
    # 1e19, so its float32 sums differ by whole units in two orders.
    family_err = max(family_err,
                     *(f["max_abs_err"] for f in family_times.values()))

    # 35. The 1-D MCMC kernel's family checks, then c5b's shape with a
    # Laplace target and a logistic proposal.
    def family_checks(phase: str, one_d: bool) -> float:
        err_ = 0.0
        for name, setup in family_mcmc_checks:
            if name.startswith("1-D") != one_d:
                continue
            print(f"phase {phase}: {name}, {check_grid.chains_actual} chains "
                  f"x ({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) "
                  "steps")
            err_ = max(err_, custom_vs_plain(setup, check_grid, phase)[0])
        return err_

    family_mcmc_err = family_checks("35", True)
    family_mcmc = {
        "c5b_family": mcmc_cell(35, "c5b_family",
                                family_mcmc_cells["c5b_family"],
                                family_mcmc_main["c5b_family"],
                                shape=SHORT_MCMC)}

    # 36. The nd kernel over family dimensions: every family against the
    # plain version at 2**24 in mc, antithetic and qmc; then c9's shape
    # over Lognormal(0,0.5) x Gumbel(1,0.5) through integrate(), counted,
    # against its closed forms, the plain version, timed and bounded.
    fam_nd_err = max(
        nd_vs_plain(prog, dims, method, with_stderr, CHECK_SAMPLES, "36")
        for prog, dims in zip(fam_nd_programs, fam_nd_dims)
        for method, with_stderr in (("mc", False), ("antithetic", False),
                                    ("qmc", False), ("mc", True)))
    integrate_nd_cuda.launches = 0
    result = tm.integrate(FAM_C9_FNS, fam_c9_dists, n_samples=MODE_SAMPLES,
                          seed=SEED)
    fam_nd_launches = integrate_nd_cuda.launches
    fam_c9_grid = plan_grid(make_integrate_plan(MODE_SAMPLES).actual_samples)
    n_fam = fam_c9_grid.actual_samples
    print(f"phase 36: integrate([x*y, x*x+y], [Lognormal(0,0.5), "
          f"Gumbel(1,0.5)], n_samples={MODE_SAMPLES}) drew {n_fam} samples, "
          f"{fam_nd_launches} kernel launch(es)")
    if fam_nd_launches < 1:
        fail("the family nd path did not launch the nd kernel")
    values = np.asarray(result.values)
    if values.shape != (2,) or not np.all(np.isfinite(values)):
        fail(f"bad family nd result {values!r}")
    for j, (v, mu, var) in enumerate(zip(values, FAM_C9_MEANS, FAM_C9_VARS)):
        z = (v - mu) / math.sqrt(var / n_fam)
        print(f"  f{j}: {v:+.7f}  closed form {mu:+.7f}  z = {z:+.2f}")
        if abs(z) > 6.0:
            fail(f"family nd f{j} is {z:.1f} sigma from its closed form")
    fam_c9_cfg = NdConfig(fam_c9_kinds)
    fam_c9_params = torch.tensor(
        np.stack([dist_spec_of(d).params for d in fam_c9_dists]), device=dev)
    fam_nd_err = max(fam_nd_err, nd_vs_plain(fam_c9_program, fam_c9_dists, "mc",
                                             False, MODE_SAMPLES, "36"))

    def fam_c9_run():
        return integrate_nd_cuda(fam_c9_program, fam_c9_cfg, fam_c9_params,
                                 SEED, fam_c9_grid)

    fam_nd_ms = time_ms(fam_c9_run, reps=10)
    fam_nd_plain_ms = time_ms(
        lambda: integrate_nd_reference(fam_c9_program.torch_fns, fam_c9_cfg,
                                       fam_c9_params, SEED, fam_c9_grid),
        reps=1)
    call_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        tm.integrate(FAM_C9_FNS, fam_c9_dists, n_samples=MODE_SAMPLES,
                     seed=SEED)
        call_s.append(time.perf_counter() - t0)
    fam_nd_call_ms = float(np.median(call_s)) * 1e3
    print(f"phase 36: {n_fam} samples, d=2, K=2, Lognormal x Gumbel on "
          f"{card}: kernel {fam_nd_ms:.3f} ms, plain {fam_nd_plain_ms:.3f} ms,"
          f" integrate() end to end {fam_nd_call_ms:.3f} ms median of 3, "
          "host clock")
    mhz = clock_under_load(fam_c9_run, fam_nd_ms)
    fam_nd_bound = card_bound(fam_c9_program.library(),
                              "integrate_nd_kernelILi0ELb0EE", 2, n_fam, mhz)
    print_bound(fam_nd_bound, mhz, "sample")

    # 37. The nd and tempered kernels' family checks, then their family
    # cells: c9e's shape over a product of family dimensions, c12's ladder
    # on a family target.
    family_mcmc_err = max(family_mcmc_err, family_checks("37", False))
    for name, phase in (("c9e_family", 37), ("c12_family", 37)):
        family_mcmc[name] = mcmc_cell(phase, name, family_mcmc_cells[name],
                                      family_mcmc_main[name],
                                      shape=SHORT_MCMC)
    for rec in family_mcmc.values():
        rec["max_abs_err"] = max(rec["max_abs_err"], family_mcmc_err)

    # 38. The JAX package's parity checks of the families, on the card.
    parity = {}
    for name, args, truth in PARITY_MEANS:
        r = tm.integrate(PARITY_MEAN_FNS, getattr(tm.Distribution, name)(*args),
                         n_samples=PARITY_SAMPLES, seed=SEED,
                         return_stderr=True)
        v, se = float(r.values[0]), float(r.stderr[0])
        z = (v - truth) / max(se, 1e-12)
        parity[f"family_{name}_mean"] = [v, z]
        print(f"phase 38: {name}{args}: E[X] {v:.6f} +- {se:.2e}, exact "
              f"{truth:.6f}, z = {z:+.2f}")
        if not (abs(v - truth) <= 0.02 * max(abs(truth), 0.5) and abs(z) <= 6.0):
            fail(f"parity: {name}'s mean is off")
    rc = tm.integrate(PARITY_CAUCHY_FNS, tm.Distribution.cauchy(2.0, 1.5),
                      n_samples=PARITY_SAMPLES, seed=SEED)
    parity["family_cauchy_cdf"] = np.asarray(rc.values).tolist()
    print(f"phase 38: Cauchy(2,1.5) CDF at 2, 0.5, 3.5: {rc.values} "
          "(0.5, 0.25, 0.75 within 0.005)")
    if not np.all(np.abs(np.asarray(rc.values) - [0.5, 0.25, 0.75]) <= 0.005):
        fail("parity: the Cauchy CDF is off")
    rlm = tm.integrate_mcmc(PARITY_MEAN_FNS, fam_laplace,
                            tm.Distribution.logistic(0.0, 2.0), n_steps=4000,
                            n_chains=2048, n_burnin=500, seed=SEED)
    parity["family_mcmc_laplace_target"] = float(rlm.values[0])
    print(f"phase 38: MCMC, Laplace(3,1) from Logistic(0,2): E[X] "
          f"{float(rlm.values[0]):.6f} (3 within 0.1)")
    if abs(float(rlm.values[0]) - 3.0) > 0.1:
        fail("parity: the family MCMC mean is off")
    rwq = tm.integrate(PARITY_MEAN_FNS, tm.Distribution.weibull(1.5, 2.0),
                       n_samples=1 << 21, seed=SEED, method="qmc")
    want_w = 2.0 * math.gamma(1.0 + 1.0 / 1.5)
    parity["family_weibull_qmc"] = float(rwq.values[0])
    print(f"phase 38: Weibull(1.5,2) QMC at 2**21: E[X] "
          f"{float(rwq.values[0]):.6f} ({want_w:.6f} within 0.005)")
    if abs(float(rwq.values[0]) - want_w) > 0.005:
        fail("parity: the Weibull QMC mean is off")
    print(f"phases 34-38 (the extended families) took "
          f"{time.perf_counter() - t_families:.1f} s after phase 33")

    # 39. nd over CUSTOM dimensions and nd importance sets: the libraries
    # started in phase 2, then each route and weight kind against its
    # plain version at 2**22.
    t_nd_new = time.perf_counter()
    built = [b.result() for b in nd_new_builds]
    print(f"phase 39: built the nd kernel's CUSTOM and importance libraries "
          f"for {len(built)} programs and routes, "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for lib_, _ in built:
        for line in lib_.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    def nd_new_vs_plain(prog, props, cfg_, tables_, n, name, phase):
        """The nd kernel against its plain version on the same samples:
        means within rel 1e-5 + abs 1e-6 and error bars within rel 1e-4
        + abs 1e-9, each absolute term times the column's size (its mean
        |value| on the pilot grid, weighted, or |mean| if larger).
        Returns (max abs diff of the means, the kernel's sums, params,
        grid, pilot)."""
        grid_ = plan_grid(make_integrate_plan(n).actual_samples, cfg_.method)
        params_ = torch.tensor(
            np.stack([dist_spec_of(q).params for q in props]), device=dev)
        pilot_ = (pilot_row(prog.torch_fns, prog.kinds, params_, tables_,
                            prog.torch_weight) if cfg_.with_stderr else None)
        # The weight is never negative: |f w| = |f| w.
        size = pilot_row([lambda *x, f=f: f(*x).abs() for f in prog.torch_fns],
                         prog.kinds, params_, tables_, prog.torch_weight)
        got = integrate_nd_cuda(prog, cfg_, params_, SEED, grid_, pilot_,
                                tables_)
        torch.cuda.synchronize()
        want = integrate_nd_reference(prog.torch_fns, cfg_, params_, SEED,
                                      grid_, pilot_, tables_,
                                      prog.torch_weight)
        if cfg_.with_stderr:
            (m_k, s_k), (m_p, s_p) = (
                [t.double().cpu().numpy() for t in
                 finish_stderr(o[0], o[1], pilot_, grid_, cfg_.antithetic)]
                for o in (got, want))
        else:
            n_f = float(np.float32(grid_.actual_samples))
            m_k, m_p = ((o / n_f).double().cpu().numpy() for o in (got, want))
        size = np.maximum(size.double().cpu().numpy(), np.abs(m_p))
        err = np.abs(m_k - m_p)
        label = (f"phase {phase}: {name}, {cfg_.method}"
                 f"{' + stderr' if cfg_.with_stderr else ''}, routes "
                 f"{nk_routes(cfg_, tables_)}, {grid_.actual_samples} samples")
        print(f"{label}: kernel {m_k}")
        print(f"         plain  {m_p}  max|diff|/size "
              f"{np.max(err / np.maximum(size, 1e-30)):.3e}")
        if not np.all(np.isfinite(m_k)):
            fail(f"{label}: non-finite kernel means")
        if not np.all(err <= RTOL * np.abs(m_p) + ATOL * size):
            fail(f"{label}: kernel and plain version disagree")
        if cfg_.with_stderr:
            print(f"         stderr kernel {s_k} plain {s_p}")
            if not (np.all(s_k > 0) and np.all(
                    np.abs(s_k - s_p) <= ND_STDERR_RTOL * np.abs(s_p)
                    + STDERR_1D_ATOL * size)):
                fail(f"{label}: error bars disagree")
        return float(err.max()), params_, grid_, pilot_

    nd_new_err = max(
        nd_new_vs_plain(c[1], c[2], c[3], c[4], MODE_CHECK_SAMPLES, c[0],
                        "39")[0] for c in nd_new_checks)

    def nd_new_times(key, n, call, label, phase):
        """A main path's kernel timed (CUDA events, 10 launches) against
        its plain version (held to phase 39's gates), its warm call (host
        clock, median of 3) and its bound, as phase 14 counts it (table
        loads left out: they take no arithmetic pipe)."""
        prog, props, method, stderr = nd_new_main[key]
        cfg_, tables_ = nd_new_setup(prog, props, method, stderr)
        err, params_, grid_, pilot_ = nd_new_vs_plain(
            prog, props, cfg_, tables_, n, label, phase)

        def run():
            integrate_nd_cuda(prog, cfg_, params_, SEED, grid_, pilot_,
                              tables_)

        k_ms = time_ms(run, reps=10)
        p_ms = time_ms(lambda: integrate_nd_reference(
            prog.torch_fns, cfg_, params_, SEED, grid_, pilot_, tables_,
            prog.torch_weight), reps=1)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        c_ms = float(np.median(walls)) * 1e3
        drawn = grid_.actual_samples
        mhz_ = clock_under_load(run, k_ms)
        bound = card_bound(
            prog.library(nk_routes(cfg_, tables_)),
            f"integrate_nd_kernelILi0ELb{int(stderr)}EE", len(props), drawn,
            mhz_)
        print(f"phase {phase}: {label}, {drawn} samples on {card}: kernel "
              f"{k_ms:.3f} ms ({drawn / k_ms * 1e3:.4e} samples/s), plain "
              f"{p_ms:.3f} ms, call end to end {c_ms:.3f} ms median of 3, "
              "host clock")
        print_bound(bound, mhz_, "sample")
        return {"samples": drawn, "ms": k_ms, "plain_ms": p_ms,
                "call_ms": c_ms, "bound_ms": bound[0], "bound_pipe": bound[1],
                "issue_ms": bound[2], "max_abs_err": err}

    def moments_hold(label, values, means, vars_, n, tol=None):
        values = np.asarray(values)
        if values.shape != (len(means),) or not np.all(np.isfinite(values)):
            fail(f"bad {label} result {values!r}")
        for j, (v, mu, var) in enumerate(zip(values, means, vars_)):
            z = (v - mu) / math.sqrt(var / n)
            print(f"  {label} f{j}: {v:.7f}  closed form {mu:.7f}  z = "
                  f"{z:+.3f} (iid standard error)")
            if abs(z) > 6.0 or (tol is not None and abs(v - mu) > tol):
                fail(f"{label} f{j} is off its closed form")

    # 40. c9b through integrate(), counted from 0: 1/7 within 6 sigma and
    # the reference's 0.01; then its kernel, warm call and idle share.
    def c9b_call():
        return tm.integrate(C9B_FNS, [beta25, u01], n_samples=C9B_SAMPLES,
                            seed=SEED)

    integrate_nd_cuda.launches = 0
    t0 = time.perf_counter()
    c9b_result = c9b_call()
    c9b_s = time.perf_counter() - t0
    c9b_launches = integrate_nd_cuda.launches
    c9b_n = plan_grid(make_integrate_plan(C9B_SAMPLES).actual_samples
                      ).actual_samples
    print(f"phase 40: c9b, integrate([x*y], [Beta(2,5), U(0,1)], n_samples="
          f"{C9B_SAMPLES}) drew {c9b_n} samples in {c9b_s:.3f} s (host "
          f"clock), {c9b_launches} kernel launch(es)")
    if c9b_launches < 1:
        fail("c9b did not launch the nd kernel")
    moments_hold("c9b", c9b_result.values, [C9B_MEAN], [C9B_VAR], c9b_n,
                 C9B_TOLERANCE)
    nd_custom = {"c9b": nd_new_times("c9b", C9B_SAMPLES, c9b_call,
                                     "c9b, strata", "40")}
    nd_custom["c9b"]["idle_share"] = idle_share(c9b_call)

    # 41. c9's set at 2**30 with its normal dimension made CUSTOM, counted,
    # timed and bounded beside c9.
    def c9_custom_call():
        return tm.integrate(ND_FNS, [beta25, u01, e2], n_samples=MODE_SAMPLES,
                            seed=SEED)

    integrate_nd_cuda.launches = 0
    c9c_result = c9_custom_call()
    c9_custom_launches = integrate_nd_cuda.launches
    if c9_custom_launches < 1:
        fail("c9's CUSTOM set did not launch the nd kernel")
    n_c9c = plan_grid(make_integrate_plan(MODE_SAMPLES).actual_samples
                      ).actual_samples
    print(f"phase 41: integrate([x*y*z, x*x+y+z], [Beta(2,5), U(0,1), "
          f"Exp(2)], n_samples={MODE_SAMPLES}), {c9_custom_launches} kernel "
          f"launch(es); c9 (N(0,1) in its place) {nd_ms:.3f} ms")
    moments_hold("c9_custom", c9c_result.values, ND_CUSTOM_MEANS,
                 ND_CUSTOM_VARS, n_c9c)
    nd_custom["c9_custom"] = nd_new_times(
        "c9_custom", MODE_SAMPLES, c9_custom_call,
        "c9's set over Beta(2,5) x U(0,1) x Exp(2), strata", "41")

    # 42. nd importance sampling, a rare event at 1e8 with error bars and
    # diagnostics, counted: within 6 standard errors of Phi-bar(3)^2.
    rare_props = nd_new_main["rare"][1]

    def rare_call():
        return tm.integrate_importance_sampling(
            ND_RARE_FNS, [n01, n01], rare_props, n_samples=ND_RARE_SAMPLES,
            seed=SEED, return_stderr=True, return_diagnostics=True)

    integrate_nd_cuda.launches = 0
    t0 = time.perf_counter()
    rare = rare_call()
    rare_s = time.perf_counter() - t0
    rare_launches = integrate_nd_cuda.launches
    v, se = float(rare.values[0]), float(rare.stderr[0])
    print(f"phase 42: integrate_importance_sampling([(x > 3)(y > 3)], "
          f"[N(0,1)]*2, [N(3.5,1.5)]*2, n_samples={ND_RARE_SAMPLES}, "
          f"return_stderr=True, return_diagnostics=True) in {rare_s:.3f} s "
          f"(host clock), {rare_launches} kernel launch(es): {v:.6e} +- "
          f"{se:.3e} (exact {ND_RARE_EXACT:.6e}, z = "
          f"{(v - ND_RARE_EXACT) / se:+.3f}); diagnostics {rare.diagnostics}")
    if rare_launches < 1:
        fail("the nd rare event did not launch the nd kernel")
    if not (math.isfinite(v) and se > 0
            and abs(v - ND_RARE_EXACT) <= 6.0 * se):
        fail("the nd rare event is not within 6 standard errors")
    nd_is = {"rare": nd_new_times("rare", ND_RARE_SAMPLES, rare_call,
                                  "nd rare event, traced weights, stderr",
                                  "42")}
    nd_is["rare"]["idle_share"] = idle_share(rare_call)
    nd_is["rare"].update(value=v, stderr=se)

    # 43. nd importance sampling with table and sampler weights at 2**30:
    # 2/7 within 6 standard errors; timed and bounded.
    def ts_call():
        return tm.integrate_importance_sampling(
            ND_TS_FNS, [beta_tab, n01], ts_props, n_samples=MODE_SAMPLES,
            seed=SEED, return_stderr=True)

    integrate_nd_cuda.launches = 0
    ts = ts_call()
    ts_launches = integrate_nd_cuda.launches
    v, se = float(ts.values[0]), float(ts.stderr[0])
    print(f"phase 43: integrate_importance_sampling([x*y*y], [Beta(2,5) pdf "
          f"table, N(0,1)], [Beta(1.5,3), N(0,1.5)], n_samples="
          f"{MODE_SAMPLES}, return_stderr=True), {ts_launches} kernel "
          f"launch(es): {v:.7f} +- {se:.2e} (exact {ND_TS_EXACT:.7f}, z = "
          f"{(v - ND_TS_EXACT) / se:+.3f})")
    if ts_launches < 1:
        fail("the table/sampler nd importance set did not launch the kernel")
    if not (math.isfinite(v) and se > 0 and abs(v - ND_TS_EXACT) <= 6.0 * se):
        fail("the table/sampler nd importance set is off 2/7")
    nd_is["table_sampler"] = nd_new_times(
        "table_sampler", MODE_SAMPLES, ts_call,
        "[x*y*y], table p and sampler q (strata), traced p and q, stderr",
        "43")
    nd_is["table_sampler"].update(value=v, stderr=se)
    for rec in (*nd_custom.values(), *nd_is.values()):
        nd_new_err = max(nd_new_err, rec["max_abs_err"])
    print(f"phases 39-43 (nd CUSTOM dimensions and nd importance sampling) "
          f"took {time.perf_counter() - t_nd_new:.1f} s")

    # 44-47. Split-R-hat, ESS and thinned draws in the three MCMC kernels:
    # the libraries started in phase 2; each main path through the public
    # API with both outputs, counted, gated and held bit for bit against
    # its run without them; then its kernel against its plain version at
    # that shape, the kernel timed with both outputs and without them, and
    # a run at MCMC_CHECK's shape with REMAINDER_DRAWS draws into a guarded
    # buffer, held against its plain version.
    t_outputs = time.perf_counter()
    built = [b.result() for b in outputs_builds]
    print(f"phase 44: built the MCMC kernels' {len(built)} libraries with "
          "diagnostics and draws (c5b, the slow-mixing run, c9e, c12 and "
          "its ladder layout with both), "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for out_lib, _ in built:
        for line in out_lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    mcmc_grid = plan_mcmc_grid(plan_chains(MCMC_MAIN["n_chains"], None))
    stride = SHORT_MCMC["n_steps"] // DRAWS

    def outputs_vs_plain(got, want, grid, cfg, k, phase, max_split=0.0):
        """Phase 7's checks of two runs of the same chains, then R-hat
        within rel 1e-4, ESS within rel 1e-3, and the draws chain for chain
        (no more split than ``max_split``).  Returns (max abs difference
        of the means, of R-hat and ESS relative, share of split draws)."""
        err = chains_agree(got, want, grid, cfg, k, phase, max_split)
        (r_k, e_k), (r_p, e_p) = (mcmc_diagnostics(o, grid, cfg, k)
                                  for o in (got, want))
        r_err = float(((r_k - r_p).abs() / r_p.abs()).max())
        e_err = float(((e_k - e_p).abs() / e_p.abs()).max())
        split = 0.0
        if cfg.samples:
            s_k, s_p = (o.samples.reshape(cfg.samples, -1, grid.chains_actual)
                        for o in (got, want))
            split = float(((s_k - s_p).abs() > 1e-3 * (1.0 + s_p.abs()))
                          .any(dim=1).float().mean())
        print(f"         r_hat kernel {r_k.cpu().numpy()} plain "
              f"{r_p.cpu().numpy()} (rel {r_err:.2e}); ess kernel "
              f"{e_k.cpu().numpy()} plain {e_p.cpu().numpy()} (rel "
              f"{e_err:.2e}); split draws {split:.4%}")
        if not (torch.isfinite(r_k).all() and torch.isfinite(e_k).all()):
            fail(f"phase {phase}: non-finite R-hat or ESS")
        if r_err > R_HAT_RTOL or e_err > ESS_RTOL:
            fail(f"phase {phase}: kernel and plain R-hat or ESS disagree")
        if split > max_split:
            fail(f"phase {phase}: {split:.4%} of the draws split")
        return err, r_err, e_err, split

    def unchanged(got, bare, phase):
        """Fails unless a run with the outputs has the rows and final
        states of the same run without them, bit for bit."""
        if not (torch.equal(got.rows[:, :3], bare.rows)
                and torch.equal(got.x_final, bare.x_final)):
            fail(f"phase {phase}: the outputs changed the chains or rows")

    def timed_plain(plain):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        end.synchronize()
        return want, start.elapsed_time(end)

    def outputs_times(run, bare_run):
        """The kernel's ms with both outputs and without them, one after
        the other in this call (CUDA events, 10 launches each).
        ``tools/mcmc_layout_sweep.py --outputs`` times each output alone."""
        return {"ms": time_ms(run, reps=10),
                "ms_without": time_ms(bare_run, reps=10)}

    import tpu_montecarlo_torch.ops.mcmc_kernel as mcmc_kernel_mod
    import tpu_montecarlo_torch.ops.mcmc_nd_kernel as mcmc_nd_kernel_mod

    check_grid = plan_mcmc_grid(plan_chains(MCMC_CHECK["n_chains"], None))

    def remainder_check(kernel, plain, cfg, k, phase, max_split=0.0):
        """Runs ``kernel(cfg, grid)`` at MCMC_CHECK's shape with
        REMAINDER_DRAWS draws, its draws' buffer the first m rows of one
        DRAW_GUARD rows longer filled with a sentinel: fails if a row past
        the m draws changed, else holds the run against ``plain(cfg,
        grid)`` (``outputs_vs_plain``) and returns its errors."""
        cfg = replace(cfg, n_steps=MCMC_CHECK["n_steps"],
                      n_burnin=MCMC_CHECK["n_burnin"],
                      samples=REMAINDER_DRAWS)
        sentinel, whole = -7777.0, []

        def guarded(cfg_, shape, dev, lead=()):  # one job: lead is ()
            buf = torch.full((cfg_.samples + DRAW_GUARD, *shape), sentinel,
                             dtype=torch.float32, device=dev)
            whole.append(buf)
            return buf[:cfg_.samples]

        # The nd and tempered wrappers share the nd module's launch.
        mods = (mcmc_kernel_mod, mcmc_nd_kernel_mod)
        saved = [m_.sample_buffer for m_ in mods]
        for m_ in mods:
            m_.sample_buffer = guarded
        try:
            got = kernel(cfg, check_grid)
            torch.cuda.synchronize()
        finally:
            for m_, f_ in zip(mods, saved):
                m_.sample_buffer = f_
        past = whole[0][REMAINDER_DRAWS:]
        print(f"phase {phase}: {check_grid.chains_actual} chains x "
              f"({cfg.n_burnin} + {cfg.n_steps}) steps, {cfg.samples} draws "
              f"(stride {cfg.n_steps // cfg.samples}); rows past the draws "
              f"untouched: {bool((past == sentinel).all())}")
        if not bool((past == sentinel).all()):
            fail(f"phase {phase}: the kernel wrote draws past its m rows")
        return outputs_vs_plain(got, plain(cfg, check_grid), check_grid,
                                cfg, k, phase, max_split)

    def warm_call_ms(call):
        call_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            call_s.append(time.perf_counter() - t0)
        return float(np.median(call_s)) * 1e3

    def gate_draws(name, r, f, phase):
        """The draws' mean of f within 6 x (the run's stderr x
        sqrt(stride)) of the value."""
        m_f = float(np.mean(f(r.samples)))
        tol = 6.0 * float(r.stderr[0]) * math.sqrt(stride)
        print(f"  {name}: draws' mean of f {m_f:.6f}, value "
              f"{float(r.values[0]):.6f} (within {tol:.2e})")
        if abs(m_f - float(r.values[0])) > tol:
            fail(f"phase {phase}: {name}'s draws do not average to its value")

    outputs = {}

    # 44. 1-D, c5b's shape.
    o_prog, o_cfg, o_params, _ = c5b_out

    def c5b_call(**extra):
        return tm.integrate_mcmc(MCMC_MAIN_FNS, n01, n02, return_stderr=True,
                                 **extra, **SHORT_MCMC)

    for c in ("launches", "pilot_launches", "diag_launches",
              "sample_launches"):
        setattr(mcmc_cuda, c, 0)
    t0 = time.perf_counter()
    r = c5b_call(return_diagnostics=True, return_samples=DRAWS)
    main_s = time.perf_counter() - t0
    counts = {c: getattr(mcmc_cuda, c) for c in (
        "launches", "pilot_launches", "diag_launches", "sample_launches")}
    rh = r.diagnostics["r_hat"]
    print(f"phase 44: integrate_mcmc([x*x], N(0,1), N(0,2), {SHORT_MCMC}, "
          f"return_stderr=True, return_diagnostics=True, return_samples="
          f"{DRAWS}) in {main_s:.3f} s (host clock), launches {counts}; "
          f"E[x^2] = {r.values[0]:.6f} +- {r.stderr[0]:.6f}, r_hat {rh}, "
          f"ess {r.diagnostics['ess']}, samples {r.samples.shape}")
    if min(counts.values()) < 1:
        fail("phase 44: the main path did not launch the kernel with its "
             "outputs")
    if r.samples.shape != (DRAWS, mcmc_grid.chains_actual) or not (
            np.isfinite(r.samples).all() and np.isfinite(rh).all()):
        fail("phase 44: bad draws or R-hat")
    if not np.all((0.99 < rh) & (rh < 1.02)):
        fail("phase 44: c5b's R-hat is not in (0.99, 1.02)")
    gate_draws("c5b", r, lambda s: s * s, "44")
    r0 = c5b_call()
    if not (np.array_equal(r.values, r0.values)
            and np.array_equal(r.stderr, r0.stderr)
            and r.acceptance_rate == r0.acceptance_rate):
        fail("phase 44: values or error bars moved with the outputs")
    got = mcmc_cuda(o_prog, o_cfg, o_params, SEED, mcmc_grid)
    want, plain_ms_o = timed_plain(lambda: mcmc_reference(
        o_prog.torch_fns, o_cfg, o_params, SEED, mcmc_grid))
    errs = outputs_vs_plain(got, want, mcmc_grid, o_cfg, 1, "44")
    short_cfg = replace(mcmc_main_cfg, n_steps=SHORT_MCMC["n_steps"])
    bare = mcmc_cuda(mcmc_program, short_cfg, o_params, SEED, mcmc_grid)
    unchanged(got, bare, "44")
    times = outputs_times(
        lambda: mcmc_cuda(o_prog, o_cfg, o_params, SEED, mcmc_grid),
        lambda: mcmc_cuda(mcmc_program, short_cfg, o_params, SEED,
                          mcmc_grid))
    rem_errs = remainder_check(
        lambda c, g: mcmc_cuda(o_prog, c, o_params, SEED, g),
        lambda c, g: mcmc_reference(o_prog.torch_fns, c, o_params, SEED, g),
        o_cfg, 1, "44")
    call_ms = warm_call_ms(lambda: c5b_call(return_diagnostics=True,
                                            return_samples=DRAWS))
    print("  c5b with both outputs:", end="")
    idle = idle_share(lambda: c5b_call(return_diagnostics=True,
                                        return_samples=DRAWS))
    outputs["mcmc"] = dict(counts, max_abs_err=max(errs[0], rem_errs[0]),
                           r_hat_rel_err=max(errs[1], rem_errs[1]),
                           ess_rel_err=max(errs[2], rem_errs[2]),
                           split_draws=errs[3],
                           remainder_split_draws=rem_errs[3],
                           plain_ms=plain_ms_o, call_ms=call_ms,
                           idle_share=idle, draws=DRAWS, r_hat=rh.tolist(),
                           n_steps=SHORT_MCMC["n_steps"], **times)
    print(f"phase 44: c5b on {card}: kernel with both outputs "
          f"{times['ms']:.4f} ms, without them "
          f"{times['ms_without']:.4f} ms; plain {plain_ms_o:.3f} ms; warm call with both "
          f"{call_ms:.3f} ms median of 3 (host clock); "
          f"{time.perf_counter() - t_outputs:.1f} s")

    # 45. The slow-mixing run: its R-hat must flag it.
    t45 = time.perf_counter()
    s_prog, s_cfg, s_params, _ = slow_out
    mcmc_cuda.diag_launches = 0
    r = tm.integrate_mcmc(SLOW_FNS, n01, tm.Distribution.normal(*SLOW_PROPOSAL),
                          return_diagnostics=True, **SLOW_RUN)
    slow_grid = plan_mcmc_grid(plan_chains(SLOW_RUN["n_chains"], None))
    got = mcmc_cuda(s_prog, s_cfg, s_params, SEED, slow_grid)
    want = mcmc_reference(s_prog.torch_fns, s_cfg, s_params, SEED, slow_grid)
    print(f"phase 45: integrate_mcmc([x], N(0,1), N(4,0.3), {SLOW_RUN}, "
          f"return_diagnostics=True): r_hat {r.diagnostics['r_hat']}, ess "
          f"{r.diagnostics['ess']}, {mcmc_cuda.diag_launches} diagnostics "
          "launch(es); kernel against plain version (seed 42):")
    slow_errs = outputs_vs_plain(got, want, slow_grid, s_cfg, 1, "45")
    if mcmc_cuda.diag_launches < 1 or not r.diagnostics["r_hat"][0] > 1.1:
        fail("phase 45: R-hat does not flag the slow-mixing run")
    outputs["mcmc"]["slow_mixing_r_hat"] = float(r.diagnostics["r_hat"][0])
    print(f"phase 45: {time.perf_counter() - t45:.1f} s")

    # 46. nd, c9e's shape.
    t46 = time.perf_counter()
    o_prog, o_cfg, o_params = c9e_out

    def c9e_call(**extra):
        return tm.integrate_mcmc(c9e_fns_, c9e_target_, c9e_proposal_,
                                 return_stderr=True, **extra, **SHORT_MCMC)

    for c in ("launches", "pilot_launches", "diag_launches",
              "sample_launches"):
        setattr(mcmc_nd_cuda, c, 0)
    r = c9e_call(return_diagnostics=True, return_samples=DRAWS)
    counts = {c: getattr(mcmc_nd_cuda, c) for c in (
        "launches", "pilot_launches", "diag_launches", "sample_launches")}
    rh = r.diagnostics["r_hat"]
    s = r.samples
    corr = float(np.corrcoef(s[..., 0].ravel(), s[..., 1].ravel())[0, 1])
    print(f"phase 46: c9e, integrate_mcmc({SHORT_MCMC}, return_stderr=True, "
          f"return_diagnostics=True, return_samples={DRAWS}), launches "
          f"{counts}; E[xy] = {r.values[0]:.6f} +- {r.stderr[0]:.6f}, r_hat "
          f"{rh}, ess {r.diagnostics['ess']}, samples {s.shape}, their x-y "
          f"correlation {corr:.4f}")
    if min(counts.values()) < 1:
        fail("phase 46: c9e did not launch the nd kernel with its outputs")
    if s.shape != (DRAWS, mcmc_grid.chains_actual, 2) or not (
            np.isfinite(s).all() and np.isfinite(rh).all()):
        fail("phase 46: bad draws or R-hat")
    if not np.all((0.99 < rh) & (rh < 1.02)):
        fail("phase 46: c9e's R-hat is not in (0.99, 1.02)")
    if abs(corr - 0.8) > 0.02:
        fail("phase 46: the draws' x-y correlation is not within 0.02 of 0.8")
    gate_draws("c9e", r, lambda s_: s_[..., 0] * s_[..., 1], "46")
    r0 = c9e_call()
    if not (np.array_equal(r.values, r0.values)
            and np.array_equal(r.stderr, r0.stderr)
            and r.acceptance_rate == r0.acceptance_rate):
        fail("phase 46: values or error bars moved with the outputs")
    got = mcmc_nd_cuda(o_prog, o_cfg, o_params, SEED, mcmc_grid)
    want, plain_ms_o = timed_plain(lambda: mcmc_nd_reference(
        o_prog.torch_fns, o_prog.torch_target, o_cfg, o_params, SEED,
        mcmc_grid))
    errs = outputs_vs_plain(got, want, mcmc_grid, o_cfg, 1, "46")
    b_prog, b_cfg, b_params = nd_mcmc_main["c9e"]
    b_cfg = replace(b_cfg, n_steps=SHORT_MCMC["n_steps"])
    bare = mcmc_nd_cuda(b_prog, b_cfg, b_params, SEED, mcmc_grid)
    unchanged(got, bare, "46")
    times = outputs_times(
        lambda: mcmc_nd_cuda(o_prog, o_cfg, o_params, SEED, mcmc_grid),
        lambda: mcmc_nd_cuda(b_prog, b_cfg, b_params, SEED, mcmc_grid))
    rem_errs = remainder_check(
        lambda c, g: mcmc_nd_cuda(o_prog, c, o_params, SEED, g),
        lambda c, g: mcmc_nd_reference(o_prog.torch_fns, o_prog.torch_target,
                                       c, o_params, SEED, g),
        o_cfg, 1, "46")
    call_ms = warm_call_ms(lambda: c9e_call(return_diagnostics=True,
                                            return_samples=DRAWS))
    print("  c9e with both outputs:", end="")
    idle = idle_share(lambda: c9e_call(return_diagnostics=True,
                                        return_samples=DRAWS))
    outputs["mcmc_nd"] = dict(counts, max_abs_err=max(errs[0], rem_errs[0]),
                              r_hat_rel_err=max(errs[1], rem_errs[1]),
                              ess_rel_err=max(errs[2], rem_errs[2]),
                              split_draws=errs[3],
                              remainder_split_draws=rem_errs[3],
                              plain_ms=plain_ms_o,
                              call_ms=call_ms, idle_share=idle, draws=DRAWS,
                              r_hat=rh.tolist(), n_steps=SHORT_MCMC["n_steps"],
                              draws_xy_correlation=corr, **times)
    print(f"phase 46: c9e on {card}: kernel with both outputs "
          f"{times['ms']:.4f} ms, without them "
          f"{times['ms_without']:.4f} ms; plain {plain_ms_o:.3f} ms; warm call with both "
          f"{call_ms:.3f} ms median of 3 (host clock); "
          f"{time.perf_counter() - t46:.1f} s")

    # 47. Tempered, c12's shape; then its ladder layout at phase 20's.
    t47 = time.perf_counter()
    o_prog, o_cfg, o_params, o_ladder = c12_out

    def c12_call(**extra):
        return tm.integrate_mcmc(PT_FNS, logmix, c12_walk,
                                 temperatures=PT_LADDER, return_stderr=True,
                                 **extra, **SHORT_MCMC)

    for c in ("launches", "pilot_launches", "diag_launches",
              "sample_launches"):
        setattr(mcmc_pt_cuda, c, 0)
    r = c12_call(return_diagnostics=True, return_samples=DRAWS)
    counts = {c: getattr(mcmc_pt_cuda, c) for c in (
        "launches", "pilot_launches", "diag_launches", "sample_launches")}
    rh = r.diagnostics["r_hat"]
    s = r.samples
    right = float(np.mean(s > 0.0))
    print(f"phase 47: c12, integrate_mcmc([x, x*x], logmix, temperatures="
          f"{PT_LADDER}, {SHORT_MCMC}, return_stderr=True, "
          f"return_diagnostics=True, return_samples={DRAWS}), launches "
          f"{counts}; values {r.values} +- {r.stderr}, r_hat {rh}, ess "
          f"{r.diagnostics['ess']}, swap rate {r.diagnostics['swap_rate']}, "
          f"samples {s.shape}, share with x > 0 {right:.4f}")
    if min(counts.values()) < 1:
        fail("phase 47: c12 did not launch the tempered kernel with its "
             "outputs")
    if s.shape != (DRAWS, mcmc_grid.chains_actual, 1) or not (
            np.isfinite(s).all() and np.isfinite(rh).all()):
        fail("phase 47: bad draws or R-hat")
    if not np.all(rh < 1.05):
        fail("phase 47: c12's cold-rung R-hat is not below 1.05")
    if abs(right - 0.5) > 0.05:
        fail("phase 47: the cold draws do not visit both modes")
    r0 = c12_call()
    if not (np.array_equal(r.values, r0.values)
            and np.array_equal(r.stderr, r0.stderr)
            and r.acceptance_rate == r0.acceptance_rate
            and r.diagnostics["swap_rate"] == r0.diagnostics["swap_rate"]):
        fail("phase 47: values, error bars or swap rate moved with the "
             "outputs")
    got = mcmc_pt_cuda(o_prog, o_cfg, o_params, o_ladder, SEED, mcmc_grid)
    want, plain_ms_o = timed_plain(lambda: mcmc_pt_reference(
        o_prog.torch_fns, o_prog.torch_target, o_cfg, o_params, o_ladder,
        SEED, mcmc_grid))
    errs = outputs_vs_plain(got, want, mcmc_grid, o_cfg, 2, "47",
                            max_split=0.01)
    b_prog, b_cfg, b_params, b_ladder = pt_main["c12"]
    b_cfg = replace(b_cfg, n_steps=SHORT_MCMC["n_steps"])
    bare = mcmc_pt_cuda(b_prog, b_cfg, b_params, b_ladder, SEED, mcmc_grid)
    unchanged(got, bare, "47")
    times = outputs_times(
        lambda: mcmc_pt_cuda(o_prog, o_cfg, o_params, o_ladder, SEED,
                             mcmc_grid),
        lambda: mcmc_pt_cuda(b_prog, b_cfg, b_params, b_ladder, SEED,
                             mcmc_grid))
    call_ms = warm_call_ms(lambda: c12_call(return_diagnostics=True,
                                            return_samples=DRAWS))
    print("  c12 with both outputs:", end="")
    idle = idle_share(lambda: c12_call(return_diagnostics=True,
                                        return_samples=DRAWS))
    # The remainder run on rungs on lanes, then on the ladder layout (one
    # thread per ladder), at phase 20's shape.
    pt_plain = (lambda c, g: mcmc_pt_reference(
        o_prog.torch_fns, o_prog.torch_target, c, o_params, o_ladder, SEED,
        g))
    rem_errs = remainder_check(
        lambda c, g: mcmc_pt_cuda(o_prog, c, o_params, o_ladder, SEED, g),
        pt_plain, o_cfg, 2, "47", max_split=0.01)
    print("phase 47: c12's ladder layout:")
    l_errs = remainder_check(
        lambda c, g: mcmc_pt_cuda(c12_ladder_out, c, o_params, o_ladder,
                                  SEED, g),
        pt_plain, o_cfg, 2, "47", max_split=0.01)
    outputs["mcmc_pt"] = dict(
        counts, max_abs_err=max(errs[0], rem_errs[0], l_errs[0]),
        r_hat_rel_err=max(errs[1], rem_errs[1], l_errs[1]),
        ess_rel_err=max(errs[2], rem_errs[2], l_errs[2]),
        split_draws=errs[3], remainder_split_draws=rem_errs[3],
        ladder_split_draws=l_errs[3], plain_ms=plain_ms_o, call_ms=call_ms,
        idle_share=idle,
        draws=DRAWS, r_hat=rh.tolist(), draws_right_share=right,
        n_steps=SHORT_MCMC["n_steps"],
        layout=list(o_prog.layout), **times)
    print(f"phase 47: c12 on {card}: kernel with both outputs "
          f"{times['ms']:.4f} ms, without them "
          f"{times['ms_without']:.4f} ms; plain {plain_ms_o:.3f} ms; warm call with both "
          f"{call_ms:.3f} ms median of 3 (host clock); "
          f"{time.perf_counter() - t47:.1f} s")
    print(f"phases 44-47 (MCMC diagnostics and draws) took "
          f"{time.perf_counter() - t_outputs:.1f} s")

    # 48-49. HMC, c11 and c11c: the libraries started in phase 2; each
    # main path through the public API, counted and gated; its kernel
    # against its plain version at MCMC_CHECK's depth, the plain version
    # timed there; at SHORT_MCMC's shape the kernel's time at each group,
    # its bounds, the warm call and its idle share, gradient evaluations
    # per second.
    t_hmc = time.perf_counter()
    built = [b.result() for b in hmc_state_builds]
    print(f"phase 48: built the HMC and chain-state libraries ({len(built)}: "
          "c11 and c11c at each group, c5b's and c9e's fresh and resumed), "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for name, o in hmc_out.items():
        for line in o["program"].library(o["cfg"]).build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({name}): {line.strip()}")
    hmc_depth = SHORT_MCMC["n_steps"] + SHORT_MCMC["n_burnin"]
    hmc_chain_steps = mcmc_grid.chains_actual * hmc_depth
    # Phases 48-53 hold their kernels against the plain versions at
    # MCMC_CHECK's depth: the plain version's Python loop over the steps
    # is most of their time.
    check_steps = [MCMC_CHECK["n_burnin"], MCMC_CHECK["n_steps"]]

    def check_depth(cfg_, burn=MCMC_CHECK["n_burnin"]):
        return replace(cfg_, n_steps=MCMC_CHECK["n_steps"], n_burnin=burn)
    hmc = {}
    for phase, (name, o) in zip(("48", "49"), hmc_out.items()):
        h_prog, h_cfg, h_params, h_tabs = (
            o[k] for k in ("program", "cfg", "params", "tables"))
        fns, _, exact = HMC_CELLS[name]

        def hmc_call(o=o, fns=fns):
            return tm.integrate_mcmc(fns, o["target"], o["hmc"], **SHORT_MCMC)

        for c in ("launches", "hmc_launches"):
            setattr(mcmc_cuda, c, 0)
        t0 = time.perf_counter()
        r = hmc_call()
        main_s = time.perf_counter() - t0
        counts = {c: getattr(mcmc_cuda, c) for c in ("launches",
                                                     "hmc_launches")}
        value = float(r.values[0])
        print(f"phase {phase}: {name}, integrate_mcmc("
              f"{'[x*x], N(0,1)' if name == 'c11' else '[x], Beta(2,5)'}, "
              f"{o['hmc']!r}, {SHORT_MCMC}) in {main_s:.3f} s (host clock), "
              f"launches {counts}; value {value:.6f} (exact {exact:.6f}), "
              f"acceptance {r.acceptance_rate:.4f}")
        if counts["hmc_launches"] < 1:
            fail(f"phase {phase}: {name} did not launch the HMC kernel")
        if not (math.isfinite(value) and abs(value - exact) <= HMC_TOL):
            fail(f"phase {phase}: {name}'s value is not within {HMC_TOL} of "
                 f"{exact}")
        chk = check_depth(h_cfg)
        got = mcmc_cuda(h_prog, chk, h_params, SEED, mcmc_grid, h_tabs)
        want, plain_ms_h = timed_plain(lambda: mcmc_reference(
            h_prog.torch_fns, chk, h_params, SEED, mcmc_grid, h_tabs))
        err = chains_agree(got, want, mcmc_grid, chk, len(fns), phase)
        group_ms = {g: time_ms(lambda p=p: mcmc_cuda(
            p, h_cfg, h_params, SEED, mcmc_grid, h_tabs), reps=5)
                    for g, p in o["layouts"].items()}
        h_ms = time_ms(lambda: mcmc_cuda(h_prog, h_cfg, h_params, SEED,
                                       mcmc_grid, h_tabs), reps=10)
        layout = h_prog.layout_for(h_cfg)
        print(f"phase {phase}: {name} on {card}: kernel {h_ms:.4f} ms at "
              f"{mcmc_grid.chains_actual} x ({SHORT_MCMC['n_burnin']} + "
              f"{SHORT_MCMC['n_steps']}), layout {tuple(layout)}; by group "
              + ", ".join(f"{g}: {t:.4f} ms" for g, t in group_ms.items())
              + f"; plain {plain_ms_h:.3f} ms at {check_steps}")
        mhz = clock_under_load(lambda: mcmc_cuda(
            h_prog, h_cfg, h_params, SEED, mcmc_grid, h_tabs), h_ms)
        bound = card_bound(
            h_prog.library(h_cfg), "mcmc_kernel", 2, hmc_chain_steps, mhz,
            warps=function_warps(h_cfg.mode, mcmc_grid.chains_actual),
            weights=(SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"]))
        print_bound(bound, mhz, "chain-step")
        latency = print_latency(bound, hmc_depth, mhz)
        call_ms = warm_call_ms(hmc_call)
        print(f"  {name}, warm call {call_ms:.3f} ms median of 3 (host "
              "clock):", end="")
        idle = idle_share(hmc_call)
        grads = hmc_chain_steps * HMC_LEAPFROG / (h_ms * 1e-3)
        print(f"  {name}: {grads:.4e} gradient evaluations per second (L = "
              f"{HMC_LEAPFROG} per chain-step)")
        hmc[name] = dict(
            counts, value=value, acceptance=float(r.acceptance_rate),
            n_steps=SHORT_MCMC["n_steps"], max_abs_err=err, ms=h_ms,
            plain_ms=plain_ms_h, plain_steps=check_steps,
            bound_ms=max(bound[0], latency),
            bound_by=bound_by(bound, latency), bound_pipe=bound[1],
            pipe_bound_ms=bound[0], issue_ms=bound[2], latency_ms=latency,
            call_ms=call_ms, idle_share=idle, grad_evals_per_s=grads,
            layout=list(layout), group_ms=group_ms)
    print(f"phases 48-49 (HMC) took {time.perf_counter() - t_hmc:.1f} s")

    # 50-51. Chain state: c5b and c9e as two public calls of STATE_STEPS
    # steps (return_state, then initial_state), counted and held
    # statistically against their one-call runs; segment 0's kernel
    # against the stateless kernel bit for bit; the resumed segment's
    # kernel against its plain version from the same start, for
    # MCMC_CHECK's steps.
    t_state = time.perf_counter()
    state = {}
    for phase, name in (("50", "c5b"), ("51", "c9e")):
        nd = name == "c9e"
        wrapper = mcmc_nd_cuda if nd else mcmc_cuda
        half = dict(MCMC_MAIN, n_steps=STATE_STEPS)
        fns, target_, proposal_ = ((c9e_fns_, c9e_target_, c9e_proposal_)
                                   if nd else (MCMC_MAIN_FNS, n01, n02))
        for c in ("launches", "state_launches"):
            setattr(wrapper, c, 0)
        r1 = tm.integrate_mcmc(fns, target_, proposal_, return_state=True,
                               **half)
        r2 = tm.integrate_mcmc(fns, target_, proposal_, return_state=True,
                               initial_state=r1.chain_state,
                               **dict(half, n_burnin=0))
        counts = {c: getattr(wrapper, c) for c in ("launches",
                                                   "state_launches")}
        one = tm.integrate_mcmc(fns, target_, proposal_, return_stderr=True,
                                **MCMC_MAIN)
        two = 0.5 * (float(r1.values[0]) + float(r2.values[0]))
        z = (two - float(one.values[0])) / (float(one.stderr[0])
                                            * math.sqrt(2.0))
        st = r2.chain_state
        print(f"phase {phase}: {name} as two calls of {half}, return_state "
              f"then initial_state: launches {counts}; values "
              f"{float(r1.values[0]):.6f}, {float(r2.values[0]):.6f}, their "
              f"mean {two:.6f}, one call {float(one.values[0]):.6f} +- "
              f"{float(one.stderr[0]):.6f} (z = {z:+.2f}); state x "
              f"{st.x.shape}, segment {st.segment}")
        if counts["state_launches"] < 2:
            fail(f"phase {phase}: {name}'s calls did not launch the stateful "
                 "kernel")
        if not (st.segment == 1 and np.isfinite(st.x).all()
                and np.isfinite(st.log_p).all()
                and st.x.shape[-1] == mcmc_grid.chains_actual):
            fail(f"phase {phase}: bad chain state {st!r}")
        if abs(z) > STATE_Z:
            fail(f"phase {phase}: the two calls' mean is {z:+.2f} standard "
                 "errors from the one call's")
        (p0, c0, s_params, *_), (p1, c1, *_) = (state_out[name, False],
                                                state_out[name, True])
        if nd:
            b_prog, b_cfg, _ = nd_mcmc_main["c9e"]
            fresh = lambda: mcmc_nd_cuda(p0, c0, s_params, SEED, mcmc_grid)
            bare_run = lambda: mcmc_nd_cuda(
                b_prog, replace(b_cfg, with_stderr=False,
                                n_steps=STATE_STEPS), s_params, SEED,
                mcmc_grid)
        else:
            fresh = lambda: mcmc_cuda(p0, c0, s_params, SEED, mcmc_grid)
            bare_run = lambda: mcmc_cuda(
                mcmc_program, replace(mcmc_main_cfg, with_stderr=False,
                                      n_steps=STATE_STEPS), s_params, SEED,
                mcmc_grid)
        got0, bare = fresh(), bare_run()
        same = (torch.equal(got0.rows, bare.rows)
                and torch.equal(got0.x_final, bare.x_final))
        print(f"phase {phase}: segment 0 against the stateless kernel, bit "
              f"for bit: {same}")
        if not same:
            fail(f"phase {phase}: {name}'s segment 0 is not the stateless "
                 "run")
        start = ChainStart(got0.x_final, got0.logp_final)
        c1_chk = check_depth(c1, 0)
        if nd:
            resumed = lambda c=c1: mcmc_nd_cuda(p1, c, s_params, SEED,
                                                mcmc_grid, None, 1, start)
            plain = lambda: mcmc_nd_reference(
                p1.torch_fns, p1.torch_target, c1_chk, s_params, SEED,
                mcmc_grid, None, 1, start)
        else:
            resumed = lambda c=c1: mcmc_cuda(p1, c, s_params, SEED, mcmc_grid,
                                             None, 1, start)
            plain = lambda: mcmc_reference(p1.torch_fns, c1_chk, s_params,
                                           SEED, mcmc_grid, None, 1, start)
        got1 = resumed(c1_chk)
        want1, plain_ms_s = timed_plain(plain)
        err = chains_agree(got1, want1, mcmc_grid, c1_chk, len(fns), phase)
        logp_err = float((got1.logp_final - want1.logp_final).abs().max())
        print(f"         final log densities: max |kernel - plain| "
              f"{logp_err:.3e}")
        if not logp_err <= 1e-4:
            fail(f"phase {phase}: the final log densities disagree")
        times = {"fresh_ms": time_ms(fresh, reps=10),
                 "ms": time_ms(resumed, reps=10),
                 "stateless_ms": time_ms(bare_run, reps=10)}
        print(f"phase {phase}: {name} on {card}: {mcmc_grid.chains_actual} "
              f"chains, kernel fresh ({MCMC_MAIN['n_burnin']} + {STATE_STEPS}) "
              f"{times['fresh_ms']:.4f} ms, stateless {times['stateless_ms']:.4f}"
              f" ms; resumed (0 + {STATE_STEPS}) {times['ms']:.4f} ms; plain "
              f"{plain_ms_s:.3f} ms for (0 + {c1_chk.n_steps})")
        state[name] = dict(counts, max_abs_err=err, logp_max_abs_err=logp_err,
                           two_call_mean=two, one_call=float(one.values[0]),
                           z=z, plain_ms=plain_ms_s,
                           plain_steps=[0, c1_chk.n_steps], **times)
    print(f"phases 50-51 (chain state) took "
          f"{time.perf_counter() - t_state:.1f} s")

    # 52-53. nd and tempered HMC, c11b and c12b: the libraries started in
    # phase 2; each path through the public API, counted and gated; its
    # kernel against its plain version at MCMC_CHECK's depth (the plain
    # version timed there); at SHORT_MCMC's shape the kernel at each
    # layout, its bounds, the warm call and its idle share, gradient
    # evaluations per second.
    t_hmc_nd = time.perf_counter()
    built = [b.result() for b in hmc_nd_builds]
    print(f"phase 52: built the nd and tempered HMC libraries ({len(built)}: "
          "c11b and c12b at each layout), "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for name, o in hmc_nd_out.items():
        for line in o["program"].library().build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({name}): {line.strip()}")
    hmc_nd = {}
    for phase, (name, o) in zip(("52", "53"), hmc_nd_out.items()):
        cell = HMC_ND_CELLS[name]
        pt = cell["temps"] is not None
        wrapper = mcmc_pt_cuda if pt else mcmc_nd_cuda
        h_prog, h_cfg, h_params, h_ladder = (
            o[k] for k in ("program", "cfg", "params", "ladder"))
        k_fns = len(cell["fns"])
        extra = {"temperatures": cell["temps"]} if pt else {}

        def hmc_call(o=o, cell=cell, extra=extra):
            return tm.integrate_mcmc(cell["fns"], o["target"], o["hmc"],
                                     return_stderr=True, **extra,
                                     **SHORT_MCMC)

        chk = check_depth(h_cfg)

        def run(p=h_prog, c=h_cfg):
            if pt:
                return mcmc_pt_cuda(p, c, h_params, h_ladder, SEED, mcmc_grid)
            return mcmc_nd_cuda(p, c, h_params, SEED, mcmc_grid)

        def plain():
            if pt:
                return mcmc_pt_reference(
                    h_prog.torch_fns, h_prog.torch_target, chk, h_params,
                    h_ladder, SEED, mcmc_grid,
                    torch_target_grad=h_prog.torch_target_grad)
            return mcmc_nd_reference(
                h_prog.torch_fns, h_prog.torch_target, chk, h_params, SEED,
                mcmc_grid, torch_target_grad=h_prog.torch_target_grad)

        for c in ("launches", "hmc_launches"):
            setattr(wrapper, c, 0)
        t0 = time.perf_counter()
        r = hmc_call()
        main_s = time.perf_counter() - t0
        counts = {c: getattr(wrapper, c) for c in ("launches",
                                                   "hmc_launches")}
        value, se = float(r.values[0]), float(r.stderr[0])
        swap = (r.diagnostics or {}).get("swap_rate")
        print(f"phase {phase}: {name}, integrate_mcmc("
              f"{'[x*x], logmix' if pt else '[x*y], joint rho=0.8'}, "
              f"{o['hmc']!r}, {extra or ''}{SHORT_MCMC}, return_stderr=True) "
              f"in {main_s:.3f} s (host clock), launches {counts}; value "
              f"{value:.6f} +- {se:.6f} (exact {cell['exact']}, z = "
              f"{(value - cell['exact']) / se:+.2f}), acceptance "
              f"{r.acceptance_rate:.4f}"
              + ("" if swap is None else f", swap rate {swap:.4f}"))
        if counts["hmc_launches"] < 1:
            fail(f"phase {phase}: {name} did not launch the HMC kernel")
        if not (math.isfinite(value) and se > 0.0
                and abs(value - cell["exact"]) <= 6.0 * se
                and abs(value - cell["exact"]) <= cell["tol"]):
            fail(f"phase {phase}: {name}'s value is not within 6 error bars "
                 f"and {cell['tol']} of {cell['exact']}")
        if pt and not 0.0 < swap < 1.0:
            fail(f"phase {phase}: {name}'s swap rate is not in (0, 1)")
        got = run(c=chk)
        want, plain_ms_h = timed_plain(plain)
        err = chains_agree(got, want, mcmc_grid, chk, k_fns, phase,
                           max_split=0.01 if pt else 0.0)
        if pt:
            w_k, w_p = (float(pt_finish(t, mcmc_grid, chk, k_fns)[2])
                        for t in (got, want))
            print(f"         swap rate kernel {w_k:.6f} plain {w_p:.6f}")
            if abs(w_k - w_p) > 1e-3:
                fail(f"phase {phase}: swap rates disagree")
        layout_ms = {key: time_ms(lambda p=p: run(p), reps=5)
                     for key, p in o["layouts"].items()}
        h_ms = time_ms(run, reps=10)
        rungs = h_cfg.n_temps if pt else 1
        lane_steps = hmc_chain_steps * rungs
        print(f"phase {phase}: {name} on {card}: kernel {h_ms:.4f} ms at "
              f"{mcmc_grid.chains_actual} x {rungs} x "
              f"({SHORT_MCMC['n_burnin']} + {SHORT_MCMC['n_steps']}), layout "
              f"{tuple(h_prog.layout)}; by layout "
              + ", ".join(f"{key}: {t:.4f} ms" for key, t in layout_ms.items())
              + f"; plain {plain_ms_h:.3f} ms at {check_steps}")
        mhz = clock_under_load(run, h_ms)
        # Bounds as phases 18 and 22: per chain-step, d + 1 uniform
        # conversions a rung (and the swap draws, on the ladder layout's
        # build, whose SASS holds the function's own instructions); the
        # work spans rungs x chains lanes.
        if pt:
            count_prog = o["layouts"][str(tuple(LADDER_LAYOUT))]
            conversions = rungs * (h_cfg.d + 1) + (rungs - 1) // 2
            function = "mcmc_pt_kernel"
        else:
            count_prog = h_prog
            conversions = h_cfg.d + 1
            function = "mcmc_nd_kernel"
        bound = card_bound(
            count_prog.library(), function, conversions, hmc_chain_steps,
            mhz, warps=function_warps(h_cfg.mode, mcmc_grid.chains_actual,
                                      rungs),
            weights=(SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"]))
        print_bound(bound, mhz, "chain-step")
        latency = print_latency(bound, hmc_depth, mhz)
        call_ms = warm_call_ms(hmc_call)
        print(f"  {name}, warm call {call_ms:.3f} ms median of 3 (host "
              "clock):", end="")
        idle = idle_share(hmc_call)
        grads = lane_steps * HMC_LEAPFROG / (h_ms * 1e-3)
        print(f"  {name}: {grads:.4e} gradient evaluations per second (L = "
              f"{HMC_LEAPFROG} per {'lane' if pt else 'chain'}-step)")
        hmc_nd[name] = dict(
            counts, value=value, stderr=se, acceptance=float(r.acceptance_rate),
            **({} if swap is None else {"swap_rate": float(swap)}),
            n_steps=SHORT_MCMC["n_steps"], max_abs_err=err, ms=h_ms,
            plain_ms=plain_ms_h, plain_steps=check_steps,
            bound_ms=max(bound[0], latency),
            bound_by=bound_by(bound, latency), bound_pipe=bound[1],
            pipe_bound_ms=bound[0], issue_ms=bound[2], latency_ms=latency,
            call_ms=call_ms, idle_share=idle, grad_evals_per_s=grads,
            layout=list(h_prog.layout), layout_ms=layout_ms)
    print(f"phases 52-53 (nd and tempered HMC) took "
          f"{time.perf_counter() - t_hmc_nd:.1f} s")

    # 54-59. The serving handles: compile_integrate, compile_importance_
    # sampling and the 1-D compile_mcmc with seed and param batches on the
    # batch axis of kernels 1-3.  Each phase builds a handle as a user
    # would, counts the launches of one warm call (one batched launch),
    # holds every rep of one batched launch bit for bit against the
    # unbatched launch with its seed and row (and the handle's element
    # against the unbatched handle's), and times the batched launch
    # against the unbatched one (CUDA events), the warm call (host clock,
    # enqueue and synchronised) and its idle share: in one profiler window,
    # kept where its busy time covers the batched launches' CUDA-event
    # time, and from that time over the host clock of ten calls (an upper
    # bound of the share: the calls' copies and sums count as idle).  The
    # bound of an integrate batch is R times the unbatched launch's (R
    # jobs' samples on the whole card); an MCMC batch's is the larger of
    # its R jobs' pipe work, on the warps of all R, and one job's latency
    # (the reps run side by side), times the waves when they cannot all be
    # resident.
    t_serve = time.perf_counter()
    serve = tm.MonteCarloIntegrator()
    serving = {"integrate": {}, "integrate_nd": {}, "mcmc": {}}

    # The nd libraries phases 60-62 add, their handles' and the one-lane
    # builds their bounds count, started now and built while phases 54-59
    # run: c9e and c9d, c9e with draws, c9d's set over rows of targets
    # and proposals and under adaptive walks.
    def nd_one_lane(prog_, cfg_):
        """The one-lane build of an nd program's group: its SASS holds the
        function's own instructions."""
        return McmcNdProgram(prog_.fns, cfg_, prog_.target,
                             layout=Layout(1, prog_.layout.group))

    row_targets = [[tm.Distribution.normal(*p) for p in row]
                   for row in ND_SERVING_TARGETS]
    row_props = [[tm.Distribution.normal(0.0, s)] * 2
                 for s in ND_SERVING_PROPOSALS]
    row_walks = [tm.RandomWalk(step_size=list(st), adapt=True)
                 for st in ND_SERVING_STEPS]
    short_shape = (SHORT_MCMC["n_steps"], SHORT_MCMC["n_burnin"], True)
    nd_serving_setups = {
        "c9e": nd_mcmc_setup(c9e_fns, c9e_joint, c9e_proposal, *short_shape),
        "c9d": nd_mcmc_setup(*nd_mcmc_cells["c9d"][:3], *short_shape),
        "c9e_draws": integ._nd_mcmc_kernel_program(
            c9e_fns, c9e_proposal,
            integ._parse_nd_mcmc_args(c9e_joint, c9e_proposal), *short_shape,
            samples=SERVING_DRAWS),
        "param_batch": nd_mcmc_setup(C9D_FNS, row_targets[0], row_props[0],
                                     *short_shape),
        "walk_param_batch": nd_mcmc_setup(C9D_FNS, row_targets[0],
                                          row_walks[0], *short_shape),
    }
    serving_pool = ThreadPoolExecutor(max_workers=8)
    serving_builds = [
        serving_pool.submit(timed_build, build)
        for prog_, cfg_, _ in nd_serving_setups.values()
        for build in ((prog_.library,) if prog_.layout.lanes == 1 else
                      (prog_.library, nd_one_lane(prog_, cfg_).library))]

    def words(seeds):
        """The seed words on the card.  Staged once, outside the timed
        launches: a copy from pageable memory waits for the stream, so
        inside a launch's lambda it would time the host's work too."""
        return torch.from_numpy(
            np.asarray(seeds, np.uint32).view(np.int32)).to(dev)

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def warm_handle(call, kernel_ms, n_calls=10):
        """(enqueue ms, synchronised ms) medians of 5 warm calls; the idle
        share of one profiler window of ``n_calls`` calls (None where the
        window lost events); and 1 - ``n_calls`` x ``kernel_ms`` over the
        host clock of ``n_calls`` calls synchronised once."""
        call()
        torch.cuda.synchronize()
        enq, full = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enq.append(t1 - t0)
            full.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_events = 1.0 - n_calls * kernel_ms / wall_ms
        print(f"  warm call {np.median(full) * 1e3:.3f} ms synchronised, "
              f"{np.median(enq) * 1e3:.3f} ms to enqueue (medians of 5, "
              f"host clock); {n_calls} calls in {wall_ms:.3f} ms, idle at "
              f"most {by_events:.2%} beside {n_calls} x {kernel_ms:.4f} ms "
              "of kernel (CUDA events):", end="")
        idle = idle_share(call, n_calls=n_calls, floor_ms=kernel_ms)
        return (float(np.median(enq)) * 1e3, float(np.median(full)) * 1e3,
                idle, by_events)

    def batch_phase(phase, label, wrapper, counters, handle, args, one_handle,
                    launch_batch, launch_one, reps, units, bound,
                    public_call=None):
        """One serving phase (module comment above): ``launch_batch()`` is
        the batched launch's rows, ``launch_one(r)`` rep r's unbatched
        launch's, ``bound(mhz)`` the batched launch's (ms, bound_by,
        how it was counted)."""
        for c in counters:
            setattr(wrapper, c, 0)
        out = handle(*args)
        torch.cuda.synchronize()
        counts = {c: getattr(wrapper, c) for c in counters}
        print(f"phase {phase}: {label}: one warm call, launches {counts}")
        if counts["launches"] != 1 or counts["batch_launches"] != 1:
            fail(f"phase {phase}: a handle call is not one batched launch")
        rows = launch_batch()
        for r in range(reps):
            one = launch_one(r)
            for got, want in zip(as_tuple(rows), as_tuple(one)):
                if not torch.equal(got[r], want):
                    fail(f"phase {phase}: rep {r} of the batched launch is "
                         "not the unbatched launch, bit for bit")
            got = tuple(o[r] for o in as_tuple(out))
            want = as_tuple(one_handle(r))
            if len(got) != len(want) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"phase {phase}: element {r} of the handle is not the "
                     "unbatched handle's, bit for bit")
        values = as_tuple(out)[0]
        if not bool(torch.isfinite(values).all()):
            fail(f"phase {phase}: the handle's values are not finite")
        b_ms = time_ms(launch_batch, reps=5)
        o_ms = time_ms(lambda: launch_one(0), reps=10)
        mhz_ = clock_under_load(launch_batch, b_ms)
        b_bound, b_by, how, *extra = bound(mhz_)
        print(f"  {reps} reps bit for bit their unbatched launches; on "
              f"{card}: batched launch {b_ms:.4f} ms ({b_ms / reps:.4f} ms a "
              f"job, {reps * units / b_ms * 1e3:.4e} units/s), unbatched "
              f"{o_ms:.4f} ms ({reps} x = {reps * o_ms:.4f} ms); bound "
              f"{b_bound:.4f} ms ({b_by}: {how}) at {mhz_:.0f} MHz, the "
              f"launch at {b_ms / b_bound:.2f}x it")
        enq, full, idle, idle_ev = warm_handle(lambda: handle(*args), b_ms)
        rec = dict(reps=reps, launches=counts, ms=b_ms, ms_per_job=b_ms / reps,
                   unbatched_ms=o_ms, units_per_s=reps * units / b_ms * 1e3,
                   bound_ms=b_bound, bound_by=b_by, bound_mhz=mhz_,
                   call_enqueue_ms=enq, call_ms=full, idle_share=idle,
                   idle_share_at_most=idle_ev, **(extra[0] if extra else {}))
        if public_call is not None:
            c_ms = warm_call_ms(public_call)
            print(f"  the public call, unbatched: warm {c_ms:.3f} ms median "
                  "of 3 (host clock):", end="")
            rec.update(public_call_ms=c_ms,
                       public_idle_share=idle_share(public_call, n_calls=3,
                                                    windows=1, floor_ms=o_ms))
        return rec

    def jobs_bound(reps, one):
        """An integrate batch's bound: ``reps`` times ``one(mhz)``, an
        unbatched launch's samples on the whole card."""
        def bound(mhz_):
            one_ms = one(mhz_)
            return reps * one_ms, "operations", f"{reps} x {one_ms:.4f} ms"

        return bound

    def int_bound(lib_, kind, units):
        return lambda mhz_: card_bound(
            lib_, f"integrate_kernelILi{int(kind)}EE", 1, units, mhz_)[0]

    # 54. K=8, N(0,1), 1e9 samples a job, seed_batch=8.
    k8_seeds = [SEED + 1000 * r for r in range(8)]
    k8_spec = dist_spec_of(normal)
    k8_params = torch.tensor(k8_spec.params, device=dev)
    k8_words = words(k8_seeds)
    k8_grid = plan_grid(make_integrate_plan(MAIN_SAMPLES).actual_samples)
    k8_one = serve.compile_integrate(BENCH_FNS, normal, n_samples=MAIN_SAMPLES)
    serving["integrate"]["seed_batch"] = batch_phase(
        "54", f"K=8, N(0,1), n_samples={MAIN_SAMPLES}, seed_batch=8",
        integrate_cuda, ("launches", "batch_launches"),
        serve.compile_integrate(BENCH_FNS, normal, n_samples=MAIN_SAMPLES,
                                seed_batch=8), (k8_seeds,),
        lambda r: k8_one(k8_seeds[r]),
        lambda: integrate_batch_rows(program, k8_spec.kind, k8_params,
                                     k8_words, k8_grid),
        lambda r: integrate_rows(program, k8_spec.kind, k8_params,
                                 k8_seeds[r], k8_grid),
        8, n_main, jobs_bound(8, int_bound(program.library(), k8_spec.kind,
                                          n_main)),
        public_call=lambda: tm.integrate(BENCH_FNS, normal,
                                         n_samples=MAIN_SAMPLES, seed=SEED))

    # 55. Eight normal (mean, std) rows at 2**27 with error bars.
    p_n = 1 << 27
    p_grid = plan_grid(make_integrate_plan(p_n).actual_samples)
    p_dists = [tm.Distribution.normal(0.25 * r - 1.0, 0.5 + 0.25 * r)
               for r in range(8)]
    p_pack = tm.pack_param_batch(p_dists)
    p_rows = torch.tensor(np.asarray(p_pack), device=dev)
    se_cfg = IntegrateConfig("mc", True)
    p_pilots = torch.stack([pilot_values(program.torch_values, k8_spec.kind,
                                         row) for row in p_rows.unbind()])
    serving["integrate"]["param_batch"] = batch_phase(
        "55", f"K=8, eight N(m, s) rows, n_samples={p_n}, return_stderr",
        integrate_cuda, ("launches", "batch_launches"),
        serve.compile_integrate(BENCH_FNS, p_dists[0], n_samples=p_n,
                                seed_batch=8, param_batch=True,
                                return_stderr=True), (k8_seeds, p_pack),
        lambda r: serve.compile_integrate(BENCH_FNS, p_dists[r], n_samples=p_n,
                                          return_stderr=True)(k8_seeds[r]),
        lambda: integrate_batch_rows(program, k8_spec.kind, p_rows, k8_words,
                                     p_grid, se_cfg, p_pilots),
        lambda r: integrate_rows(program, k8_spec.kind, p_rows[r], k8_seeds[r],
                                 p_grid, se_cfg, p_pilots[r]),
        8, p_grid.actual_samples,
        jobs_bound(8, int_bound(program.library(se_cfg), k8_spec.kind,
                                p_grid.actual_samples)))

    # 56. BASELINE.md config 3: Beta(2, 5), [x, x^2], 1e7 a job,
    # seed_batch=64.
    c3_seeds = [SEED + r for r in range(64)]
    c3_spec = dist_spec_of(c3_beta)
    c3_tables = sampling_tables(c3_beta, c3_spec, dev)
    c3_params = torch.tensor(c3_spec.params, device=dev)
    c3_grid = plan_grid(make_integrate_plan(C3_SAMPLES).actual_samples)
    c3_words = words(c3_seeds)
    c3_one = serve.compile_integrate(C3_BETA_FNS, c3_beta,
                                     n_samples=C3_SAMPLES)
    serving["integrate"]["config3_seed_batch"] = batch_phase(
        "56", f"config 3, Beta(2,5), n_samples={C3_SAMPLES}, seed_batch=64",
        integrate_cuda, ("launches", "batch_launches"),
        serve.compile_integrate(C3_BETA_FNS, c3_beta, n_samples=C3_SAMPLES,
                                seed_batch=64), (c3_seeds,),
        lambda r: c3_one(c3_seeds[r]),
        lambda: integrate_batch_rows(c3_beta_program, c3_spec.kind, c3_params,
                                     c3_words, c3_grid,
                                     tables=c3_tables),
        lambda r: integrate_rows(c3_beta_program, c3_spec.kind, c3_params,
                                 c3_seeds[r], c3_grid, tables=c3_tables),
        64, c3_grid.actual_samples,
        jobs_bound(64, int_bound(c3_beta_program.library(MC_CFG,
                                                         c3_tables.route),
                                 c3_spec.kind, c3_grid.actual_samples)),
        public_call=lambda: tm.integrate(C3_BETA_FNS, c3_beta,
                                         n_samples=C3_SAMPLES, seed=SEED))

    # 57. Config 4's importance set, 1e8 a job, seed_batch=8, error bars.
    h_spec = dist_spec_of(is_proposal)
    is_h_params = torch.tensor(h_spec.params, device=dev)
    h_grid = plan_grid(make_integrate_plan(IS_SAMPLES).actual_samples)
    h_pilot = pilot_values(is_handle_program.torch_values, h_spec.kind,
                           is_h_params)
    h_one = serve.compile_importance_sampling(
        IS_FNS, is_target, is_proposal, n_samples=IS_SAMPLES,
        return_stderr=True)
    serving["integrate"]["is_seed_batch"] = batch_phase(
        "57", f"config 4 importance handle, n_samples={IS_SAMPLES}, "
        "seed_batch=8, return_stderr", integrate_cuda,
        ("launches", "batch_launches"),
        serve.compile_importance_sampling(
            IS_FNS, is_target, is_proposal, n_samples=IS_SAMPLES,
            seed_batch=8, return_stderr=True), (k8_seeds,),
        lambda r: h_one(k8_seeds[r]),
        lambda: integrate_batch_rows(is_handle_program, h_spec.kind,
                                     is_h_params, k8_words, h_grid, is_cfg,
                                     h_pilot),
        lambda r: integrate_rows(is_handle_program, h_spec.kind, is_h_params,
                                 k8_seeds[r], h_grid, is_cfg, h_pilot),
        8, h_grid.actual_samples,
        jobs_bound(8, int_bound(is_handle_program.library(is_cfg),
                                h_spec.kind, h_grid.actual_samples)),
        public_call=lambda: tm.integrate_importance_sampling(
            IS_FNS, is_target, is_proposal, n_samples=IS_SAMPLES, seed=SEED,
            return_stderr=True))

    # 58. nd: c9's set at 1e9 a job, seed_batch=4; four
    # pack_param_batch_nd rows at 2**27 (phase 13 ran c9c's rotations as
    # one launch).
    nd_seeds = k8_seeds[:4]
    nd_words = words(nd_seeds)
    nd_c9_cfg = NdConfig(nd_kinds)
    nd_c9_params = torch.tensor(
        np.stack([dist_spec_of(d).params for d in nd_dists]), device=dev)
    nd_one = serve.compile_integrate(ND_FNS, nd_dists, n_samples=MAIN_SAMPLES)
    serving["integrate_nd"]["seed_batch"] = batch_phase(
        "58", f"c9's set, n_samples={MAIN_SAMPLES}, seed_batch=4",
        integrate_nd_cuda, ("launches", "batch_launches"),
        serve.compile_integrate(ND_FNS, nd_dists, n_samples=MAIN_SAMPLES,
                                seed_batch=4), (nd_seeds,),
        lambda r: nd_one(nd_seeds[r]),
        lambda: integrate_nd_batch_rows(nd_program, nd_c9_cfg, nd_c9_params,
                                        nd_words, nd_grid),
        lambda r: integrate_nd_rows(nd_program, nd_c9_cfg, nd_c9_params,
                                    nd_seeds[r], nd_grid),
        4, n_nd, jobs_bound(4, lambda mhz_: card_bound(
            nd_program.library(), "integrate_nd_kernelILi0ELb0EE", 3, n_nd,
            mhz_)[0]),
        public_call=lambda: tm.integrate(ND_FNS, nd_dists,
                                         n_samples=MAIN_SAMPLES, seed=SEED))
    nd_rows = [[tm.Distribution.normal(0.5 * r, 1.0 + 0.5 * r),
                tm.Distribution.uniform(-r, 1.0),
                tm.Distribution.exponential(2.0 + r)] for r in range(4)]
    nd_pack = tm.pack_param_batch_nd(nd_rows)
    nd_prows = torch.tensor(np.asarray(nd_pack), device=dev)
    nd_pgrid = plan_grid(make_integrate_plan(p_n).actual_samples)
    serving["integrate_nd"]["param_batch"] = batch_phase(
        "58", f"c9's set, four pack_param_batch_nd rows, n_samples={p_n}",
        integrate_nd_cuda, ("launches", "batch_launches"),
        serve.compile_integrate(ND_FNS, nd_rows[0], n_samples=p_n,
                                seed_batch=4, param_batch=True),
        (nd_seeds, nd_pack),
        lambda r: serve.compile_integrate(ND_FNS, nd_rows[r],
                                          n_samples=p_n)(nd_seeds[r]),
        lambda: integrate_nd_batch_rows(nd_program, nd_c9_cfg, nd_prows,
                                        nd_words, nd_pgrid),
        lambda r: integrate_nd_rows(nd_program, nd_c9_cfg, nd_prows[r],
                                    nd_seeds[r], nd_pgrid),
        4, nd_pgrid.actual_samples,
        jobs_bound(4, lambda mhz_: card_bound(
            nd_program.library(), "integrate_nd_kernelILi0ELb0EE", 3,
            nd_pgrid.actual_samples, mhz_)[0]))
    serving["integrate_nd"]["rqmc"] = dict(
        reps=QMC_ROTATIONS, ms=rot_batch_ms, unbatched_ms=rot_ms,
        launches={"launches": qmc_launches})

    # 59. The 1-D MCMC handle: c5b at 4096 x (1,000 + 2,000) with error
    # bars, seed_batch=4; four N(m, s) targets under four adaptive walks
    # (pack_random_walk_batch); c11's HMC handle at seed_batch=2.  Each
    # rep's rows and final states (its chains' digest) against the
    # unbatched launch's.
    short = {k: v for k, v in SHORT_MCMC.items() if k != "seed"}
    m_grid = plan_mcmc_grid(plan_chains(short["n_chains"], None))
    m_depth = short["n_steps"] + short["n_burnin"]
    m_units = m_grid.chains_actual * m_depth
    mcmc_counters = ("launches", "pilot_launches", "batch_launches")

    def mcmc_setup(fns, target_, proposal_, stderr):
        traced_ = serve._trace_user_functions(fns)
        return serve._mcmc_kernel_program(
            traced_, target_, proposal_, short["n_steps"], short["n_burnin"],
            stderr)

    def mcmc_batch_launches(prog_, cfg_, rows_, seeds_, tabs_):
        words_ = words(seeds_)

        def batch():
            out_ = mcmc_batch(prog_, cfg_, rows_, words_, m_grid, tabs_)
            return out_.rows, out_.x_final

        def one(r):
            out_ = mcmc_cuda(prog_, cfg_, rows_[r] if rows_.dim() == 2
                             else rows_, seeds_[r], m_grid, tabs_)
            return out_.rows, out_.x_final

        return batch, one

    def chain_batch_bound(count, run, function, conversions, cfg_, reps,
                          threads, rungs=1):
        """An MCMC batched launch's bound (module comment above): the pipe
        bound of ``reps`` jobs' chain-steps, on the warps of all of them,
        against one job's latency times the waves of resident warps
        (``threads`` a chain on the running build).  Both count
        ``function`` (``conversions`` as ``card_bound``'s) on ``count``,
        a (library, lanes) holding the function's own instructions: a
        one-lane build of the running group, or the ladder layout's.
        ``run``, the running build's (library, lanes) where it differs,
        is counted beside it (``running_pipes_ms``)."""
        def bound(mhz_):
            warps = function_warps(cfg_.mode, m_grid.chains_actual, rungs)

            def pipes(lib_, lanes):
                return card_bound(
                    lib_, function, conversions, reps * m_units, mhz_,
                    warps=None if warps is None else reps * warps,
                    weights=(short["n_steps"], short["n_burnin"]),
                    lanes=lanes)

            b = pipes(*count)
            props = torch.cuda.get_device_properties(0)
            resident = props.multi_processor_count * getattr(
                props, "max_threads_per_multi_processor", 2048)
            waves = -(-reps * m_grid.chains_actual * threads // resident)
            lat = waves * latency_ms(b[3]["carried"], m_depth, mhz_)
            how = (f"pipes {b[0]:.4f} ms for {reps} jobs ({b[1]}), latency "
                   f"{lat:.4f} ms: one job's {m_depth} steps x "
                   f"{b[3]['carried']:g} carried instructions, {waves} "
                   "wave(s) of resident warps")
            extra = {}
            if run is not None:
                own = pipes(*run)
                how += (f"; on the build that runs ({run[1]} lanes a chain, "
                        f"each repeating the decisions) pipes {own[0]:.4f} "
                        f"ms ({own[1]})")
                extra = dict(running_pipes_ms=own[0],
                             running_bound_pipe=own[1])
            return max(b[0], lat), bound_by(b, lat), how, extra

        return bound

    def lane_bound(run_lib, lanes, one_lane, function, conversions, cfg_,
                   reps):
        """A 1-D or nd batch's bound: counted on ``one_lane()``, the
        one-lane build of its group, where the build that runs spreads a
        chain over ``lanes`` lanes."""
        run = (run_lib, lanes)
        if lanes == 1:
            return chain_batch_bound(run, None, function, conversions, cfg_,
                                     reps, 1)
        return chain_batch_bound((one_lane(), 1), run, function, conversions,
                                 cfg_, reps, lanes)

    def mcmc_batch_bound(prog_, cfg_, reps):
        layout = prog_.layout_for(cfg_)
        return lane_bound(
            prog_.library(cfg_), layout.lanes,
            lambda: McmcProgram(prog_.fns, layout=Layout(
                1, layout.group)).library(cfg_), "mcmc_kernel", 2, cfg_, reps)

    c5b_t = tm.Distribution.normal(0.0, 1.0)
    c5b_q = tm.Distribution.normal(0.0, 2.0)
    m_prog, m_cfg, m_params, m_tabs = mcmc_setup(MCMC_MAIN_FNS, c5b_t, c5b_q,
                                                 True)
    m_seeds = k8_seeds[:4]
    m_one = serve.compile_mcmc(MCMC_MAIN_FNS, c5b_t, c5b_q, return_stderr=True,
                               **short)
    serving["mcmc"]["seed_batch"] = batch_phase(
        "59", f"c5b, {m_grid.chains_actual} x ({short['n_burnin']} + "
        f"{short['n_steps']}), error bars, seed_batch=4", mcmc_cuda,
        mcmc_counters,
        serve.compile_mcmc(MCMC_MAIN_FNS, c5b_t, c5b_q, seed_batch=4,
                           return_stderr=True, **short), (m_seeds,),
        lambda r: m_one(m_seeds[r]),
        *mcmc_batch_launches(m_prog, m_cfg, m_params, m_seeds, m_tabs),
        4, m_units, mcmc_batch_bound(m_prog, m_cfg, 4))
    w_targets = [tm.Distribution.normal(0.5 * r, 1.0 + 0.5 * r)
                 for r in range(4)]
    w_walks = [tm.RandomWalk(step_size=0.5 + 0.5 * r, adapt=True)
               for r in range(4)]
    t_pack = tm.pack_param_batch(w_targets)
    w_pack = tm.pack_random_walk_batch(w_walks, w_targets)
    w_prog, w_cfg, _, _ = mcmc_setup(MCMC_MAIN_FNS, w_targets[0], w_walks[0],
                                     True)
    w_rows = torch.tensor(np.concatenate([np.asarray(w_pack),
                                          np.asarray(t_pack)], axis=1),
                          device=dev)
    serving["mcmc"]["param_batch"] = batch_phase(
        "59", "four N(m, s) targets x four adaptive walks "
        "(pack_random_walk_batch), error bars", mcmc_cuda, mcmc_counters,
        serve.compile_mcmc(MCMC_MAIN_FNS, w_targets[0], w_walks[0],
                           seed_batch=4, param_batch=True, return_stderr=True,
                           **short), (m_seeds, t_pack, w_pack),
        lambda r: serve.compile_mcmc(MCMC_MAIN_FNS, w_targets[r], w_walks[r],
                                     return_stderr=True, **short)(m_seeds[r]),
        *mcmc_batch_launches(w_prog, w_cfg, w_rows, m_seeds, None),
        4, m_units, mcmc_batch_bound(w_prog, w_cfg, 4))
    c11_out = hmc_out["c11"]
    c11_fns = HMC_CELLS["c11"][0]
    x_prog, x_cfg, x_params, x_tabs = mcmc_setup(c11_fns, c11_out["target"],
                                                 c11_out["hmc"], False)
    x_one = serve.compile_mcmc(c11_fns, c11_out["target"], c11_out["hmc"],
                               **short)
    serving["mcmc"]["hmc_seed_batch"] = batch_phase(
        "59", f"c11's HMC handle, L = {HMC_LEAPFROG}, seed_batch=2",
        mcmc_cuda, mcmc_counters,
        serve.compile_mcmc(c11_fns, c11_out["target"], c11_out["hmc"],
                           seed_batch=2, **short), (m_seeds[:2],),
        lambda r: x_one(m_seeds[r]),
        *mcmc_batch_launches(x_prog, x_cfg, x_params, m_seeds[:2], x_tabs),
        2, m_units, mcmc_batch_bound(x_prog, x_cfg, 2))
    serve_s = time.perf_counter() - t_serve
    print(f"phases 54-59 (the serving handles) took {serve_s:.1f} s")

    # 60-63. The nd and tempered compile_mcmc handles at SHORT_MCMC's
    # depth with error bars, each phase as phase 59's: one warm call is
    # one batched chain launch (and one pilot launch), each rep's rows and
    # final states (and draws) the unbatched launch's, each element of the
    # handle the unbatched handle's, bit for bit.  An nd batch's bound is
    # counted on a one-lane build of its group, a tempered one's on its
    # ladder layout's build, the function's own instructions, as phases 18
    # and 22 count them (the build that runs beside it); the libraries
    # these phases add were started with phase 54.
    t_serve_nd = time.perf_counter()
    built = [b.result() for b in serving_builds]
    serving_pool.shutdown()
    print(f"phase 60: {len(built)} nd libraries (handles and one-lane "
          f"builds), {min(t for _, t in built):.1f}-"
          f"{max(t for _, t in built):.1f} s each, waited "
          f"{time.perf_counter() - t_serve_nd:.1f} s for the last (started "
          "with phase 54)")
    serving["mcmc_nd"], serving["mcmc_pt"] = {}, {}
    b_seeds = k8_seeds[:4]

    def nd_batch_launches(prog_, cfg_, rows_, seeds_, tabs_=None):
        words_ = words(seeds_)

        def outs(o):
            return (o.rows, o.x_final) + (() if o.samples is None
                                          else (o.samples,))

        def batch():
            return outs(mcmc_nd_batch(prog_, cfg_, rows_, words_, m_grid,
                                      tabs_))

        def one(r):
            return outs(mcmc_nd_cuda(prog_, cfg_, rows_[r] if rows_.dim() == 3
                                     else rows_, seeds_[r], m_grid, tabs_))

        return batch, one

    def nd_batch_bound(prog_, cfg_, reps):
        return lane_bound(prog_.library(), prog_.layout.lanes,
                          nd_one_lane(prog_, cfg_).library, "mcmc_nd_kernel",
                          cfg_.d + 1, cfg_, reps)

    def nd_serving_phase(phase, key, label, fns_, target_, proposal_, prog_,
                         cfg_, params_, reps, **kw):
        one_h = serve.compile_mcmc(fns_, target_, proposal_,
                                   return_stderr=True, **kw, **short)
        serving["mcmc_nd"][key] = batch_phase(
            phase, label, mcmc_nd_cuda, mcmc_counters,
            serve.compile_mcmc(fns_, target_, proposal_, seed_batch=reps,
                               return_stderr=True, **kw, **short),
            (b_seeds[:reps],), lambda r: one_h(b_seeds[r]),
            *nd_batch_launches(prog_, cfg_, params_, b_seeds[:reps]),
            reps, m_units, nd_batch_bound(prog_, cfg_, reps))

    depth = (f"{m_grid.chains_actual} x ({short['n_burnin']} + "
             f"{short['n_steps']}), error bars")
    for name in ("c9e", "c9d"):
        fns_, target_, proposal_, _ = nd_mcmc_cells[name]
        nd_serving_phase(
            "60", f"{name}_seed_batch", f"{name}, {depth}, seed_batch=4",
            fns_, target_, proposal_, *nd_serving_setups[name], 4)
    nd_serving_phase(
        "61", "c9e_draws_seed_batch",
        f"c9e, {depth}, {SERVING_DRAWS} draws, seed_batch=4", c9e_fns,
        c9e_joint, c9e_proposal, *nd_serving_setups["c9e_draws"], 4,
        return_samples=SERVING_DRAWS)

    # 62. c9d's set over four rows: targets N(m, s) x N(m', s') under
    # N(0, s_q)^2 proposals, and under adaptive walks.
    t_pack_nd = tm.pack_param_batch_nd(row_targets)
    for key, label, props_, pack_ in (
            ("param_batch", "four pack_param_batch_nd rows of targets and "
             "proposals", row_props, tm.pack_param_batch_nd(row_props)),
            ("walk_param_batch", "four targets x four adaptive walks "
             "(pack_random_walk_batch_nd)", row_walks,
             tm.pack_random_walk_batch_nd(row_walks, row_targets))):
        prop_rows = np.asarray(pack_)
        if prop_rows.shape[-1] == 2:
            prop_rows = np.concatenate([prop_rows, np.zeros_like(prop_rows)],
                                       axis=-1)
        rows_ = torch.tensor(np.concatenate([prop_rows, np.asarray(t_pack_nd)],
                                            axis=-1), device=dev)
        prog_, cfg_, _ = nd_serving_setups[key]
        serving["mcmc_nd"][key] = batch_phase(
            "62", f"c9d's set, {label}, {depth}", mcmc_nd_cuda, mcmc_counters,
            serve.compile_mcmc(C9D_FNS, row_targets[0], props_[0],
                               seed_batch=4, param_batch=True,
                               return_stderr=True, **short),
            (b_seeds, t_pack_nd, pack_),
            lambda r, p=props_: serve.compile_mcmc(
                C9D_FNS, row_targets[r], p[r], return_stderr=True,
                **short)(b_seeds[r]),
            *nd_batch_launches(prog_, cfg_, rows_, b_seeds),
            4, m_units, nd_batch_bound(prog_, cfg_, 4))

    # 63. The tempered handles, seed_batch=2: c12, c12b, c12c, c12d.
    c12b_cell = HMC_ND_CELLS["c12b"]
    pt_serving_cells = {
        "c12": (PT_FNS, logmix, c12_walk, PT_LADDER),
        "c12b": (c12b_cell["fns"], c12b_cell["target"](),
                 tm.HMC(**c12b_cell["hmc"]), c12b_cell["temps"]),
        "c12c": (PT_FNS, logmix, n06, PT_LADDER),
        "c12d": (C12D_FNS, c5_target, c12d_proposal, PT_LADDER),
    }
    for name, (fns_, target_, proposal_, temps_) in pt_serving_cells.items():
        parsed_ = integ._parse_nd_mcmc_args(target_, proposal_)
        prog_, cfg_, params_, ladder_ = pt_setup(
            fns_, target_, proposal_, temps_, short["n_steps"],
            short["n_burnin"], True)
        tabs_ = nd_dim_tables(parsed_[0], parsed_[1], parsed_[3], dev)
        words_ = words(b_seeds[:2])

        def pt_batch(p=prog_, c=cfg_, q=params_, lad=ladder_, t=tabs_,
                     w=words_):
            o = mcmc_pt_batch(p, c, q, lad, w, m_grid, t)
            return o.rows, o.x_final

        def pt_one(r, p=prog_, c=cfg_, q=params_, lad=ladder_, t=tabs_):
            o = mcmc_pt_cuda(p, c, q, lad, b_seeds[r], m_grid, t)
            return o.rows, o.x_final

        one_h = serve.compile_mcmc(fns_, target_, proposal_,
                                   temperatures=temps_, return_stderr=True,
                                   **short)
        ladder_lib = McmcPtProgram(prog_.fns, cfg_, prog_.target,
                                   layout=LADDER_LAYOUT).library()
        rungs = cfg_.n_temps
        serving["mcmc_pt"][f"{name}_seed_batch"] = batch_phase(
            "63", f"{name}, {rungs} rungs, {depth}, seed_batch=2",
            mcmc_pt_cuda, mcmc_counters,
            serve.compile_mcmc(fns_, target_, proposal_, temperatures=temps_,
                               seed_batch=2, return_stderr=True, **short),
            (b_seeds[:2],), lambda r, h=one_h: h(b_seeds[r]), pt_batch,
            pt_one, 2, m_units * rungs,
            chain_batch_bound(
                (ladder_lib, 1), None, "mcmc_pt_kernel",
                rungs * (cfg_.d + 1) + (rungs - 1) // 2, cfg_, 2,
                prog_.layout.rung_lanes * prog_.layout.lanes, rungs))
        serving["mcmc_pt"][f"{name}_seed_batch"]["layout"] = list(
            prog_.layout)
    print(f"phases 60-63 (the nd and tempered handles) took "
          f"{time.perf_counter() - t_serve_nd:.1f} s")

    # 64-67. The wide sets and control variates (libraries started in
    # phase 2): each cell through its public call, counted from 0 (one
    # launch a group); every pass held against its plain version on the
    # card; each pass timed (CUDA events) and bounded on its own build,
    # beside nvcc's spills.
    t_wide = time.perf_counter()
    built = [b.result() for b in wide_builds]
    print(f"phase 64: built the wide sets' {len(built)} libraries, "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel since phase 2), waited "
          f"{time.perf_counter() - t_wide:.1f} s for the last")

    def spill_bytes(lib_):
        """The most bytes of spill stores and loads ptxas reported for any
        function of ``lib_`` (None where it came from the build cache)."""
        found = [tuple(int(n) for n in m.groups()) for m in re.finditer(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            lib_.build_log)]
        if not found:
            return None, None
        return max(f[0] for f in found), max(f[1] for f in found)

    def pass_record(prog_, cfg_, dist_, n, label):
        """One integrate pass at ``n`` samples: the kernel timed (CUDA
        events), its bound on its own build (table loads left out) and
        its spills."""
        spec_ = dist_spec_of(dist_)
        params_ = torch.tensor(spec_.params, device=dev)
        tables_ = tables_of(prog_, dist_)
        grid_ = plan_grid(make_integrate_plan(n).actual_samples, cfg_.method)
        pilot_ = (pilot_values(prog_.torch_values, spec_.kind, params_,
                               tables_) if cfg_.with_stderr else None)
        lib_ = prog_.library(cfg_, route_of(prog_, dist_))

        def run():
            integrate_cuda(prog_, spec_.kind, params_, SEED, grid_, cfg_,
                           pilot_, tables_)

        ms_ = time_ms(run, reps=10)
        mhz_ = clock_under_load(run, ms_)
        bound_ = card_bound(lib_, f"integrate_kernelILi{int(spec_.kind)}EE",
                            1, grid_.actual_samples, mhz_)
        stores, loads = spill_bytes(lib_)
        k_ = len(prog_.fns)
        print(f"{label}: a pass of {k_} functions at {grid_.actual_samples} "
              f"samples on {card}: {ms_:.4f} ms "
              f"({grid_.actual_samples * k_ / ms_ * 1e3:.4e} samples x "
              f"functions/s), {ms_ / bound_[0]:.2f}x its bound; spills "
              f"{stores} / {loads} bytes (stores / loads)")
        print_bound(bound_, mhz_, "sample")
        return {"k": k_, "samples": grid_.actual_samples, "ms": ms_,
                "bound_ms": bound_[0], "bound_pipe": bound_[1],
                "issue_ms": bound_[2], "bound_mhz": mhz_,
                "spill_stores": stores, "spill_loads": loads}

    # 64. c7: K = 128 and 256 bins through compile_integrate at 2**27, one
    # and two launches; the bins within 6 sigma + C7_TABLE_TOL of Beta(2,
    # 5)'s masses (the 2048-entry table's interpolation moves a bin); the
    # per-function rate of K = 256 against K = 128's (the reference
    # expects it within ~2x).
    n_c7 = plan_grid(make_integrate_plan(C7_SAMPLES).actual_samples).actual_samples
    c7 = {}
    for k in (128, 256):
        groups = c7_groups[k]
        handle = serve.compile_integrate(hist_fns(k), c7_beta,
                                         n_samples=C7_SAMPLES)
        integrate_cuda.launches = 0
        out = handle(SEED)
        torch.cuda.synchronize()
        launches = integrate_cuda.launches
        print(f"phase 64: c7, compile_integrate({k} bins of [0, 1), Beta(2,5) "
              f"{C7_TABLE_SIZE}-entry table, n_samples={C7_SAMPLES})(seed): "
              f"{launches} launch(es), groups {[len(g.fns) for g in groups]}")
        if launches != len(groups):
            fail(f"phase 64: c7 K={k} is not one launch a group")
        v = out.double().cpu().numpy()
        masses = hist_masses(k)
        off = np.abs(v - masses)
        gate = 6.0 * np.sqrt(masses * (1.0 - masses) / n_c7) + C7_TABLE_TOL
        print(f"  bins sum to {v.sum():.7f}; max |bin - mass| "
              f"{off.max():.3e}, at most {np.max(off / gate):.3f} of 6 sigma "
              f"+ {C7_TABLE_TOL:g}")
        if v.shape != (k,) or not np.all(np.isfinite(v)):
            fail(f"phase 64: bad c7 K={k} result")
        if abs(v.sum() - 1.0) > 1e-5 or np.any(off > gate):
            fail(f"phase 64: c7 K={k}'s bins are off Beta(2,5)'s masses")
        err = max(mode_vs_plain(p, c7_beta, MC_CFG, C7_CHECK_SAMPLES, "64")
                  for p in groups)
        passes = [pass_record(p, MC_CFG, c7_beta, C7_SAMPLES,
                              f"phase 64: c7 K={k}, pass {g}")
                  for g, p in enumerate(groups)]
        card_ms = sum(p["ms"] for p in passes)
        call_ms = time_ms(lambda h=handle: h(SEED), reps=10)
        c7[f"k{k}"] = {
            "launches": launches, "groups": [p["k"] for p in passes],
            "max_abs_err": err, "samples": n_c7, "ms": card_ms,
            "call_card_ms": call_ms,
            "samples_functions_per_s": n_c7 * k / card_ms * 1e3,
            "bound_ms": sum(p["bound_ms"] for p in passes), "passes": passes,
            "max_bin_err": float(off.max())}
        print(f"  c7 K={k} on {card}: {card_ms:.4f} ms of passes a call "
              f"({call_ms:.4f} ms between the handle call's events), "
              f"{c7[f'k{k}']['samples_functions_per_s']:.4e} samples x "
              "functions/s")
    c7["rate_ratio"] = (c7["k256"]["samples_functions_per_s"]
                        / c7["k128"]["samples_functions_per_s"])
    print(f"phase 64: K=256's per-function rate is {c7['rate_ratio']:.3f} of "
          "K=128's: the reference's 'within ~2x' "
          f"{'holds' if c7['rate_ratio'] >= 0.5 else 'does not hold'}")

    # 65. K = 128 with error bars: c7's 128 bins through compile_integrate
    # with return_stderr=True, one launch; the pass against its plain
    # version; timed, bounded, its spills.
    handle = serve.compile_integrate(hist_fns(128), c7_beta,
                                     n_samples=C7_SAMPLES, return_stderr=True)
    integrate_cuda.launches = 0
    v65, s65 = handle(SEED)
    torch.cuda.synchronize()
    launches65 = integrate_cuda.launches
    masses = hist_masses(128)
    v65, s65 = v65.double().cpu().numpy(), s65.double().cpu().numpy()
    # A bin the run drew no sample in (Beta(2, 5)'s mass past x = 0.99 is
    # 1e-11) has the error bar 0.
    drawn = v65 > 0
    print(f"phase 65: c7's 128 bins with error bars, {launches65} launch(es); "
          f"{int(drawn.sum())} bins drawn, max |bin - mass| / stderr over "
          f"them {np.max(np.abs(v65 - masses)[drawn] / s65[drawn]):.2f}")
    if launches65 != 1 or not (np.all(np.isfinite(v65))
                               and np.array_equal(s65 > 0, drawn)):
        fail("phase 65: bad K=128 error-bar result")
    err65 = mode_vs_plain(c7_groups[128][0], c7_beta, stderr_cfg,
                          C7_CHECK_SAMPLES, "65")
    k128_stderr = pass_record(c7_groups[128][0], stderr_cfg, c7_beta,
                              C7_SAMPLES, "phase 65: c7 K=128, error bars")
    k128_stderr.update(launches=launches65, max_abs_err=err65)

    # 66. The wide MCMC sets at MCMC_CHECK's shape with error bars through
    # integrate_mcmc (one chain and one pilot launch a group, the passes'
    # chains checked equal in the call); each pass against its plain
    # version at WIDE_MCMC_CHECK's depth; the passes' final states and
    # accept (and swap) counts bit for bit; each pass timed and bounded
    # (pipes on its one-lane or ladder build, latency) with its spills.
    wide_check = wide_mcmc_setups(WIDE_MCMC_CHECK)
    w_depth = MCMC_CHECK["n_steps"] + MCMC_CHECK["n_burnin"]
    w_steps = check_grid.chains_actual * w_depth
    mcmc_wide = {}
    for name, (target_, proposal_, temps, wrapper) in wide_mcmc_cells.items():
        setups = wide_mcmc[name]
        ks = [s_["k"] for s_ in setups]
        extra = {} if temps is None else {"temperatures": temps}
        wrapper.launches = wrapper.pilot_launches = 0
        t0 = time.perf_counter()
        r = tm.integrate_mcmc(WIDE_MCMC_FNS[name], target_, proposal_,
                              return_stderr=True, seed=SEED, **MCMC_CHECK,
                              **extra)
        call_s = time.perf_counter() - t0
        launches = (wrapper.launches, wrapper.pilot_launches)
        v, se = np.asarray(r.values), np.asarray(r.stderr)
        z = (v - WIDE_MCMC_EXACT[name]) / se
        print(f"phase 66: {name}'s shape, {len(v)} functions in groups {ks}, "
              f"{check_grid.chains_actual} chains x ({MCMC_CHECK['n_burnin']} "
              f"+ {MCMC_CHECK['n_steps']}), error bars: integrate_mcmc in "
              f"{call_s:.3f} s (host clock, first call), launches (chain, "
              f"pilot) {launches}; E[f] - {WIDE_MCMC_EXACT[name]} within "
              f"{np.abs(z).max():.2f} stderr, acceptance "
              f"{r.acceptance_rate:.4f}"
              + ("" if temps is None else
                 f", swap rate {r.diagnostics['swap_rate']:.4f}"))
        if launches != (len(setups), len(setups)):
            fail(f"phase 66: {name} is not one chain and one pilot launch "
                 "a group")
        if not np.all(np.isfinite(v)) or np.any(np.abs(z) > 6.0):
            fail(f"phase 66: {name}'s estimates are off their closed form")
        err = max(custom_vs_plain(s_, check_grid, "66")[0]
                  for s_ in wide_check[name])
        outs = [s_["kernel"](check_grid) for s_ in setups]
        try:
            check_same_chains(outs, ks, swap=temps is not None)
        except RuntimeError as e:
            fail(f"phase 66: {name}: {e}")
        print(f"phase 66: {name}'s {len(setups)} passes ended in the same "
              "states with the same accept"
              + (" and swap" if temps is not None else "")
              + " counts, bit for bit")
        cfg_ = setups[0]["cfg"]
        rungs = 1 if temps is None else cfg_.n_temps
        conversions = (2 if wrapper is mcmc_cuda else
                       cfg_.d + 1 if wrapper is mcmc_nd_cuda else
                       cfg_.n_temps * (cfg_.d + 1) + (cfg_.n_temps - 1) // 2)
        function = {mcmc_cuda: "mcmc_kernel", mcmc_nd_cuda: "mcmc_nd_kernel",
                    mcmc_pt_cuda: "mcmc_pt_kernel"}[wrapper]
        passes = []
        for g, s_ in enumerate(setups):
            ms_ = time_ms(lambda s_=s_: s_["kernel"](check_grid), reps=5)
            mhz_ = clock_under_load(lambda s_=s_: s_["kernel"](check_grid),
                                    ms_)
            bound_ = card_bound(
                custom_mcmc_library(s_, bound=True), function, conversions,
                w_steps, mhz_,
                warps=function_warps(cfg_.mode, check_grid.chains_actual,
                                     rungs),
                weights=(MCMC_CHECK["n_steps"], MCMC_CHECK["n_burnin"]))
            stores, loads = spill_bytes(custom_mcmc_library(s_))
            print(f"phase 66: {name} pass {g} ({s_['k']} functions) on "
                  f"{card}: {ms_:.4f} ms ({w_steps / ms_ * 1e3:.4e} "
                  f"chain-steps/s); spills {stores} / {loads} bytes (stores "
                  "/ loads)")
            print_bound(bound_, mhz_, "chain-step")
            latency_ = print_latency(bound_, w_depth, mhz_)
            passes.append({
                "k": s_["k"], "ms": ms_, "bound_ms": max(bound_[0], latency_),
                "bound_by": bound_by(bound_, latency_),
                "bound_pipe": bound_[1], "pipe_bound_ms": bound_[0],
                "latency_ms": latency_, "issue_ms": bound_[2],
                "bound_mhz": mhz_, "spill_stores": stores,
                "spill_loads": loads})
        mcmc_wide[name] = {
            "launches": launches[0], "pilot_launches": launches[1],
            "groups": ks, "n_steps": MCMC_CHECK["n_steps"],
            "n_burnin": MCMC_CHECK["n_burnin"], "max_abs_err": err,
            "ms": sum(p["ms"] for p in passes),
            "bound_ms": sum(p["bound_ms"] for p in passes),
            "passes": passes, "max_z": float(np.abs(z).max()),
            "acceptance_rate": r.acceptance_rate,
            **({} if temps is None else
               {"swap_rate": r.diagnostics["swap_rate"]})}

    # 67. Control variates: exp(x/2) and 31 shifted copies under N(0, 1)
    # with the controls x, x^2, x^3, sin x at 2**24, through integrate():
    # 174 composed integrands (two launches), then with error bars (206,
    # two launches) against the plain run's; each pass against its plain
    # version at 2**22; the 174 set's passes timed and bounded.
    n_cv = plan_grid(make_integrate_plan(CV_SAMPLES).actual_samples).actual_samples
    integrate_cuda.launches = 0
    t0 = time.perf_counter()
    cv = serve.integrate(CV_FNS, n01, n_samples=CV_SAMPLES, seed=SEED,
                         control_variates=CV_CONTROLS)
    cv_s = time.perf_counter() - t0
    cv_launches = integrate_cuda.launches
    cv_se = serve.integrate(CV_FNS, n01, n_samples=CV_SAMPLES, seed=SEED,
                            control_variates=CV_CONTROLS, return_stderr=True)
    plain_cv = serve.integrate(CV_FNS, n01, n_samples=CV_SAMPLES, seed=SEED,
                               return_stderr=True)
    total_launches = integrate_cuda.launches
    z = (cv_se.values - np.asarray(CV_MEANS)) / cv_se.stderr
    ratio = cv_se.stderr / plain_cv.stderr
    print(f"phase 67: control variates, {len(CV_FNS)} functions and "
          f"{len(CV_CONTROLS)} controls at {n_cv} samples: the 174-integrand "
          f"set in groups {[len(p.fns) for p in cv_groups[False]]}, "
          f"{cv_launches} launch(es), first call {cv_s:.3f} s (host clock); "
          f"with error bars groups {[len(p.fns) for p in cv_groups[True]]} "
          f"and the plain run, {total_launches - cv_launches} more; within "
          f"{np.abs(z).max():.2f} error bars of the closed forms; error bar "
          f"{ratio.min():.4f}-{ratio.max():.4f} of the plain run's; values "
          f"of the two CV runs equal: {np.array_equal(cv.values, cv_se.values)}")
    if cv_launches != len(cv_groups[False]) or total_launches != (
            len(cv_groups[True]) + 1 + cv_launches):
        fail("phase 67: a control-variate run is not one launch a group")
    if not (np.all(np.isfinite(cv.values)) and np.all(np.abs(z) <= 6.0)
            and np.all(ratio < 1.0)):
        fail("phase 67: the control-variate estimates are off")
    cv_err = max(mode_vs_plain(p, n01, MC_CFG, CV_CHECK_SAMPLES, "67")
                 for groups in cv_groups.values() for p in groups)
    cv_passes = [pass_record(p, MC_CFG, n01, CV_SAMPLES,
                             f"phase 67: control variates, pass {g}")
                 for g, p in enumerate(cv_groups[False])]
    cv_rec = {"launches": cv_launches, "groups": [p["k"] for p in cv_passes],
              "max_abs_err": cv_err, "samples": n_cv,
              "ms": sum(p["ms"] for p in cv_passes),
              "bound_ms": sum(p["bound_ms"] for p in cv_passes),
              "passes": cv_passes, "max_z": float(np.abs(z).max()),
              "stderr_ratio": [float(ratio.min()), float(ratio.max())]}
    print(f"phases 64-67 (the wide sets and control variates) took "
          f"{time.perf_counter() - t_wide:.1f} s")

    # 68. The tables the JAX package runs on its XLA sweep: the libraries
    # started in phase 2, then each new route of the three kernels against
    # its plain version, chain for chain, at MCMC_CHECK's shape.
    t_xla = time.perf_counter()
    built = [b.result() for b in xla_builds]
    print(f"phase 68: built the knots, full and irregular-table routes' "
          f"{len(built)} libraries, "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for lib_, _ in built:
        for line in lib_.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    xla_err = 0.0
    xla_routes = {}
    for name, setup in xla_checks:
        print(f"phase 68: {name}, {check_grid.chains_actual} chains x "
              f"({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) steps")
        err_, plain_ms_ = custom_vs_plain(setup, check_grid, "68")
        xla_err = max(xla_err, err_)
        if name not in xla_timed:
            continue
        ms_ = time_ms(lambda s=setup: s["kernel"](check_grid), reps=10)
        print(f"phase 68: {name} on {card}: kernel {ms_:.3f} ms, plain "
              f"{plain_ms_:.3f} ms")
        xla_routes[xla_timed[name]] = {
            "n_steps": MCMC_CHECK["n_steps"],
            "n_burnin": MCMC_CHECK["n_burnin"], "max_abs_err": err_,
            "ms": ms_, "plain_ms": plain_ms_, "library_ms": None,
            **chain_bound(setup, MCMC_CHECK, ms_, check_grid, None)}

    # 69-71. The cells through the public API, each counted from 0, held
    # to its closed forms within 6 error bars and XLA_TOLERANCE, against
    # its plain version at MCMC_CHECK's shape, timed and bounded at its own
    # with its knot searches (mcmc_cell, chain_bound).
    xla_mcmc = {}
    for name, (phase, fns, target, proposal, temps, exact, shape) in (
            xla_cells.items()):
        rec = mcmc_cell(phase, name, (fns, target, proposal, temps, exact),
                        xla_main[name], XLA_TOLERANCE, shape=shape,
                        check=MCMC_CHECK)
        rec["max_abs_err"] = max(rec["max_abs_err"], xla_err)
        print(f"phase {phase}: {name} on {card}: kernel {rec['ms']:.3f} ms, "
              f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}), plain "
              f"{rec['plain_ms']:.3f} ms")
        xla_mcmc[name] = rec
    print(f"phases 68-71 (the XLA-only tables) took "
          f"{time.perf_counter() - t_xla:.1f} s")

    # 72-75. expectation_fn's gradient builds of kernels 1 and 2 and
    # adapt_proposal feeding kernel 1's table route; the libraries started
    # in phase 2.
    t_grad = time.perf_counter()
    built = [b.result() for b in grad_builds]
    print(f"phase 72: built the gradient builds' and the learned proposal's "
          f"{len(built)} libraries, "
          f"{min(t for _, t in built):.1f}-{max(t for _, t in built):.1f} s "
          "each (in parallel with phase 2)")
    for lib_, _ in built:
        for line in lib_.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    def spills(lib_) -> dict:
        """The largest spill stores and loads (bytes) ptxas reported for
        any kernel of ``lib_``."""
        found = [tuple(int(v) for v in m) for m in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            lib_.build_log)]
        return {"stores": max((a for a, _ in found), default=0),
                "loads": max((b for _, b in found), default=0)}

    def grad_size(prog, kind, params_):
        """(K, 2): the mean |f_k'(x) dx/dp| on the family's 1,024
        quantile midpoints, the scale of GRAD_RTOL's absolute term."""
        u_ = (torch.arange(1024, dtype=torch.float32) + 0.5) / 1024.0
        p_ = params_.cpu()
        x_, d1_, d2_ = transform_grad_from_u(u_, kind, p_[0], p_[1])
        out = []
        for vg in prog.torch_grads:
            _, (g_,) = vg(x_)
            out.append([float((g_ * d_).abs().mean()) for d_ in (d1_, d2_)])
        return np.array(out)

    def grads_agree(g_k, g_p, size, label):
        """Fails unless the kernel's pathwise means ``g_k`` and the plain
        version's ``g_p`` agree within GRAD_RTOL (equal infinities and
        NaNs agree).  Returns the largest difference over the bound."""
        with np.errstate(invalid="ignore"):
            diff = np.abs(g_k - g_p)
            allowed = GRAD_RTOL * (np.abs(g_p) + size)
            ok = (g_k == g_p) | (np.isnan(g_k) & np.isnan(g_p)) | (
                diff <= allowed)
        print(f"{label}: gradients kernel {g_k.tolist()}")
        print(f"         plain {g_p.tolist()}")
        if not np.all(ok):
            fail(f"{label}: kernel and plain gradients disagree")
        finite = np.isfinite(diff)
        return float(np.max(diff[finite] / np.maximum(allowed[finite],
                                                     1e-300), initial=0.0))

    def grad_vs_plain(prog, kind, params_, cfg, n, label):
        """The gradient build at ``n`` samples against the value build
        (value sums bit for bit) and against its plain version (means as
        phase 25, pathwise means within GRAD_RTOL).  Returns (max abs
        difference of the means, of the gradients' over their bound)."""
        grid_ = plan_grid(make_integrate_plan(n).actual_samples, cfg.method)
        sums, grads = integrate_grad_cuda(prog, kind, params_, SEED, grid_,
                                          cfg)
        values_ = integrate_cuda(prog, kind, params_, SEED, grid_,
                                 IntegrateConfig(cfg.method))
        if not torch.equal(sums, values_):
            fail(f"{label}: the gradient build's values are not the value "
                 "build's bit for bit")
        want_s, want_g = integrate_grad_reference(prog, kind, params_, SEED,
                                                  grid_, cfg)
        n_f = float(np.float32(grid_.actual_samples))
        m_k = (sums / n_f).double().cpu().numpy()
        m_p = (want_s / n_f).double().cpu().numpy()
        size = np.maximum(pilot_values(
            lambda *a: [v.abs() for v in prog.torch_values(*a)], kind,
            params_).double().cpu().numpy(), np.abs(m_p))
        err = np.abs(m_k - m_p)
        print(f"{label}, {grid_.actual_samples} samples: values kernel "
              f"{m_k} plain {m_p} max|diff| {err.max():.3e}")
        if not (np.all(np.isfinite(m_k))
                and np.all(err <= RTOL * np.abs(m_p) + ATOL * size)):
            fail(f"{label}: kernel and plain values disagree")
        g_err = grads_agree((grads / n_f).double().cpu().numpy(),
                            (want_g / n_f).double().cpu().numpy(),
                            grad_size(prog, kind, params_), f"  {label}")
        return float(err.max()), g_err

    def batch_means(rows, k, width, n_tiles):
        """The pathwise means and their standard errors from a gradient
        launch's block rows (blocks, k + k * width): each block's mean
        over its equal share of the tiles, the spread of the block means
        over sqrt(blocks)."""
        blocks = rows.shape[0]
        if n_tiles % blocks:
            fail("the gradient launch's blocks draw unequal tile counts")
        per_block = float(n_tiles // blocks * (1 << 15))
        g = rows[:, k:].double().cpu().numpy().reshape(blocks, k, width)
        g = g / per_block
        return g.mean(axis=0), g.std(axis=0, ddof=1) / math.sqrt(blocks)

    def held_to_exact(mean, se, exact, label):
        """Each pathwise mean within GRAD_Z of its run's standard errors of
        the closed form; a term the run saw only as 0 exactly 0."""
        exact = np.asarray(exact, np.float64).reshape(mean.shape)
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(se > 0, (mean - exact) / se, 0.0)
        print(f"{label}: pathwise means {mean.tolist()}")
        print(f"         closed forms {exact.tolist()}, max |z| "
              f"{np.abs(z).max():.2f}")
        if not (np.all(np.abs(z) <= GRAD_Z)
                and np.all((se > 0) | (mean == exact))):
            fail(f"{label}: a pathwise gradient is off its closed form")
        return float(np.abs(z).max())

    # 72. The 1-D main path: expectation_fn over the bench set under N(0, 1)
    # at 2**30, its gradient through autograd, counted from 0.
    k8 = len(BENCH_FNS)
    p01 = torch.tensor([0.0, 1.0], device=dev)
    grad_grid = plan_grid(make_integrate_plan(MODE_SAMPLES).actual_samples)
    mc_grad = grad_cfgs["mc"]
    integrate_cuda.launches = 0
    integrate_cuda.grad_launches = 0
    t0 = time.perf_counter()
    est = tm.expectation_fn(BENCH_FNS, normal, n_samples=MODE_SAMPLES)
    leaf = p01.clone().requires_grad_()
    vals = est(leaf, seed=SEED)
    jac = torch.stack([torch.autograd.grad(vals[j], leaf, retain_graph=True)[0]
                       for j in range(k8)])
    torch.cuda.synchronize()
    est_s = time.perf_counter() - t0
    grad_launches = integrate_cuda.grad_launches
    est_launches = integrate_cuda.launches
    print(f"phase 72: expectation_fn(8 fns, N(0,1), n_samples={MODE_SAMPLES})"
          f"(params.requires_grad_()) and 8 backward passes in {est_s:.3f} s "
          f"(host clock, its libraries cached), {grad_launches} gradient "
          f"launch(es) of {est_launches}")
    if grad_launches != 1 or est_launches != 1:
        fail("phase 72: the estimator is not one gradient launch")
    plain_vals = est(p01, seed=SEED)
    ref = tm.integrate(BENCH_FNS, normal, n_samples=MODE_SAMPLES, seed=SEED)
    if not (torch.equal(vals.detach(), plain_vals) and np.array_equal(
            plain_vals.cpu().numpy(), np.float32(ref.values))):
        fail("phase 72: the gradient build's values are not integrate()'s "
             "bit for bit")
    rows = integrate_rows(program, DistKind.NORMAL, p01, SEED, grad_grid,
                          mc_grad)
    g_mean, g_se = batch_means(rows, k8, 2, grad_grid.n_tiles)
    if not np.allclose(g_mean, jac.double().cpu().numpy(), rtol=1e-5,
                       atol=1e-7):
        fail("phase 72: the block rows do not sum to the estimator's "
             "Jacobian")
    grad_z = held_to_exact(g_mean, g_se, BENCH_GRAD_EXACT,
                           "phase 72: K=8, N(0,1), d/d(mu, sigma)")
    grad_rec = {"launches": grad_launches,
                "samples": grad_grid.actual_samples, "max_z": grad_z}

    def grad_run():
        integrate_grad_cuda(program, DistKind.NORMAL, p01, SEED, grad_grid,
                            mc_grad)

    check_grid_ = plan_grid(make_integrate_plan(MODE_CHECK_SAMPLES)
                            .actual_samples)
    grad_rec["ms"] = time_ms(grad_run, reps=10)
    grad_rec["plain_ms"] = time_ms(
        lambda: integrate_grad_reference(program, DistKind.NORMAL, p01, SEED,
                                         check_grid_, mc_grad), reps=1)
    grad_rec["plain_samples"] = check_grid_.actual_samples
    mhz = clock_under_load(grad_run, grad_rec["ms"])
    bound = card_bound(program.library(mc_grad), "integrate_kernelILi1EE", 1,
                       grad_grid.actual_samples, mhz)
    grad_rec.update(bound_ms=bound[0], bound_pipe=bound[1], issue_ms=bound[2],
                    bound_by="operations", library_ms=None,
                    value_ms=ms,
                    spills=spills(program.library(mc_grad)))
    print(f"phase 72: the gradient build, {grad_grid.actual_samples} samples, "
          f"K=8, N(0,1) on {card}: kernel {grad_rec['ms']:.3f} ms (the value "
          f"build {ms:.3f} ms in phase 5, {grad_rec['ms'] / ms:.2f}x), plain "
          f"{grad_rec['plain_ms']:.3f} ms at {check_grid_.actual_samples} "
          f"samples; spills {grad_rec['spills']}")
    print_bound(bound, mhz, "sample")

    # 73. Each method under N(0, 1) and each extended family under mc at
    # 2**22 against the plain version.
    grad_errs = []
    for method in ("mc", "antithetic", "qmc"):
        grad_errs.append(grad_vs_plain(
            program, DistKind.NORMAL, p01, grad_cfgs[method],
            MODE_CHECK_SAMPLES, f"phase 73: K=8, N(0,1), {method}"))
    for name, args in FAMILY_ARGS.items():
        grad_errs.append(grad_vs_plain(
            program, family_kinds[name], torch.tensor(args, device=dev),
            mc_grad, MODE_CHECK_SAMPLES, f"phase 73: K=8, {name}{args}, mc"))
    grad_rec["max_abs_err"] = max(e for e, _ in grad_errs)
    grad_rec["max_grad_err_over_bound"] = max(g for _, g in grad_errs)

    # 74. The nd main path: expectation_fn over c9's set at 2**30, counted
    # from 0, against the closed forms; the build against its plain version
    # at 2**22 in each method; timed and bounded.
    nd_grad_cfgs = {m: NdConfig(nd_kinds, m, grad=True)
                    for m in ("mc", "antithetic", "qmc")}
    nd_grad_grid = plan_grid(make_integrate_plan(MODE_SAMPLES).actual_samples)
    integrate_nd_cuda.launches = 0
    integrate_nd_cuda.grad_launches = 0
    est_nd = tm.expectation_fn(ND_FNS, nd_dists, n_samples=MODE_SAMPLES)
    leaf_nd = nd_params.clone().requires_grad_()
    v_nd = est_nd(leaf_nd, seed=SEED)
    jac_nd = torch.stack([torch.autograd.grad(v_nd[j], leaf_nd,
                                              retain_graph=True)[0]
                          for j in range(len(ND_FNS))])
    torch.cuda.synchronize()
    nd_grad_launches = integrate_nd_cuda.grad_launches
    if nd_grad_launches != 1 or integrate_nd_cuda.launches != 1:
        fail("phase 74: the nd estimator is not one gradient launch")
    nd_ref = tm.integrate(ND_FNS, nd_dists, n_samples=MODE_SAMPLES, seed=SEED)
    if not (torch.equal(v_nd.detach(), est_nd(nd_params, seed=SEED))
            and np.array_equal(v_nd.detach().cpu().numpy(),
                               np.float32(nd_ref.values))):
        fail("phase 74: the nd gradient build's values are not "
             "integrate()'s bit for bit")
    d_nd = len(nd_kinds)
    nd_rows = integrate_nd_rows(nd_program, nd_grad_cfgs["mc"], nd_params,
                                SEED, nd_grad_grid)
    nd_mean, nd_se = batch_means(nd_rows, len(ND_FNS), 2 * d_nd,
                                 nd_grad_grid.n_tiles)
    nd_mean = nd_mean.reshape(len(ND_FNS), d_nd, 2)
    nd_se = nd_se.reshape(len(ND_FNS), d_nd, 2)
    if not np.allclose(nd_mean, jac_nd.double().cpu().numpy(), rtol=1e-5,
                       atol=1e-7):
        fail("phase 74: the nd block rows do not sum to the Jacobian")
    nd_grad_rec = {
        "launches": nd_grad_launches, "samples": nd_grad_grid.actual_samples,
        "max_z": held_to_exact(nd_mean, nd_se, ND_GRAD_EXACT,
                               "phase 74: c9, d/d(rows)")}
    nd_errs = []
    for method, cfg_ in nd_grad_cfgs.items():
        grid_ = plan_grid(make_integrate_plan(MODE_CHECK_SAMPLES)
                          .actual_samples, method)
        sums, grads = integrate_nd_grad_cuda(nd_program, cfg_, nd_params,
                                             SEED, grid_)
        if not torch.equal(sums, integrate_nd_cuda(
                nd_program, NdConfig(nd_kinds, method), nd_params, SEED,
                grid_)):
            fail(f"phase 74: {method}: the nd gradient build's values are "
                 "not the value build's bit for bit")
        want_s, want_g = integrate_nd_grad_reference(
            nd_program.torch_grads, cfg_, nd_params, SEED, grid_)
        n_f = float(np.float32(grid_.actual_samples))
        m_k = (sums / n_f).double().cpu().numpy()
        m_p = (want_s / n_f).double().cpu().numpy()
        err = np.abs(m_k - m_p)
        print(f"phase 74: c9, {method}, {grid_.actual_samples} samples: "
              f"values kernel {m_k} plain {m_p}")
        if not np.all(err <= RTOL * np.abs(m_p) + ATOL):
            fail(f"phase 74: {method}: kernel and plain values disagree")
        g_p = (want_g / n_f).double().cpu().numpy()
        # The scale: c9's terms are O(1) (|x| < 5.2, y < 1, z < 8.1).
        nd_errs.append((float(err.max()), grads_agree(
            (grads / n_f).double().cpu().numpy(), g_p,
            np.ones_like(g_p), f"  phase 74: c9, {method}")))
    nd_grad_rec["max_abs_err"] = max(e for e, _ in nd_errs)
    nd_grad_rec["max_grad_err_over_bound"] = max(g for _, g in nd_errs)

    def nd_grad_run():
        integrate_nd_grad_cuda(nd_program, nd_grad_cfgs["mc"], nd_params,
                               SEED, nd_grad_grid)

    nd_check_grid = plan_grid(make_integrate_plan(MODE_CHECK_SAMPLES)
                              .actual_samples)
    nd_grad_rec["ms"] = time_ms(nd_grad_run, reps=10)
    nd_grad_rec["plain_ms"] = time_ms(
        lambda: integrate_nd_grad_reference(
            nd_program.torch_grads, nd_grad_cfgs["mc"], nd_params, SEED,
            nd_check_grid), reps=1)
    nd_grad_rec["plain_samples"] = nd_check_grid.actual_samples
    mhz = clock_under_load(nd_grad_run, nd_grad_rec["ms"])
    nd_lib = nd_program.library(None, True)
    bound = card_bound(nd_lib, "integrate_nd_kernelILi0ELb0EE", 3,
                       nd_grad_grid.actual_samples, mhz)
    nd_grad_rec.update(bound_ms=bound[0], bound_pipe=bound[1],
                       issue_ms=bound[2], bound_by="operations",
                       library_ms=None, value_ms=nd_ms, spills=spills(nd_lib))
    print(f"phase 74: the nd gradient build, {nd_grad_grid.actual_samples} "
          f"samples, c9 on {card}: kernel {nd_grad_rec['ms']:.3f} ms (the "
          f"value build {nd_ms:.3f} ms in phase 14, "
          f"{nd_grad_rec['ms'] / nd_ms:.2f}x), plain "
          f"{nd_grad_rec['plain_ms']:.3f} ms at "
          f"{nd_check_grid.actual_samples} samples; spills "
          f"{nd_grad_rec['spills']}")
    print_bound(bound, mhz, "sample")

    # 75. adapt_proposal at its defaults on the card, against the same call
    # on the host (phase 2); then config 4's IS with the learned proposal
    # through the public call, counted from 0, its kernel timed as phase 27
    # times config 4's.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learned, adapt_hist = tm.adapt_proposal(
        IS_FNS[0], is_target, support=ADAPT_SUPPORT, return_history=True)
    torch.cuda.synchronize()
    adapt_s = time.perf_counter() - t0
    edge_err = float(np.max(np.abs(adapt_hist["edges"][0]
                                   - adapt_cpu_hist["edges"][0])))
    width = ADAPT_SUPPORT[1] - ADAPT_SUPPORT[0]
    print(f"phase 75: adapt_proposal([x > 4], N(0,1), support="
          f"{ADAPT_SUPPORT}) on {card} in {adapt_s * 1e3:.1f} ms (host "
          f"clock, first call); the iterations' error bars "
          f"{adapt_hist['stderr']}; edges against the host's: max |diff| "
          f"{edge_err:.3e} (allowed {ADAPT_EDGE_TOL * width:.3e})")
    if not edge_err <= ADAPT_EDGE_TOL * width:
        fail("phase 75: the card's learned edges are not the host's")
    integrate_cuda.launches = 0
    learned_r = tm.integrate_importance_sampling(
        IS_FNS, is_target, learned, n_samples=IS_SAMPLES, seed=SEED,
        return_stderr=True)
    learned_launches = integrate_cuda.launches
    lv, lse = float(learned_r.values[0]), float(learned_r.stderr[0])
    fixed_se = float(is_result.stderr[0])
    learned_spec = dist_spec_of(learned)
    learned_tables = tables_of(adapt_program, learned)
    print(f"phase 75: config 4 with the learned proposal ("
          f"{learned_launches} launch(es), route "
          f"{library_route(learned_spec.kind, learned_tables)!r}, weight "
          f"modes {adapt_program._lowered_weight()[1]}): P(X > 4) = "
          f"{lv:.7e} +- {lse:.3e}, exact {IS_EXACT:.7e}, z = "
          f"{(lv - IS_EXACT) / lse:+.2f}; the fixed N(4,1.5) proposal's "
          f"error bar {fixed_se:.3e}, {fixed_se / lse:.2f}x the learned one's")
    if learned_launches < 1 or library_route(
            learned_spec.kind, learned_tables) != "strata":
        fail("phase 75: the learned proposal did not take kernel 1's strata "
             "route")
    if not (lse > 0 and abs(lv - IS_EXACT) <= 6 * lse):
        fail("phase 75: the learned proposal's estimate is off P(X > 4)")
    adapt_rec = mode_times(
        adapt_program, is_cfg, adapt_program.library(is_cfg, "strata"),
        learned_spec, IS_SAMPLES,
        lambda: tm.integrate_importance_sampling(
            IS_FNS, is_target, learned, n_samples=IS_SAMPLES, seed=SEED,
            return_stderr=True),
        "phase 75: config 4 from the learned proposal", tables=learned_tables)
    adapt_rec.update(launches=learned_launches, adapt_ms=adapt_s * 1e3,
                     edge_max_abs_diff=edge_err, value=lv, stderr=lse,
                     fixed_stderr=fixed_se, stderr_ratio=fixed_se / lse,
                     library_ms=None, bound_by="operations")
    print(f"phases 72-75 (gradient builds, adapt_proposal) took "
          f"{time.perf_counter() - t_grad:.1f} s")
    print(f"chip_smoke.py ran {time.perf_counter() - t_main:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "integrate",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/integrate.cu",
        "replaces": "tpu_montecarlo/ops/integrate_pallas.py:969",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": integrate_bound[0],
        "bound_by": "operations",
        "bound_pipe": integrate_bound[1],
        "issue_ms": integrate_bound[2],
        "parent_bound_ms": integrate_parent[0],
        "parent_bound_pipe": integrate_parent[1],
        "parent_issue_ms": integrate_parent[2],
        "library_ms": None,
        "is_launches": is_launches,
        "custom_launches": custom_launches,
        "custom_max_abs_err": custom_err,
        "modes": modes,
        "families": {"launches": family_launches,
                     "max_abs_err": family_err, **family_times},
        "batch": serving["integrate"],
        "wide": {"c7": c7, "k128_stderr": k128_stderr,
                 "control_variates": cv_rec},
        "grad": grad_rec,
        "adapt": adapt_rec,
    }, {
        "name": "mcmc",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/mcmc.cu",
        "replaces": "tpu_montecarlo/ops/mcmc_pallas.py:612",
        "launches": mcmc_launches,
        "pilot_launches": pilot_launches,
        "max_abs_err": mcmc_err,
        "ms": mcmc_ms,
        "plain_ms": mcmc_plain_ms,
        "plain_steps": [MCMC_CHECK["n_burnin"], MCMC_CHECK["n_steps"]],
        "bound_ms": mcmc_bound[0],
        "bound_by": "operations",
        "bound_pipe": mcmc_bound[1],
        "issue_ms": mcmc_bound[2],
        "latency_ms": mcmc_latency,
        "library_ms": None,
        "layout": list(mcmc_program.layout_for(main_cfg)),
        "walk_ms": mcmc_walk_ms,
        "custom": {"config5": custom_mcmc["config5"]},
        "families": {"c5b_family": family_mcmc["c5b_family"]},
        "outputs": outputs["mcmc"],
        "hmc": hmc,
        "state": state["c5b"],
        "batch": serving["mcmc"],
        "wide": mcmc_wide["c5b"],
        "xla_tables": {**{k: xla_mcmc[k] for k in ("c5b_t5", "spiky_walk")},
                       **xla_routes},
    }, {
        "name": "integrate_nd",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/integrate_nd.cu",
        "replaces": "tpu_montecarlo/ops/integrate_nd_pallas.py:373",
        "launches": nd_launches,
        "qmc_launches": qmc_launches,
        "max_abs_err": nd_err,
        "ms": nd_ms,
        "plain_ms": nd_plain_ms,
        "bound_ms": nd_bound[0],
        "bound_by": "operations",
        "bound_pipe": nd_bound[1],
        "issue_ms": nd_bound[2],
        "parent_bound_ms": nd_parent[0],
        "parent_bound_pipe": nd_parent[1],
        "parent_issue_ms": nd_parent[2],
        "library_ms": None,
        "qmc_rotation_ms": rot_ms,
        "families": {"c9_family": {
            "launches": fam_nd_launches, "max_abs_err": fam_nd_err,
            "samples": n_fam, "ms": fam_nd_ms, "plain_ms": fam_nd_plain_ms,
            "call_ms": fam_nd_call_ms, "bound_ms": fam_nd_bound[0],
            "bound_pipe": fam_nd_bound[1], "issue_ms": fam_nd_bound[2]}},
        "custom": {
            "launches": c9b_launches, "max_abs_err": nd_new_err,
            **{k: nd_custom["c9b"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "call_ms")},
            **nd_custom},
        "is": {
            "launches": rare_launches, "max_abs_err": nd_new_err,
            **{k: nd_is["rare"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "call_ms")},
            **nd_is},
        "batch": serving["integrate_nd"],
        "grad": nd_grad_rec,
    }, {
        "name": "mcmc_nd",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/mcmc_nd.cu",
        "replaces": "tpu_montecarlo/ops/mcmc_nd_pallas.py:338",
        "launches": nd_mcmc_launches,
        "pilot_launches": nd_pilot_launches,
        "max_abs_err": nd_mcmc_err,
        "ms": nd_mcmc_ms,
        "plain_ms": nd_mcmc_plain_ms,
        "plain_steps": [MCMC_CHECK["n_burnin"], MCMC_CHECK["n_steps"]],
        "bound_ms": nd_mcmc_bound[0],
        "bound_by": "operations",
        "bound_pipe": nd_mcmc_bound[1],
        "issue_ms": nd_mcmc_bound[2],
        "latency_ms": nd_mcmc_latency,
        "library_ms": None,
        "layout": nd_mcmc_layout,
        "walk_ms": c10b_ms,
        "custom": {"c9f": custom_mcmc["c9f"]},
        "families": {"c9e_family": family_mcmc["c9e_family"]},
        "outputs": outputs["mcmc_nd"],
        "state": state["c9e"],
        "hmc": {"c11b": hmc_nd["c11b"]},
        "batch": serving["mcmc_nd"],
        "wide": mcmc_wide["c9e"],
        "xla_tables": {"c9f_t5": xla_mcmc["c9f_t5"]},
    }, {
        "name": "mcmc_pt",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/mcmc_pt.cu",
        "replaces": "tpu_montecarlo/ops/mcmc_pt_pallas.py:332",
        "launches": pt_launches,
        "pilot_launches": pt_pilot_launches,
        "max_abs_err": pt_err,
        "ms": pt_ms,
        "plain_ms": pt_plain_ms,
        "plain_steps": [MCMC_CHECK["n_burnin"], MCMC_CHECK["n_steps"]],
        "bound_ms": pt_bound[0],
        "bound_by": "operations",
        "bound_pipe": pt_bound[1],
        "issue_ms": pt_bound[2],
        "latency_ms": pt_latency,
        "library_ms": None,
        "swap_rate": pt_swap,
        "layout": list(prog.layout),
        "ladder_ms": pt_times["c12", "ladder"],
        "c12c_ms": pt_times["c12c", "default"],
        "c12c_ladder_ms": pt_times["c12c", "ladder"],
        "custom": {"c12d": custom_mcmc["c12d"]},
        "families": {"c12_family": family_mcmc["c12_family"],
                     "parity": parity},
        "outputs": outputs["mcmc_pt"],
        "hmc": {"c12b": hmc_nd["c12b"]},
        "batch": serving["mcmc_pt"],
        "wide": mcmc_wide["c12"],
        "xla_tables": {k: xla_mcmc[k] for k in ("c12d_t5", "c12d_gapped")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
