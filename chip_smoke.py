#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. versions: torch, CUDA, and the card's name and power limit (nvidia-smi);
2. build the port's nineteen CUDA kernel sources (K1 and K7 with an
   instantiation each for the augmented LCLD domain, K7 two more for
   AutoPGD, K8 one for the augmented botnet domain, K1 and K8 their history
   instantiations for each domain, K6's two kernels in one source, K9 for
   domains compiled from a spec, K10 with its two instantiations, PGD and
   AutoPGD, for spec domains)
   from the sources in the checkout and
   print each kernel's ptxas registers, shared memory, stack frame and
   spill (none of the redesigned ones, ``REDESIGNED``, may spill);
3. hold each kernel against its plain PyTorch version on the card over a
   sweep of state counts and two shapes, bit for bit: K5 ``offspring``, K1
   ``objective_lcld``, K4a ``survive_norm``, K4b ``survive_fill`` (fill,
   extraction, archive), K2 ``nd_peel`` and K3 ``associate``. The inputs
   include NaN, +inf and duplicate objective rows, tied gumbels, zero-range
   genes, NaN archive scores and candidates whose constraint denominators
   are 0. K1 is held on the offspring (100 rows) and on the population
   (P rows, as at init), the main path's two shapes. Each kernel is timed
   at the main path's shape with CUDA events, around the replay of a CUDA
   graph of 20 launches (``ms``, the kernel's device time) and around 20
   calls of its Python wrapper (``wrapper_ms``), beside its plain version
   and its bound (bytes and operations this run's data needs). K1, K4b,
   K4a and K5 are also held on their launch shapes' edges: partial tiles
   and blocks, tiles spanning states, a stack too large for shared memory
   (K1 reads it from global memory), M = R = 1024 (K4b runs one state per
   block), M = 1024 and degenerate states for K4a (an all-NaN column,
   equal rows, previous extremes that win), and for K5 a full and an empty
   mutation queue, zero-range genes, odd N and more genes than one chunk of
   its queue; K2 on ``K2_EDGES`` (word edges, even word counts, M = 303
   and 1024, all-NaN states, equal rows, chains, ties of signed zeros,
   infinities and denormals; n_stop 0 to M + 5) and K3 on ``K3_EDGES``
   (R from 1 to 4096, M from 1 to 1024; exact ties of duplicated
   directions, inf objectives, all-NaN states, 1e-12 denominators, signed
   zeros and denormals, a zero direction). The fronts K2 peels per state
   are logged; K1's record adds its no-FMA ceiling, K2's and K3's their
   time at ``config/moeva.yaml``'s shape;
4. drive the main path, ``Moeva2.generate`` on 1000 synthetic LCLD states
   at population 103 with 100 offspring, with every launch count set to 0
   just before and read just after (each must equal what the code implies);
   check the result's shape, finiteness and that only mutable features
   moved; hold the engine's stages on the card against the CPU path, stage
   by stage on the same inputs;
5. judge the result with ``ObjectiveCalculator.success_rate_3d`` (o1..o7);
6. profile a few generation steps: ms per generation, device-busy share,
   launches, kernels and stages by device time; fails unless the trace
   holds as many kernel launches as an untraced generation made; then the
   fronts K2 peels per state on one more generation;
7. constrained PGD on LCLD (the ``[pgd]`` lines): hold K7 ``pgd_lcld``
   against ``pgd_run_plain`` on the card, bit for bit (x_adv, the class at
   x_adv, the history), over ``PGD_ROWS`` x ``PGD_ITERS`` and
   ``PGD_CONFIGS`` (every loss strategy, the three ``constraints_optim``,
   targeted, norms 2 and inf, every history layout), with edge rows at the
   start (0 denominators, so NaN gradients; terms exactly at the tolerance;
   ±0 inside an abs; features at the clip bounds), at row counts on the
   edges of K7's layout (rows per block, its register tiles, the SMs); time
   K7 at 4000 states x 1000 iterations (and the other rq1 losses at 100)
   beside the plain version at 100 iterations, its bound, its no-FMA
   ceiling and its latency floor; drive ``ConstrainedPGD.
   generate`` as ``experiments/pgd.py`` does (labels from the surrogate,
   ε - 1e-6, inverse scaling, directional rounding, o1..o7) with its launch
   count set to 0 just before and read just after; check the ε-ball,
   immutables and finiteness, that two runs are equal, and the card against
   the CPU at 256 states x 100 iterations; and K7 against ``pgd_run_plain``
   on a copy of the schema that marks term immutable, with rows whose
   repair rewrites it (``check_immutable_repair``, ROADMAP C6);
8. MoEvA2 on the botnet domain (the ``[botnet]`` lines): K8's ptxas line;
   K8 ``objective_botnet`` against ``evaluate_plain`` on the card, bit for
   bit, over ``BOTNET_SWEEP_STATES`` x ``BOTNET_SWEEP_ROWS``, the tile edges
   under both norms and other stacks and heads, with the terms' edge cases in
   the candidates (0, -0.0 and NaN packets, infinite and inf - inf flow
   sums, a ratio of exactly 1500, an ordering at -inf); K5, K2, K4a, K3 and
   K4b at L = 756 and (M, R) = (303, 203); K8 timed at 387 states x 100
   offspring beside its plain version, its bound, its no-FMA ceiling and
   ``torch.matmul`` of its first layer alone, and at the shapes the path
   launches it at (256 and 131 states x 100); K5 and K4b timed at those two
   state counts, L = 756 and (M, R) = (303, 203), beside their bounds; each
   timed at the path's shapes also held bit for bit on the inputs it is
   timed on;
   ``Moeva2.generate`` as
   ``config/rq1.botnet.yaml`` runs it (387 states, 1000 generations, pop
   200, 100 offspring, archive 24, L2, seed 42, chunks of 256) cold and
   steady, with its launch counts set to 0 just before and read just after;
   shape, finiteness, immutables and two equal runs; the stages on the card
   against the CPU at 4 states; o1..o7 at f1 0.5 and f2 4; and the profile of
   phase 6 at 387 states;
9. constrained PGD on the botnet domain (the ``[pgd-botnet]`` lines): K7b's
   base instantiation's ptxas line; K7b ``pgd_botnet`` against ``pgd_run_plain`` on the card, bit
   for bit (x_adv, the class at x_adv, the history), over
   ``PGD_BOTNET_ROWS`` (partial last clusters among them) x ``PGD_ITERS`` and
   phase 7's ``PGD_CONFIGS``, with the terms' edge cases in the starts
   (``problems.botnet_edge_starts``); K7b timed at 387 states x 1000
   iterations (and the other rq1 losses at 100) beside the plain version at
   10 iterations, its bound, its latency floor and ``torch.matmul`` of its
   first layer alone, with its launch's shape as the launcher plans it; ``ConstrainedPGD.generate`` as ``experiments/pgd.py``
   drives it at rq1.botnet's ε 4 and rq0.botnet's ε 1 (cold and steady,
   launch counts set to 0 just before and read just after: one launch of
   K7b each), the ε-ball, immutables, finiteness, two equal runs and
   o1..o7; the card against the CPU at 32 states x 20 iterations;
10. the runners (the ``[runner]`` lines): rq1's grid points through
   ``experiments.moeva.run`` and ``experiments.pgd.run`` on the card, from
   configs composed as ``experiments/rq.py`` composes ``config/moeva.yaml``
   or ``config/pgd.yaml`` with ``config/rq1.{lcld,botnet}.static.yaml``
   (``runner_config``; dict literals, held equal to the files by
   ``tests/test_torch_runner_configs.py``), over artifacts written to a
   temporary directory (synthetic schemas, ``synth_lcld(4000, seed=42)`` and
   ``synth_botnet(387, seed=42)``, the seeded surrogates by ``save_params``,
   the scalers by ``save_npz``): MoEvA on LCLD (4000 states, pop 200,
   budget 100, chunks of 256) and on botnet (387 x 1000), and the five rq1
   PGD losses on each (4000 and 387 states x 1000; LCLD's ``flip+sat`` on
   256 states, ``RUNNER_CUTS``). Each run has its launch counts set to 0
   just before and read just after (MoEvA's as its chunks imply, one K7 or
   K7b launch per PGD run), its files under the JAX names, its metrics
   equal to the objectives recomputed from the saved ``x_attacks``,
   ``includes_compile`` false and a second run that skips and writes
   nothing; ``flip+sat``'s repaired rows are each feasible or their initial
   state (``check_repairs``), with the SAT seconds per state. One refusal is
   accepted, LCLD's ``constraints+flip`` (``NAN_REFUSALS``): the judgement
   refuses its result, as the JAX runner's does, only if exactly the listed
   rows are NaN, each after x22 reached its pole at 0;
11. the augmented LCLD domain (the ``[augmented]`` lines; ``lcld_augmented``,
   57 features, 10 + 10 terms, from ``problems.
   synthetic_lcld_augmented_problem``): the ptxas lines of K1's and K7's
   augmented instantiations; K1 at D = 57 against ``evaluate_plain`` on the
   card, bit for bit, over phase 3's sweep and K1's launch edges under both
   norms, with the pair terms' edge rows (``problems.
   lcld_augmented_edge_rows``) among the candidates; K5, K1, K2, K4a, K3 and
   K4b at the domain's gene length on the path's inputs (the initial round
   and ``AUG_STAGE_GENS`` steps at 1000 and 256 states); K7 at D = 57
   against ``pgd_run_plain`` over phase 7's sweep with the edge rows among
   the starts; K1 timed at (1000, 100) and the runner's chunk (256, 100), K7
   at 4000 x 1000 (rq2's loss) and 100 iterations for the other losses,
   each beside its plain version and its bound; then rq2.lcld's four grid
   points (MoEvA and PGD, budgets 100 and 1000, 4000 states) through the
   runners from configs composed as ``experiments/rq.py`` composes
   ``config/rq2.lcld.yaml`` (``rq2_config``; held equal to the files by
   ``tests/test_torch_runner_configs.py``), with phase 10's checks, and
   MoEvA at budget 100 again with ``reconstruction: true``; K7 at D = 57 on
   phase 7's immutable-repair rows too;
12. the augmented botnet domain (the ``[botnet-augmented]`` lines;
   ``botnet_augmented``, 927 features, 360 + 171 terms, from ``problems.
   synthetic_botnet_augmented_problem``): the ptxas lines of K8's base and
   augmented instantiations; K8 at D = 927 against ``evaluate_plain`` on the
   card, bit for bit, over phase 8's sweep, tile edges under both norms and
   other stacks and heads, with the pair terms' edge rows (``problems.
   botnet_augmented_edge_rows``) among the candidates beside the base
   terms'; K5, K8, K2, K4a, K3 and K4b at L = 927 on rq2.botnet's engine
   (the initial round and ``AUG_STAGE_GENS`` steps at the runner's chunks
   of 256 and 131 states); K8 timed at 387 x 100 beside its plain version,
   bound, no-FMA ceiling and ``torch.matmul`` of its first layer, and at the
   chunks; K5 and K4b timed at L = 927 beside their bounds; rq2.botnet's
   grid point (MoEvA, budget 1000, ε 4, 387 states) through the runner from
   a config composed as ``experiments/rq.py`` composes
   ``config/rq2.botnet.yaml`` (``rq2_botnet_config``; held equal to the
   files by ``tests/test_torch_runner_configs.py``), with phase 10's
   checks; then constrained PGD on the domain: the ptxas line of K7b's
   927-feature instantiation; it against ``pgd_run_plain`` on the card,
   bit for bit (x_adv, class, the history with its 531 term columns), over
   ``BOTNET_AUG_PGD_CONFIGS`` x ``BOTNET_AUG_PGD_ROWS`` x
   ``BOTNET_AUG_PGD_ITERS`` (both norms, targeted, the single constraint on
   a pair term) from the base and pair terms' edge starts
   (``botnet_augmented_edge_starts``); timed at 387 x 1000
   (``BOTNET_AUG_PGD_LOSS``, L2, ε 4) in turns with base K7b at 756 on the
   same loss, beside its plain version at 10 iterations, bound, latency
   floor and launch shape; ``generate`` cold and steady (one
   ``pgd_botnet_aug`` launch); the card against the CPU at 32 x 20 and 2
   restarts; rq2.botnet's point under PGD through the runner at budget
   1000, with phase 10's checks; and a ``+repair`` loss refused with JAX's
   error before any launch;
13. the grid runner (the ``[grid]`` lines): the ten rq and sm1 grid files
   of ``config/`` (``GRID_FILES``) through ``experiments.rq.run`` on the
   card, from a ``config_dir`` written from ``config/``'s files
   (``write_grid_config_dir``: the artifact paths, results directories and
   ``config_dir`` replaced; held equal to the files by
   ``tests/test_torch_runner_configs.py``) over phases 10-12's synthetic
   artifacts and rq3's seeded surrogates; one cut, ``GRID_CUTS``:
   ``flip+sat`` out of rq1.lcld, sm1.2.lcld and sm1.2.botnet. Each grid
   with its launch counts set to 0 just before and read just after (as its
   points imply), every point's files, its metrics equal to their
   recomputation from its saved ``x_attacks``, the grid report's counts,
   and the judgement's refusals only at the points of
   ``GRID_NAN_REFUSALS`` (ROADMAP C5: exactly the pinned rows NaN, each
   first non-finite in the pinned ratio terms, a denominator at 0, the
   attack run again alone); any other failed point fails the smoke. Then rq2.lcld again (every point skipped), a
   MoEvA point served by a cached engine and a PGD point at a grid's second
   ε against the standalone runner on a fresh engine (bit for bit),
   rq2.botnet with ``use_subprocess=True`` and rq2.lcld with ``pipeline:
   false`` against the pipelined run (bit for bit), with the walls of the
   pipelined and serial rq2.lcld;
14. AutoPGD on LCLD and augmented LCLD (the ``[autopgd]`` lines): the ptxas
   lines of K7's four instantiations (kPairs, kAuto); K7's AutoPGD
   instantiation against ``autopgd_run_plain`` on the card, bit for bit
   (x_best, the class there, the history, each row's final step), over
   ``AUTOPGD_ROWS`` x ``AUTOPGD_ITERS`` x ``AUTOPGD_CONFIGS`` (phase 7's under
   the ``autopgd+`` prefix) with phase 7's edge starts (at D = 57 the pair
   terms' too), the step halved on some rows and kept on others at T >= 12;
   timed at 4000 x 1000 (rq1's ``constraints+flip`` and, at D = 57, rq2's
   loss under the prefix) beside base K7 at the same loss, the plain
   version at 100 iterations and the bound (``autopgd_bound``);
   ``AutoPGD.generate`` as the runner drives it (one random start) cold and
   steady at each D, its launch counts set to 0 just before and read just
   after (one launch each); the card against the CPU at 256 x 100 and 2
   restarts; rq1.lcld's PGD points under the prefix (4000 x 1000;
   ``autopgd+flip+sat`` on 256 states, ``RUNNER_CUTS``' cut of ``flip+sat``) and rq2.lcld's at
   budget 1000 through the runner, with phase 10's checks. Then botnet (the
   ``[autopgd-botnet]`` lines): the
   ptxas lines of K7b's two instantiations (kAuto); its AutoPGD
   instantiation against ``autopgd_run_plain`` bit for bit over
   ``AUTOPGD_BOTNET_ROWS`` x ``AUTOPGD_BOTNET_ITERS`` x ``AUTOPGD_CONFIGS`` with
   phase 9's edge starts, halved and kept rows at T >= 12; timed at 387 x
   1000 (rq1.botnet's ``constraints+flip`` under the prefix, ε 4) beside
   base K7b at the same loss, the plain version at 10 iterations, the bound
   (``autopgd_botnet_bound``), the latency floor and the launch's shape (one
   wave); ``generate`` cold and steady (one launch); the card against the
   CPU at 32 x 20 and 2 restarts; rq1.botnet's five PGD points under the
   prefix through the runner (387 x 1000; ``autopgd+flip+sat`` on
   ``AUTOPGD_BOTNET_SAT_STATES``). Then the augmented botnet domain (the
   ``[autopgd-botnet-augmented]`` lines): the ptxas line of K7b's
   927-feature AutoPGD instantiation; it against ``autopgd_run_plain`` bit
   for bit over ``AUTOPGD_BOTNET_AUG_CONFIGS`` x ``AUTOPGD_BOTNET_AUG_ROWS``
   x ``AUTOPGD_BOTNET_AUG_ITERS`` from phase 12's edge starts, halved and
   kept rows at T = 12; timed at 387 x 1000 in turns with K7b's AutoPGD
   instantiation at 756; ``generate`` (one launch), the card against the
   CPU at 32 x 20 and 2 restarts, rq2.botnet's point under the ``autopgd+``
   prefix through the runner, a ``+repair`` loss refused. No grid file of
   ``config/`` selects AutoPGD, nor PGD on the augmented botnet domain:
   phase 13 launches none of their counters (``AUTOPGD_COUNTERS``,
   ``pgd_botnet_aug``), which phases 12 and 14 must launch.
15. the early exit (the ``[early-exit]`` lines): K6's ptxas lines; K6a
   ``gate_stats`` against ``engine_quality_stats`` bit for bit over
   ``GATE_STATES`` x ``GATE_COLUMNS`` (NaN and ±inf objectives, an all-NaN
   state, f1 at the threshold, f2 at eps, no archive); K6b ``take_carry``
   and ``final_columns`` against ``index_select`` bit for bit at
   ``TAKE_GENES`` x ``TAKE_ARCHIVES`` with duplicate, identity and
   reversed index vectors; each timed at ``K6_TIMED`` beside its plain
   version and its bound (bytes), K6b with ``index_select``'s summed time;
   the main path's engine with ``EE_KNOBS`` (a gate every 10 generations,
   archive 24), its launch counts set to 0 just before and read just after
   and held to what its record implies (``expected_launches``), the
   buckets shrinking down the menu, fewer steps than the budget; the same
   run with ``double_buffer`` off, a gate that never fires and
   ``quality_every`` 10 against strict mode, all bit for bit; the run
   interrupted after its first checkpoint and resumed, bit for bit; the
   card against the CPU at ``EE_CPU_RUN`` fed the CPU's draws; botnet's
   early exit at 387 states in chunks of 256 (``EE_BOTNET_KNOBS``); and
   rq1.lcld's MoEvA point through the runner with ``early_stop_check_every``
   10 (and ``early_stop_threshold`` 0.5) beside the strict point, o1..o7 of
   both. No grid file sets an early exit: phase 13 launches no
   ``EARLY_EXIT_COUNTERS``, which phase 15 must launch.
16. the history of every evaluation (the ``[history]`` lines,
   ``save_history``, ROADMAP A7b): the ptxas lines of K1's and K8's history
   instantiations beside their bases'; each (``HISTORY_COUNTERS``) against
   ``evaluate_hist_plain`` on the card, bit for bit, at ``HISTORY_SHAPES``
   with the domain's edge rows (the ratio poles: infinite terms, NaN
   objectives), its ``out`` against the base kernel's, column 2 against the
   kept terms' left-to-right sum, and a 3-column record as the base
   kernel's output; each timed beside its base in turns, with its bound
   (the base's bytes and the record's); ``config/moeva.yaml`` with
   ``config/lcld.yaml`` through the runner (``history_config``: 4000
   states, budget 100, ``history_chunk`` 25) with "full", "reduced" and no
   history, each with phase 10's checks, the ``x_history`` files' shapes and
   the reduced one equal to the full one's objectives, and the wall of
   each; the engine with "full" on augmented LCLD, on botnet (387 states,
   26 generations in segments of 10) and on augmented botnet, each with its
   launch counts set to 0 just before and read just after, the records'
   layout, no NaN term and column 2 the terms' sum. No grid file sets
   ``save_history``: phase 13 launches no ``HISTORY_COUNTERS``, which phase
   16 must launch.
17. domains compiled from a constraint spec (the ``[spec]`` lines, ROADMAP
   A11; kernel K9 ``objective_spec``): the ptxas lines of K9's six
   instantiations (tiles of 128, 64 and 32 rows, with and without the
   history; none may spill); K9 and its ``kHistory`` instantiation against
   ``evaluate_plain`` and ``evaluate_hist_plain`` on the card, bit for bit,
   on ``lcld_spec``, ``botnet_spec``, phishing and two seeded families
   (``SPEC_FAMILIES``) over ``SPEC_SWEEP`` (partial tiles, tiles spanning
   states) under L2 and L-inf, the candidates led by the spec operators'
   edge rows (``problems.spec_candidates``: 0, -0.0, NaN and ±inf
   denominators of ``/``, ``safe_div`` and ``finite_div``, membership
   values met, ±0 everywhere, features at their bounds); K9 on
   ``lcld_spec`` against K1 on LCLD and on ``botnet_spec`` against K8 on
   botnet, bit for bit, out and history record, on the same inputs; K9 timed
   at ``SPEC_TIMED`` (CUDA graph of 20) beside K1 and K8 in turns, through
   its wrapper, its plain version and its bound, and K9h beside K9;
   rq1.lcld's MoEvA point through ``experiments.moeva.run`` with a
   ``spec:`` key (4000 states, budget 100) with phase 10's checks, its
   ``x_attacks`` equal to the same point on ``lcld``; ``Moeva2.generate``
   on ``botnet_spec`` (387 states, budget cut to 100) and on ``lcld_spec``
   with ``save_history`` "full" and "reduced", each equal to its
   hand-written twin's run bit for bit, launch counts set to 0 just before
   and read just after; and phishing's o1..o7 on the card at the oracle
   fixture's config within its tolerance of ``oracle_ga``. No grid file
   names a spec domain: phase 13 launches no ``SPEC_COUNTERS``, which
   phase 17 must launch.
18. PGD, AutoPGD and ``flip+sat`` on spec domains (the ``[spec-pgd]`` lines,
   ROADMAP A11b; kernel K10 ``pgd_spec``): the ptxas lines of K10's two
   instantiations; K10 and its AutoPGD instantiation against
   ``pgd_run_plain`` and ``autopgd_run_plain`` on the card, bit for bit
   (x_adv, the class there, the history, AutoPGD's steps), on
   ``lcld_spec``, ``botnet_spec``, phishing and ``family2`` over
   ``SPEC_PGD_ROWS`` (K10's block edges) with phase 7's ``PGD_CONFIGS`` and
   phase 14's ``AUTOPGD_CONFIGS``, the starts led by the spec operators'
   edge rows (``spec_edge_rows``); K10 and K10-auto timed at rq1's shapes
   (``SPEC_PGD_TIMED``: 4000 x 1000 on ``lcld_spec``, 387 x 1000 on
   ``botnet_spec``) beside K7 and K7b (and their AutoPGD instantiations) on
   the same inputs in turns, through the wrapper, the plain version at 100
   and 10 iterations (equal to K10 there) and the twins' bounds;
   ``ConstrainedPGD.generate`` and ``AutoPGD.generate`` on both domains, launch
   counts set to 0 just before and read just after, PGD on ``lcld_spec``
   reaching LCLD's month pole (C5) on exactly K7's ``NAN_REFUSALS`` rows;
   rq1.lcld's ``SPEC_RUNNER_LOSS`` point through ``experiments.pgd.run``
   with a ``spec:`` key, and ``flip+sat`` through it on ``lcld_spec``, on
   ``lcld`` (the same ``SPEC_SAT_STATES`` states: as many rows feasible only
   under C3) and on phishing, with phase 10's checks. No grid file names a
   spec domain: phase 13 launches no ``SPEC_PGD_COUNTERS``, which phase 18
   must launch.
19. training and the defense pipelines (the ``[defense]`` lines, ROADMAP
   A12b; kernels K11 ``train_step``, its loss-only instantiation
   ``train_loss``, and K12 ``input_grad``): their ptxas lines; K11 against
   ``train_step_plain`` on the card, bit for bit (loss, parameters, both
   moments), over ``TRAIN_CHECK_STEPS`` steps at each of ``TRAIN_SHAPES``
   (512 x 47 and 57, 256 x 756 and 927; weight-0 padded tails, class
   weights), the loss-only instantiation at ``VAL_ROWS`` and K12 at
   ``INPUT_GRAD_SHAPES`` (10,000 x 47, 600 x 756); each timed (a CUDA graph
   of 20 launches), through its wrapper, its plain version, K11 beside eager
   autograd + ``torch.optim.Adam`` (a note), and its bound;
   ``config/defense.lcld.yaml`` and ``config/defense.botnet.yaml`` through
   ``experiments.defense.run`` and RQ4 on LCLD's artifacts through
   ``experiments.rq4.run``, over synthetic splits (``DEFENSE_ROWS``; budget
   cut to ``DEFENSE_BUDGET``), each with its launch counts set to 0 just
   before and read just after (K11, K12 and the attacks' kernels), every
   artifact of the family written, each model's epochs, wall and AUROC,
   each stage's wall; and ``fit_mlp`` on the card against the CPU's
   float32 path from the same initial parameters. No grid file trains:
   phase 13 launches no ``DEFENSE_COUNTERS``, which phase 19 must launch.
20. the draws and a chunk's prepare and decode (the ``[draws]`` lines,
   ROADMAP B3; kernel K0 ``draws`` with its PGD instantiation
   ``pgd_start``, K13a ``chunk_prepare`` and K13b ``chunk_decode``): their
   ptxas lines; K0 against ``core.philox.draw_plain`` on the card, bit for
   bit, at the main path's generation (1000 states), botnet's chunks (256
   and 131 x 756), 1, 31 and 33 states with 99 offspring, lp_ratio's
   initial rounds under both norms and every field kind at
   ``DRAW_EDGE_COUNTS`` elements from a block past 2**32; ``pgd_start``
   against ``pgd_start_plain`` at ``PGD_START_SHAPES`` under both norms;
   K0 on the card against the CPU twin (integer and uniform fields equal;
   the differing gumbel and normal elements counted and printed); K13a and
   K13b against their plain versions on LCLD and botnet chunks (tile and
   lp_ratio, a repack's prepare, the decode with and without the archive);
   each timed (a CUDA graph of 20 launches), through its wrapper, its plain
   version on the card and its bound, K0 beside the parent's 17 eager
   launches of a generation's draws (``parent_generation_draws``, the
   library figure); ``ConstrainedPGD.generate`` with 2 random starts, its
   launch counts set to 0 just before and read just after; phase 6's
   launches and busy share per LCLD generation and phase 4's walls. K0 and
   K13 count their launches on phase 4's main path, ``pgd_start`` on this
   phase's PGD run.
21. the last device stages of the ported paths (the ``[refdirs]``,
   ``[restart]``, ``[forward]`` and ``[two-pointers]`` lines, ROADMAP B11-B14;
   kernels K14 ``refdirs``, K15 ``restart`` and K16 ``forward_labels`` and
   ``forward_proba1``): their ptxas lines; K14 against
   ``energy_descent_plain`` on the card bit for bit and timed (one CTA) at
   each of ``REFDIRS_POINTS`` (100, 200, 300) x 3000 steps, against the
   twin on the host at 200 points, with the entries in which the
   card's float64 exp and pow differ from the host's on the same inputs;
   the main path's aspiration points equal to K14's, an engine built on a
   fresh cache with the host descent made to raise (one K14 launch, none
   for a second engine of the shape) and its ``generate``; K15 against
   ``restart_plain`` over 3 starts at 4000 x 47 (a history, targeted),
   timed at the AutoPGD runner's shape, and rq1.lcld's ``autopgd+flip``
   point through ``experiments.pgd.run`` (one K15 and one K16 label
   launch); K16's two instantiations against their plain versions on
   LCLD's and botnet's stacks, timed beside the model's own ``nn.Linear``
   forward and softmax (the library figure, device time from a CUDA graph
   as the kernel's, and launched eagerly), and ``experiments.defense.
   proba1`` on the card; K2, K4a and K3 reading [population, offspring]
   through two pointers against themselves on the concatenation and their
   plain versions at the main path's generation, timed both ways in turns;
   and one LCLD generation's launches: ``GENERATION_LAUNCHES`` (7), no
   eager op. Every launch count above is set to 0 just before its path and
   read just after.

The last three lines are the per-kernel JSON record (with each kernel's
launches over phase 13's grids, ``grid_launches``), the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Nothing is printed as a
result when CUDA is missing or the port's package is not beside this script.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

#: generations of the main-path attack (the headline bench runs 1000)
N_GEN = 100
N_STATES = 1000
#: state counts of the kernel sweep: those at which the removed TPU
#: association kernel faulted (537-544) or ran clean
SWEEP_STATES = (64, 387, 512, 520, 537, 538, 540, 544, 1000)
#: (M candidates, R directions, n_stop): the main path's shape and the
#: shape the TPU fault was bisected at
SWEEP_SHAPES = ((203, 103, 103), (303, 203, 203))
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 and fp64
#: ops/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F64_OPS_S = 34e12
#: engine stages on the same inputs: the card's float32 error against the
#: float64 CPU path may be at most this many times the CPU's float32 error
STEP_ERR_RATIO = 4.0
#: generations traced by the profile phase, after 3 untraced ones
PROFILE_GENS = 10
#: seconds the card idles after a trace's kept window opens and before it
#: closes, and the traces taken at most before a lost event fails the phase
PROFILE_SETTLE_S = 0.05
PROFILE_ATTEMPTS = 3


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


#: kernels whose ptxas report must show no spill
REDESIGNED = ("objective_lcld_kernel", "survive_fill_kernel", "survive_norm_kernel", "offspring_kernel",
              "nd_peel_kernel", "associate_kernel", "pgd_lcld_kernel", "pgd_botnet_kernel", "gate_stats_kernel",
              "take_kernel", "refdirs_kernel", "forward_kernel")


def ptxas_resources(build_log: str) -> list:
    """Per kernel entry of ``nvcc -Xptxas=-v``'s report in ``build_log``:
    source, kernel (with its template arguments), registers, static shared
    bytes, stack frame and spill bytes."""
    import re

    out, source, entry, props = [], "", None, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            mangled = m.group(1)
            # the mangled name's length-prefixed identifiers; the kernel's
            # ends in _kernel, its template arguments follow as L<type><n>E
            name, i = mangled, 0
            while d := re.compile(r"\d+").search(mangled, i):
                ident = mangled[d.end():d.end() + int(d.group())]
                if ident.endswith("_kernel"):
                    name = ident
                    break
                i = d.end() + int(d.group())
            args = re.findall(r"L[ib](\d+)E", mangled)
            entry = {"source": source, "kernel": name + (f"<{','.join(args)}>" if args else ""),
                     "mangled": mangled, "registers": 0,
                     "smem": 0, "stack": 0, "spill_stores": 0, "spill_loads": 0}
            out.append(entry)
        elif m := re.search(r"Function properties for (\w+)", line):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
            if entry is not None and props == entry["mangled"]:
                entry["stack"], entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and entry is not None:
            entry["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                entry["smem"] = int(sm.group(1))
    return out


def cuda_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``launches`` calls,
    measured with CUDA events after one warm-up call. For a kernel this
    includes its Python wrapper: where the wrapper takes longer than the
    kernel, it times the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time per call of ``fn``'s
    kernel launches: CUDA events around the replay of a CUDA graph that
    captured ``launches`` calls. The wrapper's Python runs at capture only,
    so the replay times the kernels and not the host."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


# -- kernel inputs --------------------------------------------------------------


def sweep_objectives(rng, s: int, m: int) -> np.ndarray:
    """(S, M, 3) float32 objectives shaped like the engine's: a misclassification
    probability, a small distance and a violation sum, with per-state mixes of
    continuous values, coarse discrete values (ties), duplicated rows, a few
    NaN rows and a few rows whose violation sum is +inf (a ratio constraint
    whose denominator a mutation set to 0)."""
    f = np.stack(
        [rng.uniform(0, 1, (s, m)), rng.uniform(0, 0.3, (s, m)), rng.exponential(1.0, (s, m))],
        axis=-1,
    )
    coarse = rng.random(s) < 0.3
    f[coarse] = np.round(f[coarse] * 4) / 4
    k = m // 5
    f[:, m - k :] = f[:, :k]  # duplicate rows
    nan_rows = rng.random((s, m)) < 0.01
    f[nan_rows, rng.integers(0, 3)] = np.nan
    f[rng.random((s, m)) < 0.01, 2] = np.inf
    return f.astype(np.float32)


def finite_ideal_nadir(f):
    """Ideal and nadir over the finite objectives, as survival keeps them
    (an inf objective under a finite nadir projects to NaN on the axes)."""
    import torch

    finite = torch.where(torch.isfinite(f), f, 0.0)
    return finite.amin(1), finite.amax(1)


def sweep_directions(rng, s: int, r: int) -> np.ndarray:
    """(S, R, 3) directions like ``_unit_ref_dirs``: simplex points + axes."""
    pts = rng.dirichlet(np.ones(3), (s, r - 3))
    return np.concatenate([pts, np.broadcast_to(np.eye(3), (s, 3, 3))], axis=1).astype(np.float32)


def nd_peel_ops(ranks: np.ndarray, m: int) -> int:
    """Operations the peel needs on these inputs: 6 comparisons per pair of
    candidates for the relation (one comparison of a pair gives both
    directions), then per front one AND of ceil(M/32) words for every
    candidate still remaining."""
    words = -(-m // 32)
    ops = 6 * ranks.shape[0] * (m * (m - 1) // 2)
    for row in ranks:
        ranked = np.sort(row[row != 2**31 - 1])
        for r in range(int(ranked.max()) + 1 if ranked.size else 0):
            ops += (m - int(np.searchsorted(ranked, r))) * words
    return ops


def peeled_fronts(ranks) -> tuple:
    """(mean, max) over the states of ``ranks`` (S, M) of the fronts peeled."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import UNRANKED

    n = torch.where(ranks == UNRANKED, -1, ranks).amax(1) + 1
    return float(n.double().mean()), int(n.max())


def bound_ms(n_bytes: float, n_ops: float, n_ops_f64: float):
    """The larger of the bytes' time and the operations' time: ``n_ops``
    float32 (and integer) operations at the fp32 peak plus ``n_ops_f64``
    float64 operations at the fp64 peak."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = (n_ops / PEAK_F32_OPS_S + n_ops_f64 / PEAK_F64_OPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ---------------------------------------------------------------------


def same_entries(got, want):
    """Entry-wise equality, NaN where NaN (-0.0 == 0.0)."""
    if not got.is_floating_point():
        return got == want
    return (got == want) | (got.isnan() & want.isnan())


def hold_equal(got, want, what: str) -> float:
    """Fail unless ``got`` equals ``want`` entry for entry; return the
    largest absolute difference (0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} != plain {want.dtype} {tuple(want.shape)}")
    bad = ~same_entries(got, want)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} entries differ from the plain version")
    return 0.0


def hard_candidates(codec, x):
    """Candidates ``x`` (S, N, L) with the rows the main path makes rarely:
    categorical genes at .5 (``rint`` ties) and 0 denominators of the LCLD
    ratio constraints (``annual_inc``, ``total_acc``, ``pub_rec``, a derived
    month count), which give inf and NaN terms."""
    import torch

    x = x.clone()
    x[:, ::7] = torch.where(codec.int_mask_gen, x[:, ::7] + 0.5, x[:, ::7])
    gene = {int(d): i for i, d in enumerate(codec.non_ohe_ml_idx)}
    for k, feat in enumerate(f for f in (6, 14, 11, 22, 0) if f in gene):
        x[:, 3 + k :: 11, gene[feat]] = 0.0
    return x


_STREAMS: dict = {}


def stream_of(gen):
    """The port's Philox stream (``core.philox``) that stands beside the
    test-input ``torch.Generator`` ``gen``: keyed by its seed, on its
    device, one stream per generator. The engine's draws come from it (K0
    on the card) while ``gen`` makes the sweeps' inputs."""
    from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream

    if id(gen) not in _STREAMS:
        _STREAMS[id(gen)] = (gen, PhiloxStream(gen.initial_seed(), gen.device))
    return _STREAMS[id(gen)][1]


def sweep_population(gen, run, codec, s: int, p: int):
    """(S, P, L) genes uniform within the states' bounds (integer genes
    rounded), with every fifth gene's range collapsed to its lower bound
    (zero-range genes, which mutation leaves alone). Returns the population
    and the bounds it was drawn in."""
    import torch

    xl, xu = run.xl_gen.clone(), run.xu_gen.clone()
    xu[:, ::5] = xl[:, ::5]
    u = torch.rand((s, p, xl.shape[1]), generator=gen, device=xl.device)
    pop = xl[:, None] + u * (xu - xl)[:, None]
    pop = torch.where(codec.int_mask_gen, torch.round(pop), pop)
    return torch.minimum(torch.maximum(pop, xl[:, None]), xu[:, None]), xl, xu


def fill_work(ranks, niche, n_dirs: int, n_survive: int):
    """(available rows, niches that start empty with members): the data-
    dependent counts of K4b's quadratic scans on these inputs."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import UNRANKED

    full = (ranks[:, None, :] <= ranks[:, :, None]).sum(-1) <= n_survive
    split = torch.where(full, UNRANKED, ranks).amin(-1)
    avail = ranks == split[:, None]
    onehot = torch.nn.functional.one_hot(niche, n_dirs)
    c0 = (onehot * full[..., None]).sum(1)
    cap = (onehot * avail[..., None]).sum(1)
    return int(avail.sum()), int(((c0 == 0) & (cap > 0)).sum())


def mutated_genes(tables, xl, xu, mut_select) -> int:
    """Output genes that mutate on these draws: ``mut_select`` under the
    gene's probability (rounded to float32) and a range above 0 on the
    bounds mutation works on."""
    import torch

    half = torch.tensor(0.5 - 1e-16, dtype=torch.float32, device=xl.device)
    ext = torch.where(tables.int_mask, half, torch.zeros_like(half))
    ok = (xu + ext) - (xl - ext) > 0
    return int(((mut_select < tables.mut_prob.float()) & ok[:, None]).sum())


def parent_rows(draws, p: int) -> int:
    """Distinct (state, parent) rows that the matings of ``draws`` read."""
    import torch

    pairs = draws.pairs.reshape(draws.pairs.shape[0], -1)
    return int(torch.zeros(pairs.shape[0], p, dtype=torch.bool, device=pairs.device).scatter_(1, pairs, True).sum())


def fill_rows_read(mask, arch_f, off_f, size: int):
    """(population, offspring, archive) rows whose genes K4b must read on
    these inputs: the survivors of ``mask`` and the archive's ``size`` picks
    among [archive, offspring], an offspring row counted once."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import archive_score

    a, n = arch_f.shape[1], off_f.shape[1]
    elite = torch.argsort(archive_score(torch.cat([arch_f, off_f], 1)), dim=1, stable=True)[:, :size]
    picked = torch.zeros(mask.shape[0], a + n, dtype=torch.bool, device=mask.device).scatter_(1, elite, True)
    p = mask.shape[1] - n
    return int(mask[:, :p].sum()), int((mask[:, p:] | picked[:, a:]).sum()), int(picked[:, :a].sum())


#: operations of K5 counted from its source: float32 (and integer) ones per
#: gene of a state's bounds (the widened bounds and range), per output gene
#: (crossover, rounding, clip) and per mutated gene (the polynomial mutation
#: besides its pows); the two float64 pows of a mutated gene count as one
#: operation each at the fp64 peak (so the bound stays a lower bound), and a
#: gene that does not mutate takes no pow
OFFSPRING_OPS_PER_BOUND = 4
OFFSPRING_OPS_PER_GENE = 8
OFFSPRING_OPS_PER_MUTATION = 18
OFFSPRING_POWS_PER_MUTATION = 2
#: operations of K4a per state, counted from its source: 12 per candidate
#: row (column min/max, front max, the masked row), 24 per ASF candidate
#: (shift, snap, 9 products, max, argmin step), 20 per direction, 135 for
#: the reductions and the 3x3 solve; the aspiration points' min/max (6 per
#: point) is the same for every state and counts once
NORM_OPS_PER_ROW = 12
NORM_OPS_PER_CANDIDATE = 24
NORM_OPS_PER_DIRECTION = 20
NORM_OPS_PER_STATE = 135
#: float32 operations per candidate of K1 besides the MLP's 2 per weight:
#: 7 per feature (decode, min-max, distance, scaler), 60 for the softmax and
#: the 10 LCLD terms
OBJECTIVE_OPS_PER_FEATURE = 7
OBJECTIVE_OPS_PER_ROW = 60


def offspring_work(tables, pop, xl, xu, n: int, draws):
    """K5's (bytes, float32 operations, float64 operations, mutated genes)
    on these inputs, counted from its source: it reads the parents' genes
    the matings use, the bounds, the draws and mut_u where a gene mutates,
    and writes the offspring."""
    s, p, l = pop.shape
    n_mat = (n + 1) // 2
    n_parents = parent_rows(draws, p)
    n_mutated = mutated_genes(tables, xl, xu, draws.mut_select)
    n_bytes = (4 * n_parents * l + 8 * s * l + 16 * s * n_mat + 48 * s * n_mat + 12 * s * n_mat + 4 * s * n * l
               + 4 * n_mutated + 25 * l + 4 * s * n * l)
    n_ops = (OFFSPRING_OPS_PER_BOUND * s * l + OFFSPRING_OPS_PER_GENE * s * n * l
             + OFFSPRING_OPS_PER_MUTATION * n_mutated)
    return n_bytes, n_ops, OFFSPRING_POWS_PER_MUTATION * n_mutated, n_mutated


def fill_work_bound(fill_args, extract, archive):
    """K4b's (bytes, operations) for the fill, extraction and archive on
    these inputs, counted from its source (``fill_work``, ``fill_rows_read``)."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import survive_fill_plain

    gum_cut, _, ranks, niche, _, n_stop = fill_args
    pop_x, _, _, off_f = extract
    _, arch_f, _, _, n_arch = archive
    s, m = ranks.shape
    r, p, l, n = gum_cut.shape[1], pop_x.shape[1], pop_x.shape[2], off_f.shape[1]
    n_avail, n_first = fill_work(ranks, niche, r, n_stop)
    n_cand = arch_f.shape[1] + n
    pop_rows, off_rows, arch_rows = fill_rows_read(survive_fill_plain(*fill_args), arch_f, off_f, n_arch)
    n_bytes = (21 * s * m + 4 * s * r + 4 * l * (pop_rows + off_rows + arch_rows)
               + 12 * (pop_rows + s * n + s * arch_f.shape[1]) + 4 * s * (p + n_arch) * (l + 3))
    n_ops = s * (4 * m + 40 * r) + 3 * m * n_avail + 2 * m * n_first + 6 * s * n_cand * n_cand
    return n_bytes, n_ops


def check_kernels(device, moeva, x):
    """Phase 3: parity sweep of the six kernels against their plain versions
    on the card, and their times at the main path's shape. ``moeva`` is the
    main path's engine (its gene tables and objective tables) and ``x`` its
    states. Returns the per-kernel records (launches filled in later)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
        archive_score, archive_select_plain, evaluate_plain, extract_archive_plain,
    )
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import (
        draw_offspring, make_offspring_plain,
    )
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import (
        NormState, associate_plain, survive_fill_plain, survive_norm_plain,
    )

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    codec, tables, obj, cons = moeva.codec, moeva.tables, moeva._objective, moeva.constraints
    n_gene = codec.gen_length
    inf_rows = 0
    counts = {"nonfinite objectives": 0, "NaN archive scores": 0, "zero-range genes": 0}
    timing = {}
    fronts = {}  # M: [sum of fronts, states, max]
    for m, r, n_stop in SWEEP_SHAPES:
        p, n_off, a = n_stop, m - n_stop, r - 3
        asp = torch.as_tensor(rng.dirichlet(np.ones(3), a).astype(np.float32), device=device)
        for s in SWEEP_STATES:
            run = moeva.prepare(x[:s], np.arange(s) % 2)
            # K5 offspring
            pop, xl, xu = sweep_population(gen, run, codec, s, p)
            counts["zero-range genes"] += int((xl == xu).sum())
            draws = draw_offspring(stream_of(gen), s, p, n_off, n_gene)
            off = kernels.offspring(tables, pop, xl, xu, n_off, draws)
            hold_equal(off, make_offspring_plain(tables, pop, xl, xu, n_off, draws), f"offspring S={s} P={p}")
            # K1 at the main path's two shapes: the offspring (N_off rows, each
            # step) and the population (P rows, as at init)
            hard = {"off": hard_candidates(codec, off), "pop": hard_candidates(codec, pop)}
            f_obj = {}
            for rows, cand in hard.items():
                f_obj[rows] = kernels.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                                     run.minimize_class, obj)
                hold_equal(f_obj[rows], evaluate_plain(obj, codec, run, cand, cons),
                           f"objective_lcld S={s} N={cand.shape[1]}")
                counts["nonfinite objectives"] += int((~torch.isfinite(f_obj[rows])).any(-1).sum())
            # K2 front peel
            f = torch.as_tensor(sweep_objectives(rng, s, m), device=device)
            inf_rows += int((torch.isinf(f).any(-1) & ~torch.isnan(f).any(-1)).sum())
            for stop in (n_stop, m):
                got = kernels.nd_peel(f, stop)
                want = nd_ranks_plain(f, stop)
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"nd_peel != plain at S={s} M={m} n_stop={stop}: {bad} ranks differ")
            ranks = kernels.nd_peel(f, n_stop)
            mean, most = peeled_fronts(ranks)
            acc = fronts.setdefault(m, [0.0, 0, 0])
            acc[0], acc[1], acc[2] = acc[0] + mean * s, acc[1] + s, max(acc[2], most)
            # K4a normalisation, from the initial state and from a warm one
            state = NormState.init(s, 3, device=device)
            for step in range(2):
                got = kernels.survive_norm(f, ranks, asp, state)
                new_state, nadir, dirs = survive_norm_plain(f, ranks, asp, state)
                for name, g, w in zip(("ideal", "worst", "extreme", "nadir", "dirs"), got, (*new_state, nadir, dirs)):
                    hold_equal(g, w, f"survive_norm {name} S={s} M={m} step {step}")
                state = new_state
            # K3 association
            dirs_sw = torch.as_tensor(sweep_directions(rng, s, r), device=device)
            ideal_sw, nadir_sw = finite_ideal_nadir(f)
            got = kernels.associate(f, dirs_sw, ideal_sw, nadir_sw)
            for name, g, w in zip(("niche", "dist"), got, associate_plain(f, dirs_sw, ideal_sw, nadir_sw)):
                hold_equal(g, w, f"associate {name} S={s} M={m}")
            # K4b fill, extraction and archive, on K4a's directions; tied
            # gumbels; an inf violation gives a NaN archive score
            niche, dist = kernels.associate(f, dirs, state.ideal, nadir)
            gum_cut = -torch.log(-torch.log(torch.rand((s, r), generator=gen, device=device).clamp_min(1e-30)))
            gum_mem = -torch.log(-torch.log(torch.rand((s, m), generator=gen, device=device).clamp_min(1e-30)))
            gum_cut[:, ::3] = 0.25
            gum_mem[:, ::4] = -0.5
            pop_f, off_f = f[:, :p], f[:, p:]
            arch_x, arch_f = pop[:, :24], f_obj["pop"][:, :24].clone()
            arch_f[:, 3, 2] = torch.inf
            counts["NaN archive scores"] += int(torch.isnan(archive_score(torch.cat([arch_f, off_f], 1))).sum())
            mask = survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, n_stop)
            hold_equal(kernels.survive_fill(gum_cut, gum_mem, ranks, niche, dist, n_stop).mask, mask,
                       f"survive_fill mask S={s} M={m}")
            out = kernels.survive_fill(gum_cut, gum_mem, ranks, niche, dist, n_stop,
                                       extract=(pop, off, pop_f, off_f), archive=(arch_x, arch_f, off, off_f, 24))
            want = extract_archive_plain(mask, pop, off, pop_f, off_f, arch_x, arch_f)
            for name, g, w in zip(("mask", "pop_x", "pop_f", "arch_x", "arch_f"), out, (mask, *want)):
                hold_equal(g, w, f"survive_fill {name} S={s} M={m}")
            for g, w in zip(kernels.archive_select(pop, f_obj["pop"], pop[:, :0], f_obj["pop"][:, :0], 24),
                            archive_select_plain(pop, f_obj["pop"], 24)):
                hold_equal(g, w, f"archive_select S={s} P={p}")
            if s == N_STATES and m == SWEEP_SHAPES[0][0]:
                timing = dict(run=run, pop=pop, xl=xl, xu=xu, draws=draws, off=off, cand=hard["off"], f=f,
                              ranks=ranks, asp=asp, state0=NormState.init(s, 3, device=device), niche=niche,
                              dist=dist, gum_cut=gum_cut, gum_mem=gum_mem, arch_x=arch_x, arch_f=arch_f,
                              dirs=dirs_sw, ideal=ideal_sw, nadir=nadir_sw)
            if s == N_STATES and m == SWEEP_SHAPES[1][0]:
                timing["f_config"] = f
                timing["assoc_config"] = (f, dirs_sw, ideal_sw, nadir_sw)
        log(f"[kernels] parity ok at M={m} R={r}: S in {SWEEP_STATES}")
        acc = fronts[m]
        log(f"[kernels] nd_peel at M={m} n_stop={n_stop}: fronts per state mean {acc[0] / acc[1]:.3f}, "
            f"max {acc[2]} over the sweep's {acc[1]} states")
    log(f"[kernels] offspring, objective_lcld, survive_norm, associate and survive_fill equal their plain versions "
        f"on every entry; swept {counts}, {inf_rows} rows with an inf and no NaN objective (NaN and inf projections)")
    check_launch_shapes(device, moeva, x, rng, gen)
    return time_kernels(device, moeva, timing)


#: (S, N) of K1's tile edges: 300 rows end in a partial tile and tiles span
#: states of both classes; 7 rows fill no tile; 5 x 27 rows put several
#: states in one tile
OBJECTIVE_EDGES = ((3, 100), (1, 7), (5, 27))
#: hidden widths of a relu stack too large for shared memory beside K1's
#: buffers: its weights are read from global memory, at 64-row tiles
GLOBAL_STACK = (128, 128, 128)
#: (S, M, R, n_survive) of K4b's block edges: a last block with fewer states
#: than the four it holds, and the kernel's limits, where four states'
#: arrays do not fit one block
FILL_EDGES = ((3, 203, 103, 103), (5, 203, 103, 103), (3, 1024, 1024, 512))
#: (case, M) of K4a's edges, each at S = 3 and 5 (four states per block, the
#: last block partial): M = 1024, the peel's limit (32 staged rows per
#: lane); an all-NaN f column; equal rows (det = 0, the nadir fallbacks);
#: a warm state whose previous extreme points win every argmin
NORM_EDGES = (("mixed", 203), ("limits", 1024), ("NaN column", 203), ("equal rows", 203), ("warm extremes", 203))
#: K2's edges, (objectives, M) at S = 3, each for n_stop = 0, M / 2, M and
#: M + 5: M of one partial word, one full word, a word and one more, two
#: words, even word counts (rows padded to an odd stride), the config's 303
#: and the limit; mixed objectives (NaN, inf, ties, duplicates), all-NaN
#: states, equal rows (one front), chains (M fronts, the deepest peel) and
#: ties of signed zeros, infinities, float32 extremes and denormals (K2
#: compares by the sign of a difference)
K2_EDGES = tuple((kind, m) for kind in ("mixed", "all NaN", "equal rows", "chain", "extremes")
                 for m in (1, 31, 32, 33, 64, 256, 303, 1024))
#: the values of the "extremes" edge, a few rows of them NaN
K2_EXTREMES = (-np.inf, -np.finfo(np.float32).max, -1.0, -1e-45, -0.0, 0.0, 1e-45, 3e-45, 1.0,
               np.finfo(np.float32).max, np.inf)
#: K3's edges, (inputs, M, R), each at S = 3 and 5: every kind has
#: duplicated directions (exact ties: the first wins) and rows with an inf
#: objective (NaN and inf projections); "all NaN": one state's objectives
#: all NaN; "nadir == ideal": 1e-12 denominators under a column scaled by
#: 1e8, so squared projections overflow to tied infinities; "zeros and
#: denormals": signed zeros and denormals in the objectives and the
#: directions; "zero direction": one direction is 0, a NaN projection on
#: every row. M of one candidate, a partial warp, the two shapes' and 1024;
#: R of one direction, fewer than the unroll, one step of it, around a
#: warp, the two shapes', 1024 and 4096 (more than 48 KB of staged
#: directions)
K3_EDGES = tuple((kind, m, r)
                 for kind in ("mixed", "all NaN", "nadir == ideal", "zeros and denormals", "zero direction")
                 for m in (1, 31, 203, 303, 1024) for r in (1, 3, 4, 31, 32, 33, 103, 203, 1024, 4096))
#: the values of the "zeros and denormals" edge
K3_TINY = (-0.0, 0.0, 1e-45, -1e-45, 3e-42, 1e-39, 0.5, 1.0)
#: K5's edges: the mutation queue full and empty, zero-range genes, a last
#: mating with one child, and a synthetic schema of more genes than one
#: chunk of the queue
OFFSPRING_EDGES = ("all mutate", "none mutate", "zero range", "odd N", "wide")
WIDE_GENES = 3000


def check_norm_edges(device, rng):
    """K4a on ``NORM_EDGES``, two steps each, bit for bit against
    ``survive_norm_plain``."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import NormState, survive_norm_plain

    asp = torch.as_tensor(rng.dirichlet(np.ones(3), 100).astype(np.float32), device=device)
    for case, m in NORM_EDGES:
        for s in (3, 5):
            f = torch.as_tensor(sweep_objectives(rng, s, m), device=device)
            state = NormState.init(s, 3, device=device)
            if case == "NaN column":
                f[1, :, 1] = torch.nan
            if case == "equal rows":
                f = f[:, :1].expand(s, m, 3).nan_to_num(nan=0.5, posinf=2.0).contiguous()
            if case == "warm extremes":
                f = f.nan_to_num(nan=0.5, posinf=9.0) + 1.0
                state = state._replace(ideal=torch.zeros((s, 3), device=device),
                                       extreme=0.5 * torch.eye(3, device=device).expand(s, 3, 3).contiguous())
            ranks = nd_ranks_plain(f, m // 2)
            for step in range(2):
                got = kernels.survive_norm(f, ranks, asp, state)
                new_state, nadir, dirs = survive_norm_plain(f, ranks, asp, state)
                for name, g, w in zip(("ideal", "worst", "extreme", "nadir", "dirs"), got, (*new_state, nadir, dirs)):
                    hold_equal(g, w, f"survive_norm {name} {case} S={s} M={m} step {step}")
                if case == "warm extremes" and not torch.equal(new_state.extreme, state.extreme):
                    raise AssertionError("survive_norm warm extremes: the previous extreme points did not win")
                state = new_state


def check_peel_edges(device, rng):
    """K2 on ``K2_EDGES``, exactly against ``nd_ranks_plain``."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain

    deepest = 0
    for kind, m in K2_EDGES:
        f = sweep_objectives(rng, 3, m)
        if kind == "all NaN":
            f[:] = np.nan
        if kind == "equal rows":
            f[:] = np.nan_to_num(f[:, :1], nan=0.5, posinf=2.0)
        if kind == "chain":
            f = (rng.uniform(0.1, 1.0, (3, m, 1)) * rng.uniform(0.2, 2.0, (3, 1, 3))).astype(np.float32)
        if kind == "extremes":
            f = rng.choice(np.array(K2_EXTREMES, dtype=np.float32), size=(3, m, 3))
            f[rng.random((3, m)) < 0.05, 1] = np.nan
        f = torch.as_tensor(f, device=device)
        for stop in (0, m // 2, m, m + 5):
            got = kernels.nd_peel(f, stop)
            if not torch.equal(got, nd_ranks_plain(f, stop)):
                raise AssertionError(f"nd_peel != plain on K2_EDGES {kind} M={m} n_stop={stop}")
            deepest = max(deepest, peeled_fronts(got)[1])
    log(f"[kernels] K2_EDGES: nd_peel equals nd_ranks_plain on {len(K2_EDGES)} (objectives, M) cases at S = 3, "
        f"n_stop in (0, M/2, M, M+5); deepest peel {deepest} fronts")


def associate_edge_inputs(rng, kind: str, s: int, m: int, r: int):
    """``(f, dirs, ideal, nadir)``, float32 numpy arrays of one case of
    ``K3_EDGES``."""
    f = sweep_objectives(rng, s, m)
    f[rng.random((s, m)) < 0.05, rng.integers(0, 3)] = np.inf
    dirs = rng.dirichlet(np.ones(3), (s, r)).astype(np.float32)
    if kind == "all NaN":
        f[0] = np.nan
    if kind == "nadir == ideal":
        f[..., 1] *= np.float32(1e8)
    if kind == "zeros and denormals":
        tiny = np.array(K3_TINY, dtype=np.float32)
        f = rng.choice(tiny, size=(s, m, 3))
        dirs = np.where(rng.random((s, r, 3)) < 0.3, rng.choice(tiny, size=(s, r, 3)), dirs)
    a = min(r, 3)
    dirs[:, r - a:] = np.eye(3, dtype=np.float32)[:a]  # the axes, last as in survival
    k = r // 3
    dirs[:, k : 2 * k] = dirs[:, :k] * np.float32(2.0)  # the same unit directions
    if kind == "zero direction":
        dirs[:, r // 2] = 0.0
    finite = np.where(np.isfinite(f), f, np.float32(0.0))
    ideal, nadir = finite.min(1), finite.max(1)
    if kind == "nadir == ideal":
        nadir[:, 1] = ideal[:, 1]
        nadir[-1] = ideal[-1]
    if kind == "zeros and denormals":
        ideal[:], nadir[:] = 0.0, 1.0
    return f, dirs, ideal, nadir


def check_associate_edges(device, rng):
    """K3 on ``K3_EDGES`` at S = 3 and 5, bit for bit against
    ``associate_plain``."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import associate_plain

    nan_rows = 0
    for kind, m, r in K3_EDGES:
        for s in (3, 5):
            args = [torch.as_tensor(a, device=device) for a in associate_edge_inputs(rng, kind, s, m, r)]
            got, want = kernels.associate(*args), associate_plain(*args)
            for name, g, w in zip(("niche", "dist"), got, want):
                hold_equal(g, w, f"associate {name} on K3_EDGES {kind} S={s} M={m} R={r}")
            nan_rows += int(want[1].isnan().sum())
    log(f"[kernels] K3_EDGES: associate equals associate_plain on {len(K3_EDGES)} (inputs, M, R) cases at S = 3 "
        f"and 5; {nan_rows} rows with a NaN dist")


def wide_tables(rng, l: int, device):
    """Operator tables of a synthetic schema of ``l`` genes, 40% integer."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import OperatorTables

    type_id = (rng.random(l) < 0.4).astype(np.int64)
    rank = np.zeros(l, dtype=np.int64)
    sizes = [0, 0, 0]
    for i, t in enumerate(type_id):
        rank[i] = sizes[t]
        sizes[t] += 1
    return OperatorTables(
        type_id=torch.as_tensor(type_id), rank_in_type=torch.as_tensor(rank), type_sizes=tuple(sizes),
        mut_prob=torch.as_tensor(1.0 / np.maximum(np.array(sizes)[type_id], 1)), int_mask=torch.as_tensor(type_id == 1),
    ).to(device)


def check_offspring_edges(device, moeva, x, rng, gen):
    """K5 on ``OFFSPRING_EDGES`` at 7 states, bit for bit against
    ``make_offspring_plain``."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import draw_offspring, make_offspring_plain

    s, p = 7, moeva.pop_size
    run = moeva.prepare(x[:s], np.arange(s) % 2)
    for case in OFFSPRING_EDGES:
        n, tables, xl, xu = moeva.n_offsprings, moeva.tables, run.xl_gen.clone(), run.xu_gen.clone()
        if case == "odd N":
            n -= 1
        if case == "wide":
            n, tables = 5, wide_tables(rng, WIDE_GENES, device)
            xl = torch.as_tensor(rng.uniform(-5, 0, (s, WIDE_GENES)).astype(np.float32), device=device)
            xu = xl + torch.as_tensor(rng.uniform(0, 5, (s, WIDE_GENES)).astype(np.float32), device=device)
        if case in ("zero range", "wide"):
            xu[:, ::5] = xl[:, ::5]
        l = xl.shape[1]
        pop = xl[:, None] + torch.rand((s, p, l), generator=gen, device=device) * (xu - xl)[:, None]
        pop = torch.where(tables.int_mask, torch.round(pop), pop).clamp(xl[:, None], xu[:, None])
        draws = draw_offspring(stream_of(gen), s, p, n, l)
        if case in ("all mutate", "none mutate"):
            draws = draws._replace(mut_select=torch.full_like(draws.mut_select, 0.0 if case == "all mutate" else 1.0))
        if case == "wide":  # ~7% of the genes mutate, in every chunk of elements
            draws = draws._replace(mut_select=draws.mut_select * 0.01)
        args = (tables, pop, xl, xu, n, draws)
        hold_equal(kernels.offspring(*args), make_offspring_plain(*args), f"offspring {case} S={s} N={n} L={l}")


def check_launch_shapes(device, moeva, x, rng, gen):
    """K1, K4b, K4a, K5, K2 and K3 on their launch shapes' edges, bit for
    bit against their plain versions."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
        evaluate_plain, extract_archive_plain, make_objective_tables,
    )
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import associate_plain, survive_fill_plain
    from moeva2_ijcai22_replication_tpu_torch.models.mlp import MLP

    codec, obj = moeva.codec, moeva._objective
    with torch.random.fork_rng(devices=[]):  # the main path's draws stay as they were
        torch.manual_seed(0)
        wide = MLP(codec.n_features, GLOBAL_STACK, 2).to(device).eval().requires_grad_(False)
    obj_global = make_objective_tables(codec, wide, obj.scaler, moeva.norm, moeva.constraints.tol)
    for s, n in OBJECTIVE_EDGES:
        run = moeva.prepare(x[:s], np.arange(s) % 2)
        cand = hard_candidates(codec, sweep_population(gen, run, codec, s, n)[0])
        for stack, tables in (("main", obj), ("global", obj_global)):
            got = kernels.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                         run.minimize_class, tables)
            hold_equal(got, evaluate_plain(tables, codec, run, cand, moeva.constraints),
                       f"objective_lcld S={s} N={n} {stack} stack")
    for s, m, r, p in FILL_EDGES:
        f = torch.as_tensor(sweep_objectives(rng, s, m), device=device)
        ranks = nd_ranks_plain(f, p)
        ideal, nadir = finite_ideal_nadir(f)
        niche, dist = associate_plain(f, torch.as_tensor(sweep_directions(rng, s, r), device=device), ideal, nadir)
        gum_cut = torch.rand((s, r), generator=gen, device=device)
        gum_mem = torch.rand((s, m), generator=gen, device=device)
        gum_cut[:, ::3] = 0.25
        pop = torch.rand((s, p, codec.gen_length), generator=gen, device=device)
        off = torch.rand((s, m - p, codec.gen_length), generator=gen, device=device)
        extract = (pop, off, f[:, :p], f[:, p:])
        mask = survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, p)
        want = (mask, *extract_archive_plain(mask, *extract, pop[:, :24], f[:, :24]))
        got = kernels.survive_fill(gum_cut, gum_mem, ranks, niche, dist, p, extract=extract,
                                   archive=(pop[:, :24], f[:, :24], off, f[:, p:], 24))
        for name, g, w in zip(("mask", "pop_x", "pop_f", "arch_x", "arch_f"), got, want):
            hold_equal(g, w, f"survive_fill {name} S={s} M={m} R={r}")
    check_norm_edges(device, rng)
    check_offspring_edges(device, moeva, x, rng, gen)
    check_peel_edges(device, rng)
    check_associate_edges(device, rng)
    log(f"[kernels] launch-shape edges equal their plain versions: objective_lcld (S, N) in {OBJECTIVE_EDGES} "
        f"with the main path's stack and a 47-{'-'.join(map(str, GLOBAL_STACK))}-2 stack read from global memory; "
        f"survive_fill (S, M, R, n_survive) in {FILL_EDGES}; survive_norm (case, M) in {NORM_EDGES} at S = 3 "
        f"and 5, two steps; offspring {OFFSPRING_EDGES} at S = 7 (wide: L = {WIDE_GENES})")


def time_kernels(device, moeva, t):
    """Each kernel's device time, wrapper time, plain time and bound at the
    main path's shape (S = 1000, M = 203, R = 103), on the sweep's inputs."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
        evaluate_plain, extract_archive_plain,
    )
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import make_offspring_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import (
        associate_plain, survive_fill_plain, survive_norm_plain,
    )

    m, r, n_stop = SWEEP_SHAPES[0]
    s, n, l = t["off"].shape
    p, a, d = n_stop, r - 3, moeva.codec.n_features
    run, obj, tables = t["run"], moeva._objective, moeva.tables
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    ranks_np = t["ranks"].cpu().numpy()
    n_arch = 24
    fill_args = (t["gum_cut"], t["gum_mem"], t["ranks"], t["niche"], t["dist"], n_stop)
    extract = (t["pop"], t["off"], t["f"][:, :p], t["f"][:, p:])
    archive = (t["arch_x"], t["arch_f"], t["off"], t["f"][:, p:], n_arch)
    off_bytes, off_ops, off_ops_f64, n_mutated = offspring_work(tables, t["pop"], t["xl"], t["xu"], n, t["draws"])
    fill_bytes, fill_ops = fill_work_bound(fill_args, extract, archive)

    def fill_plain():
        mask = survive_fill_plain(*fill_args)
        return extract_archive_plain(mask, *extract, t["arch_x"], t["arch_f"])

    # K5 reads mut_u only where a gene mutates (n_mutated)
    specs = (
        ("offspring", "csrc/offspring.cu", "attacks/moeva/operators.py:233",
         lambda: kernels.offspring(tables, t["pop"], t["xl"], t["xu"], n, t["draws"]),
         lambda: make_offspring_plain(tables, t["pop"], t["xl"], t["xu"], n, t["draws"]),
         off_bytes, off_ops, off_ops_f64, 0.0),
        ("objective_lcld", "csrc/objective_lcld.cu", "attacks/moeva/engine.py:452",
         lambda: kernels.objective_lcld(t["cand"], run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                        run.minimize_class, obj),
         lambda: evaluate_plain(obj, moeva.codec, run, t["cand"], moeva.constraints),
         4 * s * n * l + 16 * s * d + 8 * s + 4 * n_params + 16 * d + 12 * s * n,
         s * n * (2 * macs + OBJECTIVE_OPS_PER_FEATURE * d + OBJECTIVE_OPS_PER_ROW), 0, 0.0),
        ("nd_peel", "csrc/nd_peel.cu", "attacks/moeva/nds.py:39",
         lambda: kernels.nd_peel(t["f"], n_stop), lambda: nd_ranks_plain(t["f"], n_stop),
         4 * s * m * 3 + 4 * s * m, nd_peel_ops(ranks_np, m), 0, 0.0),
        ("survive_norm", "csrc/survive_norm.cu", "attacks/moeva/survival.py:325",
         lambda: kernels.survive_norm(t["f"], t["ranks"], t["asp"], t["state0"]),
         lambda: survive_norm_plain(t["f"], t["ranks"], t["asp"], t["state0"]),
         16 * s * m + 12 * a + 60 * s + 72 * s + 12 * s * r,
         s * (NORM_OPS_PER_CANDIDATE * (3 + m + a) + NORM_OPS_PER_ROW * m + NORM_OPS_PER_DIRECTION * a
              + NORM_OPS_PER_STATE) + 6 * a, 0, 0.0),
        ("associate", "csrc/associate.cu", "attacks/moeva/survival.py:225",
         lambda: kernels.associate(t["f"], t["dirs"], t["ideal"], t["nadir"]),
         lambda: associate_plain(t["f"], t["dirs"], t["ideal"], t["nadir"]),
         4 * (s * m * 3 + s * r * 3 + 2 * s * 3) + 12 * s * m, 6 * s * m * r + 9 * s * r + 12 * s * m, 0, 0.0),
        ("survive_fill", "csrc/survive_fill.cu", "attacks/moeva/survival.py:351",
         lambda: kernels.survive_fill(*fill_args, extract=extract, archive=archive), fill_plain,
         fill_bytes, fill_ops, 0, 0.0),
    )
    records = []
    for name, source, replaces, kfn, pfn, n_bytes, n_ops, n_ops_f64, err in specs:
        b_ms, b_by = bound_ms(n_bytes, n_ops, n_ops_f64)
        rec = {
            "name": name,
            "route": "cuda",
            "source": "moeva2_ijcai22_replication_tpu_torch/kernels/" + source,
            "replaces": "moeva2_ijcai22_replication_tpu/" + replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": graph_ms(kfn),
            "wrapper_ms": cuda_ms(kfn),
            "plain_ms": cuda_ms(pfn, launches=5, repeats=3),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        log(f"[kernels] {name} at S={s} M={m} R={r}: device {rec['ms']:.4f} ms, through the wrapper "
            f"{rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        if name == "offspring":
            log(f"[kernels] {name}: {n_mutated} of {s * n * l} output genes mutate on these draws (pows and "
                "mut_u bytes counted for those only)")
        if name == "nd_peel":
            m_c, _, stop_c = SWEEP_SHAPES[1]
            rec["ms_config_shape"] = graph_ms(lambda: kernels.nd_peel(t["f_config"], stop_c))
            log(f"[kernels] {name} at S={s} M={m_c} n_stop={stop_c} (config/moeva.yaml's shape): device "
                f"{rec['ms_config_shape']:.4f} ms")
        if name == "associate":
            m_c, r_c, _ = SWEEP_SHAPES[1]
            rec["ms_config_shape"] = graph_ms(lambda: kernels.associate(*t["assoc_config"]))
            log(f"[kernels] {name} at S={s} M={m_c} R={r_c} (config/moeva.yaml's shape): device "
                f"{rec['ms_config_shape']:.4f} ms")
        if name == "objective_lcld":
            # without FMA contraction a multiply-add takes two instructions: the
            # fixed-order design cannot beat half the fp32 peak
            rec["ceiling_ms"] = n_ops / (PEAK_F32_OPS_S / 2) * 1e3
            log(f"[kernels] {name} no-FMA ceiling {rec['ceiling_ms']:.5f} ms")
        records.append(rec)
    return records


def max_err(got, want, scale=None) -> float:
    """Largest |got - want| (over ``scale`` where given) over the entries
    finite in ``want``; inf where the two differ in which entries are
    finite, or in a non-finite value."""
    import torch

    got, want = got.cpu().double(), want.cpu().double()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(got[~fin].nan_to_num(), want[~fin].nan_to_num()):
        return math.inf
    d = (got - want).abs()
    if scale is not None:
        d = d / scale.cpu().double()
    d = d[fin]
    return float(d.max()) if d.numel() else 0.0


def check_step_against_cpu(moeva_gpu, moeva_cpu, moeva_ref, x, device, tag="[main]", n_states=8):
    """Three generation steps on ``n_states`` states, on the card and on the CPU path
    (both float32), fed the same draws, made on the CPU. Each step starts both
    from the CPU's carry and compares the stages in order, on the same inputs:

    - offspring (K5) and the objectives (K1) of the CPU's offspring: the
      entries that differ between the devices are counted (0 expected: both
      run the same rounded operations); each device's error against the
      float64 CPU path (``moeva_ref``) is held as a floor, the card's at
      most ``STEP_ERR_RATIO`` times the CPU's;
    - survival of the CPU's objectives of [population, offspring] (on the
      card read through two pointers, as the step reads them; on the CPU
      merged): ranks (K2), normalisation state, nadir and directions (K4a),
      niche and dist (K3), and the fill, the next population and the
      archive (K4b) must be equal.

    The same three steps run free on each device are reported: with every
    stage equal, their populations agree on every row. The CPU engine takes
    the card engine's aspiration points (K14's, the same source): its own,
    from ``energy_descent_plain`` on the host, may differ in the last ulps
    (CUDA's float64 ``pow`` and ``exp`` against the CPU's)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import extract_archive_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import (
        associate_batch, draw_gumbels, survive_fill_plain, survive_norm,
    )
    from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream

    def to(t, dev, dtype=None):
        if isinstance(t, tuple):
            items = [to(u, dev, dtype) for u in t]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return t.to(dev, dtype if dtype is not None and t.is_floating_point() else t.dtype)

    def survive_stages(moeva, state, gum_cut, gum_mem, pop_x, off, pop_f, off_f, arch_x, arch_f):
        f, two = (pop_f, off_f) if pop_f.is_cuda else (torch.cat([pop_f, off_f], dim=1), None)
        ranks = nd_ranks(f, n_stop=moeva.pop_size, off_f=two)
        new_state, nadir, dirs = survive_norm(f, ranks, moeva.asp_points, state, two)
        niche, dist = associate_batch(f, dirs, new_state.ideal, nadir, two)
        if f.is_cuda:
            mask, *tail = kernels.survive_fill(
                gum_cut, gum_mem, ranks, niche, dist, moeva.pop_size,
                extract=(pop_x, off, pop_f, off_f), archive=(arch_x, arch_f, off, off_f, arch_x.shape[1]),
            )
        else:
            mask = survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, moeva.pop_size)
            tail = extract_archive_plain(mask, pop_x, off, pop_f, off_f, arch_x, arch_f)
        return dict(ranks=ranks, directions=dirs, nadir=nadir, niche=niche, dist=dist, mask=mask,
                    **dict(zip(("pop_x", "pop_f", "arch_x", "arch_f"), tail)),
                    **{f"state.{k}": v for k, v in new_state._asdict().items()})

    moeva_cpu.asp_points = moeva_gpu.asp_points.cpu()
    xs = x[:n_states]
    mc = np.ones(len(xs), dtype=np.int64)
    gen = PhiloxStream(3)
    err = {k: [0.0, 0.0] for k in ("offspring", "f1", "f2", "f3")}  # [card, CPU]
    differ = {"offspring": 0, "objectives": 0, "niche": 0, "dist": 0}  # entries, card != CPU
    with torch.inference_mode():
        run_c, run_g, run_r = (m.prepare(xs, mc) for m in (moeva_cpu, moeva_gpu, moeva_ref))
        span = run_r.xu_gen - run_r.xl_gen
        span = torch.where(span > 0, span, 1.0)[:, None, :]
        gums = draw_gumbels(gen, len(xs), moeva_cpu.n_dirs, moeva_cpu.pop_size)
        carry_c = moeva_cpu.init_carry(run_c, *gums)
        free_g = moeva_gpu.init_carry(run_g, *to(gums, device))
        for step in range(3):
            dr = moeva_cpu.draw_generation(gen, len(xs))
            dr_g = to(dr, device)
            pop_x = carry_c.pop_x
            off_c = moeva_cpu.offspring(run_c, pop_x, dr.offspring)
            off_g = moeva_gpu.offspring(run_g, pop_x.to(device), dr_g.offspring)
            off_r = moeva_ref.offspring(run_r, pop_x.double(), to(dr.offspring, "cpu", torch.float64))
            for i, off in enumerate((off_g, off_c)):
                err["offspring"][i] = max(err["offspring"][i], max_err(off, off_r, span))
            f_c = moeva_cpu._evaluate(run_c, off_c)
            f_g = moeva_gpu._evaluate(run_g, off_c.to(device))
            f_r = moeva_ref._evaluate(run_r, off_c.double())
            differ["offspring"] += int((~same_entries(off_g.cpu(), off_c)).sum())
            differ["objectives"] += int((~same_entries(f_g.cpu(), f_c)).sum())
            for k in range(3):
                for i, f in enumerate((f_g, f_c)):
                    err[f"f{k + 1}"][i] = max(err[f"f{k + 1}"][i], max_err(f[..., k], f_r[..., k]))
            args = (carry_c.norm_state, dr.gum_cut, dr.gum_mem, pop_x, off_c, carry_c.pop_f, f_c,
                    carry_c.arch_x, carry_c.arch_f)
            want = survive_stages(moeva_cpu, *args)
            got = survive_stages(moeva_gpu, *to(args, device))
            for name in ("niche", "dist"):
                differ[name] += int((~same_entries(got[name].cpu(), want[name])).sum())
            for name in want:
                if not bool(same_entries(got[name].cpu(), want[name]).all()):
                    raise AssertionError(f"step {step}: survival {name} on the card != CPU on the same objectives "
                                         f"(max |difference| {max_err(got[name], want[name]):.3e})")
            carry_c = moeva_cpu.gen_step(run_c, carry_c, dr)
            free_g = moeva_gpu.gen_step(run_g, free_g, dr_g)
    log(f"{tag} engine stages on the same inputs over 3 steps, entries that differ between the card and the CPU: "
        f"offspring {differ['offspring']} of {3 * off_c.numel()}, objectives {differ['objectives']} of "
        f"{3 * f_c.numel()}; float32 error against the float64 CPU path (card, CPU): "
        + ", ".join(f"{k} {g:.3e} {c:.3e}" for k, (g, c) in err.items()) + " (offspring over each gene's range)")
    log(f"{tag} association of the same objectives, entries that differ between the card and the CPU: niche "
        f"{differ['niche']} of {3 * want['niche'].numel()}, dist {differ['dist']} of {3 * want['dist'].numel()}")
    log(f"{tag} survival, extraction and archive of the same objectives, card vs CPU: " + ", ".join(want) + " equal")
    for k, (g, c) in err.items():
        if g > STEP_ERR_RATIO * c:
            raise AssertionError(f"{k} on the card is off the float64 path by {g:.3e}, on the CPU by {c:.3e}")
    rows_equal = (free_g.pop_x.cpu() == carry_c.pop_x).all(-1).float().mean().item()
    log(f"{tag} the same 3 steps run free on each device: {rows_equal:.4f} of population rows equal")


def launches_per_generation(moeva, run, carry, draws, n_states: int):
    """One untraced generation (the draw source ``draws``' generation, one
    K0 launch, and ``gen_step``) with its launches counted as the code makes
    them: each port kernel's wrapper count, and each PyTorch op that
    launches a kernel (none since K2, K4a and K3 read the merge through two
    pointers): every ATen op but views, bare allocations and the profiler's
    range markers. Returns ``(carry, port kernels {name: n},
    torch ops {op: n})``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from moeva2_ijcai22_replication_tpu_torch import kernels

    ops = {}

    class CountLaunches(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if not (func.is_view or name.startswith(("empty", "_record_function"))):
                ops[name] = ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    before = kernels.launch_counts()
    with CountLaunches():
        carry = moeva.gen_step(run, carry, draws.generation(n_states))
    after = kernels.launch_counts()
    return carry, {k: after[k] - before[k] for k in after}, ops


def trace_generations(moeva, run, carry, draws, n_states: int, settle_s: float = PROFILE_SETTLE_S):
    """One ``torch.profiler`` trace of ``PROFILE_GENS`` generation steps,
    after ``PROFILE_GENS`` traced and discarded (the profiler's warm-up) and
    ``settle_s`` seconds of an idle card once the kept window has opened.
    Returns ``(carry, the trace's key averages, the window's wall seconds)``.

    The device trace can miss kernels launched just after the profiler
    starts: at botnet's 2 ms per generation it once missed the first three
    generations' worth after a warm-up of one, and once 1 of 240 events
    after a warm-up of ``PROFILE_GENS``; the settle keeps the window's
    first launch away from its start."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(PROFILE_GENS):
                carry = moeva.gen_step(run, carry, draws.generation(n_states))
            torch.cuda.synchronize()
            prof.step()
            time.sleep(settle_s)
            t0 = time.perf_counter()
            for _ in range(PROFILE_GENS):
                with record_function("moeva.draws"):
                    step_draws = draws.generation(n_states)
                carry = moeva.gen_step(run, carry, step_draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(settle_s)
            prof.step()
    return carry, prof.key_averages(), wall


def traced_kernels(events):
    """The kernel events of a trace's key averages: device events with
    device time, less the ``moeva.*`` stage ranges (which also appear on the
    device timeline, as spans from their first to their last kernel)."""
    import torch

    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    return [e for e in on_card if not e.key.startswith("moeva.")], [e for e in on_card if e.key.startswith("moeva.")]


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def lost_events(kernels, port: dict, expected: int) -> list:
    """What a trace of ``PROFILE_GENS`` generations lacks: a line for each
    port kernel with fewer events than ``n * PROFILE_GENS``, for each kernel
    whose count is not a whole number of generations, and for the total
    against ``expected`` per generation; the second kind only where one of
    the others shows. Empty when the trace is whole."""
    lost = []
    for name, n in port.items():
        got = sum(e.count for e in kernels if f"{name}_kernel" in e.key)
        if got != n * PROFILE_GENS:
            lost.append(f"{got} events of {name}, the code launched {n * PROFILE_GENS}")
    traced = sum(e.count for e in kernels)
    if traced != expected * PROFILE_GENS:
        lost.append(f"{traced} kernel events, the code launched {expected * PROFILE_GENS}")
    if lost:
        lost += [f"{e.count} events of {e.key[:80]}" for e in kernels if e.count % PROFILE_GENS]
    return lost


#: the launches of one generation step: K0's draws, then K5, the objective
#: kernel, K2, K4a, K3 (the last three reading [population, offspring]
#: through two pointers) and K4b; no eager PyTorch op
GENERATION_LAUNCHES = 7


def check_generation_launches(port: dict, ops: dict, tag: str) -> None:
    """Fail unless one generation launched ``GENERATION_LAUNCHES`` kernels,
    each port kernel at most once, and no eager PyTorch op."""
    if ops:
        raise AssertionError(f"{tag} a generation step launched eager torch ops {ops}")
    if sum(port.values()) != GENERATION_LAUNCHES or max(port.values()) != 1:
        raise AssertionError(f"{tag} a generation step launched {port}, not {GENERATION_LAUNCHES} kernels once each")


def profile_generation(moeva, x, tag="[profile]"):
    """Phase 6: where a generation's time goes at the main path's shape.
    Traces ``PROFILE_GENS`` generation steps (``trace_generations``) after 3
    untraced ones and
    prints the traced ms per generation, the device-busy
    share (summed kernel time over the traced wall time), the kernels ranked
    by device time with their launches per generation, and the device span
    of each ``moeva.*`` stage range of ``gen_step``. Fails unless the trace
    holds, per generation, one event of each port kernel and as many kernel
    events in all as the first untraced generation launched (a trace that
    lost events would read a low busy share). A trace that lost events is
    logged with what it lost and taken again, ``PROFILE_ATTEMPTS`` times at
    most; only a whole trace is reported."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import PhiloxDraws
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks

    draws = PhiloxDraws(moeva, 0)
    with torch.inference_mode():
        init = draws.init(len(x))
        run, start = moeva._prepare(x, np.ones(len(x), dtype=np.int64), moeva.init_spec(init.ball))
        carry = moeva.init_carry(run, init.gum_cut, init.gum_mem, start=start)
        carry, port, ops = launches_per_generation(moeva, run, carry, draws, len(x))
        check_generation_launches(port, ops, tag)
        for _ in range(2):
            carry = moeva.gen_step(run, carry, draws.generation(len(x)))
    expected = sum(port.values()) + sum(ops.values())
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        carry, events, wall = trace_generations(moeva, run, carry, draws, len(x))
        kernels, stages = traced_kernels(events)
        lost = lost_events(kernels, port, expected)
        if not lost:
            break
        log(f"{tag} trace {attempt} of at most {PROFILE_ATTEMPTS} lost events, taken again: " + "; ".join(lost))
    else:
        raise AssertionError(f"{PROFILE_ATTEMPTS} traces in a row lost events, the last: " + "; ".join(lost))

    dev = _device_us
    busy_us = sum(dev(e) for e in kernels)
    per_gen = lambda us: us / 1e3 / PROFILE_GENS  # noqa: E731
    traced = sum(e.count for e in kernels)
    if tag == "[profile]":
        PROFILE_SUMMARY.update(traced=traced / PROFILE_GENS, busy=round(busy_us / 1e6 / wall, 3),
                               ms=round(wall / PROFILE_GENS * 1e3, 3))
    log(f"{tag} {len(x)} states: {wall / PROFILE_GENS * 1e3:.3f} ms per generation traced, device busy "
        f"{busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms = share {busy_us / 1e6 / wall:.3f}, "
        f"{traced / PROFILE_GENS:.1f} launches per generation traced, {expected} launched by the code "
        f"(port kernels {port}, torch ops {ops}; trace {attempt})")
    for e in sorted(kernels, key=dev, reverse=True):
        log(f"{tag} {per_gen(dev(e)):9.4f} ms/gen {e.count / PROFILE_GENS:6.1f} launches/gen  {e.key[:100]}")
    for e in sorted(stages, key=dev, reverse=True):
        log(f"{tag} stage {e.key}: device span {per_gen(dev(e)):.4f} ms/gen (idle gaps included)")
    with torch.inference_mode():
        off = moeva.offspring(run, carry.pop_x, draws.generation(len(x)).offspring)
        mean, most = peeled_fronts(nd_ranks(carry.pop_f, moeva.pop_size, moeva._evaluate(run, off)))
    log(f"{tag} nd_peel on the next generation's objectives: fronts per state mean {mean:.3f}, max {most}")


def main_path_engine(device):
    """The main path's problem (1000 synthetic LCLD states, a seeded
    surrogate and scaler) and its engine on ``device``."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = synthetic_lcld_problem(tmp, N_STATES)
    knobs = dict(norm=2, n_gen=N_GEN, n_pop=100, n_offsprings=100, archive_size=24, seed=42)
    return Moeva2(sur, cons, ml_scaler=scaler, device=device, **knobs), x, knobs


def expected_launches(moeva, n_states: int, result=None) -> dict:
    """Launches of one ``generate`` call that the engine's code implies: per
    chunk of states, the initial round (objectives, survival, the archive
    seeding on K4b) and its generation steps, ``n_gen - 1`` unless the
    early exit's record in ``result`` (a ``MoevaResult``) shows every state
    of the chunk solved at a gate, where the chunk stops. A gate (every
    ``early_stop_check_every`` generations, or ``quality_every`` with
    ``record_quality``, before the last step) launches K6a once; a gate
    that parks states launches K6b once for their columns, and once more
    where it repacks the rest. With ``save_history="full"`` every
    evaluation is the objective kernel's history instantiation. A chunk
    starts with K13a (``chunk_prepare``, again at each repack) and K0's
    initial draws, each step draws once (``draws``), and the chunk ends with
    K13b (``chunk_decode``)."""
    from moeva2_ijcai22_replication_tpu_torch import kernels

    chunk = moeva.max_states_per_call or n_states
    sizes = [min(chunk, n_states - start) for start in range(0, n_states, chunk)]
    n_steps = moeva.n_gen - 1
    check = getattr(moeva, "early_stop_check_every", 0) or 0
    every = check or (getattr(moeva, "quality_every", 0) if getattr(moeva, "record_quality", False) else 0)
    trace = result.early_stop["compaction"] if result is not None and result.early_stop else []
    steps = gates = takes = repacks = 0
    for i, size in enumerate(sizes):
        entries = [t for t in trace if t.get("chunk", 0) == i]
        done = next((t["gen"] for t in entries if t["active"] == 0), n_steps)
        steps += done
        gates += min(done, n_steps - 1) // every if every else 0
        rows = size
        for t in entries:  # a gate that parked states; a smaller bucket is a repack
            takes += 1 + (t["bucket"] < rows)
            repacks += t["bucket"] < rows
            rows = t["bucket"]
    if result is not None and result.gens_executed != steps:
        raise AssertionError(f"gens_executed {result.gens_executed} != {steps} implied by the early exit's record")
    chunks = len(sizes)
    full = getattr(moeva, "save_history", None) == "full"
    return {
        **{name: 0 for name in kernels.launch_counts()},
        "offspring": steps,
        counter_name(moeva.constraints, "objective") + ("_hist" if full else ""): chunks + steps,
        "nd_peel": chunks + steps,
        "survive_norm": chunks + steps,
        "associate": chunks + steps,
        "survive_fill": chunks * (1 + (1 if moeva.archive_size else 0)) + steps,
        "gate_stats": gates,
        "take_carry": takes,
        "draws": chunks + steps,
        "chunk_prepare": chunks + repacks,
        "chunk_decode": chunks,
    }


def check_launches(launches: dict, expected: dict, path: str) -> None:
    """Fail unless every kernel that ``expected`` launches ran, and each as
    often as the code implies. K14 (``refdirs``) is left out: it launches
    at an engine's construction once per process and shape, so a path's
    count depends on what the process built before; phase 21 holds it on a
    fresh cache."""
    launches, expected = ({k: v for k, v in d.items() if k != "refdirs"} for d in (launches, expected))
    for name, n in expected.items():
        if n and launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on {path}")
    if launches != expected:
        raise AssertionError(f"launches {launches} != {expected} implied by the code")


def run_main_path(device, smi: str, moeva, x, knobs):
    """Phases 4 to 6."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator

    sur, cons, scaler = moeva.classifier, moeva.constraints, moeva.ml_scaler
    log(f"[main] Moeva2 on {N_STATES} LCLD states: pop {moeva.pop_size}, "
        f"{moeva.n_offsprings} offspring (M={moeva.pop_size + moeva.n_offsprings}, "
        f"R={moeva.n_dirs}), archive 24, {N_GEN} generations")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    PROFILE_SUMMARY.update(cold_s=round(cold_s, 3), steady_s=round(steady_s, 3))
    log(f"[main] launches on the main path: {launches}")
    log(f"[main] generate: cold {cold_s:.3f} s, steady {steady_s:.3f} s for {N_STATES} states "
        f"x {N_GEN} generations on {smi}")
    check_launches(launches, expected_launches(moeva, N_STATES), "the main path")

    p = moeva.pop_size + 24
    if res.x_ml.shape != (N_STATES, p, cons.schema.n_features):
        raise AssertionError(f"x_ml has shape {res.x_ml.shape}")
    if not np.isfinite(res.x_ml).all():
        raise AssertionError("non-finite values in x_ml")
    # an objective may legitimately be inf or NaN (a ratio constraint whose
    # denominator a mutation drove to 0); count them, as the reference does
    nonfinite = int((~np.isfinite(res.f)).any(-1).sum())
    log(f"[main] candidates with a non-finite objective: {nonfinite} of {res.f.shape[0] * res.f.shape[1]}")
    frozen = ~cons.schema.mutable
    if not np.array_equal(res.x_ml[:, :, frozen], np.broadcast_to(x[:, None, frozen].astype(np.float32), res.x_ml[:, :, frozen].shape)):
        raise AssertionError("immutable features moved")
    moved = float((res.x_ml != x[:, None, :].astype(np.float32)).any(-1).mean())
    log(f"[main] x_ml {res.x_ml.shape}, finite, immutables unchanged, {moved:.3f} of candidates moved")

    moeva_cpu = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs)
    moeva_ref = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", dtype=torch.float64, **knobs)
    check_step_against_cpu(moeva, moeva_cpu, moeva_ref, x, device)

    # the thresholds of the lcld_synth config in
    # tests/fixtures/oracle_interior_rates.json. The surrogate is seeded and
    # untrained, so the rates show that the judgement runs on the result,
    # not how well the attack works
    calc = ObjectiveCalculator(
        classifier=sur, constraints=cons, thresholds={"f1": 0.5, "f2": 0.5},
        min_max_scaler=scaler, minimize_class=1, norm=2, ml_scaler=scaler,
    )
    rates = calc.success_rate_3d(x, res.x_ml)
    if rates.shape != (7,) or not np.isfinite(rates).all():
        raise AssertionError(f"bad success rates {rates}")
    log("[main] success rates o1..o7 (plumbing check, not an attack result): " + " ".join(f"{v:.4f}" for v in rates))
    profile_generation(moeva, x)
    return launches


# -- phase 7: constrained PGD ----------------------------------------------------

#: K7's sweep: row counts and iteration budgets. K7 runs ceil(N / 132) rows
#: per block, at most 32 (one lane each in the per-row chains), in register
#: tiles of up to 4 rows on 132 SMs: a lone row; 31 and 33 rows, a block of
#: one row each; 131 and 133, one row per block and one row past it (two
#: per block, the last block holding one); 1000 (8 per block); the main
#: shape's 4000 (31 per block, a padded tile row, the last block holding
#: one); 4223, one row short of 132 full blocks of 32; and 4225, one row
#: past them (133 blocks, the last holding one). Counts above the problem's
#: states repeat its rows.
PGD_ROWS = (1, 31, 33, 131, 133, 1000, 4000, 4223, 4225)
#: the sweeps' budgets, the deepest cut from 100 to 30 to keep the smoke
#: within about half its time limit as phases join it (the timed runs keep
#: ``PGD_TIMED_ITERS``)
PGD_ITERS = (1, 7, 30)
#: iterations of the kernels' and plain versions' timed runs beside the main
#: shape's budget
PGD_TIMED_ITERS = 100
#: what the sweep covers: every loss strategy, the three constraints_optim,
#: targeted, both norms and every history layout. Each runs at every row
#: count for 1 and 7 iterations, and for 100 at PGD_ROWS[i % 9]
PGD_CONFIGS = (
    dict(loss_evaluation="flip", norm=2),
    dict(loss_evaluation="constraints", norm=np.inf, record_loss="reduced"),
    dict(loss_evaluation="constraints+flip", norm=2, record_loss="full", record_grad_norm=True),
    dict(loss_evaluation="constraints+flip+alternate", constraints_optim="alt_constraints", norm=np.inf,
         record_loss="full"),
    dict(loss_evaluation="constraints+flip+constraints", constraints_optim="single_constraints", ctr_id=3, norm=2,
         targeted=True),
    dict(loss_evaluation="constraints+flip+manual", norm=np.inf, record_loss="reduced", record_grad_norm=True),
    dict(loss_evaluation="constraints+flip+adaptive_eps_step", norm=2, targeted=True, record_loss="reduced"),
    dict(loss_evaluation="constraints+flip+adaptive_eps_step+repair", norm=2, record_loss="full"),
    dict(loss_evaluation="flip+repair", norm=np.inf, constraints_optim="alt_constraints"),
    dict(loss_evaluation="constraints+flip+adaptive_eps_step+repair", norm=np.inf,
         constraints_optim="single_constraints", ctr_id=0, record_loss="full", record_grad_norm=True),
)
#: the main shape: config/rq1.lcld.yaml's PGD on LCLD (4000 states, L2,
#: ε 0.2, budget 1000, its last loss), run as experiments/pgd.py runs it
PGD_STATES = 4000
PGD_BUDGET = 1000
PGD_EPS = 0.2
PGD_LOSS = "constraints+flip+adaptive_eps_step+repair"
#: rq1's other PGD losses (flip+sat runs as flip on the card), timed at 100
PGD_OTHER_LOSSES = ("flip", "constraints+flip", "constraints+flip+adaptive_eps_step")
#: card against CPU: rows and iterations
PGD_CPU_ROWS = 256
PGD_CPU_ITERS = 100
#: operations of K7 per row and iteration counted from its source, besides
#: 4 per weight of the stack (a multiply and an add, forward and backward):
#: 25 float32 ones per feature (unscaling, the cotangents' sum, masking,
#: conditioning, the step, the clips, the projection, repair's round trip),
#: 250 per row (the cross-entropy, the ten terms and their backward, the
#: sums' roots, repair's installment and one-hot groups) and 7 float64 pow,
#: log and exp, counted as one operation each at the fp64 peak
PGD_OPS_PER_FEATURE = 25
PGD_OPS_PER_ROW = 250
PGD_F64_PER_ROW = 7
#: K7's dependent operations per iteration besides the stack's sums (the
#: forward's over each layer's inputs, the backward's over its outputs) and
#: the two L2 sums over the features, counted from its source, with a
#: float64 pow, exp or log as one: the cross-entropy (12), the gradient's
#: last add, mask and square (3), the two roots with their add (2), the
#: step with its clip and square (7), the projection factor's add, division
#: and min (4, its root counted above), the projection with its clip and
#: unscaling (6), repair (the longest of its parallel parts: a one-hot
#: group's 14 compares and 2 more, 16) and its round trip (4)
PGD_LCLD_CHAIN_PER_ITER = 54


def pgd_edge_starts(rng, xs: np.ndarray, scaler) -> np.ndarray:
    """Starts (N, 47) float32: the rows ``xs`` perturbed and clipped, the
    first 14 at the backward's edges (unscaled values exact in float32): 0
    denominators (x6 alone and with x0, x14 alone and with x10, x22, x11 with
    x16 and x22, x11 alone), a term exactly at the tolerance (x10 - x14 and
    x16 - x11 equal to 1e-3), ±0 inside an abs (term 60 and 36), and
    features at the clip bounds (a row rounded to {0, 1}, a row of 0s, a
    row of 1s)."""
    from moeva2_ijcai22_replication_tpu_torch.problems import scaled_preimage

    sc, mn = scaler.scale.astype(np.float32), scaler.min_.astype(np.float32)
    st = np.clip(xs + rng.normal(scale=0.03, size=xs.shape), 0.0, 1.0).astype(np.float32)
    for row, feats in enumerate(([6], [0, 6], [14], [10, 14], [22], [11, 16, 22], [11], [14], [11])):
        st[row, feats] = mn[feats]  # unscales to exactly 0
    st[7, 10] = scaled_preimage(1e-3, 10, sc, mn)
    st[8, 16] = scaled_preimage(1e-3, 16, sc, mn)
    st[9, 1] = scaled_preimage(60.0, 1, sc, mn)
    st[10, 1] = scaled_preimage(36.0, 1, sc, mn)
    st[11] = np.round(st[11])
    st[12], st[13] = 0.0, 1.0
    u = (st[:14] - mn) / sc
    assert u[7, 10] - u[7, 14] == np.float32(1e-3) and u[9, 1] == 60 and u[10, 1] == 36
    return st


def pgd_problem():
    """PGD's problem: ``PGD_STATES`` synthetic LCLD states, the seeded
    surrogate and its scaler (``tests/test_torch_engine.py::_scaler``)."""
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

    with tempfile.TemporaryDirectory() as tmp:
        return synthetic_lcld_problem(tmp, PGD_STATES)


def surrogate_labels(sur, xs: np.ndarray) -> np.ndarray:
    """The surrogate's own classes of the scaled rows (ART's labels when
    none are given), on the CPU in the surrogate's float32."""
    import torch

    with torch.inference_mode():
        return sur.predict_proba(torch.as_tensor(xs, dtype=torch.float32)).argmax(-1).numpy()


def pgd_sweep(device, kernel: str, cons, sur, scaler, xs: np.ndarray, starts: np.ndarray, rows: tuple,
              configs: tuple = PGD_CONFIGS, iters: tuple = PGD_ITERS):
    """The PGD kernel ``kernel`` (``pgd_lcld`` or ``pgd_botnet``) against
    ``pgd_run_plain`` on the card, bit for bit (x_adv, the class at x_adv,
    the history), over ``configs`` x ``rows`` x ``iters``, the last
    budget at one row count per configuration; labels alternate 0 and 1.
    A row's run depends on no other row, so the plain version runs once per
    configuration and budget, on the most rows, and each launch is held
    against its first N (as ``autopgd_sweep`` does).
    Returns (runs, NaN rows of x_adv, NaN history entries) and the labels."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.core.norms import is_inf

    launch = getattr(kernels, kernel)
    xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
    st = torch.as_tensor(starts, device=device)
    y = torch.as_tensor(np.arange(len(xs)) % 2, device=device)
    runs, nan_rows, nan_hist = 0, 0, 0
    for ci, knobs in enumerate(configs):
        eps = 0.2 if knobs["norm"] == 2 else 0.1
        atk = ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, device=device, **knobs)
        repair, linf = "repair" in atk.loss_evaluation, is_inf(atk.norm)
        for t in iters:
            ns = [rows[ci % len(rows)]] if t == iters[-1] else list(rows)
            sched = atk.schedule(eps, 0.1, t)
            m = max(ns)
            want = pgd_run_plain(atk.tables, cons, sched, xi[:m], y[:m], st[:m], eps, atk.clip, atk.norm, repair,
                                 atk.targeted, atk.history_layout())
            for n in ns:
                got = launch(atk.tables, sched, xi[:n], y[:n], st[:n], eps, atk.clip, linf, repair, atk.targeted,
                             atk.history_layout())
                what = f"{kernel} {atk.loss_evaluation} {atk.constraints_optim} norm={atk.norm} N={n} T={t}"
                for name, g, w in zip(("x_adv", "pred", "hist"), got, want):
                    if (g is None) != (w is None):
                        raise AssertionError(f"{what}: {name} is {g} on the card, {w} in the plain version")
                    if g is not None:
                        hold_equal(g, w[:, :n] if name == "hist" else w[:n], f"{what} {name}")
                runs += 1
                nan_rows += int(torch.isnan(got[0]).any(1).sum())
                nan_hist += 0 if got[2] is None else int(torch.isnan(got[2]).sum())
    return (runs, nan_rows, nan_hist), y


def edge_gradient(device, cons, sur, scaler, starts, y):
    """(NaN, inf) entries of the first iteration's gradient at the edge
    starts (``constraints+flip``): the edges must reach it."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import grad_and_terms_plain

    atk = ConstrainedPGD(sur, cons, scaler, loss_evaluation="constraints+flip", device=device)
    sched = atk.schedule(0.2, 0.1, 1)
    st = torch.as_tensor(starts, device=device)
    grad = grad_and_terms_plain(atk.tables, cons, st, y[:len(st)], sched.w_class[0], sched.w_cons[0], -1, False)[0]
    nan_grad, inf_grad = int(torch.isnan(grad).sum()), int(torch.isinf(grad).sum())
    if not nan_grad:
        raise AssertionError("the edge starts give no NaN gradient entry")
    return nan_grad, inf_grad


def check_pgd_kernel(device, problem):
    """K7 against ``pgd_run_plain`` on the card over the sweep, bit for bit."""
    cons, sur, scaler, x = problem
    rng = np.random.default_rng(5)
    xs = scaler.transform(x).astype(np.float32)
    starts = pgd_edge_starts(rng, xs, scaler)
    n = max(PGD_ROWS)
    xs, starts = np.resize(xs, (n, xs.shape[1])), np.resize(starts, (n, xs.shape[1]))
    (runs, nan_rows, nan_hist), y = pgd_sweep(device, "pgd_lcld", cons, sur, scaler, xs, starts, PGD_ROWS)
    nan_grad, _ = edge_gradient(device, cons, sur, scaler, starts[:14], y)
    log(f"[pgd] pgd_lcld equals pgd_run_plain (x_adv, class, history) on all {runs} runs: {len(PGD_CONFIGS)} "
        f"configurations x N in {PGD_ROWS} x T in {PGD_ITERS[:-1]}, and T = {PGD_ITERS[-1]} at one N each; "
        f"{nan_grad} NaN gradient entries at the 14 edge starts, {nan_rows} NaN rows of x_adv, {nan_hist} NaN "
        "history entries")
    from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld_schema

    with tempfile.TemporaryDirectory() as tmp:
        check_immutable_repair(device, "[pgd]", synth_lcld_schema(f"{tmp}/base"), sur, scaler, x, starts, first=14)


#: K7's round trip after a repair that rewrites an immutable feature (ROADMAP
#: C6): the configurations of ``PGD_CONFIGS`` that repair, at these row counts
#: (a lone row, a block of one row each, two rows a block, the main shape)
IMMUTABLE_REPAIR_CONFIGS = tuple(c for c in PGD_CONFIGS if "repair" in c["loss_evaluation"])
IMMUTABLE_REPAIR_ROWS = (1, 33, 133, 4000)


def check_immutable_repair(device, tag: str, paths: dict, sur, scaler, x: np.ndarray, starts: np.ndarray,
                           first: int) -> None:
    """K7 against ``pgd_run_plain`` on the card, bit for bit, on a copy of
    the schema ``paths`` that marks term immutable
    (``problems.lcld_immutable_term_schema``), with the four rows from
    ``first`` on of the states and of ``starts`` holding a term off {36, 60}
    (``problems.lcld_immutable_repair_rows``), over the configurations that
    repair: each repair rewrites the immutable term, which x keeps and from
    which the next iteration unscales u. Fails unless the final rows'
    repair still rewrites it."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.domains import get_constraints_class
    from moeva2_ijcai22_replication_tpu_torch.problems import (
        LCLD_IMMUTABLE_FEATURE, LCLD_IMMUTABLE_TERMS, lcld_immutable_repair_rows, lcld_immutable_term_schema,
    )

    with tempfile.TemporaryDirectory() as tmp:
        imm = lcld_immutable_term_schema(paths, tmp)
        cons = get_constraints_class("lcld_augmented" if x.shape[1] > 47 else "lcld")(imm["features"],
                                                                                      imm["constraints"])
    k, n_edge = LCLD_IMMUTABLE_FEATURE, len(LCLD_IMMUTABLE_TERMS)
    xs = scaler.transform(x).astype(np.float32)
    xs[first:first + n_edge] = lcld_immutable_repair_rows(x[first:first + n_edge], scaler)
    st = np.array(starts[:len(xs)], np.float32)
    st[first:first + n_edge, k] = xs[first:first + n_edge, k]
    n = max(IMMUTABLE_REPAIR_ROWS)
    xs, st = np.resize(xs, (n, xs.shape[1])), np.resize(st, (n, xs.shape[1]))
    (runs, _, _), y = pgd_sweep(device, "pgd_lcld", cons, sur, scaler, xs, st, IMMUTABLE_REPAIR_ROWS,
                                IMMUTABLE_REPAIR_CONFIGS)
    atk = ConstrainedPGD(sur, cons, scaler, eps=0.2, eps_step=0.1, device=device, **IMMUTABLE_REPAIR_CONFIGS[0])
    rows = torch.as_tensor(xs[first:first + n_edge], device=device)
    x_adv, _, _ = pgd_run_plain(atk.tables, cons, atk.schedule(0.2, 0.1, PGD_ITERS[-1]), rows,
                                y[first:first + n_edge], torch.as_tensor(st[first:first + n_edge], device=device),
                                0.2, atk.clip, atk.norm, True, False, None)
    u = (x_adv - atk.tables.min_) / atk.tables.scale
    rewritten = int((cons.repair(u)[:, k] != u[:, k]).sum())
    if rewritten != n_edge or atk.tables.mutable[k]:
        raise AssertionError(f"{tag} the immutable-repair rows: repair rewrites term on {rewritten} of {n_edge}")
    log(f"{tag} pgd_lcld at D = {x.shape[1]} equals pgd_run_plain on all {runs} runs with term immutable (ROADMAP "
        f"C6): the {len(IMMUTABLE_REPAIR_CONFIGS)} repairing configurations x N in {IMMUTABLE_REPAIR_ROWS}, with "
        f"rows {first}..{first + n_edge - 1} at terms {LCLD_IMMUTABLE_TERMS}, whose repair rewrites term on every "
        f"iteration ({rewritten} of {n_edge} after {PGD_ITERS[-1]})")


def pgd_work(tables, n: int, t: int, hist_cols: int = 0):
    """K7's work for ``n`` rows and ``t`` iterations: (bytes it must move,
    float32 operations, float64 operations), counted from its source."""
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    d = widths[0]
    n_bytes = 4 * 3 * n * d + 16 * n + 4 * tables.params.numel() + 12 * d + 16 * t + 4 * t * n * hist_cols
    n_ops = n * t * (4 * macs + PGD_OPS_PER_FEATURE * d + PGD_OPS_PER_ROW)
    return n_bytes, n_ops, n * t * PGD_F64_PER_ROW


def pgd_bound(tables, n: int, t: int, hist_cols: int = 0):
    """K7's least time for ``n`` rows and ``t`` iterations: the bytes it
    must move and the operations counted from its source."""
    return bound_ms(*pgd_work(tables, n, t, hist_cols))


def pgd_no_fma_ms(tables, n: int, t: int) -> float:
    """K7's operations with every float32 one at half the fp32 peak (a
    multiply-add is two instructions without FMA), the float64 ones at the
    fp64 peak."""
    _, n_ops, n_f64 = pgd_work(tables, n, t)
    return (n_ops / (PEAK_F32_OPS_S / 2) + n_f64 / PEAK_F64_OPS_S) * 1e3


def pgd_lcld_floor_ms(tables, t: int, mhz: float, l2: bool = True) -> float:
    """K7's latency floor for ``t`` iterations counted from its source: the
    dependent operations of an iteration's longest path (each unit's sum
    over its layer's inputs, each input's backward sum over the layer's
    outputs, the two L2 sums over the features and
    ``PGD_LCLD_CHAIN_PER_ITER`` more), each at ``CYCLES_PER_DEPENDENT_OP``
    cycles of the card's maximum SM clock."""
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    chain = sum(widths[:-1]) + sum(widths[1:]) + (2 * widths[0] if l2 else 0) + PGD_LCLD_CHAIN_PER_ITER
    return t * chain * CYCLES_PER_DEPENDENT_OP / (mhz * 1e6) * 1e3


def pgd_kernel_record(device, tag: str, kernel: str, replaces: str, problem, eps: float, plain_iters: int, bound):
    """The PGD kernel ``kernel``'s record at ``problem``'s states x
    ``PGD_BUDGET`` iterations (``PGD_LOSS``, L2, from x_init): device ms
    (CUDA events around a CUDA graph of 2 launches), wrapper ms, the plain
    version at ``plain_iters`` iterations, the bound ``bound(tables)``
    gives as ``(ms, by)``; and the kernel at 100 iterations for each rq1
    loss. Returns it and the attack."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain

    cons, sur, scaler, _, xs, y = problem
    launch = getattr(kernels, kernel)
    xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, device=device)

    def engine(loss):
        return ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, norm=2, loss_evaluation=loss, device=device)

    def kernel_fn(a, t):
        sched = a.schedule(eps, 0.1, t)
        return lambda: launch(a.tables, sched, xi, yt, xi, eps, a.clip, False, "repair" in a.loss_evaluation, False)

    atk = engine(PGD_LOSS)
    main = kernel_fn(atk, PGD_BUDGET)
    sched_plain = atk.schedule(eps, 0.1, plain_iters)
    b_ms, b_by = bound(atk.tables)
    rec = {
        "name": kernel,
        "route": "cuda",
        "source": f"moeva2_ijcai22_replication_tpu_torch/kernels/csrc/{kernel}.cu",
        "replaces": replaces,
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": graph_ms(main, launches=2, repeats=3),
        "wrapper_ms": cuda_ms(main, launches=2, repeats=3),
        "plain_ms": cuda_ms(lambda: pgd_run_plain(atk.tables, cons, sched_plain, xi, yt, xi, eps, atk.clip, 2, True,
                                                  False), launches=1, repeats=2),
        "plain_iters": plain_iters,
        "ms_100_iters": {PGD_LOSS: graph_ms(kernel_fn(atk, PGD_TIMED_ITERS), launches=5, repeats=3)},
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    for loss in PGD_OTHER_LOSSES:
        rec["ms_100_iters"][loss] = graph_ms(kernel_fn(engine(loss), PGD_TIMED_ITERS), launches=5, repeats=3)
    log(f"{tag} {kernel} at {len(xs)} states x {PGD_BUDGET} iterations ({PGD_LOSS}, L2): device {rec['ms']:.3f} ms, "
        f"through the wrapper {rec['wrapper_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); plain version at "
        f"{plain_iters} iterations {rec['plain_ms']:.1f} ms")
    log(f"{tag} {kernel} at {len(xs)} states x {PGD_TIMED_ITERS} iterations, device ms by loss: "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["ms_100_iters"].items()))
    return rec, atk


def time_pgd(device, problem):
    """K7's record at the main shape (4000 x 1000), the plain version at 100
    iterations, and beside the bound its two ceilings: the no-FMA one
    (``pgd_no_fma_ms``) and the latency floor (``pgd_lcld_floor_ms``);
    ``ceiling_ms`` is the larger."""
    cons, sur, scaler, x = problem
    xs = scaler.transform(x)
    rec, atk = pgd_kernel_record(device, "[pgd]", "pgd_lcld",
                                 "moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py:241",
                                 (cons, sur, scaler, x, xs, surrogate_labels(sur, xs)), PGD_EPS - 1e-6,
                                 PGD_TIMED_ITERS, lambda tables: pgd_bound(tables, len(xs), PGD_BUDGET))
    mhz = max_sm_clock_mhz()
    rec["no_fma_ms"] = pgd_no_fma_ms(atk.tables, len(xs), PGD_BUDGET)
    rec["latency_floor_ms"] = pgd_lcld_floor_ms(atk.tables, PGD_BUDGET, mhz)
    rec["ceiling_ms"] = max(rec["no_fma_ms"], rec["latency_floor_ms"])
    log(f"[pgd] pgd_lcld's no-FMA ceiling {rec['no_fma_ms']:.4f} ms, latency floor {rec['latency_floor_ms']:.4f} ms "
        f"(at {mhz:.0f} MHz); device time {rec['ms'] / rec['ceiling_ms']:.2f}x the larger, "
        f"{rec['ms'] / rec['bound_ms']:.2f}x the bound")
    return rec


def same_entries_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a == b) | (np.isnan(a) & np.isnan(b))


def drive_pgd(device, smi: str, tag: str, kernel: str, problem, eps: float, f1: float, rewritten,
              loss: str = PGD_LOSS) -> dict:
    """Drive ``ConstrainedPGD.generate`` as ``experiments/pgd.py:149-186``
    does at ``eps`` (``loss``, L2, ``PGD_BUDGET`` iterations) cold and
    steady, with the launch counts set to 0 just before and read just
    after: one launch of ``kernel``. Check the result (finite, immutables
    unchanged, two runs equal, the L2 ball on the features that repair
    leaves alone, those not in the mask ``rewritten``) and judge it (o1..o7
    at ``f1`` and f2 ε). Returns the launch counts."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD, round_ints_toward_initial

    cons, sur, scaler, x, xs, y = problem
    knobs = dict(eps=eps, eps_step=0.1, max_iter=PGD_BUDGET, norm=2, loss_evaluation=loss)
    atk = ConstrainedPGD(sur, cons, scaler, device=device, **knobs)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_adv = atk.generate(xs, y, eps=eps - 1e-6, eps_step=0.1, max_iter=PGD_BUDGET)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    again = atk.generate(xs, y, eps=eps - 1e-6, eps_step=0.1, max_iter=PGD_BUDGET)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    log(f"{tag} launches on the PGD path: {launches}")
    log(f"{tag} generate: cold {cold_s:.3f} s, steady {steady_s:.3f} s for {len(xs)} states x {PGD_BUDGET} "
        f"iterations on {smi}")
    if launches != {**{k: 0 for k in launches}, kernel: 1}:
        raise AssertionError(f"launches {launches}: one generate without restarts is one launch of {kernel}")
    if not same_entries_np(x_adv, again).all():
        raise AssertionError("two runs of generate differ")
    x0 = xs.astype(np.float32)
    if x_adv.shape != xs.shape or x_adv.dtype != np.float32 or not np.isfinite(x_adv).all():
        raise AssertionError(f"x_adv {x_adv.dtype} {x_adv.shape}, {int((~np.isfinite(x_adv)).sum())} non-finite")
    mutable = np.asarray(cons.get_mutable_mask(), bool)
    if not np.array_equal(x_adv[:, ~mutable], x0[:, ~mutable]):
        raise AssertionError("immutable features moved")
    delta = x_adv.astype(np.float64) - x0
    kept = np.sqrt((delta[:, ~rewritten] ** 2).sum(1))
    full = np.sqrt((delta**2).sum(1))
    if kept.max() > eps + 1e-5:
        raise AssertionError(f"L2 distance {kept.max()} > ε on the features repair leaves alone")
    log(f"{tag} x_adv {x_adv.shape} float32, finite, immutables unchanged, two runs equal; L2 distance over the "
        f"features repair leaves alone at most {kept.max():.6f} (ε {eps}), over all features at most "
        f"{full.max():.6f} with {float((full <= eps + 1e-5).mean()):.4f} of the rows within ε")
    x_attacks = round_ints_toward_initial(scaler.inverse(x_adv.astype(np.float64)), x, cons.get_feature_type())
    calc = ObjectiveCalculator(classifier=sur, constraints=cons, thresholds={"f1": f1, "f2": eps},
                               min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=2)
    rates = calc.success_rate_3d(x, x_attacks[:, None, :])
    if rates.shape != (7,) or not np.isfinite(rates).all():
        raise AssertionError(f"bad success rates {rates}")
    log(f"{tag} success rates o1..o7 (f1 {f1}, f2 ε; plumbing check with an untrained surrogate): "
        + " ".join(f"{v:.4f}" for v in rates))
    return launches


def check_pgd_card_vs_cpu(device, tag: str, kernel: str, problem, eps: float, n: int, t: int,
                          loss: str = PGD_LOSS) -> None:
    """``generate`` on the card against the CPU on ``n`` states x ``t``
    iterations at ``loss`` (every x_adv entry equal), and 2 random restarts
    on the card: 2 launches of ``kernel``."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD

    cons, sur, scaler, _, xs, y = problem
    small = dict(eps=eps, eps_step=0.1, max_iter=t, norm=2, loss_evaluation=loss)
    on_cpu = ConstrainedPGD(sur, cons, scaler, device="cpu", **small).generate(xs[:n], y[:n], eps=eps - 1e-6)
    on_card = ConstrainedPGD(sur, cons, scaler, device=device, **small).generate(xs[:n], y[:n], eps=eps - 1e-6)
    differ = int((~same_entries_np(on_card, on_cpu)).sum())
    log(f"{tag} card vs CPU at {n} states x {t} iterations: {differ} of {on_cpu.size} x_adv entries differ")
    if differ:
        raise AssertionError(f"{differ} x_adv entries differ between the card and the CPU")
    kernels.reset_launch_counts()
    restarts = ConstrainedPGD(sur, cons, scaler, device=device, num_random_init=2, **small)
    restarts.generate(xs[:n], y[:n], eps=eps - 1e-6)
    got = kernels.launch_counts()[kernel]
    log(f"{tag} 2 random restarts at {n} states: {got} launches of {kernel}, success after each restart "
        f"{restarts.quality_history['restart_flip_frac']}")
    if got != 2:
        raise AssertionError(f"{got} launches of {kernel} for 2 restarts")


def lcld_repair_rewrites(cons, loss: str, d: int) -> np.ndarray:
    """(d,) the features LCLD's repair rewrites after the projection under
    ``loss``, none without repair: term, installment, the one-hot groups
    and, on the augmented domain, the pairs' features past the 47th; the
    ball holds on every other feature."""
    rewritten = np.zeros(d, bool)
    if "repair" in loss:
        rewritten[[1, 3]] = True
        rewritten[47:] = True
        for group in cons.schema.ohe_groups():
            rewritten[list(group)] = True
    return rewritten


def run_pgd_path(device, problem, smi: str) -> dict:
    """Phase 7's drive: ``generate`` at the main shape, card against CPU,
    restarts; returns the launch counts of the drive."""
    cons, sur, scaler, x = problem
    xs = scaler.transform(x)
    atk_problem = (cons, sur, scaler, x, xs, surrogate_labels(sur, xs))
    launches = drive_pgd(device, smi, "[pgd]", "pgd_lcld", atk_problem, PGD_EPS, 0.25,
                         lcld_repair_rewrites(cons, PGD_LOSS, x.shape[1]))
    check_pgd_card_vs_cpu(device, "[pgd]", "pgd_lcld", atk_problem, PGD_EPS, PGD_CPU_ROWS, PGD_CPU_ITERS)
    return launches


# -- phase 8: MoEvA2 on botnet ----------------------------------------------------

#: config/rq1.botnet.yaml's run with config/moeva.yaml's engine: 387 states,
#: L2, seed 42, pop 200 (P = 203, M = 303, R = 203), 100 offspring, archive
#: 24, in chunks of 256 and 131 states
BOTNET_STATES = 387
BOTNET_KNOBS = dict(norm=2, n_gen=1000, n_pop=200, n_offsprings=100, archive_size=24, seed=42,
                    max_states_per_call=256)
#: judged as rq1.botnet: f1 0.5, f2 (ε) 4
BOTNET_THRESHOLDS = {"f1": 0.5, "f2": 4.0}
#: K8's sweep: state counts (rq1.botnet's, its second chunk's, 1000) at the
#: offspring's and the population's row counts
BOTNET_SWEEP_STATES = (387, 131, 1000)
BOTNET_SWEEP_ROWS = (100, 203)
#: K8's tile edges (S, N): a partial last tile, fewer rows than a tile,
#: tiles that span states of both classes; each under L2 and L-inf
BOTNET_EDGES = ((3, 100), (1, 7), (5, 27))
#: other stacks K8 is held on: (hidden widths, classes, norm, scaled)
BOTNET_STACKS = (((64, 64, 32), 1, 2, True), ((64, 64, 32), 2, "inf", False), ((16, 64, 48, 5), 2, 2, True))
#: state counts at which K5, K4b, K2, K4a and K3 are held at botnet's L = 756
#: and (M, R) = (303, 203)
BOTNET_STAGE_STATES = (387, 131)
#: the state counts the botnet generate path launches its kernels at: the
#: chunks max_states_per_call: 256 makes of 387 states
BOTNET_PATH_STATES = (256, 131)
#: states of the card-vs-CPU stage check
BOTNET_STEP_STATES = 4
#: float32 operations of K8 per row besides the stack's 2 per weight: 8 per
#: feature (decode, scaler, the min-max difference and its square and sum)
#: and 20 for the softmax; per gathered flow or bytes feature 1 (its add),
#: per ratio 3 (compare, divide, subtract), per ordering 1, per term 2 (the
#: threshold and the sum)
BOTNET_OPS_PER_FEATURE = 8
BOTNET_OPS_PER_ROW = 20


def botnet_problem():
    """Phase 8's problem: ``synth_botnet(387, seed=42)`` with the seeded
    64-64-32-2 surrogate and its scaler, and 1000 more states (seed 43) for
    the kernel sweep."""
    from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_botnet
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_problem

    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = synthetic_botnet_problem(tmp, BOTNET_STATES)
    return cons, sur, scaler, x, synth_botnet(max(BOTNET_SWEEP_STATES), cons.schema, seed=43)


def botnet_candidates(gen, moeva, run, n: int):
    """(S, N, L) genes uniform in the states' bounds, with the terms' edge
    cases (``problems.botnet_hard_candidates``); on the augmented domain
    also the pair terms' edge rows (``problems.botnet_augmented_edge_rows``
    of the first states) on every ninth candidate from the first, which the
    base terms' edges leave alone."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
    from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetAugmentedConstraints
    from moeva2_ijcai22_replication_tpu_torch.problems import (
        BOTNET_AUGMENTED_EDGE_ROWS, botnet_augmented_edge_rows, botnet_hard_candidates,
    )

    s, l = run.xl_gen.shape
    u = torch.rand((s, n, l), generator=gen, device=run.xl_gen.device)
    cand = run.xl_gen[:, None] + u * (run.xu_gen - run.xl_gen)[:, None]
    cand = botnet_hard_candidates(moeva.codec, moeva.constraints.schema.names, cand)
    cons = moeva.constraints
    if isinstance(cons, BotnetAugmentedConstraints):
        x0 = run.x_init_ml.cpu().numpy()
        rows = botnet_augmented_edge_rows(np.resize(x0, (BOTNET_AUGMENTED_EDGE_ROWS, x0.shape[1])),
                                          cons.important_features)
        at = list(range(0, n, 9))[:BOTNET_AUGMENTED_EDGE_ROWS]
        cand[:, at] = codec_lib.ml_to_genetic(moeva.codec, torch.as_tensor(rows[:len(at)], device=cand.device))
    return cand


def check_botnet_kernel(device, moeva, x_sweep, gen, tag: str = "[botnet]"):
    """K8 against ``evaluate_plain`` on the card, bit for bit: the sweep, the
    tile edges under both norms, and other stacks and heads, over
    ``moeva``'s constraint set (its edge rows among the candidates,
    ``botnet_candidates``)."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_plain, make_objective_tables
    from moeva2_ijcai22_replication_tpu_torch.models.mlp import MLP

    codec, cons, obj = moeva.codec, moeva.constraints, moeva._objective
    linf = make_objective_tables(codec, moeva._model, obj.scaler, "inf", cons.tol, obj.cons)

    def hold(run, cand, tables, what):
        got = kernels.objective_botnet(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                       run.minimize_class, tables)
        hold_equal(got, evaluate_plain(tables, codec, run, cand, cons), f"objective_botnet {what}")
        return int((~got.isfinite()).any(-1).sum())

    nonfinite = 0
    for s in BOTNET_SWEEP_STATES:
        run = moeva.prepare(x_sweep[:s], np.arange(s) % 2)
        for n in BOTNET_SWEEP_ROWS:
            nonfinite += hold(run, botnet_candidates(gen, moeva, run, n), obj, f"S={s} N={n}")
    for s, n in BOTNET_EDGES:
        run = moeva.prepare(x_sweep[:s], np.arange(s) % 2)
        cand = botnet_candidates(gen, moeva, run, n)
        for norm, tables in ((2, obj), ("inf", linf)):
            nonfinite += hold(run, cand, tables, f"S={s} N={n} norm={norm}")
    run = moeva.prepare(x_sweep[:40], np.arange(40) % 2)
    cand = botnet_candidates(gen, moeva, run, 100)
    for hidden, head, norm, scaled in BOTNET_STACKS:
        model = MLP(codec.n_features, hidden, head).reset_parameters_seeded(7).to(device).eval().requires_grad_(False)
        tables = make_objective_tables(codec, model, obj.scaler if scaled else None, norm, cons.tol, obj.cons)
        nonfinite += hold(run, cand, tables, f"{hidden} head {head} norm={norm} scaled={scaled}")
    log(f"{tag} objective_botnet at D = {codec.n_features} ({cons.n_constraints} terms) equals evaluate_plain on "
        f"every entry: S in {BOTNET_SWEEP_STATES} x N in "
        f"{BOTNET_SWEEP_ROWS}; (S, N) in {BOTNET_EDGES} under L2 and L-inf; stacks (hidden, classes, norm, "
        f"scaled) {BOTNET_STACKS}; {nonfinite} rows with a non-finite objective (the terms' edge cases)")


def botnet_stage_inputs(device, moeva, x_sweep, gen, rng, s: int) -> dict:
    """K5's, K2's, K4a's, K3's and K4b's inputs at botnet's L = 756 and
    (M, R) = (303, 203) for ``s`` states: a population in the states'
    bounds, offspring draws and K5's offspring, sweep objectives and their
    ranks, two steps of the plain normalisation, K3's association, tied
    gumbels and the archive."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import draw_offspring
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import NormState, survive_norm_plain

    p, n_off, a = moeva.pop_size, moeva.n_offsprings, moeva.archive_size
    m, r, l = p + n_off, moeva.n_dirs, moeva.codec.gen_length
    run = moeva.prepare(x_sweep[:s], np.arange(s) % 2)
    pop, xl, xu = sweep_population(gen, run, moeva.codec, s, p)
    draws = draw_offspring(stream_of(gen), s, p, n_off, l)
    off = kernels.offspring(moeva.tables, pop, xl, xu, n_off, draws)
    f = torch.as_tensor(sweep_objectives(rng, s, m), device=device)
    ranks = nd_ranks_plain(f, p)
    states = [NormState.init(s, 3, device=device)]
    for _ in range(2):
        new_state, nadir, dirs = survive_norm_plain(f, ranks, moeva.asp_points, states[-1])
        states.append(new_state)
    niche, dist = kernels.associate(f, dirs, states[-1].ideal, nadir)
    gum_cut = torch.rand((s, r), generator=gen, device=device)
    gum_mem = torch.rand((s, m), generator=gen, device=device)
    gum_cut[:, ::3] = 0.25
    return dict(pop=pop, xl=xl, xu=xu, draws=draws, off=off, f=f, ranks=ranks, states=states, nadir=nadir,
                dirs=dirs, niche=niche, dist=dist, fill_args=(gum_cut, gum_mem, ranks, niche, dist, p),
                extract=(pop, off, f[:, :p], f[:, p:]), archive=(pop[:, :a], f[:, :a], off, f[:, p:], a))


def check_botnet_stages(device, moeva, x_sweep, gen, rng):
    """K5, K2, K4a, K3 and K4b at botnet's L = 756 and (M, R) = (303, 203),
    bit for bit against their plain versions."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import extract_archive_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import make_offspring_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import (
        associate_plain, survive_fill_plain, survive_norm_plain,
    )

    p, m, r, l = moeva.pop_size, moeva.pop_size + moeva.n_offsprings, moeva.n_dirs, moeva.codec.gen_length
    for s in BOTNET_STAGE_STATES:
        t = botnet_stage_inputs(device, moeva, x_sweep, gen, rng, s)
        hold_equal(t["off"], make_offspring_plain(moeva.tables, t["pop"], t["xl"], t["xu"], moeva.n_offsprings,
                                                  t["draws"]), f"offspring S={s} L={l}")
        for stop in (p, m):
            hold_equal(kernels.nd_peel(t["f"], stop), nd_ranks_plain(t["f"], stop), f"nd_peel S={s} M={m} n_stop={stop}")
        for step, (state, new_state) in enumerate(zip(t["states"][:-1], t["states"][1:])):
            got = kernels.survive_norm(t["f"], t["ranks"], moeva.asp_points, state)
            _, nadir, dirs = survive_norm_plain(t["f"], t["ranks"], moeva.asp_points, state)
            for name, g, w in zip(("ideal", "worst", "extreme", "nadir", "dirs"), got, (*new_state, nadir, dirs)):
                hold_equal(g, w, f"survive_norm {name} S={s} M={m} R={r} step {step}")
        for name, g, w in zip(("niche", "dist"), (t["niche"], t["dist"]),
                              associate_plain(t["f"], t["dirs"], t["states"][-1].ideal, t["nadir"])):
            hold_equal(g, w, f"associate {name} S={s} M={m} R={r}")
        mask = survive_fill_plain(*t["fill_args"])
        want = (mask, *extract_archive_plain(mask, *t["extract"], *t["archive"][:2]))
        got = kernels.survive_fill(*t["fill_args"], extract=t["extract"], archive=t["archive"])
        for name, g, w in zip(("mask", "pop_x", "pop_f", "arch_x", "arch_f"), got, want):
            hold_equal(g, w, f"survive_fill {name} S={s} M={m} R={r} L={l}")
    log(f"[botnet] offspring, nd_peel, survive_norm, associate and survive_fill equal their plain versions at "
        f"L = {l}, (M, R) = ({m}, {r}), S in {BOTNET_STAGE_STATES}")


def time_botnet_stages(device, moeva, x_sweep, gen, rng, smi: str, tag: str = "[botnet]") -> dict:
    """K5's and K4b's device ms at the botnet path's shapes (L = 756, (M,
    R) = (303, 203), the two chunks of 256 and 131 states) beside their
    bounds on these inputs, counted from their sources as phase 3 counts
    them at LCLD's shape. Each is held bit for bit against its plain
    version on the inputs it is timed on."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import extract_archive_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import make_offspring_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import survive_fill_plain

    out = {"offspring": {}, "survive_fill": {}}
    m, r, l = moeva.pop_size + moeva.n_offsprings, moeva.n_dirs, moeva.codec.gen_length
    for s in BOTNET_PATH_STATES:
        t = botnet_stage_inputs(device, moeva, x_sweep, gen, rng, s)
        hold_equal(t["off"], make_offspring_plain(moeva.tables, t["pop"], t["xl"], t["xu"], moeva.n_offsprings,
                                                  t["draws"]), f"offspring S={s} L={l}")
        mask = survive_fill_plain(*t["fill_args"])
        want = (mask, *extract_archive_plain(mask, *t["extract"], *t["archive"][:2]))
        got = kernels.survive_fill(*t["fill_args"], extract=t["extract"], archive=t["archive"])
        for name, g, w in zip(("mask", "pop_x", "pop_f", "arch_x", "arch_f"), got, want):
            hold_equal(g, w, f"survive_fill {name} S={s} M={m} R={r} L={l}")
        off_bytes, off_ops, off_f64, _ = offspring_work(moeva.tables, t["pop"], t["xl"], t["xu"], moeva.n_offsprings,
                                                        t["draws"])
        fill_bytes, fill_ops = fill_work_bound(t["fill_args"], t["extract"], t["archive"])
        for name, fn, bound in (
            ("offspring", lambda: kernels.offspring(moeva.tables, t["pop"], t["xl"], t["xu"], moeva.n_offsprings,
                                                    t["draws"]), bound_ms(off_bytes, off_ops, off_f64)),
            ("survive_fill", lambda: kernels.survive_fill(*t["fill_args"], extract=t["extract"], archive=t["archive"]),
             bound_ms(fill_bytes, fill_ops, 0)),
        ):
            ms = graph_ms(fn)
            out[name][f"{s}x{l}"] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
            log(f"{tag} {name} at S={s} L={l} M={m} R={r}: equals its plain version; device {ms:.4f} ms, "
                f"bound {bound[0]:.5f} ms ({bound[1]}) on {smi}")
    return out


def botnet_bound(moeva, s: int, n: int):
    """K8's bytes and operations for S x N rows, counted from its source; on
    the augmented domain with the pair stage (``OBJECTIVE_OPS_PER_PAIR`` per
    pair, as K1's, and 16 bytes of tables)."""
    obj, cons = moeva._objective, moeva._objective.cons
    d, l = moeva.codec.n_features, moeva.codec.gen_length
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    c = cons.counts
    pairs = 0 if cons.pair_idx is None else cons.pair_idx.shape[0]
    n_base = 2 + c[4] + sum(c[6::2])
    term_ops = sum(c[:4]) + 3 * c[4] + sum(c[6::2]) + 2 * n_base + OBJECTIVE_OPS_PER_PAIR * pairs
    # the first layer is read from its transposed copy, the rest from params
    n_bytes = 4 * s * n * l + 16 * s * d + 8 * s + 4 * n_params + 16 * d + 4 * sum(c) + 16 * pairs + 12 * s * n
    n_ops = s * n * (2 * macs + BOTNET_OPS_PER_FEATURE * d + term_ops + BOTNET_OPS_PER_ROW)
    return n_bytes, n_ops


def time_botnet_kernel(device, moeva, x, gen, tag: str = "[botnet]", name: str = "objective_botnet",
                       replaces: str = "moeva2_ijcai22_replication_tpu/domains/botnet.py:111") -> dict:
    """K8's record (``name``) at the main path's shape (387 states x 100
    offspring): device, wrapper and plain ms, the bound and the no-FMA
    ceiling, and, as a note for the next redesign, ``torch.matmul`` of the
    first layer alone in fp32 with TF32 off; and its device ms at the
    generate path's chunks."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_plain

    s, n = len(x), moeva.n_offsprings
    run = moeva.prepare(x, np.ones(s, dtype=np.int64))
    cand = botnet_candidates(gen, moeva, run, n)
    obj = moeva._objective
    kfn = lambda: kernels.objective_botnet(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,  # noqa: E731
                                           run.minimize_class, obj)
    n_bytes, n_ops = botnet_bound(moeva, s, n)
    b_ms, b_by = bound_ms(n_bytes, n_ops, 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.rand((s * n, moeva.codec.n_features), generator=gen, device=device)
    matmul_ms = graph_ms(lambda: torch.matmul(a, obj.first_t))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    path_ms = {}
    for s_path in BOTNET_PATH_STATES:
        run_p = moeva.prepare(x[:s_path], np.ones(s_path, dtype=np.int64))
        cand_p = botnet_candidates(gen, moeva, run_p, n)
        kfn_p = lambda: kernels.objective_botnet(cand_p, run_p.x_init_ml, run_p.xl_ml, run_p.xu_ml,  # noqa: B023, E731
                                                 run_p.x_init_mm, run_p.minimize_class, obj)
        hold_equal(kfn_p(), evaluate_plain(obj, moeva.codec, run_p, cand_p, moeva.constraints),
                   f"objective_botnet S={s_path} N={n}")
        path_ms[f"{s_path}x{n}"] = graph_ms(kfn_p)
    rec = {
        "name": name,
        "route": "cuda",
        "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/objective_botnet.cu",
        "replaces": replaces,
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": graph_ms(kfn),
        "wrapper_ms": cuda_ms(kfn),
        "plain_ms": cuda_ms(lambda: evaluate_plain(obj, moeva.codec, run, cand, moeva.constraints),
                            launches=2, repeats=3),
        "bound_ms": b_ms,
        "bound_by": b_by,
        # without FMA contraction a multiply-add takes two instructions
        "ceiling_ms": n_ops / (PEAK_F32_OPS_S / 2) * 1e3,
        "library_ms": None,
        "first_layer_matmul_ms": matmul_ms,
        "ms_path_shapes": path_ms,
    }
    log(f"{tag} objective_botnet at D = {moeva.codec.n_features}, S={s} N={n}: device {rec['ms']:.4f} ms, through "
        "the wrapper "
        f"{rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, bound {b_ms:.5f} ms ({b_by}), no-FMA "
        f"ceiling {rec['ceiling_ms']:.5f} ms; torch.matmul of the first layer alone ({s * n} x "
        f"{moeva.codec.n_features}) @ ({moeva.codec.n_features} x {obj.first_t.shape[1]}), fp32, TF32 off: "
        f"{matmul_ms:.4f} ms (a note for the next redesign; the port does not call it)")
    log(f"{tag} objective_botnet at the generate path's launch shapes, equal to evaluate_plain on the inputs "
        f"timed: "
        + ", ".join(f"S x N = {k}: {v:.4f} ms" for k, v in path_ms.items()))
    return rec


def run_botnet(device, smi: str, resources: list):
    """Phase 8: MoEvA2 on the botnet domain. Returns K8's record, the launch
    counts of the botnet drive and K5's and K4b's times at its shapes."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator

    entries = [k for k in resources if k["kernel"].startswith("objective_botnet_kernel")]
    if not entries:
        raise AssertionError("the build's ptxas report has no entry for objective_botnet_kernel")
    for k in entries:
        log(f"[botnet] K8 ptxas: {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    cons, sur, scaler, x, x_sweep = botnet_problem()
    moeva = Moeva2(sur, cons, ml_scaler=scaler, device=device, **BOTNET_KNOBS)
    log(f"[botnet] Moeva2 on {BOTNET_STATES} synthetic botnet states ({cons.schema.n_features} features, "
        f"{cons.n_constraints} constraints): pop {moeva.pop_size}, {moeva.n_offsprings} offspring "
        f"(M={moeva.pop_size + moeva.n_offsprings}, R={moeva.n_dirs}), archive {moeva.archive_size}, "
        f"{moeva.n_gen} generations, chunks of {moeva.max_states_per_call}")
    gen = torch.Generator(device=device).manual_seed(8)
    check_botnet_kernel(device, moeva, x_sweep, gen)
    check_botnet_stages(device, moeva, x_sweep, gen, np.random.default_rng(8))
    rec = time_botnet_kernel(device, moeva, x, gen)
    stage_times = time_botnet_stages(device, moeva, x_sweep, gen, np.random.default_rng(9), smi)

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    again = moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    log(f"[botnet] launches on the botnet path: {launches}")
    log(f"[botnet] generate: cold {cold_s:.3f} s, steady {steady_s:.3f} s for {BOTNET_STATES} states x "
        f"{moeva.n_gen} generations on {smi}")
    check_launches(launches, expected_launches(moeva, BOTNET_STATES), "the botnet path")
    p = moeva.pop_size + moeva.archive_size
    if res.x_ml.shape != (BOTNET_STATES, p, cons.schema.n_features) or not np.isfinite(res.x_ml).all():
        raise AssertionError(f"x_ml {res.x_ml.shape}, {int((~np.isfinite(res.x_ml)).sum())} non-finite")
    if not np.array_equal(res.x_ml, again.x_ml):
        raise AssertionError("two runs of generate differ")
    frozen = ~cons.schema.mutable
    if not np.array_equal(res.x_ml[:, :, frozen], np.broadcast_to(x[:, None, frozen].astype(np.float32),
                                                                  res.x_ml[:, :, frozen].shape)):
        raise AssertionError("immutable features moved")
    moved = float((res.x_ml != x[:, None, :].astype(np.float32)).any(-1).mean())
    log(f"[botnet] x_ml {res.x_ml.shape}, finite, immutables unchanged ({int(frozen.sum())} immutable), two runs "
        f"equal, {moved:.3f} of candidates moved; {int((~np.isfinite(res.f)).any(-1).sum())} candidates with a "
        "non-finite objective")

    knobs = {**BOTNET_KNOBS, "n_gen": 3}
    moeva_cpu = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs)
    moeva_ref = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", dtype=torch.float64, **knobs)
    check_step_against_cpu(moeva, moeva_cpu, moeva_ref, x, device, tag="[botnet]", n_states=BOTNET_STEP_STATES)

    calc = ObjectiveCalculator(classifier=sur, constraints=cons, thresholds=dict(BOTNET_THRESHOLDS),
                               min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=2)
    rates = calc.success_rate_3d(x, res.x_ml)
    if rates.shape != (7,) or not np.isfinite(rates).all():
        raise AssertionError(f"bad success rates {rates}")
    log(f"[botnet] success rates o1..o7 (f1 {BOTNET_THRESHOLDS['f1']}, f2 {BOTNET_THRESHOLDS['f2']}; plumbing "
        "check with an untrained surrogate): " + " ".join(f"{v:.4f}" for v in rates))
    profile_generation(moeva, x, tag="[botnet profile]")
    return rec, launches, stage_times


# -- phase 9: constrained PGD on botnet --------------------------------------------

#: config/rq1.botnet.yaml's PGD (387 states, L2, ε 4, budget 1000, its last
#: loss), run as experiments/pgd.py runs it (ε - 1e-6, eps_step 0.1); and
#: config/rq0.botnet.yaml's ε 1.0
PGD_BOTNET_STATES = 387
PGD_BOTNET_EPS = 4.0
PGD_BOTNET_RQ0_EPS = 1.0
#: K7b's sweep: clusters of two CTAs, ceil(N / 66) rows each (66 clusters
#: resident on the H100), at most 6: a lone row; one row per cluster (31,
#: 33) up to 66, the largest N that gives it, and 67, one row past it (2 per
#: cluster, the last holding one); partial last clusters of 3, 5 and 6 rows
#: per cluster (133, 265, 331); rq1.botnet's 387 (6 per cluster, the last
#: holding 3); 396, 6 rows on each of the 66 clusters, the most the layout
#: allows, and 397, one past it (a 67th cluster of one row). Counts above
#: the problem's states repeat its rows. Phase 7's configurations and
#: iteration budgets, 100 at one N each
PGD_BOTNET_ROWS = (1, 31, 33, 66, 67, 133, 265, 331, 387, 396, 397)
#: the plain version's iterations when it is timed
PGD_BOTNET_PLAIN_ITERS = 10
#: card against CPU: rows and iterations
PGD_BOTNET_CPU_ROWS = 32
PGD_BOTNET_CPU_ITERS = 20
#: float32 operations of K7b per row and iteration counted from its source,
#: besides 4 per weight of the stack and PGD_OPS_PER_FEATURE per feature: 1
#: per entry of the gather lists (its feature's sum in the backward) and 1
#: more per flow entry (the forward sums), 7 per term (its threshold, clip,
#: cotangent and, for a ratio, the division's backward) and 50 per row (the
#: cross-entropy, the sums' roots); 3 float64 exp and log per row
PGD_BOTNET_OPS_PER_TERM = 7
PGD_BOTNET_OPS_PER_ROW = 50
#: a pair's term (the augmented domain) besides a term's 7: its two
#: comparisons, the xor's select and its cotangent's add at its column
PGD_BOTNET_OPS_PER_PAIR = 4
PGD_BOTNET_F64_PER_ROW = 3
#: K7b's dependent operations per iteration besides the stack's sums and the
#: two L2 sums, counted from its source: the cross-entropy (20), a feature's
#: cotangent sum and gradient (6), the step, clips, projection and repair's
#: round trip (20); each dependent float32 operation takes at least this
#: many cycles (Hopper's FADD and FMUL latency)
PGD_BOTNET_CHAIN_PER_ITER = 46
CYCLES_PER_DEPENDENT_OP = 4


def pgd_botnet_problem():
    """Phase 9's problem: ``synthetic_botnet_pgd_problem(387)`` (phase 8's
    states, surrogate and scaler, labels from the surrogate)."""
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_pgd_problem

    with tempfile.TemporaryDirectory() as tmp:
        return synthetic_botnet_pgd_problem(tmp, PGD_BOTNET_STATES)


def check_pgd_botnet_kernel(device, problem):
    """K7b against ``pgd_run_plain`` on the card over the sweep, bit for bit,
    with the terms' edge cases in the first rows of the starts."""
    from moeva2_ijcai22_replication_tpu_torch.problems import BOTNET_EDGE_ROWS, botnet_edge_starts

    cons, sur, scaler, _, xs, _ = problem
    starts = botnet_edge_starts(cons.schema.names, scaler, xs)
    n = max(PGD_BOTNET_ROWS)
    xs, starts = np.resize(xs, (n, xs.shape[1])), np.resize(starts, (n, xs.shape[1]))
    (runs, nan_rows, nan_hist), y = pgd_sweep(device, "pgd_botnet", cons, sur, scaler, xs, starts, PGD_BOTNET_ROWS)
    nan_grad, inf_grad = edge_gradient(device, cons, sur, scaler, starts[:BOTNET_EDGE_ROWS], y)
    log(f"[pgd-botnet] pgd_botnet equals pgd_run_plain (x_adv, class, history) on all {runs} runs: "
        f"{len(PGD_CONFIGS)} configurations x N in {PGD_BOTNET_ROWS} x T in {PGD_ITERS[:-1]}, and T = "
        f"{PGD_ITERS[-1]} at one N each; {nan_grad} NaN and {inf_grad} inf gradient entries at the "
        f"{BOTNET_EDGE_ROWS} edge starts, {nan_rows} NaN rows of x_adv, {nan_hist} NaN history entries")


def botnet_pairs(tables) -> int:
    """The XOR pairs of K7b's tables: 0 on the base domain."""
    return 0 if tables.cons.pair_idx is None else tables.cons.pair_idx.shape[0]


def pgd_botnet_work(tables, n: int, t: int, hist_cols: int = 0):
    """K7b's work for ``n`` rows and ``t`` iterations: the bytes it must
    move, its float32 and its float64 operations, counted from its source
    (on the augmented domain the pairs' terms among the terms, their tables
    and ``PGD_BOTNET_OPS_PER_PAIR`` more a pair)."""
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    d = widths[0]
    c = tables.cons.counts
    pairs = botnet_pairs(tables)
    n_terms = 2 + sum(c[4::2]) + pairs
    n_bytes = (4 * 3 * n * d + 16 * n + 4 * (tables.params.numel() + tables.first_t.numel()) + 9 * d
               + 4 * (sum(c) + tables.cons.inverse.numel()) + 16 * pairs + 16 * t + 4 * t * n * hist_cols)
    per_row = (4 * macs + PGD_OPS_PER_FEATURE * d + sum(c) + sum(c[:4]) + PGD_BOTNET_OPS_PER_TERM * n_terms
               + PGD_BOTNET_OPS_PER_PAIR * pairs + PGD_BOTNET_OPS_PER_ROW)
    return n_bytes, n * t * per_row, n * t * PGD_BOTNET_F64_PER_ROW


def pgd_botnet_bound(tables, n: int, t: int, hist_cols: int = 0):
    """K7b's least time for ``n`` rows and ``t`` iterations: the bytes it
    must move and the operations counted from its source."""
    return bound_ms(*pgd_botnet_work(tables, n, t, hist_cols))


def pgd_botnet_floor_ms(tables, t: int, mhz: float, l2: bool = True) -> float:
    """K7b's latency floor for ``t`` iterations counted from its source: the
    dependent operations of an iteration's longest path (each first-layer
    unit's 756 adds, the deeper layers' and the backward's sums, the two L2
    sums over the features and ``PGD_BOTNET_CHAIN_PER_ITER`` more), each at
    ``CYCLES_PER_DEPENDENT_OP`` cycles of the card's maximum SM clock."""
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    d = widths[0]
    chain = d + sum(widths[1:-1]) + sum(widths[1:]) + (2 * d if l2 else 0) + PGD_BOTNET_CHAIN_PER_ITER
    return t * chain * CYCLES_PER_DEPENDENT_OP / (mhz * 1e6) * 1e3


def pgd_botnet_shape(tables, n: int, autopgd: bool = False) -> dict:
    """K7b's launch at ``n`` rows of ``tables``' stack and gather lists, as
    its launcher plans it on the current card (``moeva_pgd_botnet_shape``),
    of its AutoPGD instantiation where ``autopgd``."""
    import ctypes

    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    fn = build.library().moeva_pgd_botnet_shape
    c_int = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(c_int), c_int, ctypes.POINTER(c_int), c_int, c_int, c_int, ctypes.POINTER(c_int)]
    fn.restype = c_int
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    counts = list(tables.cons.counts)
    out = (c_int * 6)()
    err = fn((c_int * len(widths))(*widths), len(widths) - 1, (c_int * len(counts))(*counts), botnet_pairs(tables),
             n, int(autopgd), out)
    if err:
        raise RuntimeError(f"moeva_pgd_botnet_shape failed: {build.library().moeva_error_string(err).decode()}")
    return dict(zip(("rows_per_cluster", "ctas_per_cluster", "ctas", "threads", "smem_bytes", "resident_clusters"),
                    out))


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def time_pgd_botnet(device, problem):
    """K7b's record at rq1.botnet's shape (387 x 1000, L2, its last loss):
    ``pgd_kernel_record``'s with the plain version at
    ``PGD_BOTNET_PLAIN_ITERS`` iterations, and beside them the latency floor
    and, as a note for the library column, the first layer's forward alone
    by ``torch.matmul`` 1000 times (fp32, TF32 off)."""
    import torch

    xs = problem[4]
    rec, atk = pgd_kernel_record(device, "[pgd-botnet]", "pgd_botnet",
                                 "moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py:241", problem,
                                 PGD_BOTNET_EPS - 1e-6, PGD_BOTNET_PLAIN_ITERS,
                                 lambda tables: pgd_botnet_bound(tables, len(xs), PGD_BUDGET))
    mhz = max_sm_clock_mhz()
    xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rec["first_layer_matmul_ms"] = PGD_BUDGET * graph_ms(lambda: torch.matmul(xi, atk.tables.first_t))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    rec["ceiling_ms"] = pgd_botnet_floor_ms(atk.tables, PGD_BUDGET, mhz)
    rec["launch"] = pgd_botnet_shape(atk.tables, len(xs))
    sh = rec["launch"]
    log(f"[pgd-botnet] K7b's launch at {len(xs)} rows: clusters of {sh['ctas_per_cluster']} CTAs of {sh['threads']} "
        f"threads, {sh['rows_per_cluster']} rows per cluster, {sh['ctas'] // sh['ctas_per_cluster']} clusters "
        f"({sh['resident_clusters']} resident at once), {sh['smem_bytes']} bytes of shared memory per CTA")
    log(f"[pgd-botnet] pgd_botnet's latency floor {rec['ceiling_ms']:.3f} ms (at {mhz:.0f} MHz); torch.matmul of the "
        f"first layer alone ({len(xs)} x {xs.shape[1]}) @ ({xs.shape[1]} x {atk.tables.first_t.shape[1]}), fp32, "
        f"TF32 off, x {PGD_BUDGET}: {rec['first_layer_matmul_ms']:.3f} ms (a note for the library column; the port "
        "does not call it)")
    return rec


def run_pgd_botnet(device, smi: str, resources: list):
    """Phase 9: constrained PGD on the botnet domain. Returns K7b's record
    and the launch counts of the rq1.botnet drive."""
    entries = [k for k in resources if k["kernel"] == "pgd_botnet_kernel<0>"]
    if not entries:
        raise AssertionError("the build's ptxas report has no entry for pgd_botnet_kernel<0>, K7b's PGD")
    for k in entries:
        log(f"[pgd-botnet] K7b ptxas: {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    problem = pgd_botnet_problem()
    cons, _, _, x, xs, y = problem
    log(f"[pgd-botnet] ConstrainedPGD on {len(xs)} synthetic botnet states ({cons.schema.n_features} features, "
        f"{cons.n_constraints} constraints), labels from the surrogate ({int(y.sum())} of class 1)")
    check_pgd_botnet_kernel(device, problem)
    rec = time_pgd_botnet(device, problem)
    # botnet's repair is the identity: the ball holds on every feature
    rewritten = np.zeros(x.shape[1], bool)
    launches = drive_pgd(device, smi, f"[pgd-botnet ε {PGD_BOTNET_EPS}]", "pgd_botnet", problem, PGD_BOTNET_EPS,
                         0.5, rewritten)
    drive_pgd(device, smi, f"[pgd-botnet ε {PGD_BOTNET_RQ0_EPS}]", "pgd_botnet", problem, PGD_BOTNET_RQ0_EPS, 0.5,
              rewritten)
    check_pgd_card_vs_cpu(device, "[pgd-botnet]", "pgd_botnet", problem, PGD_BOTNET_EPS, PGD_BOTNET_CPU_ROWS,
                          PGD_BOTNET_CPU_ITERS)
    return rec, launches


# -- phase 10: the runners ----------------------------------------------------------

#: ``config/moeva.yaml`` and ``config/pgd.yaml``, as dict literals (the card's
#: machine may have no PyYAML); ``tests/test_torch_runner_configs.py`` holds
#: them equal to the files
MOEVA_YAML = {
    "attack_name": "moeva", "n_pop": 200, "n_offsprings": 100, "max_states_per_call": 256, "archive_size": 24,
    "early_stop_check_every": 0, "record_quality": True, "quality_every": 0,
}
PGD_YAML = {"attack_name": "pgd", "constraints_optim": "sum"}
#: ``config/rq1.lcld.static.yaml`` and ``config/rq1.botnet.static.yaml``,
#: their artifact paths and results directory replaced by phase 10's
RQ1_STATIC = {
    "lcld": {
        "project_name": "lcld", "misclassification_threshold": 0.25, "norm": 2, "n_initial_state": 4000,
        "initial_state_offset": 0, "system": {"n_jobs": -1, "verbose": 1, "mesh_devices": 0},
        "save_history": False, "reconstruction": False,
    },
    "botnet": {
        "project_name": "botnet", "misclassification_threshold": 0.5, "norm": 2, "n_initial_state": -1,
        "initial_state_offset": 0, "system": {"n_jobs": 10, "verbose": 1, "mesh_devices": 0},
        "save_history": False, "reconstruction": False,
    },
}
#: rq1's grid (``config/rq1.lcld.yaml``, ``config/rq1.botnet.yaml``): seed,
#: ε, MoEvA's budget (rq1.lcld's first), PGD's budget and losses
RQ1_GRID = {
    "lcld": {"seed": 42, "eps": 0.2, "moeva_budget": 100, "pgd_budget": 1000},
    "botnet": {"seed": 42, "eps": 4, "moeva_budget": 1000, "pgd_budget": 1000},
}
RQ1_LOSSES = (
    "flip", "flip+sat", "constraints+flip", "constraints+flip+adaptive_eps_step",
    "constraints+flip+adaptive_eps_step+repair",
)
#: the one cut of phase 10: LCLD's ``flip+sat`` runs on the first 256 of the
#: 4000 states. Its MILP repair is host work, measured at 0.036 s per state
#: on the card's machine: all 4000 states would add about 144 s to a smoke of
#: about 250 s, which must stay within half its time limit as phases grow
RUNNER_CUTS = {("lcld", "flip+sat"): {"n_initial_state": 256}}
#: the one refusal phase 10 accepts, and the rows of x_adv that must be NaN
#: for it: on the card, rq1's LCLD ``constraints+flip`` point brings feature
#: 22 (the month count) of these rows to its lower bound 0 while x11 or x16 is
#: positive, where g8 = |x23 - x11/x22| or g9 = |x24 - x16/x22| is infinite;
#: the L2 step then turns the row NaN, and the judgement refuses the result
#: with its ``AssertionError``, as the JAX runner's does. Which rows reach the
#: pole depends on the rounding (float64 gives other rows, the same in both
#: packages: ``tests/test_torch_pgd_month_pole.py``; ROADMAP C5)
NAN_REFUSALS = {("lcld", "constraints+flip"): (1056, 1782, 2929, 2989, 3536, 3621)}
#: LCLD's terms over x22, g8 and g9, among the constraint violations
MONTH_POLE_TERMS = (7, 8)


def runner_config(domain: str, attack: str, artifacts: str, loss: str | None = None) -> dict:
    """Phase 10's config of one rq1 grid point, composed as the grid runner
    composes it (``experiments/rq.py::_compose``: the attack's yaml, the
    project's static yaml, then seed, budget and ε, and for PGD the loss),
    over the artifacts in ``artifacts``, with ``RUNNER_CUTS`` applied."""
    import copy

    grid = RQ1_GRID[domain]
    cfg = copy.deepcopy(MOEVA_YAML if attack == "moeva" else PGD_YAML)
    cfg.update(copy.deepcopy(RQ1_STATIC[domain]))
    cfg["paths"] = {
        "model": f"{artifacts}/nn.msgpack",
        "features": f"{artifacts}/features.csv",
        "constraints": f"{artifacts}/constraints.csv",
        "x_candidates": f"{artifacts}/x_candidates_common.npy",
        "min_max_scaler": f"{artifacts}/scaler.npz",
        "ml_scaler": f"{artifacts}/scaler.npz",
    }
    cfg["dirs"] = {"results": f"{artifacts}/out/{domain}/rq1"}
    if attack == "moeva":
        cfg.update(seed=grid["seed"], budget=grid["moeva_budget"], eps_list=[grid["eps"]])
    else:
        cfg.update(seed=grid["seed"], budget=grid["pgd_budget"], eps=grid["eps"], loss_evaluation=loss)
        cfg.update(RUNNER_CUTS.get((domain, loss), {}))
    return cfg


def write_runner_artifacts(domain: str, out: str):
    """Phase 10's artifacts in ``out``: the synthetic schema, the problem's
    states (``synth_lcld(4000, seed=42)`` or ``synth_botnet(387, seed=42)``),
    its seeded surrogate by the port's ``save_params`` and its scaler by
    ``save_npz``. Returns the problem's constraints."""
    from moeva2_ijcai22_replication_tpu_torch.models.io import save_params
    from moeva2_ijcai22_replication_tpu_torch.models.scalers import save_npz
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_problem, synthetic_lcld_problem

    make, n = (synthetic_lcld_problem, 4000) if domain == "lcld" else (synthetic_botnet_problem, 387)
    cons, sur, scaler, x = make(out, n)
    np.save(f"{out}/x_candidates_common.npy", x)
    save_params(sur, f"{out}/nn.msgpack")
    save_npz(scaler, f"{out}/scaler.npz")
    return cons


def dir_state(path: str) -> dict:
    import os

    return {f: os.stat(os.path.join(path, f)).st_mtime_ns for f in sorted(os.listdir(path))}


def repair_counts(cons, x_init: np.ndarray, x_rep: np.ndarray) -> dict:
    """The MILP-repaired rows of ``x_rep``: each satisfies the constraints as
    ``check_constraints_error`` judges them (float64, every term within its
    tolerance) or is its initial state (the fallback). One exception is
    counted apart, a caveat of the JAX package's LCLD builders, hand-written
    and compiled from LCLD's spec alike (ROADMAP C3): they take the
    amortisation factor of g1 at the initial state's int_rate, which the
    synthetic schema lets move, so a repaired row may break g1 alone by its
    moved int_rate; such a row must satisfy every term once int_rate is put
    back to its initial value. Returns the counts: feasible, fell back,
    caveat, of n."""
    import torch

    def feasible(rows):
        return ~(cons.evaluate(torch.as_tensor(rows, dtype=torch.float64)).numpy() > 0).any(-1)

    ok = feasible(x_rep)
    fell_back = (x_rep == x_init).all(-1)
    caveat = np.zeros_like(ok)
    if cons.objective_kernel == "lcld" or getattr(getattr(cons, "spec", None), "name", "").startswith("lcld"):
        back = x_rep.copy()
        back[:, 2] = x_init[:, 2]
        caveat = ~ok & ~fell_back & feasible(back)
    bad = ~(ok | fell_back | caveat)
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} repaired rows violate the constraints: rows {np.flatnonzero(bad)[:10]}")
    return {"feasible": int((ok & ~fell_back).sum()), "fell_back": int(fell_back.sum()), "caveat": int(caveat.sum()),
            "n": len(x_rep)}


def check_repairs(cons, x_init: np.ndarray, x_rep: np.ndarray) -> str:
    """``repair_counts`` (which fails on a repaired row that is neither
    feasible, nor its initial state, nor C3's caveat), for the log."""
    c = repair_counts(cons, x_init, x_rep)
    return (f"{c['feasible']} feasible, {c['fell_back']} fell back to the initial state, "
            f"{c['caveat']} feasible once int_rate is put back (C3) of {c['n']}")


def pole_rows_of_pgd(cfg: dict, plain: bool = True, poles: tuple = MONTH_POLE_TERMS) -> tuple:
    """``(rows, first, terms, plain_rows)``: the rows of
    ``ConstrainedPGD.generate``'s result that hold a NaN, for the inputs and
    knobs ``experiments.pgd.run`` gives it under ``cfg``; for each, the first
    iteration at which one of the row's recorded violations was not finite,
    if every term not finite there is one of ``poles`` (a ratio term whose
    denominator reached 0: an infinite quotient, or 0/0), else None, and the
    names of those terms; and, with ``plain``, the NaN rows of the plain
    version run on the card on the same inputs (None without)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.experiments import common, pgd

    x_init = common.load_candidates(cfg)
    scaler, sur = common.load_scaler(cfg), common.load_surrogate(cfg)
    eps = cfg["eps"] / 2 if "sat" in cfg["loss_evaluation"] else cfg["eps"]
    xs = scaler.transform(np.asarray(x_init))
    y = pgd.surrogate_labels(sur, xs, "cuda", torch.float32)
    cons = common.load_constraints(cfg)
    atk = ConstrainedPGD(sur, cons, scaler, max_iter=cfg["budget"], norm=cfg["norm"],
                         loss_evaluation=cfg["loss_evaluation"], constraints_optim=cfg["constraints_optim"],
                         seed=cfg["seed"], record_loss="full")
    x_adv = atk.generate(xs, y, eps=eps - 0.000001, eps_step=0.1, max_iter=cfg["budget"])
    rows = tuple(np.flatnonzero(~np.isfinite(x_adv).all(-1)).tolist())
    plain_rows = None
    if plain:
        x_t = torch.as_tensor(xs, dtype=torch.float32, device="cuda")
        sched = atk.schedule(eps - 0.000001, 0.1, cfg["budget"])
        out, _, _ = pgd_run_plain(atk.tables, cons, sched, x_t, torch.as_tensor(y, device="cuda"), x_t,
                                  eps - 0.000001, atk.clip, atk.norm, "repair" in cfg["loss_evaluation"],
                                  atk.targeted, None)
        plain_rows = tuple(np.flatnonzero(~torch.isfinite(out).all(-1).cpu().numpy()).tolist())
    g = atk.loss_history[:, :, 3:]  # (N, T, K): the violations after [per, loss_class, cons]
    first, terms = [], []
    for r in rows:
        bad = ~np.isfinite(g[r]).all(-1)
        t = int(np.argmax(bad)) if bad.any() else None
        hit = [] if t is None else np.flatnonzero(~np.isfinite(g[r, t])).tolist()
        first.append(t if hit and set(hit) <= set(poles) else None)
        terms.append(" ".join(f"g{k + 1}" for k in hit))
    return rows, first, terms, plain_rows


def point_mid_fix(runner: str, cfg: dict) -> str:
    return cfg["attack_name"] if runner == "moeva" else f"{cfg['attack_name']}_{cfg['loss_evaluation']}"


def point_files(runner: str, cfg: dict) -> set:
    from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash

    mid, h = point_mid_fix(runner, cfg), get_dict_hash(cfg)
    names = {f"metrics_{mid}_{h}.json", f"config_{mid}_{h}.yaml", f"x_attacks_{mid}_{h}.npy"}
    if runner == "moeva" and cfg.get("save_history") and cfg["budget"] > 1:
        names.add(f"x_history_{mid}_{h}.npy")
    return names | ({f"success_rate_{mid}_{h}.csv"} if runner == "pgd" else set())


def point_expected_launches(runner: str, cfg: dict, result=None) -> dict:
    """The launches one point's run implies: ``expected_launches`` for
    MoEvA (with the run's ``MoevaResult`` where it has an early exit), for
    PGD one launch of K16's ``forward_labels`` (the surrogate's labels), one
    launch of the set's PGD kernel (of its AutoPGD instantiation for an
    ``autopgd`` loss) per random start, at least one, and one launch each
    of K0's ``pgd_start`` and K15's ``restart`` per random start."""
    import types

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.experiments import common

    cons = common.load_constraints(cfg)
    if runner == "pgd":
        auto = "autopgd" in cfg["loss_evaluation"]
        starts = int(cfg.get("nb_random", 1 if auto else 0))
        return {**{k: 0 for k in kernels.launch_counts()}, "pgd_start": starts, "restart": starts,
                "forward_labels": 1, counter_name(cons, "pgd") + ("_auto" if auto else ""): max(starts, 1)}
    engine = types.SimpleNamespace(
        max_states_per_call=cfg["max_states_per_call"], n_gen=cfg["budget"], archive_size=cfg["archive_size"],
        constraints=cons, early_stop_check_every=int(cfg.get("early_stop_check_every", 0) or 0),
        record_quality=bool(cfg.get("record_quality", True)), quality_every=int(cfg.get("quality_every", 0) or 0),
        save_history=cfg.get("save_history") or None,
    )
    return expected_launches(engine, len(common.load_candidates(cfg)), result)


def point_rates(runner: str, metrics: dict) -> list:
    return metrics["objectives_list"] if runner == "moeva" else [metrics["objectives"]]


def recomputed_rates(runner: str, cfg: dict, x_attacks: np.ndarray) -> list:
    """o1..o7 of ``x_attacks`` judged afresh, per ε, as the runner judges."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
    from moeva2_ijcai22_replication_tpu_torch.experiments import common

    x_init = common.load_candidates(cfg)
    scaler = common.load_scaler(cfg)
    calc = ObjectiveCalculator(
        classifier=common.load_surrogate(cfg),
        constraints=common.evaluation_constraints(cfg, common.load_constraints(cfg)), thresholds={},
        min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=cfg["norm"],
    )
    vals = calc.objectives(x_init, x_attacks)
    rates = []
    for eps in cfg["eps_list"] if runner == "moeva" else [cfg["eps"]]:
        calc.thresholds = {"f1": cfg["misclassification_threshold"], "f2": eps}
        rates.append(calc.success_rate_3d_record(x_init, x_attacks, vals))
    return rates


def drive_runner(cfg: dict, smi: str, expected, tag: str) -> dict | None:
    """One phase-10 run: ``run(cfg)`` with the launch counts set to 0 just
    before and read just after (they must equal ``expected``, a dict or a
    function called after the run that gives it); the files
    under the JAX names; the metrics against a recomputation from the saved
    ``x_attacks``; ``includes_compile`` false; skip-if-done. Returns the
    metrics.

    One outcome other than metrics is checked and accepted, for the grid
    point of ``NAN_REFUSALS`` alone, as the JAX runner has it too (ROADMAP
    C5): the judgement's range check refuses the result with its
    ``AssertionError``, before any file is written. Then the run must have
    written nothing, the attack run again alone, and its plain version on
    the card, must leave exactly the listed rows NaN, each after g8 or g9
    went non-finite (x22 at 0), and None is returned. Any other refusal
    raises."""
    import os

    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.experiments import common, moeva, pgd
    from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash

    runner = moeva if cfg["attack_name"] == "moeva" else pgd
    kind = "moeva" if runner is moeva else "pgd"
    mid_fix = point_mid_fix(kind, cfg)
    out = cfg["dirs"]["results"]
    refusal = (cfg["project_name"], cfg["loss_evaluation"]) if runner is pgd else None
    before = dir_state(out) if os.path.isdir(out) else {}
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        metrics = runner.run(cfg)
    except AssertionError as exc:
        if refusal not in NAN_REFUSALS or "min-max scaled values outside" not in str(exc):
            raise
        metrics = None
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_launches(launches, expected() if callable(expected) else expected, f"the {tag} runner")
    if metrics is None:
        if (dir_state(out) if os.path.isdir(out) else {}) != before:
            raise AssertionError(f"{tag}: the refused run wrote files")
        rows, first, _, plain_rows = pole_rows_of_pgd(cfg)
        if rows != NAN_REFUSALS[refusal] or plain_rows != rows:
            raise AssertionError(f"{tag}: the judgement refused the result; x_adv's NaN rows are {rows} "
                                 f"(the plain version's {plain_rows}), not the known {NAN_REFUSALS[refusal]}")
        if None in first:
            raise AssertionError(f"{tag}: NaN rows {rows}: g8 or g9 not finite first at iterations {first} "
                                 "(None: another term first)")
        log(f"[runner] {tag}: {len(common.load_candidates(cfg))} states x {cfg['budget']}: refused by the "
            f"judgement's AssertionError, as the JAX runner's (ROADMAP C5): x_adv rows {list(rows)} are NaN, as "
            f"listed and as the plain version's on the card, each after x22 reached 0 (g8 or g9 not finite first "
            f"at iterations {first}); nothing written; "
            f"launches {({k: v for k, v in launches.items() if v})} as expected; wall {wall_s:.3f} s on {smi}")
        return None

    h = get_dict_hash(cfg)
    names = point_files(kind, cfg)
    written = set(dir_state(out)) - set(before)
    if written != names:
        raise AssertionError(f"{tag}: the run wrote {sorted(written)}, not {sorted(names)}")
    with open(f"{out}/metrics_{mid_fix}_{h}.json") as f:
        on_disk = json.load(f)
    if on_disk["config_hash"] != h or set(on_disk) != {
        "objectives_list" if runner is moeva else "objectives", "time", "includes_compile", "execution",
        "timings", "counters", "config", "config_hash",
    }:
        raise AssertionError(f"{tag}: metrics keys {sorted(on_disk)}")
    if metrics["includes_compile"]:
        raise AssertionError(f"{tag}: includes_compile is true, but the kernel library was loaded in phase 2")

    x_init = common.load_candidates(cfg)
    rates = recomputed_rates(kind, cfg, np.load(f"{out}/x_attacks_{mid_fix}_{h}.npy"))
    if rates != point_rates(kind, metrics):
        raise AssertionError(f"{tag}: metrics {metrics} != objectives recomputed from x_attacks {rates}")

    state = dir_state(out)
    if runner.run(cfg) is not None or dir_state(out) != state:
        raise AssertionError(f"{tag}: a second run of the same config did not skip")
    timings = " ".join(f"{k} {v:.3f}" for k, v in metrics["timings"].items())
    log(f"[runner] {tag}: {len(x_init)} states x {cfg['budget']}, time {metrics['time']:.3f} s (wall "
        f"{wall_s:.3f}), timings: {timings}; launches {({k: v for k, v in launches.items() if v})} as expected; "
        f"metrics equal the recomputation; second run skipped; o1..o7 "
        + " | ".join(" ".join(f"{r[k]:.4f}" for k in r) for r in rates) + f" on {smi}")
    return metrics


def run_runners(smi: str) -> None:
    """Phase 10: rq1's grid points through the port's runners, MoEvA and the
    five PGD losses on LCLD and on botnet, from configs composed as the
    grid runner composes ``config/``'s files, over synthetic artifacts."""
    import os

    from moeva2_ijcai22_replication_tpu_torch.experiments import common

    with tempfile.TemporaryDirectory() as tmp:
        for domain in ("lcld", "botnet"):
            art = f"{tmp}/{domain}"
            cons = write_runner_artifacts(domain, art)
            cfg = runner_config(domain, "moeva", art)
            drive_runner(cfg, smi, point_expected_launches("moeva", cfg), f"moeva {domain}")
            pgd_s = None
            for loss in RQ1_LOSSES:
                cfg = runner_config(domain, "pgd", art, loss)
                metrics = drive_runner(cfg, smi, point_expected_launches("pgd", cfg), f"pgd {domain} {loss}")
                if loss == "flip":
                    pgd_s = metrics["timings"]["attack"]
                if "sat" in loss:
                    # the attack span holds PGD and the MILP repair; PGD alone
                    # is the span of the flip run before it
                    h = metrics["config_hash"]
                    x_rep = np.load(f"{cfg['dirs']['results']}/x_attacks_pgd_{loss}_{h}.npy")[:, 0]
                    x_init = common.load_candidates(cfg)
                    sat_s = metrics["timings"]["attack"] - pgd_s
                    log(f"[runner] pgd {domain} {loss}: MILP repair {check_repairs(cons, x_init, x_rep)}; "
                        f"SAT {sat_s:.3f} s (attack span {metrics['timings']['attack']:.3f} s less flip's "
                        f"{pgd_s:.3f} s), {sat_s / len(x_init):.4f} s per state (n_jobs {cfg['system']['n_jobs']}, "
                        f"{os.cpu_count()} host cores) on {smi}")

# -- phase 11: the augmented LCLD domain ---------------------------------------------

#: states of the augmented problem for K1's sweep and the stages' checks
#: (phase 3's largest sweep count), at which K1 is timed too
AUG_STATES = 1000
#: generation steps over which the stages are held on the card
AUG_STAGE_GENS = 3
#: operations of the pair stage per pair, counted from the sources: K1's two
#: compares, xor, subtract, abs, compare-select and add (7); K7's forward
#: with its clip (8), clip_vjp's 2 compares and 2 multiplies, abs_vjp and
#: the add to 0 (6) and repair's re-derivation (4)
OBJECTIVE_OPS_PER_PAIR = 7
PGD_OPS_PER_PAIR = 18
#: ``config/rq2.lcld.static.yaml``, its artifact paths and results directory
#: replaced by phase 11's; ``tests/test_torch_runner_configs.py`` holds it
#: equal to the file
RQ2_STATIC = {
    "misclassification_threshold": 0.25, "norm": 2, "n_initial_state": 4000, "initial_state_offset": 0,
    "system": {"n_jobs": -1, "verbose": 1, "mesh_devices": 0}, "save_history": False,
}
#: ``config/rq2.lcld.yaml``'s grid: seed, ε, budgets, its one loss, and its
#: one scenario (the schema and evaluation paths replaced by phase 11's)
RQ2_GRID = {"seed": 42, "eps": 0.2, "budgets": (100, 1000), "loss": "constraints+flip+adaptive_eps_step+repair"}
RQ2_SCENARIO = {"project_name": "lcld_augmented", "reconstruction": False,
                "evaluation": {"project_name": "lcld_augmented"}}
#: the MoEvA runner's chunk of states on rq2.lcld and its last chunk (4000
#: states in chunks of 256), at which the stages are checked and K1 is timed
AUG_CHUNK = MOEVA_YAML["max_states_per_call"]
AUG_LAST_CHUNK = RQ2_STATIC["n_initial_state"] % AUG_CHUNK or AUG_CHUNK


def counter_name(cons, kind: str) -> str:
    """The launch count that ``cons``'s objective (``kind`` "objective") or
    PGD (``kind`` "pgd") kernel adds to: K1's, K7's and K8's instantiations
    for the augmented domains count apart (their tables carry the pairs:
    LCLD's are the pair tables, botnet's hold them beside the gather lists)."""
    base = f"{kind}_{cons.objective_kernel if kind == 'objective' else cons.pgd_kernel}"
    if base in ("objective_spec", "pgd_spec"):  # K9 and K10 read programs, with no pairs
        return base
    tables = cons.kernel_tables("cpu")
    return f"{base}_aug" if tables is not None and getattr(tables, "pair_idx", tables) is not None else base


def rq2_config(attack: str, budget: int, artifacts: str, reconstruction: bool = False) -> dict:
    """Phase 11's config of one rq2.lcld grid point, composed as the grid
    runner composes it (the attack's yaml, ``rq2.lcld.static``, seed and
    budget, the scenario, then ε, and for PGD the loss), over the artifacts
    in ``artifacts``; ``reconstruction`` set where asked."""
    import copy

    cfg = copy.deepcopy(MOEVA_YAML if attack == "moeva" else PGD_YAML)
    cfg.update(copy.deepcopy(RQ2_STATIC))
    cfg["paths"] = {
        "model": f"{artifacts}/nn_augmented.msgpack",
        "x_candidates": f"{artifacts}/x_candidates_common_augmented.npy",
        "min_max_scaler": f"{artifacts}/scaler_augmented.npz",
        "ml_scaler": f"{artifacts}/scaler_augmented.npz",
        "features": f"{artifacts}/features_augmented.csv",
        "constraints": f"{artifacts}/constraints_augmented.csv",
    }
    cfg["dirs"] = {"results": f"{artifacts}/out/lcld/rq2"}
    cfg.update(seed=RQ2_GRID["seed"], budget=budget)
    cfg.update(copy.deepcopy(RQ2_SCENARIO))
    cfg["evaluation"]["constraints"] = cfg["paths"]["constraints"]
    cfg["reconstruction"] = reconstruction
    if attack == "moeva":
        cfg["eps_list"] = [RQ2_GRID["eps"]]
    else:
        cfg.update(eps=RQ2_GRID["eps"], loss_evaluation=RQ2_GRID["loss"])
    return cfg


def rq2_engine(device, cons, sur, scaler, artifacts: str):
    """The MoEvA engine that the runner builds for rq2.lcld's first grid
    point (``rq2_config``'s population, offspring, archive, norm, seed and
    chunk), over the augmented problem's constraints, surrogate and scaler."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2

    cfg = rq2_config("moeva", RQ2_GRID["budgets"][0], artifacts)
    return Moeva2(sur, cons, ml_scaler=scaler, device=device, norm=cfg["norm"], n_gen=cfg["budget"],
                  n_pop=cfg["n_pop"], n_offsprings=cfg["n_offsprings"], seed=cfg["seed"],
                  archive_size=cfg["archive_size"], max_states_per_call=cfg["max_states_per_call"])


def aug_candidates(codec, cons, x: np.ndarray, cand):
    """``hard_candidates(codec, cand)`` with the pair terms' edge rows
    (``problems.lcld_augmented_edge_rows`` of ``x``) as rows 1 to 6 of each
    state, in genes."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
    from moeva2_ijcai22_replication_tpu_torch.problems import LCLD_AUGMENTED_EDGE_ROWS, lcld_augmented_edge_rows

    cand = hard_candidates(codec, cand)
    rows = torch.as_tensor(lcld_augmented_edge_rows(x, cons.important_features)[:LCLD_AUGMENTED_EDGE_ROWS],
                           device=cand.device)
    n = min(LCLD_AUGMENTED_EDGE_ROWS, cand.shape[1] - 1)
    cand[:, 1:1 + n] = codec_lib.ml_to_genetic(codec, rows[:n])
    return cand


def aug_objective_bound(eng, s: int, n: int):
    """K1's least time on the augmented domain for ``s`` states x ``n``
    candidates: phase 3's count at its widths plus the pair stage."""
    obj, l, d = eng._objective, eng.codec.gen_length, eng.codec.n_features
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    pairs = obj.cons.idx.shape[0]
    n_bytes = 4 * s * n * l + 16 * s * d + 8 * s + 4 * n_params + 16 * d + 16 * pairs + 12 * s * n
    n_ops = s * n * (2 * macs + OBJECTIVE_OPS_PER_FEATURE * d + OBJECTIVE_OPS_PER_ROW + OBJECTIVE_OPS_PER_PAIR * pairs)
    return bound_ms(n_bytes, n_ops, 0)


def aug_pgd_bound(tables, n: int, t: int):
    """K7's least time on the augmented domain: ``pgd_work`` at its width
    plus the pair stage."""
    n_bytes, n_ops, n_f64 = pgd_work(tables, n, t)
    pairs = tables.cons.idx.shape[0]
    return bound_ms(n_bytes + 16 * pairs, n_ops + n * t * PGD_OPS_PER_PAIR * pairs, n_f64)


def check_aug_objectives(device, cons, sur, scaler, x, gen, rng):
    """K1 on the augmented domain against ``evaluate_plain``, bit for bit:
    phase 3's sweep (S in ``SWEEP_STATES``, the offspring and the
    population of both shapes) and K1's launch edges (``OBJECTIVE_EDGES``,
    the main stack and one read from global memory), under both norms, with
    the pair terms' edge rows among the candidates."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_plain, make_objective_tables
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import draw_offspring
    from moeva2_ijcai22_replication_tpu_torch.models.mlp import MLP

    engines = {norm: Moeva2(sur, cons, ml_scaler=scaler, device=device, norm=norm, n_pop=100, n_offsprings=100,
                            archive_size=24, seed=42) for norm in (2, "inf")}
    codec = engines[2].codec
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        wide = MLP(codec.n_features, GLOBAL_STACK, 2).to(device).eval().requires_grad_(False)
    runs = nonfinite = candidates = 0
    for norm, eng in engines.items():
        obj = eng._objective
        obj_global = make_objective_tables(codec, wide, obj.scaler, norm, cons.tol, obj.cons)
        for m, _, p in SWEEP_SHAPES:
            for s in SWEEP_STATES:
                run = eng.prepare(x[:s], np.arange(s) % 2)
                pop, xl, xu = sweep_population(gen, run, codec, s, p)
                draws = draw_offspring(stream_of(gen), s, p, m - p, codec.gen_length)
                off = kernels.offspring(eng.tables, pop, xl, xu, m - p, draws)
                for cand in (off, pop):
                    cand = aug_candidates(codec, cons, x, cand)
                    got = kernels.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                                 run.minimize_class, obj)
                    hold_equal(got, evaluate_plain(obj, codec, run, cand, cons),
                               f"objective_lcld_aug S={s} N={cand.shape[1]} norm={norm}")
                    runs += 1
                    candidates += got.shape[0] * got.shape[1]
                    nonfinite += int((~torch.isfinite(got)).any(-1).sum())
        for s, n in OBJECTIVE_EDGES:
            run = eng.prepare(x[:s], np.arange(s) % 2)
            cand = aug_candidates(codec, cons, x, sweep_population(gen, run, codec, s, n)[0])
            for stack, tables in (("main", obj), ("global", obj_global)):
                got = kernels.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                             run.minimize_class, tables)
                hold_equal(got, evaluate_plain(tables, codec, run, cand, cons),
                           f"objective_lcld_aug S={s} N={n} {stack} stack norm={norm}")
                runs += 1
    log(f"[augmented] objective_lcld at D = {codec.n_features} ({cons.n_constraints} terms) equals evaluate_plain "
        f"on every entry of {runs} launches: S in {SWEEP_STATES} x the offspring and populations of (M, P) in "
        f"{[(m, p) for m, _, p in SWEEP_SHAPES]}, and (S, N) in {OBJECTIVE_EDGES} with the main stack and a "
        f"{codec.n_features}-{'-'.join(map(str, GLOBAL_STACK))}-2 stack read from global memory, under L2 and "
        f"L-inf, with the pair terms' edge rows among the candidates; {nonfinite} of {candidates} candidates with a "
        "non-finite objective (the sweep's random genes put denominators at 0)")


def check_aug_stages(device, eng, x, tag="[augmented]", states=(AUG_CHUNK, AUG_LAST_CHUNK, AUG_STATES)):
    """K5, the objective kernel (K1 or K8), K2, K4a, K3 and K4b at an
    augmented domain's gene length, each against its plain version on the
    inputs the path gives it: ``eng`` is the runner's engine (``rq2_engine``,
    ``rq2_botnet_engine``), and each is held over the initial round (as
    ``init_carry`` runs it), then ``AUG_STAGE_GENS`` generation steps, at
    each state count of ``states`` (rq2.lcld's: the runner's chunk and last
    chunk, ``AUG_CHUNK`` and ``AUG_LAST_CHUNK``, and ``AUG_STATES``), the
    carry following the card."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
        OBJECTIVE_KERNELS, Carry, archive_select_plain, evaluate_plain, extract_archive_plain,
    )
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.initialisation import tile_init
    from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
    from moeva2_ijcai22_replication_tpu_torch.domains import augmentation
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import make_offspring_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import (
        NormState, associate_plain, draw_gumbels, survive_fill_plain, survive_norm_plain,
    )
    from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream

    def survival(pop_f, off_f, state, gum_cut, gum_mem, what, extract=None, archive=None):
        """K2, K4a and K3 on [pop_f, off_f] (through two pointers; pop_f
        alone with ``off_f`` None) and K4b, each held against its plain
        version on the merged objectives; returns K4b's output and the new
        normalisation state."""
        f = pop_f if off_f is None else torch.cat([pop_f, off_f], dim=1)
        ranks = kernels.nd_peel(pop_f, eng.pop_size, off_f)
        hold_equal(ranks, nd_ranks_plain(f, eng.pop_size), f"nd_peel {what}")
        ideal, worst, extreme, nadir, dirs = kernels.survive_norm(pop_f, ranks, eng.asp_points, state, off_f)
        w_state, w_nadir, w_dirs = survive_norm_plain(f, ranks, eng.asp_points, state)
        for name, got, want in zip(("ideal", "worst", "extreme", "nadir", "dirs"),
                                   (ideal, worst, extreme, nadir, dirs), (*w_state, w_nadir, w_dirs)):
            hold_equal(got, want, f"survive_norm {name} {what}")
        niche, dist = kernels.associate(pop_f, dirs, ideal, nadir, off_f)
        for name, got, want in zip(("niche", "dist"), (niche, dist), associate_plain(f, dirs, ideal, nadir)):
            hold_equal(got, want, f"associate {name} {what}")
        out = kernels.survive_fill(gum_cut, gum_mem, ranks, niche, dist, eng.pop_size, extract=extract,
                                   archive=archive)
        mask = survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, eng.pop_size)
        want = (mask, *extract_archive_plain(mask, *extract, *archive[:2])) if extract is not None else (mask,)
        for name, got, w in zip(("mask", "pop_x", "pop_f", "arch_x", "arch_f"), out, want):
            hold_equal(got, w, f"survive_fill {name} {what}")
        shapes.add((f.shape[1], dirs.shape[1]))
        return out, NormState(ideal, worst, extreme)

    objective = getattr(kernels, OBJECTIVE_KERNELS[eng.constraints.objective_kernel])
    name = counter_name(eng.constraints, "objective")
    n_base = eng.constraints.n_constraints - augmentation.n_pairs(eng.constraints.important_features)
    offspring = finite = pair_violated = 0
    shapes = set()
    for s in states:
        run = eng.prepare(x[:s], np.ones(s, dtype=np.int64))
        ins = (run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
        gen = PhiloxStream(s, device)
        what = f"S={s} initial round"
        pop_x = tile_init(eng.codec, run.x_init_ml, eng.pop_size)
        pop_f = objective(pop_x, *ins)
        hold_equal(pop_f, evaluate_plain(eng._objective, eng.codec, run, pop_x, eng.constraints),
                   f"{name} {what}")
        _, state = survival(pop_f, None, NormState.init(s, 3, device=device),
                            *draw_gumbels(gen, s, eng.n_dirs, eng.pop_size), what)
        arch = kernels.archive_select(pop_x, pop_f, pop_x[:, :0], pop_f[:, :0], eng.archive_size)
        for name, got, want in zip(("arch_x", "arch_f"), arch, archive_select_plain(pop_x, pop_f, eng.archive_size)):
            hold_equal(got, want, f"survive_fill archive {name} {what}")
        carry = Carry(pop_x, pop_f, *arch, state)
        for g in range(AUG_STAGE_GENS):
            d = eng.draw_generation(gen, s)
            what = f"S={s} step {g}"
            args = (eng.tables, carry.pop_x, run.xl_gen, run.xu_gen, eng.n_offsprings, d.offspring)
            off = kernels.offspring(*args, crossover_prob=eng.crossover_prob, eta_mutation=eng.eta_mutation)
            hold_equal(off, make_offspring_plain(*args, crossover_prob=eng.crossover_prob,
                                                 eta_mutation=eng.eta_mutation), f"offspring {what}")
            off_f = objective(off, *ins)
            hold_equal(off_f, evaluate_plain(eng._objective, eng.codec, run, off, eng.constraints),
                       f"{name} {what}")
            terms = eng.constraints.evaluate(codec_lib.genetic_to_ml(eng.codec, off, run.x_init_ml[:, None, :]))
            offspring += off.shape[0] * off.shape[1]
            finite += int(torch.isfinite(off_f).all(-1).sum())
            pair_violated += int((terms[..., n_base:] > 0).any(-1).sum())
            out, state = survival(carry.pop_f, off_f, carry.norm_state, d.gum_cut, d.gum_mem,
                                  what, extract=(carry.pop_x, off, carry.pop_f, off_f),
                                  archive=(carry.arch_x, carry.arch_f, off, off_f, eng.archive_size))
            carry = Carry(out.pop_x, out.pop_f, out.arch_x, out.arch_f, state)
    log(f"{tag} offspring, {objective.__name__}, nd_peel, survive_norm, associate and survive_fill at L = "
        f"{eng.codec.gen_length} genes ({eng.codec.n_features} features) equal their plain versions on the runner's "
        f"engine (population {eng.pop_size}, {eng.n_offsprings} offspring, archive {eng.archive_size}; (M, R) in "
        f"{sorted(shapes)}): the initial round and {AUG_STAGE_GENS} generation steps at S in {states} (the "
        f"runner's chunks among them); of {offspring} offspring {finite} have finite objectives and "
        f"{pair_violated} violate a pair term")


def time_aug_objective(device, eng, x, smi: str) -> dict:
    """K1's record on the augmented domain at (``AUG_STATES``, 100), and its
    device time at the runner's chunk (``AUG_CHUNK``, 100), each beside its
    bound, on the path's offspring (held bit for bit)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import draw_gumbels
    from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream

    shapes = {}
    for s in (AUG_STATES, AUG_CHUNK):
        run = eng.prepare(x[:s], np.ones(s, dtype=np.int64))
        gen = PhiloxStream(7, device)
        carry = eng.init_carry(run, *draw_gumbels(gen, s, eng.n_dirs, eng.pop_size))
        off = eng.offspring(run, carry.pop_x, eng.draw_generation(gen, s).offspring)
        args = (off, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
        hold_equal(kernels.objective_lcld(*args), evaluate_plain(eng._objective, eng.codec, run, off, eng.constraints),
                   f"objective_lcld_aug S={s} (timed inputs)")
        shapes[s] = (args, run, off)
    args, run, off = shapes[AUG_STATES]
    s, n = off.shape[:2]
    b_ms, b_by = aug_objective_bound(eng, s, n)
    rec = {
        "name": "objective_lcld_aug",
        "route": "cuda",
        "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/objective_lcld.cu",
        "replaces": "moeva2_ijcai22_replication_tpu/attacks/moeva/engine.py:452",
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": graph_ms(lambda: kernels.objective_lcld(*args)),
        "wrapper_ms": cuda_ms(lambda: kernels.objective_lcld(*args)),
        "plain_ms": cuda_ms(lambda: evaluate_plain(eng._objective, eng.codec, run, off, eng.constraints),
                            launches=5, repeats=3),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    chunk_args = shapes[AUG_CHUNK][0]
    rec["ms_chunk"] = graph_ms(lambda: kernels.objective_lcld(*chunk_args))
    rec["bound_ms_chunk"] = aug_objective_bound(eng, AUG_CHUNK, n)[0]
    log(f"[augmented] objective_lcld at D = {eng.codec.n_features}, S={s} N={n}: device {rec['ms']:.4f} ms, through "
        f"the wrapper {rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}); at "
        f"S={AUG_CHUNK} N={n} (the runner's chunk): device {rec['ms_chunk']:.4f} ms, bound "
        f"{rec['bound_ms_chunk']:.5f} ms; on {smi}")
    return rec


def check_aug_pgd(device, cons, sur, scaler, x, art: str):
    """K7 on the augmented domain against ``pgd_run_plain`` on the card, bit
    for bit, over phase 7's sweep (``PGD_CONFIGS``, rq2's loss among them, x
    ``PGD_ROWS`` x ``PGD_ITERS``), with phase 7's edge starts and the pair
    terms' edge rows among the starts; then phase 7's immutable-repair check
    on a copy of the augmented schema in ``art`` (``check_immutable_repair``)."""
    from moeva2_ijcai22_replication_tpu_torch.problems import LCLD_AUGMENTED_EDGE_ROWS, lcld_augmented_edge_rows

    rng = np.random.default_rng(5)
    xs = scaler.transform(x).astype(np.float32)
    starts = pgd_edge_starts(rng, xs, scaler)
    aug = lcld_augmented_edge_rows(x[14:14 + LCLD_AUGMENTED_EDGE_ROWS], cons.important_features, scaler)
    starts[14:14 + LCLD_AUGMENTED_EDGE_ROWS] = aug
    n = max(PGD_ROWS)
    xs, starts = np.resize(xs, (n, xs.shape[1])), np.resize(starts, (n, xs.shape[1]))
    (runs, nan_rows, nan_hist), _ = pgd_sweep(device, "pgd_lcld", cons, sur, scaler, xs, starts, PGD_ROWS)
    log(f"[augmented] pgd_lcld at D = {xs.shape[1]} ({cons.n_constraints} terms) equals pgd_run_plain (x_adv, class, "
        f"history) on all {runs} runs: {len(PGD_CONFIGS)} configurations (rq2's loss among them) x N in {PGD_ROWS} x "
        f"T in {PGD_ITERS[:-1]}, and T = {PGD_ITERS[-1]} at one N each, with phase 7's 14 edge starts and the pair "
        f"terms' {LCLD_AUGMENTED_EDGE_ROWS}; {nan_rows} NaN rows of x_adv, {nan_hist} NaN history entries")
    paths = {"features": f"{art}/features_augmented.csv", "constraints": f"{art}/constraints_augmented.csv"}
    check_immutable_repair(device, "[augmented]", paths, sur, scaler, x, starts,
                           first=14 + LCLD_AUGMENTED_EDGE_ROWS)


def write_aug_artifacts(out: str):
    """Phase 11's artifacts in ``out``: the augmented schema files and
    ``important_features.npy`` (``synthetic_lcld_augmented_problem(4000)``),
    its states, its seeded surrogate by ``save_params`` and its scaler by
    ``save_npz``, under rq2.lcld.static's file names. Returns the problem."""
    from moeva2_ijcai22_replication_tpu_torch.models.io import save_params
    from moeva2_ijcai22_replication_tpu_torch.models.scalers import save_npz
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_augmented_problem

    cons, sur, scaler, x = synthetic_lcld_augmented_problem(out, PGD_STATES)
    np.save(f"{out}/x_candidates_common_augmented.npy", x)
    save_params(sur, f"{out}/nn_augmented.msgpack")
    save_npz(scaler, f"{out}/scaler_augmented.npz")
    return cons, sur, scaler, x


def drive_aug_runners(smi: str, art: str, cons) -> dict:
    """rq2.lcld's four grid points through the runners, and MoEvA at its
    first budget again with ``reconstruction: true``, each with phase 10's
    checks (launch counts as implied, the JAX file names, metrics equal to
    their recomputation, a rerun that skips). Returns the launches summed
    over the four grid points."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.domains import augmentation
    from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash

    total = {k: 0 for k in kernels.launch_counts()}
    for budget in RQ2_GRID["budgets"]:
        for attack in ("moeva", "pgd"):
            cfg = rq2_config(attack, budget, art)
            expected = point_expected_launches(attack, cfg)
            tag = f"{attack} lcld_augmented budget {budget}" + (f" {cfg['loss_evaluation']}" if attack == "pgd" else "")
            metrics = drive_runner(cfg, smi, expected, tag)
            if metrics is not None:
                for k, v in expected.items():
                    total[k] += v
    cfg = rq2_config("moeva", RQ2_GRID["budgets"][0], art, reconstruction=True)
    drive_runner(cfg, smi, point_expected_launches("moeva", cfg), "moeva lcld_augmented reconstruction")
    x_rec = np.load(f"{cfg['dirs']['results']}/x_attacks_moeva_{get_dict_hash(cfg)}.npy")
    base = torch.as_tensor(x_rec[..., : -augmentation.n_pairs(cons.important_features)])
    if not same_entries_np(x_rec, augmentation.augment(base, cons.important_features).numpy()).all():
        raise AssertionError("reconstruction: the saved populations' pair columns are not the XOR of their base")
    log(f"[augmented] reconstruction: true: the saved populations {x_rec.shape} hold the XOR of their base features "
        "in their last columns")
    return total


def run_augmented(device, smi: str, resources: list):
    """Phase 11: the augmented LCLD domain (``lcld_augmented``: 57 features,
    10 + 10 terms). Returns the records of K1 and K7 at D = 57 and the
    launches of the runner drives."""
    import torch

    aug_ptxas = [k for k in resources if k["kernel"] in ("objective_lcld_kernel<128,1,1,0>",
                                                         "objective_lcld_kernel<64,0,1,0>", "pgd_lcld_kernel<1,0>")]
    if len(aug_ptxas) != 3:
        raise AssertionError(f"the build's ptxas report lacks the augmented instantiations: {aug_ptxas}")
    for k in aug_ptxas:
        log(f"[augmented] {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    rng = np.random.default_rng(11)
    gen = torch.Generator(device=device).manual_seed(11)
    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = write_aug_artifacts(tmp)
        log(f"[augmented] problem: {len(x)} states of {x.shape[1]} features, {cons.n_constraints} terms, important "
            f"features {cons.important_features[:, 0].astype(int).tolist()} (thresholds "
            f"{[float(t) for t in cons.important_features[:, 1]]})")
        check_aug_objectives(device, cons, sur, scaler, x[:AUG_STATES], gen, rng)
        eng = rq2_engine(device, cons, sur, scaler, tmp)
        check_aug_stages(device, eng, x)
        check_aug_pgd(device, cons, sur, scaler, x, tmp)
        k1 = time_aug_objective(device, eng, x, smi)
        xs = scaler.transform(x)
        k7, _ = pgd_kernel_record(device, "[augmented]", "pgd_lcld",
                                  "moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py:241",
                                  (cons, sur, scaler, x, xs, surrogate_labels(sur, xs)), RQ2_GRID["eps"] - 1e-6,
                                  PGD_TIMED_ITERS, lambda tables: aug_pgd_bound(tables, len(xs), PGD_BUDGET))
        k7["name"] = "pgd_lcld_aug"
        launches = drive_aug_runners(smi, tmp, cons)
    log(f"[augmented] launches over rq2.lcld's four grid points: {({k: v for k, v in launches.items() if v})}")
    return [k1, k7], launches


# -- phase 12: the augmented botnet domain -------------------------------------------

#: ``config/rq2.botnet.static.yaml``, its artifact paths and results directory
#: replaced by phase 12's; ``tests/test_torch_runner_configs.py`` holds it
#: equal to the file
RQ2_BOTNET_STATIC = {
    "misclassification_threshold": 0.5, "norm": 2, "n_initial_state": -1, "initial_state_offset": 0,
    "system": {"n_jobs": 10, "verbose": 1, "mesh_devices": 0}, "save_history": False,
}
#: ``config/rq2.botnet.yaml``'s grid: seed, ε, its one budget, and its one
#: scenario (the schema, important-features and evaluation paths replaced
#: by phase 12's)
RQ2_BOTNET_GRID = {"seed": 42, "eps": 4, "budget": 1000}
RQ2_BOTNET_SCENARIO = {"project_name": "botnet_augmented", "reconstruction": False,
                       "evaluation": {"project_name": "botnet_augmented"}}
#: rq2.botnet's states: the synthetic stand-in for
#: ``x_candidates_common_augmented.npy`` has rq1.botnet's 387
RQ2_BOTNET_STATES = 387


def rq2_botnet_config(artifacts: str, attack: str = "moeva", loss: str | None = None) -> dict:
    """Phase 12's config of rq2.botnet's grid point, composed as the grid
    runner composes it (``moeva.yaml``, ``rq2.botnet.static``, seed and
    budget, the scenario, then ε), over the artifacts in ``artifacts``; with
    ``attack`` "pgd", the same point for PGD with ``loss`` (no config of the
    repo selects it: phases 12 and 14 drive it through K7b at 927)."""
    import copy

    cfg = copy.deepcopy(MOEVA_YAML if attack == "moeva" else PGD_YAML)
    cfg.update(copy.deepcopy(RQ2_BOTNET_STATIC))
    cfg["paths"] = {
        "model": f"{artifacts}/nn_augmented_19.msgpack",
        "x_candidates": f"{artifacts}/x_candidates_common_augmented.npy",
        "min_max_scaler": f"{artifacts}/scaler_augmented_19.npz",
        "ml_scaler": f"{artifacts}/scaler_augmented_19.npz",
        "features": f"{artifacts}/features_augmented.csv",
        "constraints": f"{artifacts}/constraints_augmented.csv",
        "important_features": f"{artifacts}/important_features_19.npy",
    }
    cfg["dirs"] = {"results": f"{artifacts}/out/botnet/rq2"}
    cfg.update(seed=RQ2_BOTNET_GRID["seed"], budget=RQ2_BOTNET_GRID["budget"])
    cfg.update(copy.deepcopy(RQ2_BOTNET_SCENARIO))
    cfg["evaluation"]["constraints"] = cfg["paths"]["constraints"]
    if attack == "moeva":
        cfg["eps_list"] = [RQ2_BOTNET_GRID["eps"]]
    else:
        cfg.update(eps=RQ2_BOTNET_GRID["eps"], loss_evaluation=loss)
    return cfg


def write_botnet_aug_artifacts(out: str):
    """Phase 12's artifacts in ``out``: the augmented schema files,
    ``feat_idx.pickle`` and ``important_features_19.npy``
    (``synthetic_botnet_augmented_problem(387)``), its states, its seeded
    surrogate by ``save_params`` and its scaler by ``save_npz``, under
    rq2.botnet.static's file names. Returns the problem."""
    from moeva2_ijcai22_replication_tpu_torch.models.io import save_params
    from moeva2_ijcai22_replication_tpu_torch.models.scalers import save_npz
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_augmented_problem

    cons, sur, scaler, x = synthetic_botnet_augmented_problem(out, RQ2_BOTNET_STATES)
    np.save(f"{out}/x_candidates_common_augmented.npy", x)
    save_params(sur, f"{out}/nn_augmented_19.msgpack")
    save_npz(scaler, f"{out}/scaler_augmented_19.npz")
    return cons, sur, scaler, x


def rq2_botnet_engine(device, cons, sur, scaler, artifacts: str):
    """The MoEvA engine that the runner builds for rq2.botnet's grid point
    (``rq2_botnet_config``'s population, offspring, archive, norm, seed,
    budget and chunk)."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2

    cfg = rq2_botnet_config(artifacts)
    return Moeva2(sur, cons, ml_scaler=scaler, device=device, norm=cfg["norm"], n_gen=cfg["budget"],
                  n_pop=cfg["n_pop"], n_offsprings=cfg["n_offsprings"], seed=cfg["seed"],
                  archive_size=cfg["archive_size"], max_states_per_call=cfg["max_states_per_call"])


#: constrained PGD on the augmented botnet domain (K7b's 927-feature
#: instantiation) at rq2.botnet's point: rq1.botnet's last PGD loss without
#: repair, which the set does not have (a ``+repair`` loss is refused before
#: any launch, with JAX's error)
BOTNET_AUG_PGD_LOSS = "constraints+flip+adaptive_eps_step"
#: JAX's error for repair on the set (``domains/botnet.py:148``)
BOTNET_AUG_NO_REPAIR = "Repair is undefined for the augmented botnet domain (reference parity)."
#: the sweep of K7b's 927-feature PGD instantiation: five rows fit a cluster
#: beside the staged layer (66 clusters resident on the H100): a lone row;
#: 66, one row on each resident cluster; 67, two a cluster; 330, five on
#: each; 331, a 67th cluster past them (a second wave); rq2.botnet's 387.
#: Budgets 1 and 7 at every row count, 20 at one
BOTNET_AUG_PGD_ROWS = (1, 66, 67, 330, 331, 387)
BOTNET_AUG_PGD_ITERS = (1, 7, 20)
#: a pair's term, the one ``single_constraints`` optimises in the sweep
BOTNET_AUG_PAIR_TERM = 400
#: both norms, targeted, the sum, the alternate constraints and the single
#: one on a pair term, every history layout ("full": 531 term columns)
BOTNET_AUG_PGD_CONFIGS = (
    dict(loss_evaluation="constraints+flip", norm=2, record_loss="full", record_grad_norm=True),
    dict(loss_evaluation="constraints", norm=np.inf, record_loss="full"),
    dict(loss_evaluation="constraints+flip+constraints", constraints_optim="single_constraints",
         ctr_id=BOTNET_AUG_PAIR_TERM, norm=2, targeted=True, record_loss="full"),
    dict(loss_evaluation="constraints+flip+alternate", constraints_optim="alt_constraints", norm=np.inf,
         record_loss="reduced", record_grad_norm=True),
    dict(loss_evaluation=BOTNET_AUG_PGD_LOSS, norm=2, targeted=True),
)
#: the same under the AutoPGD prefix (the single constraint on the pair
#: term is the tracking loss's too); four rows fit a cluster under kAuto:
#: 264 on the 66 resident clusters, 265 one past them; budgets 1 at every
#: row count and 12 (seven checkpoints, where halving fires) at one
AUTOPGD_BOTNET_AUG_CONFIGS = tuple({**c, "loss_evaluation": "autopgd+" + c["loss_evaluation"]}
                                   for c in BOTNET_AUG_PGD_CONFIGS)
AUTOPGD_BOTNET_AUG_ROWS = (1, 67, 264, 265, 387)
AUTOPGD_BOTNET_AUG_ITERS = (1, 12)


def botnet_augmented_edge_starts(cons, scaler, xs: np.ndarray) -> np.ndarray:
    """Scaled float32 starts of the augmented botnet rows ``xs``: the first
    ``BOTNET_EDGE_ROWS`` at the base terms' edges (``problems.
    botnet_edge_starts``), then ``BOTNET_AUGMENTED_EDGE_ROWS`` at the pair
    terms' edges as ``problems.botnet_augmented_edge_rows`` lays them out,
    each unscaled value exact in float32: every important feature at its
    float32 threshold, every one at the nearest value below it, every one
    NaN, and every pair column at 0, at 1 and at 0.5."""
    from moeva2_ijcai22_replication_tpu_torch.domains.botnet import N_BASE_FEATURES
    from moeva2_ijcai22_replication_tpu_torch.problems import (
        BOTNET_AUGMENTED_EDGE_ROWS, BOTNET_EDGE_ROWS, botnet_edge_starts, scaled_preimage,
    )

    st = botnet_edge_starts(cons.schema.names, scaler, xs)
    r = BOTNET_EDGE_ROWS
    imp = cons.important_features
    for k, t in zip(imp[:, 0].astype(int), imp[:, 1].astype(np.float32)):
        st[r, k] = v = scaled_preimage(t, k, scaler.scale, scaler.min_)
        sc, mn = np.float32(scaler.scale[k]), np.float32(scaler.min_[k])
        while np.float32(np.float32(v - mn) / sc) >= t:
            v = np.nextafter(v, np.float32(-np.inf), dtype=np.float32)
        st[r + 1, k] = v
    st[r + 2, imp[:, 0].astype(int)] = np.nan
    for row, value in ((r + 3, 0.0), (r + 4, 1.0), (r + 5, 0.5)):
        for k in range(N_BASE_FEATURES, xs.shape[1]):
            st[row, k] = scaled_preimage(value, k, scaler.scale, scaler.min_)
    assert BOTNET_AUGMENTED_EDGE_ROWS == 6
    return st


def pgd_botnet_aug_record(device, problem, base_problem, auto: bool):
    """The record of K7b's 927-feature instantiation (its AutoPGD one where
    ``auto``) at ``problem``'s states x ``PGD_BUDGET`` iterations
    (``BOTNET_AUG_PGD_LOSS``, under the prefix where ``auto``; L2, ε
    ``PGD_BOTNET_EPS`` - 1e-6, from x_init): device ms (CUDA graph of 2
    launches) in turns with base K7b's same instantiation at 756 features on
    ``base_problem`` (phase 9's, 387 rows) at the same loss, wrapper ms, the
    plain version at ``PGD_BOTNET_PLAIN_ITERS`` iterations (held equal to
    the kernel there), the bound, the latency floor and the launch's shape.
    Returns it and the attack."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain

    loss = ("autopgd+" if auto else "") + BOTNET_AUG_PGD_LOSS
    eps, step = PGD_BOTNET_EPS - 1e-6, (PGD_BOTNET_EPS / 3 if auto else 0.1)
    cls = AutoPGD if auto else ConstrainedPGD

    def run(prob, t):
        cons, sur, scaler, _, xs, y = prob
        atk = cls(sur, cons, scaler, eps=eps, eps_step=step, max_iter=t, norm=2, loss_evaluation=loss, device=device)
        xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
        yt = torch.as_tensor(y, device=device)
        sched = atk.schedule(eps, step, t)
        extra = {"auto": sched.auto} if auto else {}
        fn = lambda: kernels.pgd_botnet(atk.tables, sched.pgd if auto else sched, xi, yt, xi, eps,  # noqa: E731
                                        atk.clip, False, False, False, **extra)
        return atk, sched, xi, yt, fn

    atk, _, xi, yt, main = run(problem, PGD_BUDGET)
    base = run(base_problem, PGD_BUDGET)[-1]
    times = {"aug": [], "base": []}
    for turn in ("aug", "base", "base", "aug"):
        times[turn].append(graph_ms(main if turn == "aug" else base, launches=2, repeats=2))
    small, sched, _, _, fn = run(problem, PGD_BOTNET_PLAIN_ITERS)
    plain = autopgd_run_plain if auto else pgd_run_plain
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(small.tables, small.constraints, sched, xi, yt, xi, eps, small.clip, 2, False, False)
    end.record()
    torch.cuda.synchronize()
    for part, g, w in zip(("x_adv", "pred", "hist", "eta"), fn(), want):
        if g is not None:
            hold_equal(g, w, f"pgd_botnet at 927 features{' (AutoPGD)' if auto else ''}, {len(xi)} x "
                             f"{PGD_BOTNET_PLAIN_ITERS}, {part}")
    n = len(xi)
    b_ms, b_by = (autopgd_botnet_bound if auto else pgd_botnet_bound)(atk.tables, n, PGD_BUDGET)
    mhz = max_sm_clock_mhz()
    rec = {
        "name": "pgd_botnet_aug" + ("_auto" if auto else ""),
        "route": "cuda",
        "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/pgd_botnet.cu",
        "replaces": ("moeva2_ijcai22_replication_tpu/attacks/pgd/autopgd.py:45" if auto
                     else "moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py:241"),
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": statistics.median(times["aug"]),
        "runs_ms": times["aug"],
        "base_756_ms": statistics.median(times["base"]),
        "base_756_runs_ms": times["base"],
        "wrapper_ms": cuda_ms(main, launches=1, repeats=2),
        "plain_ms": start.elapsed_time(end),
        "plain_iters": PGD_BOTNET_PLAIN_ITERS,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "ceiling_ms": (autopgd_botnet_floor_ms(atk.tables, PGD_BUDGET, mhz) if auto
                       else pgd_botnet_floor_ms(atk.tables, PGD_BUDGET, mhz)),
        "launch": pgd_botnet_shape(atk.tables, n, autopgd=auto),
        "library_ms": None,
    }
    sh = rec["launch"]
    tag = "[autopgd-botnet-augmented]" if auto else "[botnet-augmented]"
    label = "K7b's AutoPGD instantiation" if auto else "K7b"
    log(f"{tag} {label} at D = 927 ({atk.constraints.n_constraints} terms), {n} states x {PGD_BUDGET} iterations "
        f"({loss}, L2, ε {PGD_BOTNET_EPS}): device {rec['ms']:.3f} ms (runs {[round(v, 3) for v in times['aug']]}), "
        f"in turns with {label} at D = 756 on phase 9's {n} states at the same loss "
        f"{rec['base_756_ms']:.3f} ms (runs {[round(v, 3) for v in times['base']]}, "
        f"{rec['ms'] / rec['base_756_ms']:.2f}x); through the wrapper {rec['wrapper_ms']:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}), {rec['ms'] / b_ms:.2f}x; latency floor {rec['ceiling_ms']:.3f} ms (at {mhz:.0f} "
        f"MHz), {rec['ms'] / rec['ceiling_ms']:.2f}x; plain version at {PGD_BOTNET_PLAIN_ITERS} iterations "
        f"{rec['plain_ms']:.1f} ms, equal to the kernel there")
    log(f"{tag} {label}'s launch at D = 927, {n} rows: clusters of {sh['ctas_per_cluster']} CTAs of "
        f"{sh['threads']} threads, {sh['rows_per_cluster']} rows per cluster, {sh['ctas'] // sh['ctas_per_cluster']} "
        f"clusters ({sh['resident_clusters']} resident at once: "
        f"{-(-sh['ctas'] // sh['ctas_per_cluster'] // sh['resident_clusters'])} wave(s)), {sh['smem_bytes']} bytes "
        "of shared memory per CTA")
    return rec, atk


def check_botnet_aug_repair_refused(device, tag: str, art: str, problem, auto: bool) -> None:
    """A ``+repair`` loss on the augmented botnet domain (``BOTNET_AUG_PGD_LOSS
    + "+repair"``, under the AutoPGD prefix where ``auto``) raises JAX's
    ``NotImplementedError`` on the card before any launch: ``generate`` with
    one random start, and the PGD runner on rq2.botnet's point, which writes
    nothing."""
    import os

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.experiments import pgd

    cons, sur, scaler, _, xs, y = problem
    loss = ("autopgd+" if auto else "") + BOTNET_AUG_PGD_LOSS + "+repair"
    cls = AutoPGD if auto else ConstrainedPGD
    cfg = rq2_botnet_config(art, "pgd", loss)
    out = cfg["dirs"]["results"]
    kernels.reset_launch_counts()
    before = dir_state(out) if os.path.isdir(out) else {}
    for what, call in (
        ("generate", lambda: cls(sur, cons, scaler, loss_evaluation=loss, max_iter=PGD_BUDGET, norm=2,
                                 num_random_init=1, device=device).generate(xs, y, eps=PGD_BOTNET_EPS - 1e-6)),
        ("experiments.pgd.run", lambda: pgd.run(cfg)),
    ):
        try:
            call()
        except NotImplementedError as exc:
            if str(exc) != BOTNET_AUG_NO_REPAIR:
                raise AssertionError(f"{what} refused {loss} on botnet_augmented with another error: {exc}") from exc
        else:
            raise AssertionError(f"{what} ran {loss} on botnet_augmented, whose repair is undefined")
    written = {f for f in (dir_state(out) if os.path.isdir(out) else {}) if f not in before}
    if any(kernels.launch_counts().values()) or written:
        raise AssertionError(f"the refused {loss} launched {kernels.launch_counts()} or wrote {sorted(written)}")
    log(f"{tag} {loss} on botnet_augmented raises JAX's NotImplementedError ({BOTNET_AUG_NO_REPAIR!r}) on the card "
        "before any launch, in generate and in the PGD runner (nothing written)")


def run_botnet_aug_pgd(device, smi: str, resources: list, art: str, cons, sur, scaler, x):
    """Phase 12's PGD part: constrained PGD on the augmented botnet domain
    through K7b's 927-feature instantiation, over phase 12's artifacts in
    ``art``: its ptxas line; the sweep against ``pgd_run_plain`` bit for bit
    with the edge starts; its record at 387 x 1000 beside base K7b at 756;
    ``generate`` cold and steady (one launch); the card against the CPU at 32
    x 20 and 2 restarts; rq2.botnet's point under PGD through the runner at
    budget 1000; a ``+repair`` loss refused. Returns the record and the
    launches of ``generate``."""
    from moeva2_ijcai22_replication_tpu_torch.problems import BOTNET_AUGMENTED_EDGE_ROWS, BOTNET_EDGE_ROWS

    ptxas = [k for k in resources if k["kernel"] == "pgd_botnet_aug_kernel<0>"]
    if len(ptxas) != 1:
        raise AssertionError(f"the build's ptxas report has no entry for pgd_botnet_aug_kernel<0>: {ptxas}")
    k = ptxas[0]
    log(f"[botnet-augmented] K7b at 927 features, PGD: {k['kernel']}: {k['registers']} registers, {k['stack']} "
        f"bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    xs = scaler.transform(x)
    problem = (cons, sur, scaler, x, xs, surrogate_labels(sur, xs))
    starts = botnet_augmented_edge_starts(cons, scaler, xs)
    n = max(BOTNET_AUG_PGD_ROWS)
    (runs, nan_rows, nan_hist), y = pgd_sweep(device, "pgd_botnet", cons, sur, scaler,
                                              np.resize(xs, (n, xs.shape[1])), np.resize(starts, (n, xs.shape[1])),
                                              BOTNET_AUG_PGD_ROWS, BOTNET_AUG_PGD_CONFIGS, BOTNET_AUG_PGD_ITERS)
    log(f"[botnet-augmented] pgd_botnet at D = 927 ({cons.n_constraints} terms) equals pgd_run_plain (x_adv, class, "
        f"history with {cons.n_constraints} term columns) on all {runs} runs: {len(BOTNET_AUG_PGD_CONFIGS)} "
        f"configurations (both norms, targeted, the single constraint on pair term {BOTNET_AUG_PAIR_TERM}) x N in "
        f"{BOTNET_AUG_PGD_ROWS} x T in {BOTNET_AUG_PGD_ITERS[:-1]}, and T = {BOTNET_AUG_PGD_ITERS[-1]} at one N "
        f"each, with {BOTNET_EDGE_ROWS} base-term and {BOTNET_AUGMENTED_EDGE_ROWS} pair-term edge starts; "
        f"{nan_rows} NaN rows of x_adv, {nan_hist} NaN history entries")
    rec, _ = pgd_botnet_aug_record(device, problem, pgd_botnet_problem(), auto=False)
    launches = drive_pgd(device, smi, f"[botnet-augmented ε {PGD_BOTNET_EPS}]", "pgd_botnet_aug", problem,
                         PGD_BOTNET_EPS, 0.5, np.zeros(x.shape[1], bool), loss=BOTNET_AUG_PGD_LOSS)
    check_pgd_card_vs_cpu(device, "[botnet-augmented]", "pgd_botnet_aug", problem, PGD_BOTNET_EPS,
                          PGD_BOTNET_CPU_ROWS, PGD_BOTNET_CPU_ITERS, loss=BOTNET_AUG_PGD_LOSS)
    cfg = rq2_botnet_config(art, "pgd", BOTNET_AUG_PGD_LOSS)
    drive_runner(cfg, smi, point_expected_launches("pgd", cfg),
                 f"pgd botnet_augmented budget {cfg['budget']} {BOTNET_AUG_PGD_LOSS}")
    check_botnet_aug_repair_refused(device, "[botnet-augmented]", art, problem, auto=False)
    return rec, launches["pgd_botnet_aug"]


def run_autopgd_botnet_aug(device, smi: str, resources: list):
    """Phase 14's augmented botnet part: K7b's 927-feature AutoPGD
    instantiation, its ptxas line; the sweep against ``autopgd_run_plain``
    bit for bit (x_best, class, history, eta) with the edge starts, rows
    halved and kept at T = 12; its record at 387 x 1000 beside K7b's AutoPGD
    instantiation at 756; ``generate`` (one random start: one launch); the
    card against the CPU at 32 x 20 and 2 restarts; rq2.botnet's point under
    the ``autopgd+`` prefix through the runner; a ``+repair`` loss refused.
    Returns the record and the launches of ``generate``."""
    from moeva2_ijcai22_replication_tpu_torch.problems import BOTNET_AUGMENTED_EDGE_ROWS, BOTNET_EDGE_ROWS

    ptxas = [k for k in resources if k["kernel"] == "pgd_botnet_aug_kernel<1>"]
    if len(ptxas) != 1:
        raise AssertionError(f"the build's ptxas report has no entry for pgd_botnet_aug_kernel<1>: {ptxas}")
    k = ptxas[0]
    log(f"[autopgd-botnet-augmented] K7b at 927 features, AutoPGD: {k['kernel']} (kAuto): {k['registers']} "
        f"registers, {k['stack']} bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + "
        "loads")
    loss = "autopgd+" + BOTNET_AUG_PGD_LOSS
    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = write_botnet_aug_artifacts(tmp)
        xs = scaler.transform(x)
        problem = (cons, sur, scaler, x, xs, surrogate_labels(sur, xs))
        starts = botnet_augmented_edge_starts(cons, scaler, xs)
        n = max(AUTOPGD_BOTNET_AUG_ROWS)
        runs, halved, kept, nan_rows = autopgd_sweep(device, "pgd_botnet", cons, sur, scaler,
                                                     np.resize(xs, (n, xs.shape[1])),
                                                     np.resize(starts, (n, xs.shape[1])), AUTOPGD_BOTNET_AUG_ROWS,
                                                     AUTOPGD_BOTNET_AUG_ITERS, AUTOPGD_BOTNET_AUG_CONFIGS)
        log(f"[autopgd-botnet-augmented] K7b's AutoPGD instantiation at D = 927 equals autopgd_run_plain (x_best, "
            f"class, history, eta) on all {runs} runs: {len(AUTOPGD_BOTNET_AUG_CONFIGS)} configurations x N in "
            f"{AUTOPGD_BOTNET_AUG_ROWS} x T = {AUTOPGD_BOTNET_AUG_ITERS[0]}, and T = {AUTOPGD_BOTNET_AUG_ITERS[-1]} at "
            f"one N each, with {BOTNET_EDGE_ROWS} base-term and {BOTNET_AUGMENTED_EDGE_ROWS} pair-term edge starts; "
            f"at T >= 12 {halved} rows halved their step and {kept} kept it; {nan_rows} NaN rows of x_best")
        rec, _ = pgd_botnet_aug_record(device, problem, pgd_botnet_problem(), auto=True)
        launches = drive_autopgd(device, smi, "[autopgd-botnet-augmented]", "pgd_botnet_aug_auto", problem, loss,
                                 PGD_BOTNET_EPS, np.zeros(x.shape[1], bool), 0.5)
        check_autopgd_card_vs_cpu(device, "[autopgd-botnet-augmented]", "pgd_botnet_aug_auto", problem,
                                  PGD_BOTNET_CPU_ROWS, PGD_BOTNET_CPU_ITERS, PGD_BOTNET_EPS, loss=loss)
        cfg = rq2_botnet_config(tmp, "pgd", loss)
        drive_runner(cfg, smi, point_expected_launches("pgd", cfg), f"pgd botnet_augmented budget {cfg['budget']} "
                     f"{loss}")
        check_botnet_aug_repair_refused(device, "[autopgd-botnet-augmented]", tmp, problem, auto=True)
    return rec, launches["pgd_botnet_aug_auto"]


def run_botnet_augmented(device, smi: str, resources: list):
    """Phase 12: the augmented botnet domain (``botnet_augmented``: 927
    features, 360 + 171 terms). Returns K8's record at D = 927, the
    launches of rq2.botnet's grid point, K5's and K4b's times at L = 927,
    and the record and ``generate`` launches of K7b's 927-feature PGD
    instantiation."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.core.schema import FeatureSchema
    from moeva2_ijcai22_replication_tpu_torch.domains import augmentation
    from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_botnet

    ptxas = [k for k in resources if k["kernel"] in ("objective_botnet_kernel<0,0>", "objective_botnet_kernel<1,0>")]
    if len(ptxas) != 2:
        raise AssertionError(f"the build's ptxas report lacks K8's two instantiations: {ptxas}")
    for k in ptxas:
        log(f"[botnet-augmented] {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    gen = torch.Generator(device=device).manual_seed(12)
    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = write_botnet_aug_artifacts(tmp)
        imp = cons.important_features
        log(f"[botnet-augmented] problem: {len(x)} states of {x.shape[1]} features, {cons.n_constraints} terms, "
            f"important features {imp[:, 0].astype(int).tolist()}")
        base = synth_botnet(max(BOTNET_SWEEP_STATES), FeatureSchema.from_csv(f"{tmp}/features.csv"), seed=43)
        x_sweep = augmentation.augment(torch.as_tensor(base), imp).numpy()
        eng = rq2_botnet_engine(device, cons, sur, scaler, tmp)
        check_botnet_kernel(device, eng, x_sweep, gen, tag="[botnet-augmented]")
        check_aug_stages(device, eng, x, tag="[botnet-augmented]", states=BOTNET_PATH_STATES)
        rec = time_botnet_kernel(device, eng, x, gen, tag="[botnet-augmented]", name="objective_botnet_aug",
                                 replaces="moeva2_ijcai22_replication_tpu/domains/botnet.py:144")
        stage_times = time_botnet_stages(device, eng, x_sweep, gen, rng, smi, tag="[botnet-augmented]")
        smem = botnet_smem_bytes(eng)
        log(f"[botnet-augmented] K8 at D = {x.shape[1]}: {smem} bytes of shared memory a block, "
            f"{min(KMAX_SHARED_BYTES // smem, 2)} block(s) of 8 warps an SM (its launch bounds allow 2)")
        cfg = rq2_botnet_config(tmp)
        expected = point_expected_launches("moeva", cfg)
        if expected["objective_botnet_aug"] == 0 or expected["objective_botnet"] != 0:
            raise AssertionError(f"rq2.botnet's objectives are not K8's augmented instantiation's: {expected}")
        drive_runner(cfg, smi, expected, "moeva botnet_augmented budget 1000")
        t1 = time.perf_counter()
        pgd_rec, pgd_launches = run_botnet_aug_pgd(device, smi, resources, tmp, cons, sur, scaler, x)
        log(f"[botnet-augmented] phase 12's PGD part took {time.perf_counter() - t1:.1f} s")
    log(f"[botnet-augmented] launches over rq2.botnet's grid point: {({k: v for k, v in expected.items() if v})}; "
        f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return rec, expected, stage_times, pgd_rec, pgd_launches


#: the shared memory one block can use on Hopper (``kMaxSharedBytes``)
KMAX_SHARED_BYTES = 232448


def botnet_smem_bytes(moeva) -> int:
    """K8's shared bytes of one block for ``moeva``'s objective tables, as
    its launcher sizes them
    (``botnet_smem`` in ``objective_botnet.cu``): the tile's features (at
    least the two activation buffers and a deeper layer's weights), the
    double buffer, the rows' sums, the gather lists and the pair tables.
    Held against the library's own limit, which loops on ``botnet_smem``:
    the largest ``d`` it takes fits, one more does not."""
    from moeva2_ijcai22_replication_tpu_torch.kernels.build import library

    obj, cons = moeva._objective, moeva._objective.cons
    h1, tile, chunk, width = obj.layers[0][0].shape[0], 32, 16, 64
    pairs = 0 if cons.pair_idx is None else cons.pair_idx.shape[0]

    def smem(d):
        xf = max(d * tile, 2 * width * tile + width * (width + 1))
        return 4 * (xf + 2 * chunk * (2 * tile + h1) + 2 * tile + 2 * pairs) + 2 * (sum(cons.counts) + 2 * pairs)

    top = library().moeva_objective_botnet_max_features(h1, sum(cons.counts), pairs)
    if not smem(top) <= KMAX_SHARED_BYTES < smem(top + 1):
        raise AssertionError(f"K8's shared memory is not botnet_smem's: {smem(top)}, {smem(top + 1)} at d = {top}")
    return smem(moeva.codec.n_features)


# -- phase 13: the grid runner --------------------------------------------------------

#: the ten grid files of ``config/`` that phase 13 runs, in ``run_all``'s order
GRID_FILES = ("rq1.lcld.yaml", "rq1.botnet.yaml", "rq2.lcld.yaml", "rq2.botnet.yaml", "rq3.lcld.yaml",
              "rq3.botnet.yaml", "sm1.1.lcld.yaml", "sm1.2.lcld.yaml", "sm1.1.botnet.yaml", "sm1.2.botnet.yaml")
#: the static project files the grids name, and the artifact set each reads
GRID_STATICS = {
    "rq1.lcld.static": "lcld", "rq1.botnet.static": "botnet", "rq2.lcld.static": "lcld_augmented",
    "rq2.botnet.static": "botnet_augmented", "rq3.lcld.static": "lcld", "rq3.botnet.static": "botnet",
    "sm1.lcld.static": "lcld", "sm1.botnet.static": "botnet",
}
#: each artifact set's files (phases 10-12's), by the configs' ``paths`` keys
GRID_ARTIFACTS = {
    "lcld": {"model": "nn.msgpack", "features": "features.csv", "constraints": "constraints.csv",
             "x_candidates": "x_candidates_common.npy", "min_max_scaler": "scaler.npz", "ml_scaler": "scaler.npz"},
    "lcld_augmented": {"model": "nn_augmented.msgpack", "features": "features_augmented.csv",
                       "constraints": "constraints_augmented.csv",
                       "x_candidates": "x_candidates_common_augmented.npy",
                       "min_max_scaler": "scaler_augmented.npz", "ml_scaler": "scaler_augmented.npz"},
    "botnet_augmented": {"model": "nn_augmented_19.msgpack", "features": "features_augmented.csv",
                         "constraints": "constraints_augmented.csv",
                         "important_features": "important_features_19.npy",
                         "x_candidates": "x_candidates_common_augmented.npy",
                         "min_max_scaler": "scaler_augmented_19.npz", "ml_scaler": "scaler_augmented_19.npz"},
}
GRID_ARTIFACTS["botnet"] = GRID_ARTIFACTS["lcld"]
#: rq3's models axis: more seeded surrogates of the set's topology, by file
#: name (rq3.botnet's Keras model becomes a ``.msgpack``)
GRID_MODEL_SEEDS = {("lcld", "nn_moeva.msgpack"): 17, ("lcld", "nn_gradient.msgpack"): 18,
                    ("botnet", "nn_moeva.msgpack"): 19}
#: the one cut of phase 13, by file (a tuple lists the entries taken out of
#: the file's list, another value replaces the file's): ``flip+sat`` leaves rq1.lcld's and the sm1.2 grids'
#: losses. Its MILP repair is host work, about 0.04 s a state on the card's
#: machine (phase 10's SAT line): 4000 LCLD states add about 160 s a point, and sm1.2 runs
#: each loss at 15 points. rq1.botnet keeps it, so the grid path through the
#: MILP repair runs (387 states)
GRID_CUTS = {
    "rq1.lcld.yaml": {"loss_evaluations": ("flip+sat",)},
    "sm1.2.lcld.yaml": {"loss_evaluations": ("flip+sat",)},
    "sm1.2.botnet.yaml": {"loss_evaluations": ("flip+sat",)},
}
#: LCLD's ratio terms (g5 = |x20 - x0/x6|, g6 = |x21 - x10/x14|, g8, g9),
#: each infinite (or 0/0) where its denominator reaches its lower bound 0
RATIO_POLE_TERMS = (4, 5, 7, 8)
#: the terms that go non-finite first where x22 reaches 0 (g8 and g9 share it)
X22 = "g8 g9"
#: the grid points whose result the judgement refuses (ROADMAP C5), by
#: (project, loss, budget, ε): the rows of x_adv that must be NaN for each,
#: and for each row the ratio terms that are the first of its violations to
#: go non-finite (its denominator at 0; then the L2 step turns the row NaN).
#: Phase 10's point (rq1.lcld's and sm1.2.lcld's at 1000 iterations and
#: ε 0.2) and sm1.2.lcld's ``constraints+flip`` at ε 0.1, 0.2 and 0.4 at
#: every budget, found on the card: x22 at 0 in every row but 2357
#: at 2000 iterations, where x14 reaches 0 first (g6); none at ε 0.025 and
#: 0.05, none for another loss, none on rq1.lcld at 100 iterations
GRID_NAN_REFUSALS = {
    ("lcld", "constraints+flip", 1000, 0.2): dict.fromkeys(NAN_REFUSALS[("lcld", "constraints+flip")], X22),
    ("lcld", "constraints+flip", 500, 0.1): dict.fromkeys((137, 1853, 2989, 3173), X22),
    ("lcld", "constraints+flip", 500, 0.2): dict.fromkeys((2989, 3621), X22),
    ("lcld", "constraints+flip", 500, 0.4): dict.fromkeys((2989, 3621), X22),
    ("lcld", "constraints+flip", 1000, 0.1): dict.fromkeys((137, 1853, 2989, 3173), X22),
    ("lcld", "constraints+flip", 1000, 0.4): dict.fromkeys((1782, 2109, 2989, 3536, 3621), X22),
    ("lcld", "constraints+flip", 2000, 0.1): dict.fromkeys((137, 1853, 2989, 3173), X22),
    ("lcld", "constraints+flip", 2000, 0.2): {**dict.fromkeys((437, 795, 1056, 1782), X22), 2357: "g6",
                                              **dict.fromkeys((2929, 2989, 3173, 3536, 3621), X22)},
    ("lcld", "constraints+flip", 2000, 0.4): {**dict.fromkeys((137, 795, 1296, 1782, 1857, 1887, 2109), X22),
                                              2357: "g6", **dict.fromkeys((2989, 3536, 3621), X22)},
}


def grid_artifact_path(kind: str, key: str, art: str) -> str:
    return f"{art}/{kind}/{GRID_ARTIFACTS[kind][key]}"


def apply_cuts(body: dict, name: str) -> None:
    """``GRID_CUTS`` of the file ``name`` applied to its ``body``: a tuple
    takes its entries out of the file's list, any other value replaces the
    file's."""
    for key, cut in GRID_CUTS.get(name, {}).items():
        body[key] = [v for v in body[key] if v not in cut] if isinstance(cut, tuple) else cut


def write_grid_config_dir(tmp: str, art: str) -> str:
    """Phase 13's ``config_dir``, ``tmp``/config: ``moeva.yaml`` and
    ``pgd.yaml`` copied as they are; each static file of ``GRID_STATICS``
    with the artifact paths it names taken from its set in ``art`` and
    ``dirs.results`` moved under ``tmp``; each grid of ``GRID_FILES`` with
    ``config_dir`` pointing here, its scenari's and models' paths taken
    from ``art``, and ``GRID_CUTS`` applied. Returns the directory."""
    import os
    import shutil

    import yaml

    from moeva2_ijcai22_replication_tpu_torch.utils.config import load_config_file

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config")
    out = os.path.join(tmp, "config")
    os.makedirs(out, exist_ok=True)
    for name in ("moeva.yaml", "pgd.yaml"):
        shutil.copy(os.path.join(src, name), os.path.join(out, name))

    def dump(body: dict, name: str):
        with open(os.path.join(out, name), "w") as f:
            yaml.safe_dump(body, f)

    for static, kind in GRID_STATICS.items():
        body = load_config_file(os.path.join(src, f"{static}.yaml"))
        body["paths"] = {key: grid_artifact_path(kind, key, art) for key in body["paths"]}
        body["dirs"]["results"] = os.path.join(tmp, body["dirs"]["results"].removeprefix("./"))
        apply_cuts(body, f"{static}.yaml")
        dump(body, f"{static}.yaml")
    for name in GRID_FILES:
        grid = load_config_file(os.path.join(src, name))
        grid["config_dir"] = out
        for scenario in grid.get("scenari", []):
            kind = scenario["project_name"]
            scenario["paths"] = {key: grid_artifact_path(kind, key, art) for key in scenario["paths"]}
            scenario["evaluation"]["constraints"] = grid_artifact_path(kind, "constraints", art)
        if "models" in grid:
            kind = GRID_STATICS[grid["projects"][0]]
            grid["models"] = [f"{art}/{kind}/{os.path.splitext(os.path.basename(m))[0]}.msgpack"
                              for m in grid["models"]]
        apply_cuts(grid, name)
        dump(grid, name)
    return out


def write_grid_artifacts(art: str) -> None:
    """Phases 10-12's artifacts again, a set a directory of ``art``, and
    rq3's seeded surrogates (``GRID_MODEL_SEEDS``)."""
    import os

    from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, save_params
    from moeva2_ijcai22_replication_tpu_torch.models.mlp import botnet_mlp, lcld_mlp

    for kind in GRID_ARTIFACTS:
        os.makedirs(f"{art}/{kind}", exist_ok=True)
    write_runner_artifacts("lcld", f"{art}/lcld")
    write_runner_artifacts("botnet", f"{art}/botnet")
    write_aug_artifacts(f"{art}/lcld_augmented")
    write_botnet_aug_artifacts(f"{art}/botnet_augmented")
    for (kind, name), seed in GRID_MODEL_SEEDS.items():
        mlp = lcld_mlp(47, seed=seed) if kind == "lcld" else botnet_mlp(756, seed=seed)
        save_params(Surrogate(mlp), f"{art}/{kind}/{name}")


class GridFailures:
    """Keeps the error records of the port's experiment layer while open:
    the grid runner's "grid point failed" and the writer's "grid point
    finalize failed", each with its exception."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler(logging.ERROR)
        self.handler.emit = self.records.append
        self.logger = logging.getLogger("moeva2_ijcai22_replication_tpu_torch.experiments")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def quiet(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the runners' prints of configs and rates
    (from both threads) kept off the smoke's output."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def grid_points(grid: dict) -> list:
    """The (runner, config) of every point of ``grid`` in launch order, as
    the port's ``GridRunner`` expands it."""
    import copy

    from moeva2_ijcai22_replication_tpu_torch.experiments import rq

    points = []
    runner = rq.GridRunner(dict(copy.deepcopy(grid), pipeline=False))
    runner._launch = lambda module, cfg: points.append((module.rsplit(".", 1)[1], cfg))
    runner.run()
    return points


def check_grid_refusals(name: str, refused: list, failures: list) -> list:
    """The points of grid ``name`` that wrote nothing (``refused``, as
    (runner, config)) must be C5's refusals: as many failure records as
    refused points, each the judgement's ``AssertionError``; each point a
    PGD point of ``GRID_NAN_REFUSALS`` whose attack, run again alone, leaves
    exactly the pinned rows NaN, each first non-finite in the pinned ratio
    terms (``pole_rows_of_pgd``). Returns the lines to log."""
    exc = [(r.exc_info or (None, None))[1] for r in failures]
    bad = [e for e in exc if not (isinstance(e, AssertionError) and "min-max scaled values outside" in str(e))]
    if bad or len(failures) != len(refused):
        raise AssertionError(f"[grid] {name}: {len(refused)} points wrote nothing; failures: "
                             + "; ".join(f"{r.getMessage()}: {e!r}" for r, e in zip(failures, exc)))
    lines = []
    for runner, cfg in refused:
        key = (cfg["project_name"], cfg.get("loss_evaluation"), cfg["budget"], cfg.get("eps"))
        rows, first, terms, _ = (pole_rows_of_pgd(cfg, plain=False, poles=RATIO_POLE_TERMS) if runner == "pgd"
                                 else ((), [None], [], None))
        pinned = GRID_NAN_REFUSALS.get(key)
        if pinned is None or rows != tuple(pinned) or None in first or terms != list(pinned.values()):
            raise AssertionError(f"[grid] {name}: the judgement refused point {key}; x_adv's NaN rows are {rows}, "
                                 f"first non-finite at iterations {first} in {terms}; pinned: {pinned}")
        lines.append(f"[grid] {name}: {key} refused by the judgement's AssertionError (ROADMAP C5): x_adv rows "
                     f"{list(rows)} NaN, as pinned, each after a ratio term's denominator reached 0 (first "
                     f"non-finite at iterations {first}: {terms})")
    return lines


def run_grid(name: str, config_dir: str, over: dict | None = None, **kwargs) -> dict:
    """One grid file of ``config_dir`` (with ``over`` merged into it)
    through ``experiments.rq.run(grid, **kwargs)`` on the card, the launch
    counts set to 0 just before and read just after. Then: every point's
    files, its metrics equal to their recomputation from its saved
    ``x_attacks``, the launches its points imply (not countable across
    processes under ``use_subprocess``), the refusals
    (``check_grid_refusals``) and the grid report's counts. Returns the
    report (a pipelined grid's), with the grid's points, launches, wall
    time and the points' summed ``evaluate`` spans."""
    import os

    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.experiments import rq
    from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash, load_config_file

    grid = {**load_config_file(os.path.join(config_dir, name)), **(over or {})}
    points = grid_points(grid)
    out_dirs = sorted({cfg["dirs"]["results"] for _, cfg in points})
    before = {d: set(os.listdir(d)) if os.path.isdir(d) else set() for d in out_dirs}
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with GridFailures() as failures:
        n = quiet(rq.run, grid, **kwargs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if n != len(points):
        raise AssertionError(f"[grid] {name}: rq.run launched {n} points, the grid has {len(points)}")
    written = {d: (set(os.listdir(d)) if os.path.isdir(d) else set()) - before[d] for d in out_dirs}
    expected = {k: 0 for k in launches}
    refused = []
    for runner, cfg in points:
        files = point_files(runner, cfg)
        got = written[cfg["dirs"]["results"]] & files
        if not got:
            refused.append((runner, cfg))
        elif got != files:
            raise AssertionError(f"[grid] {name}: a point wrote {sorted(got)}, not {sorted(files)}")
        for k, v in point_expected_launches(runner, cfg).items():
            expected[k] += v
    if not kwargs.get("use_subprocess"):
        check_launches(launches, expected, f"the {name} grid")
    evaluate_s = 0.0
    for runner, cfg in points:
        if (runner, cfg) in refused:
            continue
        out, mid, h = cfg["dirs"]["results"], point_mid_fix(runner, cfg), get_dict_hash(cfg)
        with open(f"{out}/metrics_{mid}_{h}.json") as f:
            metrics = json.load(f)
        # this process loaded the kernel library in phase 2; a subprocess
        # loads it during a PGD point's attack (K16's labels) and in a
        # MoEvA point's setup (the engine's K14), before its attack
        fresh = bool(kwargs.get("use_subprocess")) and runner == "pgd"
        if metrics["config_hash"] != h or metrics["includes_compile"] != fresh:
            raise AssertionError(f"[grid] {name}: {mid} {h}: hash {metrics['config_hash']}, includes_compile "
                                 f"{metrics['includes_compile']} (use_subprocess {kwargs.get('use_subprocess')})")
        rates = recomputed_rates(runner, cfg, np.load(f"{out}/x_attacks_{mid}_{h}.npy"))
        if rates != point_rates(runner, metrics):
            raise AssertionError(f"[grid] {name}: {mid} {h}: metrics {point_rates(runner, metrics)} != their "
                                 f"recomputation {rates}")
        evaluate_s += metrics["timings"].get("evaluate", 0.0)
    report = {}
    if not kwargs.get("use_subprocess") and grid.get("pipeline", True):
        with open(f"{out_dirs[0]}/grid_report_{get_dict_hash(grid)}.json") as f:
            report = json.load(f)
        want = (len(points), len(points), 0, len(points), len(refused))
        got = (report["points_total"], report["points_launched"], report["points_skipped"],
               report["writer"]["submitted"], len(report["writer"]["failures"]))
        if got != want:
            raise AssertionError(f"[grid] {name}: the report's (total, launched, skipped, submitted, writer "
                                 f"failures) {got} != the grid's {want}")
    lines = check_grid_refusals(name, refused, failures.records)
    report.update(points=points, launches=launches, refused=len(refused), wall_s=wall_s, lines=lines,
                  evaluate_sum_s=evaluate_s, checks_s=time.perf_counter() - t0 - wall_s)
    return report


def point_outputs(runner: str, cfg: dict, out: str | None = None):
    """``(x_attacks, rates)`` the point of ``cfg`` wrote to ``out`` (its
    results directory by default), or None when it wrote no metrics."""
    from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash

    out, mid, h = out or cfg["dirs"]["results"], point_mid_fix(runner, cfg), get_dict_hash(cfg)
    if not os.path.exists(f"{out}/metrics_{mid}_{h}.json"):
        return None
    with open(f"{out}/metrics_{mid}_{h}.json") as f:
        return np.load(f"{out}/x_attacks_{mid}_{h}.npy"), point_rates(runner, json.load(f))


def same_outputs(a, b) -> bool:
    """Whether two ``point_outputs`` are equal, the arrays bit for bit."""
    if a is None or b is None:
        return a is b
    return a[0].shape == b[0].shape and bool(same_entries_np(a[0], b[0]).all()) and a[1] == b[1]


def check_standalone(tag: str, runner: str, cfg: dict, tmp: str) -> None:
    """A grid point against the standalone runner on a fresh engine
    (``ENGINES`` cleared), in a results directory of its own: the same
    ``x_attacks`` bit for bit and the same rates."""
    import copy

    from moeva2_ijcai22_replication_tpu_torch.experiments import common, moeva, pgd

    alone = copy.deepcopy(cfg)
    alone["dirs"]["results"] = f"{tmp}/alone/{len(os.listdir(tmp))}"
    common.ENGINES.clear()
    quiet((moeva if runner == "moeva" else pgd).run, alone)
    got, want = point_outputs(runner, cfg), point_outputs(runner, alone)
    if common.ENGINES.stats()["engines"] != 1 or want is None or not same_outputs(got, want):
        raise AssertionError(f"[grid] {tag}: the grid point differs from the standalone runner on a fresh engine")
    log(f"[grid] {tag}: x_attacks and rates equal the standalone runner's on a fresh engine, bit for bit")


def point_state(d: str) -> dict:
    """``dir_state`` of a results directory without its grid reports."""
    return {k: v for k, v in dir_state(d).items() if not k.startswith("grid_report_")}


def move_aside(d: str, suffix: str) -> str:
    moved = d.rstrip("/") + suffix
    os.rename(d, moved)
    return moved


def run_grids(smi: str) -> dict:
    """Phase 13: the ten grid files of ``config/`` through
    ``experiments.rq.run`` on the card, over phases 10-12's synthetic
    artifacts (``write_grid_config_dir``, ``GRID_CUTS``), with ``run_grid``'s
    checks; then rq2.lcld again, which skips every point; two points against
    the standalone runner on a fresh engine (a MoEvA point served by a
    cached engine, a PGD point at a grid's second ε on a cached engine);
    rq2.botnet in subprocesses and rq2.lcld with ``pipeline: false``, each
    against the pipelined run (a second pipelined rq2.lcld, a wall figure
    only, is **cut**). Returns the launches summed over the ten grids."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.experiments import rq
    from moeva2_ijcai22_replication_tpu_torch.utils.config import load_config_file

    t0 = time.perf_counter()
    total = {k: 0 for k in kernels.launch_counts()}
    with tempfile.TemporaryDirectory() as tmp:
        art = f"{tmp}/artifacts"
        write_grid_artifacts(art)
        config_dir = write_grid_config_dir(tmp, art)
        reports = {}
        for name in GRID_FILES:
            rep = reports[name] = run_grid(name, config_dir)
            for k, v in rep["launches"].items():
                total[k] += v
            for line in rep["lines"]:
                log(line)
            log(f"[grid] {name}: {len(rep['points'])} points ({rep['refused']} refused), grid_wallclock_s "
                f"{rep['grid_wallclock_s']}, attack_run_s {rep['attack_run_s']}, evaluate_s {rep['evaluate_s']}, "
                f"setup_s {rep['setup_s']}, write_s {rep['write_s']}, engine cache {rep['engine_cache']}, "
                f"artifact cache {rep['artifact_cache']}, cold {rep['cold']}; checks {rep['checks_s']:.1f} s; "
                f"launches "
                f"{({k: v for k, v in rep['launches'].items() if v})} as its points imply; every point's files "
                f"written, its metrics equal to their recomputation; on {smi}")

        rq2 = load_config_file(f"{config_dir}/rq2.lcld.yaml")
        points = grid_points(rq2)
        out = points[0][1]["dirs"]["results"]
        state = point_state(out)
        kernels.reset_launch_counts()
        runner = rq.GridRunner(rq2)
        quiet(runner.run)
        rep = runner.report
        if (rep["points_skipped"], rep["points_launched"], rep["writer"]["submitted"]) != (len(points), 0, 0) or \
                any(kernels.launch_counts().values()) or point_state(out) != state:
            raise AssertionError(f"[grid] rq2.lcld again: {rep['points_skipped']} of {len(points)} points skipped, "
                                 f"{rep['writer']['submitted']} submitted, launches {kernels.launch_counts()}")
        log(f"[grid] rq2.lcld.yaml again: all {len(points)} points skipped; nothing launched, no point written")

        if reports["sm1.1.lcld.yaml"]["engine_cache"]["misses"] != 0:
            raise AssertionError("[grid] sm1.1.lcld's MoEvA points were not all served by a cached engine")
        sm11 = grid_points(load_config_file(f"{config_dir}/sm1.1.lcld.yaml"))
        check_standalone(f"sm1.1.lcld MoEvA budget {sm11[0][1]['budget']}, served by a cached engine", *sm11[0], tmp)
        sm12 = grid_points(load_config_file(f"{config_dir}/sm1.2.lcld.yaml"))
        eps2 = sorted({cfg["eps"] for _, cfg in sm12}, key=[cfg["eps"] for _, cfg in sm12].index)[1]
        point = next(p for p in sm12 if p[1]["eps"] == eps2 and p[1]["loss_evaluation"] == "flip")
        check_standalone(f"sm1.2.lcld PGD flip budget {point[1]['budget']} at the grid's second eps {eps2}, on a "
                         "cached engine", *point, tmp)

        bot = grid_points(load_config_file(f"{config_dir}/rq2.botnet.yaml"))
        bot_out = bot[0][1]["dirs"]["results"]
        inproc = move_aside(bot_out, "_inprocess")
        sub = run_grid("rq2.botnet.yaml", config_dir, use_subprocess=True)
        names = sorted(os.listdir(bot_out))
        want = sorted(f for f in os.listdir(inproc) if not f.startswith("grid_report_"))
        if names != want or not all(same_outputs(point_outputs(r, c), point_outputs(r, c, inproc)) for r, c in bot):
            raise AssertionError(f"[grid] rq2.botnet with use_subprocess=True wrote {names} (in process: {want}) or "
                                 "other x_attacks or rates")
        log(f"[grid] rq2.botnet.yaml with use_subprocess=True: {len(bot)} point(s) in {sub['wall_s']:.3f} s wall; "
            "the same file names, x_attacks and rates as in process, bit for bit")

        piped = move_aside(out, "_pipelined")
        serial = run_grid("rq2.lcld.yaml", config_dir, {"pipeline": False})
        names = sorted(os.listdir(out))
        if names != sorted(f for f in os.listdir(piped) if not f.startswith("grid_report_")) or \
                not all(same_outputs(point_outputs(r, c), point_outputs(r, c, piped)) for r, c in points):
            raise AssertionError("[grid] rq2.lcld with pipeline: false differs from the pipelined run")
        first = reports["rq2.lcld.yaml"]
        log(f"[grid] rq2.lcld.yaml with pipeline: false gives the pipelined run's files, x_attacks and rates, bit for "
            f"bit; wall s (evaluate spans summed): pipelined {first['wall_s']:.3f} ({first['evaluate_sum_s']:.3f}), "
            f"serial {serial['wall_s']:.3f} ({serial['evaluate_sum_s']:.3f}) on {smi}")
    log(f"[grid] launches over the ten grids: {({k: v for k, v in total.items() if v})}; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")
    return total


# -- phase 14: AutoPGD on LCLD, augmented LCLD and botnet -----------------------------

#: phase 7's configurations under AutoPGD's loss prefix: every loss strategy,
#: the three constraints_optim, targeted, both norms, every history layout
AUTOPGD_CONFIGS = tuple({**c, "loss_evaluation": "autopgd+" + c["loss_evaluation"]} for c in PGD_CONFIGS)
#: the sweep's budgets: 1, 12 (seven checkpoints, where halving fires) and
#: 20 (eight, at one row count per configuration, as K7b's sweep), **cut**
#: from 40 (nine) to keep the smoke within its time limit as phase 21 holds
#: K14 at every population size: the plain version takes about 0.03 s an
#: iteration at 4000 rows
AUTOPGD_ITERS = (1, 12, 20)
#: the AutoPGD sweeps' row counts at D = 47 and 57: ``PGD_ROWS`` **cut** of
#: 4223 and 4225 (132 full blocks of 32 rows and one row past them), to keep
#: the smoke within its time limit as phase 21 joins it; K7's base and
#: kPairs instantiations, whose launch layout the kAuto ones share, keep
#: them in phases 7 and 11, and 4000 still spans every SM
AUTOPGD_ROWS = tuple(n for n in PGD_ROWS if n <= 4000)
#: the timed loss: rq1.lcld's ``constraints+flip`` under the prefix
AUTOPGD_LOSS = "autopgd+constraints+flip"
#: rq1.lcld's PGD points under AutoPGD, through the runner at rq1's shape
#: (``autopgd+flip+sat`` on 256 states: ``RUNNER_CUTS``' cut of ``flip+sat``)
AUTOPGD_RUNNER_LOSSES = ("autopgd+flip", "autopgd+constraints+flip",
                         "autopgd+constraints+flip+adaptive_eps_step+repair", "autopgd+flip+sat")
#: the launch counts of K7's and K7b's AutoPGD instantiations: no grid file
#: of ``config/`` selects an ``autopgd`` loss, so phase 13 launches none and
#: phase 14 must launch each
AUTOPGD_COUNTERS = ("pgd_lcld_auto", "pgd_lcld_aug_auto", "pgd_botnet_auto", "pgd_botnet_aug_auto")
#: operations AutoPGD adds to K7's per row and iteration, counted from its
#: source, besides the tracking forward's 2 per weight of the stack: 18 per
#: feature (the momentum's six, its clip, the second projection's
#: perturbation, square, sum, scaling and two clips, x_prev's and the best
#: point's copies) and 90 per row (the terms' forward and the
#: cross-entropy's, the tracking loss, its comparisons and the checkpoint's,
#: the second projection factor); 6 float64 pow, log and exp (the terms'
#: two pows and log, the cross-entropy's two exps and log)
AUTOPGD_OPS_PER_FEATURE = 18
AUTOPGD_OPS_PER_ROW = 90
AUTOPGD_F64_PER_ROW = 6
#: K7b's AutoPGD sweep: phase 9's row counts that keep its layouts' edges (a
#: lone row; 67, two rows a cluster, one past the 66 resident clusters' one
#: row each; rq1.botnet's 387; 397, a 67th cluster of one row past 6 rows on
#: every resident one), at AUTOPGD_BOTNET_ITERS with phase 9's edge starts
AUTOPGD_BOTNET_ROWS = (1, 67, 387, 397)
#: the states of the botnet ``autopgd+flip+sat`` runner point, **cut** from
#: rq1.botnet's 387 (its MILP repair is host work, about 0.05 s a state):
#: phase 10 runs ``flip+sat`` and phase 13 rq1.botnet's grid through the
#: repair at 387
AUTOPGD_BOTNET_SAT_STATES = 128
#: K7b's AutoPGD sweep budgets: the deepest **cut** from 40 to 20 (eight
#: checkpoints, halving firing), its plain version taking 0.13 s an
#: iteration at 756 features, to keep the smoke within its time limit
AUTOPGD_BOTNET_ITERS = (1, 12, 20)
#: rq1.botnet's PGD points under AutoPGD, through the runner on all its 387
#: states (``autopgd+flip+sat`` too, as phase 10's botnet ``flip+sat``)
AUTOPGD_BOTNET_RUNNER_LOSSES = tuple("autopgd+" + loss for loss in RQ1_LOSSES)
#: operations AutoPGD adds to K7b's per row and iteration, counted from its
#: source, besides the tracking forward's 2 per weight of the stack, its
#: terms (the flow sums and PGD_BOTNET_OPS_PER_TERM a term) and cons' sum (1
#: a term), and AUTOPGD_OPS_PER_FEATURE per feature: 40 per row (the
#: cross-entropy's forward, the tracking loss, its comparisons, the rises
#: and the checkpoint's, the second projection factor's root, add, division
#: and min); the cross-entropy's 3 float64 exp and log once more
AUTOPGD_BOTNET_OPS_PER_ROW = 40
#: K7b's AutoPGD instantiation's dependent operations per iteration besides
#: PGD's (pgd_botnet_floor_ms), the tracking forward's sums and the second
#: projection factor's L2 sum over the features, counted from its source:
#: the cross-entropy (20), the tracking loss and its decision (8), z's
#: scaling, add and clip, the momentum and its clip, the perturbation and
#: its square (12), the second factor's root, add, division and min (4)
AUTOPGD_BOTNET_CHAIN_PER_ITER = 44


def autopgd_bound(tables, n: int, t: int):
    """K7's AutoPGD instantiation's least time for ``n`` rows and ``t``
    iterations: ``pgd_work`` (and on the augmented domain the pair stage,
    twice: the gradient's pass and the tracking forward) plus what AutoPGD
    adds; the bytes add each row's step and the two (T + 1) tables."""
    n_bytes, n_ops, n_f64 = pgd_work(tables, n, t)
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    pairs = 0 if tables.cons is None else tables.cons.idx.shape[0]
    n_ops += n * t * (2 * macs + AUTOPGD_OPS_PER_FEATURE * widths[0] + AUTOPGD_OPS_PER_ROW
                      + (PGD_OPS_PER_PAIR + OBJECTIVE_OPS_PER_PAIR) * pairs)
    return bound_ms(n_bytes + 16 * pairs + 4 * n + 5 * (t + 1), n_ops, n_f64 + n * t * AUTOPGD_F64_PER_ROW)


def autopgd_botnet_bound(tables, n: int, t: int):
    """K7b's AutoPGD instantiation's least time for ``n`` rows and ``t``
    iterations, counted from its source as ``pgd_botnet_bound`` is:
    ``pgd_botnet_work`` plus the tracking pass (2 operations per weight, the
    terms' forward and cons' sum, the cross-entropy's float64 exp and log),
    the momentum, the second projection and the copies
    (``AUTOPGD_OPS_PER_FEATURE`` a feature) and ``AUTOPGD_BOTNET_OPS_PER_ROW``;
    the bytes add each row's step and the two (T + 1) tables."""
    n_bytes, n_ops, n_f64 = pgd_botnet_work(tables, n, t)
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    c = tables.cons.counts
    n_terms = 2 + sum(c[4::2]) + botnet_pairs(tables)
    n_ops += n * t * (2 * macs + sum(c[:4]) + (PGD_BOTNET_OPS_PER_TERM + 1) * n_terms
                      + AUTOPGD_OPS_PER_FEATURE * widths[0] + AUTOPGD_BOTNET_OPS_PER_ROW)
    return bound_ms(n_bytes + 4 * n + 5 * (t + 1), n_ops, n_f64 + n * t * PGD_BOTNET_F64_PER_ROW)


def autopgd_botnet_floor_ms(tables, t: int, mhz: float) -> float:
    """K7b's AutoPGD instantiation's latency floor for ``t`` iterations (L2),
    counted from its source: ``pgd_botnet_floor_ms``'s chain and, per
    iteration, the tracking forward's (each first-layer unit's 756 adds, the
    deeper layers'), the second projection factor's L2 sum over the features
    and ``AUTOPGD_BOTNET_CHAIN_PER_ITER`` more, each at
    ``CYCLES_PER_DEPENDENT_OP`` cycles of the card's maximum SM clock."""
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    d = widths[0]
    chain = d + sum(widths[1:-1]) + d + AUTOPGD_BOTNET_CHAIN_PER_ITER
    return pgd_botnet_floor_ms(tables, t, mhz) + t * chain * CYCLES_PER_DEPENDENT_OP / (mhz * 1e6) * 1e3


def autopgd_sweep(device, kernel: str, cons, sur, scaler, xs: np.ndarray, starts: np.ndarray, rows: tuple,
                  iters: tuple = AUTOPGD_ITERS, configs: tuple = AUTOPGD_CONFIGS):
    """The AutoPGD instantiation of ``kernel`` (``pgd_lcld`` or
    ``pgd_botnet``) against ``autopgd_run_plain`` on the card, bit for bit
    (x_best, the class there, the history, each row's final step), over
    ``configs`` x ``rows`` x ``iters``, the last budget at one
    row count per configuration, first step ε / 3; labels alternate 0 and
    1. A row's run depends on no other row, so the plain version runs once
    per configuration and budget, on the most rows, and each launch is held
    against its first N. Returns (runs, rows halved and rows not halved at
    T >= 12, NaN rows of x_best)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.core.norms import is_inf

    launch = getattr(kernels, kernel)
    xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
    st = torch.as_tensor(starts, device=device)
    y = torch.as_tensor(np.arange(len(xs)) % 2, device=device)
    runs = halved = kept = nan_rows = 0
    for ci, knobs in enumerate(configs):
        eps = 0.2 if knobs["norm"] == 2 else 0.1
        atk = AutoPGD(sur, cons, scaler, eps=eps, eps_step=eps / 3, device=device, **knobs)
        repair, linf = "repair" in atk.loss_evaluation, is_inf(atk.norm)
        for t in iters:
            ns = [rows[ci % len(rows)]] if t == iters[-1] else list(rows)
            sched = atk.schedule(eps, eps / 3, t)
            m = max(ns)
            want = autopgd_run_plain(atk.tables, cons, sched, xi[:m], y[:m], st[:m], eps, atk.clip, atk.norm, repair,
                                     atk.targeted, atk.history_layout())
            for n in ns:
                got = launch(atk.tables, sched.pgd, xi[:n], y[:n], st[:n], eps, atk.clip, linf, repair, atk.targeted,
                             atk.history_layout(), auto=sched.auto)
                what = f"AutoPGD {kernel} {atk.loss_evaluation} {atk.constraints_optim} norm={atk.norm} N={n} T={t}"
                for name, g, w in zip(("x_best", "pred", "hist", "eta"), got, want):
                    if (g is None) != (w is None):
                        raise AssertionError(f"{what}: {name} is {g} on the card, {w} in the plain version")
                    if g is not None:
                        hold_equal(g, w[:, :n] if name == "hist" else w[:n], f"{what} {name}")
                runs += 1
                if t >= 12:
                    eta0 = torch.tensor(eps / 3, dtype=torch.float32, device=device)
                    halved += int((got[3] < eta0).sum())
                    kept += int((got[3] == eta0).sum())
                nan_rows += int(torch.isnan(got[0]).any(1).sum())
    if not halved or not kept:
        raise AssertionError(f"AutoPGD's sweep halved {halved} and kept {kept} rows' steps at T >= 12: the "
                             "checkpoints are not exercised both ways")
    return runs, halved, kept, nan_rows


def autopgd_kernel_record(device, tag: str, name: str, problem, loss: str, bound, kernel: str = "pgd_lcld",
                          eps_run: float = PGD_EPS, plain_iters: int = PGD_TIMED_ITERS):
    """The AutoPGD instantiation of ``kernel``'s record at ``problem``'s
    states x ``PGD_BUDGET`` iterations (``loss``, L2, ε ``eps_run`` - 1e-6,
    first step ``eps_run`` / 3, from x_init), as ``pgd_kernel_record`` takes
    the PGD kernels': device ms (CUDA graph of 2 launches), wrapper ms, the
    plain version at ``plain_iters`` iterations, the bound, device ms at 100
    iterations; beside it the base kernel at the loss without the prefix, in
    the same process. Returns it and the attack."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain

    cons, sur, scaler, x, xs, y = problem
    launch = getattr(kernels, kernel)
    label = {"pgd_lcld": "K7", "pgd_botnet": "K7b"}[kernel]
    eps, eta0 = eps_run - 1e-6, eps_run / 3
    xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, device=device)
    atk = AutoPGD(sur, cons, scaler, eps=eps, eps_step=eta0, max_iter=PGD_BUDGET, norm=2, loss_evaluation=loss,
                  device=device)
    repair = "repair" in loss

    def auto_fn(t):
        sched = atk.schedule(eps, eta0, t)
        return lambda: launch(atk.tables, sched.pgd, xi, yt, xi, eps, atk.clip, False, repair, False,
                              auto=sched.auto)

    base = ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, norm=2,
                          loss_evaluation=loss.removeprefix("autopgd+"), device=device)
    base_sched = base.schedule(eps, 0.1, PGD_BUDGET)
    main = auto_fn(PGD_BUDGET)
    sched_plain = atk.schedule(eps, eta0, plain_iters)
    b_ms, b_by = bound(atk.tables)
    rec = {
        "name": name,
        "route": "cuda",
        "source": f"moeva2_ijcai22_replication_tpu_torch/kernels/csrc/{kernel}.cu",
        "replaces": "moeva2_ijcai22_replication_tpu/attacks/pgd/autopgd.py:45",
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": graph_ms(main, launches=2, repeats=3),
        "wrapper_ms": cuda_ms(main, launches=2, repeats=3),
        "plain_ms": cuda_ms(lambda: autopgd_run_plain(atk.tables, cons, sched_plain, xi, yt, xi, eps, atk.clip, 2,
                                                      repair, False), launches=1, repeats=2),
        "plain_iters": plain_iters,
        "ms_100_iters": graph_ms(auto_fn(PGD_TIMED_ITERS), launches=5, repeats=3),
        "base_ms": graph_ms(lambda: launch(base.tables, base_sched, xi, yt, xi, eps, base.clip, False, repair, False),
                            launches=2, repeats=3),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    log(f"{tag} {label}'s AutoPGD instantiation at D = {xs.shape[1]}, {len(xs)} states x {PGD_BUDGET} iterations "
        f"({loss}, L2, ε {eps_run}): device {rec['ms']:.3f} ms ({PGD_TIMED_ITERS} iterations "
        f"{rec['ms_100_iters']:.3f}), through the wrapper {rec['wrapper_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{rec['ms'] / b_ms:.2f}x the bound; base {label} at {base.loss_evaluation} {rec['base_ms']:.3f} ms "
        f"({rec['ms'] / rec['base_ms']:.2f}x); plain version at {plain_iters} iterations {rec['plain_ms']:.1f} ms")
    return rec, atk


def drive_autopgd(device, smi: str, tag: str, counter: str, problem, loss: str, eps_run: float, rewritten,
                  f1: float) -> dict:
    """``AutoPGD.generate`` as ``experiments/pgd.py`` drives it (one random
    start, ε ``eps_run`` - 1e-6, first step ``eps_run`` / 3, L2,
    ``PGD_BUDGET``) cold and steady, with the launch counts set to 0 just
    before and read just after (one launch of ``counter``); x_adv finite,
    immutables unchanged, within the ball on the features repair leaves
    alone (those not in the mask ``rewritten``), two runs equal; o1..o7 at
    ``f1`` and f2 ε. Returns the launches."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, round_ints_toward_initial

    cons, sur, scaler, x, xs, y = problem
    eps = eps_run - 1e-6
    atk = AutoPGD(sur, cons, scaler, max_iter=PGD_BUDGET, norm=2, loss_evaluation=loss, num_random_init=1,
                  seed=42, device=device)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_adv = atk.generate(xs, y, eps=eps, eps_step=eps_run / 3, max_iter=PGD_BUDGET)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    again = atk.generate(xs, y, eps=eps, eps_step=eps_run / 3, max_iter=PGD_BUDGET)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    if launches != {**{k: 0 for k in launches}, counter: 1, "pgd_start": 1, "restart": 1}:
        raise AssertionError(f"launches {launches}: one generate with one random start is one launch of {counter} "
                             "and one of K0's pgd_start")
    if not same_entries_np(x_adv, again).all():
        raise AssertionError("two runs of AutoPGD's generate differ")
    x0 = xs.astype(np.float32)
    if x_adv.shape != xs.shape or not np.isfinite(x_adv).all():
        raise AssertionError(f"x_adv {x_adv.shape}, {int((~np.isfinite(x_adv)).sum())} non-finite")
    mutable = np.asarray(cons.get_mutable_mask(), bool)
    if not np.array_equal(x_adv[:, ~mutable], x0[:, ~mutable]):
        raise AssertionError("AutoPGD moved immutable features")
    kept = ~rewritten
    dist = np.sqrt(((x_adv.astype(np.float64) - x0)[:, kept] ** 2).sum(1))
    if dist.max() > eps_run + 1e-5:
        raise AssertionError(f"AutoPGD's L2 distance {dist.max()} > ε on the features repair leaves alone")
    x_attacks = round_ints_toward_initial(scaler.inverse(x_adv.astype(np.float64)), x, cons.get_feature_type())
    calc = ObjectiveCalculator(classifier=sur, constraints=cons, thresholds={"f1": f1, "f2": eps_run},
                               min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=2)
    rates = calc.success_rate_3d(x, x_attacks[:, None, :])
    eta = atk.last_eta.cpu().numpy()
    moved = int((~same_entries_np(x_adv, x0)).any(1).sum())
    log(f"{tag} AutoPGD generate ({loss}, one random start): launches {({k: v for k, v in launches.items() if v})}; "
        f"cold {cold_s:.3f} s, steady {steady_s:.3f} s for {len(xs)} states x {PGD_BUDGET} iterations on {smi}; "
        f"x_adv finite, immutables unchanged, two runs equal, L2 distance at most {dist.max():.6f} on the "
        f"{int(kept.sum())} features repair leaves alone; {moved} of {len(xs)} rows moved (a row that the start "
        "does not flip returns x_init); "
        f"{int((eta < np.float32(eps_run / 3)).sum())} of {len(eta)} rows halved their step; o1..o7 "
        + " ".join(f"{v:.4f}" for v in rates))
    return launches


def check_autopgd_card_vs_cpu(device, tag: str, counter: str, problem, n: int, t: int, eps_run: float,
                              loss: str = AUTOPGD_LOSS) -> None:
    """AutoPGD's ``generate`` at ``loss`` on the card against the CPU from
    x_init on ``n`` states x ``t`` iterations (every x_adv entry equal), and
    2 random restarts on the card: 2 launches of ``counter``."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD

    cons, sur, scaler, _, xs, y = problem
    small = dict(eps=eps_run, eps_step=eps_run / 3, max_iter=t, norm=2, loss_evaluation=loss)
    on_cpu = AutoPGD(sur, cons, scaler, device="cpu", **small).generate(xs[:n], y[:n], eps=eps_run - 1e-6)
    on_card = AutoPGD(sur, cons, scaler, device=device, **small).generate(xs[:n], y[:n], eps=eps_run - 1e-6)
    differ = int((~same_entries_np(on_card, on_cpu)).sum())
    log(f"{tag} AutoPGD card vs CPU at {n} states x {t} iterations: {differ} of {on_cpu.size} x_adv entries differ")
    if differ:
        raise AssertionError(f"{differ} AutoPGD x_adv entries differ between the card and the CPU")
    kernels.reset_launch_counts()
    restarts = AutoPGD(sur, cons, scaler, device=device, num_random_init=2, **small)
    restarts.generate(xs[:n], y[:n], eps=eps_run - 1e-6)
    got = kernels.launch_counts()[counter]
    log(f"{tag} AutoPGD, 2 random restarts at {n} states: {got} launches of {counter}, success after each restart "
        f"{restarts.quality_history['restart_flip_frac']}")
    if got != 2:
        raise AssertionError(f"{got} launches of {counter} for 2 restarts")


def check_autopgd_c5(device, problem) -> None:
    """ROADMAP C5 under best-point tracking: AutoPGD (``AUTOPGD_LOSS``, L2,
    ε 0.2 - 1e-6, first step 0.2 / 3, 1000 iterations) from x_init, as PGD
    ran when its judgement refused rq1.lcld's ``constraints+flip`` point,
    with the violations recorded: the NaN rows of x_best, and for
    ``NAN_REFUSALS``' rows (PGD's NaN rows) the first iteration whose g8 or
    g9 was not finite (the iterate at x22's pole, or None), whether their
    x_best is finite, and their final steps."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD

    cons, sur, scaler, _, xs, y = problem
    atk = AutoPGD(sur, cons, scaler, max_iter=PGD_BUDGET, norm=2, loss_evaluation=AUTOPGD_LOSS, record_loss="full",
                  device=device)
    x_best = atk.generate(xs, y, eps=PGD_EPS - 1e-6, eps_step=PGD_EPS / 3)
    nan_rows = np.flatnonzero(~np.isfinite(x_best).all(-1)).tolist()
    rows = list(NAN_REFUSALS[("lcld", "constraints+flip")])
    g = atk.loss_history[rows][:, :, [3 + k for k in MONTH_POLE_TERMS]]  # (rows, T, 2)
    bad = ~np.isfinite(g).all(-1)
    first = [int(np.argmax(b)) if b.any() else None for b in bad]
    log(f"[autopgd] C5: AutoPGD {AUTOPGD_LOSS} from x_init at {len(xs)} states x {PGD_BUDGET}: NaN rows of x_best "
        f"{nan_rows}; PGD's C5 rows {rows}: g8 or g9 not finite first at iterations {first} (None: never), x_best "
        f"finite {np.isfinite(x_best[rows]).all(-1).tolist()}, final steps {atk.last_eta.cpu().numpy()[rows].tolist()}")


def run_autopgd_botnet(device, smi: str, resources: list):
    """Phase 14's botnet part: K7b's AutoPGD instantiation. Its ptxas line
    beside the base's, the sweep against
    ``autopgd_run_plain``, its record at rq1.botnet's 387 x 1000 with the
    latency floor and the launch's shape, ``generate``, the card against the
    CPU, rq1.botnet's PGD points under the prefix through the runner.
    Returns the record and the launches of ``generate``."""
    from moeva2_ijcai22_replication_tpu_torch.problems import botnet_edge_starts

    ptxas = {k["kernel"]: k for k in resources if k["kernel"].startswith("pgd_botnet_kernel")}
    names = ("pgd_botnet_kernel<0>", "pgd_botnet_kernel<1>")
    if sorted(ptxas) != sorted(names):
        raise AssertionError(f"the build's ptxas report has K7b's instantiations {sorted(ptxas)}, not {names}")
    for name in names:
        k = ptxas[name]
        log(f"[autopgd-botnet] {name} (kAuto): {k['registers']} registers, {k['stack']} bytes stack frame, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    problem = pgd_botnet_problem()
    cons, sur, scaler, x, xs, y = problem
    starts = botnet_edge_starts(cons.schema.names, scaler, xs)
    n = max(AUTOPGD_BOTNET_ROWS)
    runs, halved, kept, nan_rows = autopgd_sweep(device, "pgd_botnet", cons, sur, scaler,
                                                 np.resize(xs, (n, xs.shape[1])), np.resize(starts, (n, xs.shape[1])),
                                                 AUTOPGD_BOTNET_ROWS, AUTOPGD_BOTNET_ITERS)
    log(f"[autopgd-botnet] K7b's AutoPGD instantiation equals autopgd_run_plain (x_best, class, history, eta) on "
        f"all {runs} runs: {len(AUTOPGD_CONFIGS)} configurations x N in {AUTOPGD_BOTNET_ROWS} x T in "
        f"{AUTOPGD_BOTNET_ITERS[:-1]}, and T = {AUTOPGD_BOTNET_ITERS[-1]} at one N each, with phase 9's edge starts; "
        f"at T >= 12 "
        f"{halved} rows halved their step and {kept} kept it; {nan_rows} NaN rows of x_best")
    rec, atk = autopgd_kernel_record(device, "[autopgd-botnet]", "pgd_botnet_auto", problem, AUTOPGD_LOSS,
                                     lambda tables: autopgd_botnet_bound(tables, len(xs), PGD_BUDGET),
                                     kernel="pgd_botnet", eps_run=PGD_BOTNET_EPS, plain_iters=PGD_BOTNET_PLAIN_ITERS)
    mhz = max_sm_clock_mhz()
    rec["ceiling_ms"] = autopgd_botnet_floor_ms(atk.tables, PGD_BUDGET, mhz)
    rec["base_ceiling_ms"] = pgd_botnet_floor_ms(atk.tables, PGD_BUDGET, mhz)
    rec["launch"] = pgd_botnet_shape(atk.tables, len(xs), autopgd=True)
    sh = rec["launch"]
    log(f"[autopgd-botnet] K7b's AutoPGD launch at {len(xs)} rows: clusters of {sh['ctas_per_cluster']} CTAs of "
        f"{sh['threads']} threads, {sh['rows_per_cluster']} rows per cluster, "
        f"{sh['ctas'] // sh['ctas_per_cluster']} clusters ({sh['resident_clusters']} resident at once), "
        f"{sh['smem_bytes']} bytes of shared memory per CTA; latency floor {rec['ceiling_ms']:.3f} ms (base K7b's "
        f"{rec['base_ceiling_ms']:.3f}, at {mhz:.0f} MHz); device time {rec['ms'] / rec['ceiling_ms']:.2f}x the floor")
    if sh["rows_per_cluster"] * sh["resident_clusters"] < len(xs):
        raise AssertionError(f"K7b's AutoPGD launch runs {len(xs)} rows in more than one wave: {sh}")
    launches = drive_autopgd(device, smi, "[autopgd-botnet]", "pgd_botnet_auto", problem, AUTOPGD_LOSS,
                             PGD_BOTNET_EPS, np.zeros(x.shape[1], bool), 0.5)
    check_autopgd_card_vs_cpu(device, "[autopgd-botnet]", "pgd_botnet_auto", problem, PGD_BOTNET_CPU_ROWS,
                              PGD_BOTNET_CPU_ITERS, PGD_BOTNET_EPS)
    from moeva2_ijcai22_replication_tpu_torch.experiments import common

    with tempfile.TemporaryDirectory() as tmp:
        art = f"{tmp}/botnet"
        cons = write_runner_artifacts("botnet", art)
        pgd_s = None
        for loss in AUTOPGD_BOTNET_RUNNER_LOSSES:
            cfg = runner_config("botnet", "pgd", art, loss)
            if "sat" in loss:
                cfg["n_initial_state"] = AUTOPGD_BOTNET_SAT_STATES
            metrics = drive_runner(cfg, smi, point_expected_launches("pgd", cfg), f"pgd botnet {loss}")
            if loss == "autopgd+flip":
                pgd_s = metrics["timings"]["attack"]
            if "sat" in loss:
                h = metrics["config_hash"]
                x_rep = np.load(f"{cfg['dirs']['results']}/x_attacks_pgd_{loss}_{h}.npy")[:, 0]
                log(f"[runner] pgd botnet {loss}: MILP repair {check_repairs(cons, common.load_candidates(cfg), x_rep)}; "
                    f"attack span {metrics['timings']['attack']:.3f} s (autopgd+flip's {pgd_s:.3f} s)")
    return rec, launches["pgd_botnet_auto"]


def run_autopgd(device, smi: str, resources: list, problem):
    """Phase 14: AutoPGD on LCLD (``problem``, phase 7's) and augmented LCLD
    through K7's AutoPGD instantiations, and on botnet and augmented botnet
    through K7b's. Returns their records and the launches of the
    ``generate`` drives."""
    import os

    from moeva2_ijcai22_replication_tpu_torch.problems import LCLD_AUGMENTED_EDGE_ROWS, lcld_augmented_edge_rows

    t0 = time.perf_counter()
    ptxas = {k["kernel"]: k for k in resources if k["kernel"].startswith("pgd_lcld_kernel<")}
    names = ("pgd_lcld_kernel<0,0>", "pgd_lcld_kernel<1,0>", "pgd_lcld_kernel<0,1>", "pgd_lcld_kernel<1,1>")
    if sorted(ptxas) != sorted(names):
        raise AssertionError(f"the build's ptxas report has K7's instantiations {sorted(ptxas)}, not {names}")
    for name in names:
        k = ptxas[name]
        log(f"[autopgd] {name} (kPairs, kAuto): {k['registers']} registers, {k['stack']} bytes stack frame, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    records, launches = [], {}
    cons, sur, scaler, x = problem
    rng = np.random.default_rng(5)
    xs = scaler.transform(x).astype(np.float32)
    starts = pgd_edge_starts(rng, xs, scaler)
    n = max(AUTOPGD_ROWS)
    runs, halved, kept, nan_rows = autopgd_sweep(device, "pgd_lcld", cons, sur, scaler,
                                                 np.resize(xs, (n, xs.shape[1])), np.resize(starts, (n, xs.shape[1])),
                                                 AUTOPGD_ROWS)
    log(f"[autopgd] K7's AutoPGD instantiation at D = 47 equals autopgd_run_plain (x_best, class, history, eta) on "
        f"all {runs} runs: {len(AUTOPGD_CONFIGS)} configurations x N in {AUTOPGD_ROWS} x T in {AUTOPGD_ITERS[:-1]}, and "
        f"T = {AUTOPGD_ITERS[-1]} at one N each, with phase 7's 14 edge starts; at T >= 12 {halved} rows halved "
        f"their step and {kept} kept it; {nan_rows} NaN rows of x_best")
    xs = scaler.transform(x)
    lcld = (cons, sur, scaler, x, xs, surrogate_labels(sur, xs))
    records.append(autopgd_kernel_record(device, "[autopgd]", "pgd_lcld_auto", lcld, AUTOPGD_LOSS,
                                         lambda tables: autopgd_bound(tables, len(xs), PGD_BUDGET))[0])
    launches["pgd_lcld_auto"] = drive_autopgd(device, smi, "[autopgd]", "pgd_lcld_auto", lcld, AUTOPGD_LOSS, PGD_EPS,
                                              lcld_repair_rewrites(cons, AUTOPGD_LOSS, x.shape[1]),
                                              0.25)["pgd_lcld_auto"]
    check_autopgd_c5(device, lcld)
    check_autopgd_card_vs_cpu(device, "[autopgd]", "pgd_lcld_auto", lcld, PGD_CPU_ROWS, PGD_CPU_ITERS, PGD_EPS)
    with tempfile.TemporaryDirectory() as tmp:
        art = f"{tmp}/lcld"
        lcld_cons = write_runner_artifacts("lcld", art)
        pgd_s = None
        for loss in AUTOPGD_RUNNER_LOSSES:
            cfg = runner_config("lcld", "pgd", art, loss)
            cfg.update(RUNNER_CUTS.get(("lcld", loss.removeprefix("autopgd+")), {}))
            metrics = drive_runner(cfg, smi, point_expected_launches("pgd", cfg), f"pgd lcld {loss}")
            if loss == "autopgd+flip":
                pgd_s = metrics["timings"]["attack"]
            if "sat" in loss:
                h = metrics["config_hash"]
                x_rep = np.load(f"{cfg['dirs']['results']}/x_attacks_pgd_{loss}_{h}.npy")[:, 0]
                from moeva2_ijcai22_replication_tpu_torch.experiments import common

                x_init = common.load_candidates(cfg)
                log(f"[runner] pgd lcld {loss}: MILP repair {check_repairs(lcld_cons, x_init, x_rep)}; attack span "
                    f"{metrics['timings']['attack']:.3f} s (autopgd+flip's on 4000 states {pgd_s:.3f} s)")
        aug = f"{tmp}/aug"
        os.makedirs(aug)
        cons, sur, scaler, x = write_aug_artifacts(aug)
        xs = scaler.transform(x).astype(np.float32)
        starts = pgd_edge_starts(np.random.default_rng(5), xs, scaler)
        starts[14:14 + LCLD_AUGMENTED_EDGE_ROWS] = lcld_augmented_edge_rows(
            x[14:14 + LCLD_AUGMENTED_EDGE_ROWS], cons.important_features, scaler)
        runs, halved, kept, nan_rows = autopgd_sweep(device, "pgd_lcld", cons, sur, scaler,
                                                     np.resize(xs, (n, xs.shape[1])),
                                                     np.resize(starts, (n, xs.shape[1])), AUTOPGD_ROWS)
        log(f"[autopgd] K7's AutoPGD instantiation at D = {xs.shape[1]} ({cons.n_constraints} terms) equals "
            f"autopgd_run_plain on all {runs} runs: the same sweep, with phase 7's 14 edge starts and the pair terms' "
            f"{LCLD_AUGMENTED_EDGE_ROWS}; at T >= 12 {halved} rows halved their step and {kept} kept it; {nan_rows} "
            "NaN rows of x_best")
        xs = scaler.transform(x)
        rq2_loss = "autopgd+" + RQ2_GRID["loss"]
        problem_aug = (cons, sur, scaler, x, xs, surrogate_labels(sur, xs))
        records.append(autopgd_kernel_record(device, "[autopgd]", "pgd_lcld_aug_auto", problem_aug, rq2_loss,
                                             lambda tables: autopgd_bound(tables, len(xs), PGD_BUDGET))[0])
        launches["pgd_lcld_aug_auto"] = drive_autopgd(device, smi, "[autopgd]", "pgd_lcld_aug_auto", problem_aug,
                                                      rq2_loss, PGD_EPS, lcld_repair_rewrites(cons, rq2_loss, x.shape[1]),
                                                      0.25)["pgd_lcld_aug_auto"]
        cfg = rq2_config("pgd", RQ2_GRID["budgets"][-1], aug)
        cfg["loss_evaluation"] = rq2_loss
        drive_runner(cfg, smi, point_expected_launches("pgd", cfg), f"pgd lcld_augmented budget {cfg['budget']} "
                     f"{rq2_loss}")
    log(f"[autopgd] phase 14's LCLD part took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    rec, launches["pgd_botnet_auto"] = run_autopgd_botnet(device, smi, resources)
    records.append(rec)
    log(f"[autopgd-botnet] phase 14's botnet part took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    rec, launches["pgd_botnet_aug_auto"] = run_autopgd_botnet_aug(device, smi, resources)
    records.append(rec)
    log(f"[autopgd-botnet-augmented] phase 14's augmented botnet part took {time.perf_counter() - t1:.1f} s")
    log(f"[autopgd] phase 14 took {time.perf_counter() - t0:.1f} s")
    return records, {name: launches[name] for name in AUTOPGD_COUNTERS}


# -- phase 15: the early exit ----------------------------------------------------------

#: K6a's sweep: state counts x (population, archive) columns, P + A in
#: {103, 113, 203, 303} (the main path's, with archive 10, and
#: config/moeva.yaml's P = 203 and M = 303)
GATE_STATES = (1, 7, 8, 33, 131, 256, 1000)
GATE_COLUMNS = ((103, 0), (103, 10), (203, 0), (279, 24))
#: K6b's sweep: the genes of LCLD, augmented LCLD, botnet and augmented
#: botnet rows, with archives of 0 and 10 columns, over 131 source states
TAKE_GENES = (47, 57, 756, 927)
TAKE_ARCHIVES = (0, 10)
TAKE_STATES = 131
#: the shape K6 is timed at: 1000 states x (103 + 10) columns, L = 47
K6_TIMED = (1000, 103, 10, 47)
#: float32 operations of K6a per candidate: three compares, four flag
#: conjunctions and ORs, two minima
GATE_OPS_PER_CANDIDATE = 12
#: the main path's early exit: a gate every 10 generations, judged at f1 <
#: 0.53 (the seeded, untrained surrogate leaves the states' best feasible
#: f1 in about [0.40, 0.54] after 10 generations), repacking down
#: config's menu extended by 1, 2 and 4
EE_KNOBS = dict(early_stop_check_every=10, early_stop_threshold=0.53,
                compaction_buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256), record_quality=True)
#: the card-vs-CPU run: states x generations, a gate every 5 at f1 < 0.5
EE_CPU_RUN = (64, 31)
EE_CPU_KNOBS = dict(EE_KNOBS, early_stop_check_every=5, early_stop_threshold=0.5)
#: botnet's early exit: rq1.botnet's engine (chunks of 256 of 387 states) at
#: a budget cut from 1000 to 200, judged at rq1.botnet's f1 0.5
EE_BOTNET_KNOBS = dict(BOTNET_KNOBS, n_gen=200, early_stop_check_every=10, early_stop_threshold=0.5,
                       record_quality=True)
#: the counters that only an early exit or quality gates launch: no grid
#: file of config/ sets either
EARLY_EXIT_COUNTERS = ("gate_stats", "take_carry")


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def gate_sweep_objectives(rng, s: int, m: int, thr: float, eps: float) -> np.ndarray:
    """float32 objectives with the gate's edges: NaN, +inf and -inf entries
    in every column, an all-NaN first state, f1 exactly at ``thr``, f2
    exactly at ``eps``, violations exactly 0 and -0."""
    f = rng.uniform(-0.1, 1.0, size=(s, m, 3)).astype(np.float32)
    f[..., 2] = np.where(rng.random((s, m)) < 0.3, 0.0, np.abs(f[..., 2]))
    f[rng.random((s, m)) < 0.05, 2] = -0.0
    f[rng.random((s, m)) < 0.05, 0] = thr
    f[rng.random((s, m)) < 0.05, 1] = eps
    for col in range(3):
        f[rng.random((s, m)) < 0.03, col] = np.nan
        f[rng.random((s, m)) < 0.02, col] = np.inf
        f[rng.random((s, m)) < 0.01, col] = -np.inf
    f[0] = np.nan
    return f


def take_leaves(rng, device, s: int, p: int, a: int, l: int) -> list:
    """A carry's leaves (pop_x, pop_f, arch_x, arch_f, ideal, worst,
    extreme) of ``s`` states, random, with a NaN and a -0 among them."""
    import torch

    shapes = ((s, p, l), (s, p, 3), (s, a, l), (s, a, 3), (s, 3), (s, 3), (s, 3, 3))
    leaves = [torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=device) for sh in shapes]
    leaves[1][0, 0, 0] = float("nan")
    leaves[0][-1, -1, -1] = -0.0
    return leaves


def check_gate_repack(device) -> None:
    """K6a against ``engine_quality_stats`` and K6b against
    ``index_select`` on the card, bit for bit."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import final_columns_plain, take_carry_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import engine_quality_stats

    rng = np.random.default_rng(15)
    thr, eps = float(np.float32(0.5)), float(np.float32(0.25 / math.sqrt(47)))
    cases = 0
    for s in GATE_STATES:
        for p, a in GATE_COLUMNS:
            f = torch.as_tensor(gate_sweep_objectives(rng, s, p + a, thr, eps), device=device)
            for e in (eps, float("inf")):
                got = kernels.gate_stats(f[:, :p].contiguous(), f[:, p:].contiguous(), thr, e)
                hold_equal(got, engine_quality_stats(f, thr, e), f"gate_stats at S={s} P={p} A={a} eps={e}")
                cases += 1
    torch.cuda.synchronize()
    log(f"[early-exit] gate_stats equals engine_quality_stats (its plain version) bit for bit on {cases} cases: S in "
        f"{GATE_STATES} x (P, A) in {GATE_COLUMNS} x eps in ({eps:.6g}, inf), with NaN, +inf and -inf objectives, an "
        "all-NaN state, f1 at the threshold, f2 at eps, violations 0 and -0")
    cases = 0
    for l in TAKE_GENES:
        for a in TAKE_ARCHIVES:
            leaves = take_leaves(rng, device, TAKE_STATES, 103, a, l)
            s = TAKE_STATES
            for sel in (np.array([s - 1, 4, 4, 4, 0]), np.arange(s), np.arange(s)[::-1].copy(), np.full(256, 7)):
                idx = torch.as_tensor(sel, device=device)
                for g, w in zip(kernels.take_carry(sel, leaves), take_carry_plain(idx, leaves)):
                    if not same_bits(g, w):
                        raise AssertionError(f"take_carry at L={l} A={a} differs from index_select")
                for g, w in zip(kernels.final_columns(sel, *leaves[:4]), final_columns_plain(idx, *leaves[:4])):
                    if not same_bits(g, w):
                        raise AssertionError(f"final_columns at L={l} A={a} differs from its plain version")
                cases += 2
    torch.cuda.synchronize()
    log(f"[early-exit] take_carry and final_columns equal index_select (and its concatenation) bit for bit on {cases} "
        f"launches: L in {TAKE_GENES} x A in {TAKE_ARCHIVES} over {TAKE_STATES} states, index vectors with "
        "duplicates, the identity, reversed, 256 copies of one row; NaN and -0 carried")


def time_gate_repack(device, smi: str) -> list:
    """K6a's and K6b's records at ``K6_TIMED``: device ms (CUDA graph of 20
    launches), wrapper ms, plain ms, bound by bytes; K6b with the summed
    time of one ``index_select`` per leaf as a note."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import take_carry_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import engine_quality_stats

    s, p, a, l = K6_TIMED
    rng = np.random.default_rng(16)
    thr, eps = 0.5, float("inf")
    f = torch.as_tensor(gate_sweep_objectives(rng, s, p + a, thr, 0.1), device=device)
    pop_f, arch_f = f[:, :p].contiguous(), f[:, p:].contiguous()
    leaves = take_leaves(rng, device, s, p, a, l)
    sel = np.arange(s)[::-1].copy()
    idx = torch.as_tensor(sel, device=device)
    floats = sum(t[0].numel() for t in leaves)
    # the launch take_carry makes after its host-side checks and the copy of
    # the indices to the card, which a CUDA graph cannot capture: the device
    # time is the kernel's; the wrapper's time holds the check and the copy
    outs = [torch.empty((s, *t.shape[1:]), dtype=t.dtype, device=device) for t in leaves]
    segments = [(t, o, t[0].numel(), 0) for t, o in zip(leaves, outs)]
    kernels._take(idx, s, segments, device)
    for g, w in zip(outs, take_carry_plain(idx, leaves)):
        if not same_bits(g, w):
            raise AssertionError("the timed take_carry launch differs from index_select")
    specs = (
        ("gate_stats", "attacks/objective.py:55",
         lambda: kernels.gate_stats(pop_f, arch_f, thr, eps),
         lambda: engine_quality_stats(torch.cat([pop_f, arch_f], dim=1), thr, eps),
         4 * s * (p + a) * 3 + 4 * s * 9, GATE_OPS_PER_CANDIDATE * s * (p + a), None),
        ("take_carry", "attacks/moeva/engine.py:874",
         lambda: kernels._take(idx, s, segments, device), lambda: take_carry_plain(idx, leaves),
         2 * 4 * s * floats + 8 * s, 0, lambda: sum(cuda_ms(lambda t=t: t.index_select(0, idx)) for t in leaves)),
    )
    records = []
    for name, replaces, kfn, pfn, n_bytes, n_ops, note in specs:
        b_ms, b_by = bound_ms(n_bytes, n_ops, 0)
        rec = {
            "name": name,
            "route": "cuda",
            "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/gate_repack.cu",
            "replaces": "moeva2_ijcai22_replication_tpu/" + replaces,
            "launches": 0,
            "max_abs_err": 0.0,
            "ms": graph_ms(kfn),
            "wrapper_ms": cuda_ms(kfn if name == "gate_stats" else lambda: kernels.take_carry(sel, leaves)),
            "plain_ms": cuda_ms(pfn),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        extra = ""
        if note is not None:
            rec["index_select_ms"] = note()
            extra = f", one index_select per leaf summed {rec['index_select_ms']:.4f} ms (not one call: library_ms null)"
        log(f"[early-exit] {name} at S={s} P={p} A={a} L={l}: device {rec['ms']:.4f} ms, through the wrapper "
            f"{rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {n_bytes} "
            f"bytes){extra} on {smi}")
        records.append(rec)
    return records


class RecordedDraws:
    """Draws recorded from the CPU's generator and replayed on the card:
    ``recorder(engine)`` gives a draw source that records every draw of the
    CPU engine's run, ``replay(device)`` one that hands them out again in
    order, moved to ``device``."""

    def __init__(self):
        self.items = []

    def recorder(self, engine):
        from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import PhiloxDraws

        items = self.items

        class Recording(PhiloxDraws):
            def init(self, n):
                items.append(super().init(n))
                return items[-1]

            def generation(self, n):
                items.append(super().generation(n))
                return items[-1]

        return Recording(engine, engine.seed)

    def replay(self, device):
        items = iter(self.items)

        def move(d):
            if d is None or not isinstance(d, tuple):
                return None if d is None else d.to(device)
            return type(d)(*(move(t) for t in d))

        class Replay:
            def init(self, n):
                return move(next(items))

            def generation(self, n):
                return move(next(items))

        return Replay()


def same_result(a, b, record: bool = True) -> bool:
    """Equal populations, objectives (NaN where NaN), decoded rows and
    steps, and with ``record`` equal early-exit records."""
    return (np.array_equal(a.x_gen, b.x_gen) and np.array_equal(a.f, b.f, equal_nan=True)
            and np.array_equal(a.x_ml, b.x_ml) and a.gens_executed == b.gens_executed
            and (not record or a.early_stop == b.early_stop))


def drive_early_exit(moeva, x, smi: str, tag: str, n_states: int) -> tuple:
    """``generate`` with the launch counts set to 0 just before and read
    just after, checked against what the early exit's record implies;
    returns ``(result, launches, wall s)``."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_launches(launches, expected_launches(moeva, n_states, res), f"the {tag} early exit")
    if not np.isfinite(res.x_ml).all():
        raise AssertionError(f"{tag}: non-finite values in x_ml")
    frozen = ~moeva.constraints.schema.mutable
    if not np.array_equal(res.x_ml[:, :, frozen], np.broadcast_to(x[:, None, frozen].astype(np.float32),
                                                                  res.x_ml[:, :, frozen].shape)):
        raise AssertionError(f"{tag}: immutable features moved")
    log(f"[early-exit] {tag}: {n_states} states, gate every {moeva.early_stop_check_every} at f1 < "
        f"{moeva.early_stop_threshold}: {res.gens_executed} of {res.early_stop['budget_gens']} generation steps run, "
        f"compaction {res.early_stop['compaction']}; launches {({k: v for k, v in launches.items() if v})} as the "
        f"record implies; wall {wall:.3f} s on {smi}")
    return res, launches, wall


def check_resume(moeva, x, want, tmp: str) -> None:
    """The early exit's run interrupted right after its first checkpoint,
    then run again: it resumes there and equals the uninterrupted ``want``."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.checkpoint import AttackCheckpointer

    class Crash(RuntimeError):
        pass

    save = AttackCheckpointer.save

    def crash(self, *args, **kwargs):
        save(self, *args, **kwargs)
        raise Crash(self.path)

    moeva.checkpoint_every, moeva.checkpoint_path = 10, f"{tmp}/ee.npz"
    steps = []
    step = moeva.gen_step
    try:
        AttackCheckpointer.save = crash
        try:
            moeva.generate(x, minimize_class=1)
            raise AssertionError("the run wrote no checkpoint to interrupt")
        except Crash:
            pass
        AttackCheckpointer.save = save
        moeva.gen_step = lambda *a: steps.append(1) or step(*a)
        got = moeva.generate(x, minimize_class=1)
    finally:
        AttackCheckpointer.save = save
        moeva.__dict__.pop("gen_step", None)
        moeva.checkpoint_every, moeva.checkpoint_path = 0, None
    if not same_result(got, want) or len(steps) >= want.gens_executed:
        raise AssertionError(f"resumed run differs from the uninterrupted one ({len(steps)} steps after resuming)")
    log(f"[early-exit] interrupted right after its checkpoint at generation 10 and run again: resumed ({len(steps)} "
        f"of {want.gens_executed} steps run after it), equal to the uninterrupted run bit for bit")


def check_early_exit_card_vs_cpu(device, sur, cons, scaler, x) -> None:
    """``EE_CPU_RUN`` on the card and on the CPU, fed the draws of the
    CPU's generator and the card's aspiration points (K14's; see
    ``check_step_against_cpu``): equal results, records and quality
    samples."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2

    n, n_gen = EE_CPU_RUN
    knobs = dict(norm=2, n_gen=n_gen, n_pop=100, n_offsprings=100, archive_size=24, seed=7, **EE_CPU_KNOBS)
    draws = RecordedDraws()
    gpu = Moeva2(sur, cons, ml_scaler=scaler, device=device, **knobs)
    cpu = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs)
    cpu.asp_points = gpu.asp_points.cpu()
    cpu.draw_hook = lambda i: draws.recorder(cpu)
    want = cpu.generate(x[:n], minimize_class=1)
    gpu.draw_hook = lambda i: draws.replay(device)
    got = gpu.generate(x[:n], minimize_class=1)
    samples = [(a["gen"], np.array_equal(a["per_state"], b["per_state"], equal_nan=True))
               for a, b in zip(got.quality["samples"], want.quality["samples"])]
    if not same_result(got, want) or not all(ok for _, ok in samples) or len(samples) != len(want.quality["samples"]):
        raise AssertionError(f"the early exit on the card differs from the CPU fed the same draws: {got.early_stop} vs "
                             f"{want.early_stop}, samples {samples}")
    if not any(t["bucket"] < n for t in want.early_stop["compaction"]):
        raise AssertionError(f"the card-vs-CPU run repacked nothing: {want.early_stop}")
    log(f"[early-exit] card vs CPU at {n} states x {n_gen - 1} steps, gate every "
        f"{knobs['early_stop_check_every']} at f1 < {knobs['early_stop_threshold']}, fed the CPU's draws: populations, "
        f"objectives, decoded rows, the record {want.early_stop['compaction']} and {len(samples)} quality samples "
        "equal bit for bit")


def run_early_exit(device, smi: str, resources: list, records: list) -> dict:
    """Phase 15: the early exit (ROADMAP A7) with kernel K6. Returns the
    launch counts of its main-path run."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

    t0 = time.perf_counter()
    for k in resources:
        if k["source"].endswith("gate_repack.cu"):
            log(f"[early-exit] K6 ptxas: {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
                f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    check_gate_repack(device)
    k6 = time_gate_repack(device, smi)

    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = synthetic_lcld_problem(tmp, N_STATES)
    knobs = dict(norm=2, n_gen=N_GEN, n_pop=100, n_offsprings=100, archive_size=24, seed=42)
    torch.cuda.synchronize()
    t_strict = time.perf_counter()
    strict = Moeva2(sur, cons, ml_scaler=scaler, device=device, **knobs).generate(x, minimize_class=1)
    torch.cuda.synchronize()
    t_strict = time.perf_counter() - t_strict
    moeva = Moeva2(sur, cons, ml_scaler=scaler, device=device, **knobs, **EE_KNOBS)
    res, launches, wall = drive_early_exit(moeva, x, smi, "main path", N_STATES)
    flushes = moeva.last_deferred_gate_flushes
    trace = res.early_stop["compaction"]
    rows = [N_STATES] + [t["bucket"] for t in trace]
    if any(b > a for a, b in zip(rows, rows[1:])) or any(t["bucket"] not in EE_KNOBS["compaction_buckets"]
                                                         for t, a in zip(trace, rows) if t["bucket"] < a):
        raise AssertionError(f"the buckets did not shrink monotonically down the menu: {rows}")
    if not res.gens_executed < N_GEN - 1 or not any(t["bucket"] < N_STATES for t in trace):
        raise AssertionError(f"the main path's early exit neither repacked nor ended early: {res.early_stop}")
    gates = launches["gate_stats"]
    for rec in k6:
        rec["launches_per_gate"] = launches[rec["name"]] / gates
    log(f"[early-exit] rows per gate {rows}; {gates} gates, {launches['take_carry']} K6b launches "
        f"({launches['take_carry'] / gates:.2f} a gate); {flushes} gate flushes deferred past the next segment's "
        f"launches; wall {wall:.3f} s against {t_strict:.3f} s for strict mode's {strict.gens_executed} steps (each on "
        f"a fresh engine) on {smi}")
    records += k6

    moeva.double_buffer = False
    serial = moeva.generate(x, minimize_class=1)
    moeva.double_buffer = True
    if not same_result(serial, res) or moeva.last_deferred_gate_flushes != 0 or not flushes:
        raise AssertionError("double_buffer off changed the result, or the deferred flushes were not counted")
    never = Moeva2(sur, cons, ml_scaler=scaler, device=device, **knobs, **dict(EE_KNOBS, early_stop_threshold=0.0))
    quality = Moeva2(sur, cons, ml_scaler=scaler, device=device, **knobs, record_quality=True, quality_every=10)
    got_never, got_quality = (e.generate(x, minimize_class=1) for e in (never, quality))
    if got_never.early_stop["compaction"] or not same_result(got_never, strict, record=False):
        raise AssertionError("a gate that never fires changed the result")
    if not same_result(got_quality, strict) or len(got_quality.quality["samples"]) != (N_GEN - 2) // 10 + 1:
        raise AssertionError("quality_every changed the result or took the wrong samples")
    log("[early-exit] double_buffer off, a gate that never fires (f1 < 0) and quality_every 10 (9 interior samples) "
        "give the results of double_buffer on and of strict mode, bit for bit")
    with tempfile.TemporaryDirectory() as tmp:
        check_resume(moeva, x, res, tmp)
    check_early_exit_card_vs_cpu(device, sur, cons, scaler, x)

    bcons, bsur, bscaler, bx, _ = botnet_problem()
    botnet = Moeva2(bsur, bcons, ml_scaler=bscaler, device=device, **EE_BOTNET_KNOBS)
    bres, _, _ = drive_early_exit(botnet, bx, smi, "botnet (chunks of 256)", BOTNET_STATES)
    if not bres.early_stop["compaction"]:
        raise AssertionError("botnet's early exit parked no state")

    with tempfile.TemporaryDirectory() as tmp:
        art = f"{tmp}/lcld"
        write_runner_artifacts("lcld", art)
        base = runner_config("lcld", "moeva", art)
        strict_m = drive_runner(base, smi, point_expected_launches("moeva", base), "moeva lcld (strict)")
        cfg = dict(base, early_stop_check_every=10, early_stop_threshold=0.5)
        results = []
        generate = Moeva2.generate

        def capture(self, *a, **k):
            results.append(generate(self, *a, **k))
            return results[-1]

        Moeva2.generate = capture
        try:
            ee_m = drive_runner(cfg, smi, lambda: point_expected_launches("moeva", cfg, results[-1]),
                                "moeva lcld early_stop_check_every 10, early_stop_threshold 0.5")
        finally:
            Moeva2.generate = generate
        if ee_m["execution"]["gens_executed"] != results[-1].gens_executed or not results[-1].early_stop["compaction"]:
            raise AssertionError(f"runner execution {ee_m['execution']} vs the engine's {results[-1].early_stop}")
        fmt = lambda m: " ".join(f"{v:.4f}" for v in m["objectives_list"][0].values())  # noqa: E731
        log(f"[early-exit] rq1.lcld's MoEvA point through the runner: o1..o7 strict {fmt(strict_m)}; with the early "
            f"exit {fmt(ee_m)} ({ee_m['execution']['gens_executed']} of {results[-1].early_stop['budget_gens']} steps; "
            "judged at f1 < 0.25, parked at "
            f"0.5); time {ee_m['time']:.3f} s against strict {strict_m['time']:.3f} s on {smi}")
    log(f"[early-exit] phase 15 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return launches


# -- phase 16: the history of every evaluation (save_history) --------------------

#: the history's launch counts: K1's and K8's kHistory instantiations. No
#: grid file of ``config/`` sets ``save_history``: phase 13 launches none of
#: them, which phase 16 must launch
HISTORY_COUNTERS = ("objective_lcld_hist", "objective_lcld_aug_hist", "objective_botnet_hist",
                    "objective_botnet_aug_hist")
#: each history instantiation's ptxas entries (a 128-row tile with the stack
#: staged, a 64-row one with it in global memory for K1) beside its base's
HISTORY_ENTRIES = {
    "objective_lcld_hist": (("objective_lcld_kernel<128,1,0,1>", "objective_lcld_kernel<128,1,0,0>"),
                            ("objective_lcld_kernel<64,0,0,1>", "objective_lcld_kernel<64,0,0,0>")),
    "objective_lcld_aug_hist": (("objective_lcld_kernel<128,1,1,1>", "objective_lcld_kernel<128,1,1,0>"),
                                ("objective_lcld_kernel<64,0,1,1>", "objective_lcld_kernel<64,0,1,0>")),
    "objective_botnet_hist": (("objective_botnet_kernel<0,1>", "objective_botnet_kernel<0,0>"),),
    "objective_botnet_aug_hist": (("objective_botnet_kernel<1,1>", "objective_botnet_kernel<1,0>"),),
}
#: the shapes each history instantiation is held and timed at (states x
#: candidates): LCLD the main path's, augmented LCLD the runner's chunk,
#: botnet and augmented botnet rq1.botnet's states
HISTORY_SHAPES = {"objective_lcld_hist": (1000, 100), "objective_lcld_aug_hist": (256, 100),
                  "objective_botnet_hist": (387, 100), "objective_botnet_aug_hist": (387, 100)}
#: ``config/lcld.yaml``, the static config behind the paper's convergence
#: figures, its artifact paths and results directory replaced by phase 16's
LCLD_HISTORY_STATIC = {
    "project_name": "lcld", "misclassification_threshold": 0.25, "norm": 2, "n_initial_state": 4000,
    "initial_state_offset": 0, "system": {"n_jobs": -1, "verbose": 1, "mesh_devices": 0},
    "save_history": "full", "history_chunk": 25, "reconstruction": False,
}
#: the grid point phase 16 runs it at: rq1.lcld's seed, first budget and ε
HISTORY_POINT = {"seed": 42, "budget": 100, "eps_list": [0.2]}
#: the engine runs of phase 16 beside the runner's: botnet as rq1.botnet
#: runs it, cut to 26 generations in segments of 10 (three segments, the
#: last one short); augmented LCLD at the runner's chunk and augmented
#: botnet at a small budget
HISTORY_BOTNET_KNOBS = dict(BOTNET_KNOBS, n_gen=26, save_history="full", history_chunk=10)
HISTORY_AUG_KNOBS = dict(norm=2, n_gen=12, n_pop=200, n_offsprings=100, archive_size=24, seed=42,
                         save_history="full", history_chunk=5)
HISTORY_AUG_STATES = 256
HISTORY_BOTNET_AUG_KNOBS = dict(BOTNET_KNOBS, n_gen=6, save_history="full", history_chunk=2)
HISTORY_BOTNET_AUG_STATES = 131


def history_config(artifacts: str, save_history) -> dict:
    """Phase 16's runner config: ``config/moeva.yaml`` with
    ``config/lcld.yaml`` (``LCLD_HISTORY_STATIC``) at ``HISTORY_POINT``,
    composed as the grid runner composes them, over phase 10's artifacts in
    ``artifacts``, with ``save_history`` set as asked."""
    import copy

    cfg = copy.deepcopy(MOEVA_YAML)
    cfg.update(copy.deepcopy(LCLD_HISTORY_STATIC))
    cfg["paths"] = runner_config("lcld", "moeva", artifacts)["paths"]
    cfg["dirs"] = {"results": f"{artifacts}/out/lcld/l2_last"}
    cfg.update(copy.deepcopy(HISTORY_POINT))
    cfg["save_history"] = save_history
    return cfg


def history_problem(device, name: str):
    """The engine and problem that ``name``'s history instantiation is held
    on: (engine, run inputs, candidates with the domain's edge rows, the
    kernel's wrapper)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import draw_gumbels
    from moeva2_ijcai22_replication_tpu_torch.problems import (
        synthetic_botnet_augmented_problem, synthetic_botnet_problem, synthetic_lcld_augmented_problem,
        synthetic_lcld_problem,
    )

    s, n = HISTORY_SHAPES[name]
    make = {"objective_lcld_hist": synthetic_lcld_problem, "objective_lcld_aug_hist": synthetic_lcld_augmented_problem,
            "objective_botnet_hist": synthetic_botnet_problem,
            "objective_botnet_aug_hist": synthetic_botnet_augmented_problem}[name]
    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = make(tmp, s)
    lcld = name.startswith("objective_lcld")
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=device, n_pop=100 if lcld else 200, n_offsprings=n,
                 archive_size=24, seed=42, save_history="full")
    run = eng.prepare(x, np.arange(s) % 2)
    gen = torch.Generator(device=device).manual_seed(s)
    if lcld:
        carry = eng.init_carry(run, *draw_gumbels(stream_of(gen), s, eng.n_dirs, eng.pop_size))
        off = eng.offspring(run, carry.pop_x, eng.draw_generation(stream_of(gen), s).offspring)
        cand = hard_candidates(eng.codec, off) if name == "objective_lcld_hist" else aug_candidates(
            eng.codec, cons, x, off)
        return eng, run, cand, kernels.objective_lcld
    return eng, run, botnet_candidates(gen, eng, run, n), kernels.objective_botnet


def left_to_right_terms(record):
    """The record's kept terms (columns 3 on) summed left to right, one
    rounded add at a time, as the kernels and the plain version sum them."""
    g = record[..., 3].clone()
    for k in range(4, record.shape[-1]):
        g = g + record[..., k]
    return g


def objective_work(eng, s: int, n: int):
    """K1's or K8's bytes and operations for ``s`` x ``n`` rows (phase 3's
    count for K1, with the pair stage on the augmented domain; ``botnet_bound``
    for K8)."""
    obj = eng._objective
    if eng.constraints.objective_kernel == "botnet":
        return botnet_bound(eng, s, n)
    l, d = eng.codec.gen_length, eng.codec.n_features
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    pairs = 0 if obj.cons is None else obj.cons.idx.shape[0]
    n_bytes = 4 * s * n * l + 16 * s * d + 8 * s + 4 * n_params + 16 * d + 16 * pairs + 12 * s * n
    n_ops = s * n * (2 * macs + OBJECTIVE_OPS_PER_FEATURE * d + OBJECTIVE_OPS_PER_ROW + OBJECTIVE_OPS_PER_PAIR * pairs)
    return n_bytes, n_ops


def check_history_kernel(device, name: str, smi: str) -> dict:
    """``name``'s history instantiation on its problem (``HISTORY_SHAPES``):
    its record equal to ``evaluate_hist_plain``'s and its ``out`` to the base
    kernel's, bit for bit, edge rows included; column 2 the left-to-right
    sum of the kept terms; a 3-column record is the base kernel's output;
    then its device ms beside the base's, in turns, and its record for the
    kernels line."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_hist_plain

    eng, run, cand, kernel = history_problem(device, name)
    s, n = HISTORY_SHAPES[name]
    cols = eng.history_columns()
    args = (cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
    base = name[: -len("_hist")]
    record = torch.full((s, n, cols), float("nan"), device=device)
    kernels.reset_launch_counts()
    want_out = kernel(*args)
    out = kernel(*args, record=record)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts[base] != 1 or counts[name] != 1:
        raise AssertionError(f"{name}: launches {counts}, not one of {base} and one of {name}")
    f, want = evaluate_hist_plain(eng._objective, eng.codec, run, cand, eng.constraints, "full")
    hold_equal(record, want, f"{name}'s record")
    hold_equal(out, want_out, f"{name}'s out against {base}'s")
    hold_equal(out, f, f"{name}'s out against the plain version")
    hold_equal(left_to_right_terms(record), record[..., 2], f"{name}'s column 2 against its terms' sum")
    reduced = torch.full((s, n, 3), float("nan"), device=device)
    if kernel(*args, record=reduced).data_ptr() != reduced.data_ptr():
        raise AssertionError(f"{name}: a 3-column record is not the base kernel's output")
    hold_equal(reduced, want_out, f"{base} writing a 3-column record")
    rows_nonfinite = int((~torch.isfinite(want)).any(-1).sum())
    n_inf_terms = int(torch.isinf(want[..., 3:]).sum())
    times = {"hist": [], "base": []}
    for turn in ("base", "hist", "hist", "base"):
        fn = (lambda: kernel(*args, record=record)) if turn == "hist" else (lambda: kernel(*args))
        times[turn].append(graph_ms(fn))
    ms, base_ms = statistics.median(times["hist"]), statistics.median(times["base"])
    n_bytes, n_ops = objective_work(eng, s, n)
    rec_bytes = 4 * s * n * cols
    b_ms, b_by = bound_ms(n_bytes + rec_bytes, n_ops + s * n * cols, 0)
    base_b_ms, _ = bound_ms(n_bytes, n_ops, 0)
    rec = {
        "name": name,
        "route": "cuda",
        "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/"
                  + ("objective_lcld.cu" if kernel is kernels.objective_lcld else "objective_botnet.cu"),
        "replaces": "moeva2_ijcai22_replication_tpu/attacks/moeva/engine.py:473",
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": ms,
        "wrapper_ms": cuda_ms(lambda: kernel(*args, record=record)),
        "plain_ms": cuda_ms(lambda: evaluate_hist_plain(eng._objective, eng.codec, run, cand, eng.constraints,
                                                        "full"), launches=2, repeats=3),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "base_ms": base_ms,
        "base_bound_ms": base_b_ms,
        "record_bytes_ms": rec_bytes / PEAK_BYTES_S * 1e3,
        "ms_turns": times,
        "shape": f"{s}x{n}x{cols}",
    }
    log(f"[history] {name} at S={s} N={n}, {cols} columns: record equal to evaluate_hist_plain's bit for bit "
        f"({rows_nonfinite} rows with a non-finite entry, {n_inf_terms} infinite terms), out equal to {base}'s, "
        f"column 2 the terms' left-to-right sum; a 3-column record is {base}'s output. Device {ms:.4f} ms "
        f"against {base}'s {base_ms:.4f} ms in turns (x{ms / base_ms:.4f}), through the wrapper "
        f"{rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, bound {b_ms:.5f} ms ({b_by}; the base's "
        f"{base_b_ms:.5f} ms; the record's {rec_bytes / 1e6:.1f} MB alone {rec['record_bytes_ms']:.5f} ms at "
        f"3.35 TB/s) on {smi}")
    return rec


def check_history_records(res, n_states: int, pop: int, n_off: int, cols: int, n_gen: int, tag: str) -> None:
    """The history's layout (the initial record, then one a generation
    step), no NaN among the kept terms (a NaN term counts 0), f1 and f2
    finite wherever the terms are, and column 2 the terms' left-to-right
    sum, bit for bit."""
    import torch

    hist = res.history
    if len(hist) != n_gen or hist[0].shape != (n_states, pop, cols) or any(
            h.shape != (n_states, n_off, cols) for h in hist[1:]):
        raise AssertionError(f"{tag}: history of {len(hist)} records, shapes {hist[0].shape}, {hist[-1].shape}")
    for i, h in enumerate(hist):
        t = torch.as_tensor(h)
        terms = t[..., 3:]
        if bool(terms.isnan().any()):
            raise AssertionError(f"{tag}: record {i} keeps a NaN term")
        away = torch.isfinite(terms).all(-1)
        if not bool(torch.isfinite(t[..., :2][away]).all()):
            raise AssertionError(f"{tag}: record {i} has a non-finite f1 or f2 on a row with finite terms")
        hold_equal(left_to_right_terms(t), t[..., 2], f"{tag}: record {i}'s column 2")


def drive_history(moeva, x, smi: str, tag: str) -> tuple:
    """``generate`` with its history, the launch counts set to 0 just before
    and read just after and held to what the code implies; returns
    ``(result, launches, wall s)``."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_launches(launches, expected_launches(moeva, len(x)), f"the {tag} history")
    check_history_records(res, len(x), moeva.pop_size, moeva.n_offsprings, moeva.history_columns(), moeva.n_gen, tag)
    host_gb = sum(h.nbytes for h in res.history) / 1e9
    log(f"[history] {tag}: {len(x)} states x {moeva.n_gen} generations, save_history {moeva.save_history!r} in "
        f"segments of {moeva.history_chunk}: {len(res.history)} records of {moeva.history_columns()} columns, "
        f"{host_gb:.3f} GB on the host, no NaN term, f1 and f2 finite on rows with finite terms, column 2 the terms' "
        f"sum; launches {({k: v for k, v in launches.items() if v})} as the code implies; wall {wall:.3f} s on {smi}")
    return res, launches, wall


def run_history_runner(smi: str) -> dict:
    """``config/moeva.yaml`` with ``config/lcld.yaml`` through the runner at
    ``HISTORY_POINT`` over phase 10's artifacts (4000 states, 16 chunks of
    256): "full", then "reduced", then no history, each a run of phase 10's
    checks with its ``x_history`` file's shape and values; returns the
    "full" run's launches."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash

    with tempfile.TemporaryDirectory() as art:
        write_runner_artifacts("lcld", art)
        walls, files, launches = {}, {}, None
        for mode in ("full", "reduced", False):
            cfg = history_config(art, mode)
            t0 = time.perf_counter()
            metrics = drive_runner(cfg, smi, point_expected_launches("moeva", cfg), f"moeva lcld save_history {mode!r}")
            walls[mode] = time.perf_counter() - t0
            if mode == "full":
                launches = kernels.launch_counts()
            out, h = cfg["dirs"]["results"], get_dict_hash(cfg)
            files[mode] = (f"{out}/x_attacks_moeva_{h}.npy", f"{out}/x_history_moeva_{h}.npy" if mode else None,
                           metrics)
        n = cfg["n_initial_state"]
        full = np.load(files["full"][1], mmap_mode="r")
        reduced = np.load(files["reduced"][1], mmap_mode="r")
        shapes = {"full": (cfg["budget"] - 1, n, cfg["n_offsprings"], 13), "reduced": (cfg["budget"] - 1, n,
                                                                                       cfg["n_offsprings"], 3)}
        if full.shape != shapes["full"] or reduced.shape != shapes["reduced"] or full.dtype != np.float32:
            raise AssertionError(f"x_history shapes {full.shape} {reduced.shape}, not {shapes}")
        for k in range(0, full.shape[0], 11):
            if not np.array_equal(full[k, ..., :3], reduced[k], equal_nan=True):
                raise AssertionError(f"the reduced history's record {k} is not the full one's objectives")
            record = torch.as_tensor(np.array(full[k]))
            hold_equal(left_to_right_terms(record), record[..., 2], f"x_history record {k}'s column 2")
        x_att = [np.load(files[m][0]) for m in ("full", "reduced", False)]
        if not all(np.array_equal(a, x_att[0]) for a in x_att[1:]):
            raise AssertionError("the history changed the attack's result")
        size_gb = os.path.getsize(files["full"][1]) / 1e9
        del full, reduced
    log(f"[history] config/moeva.yaml + config/lcld.yaml through the runner, {n} states x {cfg['budget']} "
        f"generations ({-(-n // cfg['max_states_per_call'])} chunks of at most {cfg['max_states_per_call']}), "
        f"history_chunk {cfg['history_chunk']}: x_history {shapes['full']} float32 ({size_gb:.3f} GB) "
        f"and {shapes['reduced']}, the reduced one the full one's first 3 columns, x_attacks equal with and without "
        f"the history; wall full {walls['full']:.3f} s, reduced {walls['reduced']:.3f} s, none {walls[False]:.3f} s "
        f"(the runner's attack span {files['full'][2]['time']:.3f} s, {files['reduced'][2]['time']:.3f} s, "
        f"{files[False][2]['time']:.3f} s) on {smi}")
    return launches


def run_history(device, smi: str, resources: list, records: list) -> dict:
    """Phase 16: MoEvA's ``save_history`` (ROADMAP A7b) with K1's and K8's
    history instantiations. Returns the launch counts of its main paths'
    runs, each set to 0 just before and read just after."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.problems import (
        synthetic_botnet_augmented_problem, synthetic_lcld_augmented_problem,
    )

    t0 = time.perf_counter()
    by_name = {k["kernel"]: k for k in resources}
    for name, entries in HISTORY_ENTRIES.items():
        for hist, base in entries:
            if hist not in by_name or base not in by_name:
                raise AssertionError(f"the build's ptxas report has no entry for {hist} or {base}")
            for k in (by_name[hist], by_name[base]):
                log(f"[history] ptxas {name}: {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack "
                    f"frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    for name in HISTORY_COUNTERS:
        records.append(check_history_kernel(device, name, smi))

    launches = {}
    launches.update({k: v for k, v in run_history_runner(smi).items() if k == "objective_lcld_hist"})

    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = synthetic_lcld_augmented_problem(tmp, HISTORY_AUG_STATES)
    aug = Moeva2(sur, cons, ml_scaler=scaler, device=device, **HISTORY_AUG_KNOBS)
    _, got, _ = drive_history(aug, x, smi, "augmented LCLD (D = 57)")
    launches["objective_lcld_aug_hist"] = got["objective_lcld_aug_hist"]

    bcons, bsur, bscaler, bx, _ = botnet_problem()
    botnet = Moeva2(bsur, bcons, ml_scaler=bscaler, device=device, **HISTORY_BOTNET_KNOBS)
    steps, seg = botnet.n_gen - 1, botnet.history_chunk
    _, got, _ = drive_history(botnet, bx, smi, f"botnet (chunks of {botnet.max_states_per_call}; segments "
                              + ", ".join(str(min(seg, steps - k)) for k in range(0, steps, seg)) + ")")
    launches["objective_botnet_hist"] = got["objective_botnet_hist"]

    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = synthetic_botnet_augmented_problem(tmp, HISTORY_BOTNET_AUG_STATES)
    baug = Moeva2(sur, cons, ml_scaler=scaler, device=device, **HISTORY_BOTNET_AUG_KNOBS)
    log(f"[history] K8's block at D = 927 takes {botnet_smem_bytes(baug)} bytes of shared memory with or without the "
        "history (the record is written from the ring and registers)")
    _, got, _ = drive_history(baug, x, smi, "augmented botnet (D = 927)")
    launches["objective_botnet_aug_hist"] = got["objective_botnet_aug_hist"]
    if not all(launches[k] for k in HISTORY_COUNTERS):
        raise AssertionError(f"phase 16 launched no {[k for k in HISTORY_COUNTERS if not launches.get(k)]}")
    log(f"[history] phase 16 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return launches


# -- phase 17: domains compiled from a constraint spec (K9) --------------------------

#: K9's launch counts. No grid file of ``config/`` names a spec domain:
#: phase 13 launches none of them, which phase 17 must launch
SPEC_COUNTERS = ("objective_spec", "objective_spec_hist")
#: the seeded families phase 17 holds K9 on (D = 13), and their states
SPEC_FAMILIES = (2, 5)
SPEC_FAMILY_STATES = 256
#: K9's sweep (states, candidates): fewer rows than a tile, partial tiles of
#: 128, 64 and 32 rows, tiles spanning states, the population's 203 rows
SPEC_SWEEP = ((1, 7), (3, 100), (5, 27), (64, 203), (131, 100))
#: the shapes K9 is timed at, beside K1 and K8: the main path's and
#: rq1.botnet's (states, offspring)
SPEC_TIMED = {"lcld_spec": (1000, 100), "botnet_spec": (387, 100)}
#: botnet_spec's generate beside botnet's: config/rq1.botnet.yaml's run cut
#: to 100 generations (of its 1000) to keep phase 17 near 90 s
SPEC_BOTNET_KNOBS = dict(BOTNET_KNOBS, n_gen=100)
#: lcld_spec's engine with a history beside lcld's: 256 states (one chunk of
#: config/moeva.yaml's) x 20 generations, "full" then "reduced"
SPEC_HISTORY_STATES = 256
SPEC_HISTORY_KNOBS = dict(norm=2, n_gen=20, n_pop=200, n_offsprings=100, archive_size=24, seed=42,
                          history_chunk=7)
#: the phishing fixture's domain in tests/fixtures/oracle_interior_rates.json
SPEC_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "oracle_interior_rates.json")


def spec_problems(tmp: str) -> dict:
    """Phase 17's spec domains: name -> (constraints, surrogate, scaler,
    states): ``lcld_spec`` on 1000 synthetic LCLD states and ``botnet_spec``
    on rq1.botnet's 387 (the hand-written problems' files, rows, surrogates
    and scalers), phishing at the oracle fixture's config and the seeded
    families ``SPEC_FAMILIES``."""
    from moeva2_ijcai22_replication_tpu_torch.problems import (
        phishing_problem, synthetic_botnet_spec_problem, synthetic_family_problem, synthetic_lcld_spec_problem,
    )

    with open(SPEC_ORACLE) as f:
        cfg = json.load(f)["domains"]["phishing"]["config"]
    out = {
        "lcld_spec": synthetic_lcld_spec_problem(f"{tmp}/lcld", N_STATES),
        "botnet_spec": synthetic_botnet_spec_problem(f"{tmp}/botnet", BOTNET_STATES),
        "phishing": phishing_problem(cfg),
    }
    for k in SPEC_FAMILIES:
        out[f"family{k}"] = synthetic_family_problem(f"{tmp}/family{k}", k, SPEC_FAMILY_STATES)
    return out


def spec_inputs(eng, x: np.ndarray, s: int, n: int, seed: int = 0):
    """(run inputs, candidates (S, N, L) float32 on the engine's card) for
    the first ``s`` of the states ``x`` (repeated where fewer): the spec
    operators' edge rows first, then perturbed states
    (``problems.spec_candidates``)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.problems import spec_candidates

    xs = np.resize(x, (s, x.shape[1]))
    run = eng.prepare(xs, np.arange(s) % 2)
    cand = spec_candidates(eng._codec_cpu, eng.constraints, xs, n, seed=seed)
    return run, torch.as_tensor(cand, dtype=torch.float32, device=run.x_init_ml.device)


def kernel_args(run, cand, eng) -> tuple:
    return cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective


def check_spec_kernel(device, name: str, problem) -> dict:
    """K9 and its history instantiation against ``evaluate_plain`` and
    ``evaluate_hist_plain`` on the card, bit for bit, on ``name``'s problem
    over ``SPEC_SWEEP`` under L2 and L-inf, the candidates led by the spec's
    edge rows; out of both instantiations equal, column 2 the kept terms'
    left-to-right sum. Returns counts for the log."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_hist_plain, evaluate_plain

    cons, sur, scaler, x = problem
    cases = rows = nonfinite = 0
    for norm in (2, "inf"):
        eng = Moeva2(sur, cons, ml_scaler=scaler, norm=norm, n_pop=100, n_offsprings=100, device=device,
                     save_history="full")
        for s, n in SPEC_SWEEP:
            run, cand = spec_inputs(eng, x, s, n, seed=s + n)
            args = kernel_args(run, cand, eng)
            record = torch.full((s, n, eng.history_columns()), float("nan"), device=device)
            kernels.reset_launch_counts()
            out = kernels.objective_spec(*args)
            out_h = kernels.objective_spec(*args, record=record)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if counts["objective_spec"] != 1 or counts["objective_spec_hist"] != 1:
                raise AssertionError(f"{name}: launches {counts}, not one of objective_spec and one of its history")
            what = f"objective_spec on {name} (S={s} N={n}, norm {norm})"
            hold_equal(out, evaluate_plain(eng._objective, eng.codec, run, cand, cons), what)
            f, want = evaluate_hist_plain(eng._objective, eng.codec, run, cand, cons, "full")
            hold_equal(out_h, f, f"{what}'s history instantiation's out")
            hold_equal(record, want, f"{what}'s record")
            hold_equal(left_to_right_terms(record), record[..., 2], f"{what}'s column 2")
            cases += 1
            rows += s * n
            nonfinite += int((~torch.isfinite(out)).any(-1).sum())
    return {"cases": cases, "rows": rows, "nonfinite": nonfinite, "terms": cons.n_constraints,
            "features": cons.schema.n_features, "instructions": int(cons.program.code.shape[0]),
            "slots": cons.program.n_slots}


def spec_twins(device, problems: dict, tmp: str) -> dict:
    """Per twin pair, (spec engine, hand-written engine, states): lcld_spec
    and LCLD, botnet_spec and botnet, on the same files, surrogate and
    scaler, each with a history."""
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_problem, synthetic_lcld_problem

    out = {}
    for name, make, n in (("lcld_spec", synthetic_lcld_problem, N_STATES),
                          ("botnet_spec", synthetic_botnet_problem, BOTNET_STATES)):
        cons, sur, scaler, x = problems[name]
        hand = make(f"{tmp}/{name}_twin", n)[0]
        knobs = dict(ml_scaler=scaler, norm=2, n_pop=100, n_offsprings=100, device=device, save_history="full")
        out[name] = (Moeva2(sur, cons, **knobs), Moeva2(sur, hand, **knobs), x)
    return out


def check_spec_twins(device, twins: dict) -> None:
    """K9 on lcld_spec against K1 on LCLD and on botnet_spec against K8 on
    botnet, bit for bit, out and history record, on the same inputs: the
    sweep's shapes and the timed ones, the candidates led by the spec's edge
    rows with K1's and K8's own edge cases among them."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.problems import botnet_hard_candidates

    for name, (spec, hand, x) in twins.items():
        kernel = kernels.objective_lcld if name == "lcld_spec" else kernels.objective_botnet
        for s, n in SPEC_SWEEP + (SPEC_TIMED[name],):
            run, cand = spec_inputs(spec, x, s, n, seed=s * n)
            cand = hard_candidates(spec.codec, cand) if name == "lcld_spec" else botnet_hard_candidates(
                spec.codec, spec.constraints.schema.names, cand)
            rec_spec = torch.full((s, n, spec.history_columns()), float("nan"), device=device)
            rec_hand = torch.full_like(rec_spec, float("nan"))
            args = kernel_args(run, cand, spec)
            hold_equal(kernels.objective_spec(*args), kernel(*kernel_args(run, cand, hand)),
                       f"objective_spec on {name} against {kernel.__name__} (S={s} N={n})")
            kernels.objective_spec(*args, record=rec_spec)
            kernel(*kernel_args(run, cand, hand), record=rec_hand)
            hold_equal(rec_spec, rec_hand, f"objective_spec_hist on {name} against {kernel.__name__}'s (S={s} N={n})")


def spec_work(eng, s: int, n: int):
    """K9's bytes and operations for ``s`` x ``n`` rows of a spec domain: the
    genes, the states' rows, the stack, the program (16 bytes an
    instruction) and the objectives; per row the stack's 2 operations a
    weight, ``OBJECTIVE_OPS_PER_FEATURE`` per feature, 1 per instruction
    (2 per term: the threshold and the sum) and ``OBJECTIVE_OPS_PER_ROW``."""
    obj = eng._objective
    l, d = eng.codec.gen_length, eng.codec.n_features
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    prog = obj.cons
    n_instr = int(prog.code.shape[0])
    n_bytes = 4 * s * n * l + 16 * s * d + 8 * s + 4 * n_params + 16 * d + 16 * n_instr + 12 * s * n
    n_ops = s * n * (2 * macs + OBJECTIVE_OPS_PER_FEATURE * d + n_instr + prog.n_terms + OBJECTIVE_OPS_PER_ROW)
    return n_bytes, n_ops


def time_spec(device, twins: dict, smi: str) -> list:
    """K9 at ``SPEC_TIMED`` beside its twin kernel (K1 on lcld_spec's
    shape, K8 on botnet_spec's) in turns (CUDA graphs of 20), through its
    wrapper, its plain version and its bound; its history instantiation at
    lcld_spec's shape beside K9. Each on inputs it is held equal on. The
    bounds are the twins' (the same work on the same inputs:
    ``objective_work``), with K9's own count beside them (``spec_work``).
    Returns K9's and K9h's records."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_hist_plain, evaluate_plain

    shapes = {}
    for name, (spec, hand, x) in twins.items():
        s, n = SPEC_TIMED[name]
        kernel = kernels.objective_lcld if name == "lcld_spec" else kernels.objective_botnet
        run, cand = spec_inputs(spec, x, s, n, seed=7)
        sfn = lambda: kernels.objective_spec(*kernel_args(run, cand, spec))  # noqa: E731, B023
        hfn = lambda: kernel(*kernel_args(run, cand, hand))  # noqa: E731, B023
        hold_equal(sfn(), evaluate_plain(spec._objective, spec.codec, run, cand, spec.constraints),
                   f"objective_spec on {name} at its timed shape")
        times = {"spec": [], "twin": []}
        for turn in ("spec", "twin", "twin", "spec"):
            times[turn].append(graph_ms(sfn if turn == "spec" else hfn))
        n_bytes, n_ops = objective_work(hand, s, n)
        b_ms, b_by = bound_ms(n_bytes, n_ops, 0)
        own_ms, own_by = bound_ms(*spec_work(spec, s, n), 0)
        entry = {
            "shape": f"{s}x{n}", "ms": statistics.median(times["spec"]), "wrapper_ms": cuda_ms(sfn),
            "plain_ms": cuda_ms(lambda: evaluate_plain(spec._objective, spec.codec, run, cand,  # noqa: B023
                                                       spec.constraints), launches=2, repeats=3),
            "bound_ms": b_ms, "bound_by": b_by, "spec_work_bound_ms": own_ms, "spec_work_bound_by": own_by,
            "twin": kernel.__name__, "twin_ms": statistics.median(times["twin"]), "ms_turns": times,
        }
        if name == "lcld_spec":
            cols = spec.history_columns()
            record = torch.full((s, n, cols), float("nan"), device=device)
            kfn = lambda: kernels.objective_spec(*kernel_args(run, cand, spec), record=record)  # noqa: E731, B023
            kfn()
            hold_equal(record, evaluate_hist_plain(spec._objective, spec.codec, run, cand, spec.constraints,
                                                   "full")[1], "objective_spec_hist at its timed shape")
            hist = {"hist": [], "base": []}
            for turn in ("base", "hist", "hist", "base"):
                hist[turn].append(graph_ms(kfn if turn == "hist" else sfn))
            rec_bytes = 4 * s * n * cols
            hb_ms, hb_by = bound_ms(n_bytes + rec_bytes, n_ops + s * n * cols, 0)
            entry["hist"] = {
                "ms": statistics.median(hist["hist"]), "base_ms": statistics.median(hist["base"]),
                "wrapper_ms": cuda_ms(kfn), "bound_ms": hb_ms, "bound_by": hb_by, "ms_turns": hist,
                "plain_ms": cuda_ms(lambda: evaluate_hist_plain(spec._objective, spec.codec, run, cand,  # noqa: B023
                                                                spec.constraints, "full"), launches=2, repeats=3),
            }
        shapes[name] = entry
        log(f"[spec] objective_spec on {name} at S={s} N={n}: device {entry['ms']:.4f} ms against "
            f"{entry['twin']}'s {entry['twin_ms']:.4f} ms in turns (x{entry['ms'] / entry['twin_ms']:.2f}), through "
            f"the wrapper {entry['wrapper_ms']:.4f} ms, plain {entry['plain_ms']:.3f} ms, bound {b_ms:.5f} ms "
            f"({b_by}; {entry['twin']}'s count, the same work; K9's own count {own_ms:.5f} ms) on {smi}")
        if "hist" in entry:
            h = entry["hist"]
            log(f"[spec] objective_spec_hist on {name} at S={s} N={n}: device {h['ms']:.4f} ms against K9's "
                f"{h['base_ms']:.4f} ms in turns, through the wrapper {h['wrapper_ms']:.4f} ms, plain "
                f"{h['plain_ms']:.3f} ms, bound {h['bound_ms']:.5f} ms ({h['bound_by']}) on {smi}")
    lcld, botnet = shapes["lcld_spec"], shapes["botnet_spec"]
    base = {"route": "cuda", "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/objective_spec.cu",
            "replaces": "moeva2_ijcai22_replication_tpu/domains/ir/jnp_backend.py:32", "launches": 0,
            "max_abs_err": 0.0, "library_ms": None}
    rec = dict(base, name="objective_spec", **{k: lcld[k] for k in (
        "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "twin_ms", "spec_work_bound_ms", "shape")},
        botnet_spec_shape=botnet)
    hist = dict(base, name="objective_spec_hist", shape=lcld["shape"], **lcld["hist"])
    return [rec, hist]


def run_spec_runner(smi: str) -> dict:
    """rq1.lcld's MoEvA point through ``experiments.moeva.run`` with a
    ``spec:`` key naming the port's ``domains/specs/lcld.yaml``, composed as
    phase 10 composes the point (4000 states, budget 100, chunks of 256),
    with phase 10's checks; then the same point on the hand-written domain.
    Their ``x_attacks`` must be equal, bit for bit. Returns the spec run's
    launches."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.domains import SPEC_DIR
    from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash

    with tempfile.TemporaryDirectory() as art:
        write_runner_artifacts("lcld", art)
        hand = runner_config("lcld", "moeva", art)
        spec = dict(hand, spec=os.path.join(SPEC_DIR, "lcld.yaml"), dirs={"results": f"{art}/out/lcld_spec/rq1"})
        got = drive_runner(spec, smi, lambda: point_expected_launches("moeva", spec), "moeva lcld_spec (spec: key)")
        launches = kernels.launch_counts()
        want = drive_runner(hand, smi, lambda: point_expected_launches("moeva", hand), "moeva lcld (its twin)")
        a = np.load(f"{spec['dirs']['results']}/x_attacks_moeva_{get_dict_hash(spec)}.npy")
        b = np.load(f"{hand['dirs']['results']}/x_attacks_moeva_{get_dict_hash(hand)}.npy")
        if not np.array_equal(a, b, equal_nan=True) or got["objectives_list"] != want["objectives_list"]:
            raise AssertionError("the spec: point's x_attacks or rates differ from the same point on lcld")
    log(f"[spec] the spec: point's x_attacks {a.shape} equal lcld's bit for bit, o1..o7 equal; launches of the spec "
        f"run {({k: v for k, v in launches.items() if v})}")
    return launches


def drive_twin_runs(device, twins: dict, smi: str) -> dict:
    """``Moeva2.generate`` on botnet_spec (rq1.botnet's 387 states, cut to
    ``SPEC_BOTNET_KNOBS``' budget) against the same run on botnet, and on
    lcld_spec with save_history "full" and "reduced" (``SPEC_HISTORY_*``)
    against LCLD's; each with its launch counts set to 0 just before and
    read just after, held to what the code implies, and equal to its twin
    bit for bit (populations, objectives, histories). Returns the launches
    of the spec runs."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2

    launches = {}
    runs = [("botnet_spec", SPEC_BOTNET_KNOBS, BOTNET_STATES, None)]
    runs += [("lcld_spec", SPEC_HISTORY_KNOBS, SPEC_HISTORY_STATES, mode) for mode in ("full", "reduced")]
    for name, knobs, n_states, history in runs:
        spec_eng, hand_eng, x = twins[name]
        x = x[:n_states]
        results, walls = [], []
        for eng in (spec_eng, hand_eng):
            moeva = Moeva2(eng.classifier, eng.constraints, ml_scaler=eng.ml_scaler, device=device,
                           save_history=history, **knobs)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = moeva.generate(x, minimize_class=1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = kernels.launch_counts()
            check_launches(got, expected_launches(moeva, len(x)), f"{name}'s generate" if eng is spec_eng else
                           f"its twin's generate")
            if eng is spec_eng:
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
            results.append(res)
        a, b = results
        same = np.array_equal(a.x_ml, b.x_ml, equal_nan=True) and np.array_equal(a.f, b.f, equal_nan=True)
        same = same and len(a.history or ()) == len(b.history or ()) and all(
            np.array_equal(p, q, equal_nan=True) for p, q in zip(a.history or (), b.history or ()))
        if not same:
            raise AssertionError(f"{name}'s generate differs from its twin's")
        kept = f", history {history!r}: {len(a.history)} records of {a.history[0].shape[-1]} columns" if history else ""
        log(f"[spec] generate on {name}: {len(x)} states x {knobs['n_gen']} generations{kept}, equal to the "
            f"hand-written twin's bit for bit (x_ml, f{', history' if history else ''}); launches as the code "
            f"implies; wall {walls[0]:.3f} s against the twin's {walls[1]:.3f} s on {smi}")
    return launches


def check_spec_oracle(device, problem, smi: str) -> dict:
    """MoEvA on phishing on the card at the oracle fixture's config (16
    states, pop 40, 20 offspring, budget 100, seeds 42-44): the mean o1..o7
    within the fixture's ``parity_tolerance`` of its ``oracle_ga`` mean.
    Returns the launches of the three runs."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator

    with open(SPEC_ORACLE) as f:
        fixture = json.load(f)
    dom, tol = fixture["domains"]["phishing"], fixture["parity_tolerance"]
    cfg = dom["config"]
    cons, sur, scaler, x = problem
    calc = ObjectiveCalculator(classifier=sur, constraints=cons, thresholds=dict(cfg["thresholds"]),
                               min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=cfg["norm"])
    rates, launches = [], {}
    for seed in cfg["seeds"]:
        eng = Moeva2(sur, cons, ml_scaler=scaler, norm=cfg["norm"], n_gen=cfg["n_gen"], n_pop=cfg["n_pop"],
                     n_offsprings=cfg["n_offsprings"], archive_size=cfg["archive_size"], seed=seed, device=device)
        kernels.reset_launch_counts()
        res = eng.generate(x, minimize_class=1)
        got = kernels.launch_counts()
        check_launches(got, expected_launches(eng, len(x)), f"phishing seed {seed}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rates.append(calc.success_rate_3d(x, res.x_ml))
    mean = np.mean(rates, axis=0)
    want = np.asarray(dom["oracle_ga"]["mean"])
    if not np.all(np.abs(mean - want) <= tol):
        raise AssertionError(f"phishing's mean o1..o7 {mean} on the card is not within {tol} of oracle_ga's {want}")
    log(f"[spec] phishing on the card at the fixture's config ({cfg['n_states']} states, pop {cfg['n_pop']}, "
        f"{cfg['n_offsprings']} offspring, budget {cfg['n_gen']}, seeds {cfg['seeds']}): mean o1..o7 "
        + " ".join(f"{v:.4f}" for v in mean) + " against oracle_ga's " + " ".join(f"{v:.4f}" for v in want)
        + f": within {tol} (largest gap {np.max(np.abs(mean - want)):.4f}) on {smi}")
    return launches


def run_spec(device, smi: str, resources: list, records: list) -> dict:
    """Phase 17: domains compiled from a constraint spec (ROADMAP A11) with
    kernel K9. Returns the launch counts of its main paths' runs, each set to
    0 just before and read just after."""
    import torch

    t0 = time.perf_counter()
    entries = [k for k in resources if k["kernel"].startswith("objective_spec_kernel")]
    if len(entries) != 6:
        raise AssertionError(f"the build's ptxas report has {len(entries)} objective_spec_kernel entries, not 6")
    for k in entries:
        log(f"[spec] ptxas {k['kernel']}: {k['registers']} registers, {k['smem']} bytes static shared memory, "
            f"{k['stack']} bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
        if k["spill_stores"] + k["spill_loads"]:
            raise AssertionError(f"{k['kernel']} spills registers: {k}")
    with tempfile.TemporaryDirectory() as tmp:
        problems = spec_problems(tmp)
        twins = spec_twins(device, problems, tmp)
    for name, problem in problems.items():
        got = check_spec_kernel(device, name, problem)
        log(f"[spec] objective_spec and objective_spec_hist on {name} (D = {got['features']}, {got['terms']} terms, "
            f"{got['instructions']} instructions, {got['slots']} slots) equal evaluate_plain and evaluate_hist_plain "
            f"bit for bit on {got['cases']} launches each ({got['rows']} rows, {got['nonfinite']} with a non-finite "
            f"objective) over S x N in {SPEC_SWEEP} under L2 and L-inf, led by the edge rows (0, -0.0, NaN and ±inf "
            "denominators, members met, ±0 everywhere, features at their bounds); column 2 the kept terms' sum")
    check_spec_twins(device, twins)
    log(f"[spec] objective_spec on lcld_spec equals objective_lcld on lcld, and on botnet_spec objective_botnet on "
        f"botnet, bit for bit (out and history record) over {SPEC_SWEEP} and the timed shapes")
    records += time_spec(device, twins, smi)
    launches = run_spec_runner(smi)
    for k, v in drive_twin_runs(device, twins, smi).items():
        launches[k] += v
    for k, v in check_spec_oracle(device, problems["phishing"], smi).items():
        launches[k] += v
    if not all(launches[k] for k in SPEC_COUNTERS):
        raise AssertionError(f"phase 17 launched no {[k for k in SPEC_COUNTERS if not launches[k]]}")
    log(f"[spec] phase 17 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return {k: launches[k] for k in SPEC_COUNTERS}

# -- phase 18: PGD, AutoPGD and flip+sat on spec domains (kernel K10) -----------------

#: K10's launch counts. No grid file of ``config/`` names a spec domain:
#: phase 13 launches none of them, which phase 18 must launch
SPEC_PGD_COUNTERS = ("pgd_spec", "pgd_spec_auto")
#: K10's sweep, per domain: row counts on the edges of its blocks (ceil(N /
#: 132) rows a block, at most 32, and as many as one block's shared memory
#: holds: 10 rows of botnet_spec's 756 features, 8 for AutoPGD): a lone row;
#: 131 and 133, one row a block and one past it; lcld_spec's 4000 (31 a
#: block) and 4225 (32 a block, the last block holding one); botnet_spec's
#: 387 (3 a block) and 1321 (10 a block, the most that fit, the last holding
#: one); phishing's 16 states; a family's 256. Counts above the problem's
#: states repeat its rows
SPEC_PGD_ROWS = {"lcld_spec": (1, 131, 133, 4000, 4225), "botnet_spec": (1, 133, 387, 1321), "phishing": (1, 16),
                 "family2": (1, 133, 256)}
#: PGD's budgets in the sweep: every configuration at 7 iterations (at one
#: row count each, in turn), the first at 1 iteration on every row count;
#: AutoPGD's: 12 (seven checkpoints, where halving fires). On botnet_spec 4
#: for both (three of AutoPGD's checkpoints): its plain version interprets
#: 2104 instructions a step one torch op at a time, which kept phase 18 at
#: 94 s of the smoke at 7 (PR 23, call 6)
SPEC_PGD_ITERS = (1, 7)
SPEC_SWEEP_ITERS = {"botnet_spec": (4, 4)}
SPEC_AUTOPGD_DEFAULT_ITERS = 12
#: the timed shapes: rq1.lcld's (4000 states x 1000, L2, ε 0.2,
#: ``constraints+flip``) and rq1.botnet's (387 x 1000, ε 4), each beside
#: the hand-written twin's kernel (K7, K7b) on the same inputs in turns, and
#: the plain version at 100 and 10 iterations
SPEC_PGD_TIMED = {"lcld_spec": ("lcld", PGD_STATES, PGD_EPS, 100), "botnet_spec": ("botnet", 387, 4.0, 10)}
SPEC_PGD_LOSS = "constraints+flip"
#: the rows of rq1.lcld's ``constraints+flip`` point on lcld_spec that reach
#: LCLD's month pole at 1000 iterations on the card (ROADMAP C5), where the
#: runner's judgement refuses the result: K7's rows on lcld
#: (``NAN_REFUSALS``), each first non-finite in g8 and g9
SPEC_NAN_REFUSALS = {"lcld_spec": NAN_REFUSALS[("lcld", "constraints+flip")]}
#: the runner point with a ``spec:`` key: rq1.lcld's
#: ``constraints+flip+adaptive_eps_step`` (the spec's repair assigns LCLD's
#: ratio features too, as the JAX package's does, and on rq1's repairing
#: point some leave the scaler's range: the judgement refuses that result in
#: both packages)
SPEC_RUNNER_LOSS = "constraints+flip+adaptive_eps_step"
#: ``flip+sat`` through the runner on lcld_spec, on lcld (the same states)
#: and on phishing: the first states of each, the MILP repair being host work
SPEC_SAT_STATES = 48
#: float32 operations of K10 per row and iteration counted from its source,
#: besides 4 per weight of the stack and PGD_OPS_PER_FEATURE per feature:
#: one per instruction of the reverse program (its float64 pow, log and the
#: pow jacobians counted apart), one per contribution (its sum), 3 per term
#: (its sum, the history) and PGD_BOTNET_OPS_PER_ROW; with repair one per
#: instruction of the repair program
SPEC_PGD_OPS_PER_TERM = 3


def spec_pgd_problems(tmp: str) -> dict:
    """Phase 18's problems, name -> (constraints, surrogate, scaler,
    states): lcld_spec at rq1.lcld's 4000 states, botnet_spec at
    rq1.botnet's 387, phishing at the oracle fixture's config and the seeded
    family2 at 256; and the hand-written twins of the first two on the same
    files, rows, surrogates and scalers, under ``lcld`` and ``botnet``."""
    from moeva2_ijcai22_replication_tpu_torch.problems import (
        phishing_problem, synthetic_botnet_problem, synthetic_botnet_spec_problem, synthetic_family_problem,
        synthetic_lcld_problem, synthetic_lcld_spec_problem,
    )

    with open(SPEC_ORACLE) as f:
        cfg = json.load(f)["domains"]["phishing"]["config"]
    return {
        "lcld_spec": synthetic_lcld_spec_problem(f"{tmp}/lcld", PGD_STATES),
        "botnet_spec": synthetic_botnet_spec_problem(f"{tmp}/botnet", BOTNET_STATES),
        "phishing": phishing_problem(cfg),
        "family2": synthetic_family_problem(f"{tmp}/family2", 2, 256),
        "lcld": synthetic_lcld_problem(f"{tmp}/lcld", PGD_STATES),
        "botnet": synthetic_botnet_problem(f"{tmp}/botnet", BOTNET_STATES),
    }


def check_spec_pgd_kernel(device, name: str, problem) -> dict:
    """K10 and its AutoPGD instantiation against ``pgd_run_plain`` and
    ``autopgd_run_plain`` on the card, bit for bit (x_adv, the class there,
    the history; AutoPGD's final steps), on ``name``'s problem: phase 7's
    ``PGD_CONFIGS`` and phase 14's ``AUTOPGD_CONFIGS`` over the domain's
    ``SPEC_PGD_ROWS``, the starts led by the spec's edge rows
    (``spec_edge_rows``, scaled). Returns counts for the log."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.problems import spec_edge_rows

    cons, sur, scaler, x = problem
    rows = SPEC_PGD_ROWS[name]
    d = x.shape[1]
    xs = scaler.transform(x).astype(np.float32)
    edges = scaler.transform(spec_edge_rows(cons, x)).astype(np.float32)
    starts = np.concatenate([edges, xs])
    n = max(rows)
    xi = torch.as_tensor(np.resize(xs, (n, d)), device=device)
    st = torch.as_tensor(np.resize(starts, (n, d)), device=device)
    y = torch.as_tensor(np.arange(n) % 2, device=device)
    runs, nan_rows = 0, 0
    pgd_t, auto_t = SPEC_SWEEP_ITERS.get(name, (SPEC_PGD_ITERS[-1], SPEC_AUTOPGD_DEFAULT_ITERS))
    cases = [(ConstrainedPGD, knobs, rows[ci % len(rows)], pgd_t) for ci, knobs in enumerate(PGD_CONFIGS)]
    cases += [(ConstrainedPGD, PGD_CONFIGS[0], r, SPEC_PGD_ITERS[0]) for r in rows]
    cases += [(AutoPGD, knobs, rows[ci % len(rows)], auto_t) for ci, knobs in enumerate(AUTOPGD_CONFIGS)]
    for cls, knobs, r, t in cases:
        eps = 0.2 if knobs["norm"] == 2 else 0.1
        atk = cls(sur, cons, scaler, eps=eps, eps_step=0.05, max_iter=t, device=device, **knobs)
        sched = atk.schedule(eps, 0.05, t)
        args = (xi[:r], y[:r], st[:r])
        repair = "repair" in atk.loss_evaluation
        kernels.reset_launch_counts()
        got = atk.one_run(*args, sched, eps)
        counter = "pgd_spec" if cls is ConstrainedPGD else "pgd_spec_auto"
        if kernels.launch_counts()[counter] != 1:
            raise AssertionError(f"{name}: {cls.__name__}'s run launched {kernels.launch_counts()}, not one {counter}")
        if cls is ConstrainedPGD:
            want = pgd_run_plain(atk.tables, cons, sched, *args, eps, atk.clip, atk.norm, repair, atk.targeted,
                                 atk.history_layout())
        else:
            got = (*got, atk.last_eta)
            want = autopgd_run_plain(atk.tables, cons, sched, *args, eps, atk.clip, atk.norm, repair,
                                     atk.targeted, atk.history_layout())
        what = f"{counter} on {name} {atk.loss_evaluation} {atk.constraints_optim} norm={atk.norm} N={r} T={t}"
        for part, g, w in zip(("x_adv", "pred", "hist", "eta"), got, want):
            if (g is None) != (w is None):
                raise AssertionError(f"{what}: {part} is {g} on the card, {w} in the plain version")
            if g is not None:
                hold_equal(g, w, f"{what} {part}")
        runs += 1
        nan_rows += int(torch.isnan(got[0]).any(1).sum())
    return {"runs": runs, "nan_rows": nan_rows, "edge_rows": len(edges), "features": d, "iters": (pgd_t, auto_t),
            "terms": cons.n_constraints, "instructions": int(cons.pgd_program.vjp.code.shape[0]),
            "repair_instructions": int(cons.pgd_program.repair.code.shape[0]),
            "contributions": int(cons.pgd_program.acc_idx.numel())}


def spec_pgd_work(tables, n: int, t: int, repair: bool):
    """K10's own count for ``n`` rows and ``t`` iterations: ``pgd_work``'s
    bytes and stack, the program's instructions, contributions and terms,
    its float64 operations (pow, log and the pow jacobians) apart."""
    from moeva2_ijcai22_replication_tpu_torch.domains.ir import program as P

    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    d = widths[0]
    progs = tables.cons
    ops_ = progs.vjp.code[:, 0].cpu().numpy() & 0xFF
    f64 = int(np.isin(ops_, (P.POW, P.POW_DB, P.POW_DE)).sum()) * 2
    n_instr = int(progs.vjp.code.shape[0]) + (int(progs.repair.code.shape[0]) if repair else 0)
    n_bytes = (4 * 3 * n * d + 16 * n + 4 * (tables.params.numel() + tables.first_t.numel()) + 12 * d
               + 16 * n_instr + 4 * (progs.acc_idx.numel() + progs.acc_ptr.numel() + progs.term_start.numel()))
    per_row = (4 * macs + PGD_OPS_PER_FEATURE * d + n_instr + progs.acc_idx.numel()
               + SPEC_PGD_OPS_PER_TERM * progs.vjp.n_terms + PGD_BOTNET_OPS_PER_ROW)
    return n_bytes, n * t * per_row, n * t * (f64 + 3)


def time_spec_pgd(device, problems: dict, smi: str) -> list:
    """K10 and K10-auto at ``SPEC_PGD_TIMED``'s shapes beside the twin
    domain's kernel (K7 on lcld_spec's shape, K7b on botnet_spec's, each with
    its AutoPGD instantiation beside K10's) on the same rows, labels and ε,
    in turns (CUDA graphs of one launch), through the wrapper, and the plain
    version at the shape's plain budget, which K10 equals there bit for bit.
    The bounds are the twins' (their work on the same shapes: ``pgd_bound``,
    ``pgd_botnet_bound``, ``autopgd_bound``, ``autopgd_botnet_bound``), with
    K10's own count beside them (``spec_pgd_work``). Returns K10's and
    K10-auto's records."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain

    shapes = {"pgd_spec": {}, "pgd_spec_auto": {}}
    for name, (twin, n, eps, plain_t) in SPEC_PGD_TIMED.items():
        cons, sur, scaler, x = problems[name]
        hand = problems[twin][0]
        xs = scaler.transform(x)[:n]
        xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
        y = torch.as_tensor(surrogate_labels(sur, xs), device=device)
        eps = eps - 1e-6
        for cls, rec_name in ((ConstrainedPGD, "pgd_spec"), (AutoPGD, "pgd_spec_auto")):
            auto = cls is AutoPGD
            loss = ("autopgd+" if auto else "") + SPEC_PGD_LOSS

            def engine(c, t):
                return cls(sur, c, scaler, eps=eps, eps_step=0.1, max_iter=t, norm=2, loss_evaluation=loss,  # noqa: B023
                           device=device)

            spec, twin_atk = engine(cons, PGD_BUDGET), engine(hand, PGD_BUDGET)
            twin_kernel = kernels.pgd_lcld if twin == "lcld" else kernels.pgd_botnet

            def fn(atk, kernel, t=PGD_BUDGET):
                sched = atk.schedule(eps, 0.1, t)
                extra = {"auto": sched.auto} if auto else {}  # noqa: B023
                base = sched.pgd if auto else sched  # noqa: B023
                return lambda: kernel(atk.tables, base, xi, y, xi, eps, atk.clip, False, False, False, **extra)  # noqa: B023

            sfn, tfn = fn(spec, kernels.pgd_spec), fn(twin_atk, twin_kernel)
            times = {"spec": [], "twin": []}
            for turn in ("spec", "twin", "twin", "spec"):
                times[turn].append(graph_ms(sfn if turn == "spec" else tfn, launches=1, repeats=2))
            small = engine(cons, plain_t)
            sched = small.schedule(eps, 0.1, plain_t)
            plain = (autopgd_run_plain if auto else pgd_run_plain)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain(small.tables, cons, sched, xi, y, xi, eps, small.clip, 2, False, False)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            got = fn(small, kernels.pgd_spec, plain_t)()
            for part, g, w in zip(("x_adv", "pred", "eta"), got[:2] + got[3:], want[:2] + want[3:]):
                hold_equal(g, w, f"{rec_name} on {name} at its timed shape, {plain_t} iterations, {part}")
            tables = twin_atk.tables
            if auto:
                b_ms, b_by = (autopgd_bound if twin == "lcld" else autopgd_botnet_bound)(tables, n, PGD_BUDGET)
            else:
                b_ms, b_by = (pgd_bound if twin == "lcld" else pgd_botnet_bound)(tables, n, PGD_BUDGET)
            own_ms, own_by = bound_ms(*spec_pgd_work(spec.tables, n, PGD_BUDGET * (2 if auto else 1), False))
            entry = {
                "shape": f"{n}x{PGD_BUDGET}", "ms": statistics.median(times["spec"]),
                "wrapper_ms": cuda_ms(sfn, launches=1, repeats=1), "plain_ms": plain_ms, "plain_iters": plain_t,
                "bound_ms": b_ms, "bound_by": b_by, "spec_work_bound_ms": own_ms, "spec_work_bound_by": own_by,
                "twin": f"{twin_kernel.__name__}{'_auto' if auto else ''}", "twin_ms": statistics.median(times["twin"]),
                "ms_turns": times,
            }
            shapes[rec_name][name] = entry
            log(f"[spec-pgd] {rec_name} on {name} at {n} states x {PGD_BUDGET} iterations ({loss}, L2, ε {eps:.6f}): "
                f"device {entry['ms']:.3f} ms against {entry['twin']}'s {entry['twin_ms']:.3f} ms in turns "
                f"(x{entry['ms'] / entry['twin_ms']:.2f}), through the wrapper {entry['wrapper_ms']:.3f} ms, plain "
                f"{plain_ms:.1f} ms at {plain_t} iterations (K10 equal to it there), bound {b_ms:.4f} ms ({b_by}; "
                f"{entry['twin']}'s count, the same work; K10's own count {own_ms:.4f} ms) on {smi}")
    records = []
    for rec_name, replaces in (("pgd_spec", "moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py:241"),
                               ("pgd_spec_auto", "moeva2_ijcai22_replication_tpu/attacks/pgd/autopgd.py:45")):
        lcld = shapes[rec_name]["lcld_spec"]
        records.append({
            "name": rec_name, "route": "cuda",
            "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/pgd_spec.cu", "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0, "library_ms": None,
            **{k: lcld[k] for k in ("ms", "wrapper_ms", "plain_ms", "plain_iters", "bound_ms", "bound_by",
                                    "twin", "twin_ms", "spec_work_bound_ms", "shape")},
            "botnet_spec_shape": shapes[rec_name]["botnet_spec"],
        })
    return records


def drive_spec_pgd(device, problems: dict, smi: str) -> dict:
    """``ConstrainedPGD.generate`` and ``AutoPGD.generate`` on lcld_spec and
    botnet_spec at rq1's shapes (``SPEC_PGD_TIMED``, 1000 iterations,
    ``SPEC_PGD_LOSS``, labels from the surrogate), each with its launch counts
    set to 0 just before and read just after (one launch of K10 or K10-auto);
    the result's shape, immutables and ε-ball on its finite rows. PGD on
    lcld_spec is rq1.lcld's ``constraints+flip`` point as the runner runs
    it: the rows that reach LCLD's month pole (ROADMAP C5), where the
    runner's judgement refuses the result, must be ``SPEC_NAN_REFUSALS``'
    (K7's on lcld, ``NAN_REFUSALS``). Returns the launches."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD

    launches = {k: 0 for k in SPEC_PGD_COUNTERS}
    for name, (_, n, eps, _) in SPEC_PGD_TIMED.items():
        cons, sur, scaler, x = problems[name]
        xs = scaler.transform(x)[:n]
        y = surrogate_labels(sur, xs)
        mut = np.asarray(cons.get_mutable_mask())
        for cls, counter in ((ConstrainedPGD, "pgd_spec"), (AutoPGD, "pgd_spec_auto")):
            atk = cls(sur, cons, scaler, eps=eps - 1e-6, eps_step=0.1, max_iter=PGD_BUDGET, norm=2,
                      loss_evaluation=("autopgd+" if cls is AutoPGD else "") + SPEC_PGD_LOSS, device=device)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = atk.generate(xs, y)
            wall = time.perf_counter() - t0
            got = kernels.launch_counts()
            check_launches(got, {**{k: 0 for k in got}, counter: 1}, f"{cls.__name__}.generate on {name}")
            launches[counter] += 1
            fin = np.isfinite(out).all(-1)
            nan_rows = tuple(np.flatnonzero(~fin).tolist())
            if cls is ConstrainedPGD and nan_rows != SPEC_NAN_REFUSALS.get(name, ()):
                raise AssertionError(f"generate on {name}: NaN rows {nan_rows}, not {SPEC_NAN_REFUSALS.get(name, ())}")
            d = np.abs(out[fin] - xs[fin].astype(np.float32))
            if out.shape != xs.shape or not np.array_equal(out[fin][:, ~mut], xs[fin][:, ~mut].astype(np.float32)):
                raise AssertionError(f"{cls.__name__}.generate on {name}: shape {out.shape} or immutables moved")
            if (np.sqrt((d.astype(np.float64) ** 2).sum(-1)) > eps + 1e-4).any():
                raise AssertionError(f"{cls.__name__}.generate on {name}: a finite row left the ε-ball")
            log(f"[spec-pgd] {cls.__name__}.generate on {name}: {n} states x {PGD_BUDGET} iterations, one {counter} "
                f"launch, {int(fin.sum())} finite rows within the ε-ball with their immutables kept, NaN rows "
                f"{list(nan_rows)}" + (" (the month pole, C5: the runner's judgement refuses this result, as it does "
                f"K7's on lcld with the same rows {list(NAN_REFUSALS[('lcld', SPEC_PGD_LOSS)])})" if nan_rows else "")
                + f"; wall {wall:.3f} s on {smi}")
    return launches


def spec_runner_config(art: str, project: str, loss: str, n_states: int, **over) -> dict:
    """A ``config/pgd.yaml`` point of rq1.lcld's shape composed as phase 10
    composes it, for ``project`` (a registry name) over phase 10's LCLD
    artifacts in ``art``, on its first ``n_states`` states (-1: all)."""
    cfg = runner_config("lcld", "pgd", art, loss)
    cfg.update(project_name=project, n_initial_state=n_states, dirs={"results": f"{art}/out/{project}/{loss}"})
    cfg.update(over)
    return cfg


def write_phishing_artifacts(problem, out: str) -> dict:
    """The phishing problem's states, surrogate and scaler as runner
    artifacts in ``out``, and a ``config/pgd.yaml`` ``flip+sat`` point over
    them (the package data's schema and constraints)."""
    import shutil

    from moeva2_ijcai22_replication_tpu_torch.domains import spec_domain_dir
    from moeva2_ijcai22_replication_tpu_torch.models.scalers import save_npz
    from moeva2_ijcai22_replication_tpu_torch.problems import PHISHING_SURROGATE

    _, _, scaler, x = problem
    os.makedirs(out, exist_ok=True)
    np.save(f"{out}/x_candidates.npy", x)
    shutil.copy(PHISHING_SURROGATE, f"{out}/nn.msgpack")
    save_npz(scaler, f"{out}/scaler.npz")
    d = spec_domain_dir("phishing")
    cfg = dict(PGD_YAML, project_name="phishing", misclassification_threshold=0.5, norm=2, n_initial_state=-1,
               initial_state_offset=0, system={"n_jobs": -1, "verbose": 1, "mesh_devices": 0}, save_history=False,
               reconstruction=False, seed=42, budget=100, eps=0.2, loss_evaluation="flip+sat")
    cfg["paths"] = {"model": f"{out}/nn.msgpack", "features": f"{d}/features.csv",
                    "constraints": f"{d}/constraints.csv", "x_candidates": f"{out}/x_candidates.npy",
                    "min_max_scaler": f"{out}/scaler.npz", "ml_scaler": f"{out}/scaler.npz"}
    cfg["dirs"] = {"results": f"{out}/out/phishing"}
    return cfg


def run_spec_pgd_runner(problems: dict, smi: str) -> dict:
    """The runners on spec domains: rq1.lcld's ``SPEC_RUNNER_LOSS`` point
    with a ``spec:`` key (4000 states x 1000); ``flip+sat`` on ``lcld_spec``
    and on ``lcld`` at their first
    ``SPEC_SAT_STATES`` states, whose rows feasible only under C3 must be as
    many, and on phishing; each with phase 10's checks. Returns the
    launches."""
    from moeva2_ijcai22_replication_tpu_torch.domains import SPEC_DIR
    from moeva2_ijcai22_replication_tpu_torch.experiments import common

    launches = {k: 0 for k in SPEC_PGD_COUNTERS}

    def drive(cfg, tag):
        metrics = drive_runner(cfg, smi, lambda: point_expected_launches("pgd", cfg), tag)
        launches["pgd_spec"] += point_expected_launches("pgd", cfg).get("pgd_spec", 0)
        return metrics

    with tempfile.TemporaryDirectory() as tmp:
        art = f"{tmp}/lcld"
        write_runner_artifacts("lcld", art)
        cfg = spec_runner_config(art, "lcld", SPEC_RUNNER_LOSS, -1, spec=os.path.join(SPEC_DIR, "lcld.yaml"))
        drive(cfg, f"pgd lcld_spec {SPEC_RUNNER_LOSS} (spec: key)")
        caveats = {}
        for project in ("lcld_spec", "lcld"):
            cfg = spec_runner_config(art, project, "flip+sat", SPEC_SAT_STATES)
            metrics = drive(cfg, f"pgd {project} flip+sat")
            x_rep = np.load(f"{cfg['dirs']['results']}/x_attacks_pgd_flip+sat_{metrics['config_hash']}.npy")[:, 0]
            cons = common.load_constraints(cfg)
            counts = repair_counts(cons, common.load_candidates(cfg), x_rep)
            caveats[project] = counts["caveat"]
            log(f"[spec-pgd] pgd {project} flip+sat: MILP repair {check_repairs(cons, common.load_candidates(cfg), x_rep)}")
        if caveats["lcld_spec"] != caveats["lcld"]:
            raise AssertionError(f"flip+sat: {caveats['lcld_spec']} rows of lcld_spec are feasible only under C3, "
                                 f"{caveats['lcld']} of lcld on the same states")
        cfg = write_phishing_artifacts(problems["phishing"], f"{tmp}/phishing")
        metrics = drive(cfg, "pgd phishing flip+sat")
        x_rep = np.load(f"{cfg['dirs']['results']}/x_attacks_pgd_flip+sat_{metrics['config_hash']}.npy")[:, 0]
        cons = common.load_constraints(cfg)
        log(f"[spec-pgd] pgd phishing flip+sat: MILP repair {check_repairs(cons, common.load_candidates(cfg), x_rep)}")
    return launches


def run_spec_pgd(device, smi: str, resources: list, records: list) -> dict:
    """Phase 18: PGD, AutoPGD and ``flip+sat`` on domains compiled from a
    constraint spec (ROADMAP A11b) with kernel K10. Returns the launch counts
    of its main paths' runs, each set to 0 just before and read just after."""
    import torch

    t0 = time.perf_counter()
    entries = [k for k in resources if k["kernel"].startswith("pgd_spec_kernel")]
    if len(entries) != 2:
        raise AssertionError(f"the build's ptxas report has {len(entries)} pgd_spec_kernel entries, not 2")
    for k in entries:
        log(f"[spec-pgd] K10 ptxas {k['kernel']}: {k['registers']} registers, {k['smem']} bytes static shared "
            f"memory, {k['stack']} bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + "
            "loads")
    with tempfile.TemporaryDirectory() as tmp:
        problems = spec_pgd_problems(tmp)
    for name in SPEC_PGD_ROWS:
        t1 = time.perf_counter()
        got = check_spec_pgd_kernel(device, name, problems[name])
        log(f"[spec-pgd] pgd_spec and pgd_spec_auto on {name} (D = {got['features']}, {got['terms']} terms, "
            f"{got['instructions']} reverse and {got['repair_instructions']} repair instructions, "
            f"{got['contributions']} contributions) equal pgd_run_plain and autopgd_run_plain bit for bit (x_adv, "
            f"class, history, AutoPGD's steps) on {got['runs']} runs: {len(PGD_CONFIGS)} PGD configurations at T = "
            f"{got['iters'][0]}, the first at T = {SPEC_PGD_ITERS[0]} on every N, {len(AUTOPGD_CONFIGS)} AutoPGD "
            f"ones at T = {got['iters'][1]}, N in {SPEC_PGD_ROWS[name]}, the starts led by {got['edge_rows']} edge "
            f"rows; {got['nan_rows']} NaN rows of x_adv ({time.perf_counter() - t1:.1f} s)")
    records += time_spec_pgd(device, problems, smi)
    launches = drive_spec_pgd(device, problems, smi)
    for k, v in run_spec_pgd_runner(problems, smi).items():
        launches[k] += v
    if not all(launches[k] for k in SPEC_PGD_COUNTERS):
        raise AssertionError(f"phase 18 launched no {[k for k in SPEC_PGD_COUNTERS if not launches[k]]}")
    log(f"[spec-pgd] phase 18 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return launches



# -- phase 19: training and the defense pipelines (kernels K11, K12) -----------------

#: the launch counts of training: K11's step and loss-only instantiation, K12.
#: No grid file trains: phase 13 launches none of them, which phase 19 must
DEFENSE_COUNTERS = ("train_step", "train_loss", "input_grad", "forward_proba1")
#: K11's shapes, (batch, widths), as the pipelines train: LCLD's models at
#: D = 47 and 57 (augmented), botnet's at 756 and 927, each surrogate's
#: published widths and ``experiments/defense.py``'s batch sizes
TRAIN_SHAPES = {"lcld": (512, (47, 64, 32, 16, 2)), "lcld_augmented": (512, (57, 64, 32, 16, 2)),
                "botnet": (256, (756, 64, 64, 32, 2)), "botnet_augmented": (256, (927, 64, 64, 32, 2))}
#: steps held bit for bit at each shape: the first half with no class
#: weight, the second with ``TRAIN_CLASS_WEIGHT``; every odd step's batch
#: ends in a weight-0 padded tail of a fifth of its rows
TRAIN_CHECK_STEPS = 20
TRAIN_CLASS_WEIGHT = {0: 1.0, 1: 3.0}
#: the validation sets' rows at which K11's loss-only instantiation is held
#: and timed: 10% of phase 19's training rows
VAL_ROWS = {"lcld": 1000, "lcld_augmented": 1000, "botnet": 400, "botnet_augmented": 400}
#: K12's shapes: the importance's class-balanced subsample, 2 x balanced_n
#: rows (LCLD 5000 a class, botnet 300)
INPUT_GRAD_SHAPES = {"lcld": (10000, (47, 64, 32, 16, 2)), "botnet": (600, (756, 64, 64, 32, 2))}
#: the pipelines' synthetic splits (train, test) at seed 42, standing in for
#: the real ones (**cut**: the rows), and MoEvA's and PGD's budget (**cut**
#: from the configs' 1000); widths, epochs, batches, patience, population
#: and offspring are the configs' and ``PROJECT_DEFAULTS``'
DEFENSE_ROWS = {"lcld": (10000, 2000), "botnet": (4000, 1000)}
DEFENSE_BUDGET = 100
#: epochs of ``fit_mlp`` on the card against the CPU's float32 path from the
#: same initial parameters
CPU_FIT_EPOCHS = 3
LR = 1e-3


def mlp_work(widths) -> tuple:
    """(weights of the stack, weights of the layers after the first)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    return sum(a * b for a, b in pairs), sum(a * b for a, b in pairs[1:])


def train_step_bound(b: int, widths):
    """K11's step: its batch (x, labels, weights) and the class weights read
    once, parameters and both moments read and written once, the loss
    written; 2 operations a weight and row forward, 2 for the weight's
    gradient, 2 for the cotangent of each hidden unit's input, ~12 a
    parameter for Adam; exp, exp and log in float64 per row."""
    from moeva2_ijcai22_replication_tpu_torch.models.train import n_params

    p = n_params(widths)
    m_all, m_back = mlp_work(widths)
    n_bytes = b * widths[0] * 4 + b * 12 + 8 + 6 * p * 4 + 4
    return bound_ms(n_bytes, b * (4 * m_all + 2 * m_back) + 12 * p, 3 * b)


def train_loss_bound(n: int, widths):
    """K11's loss-only launch: its rows and labels, the parameters once, a
    float a tile; 2 operations a weight and row; exp, exp, log per row."""
    from moeva2_ijcai22_replication_tpu_torch.models.train import TILE_ROWS, n_params

    n_bytes = n * widths[0] * 4 + n * 8 + n_params(widths) * 4 + 8 + -(-n // TILE_ROWS) * 4
    return bound_ms(n_bytes, 2 * n * mlp_work(widths)[0], 3 * n)


def input_grad_bound(n: int, widths):
    """K12: its rows read and their gradients written once, the parameters
    once; 2 operations a weight and row forward and 2 backward (down to the
    input); exp twice per row."""
    from moeva2_ijcai22_replication_tpu_torch.models.train import n_params

    n_bytes = 2 * n * widths[0] * 4 + n_params(widths) * 4
    return bound_ms(n_bytes, 4 * n * mlp_work(widths)[0], 2 * n)


def train_inputs(device, widths, b: int, seed: int):
    """Seeded parameters (``reset_parameters_seeded``), scaled-like rows in
    [0, 1], 0/1 labels, for K11's and K12's checks."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.models.mlp import MLP
    from moeva2_ijcai22_replication_tpu_torch.models.train import flat_params

    rng = np.random.default_rng(seed)
    params = flat_params(MLP(widths[0], widths[1:-1]).reset_parameters_seeded(seed)).to(device)
    x = torch.as_tensor(rng.uniform(0, 1, (b, widths[0])), dtype=torch.float32, device=device)
    y = torch.as_tensor(rng.integers(0, 2, b), device=device)
    return params, x, y


def check_training_kernels(device) -> dict:
    """K11 against ``train_step_plain`` on the card, bit for bit (loss,
    parameters, both moments) over ``TRAIN_CHECK_STEPS`` steps at each of
    ``TRAIN_SHAPES`` (padded tails, class weights); its loss-only
    instantiation against ``train_loss_plain`` at ``VAL_ROWS``; K12 against
    ``input_grad_plain`` at ``INPUT_GRAD_SHAPES``. Returns counts for the log."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.models.train import (
        adam_scalars, class_weight_vector, input_grad_plain, train_loss_plain, train_step_plain,
    )

    steps = 0
    for i, (name, (b, widths)) in enumerate(TRAIN_SHAPES.items()):
        params, _, _ = train_inputs(device, widths, b, 11 + i)
        got = [params.clone(), torch.zeros_like(params), torch.zeros_like(params)]
        want = [params.clone(), torch.zeros_like(params), torch.zeros_like(params)]
        for step in range(TRAIN_CHECK_STEPS):
            _, x, y = train_inputs(device, widths, b, 100 * i + step)
            w = torch.ones(b, device=device)
            if step % 2:
                w[b - b // 5:] = 0.0
            weights = None if step < TRAIN_CHECK_STEPS // 2 else TRAIN_CLASS_WEIGHT
            cw = torch.tensor(class_weight_vector(weights), dtype=torch.float32, device=device)
            adam = adam_scalars(step, LR)
            loss = kernels.train_step(widths, *got, x, y, w, cw, adam)
            loss_p = train_step_plain(widths, *want, x, y, w, cw, adam)
            torch.cuda.synchronize()
            what = f"train_step at {name} ({b} x {widths[0]}), step {step}"
            hold_equal(loss, loss_p, f"{what}, loss")
            for part, a, c in zip(("params", "mu", "nu"), got, want):
                hold_equal(a, c, f"{what}, {part}")
            steps += 1
        _, xv, yv = train_inputs(device, widths, VAL_ROWS[name], 7 + i)
        cw = torch.tensor(class_weight_vector(TRAIN_CLASS_WEIGHT), dtype=torch.float32, device=device)
        hold_equal(kernels.train_loss(widths, got[0], xv, yv, cw), train_loss_plain(widths, got[0], xv, yv, cw),
                   f"train_loss at {name} ({VAL_ROWS[name]} x {widths[0]})")
    for name, (n, widths) in INPUT_GRAD_SHAPES.items():
        params, x, _ = train_inputs(device, widths, n, 5)
        hold_equal(kernels.input_grad(widths, params, x), input_grad_plain(widths, params, x),
                   f"input_grad at {name} ({n} x {widths[0]})")
    torch.cuda.synchronize()
    return {"steps": steps, "losses": len(TRAIN_SHAPES), "grads": len(INPUT_GRAD_SHAPES)}


def autograd_adam_ms(device, widths, x, y, w, cw) -> float:
    """One step of the same function by eager autograd and
    ``torch.optim.Adam`` (a note beside K11: no single PyTorch call computes
    a training step)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.models.mlp import MLP

    model = MLP(widths[0], widths[1:-1]).reset_parameters_seeded(3).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=LR)

    def step():
        losses = torch.nn.functional.cross_entropy(model(x), y, reduction="none") * cw[y]
        loss = (losses * w).sum() / torch.clamp(w.sum(), min=1e-12)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()

    return cuda_ms(step)


def time_training(device, smi: str) -> list:
    """K11's step at ``TRAIN_SHAPES`` (device ms: a CUDA graph of 20 steps;
    through the wrapper; the plain step; eager autograd + Adam as a note; the
    bound), its loss-only instantiation at ``VAL_ROWS`` and K12 at
    ``INPUT_GRAD_SHAPES``. Returns their records (LCLD's shapes first, the
    others under ``shapes``)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.models.train import (
        adam_scalars, class_weight_vector, input_grad_plain, train_loss_plain, train_step_plain,
    )

    def plain_ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    cw = torch.tensor(class_weight_vector(None), dtype=torch.float32, device=device)
    adam = adam_scalars(0, LR)
    shapes = {"train_step": {}, "train_loss": {}, "input_grad": {}}
    for i, (name, (b, widths)) in enumerate(TRAIN_SHAPES.items()):
        params, x, y = train_inputs(device, widths, b, 40 + i)
        mu, nu = torch.zeros_like(params), torch.zeros_like(params)
        w = torch.ones(b, device=device)
        step = lambda: kernels.train_step(widths, params, mu, nu, x, y, w, cw, adam)  # noqa: E731
        b_ms, b_by = train_step_bound(b, widths)
        entry = {"shape": f"{b}x{widths[0]}", "ms": graph_ms(step), "wrapper_ms": cuda_ms(step),
                 "plain_ms": plain_ms(lambda: train_step_plain(widths, params.clone(), mu.clone(), nu.clone(), x, y, w,  # noqa: B023
                                                               cw, adam)),
                 "bound_ms": b_ms, "bound_by": b_by, "autograd_adam_ms": autograd_adam_ms(device, widths, x, y, w, cw)}
        shapes["train_step"][name] = entry
        log(f"[defense] train_step (K11) at {name}'s shape ({b} x {widths[0]}, {widths[1:]}): device "
            f"{entry['ms']:.4f} ms a step (CUDA graph of 20 steps), through the wrapper {entry['wrapper_ms']:.4f} ms, "
            f"plain {entry['plain_ms']:.2f} ms, eager autograd + torch.optim.Adam {entry['autograd_adam_ms']:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}) on {smi}")
        n = VAL_ROWS[name]
        _, xv, yv = train_inputs(device, widths, n, 60 + i)
        loss = lambda: kernels.train_loss(widths, params, xv, yv, cw)  # noqa: E731
        b_ms, b_by = train_loss_bound(n, widths)
        entry = {"shape": f"{n}x{widths[0]}", "ms": graph_ms(loss), "wrapper_ms": cuda_ms(loss),
                 "plain_ms": plain_ms(lambda: train_loss_plain(widths, params, xv, yv, cw)),  # noqa: B023
                 "bound_ms": b_ms, "bound_by": b_by}
        shapes["train_loss"][name] = entry
        log(f"[defense] train_loss (K11, loss only) at {name}'s validation set ({n} x {widths[0]}): device "
            f"{entry['ms']:.4f} ms, through the wrapper {entry['wrapper_ms']:.4f} ms, plain {entry['plain_ms']:.2f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}) on {smi}")
    for name, (n, widths) in INPUT_GRAD_SHAPES.items():
        params, x, _ = train_inputs(device, widths, n, 80)
        grad = lambda: kernels.input_grad(widths, params, x)  # noqa: E731
        b_ms, b_by = input_grad_bound(n, widths)
        entry = {"shape": f"{n}x{widths[0]}", "ms": graph_ms(grad), "wrapper_ms": cuda_ms(grad),
                 "plain_ms": plain_ms(lambda: input_grad_plain(widths, params, x)),  # noqa: B023
                 "bound_ms": b_ms, "bound_by": b_by}
        shapes["input_grad"][name] = entry
        log(f"[defense] input_grad (K12) at {name}'s importance subsample ({n} x {widths[0]}): device "
            f"{entry['ms']:.4f} ms, through the wrapper {entry['wrapper_ms']:.4f} ms, plain {entry['plain_ms']:.2f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}) on {smi}")
    records = []
    for rec_name, source, replaces in (
        ("train_step", "train_step.cu", "moeva2_ijcai22_replication_tpu/models/train.py:92"),
        ("train_loss", "train_step.cu", "moeva2_ijcai22_replication_tpu/models/train.py:93"),
        ("input_grad", "input_grad.cu", "moeva2_ijcai22_replication_tpu/experiments/defense.py:175"),
    ):
        main = shapes[rec_name]["lcld"]
        records.append({
            "name": rec_name, "route": "cuda", "source": f"moeva2_ijcai22_replication_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0, "library_ms": None,
            **{k: main[k] for k in ("shape", "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
            **({"autograd_adam_ms": main["autograd_adam_ms"]} if rec_name == "train_step" else {}),
            "shapes": {k: v for k, v in shapes[rec_name].items() if k != "lcld"},
        })
    return records


def write_defense_artifacts(tmp: str) -> dict:
    """Per project, the synthetic schema (``synth_lcld_schema``,
    ``synth_botnet_schema``) and the split of ``DEFENSE_ROWS`` rows at seed
    42 with a learnable label: LCLD's ``tests/test_defense.py`` rule
    (int_rate above its median), botnet's (the highest-variance mutable
    feature above its median). Returns project -> (schema paths, directory)."""
    from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints
    from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
    from moeva2_ijcai22_replication_tpu_torch.domains.synth import (
        synth_botnet, synth_botnet_schema, synth_lcld, synth_lcld_schema,
    )

    out = {}
    for project, (schema_fn, cls, synth) in {"lcld": (synth_lcld_schema, LcldConstraints, synth_lcld),
                                             "botnet": (synth_botnet_schema, BotnetConstraints, synth_botnet)}.items():
        d = f"{tmp}/{project}"
        paths = schema_fn(d)
        cons = cls(paths["features"], paths["constraints"])
        n_train, n_test = DEFENSE_ROWS[project]
        x = synth(n_train + n_test, cons.schema, seed=42)
        if project == "lcld":
            j = 2
        else:
            mut = np.flatnonzero(cons.get_mutable_mask())
            j = mut[np.argmax(x[:, mut].std(0))]
        y = (x[:, j] > np.median(x[:, j])).astype(np.int64)
        for name, arr in (("x_train", x[:n_train]), ("x_test", x[n_train:]), ("y_train", y[:n_train]),
                          ("y_test", y[n_train:])):
            np.save(f"{d}/{name}.npy", arr)
        out[project] = (paths, d)
    return out


def defense_config(project: str, paths: dict, d: str) -> dict:
    """``config/defense.{project}.yaml`` with its paths on phase 19's
    artifacts (the data directory the schema's, as the reference keeps
    ``features.csv`` and ``feat_idx.pickle`` beside the augmented CSVs) and
    the budget cut to ``DEFENSE_BUDGET``."""
    import os

    from moeva2_ijcai22_replication_tpu_torch.utils.config import load_config_file

    cfg = load_config_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config",
                                        f"defense.{project}.yaml"))
    suffix = "" if project == "lcld" else "_19"
    cfg["paths"] = {
        "features": paths["features"], "constraints": paths["constraints"],
        "features_augmented": f"{d}/features_augmented{suffix}.csv",
        "constraints_augmented": f"{d}/constraints_augmented{suffix}.csv",
        **{k: f"{d}/{k}.npy" for k in ("x_train", "x_test", "y_train", "y_test")},
    }
    cfg["dirs"] = {"data": d, "models": f"{d}/models"}
    cfg["budget"] = DEFENSE_BUDGET
    return cfg


class DefenseStages:
    """Patches, while open, the stages ``experiments.defense`` and
    ``experiments.rq4`` call (``fit_mlp``, ``importance_gradient_x_input``,
    ``moeva_attack``, ``ConstrainedPGD.generate``) with wrappers that
    synchronise the card and record each call's wall time, and each fit's
    rows, epochs run and best epoch."""

    def __init__(self):
        self.walls = {"train": 0.0, "importance": 0.0, "moeva": 0.0, "pgd": 0.0}
        self.fits = []

    def _timed(self, stage: str, fn):
        import torch

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            self.walls[stage] += wall
            if stage == "train":
                best = int(np.argmin([h[2] for h in out.history]))
                self.fits.append({"rows": len(args[1]), "features": args[1].shape[1], "epochs": len(out.history),
                                  "best_epoch": best, "wall_s": wall})
            return out

        return wrapped

    def __enter__(self):
        from moeva2_ijcai22_replication_tpu_torch.experiments import defense, rq4

        self.saved = [(defense, k, getattr(defense, k)) for k in
                      ("fit_mlp", "importance_gradient_x_input", "moeva_attack", "ConstrainedPGD")]
        self.saved.append((rq4, "moeva_attack", rq4.moeva_attack))
        defense.fit_mlp = self._timed("train", defense.fit_mlp)
        defense.importance_gradient_x_input = self._timed("importance", defense.importance_gradient_x_input)
        defense.moeva_attack = rq4.moeva_attack = self._timed("moeva", self.saved[2][2])
        stages = self

        class TimedPGD(self.saved[3][2]):
            def generate(self, *args, **kwargs):
                return stages._timed("pgd", super().generate)(*args, **kwargs)

        defense.ConstrainedPGD = TimedPGD
        return self

    def __exit__(self, *exc):
        for module, name, value in self.saved:
            setattr(module, name, value)


def model_aurocs(device, artifacts: dict, cfg: dict, rq4_art: dict | None = None) -> dict:
    """Each model's AUROC on the test split (synthetic labels: these check
    the plumbing), the augmented ones on the augmented rows."""
    from moeva2_ijcai22_replication_tpu_torch.experiments.defense import proba1
    from moeva2_ijcai22_replication_tpu_torch.models.io import load_classifier
    from moeva2_ijcai22_replication_tpu_torch.models.scalers import load_npz
    from moeva2_ijcai22_replication_tpu_torch.models.train import auroc

    x_test, y_test = np.load(cfg["paths"]["x_test"]), np.load(cfg["paths"]["y_test"])
    x_aug = np.load(f"{cfg['dirs']['data']}/x_test_augmented.npy")
    scaler, scaler_aug = load_npz(artifacts["scaler"]), load_npz(artifacts["scaler_augmented"])
    models = {k: artifacts[k] for k in ("nn", "nn_augmented", "nn_moeva", "nn_gradient") if artifacts.get(k)}
    models.update({k: v for k, v in (rq4_art or {}).items() if k.startswith("nn_")})
    out = {}
    for key, path in models.items():
        aug = "augmented" in key
        out[key] = auroc(proba1(load_classifier(path), scaler_aug if aug else scaler, x_aug if aug else x_test,
                                device), y_test)
    return out


def check_fit_card_vs_cpu(device, cfg: dict, smi: str) -> None:
    """``fit_mlp`` on the card and on the CPU (float32: the kernels'
    arithmetic, by the plain versions) from the same initial parameters over
    ``CPU_FIT_EPOCHS`` epochs of LCLD's training split, scaled by the
    pipeline's scaler: the histories and the count of parameters that
    differ."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.models.io import params_to_numpy
    from moeva2_ijcai22_replication_tpu_torch.models.mlp import lcld_mlp
    from moeva2_ijcai22_replication_tpu_torch.models.scalers import load_npz
    from moeva2_ijcai22_replication_tpu_torch.models.train import fit_mlp, flat_params, train_test_split

    scaler = load_npz(f"{cfg['dirs']['models']}/scaler.npz")
    x, y = scaler.transform(np.load(cfg["paths"]["x_train"])), np.load(cfg["paths"]["y_train"])
    x_tr, x_val, y_tr, y_val = train_test_split(x, y, test_size=0.1, random_state=42)
    init = params_to_numpy(lcld_mlp(47, seed=5))
    fits = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        fits[str(dev)] = fit_mlp(lcld_mlp(47), x_tr, y_tr, x_val, y_val, epochs=CPU_FIT_EPOCHS, batch_size=512,
                                 init_params=init, device=dev, dtype=torch.float32)
        fits[f"{dev}_s"] = time.perf_counter() - t0
    card, cpu = fits[str(device)], fits["cpu"]
    a, b = flat_params(card.surrogate.model), flat_params(cpu.surrogate.model)
    differ = int((a != b).sum())
    log(f"[defense] fit_mlp on the card against the CPU (float32, the plain versions) from the same initial "
        f"parameters, {CPU_FIT_EPOCHS} epochs of {len(y_tr)} LCLD rows in batches of 512: {differ} of {a.numel()} "
        f"parameters differ (largest |difference| {float((a - b).abs().max()):.3g}); train losses card "
        f"{[h[1] for h in card.history]} CPU {[h[1] for h in cpu.history]}; val losses card "
        f"{[h[2] for h in card.history]} CPU {[h[2] for h in cpu.history]}; walls {fits[f'{device}_s']:.2f} s and "
        f"{fits['cpu_s']:.2f} s on {smi}")
    if len(card.history) != len(cpu.history):
        raise AssertionError("fit_mlp ran other epochs on the card than on the CPU")
    if not np.allclose(np.array(card.history), np.array(cpu.history), rtol=1e-5):
        raise AssertionError(f"fit_mlp's history on the card differs from the CPU's beyond 1e-5: {card.history} "
                             f"against {cpu.history}")


def drive_defense(device, smi: str, tmp: str) -> dict:
    """Both defense pipelines (``experiments.defense.run``) and RQ4 on
    LCLD's artifacts (``experiments.rq4.run``) on the card, each with its
    launch counts set to 0 just before and read just after: K11 (step and
    loss only) and K12 launched by each defense run, K11 by RQ4, and the
    attacks' kernels (MoEvA's, K7 on LCLD, K7b on botnet, K1's ``kPairs``
    instantiation in RQ4). Every artifact of the family exists. Returns the
    summed launch counts."""
    import os

    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.experiments import common, defense, rq4

    art = write_defense_artifacts(tmp)
    total = {}
    t_all = time.perf_counter()
    runs = [("lcld", defense), ("botnet", defense), ("lcld", rq4)]
    expect = {("lcld", defense): ("train_step", "train_loss", "input_grad", "objective_lcld", "pgd_lcld",
                                  "forward_proba1"),
              ("botnet", defense): ("train_step", "train_loss", "input_grad", "objective_botnet", "pgd_botnet",
                                    "forward_proba1"),
              ("lcld", rq4): ("train_step", "train_loss", "objective_lcld_aug", "forward_proba1")}
    artifacts = {}
    for project, runner in runs:
        paths, d = art[project]
        cfg = defense_config(project, paths, d)
        common.ARTIFACTS.clear()
        kind = runner.__name__.rsplit(".", 1)[1]
        with DefenseStages() as stages:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = quiet(runner.run, cfg, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
        artifacts[(project, kind)] = out
        missing = [k for k, v in out.items() if v is not None and not os.path.exists(v)]
        if missing:
            raise AssertionError(f"{kind} on {project} did not write {missing}")
        idle = [k for k in expect[(project, runner)] if not launches[k]]
        if idle and device.type == "cuda":
            raise AssertionError(f"{kind} on {project} launched no {idle}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        aurocs = model_aurocs(device, artifacts[(project, "defense")], cfg, out if kind == "rq4" else None)
        cand = {k: np.load(v).shape for k, v in out.items() if k.startswith("x_candidates")}
        log(f"[defense] {kind}.run on {project} ({DEFENSE_ROWS[project][0]} training and {DEFENSE_ROWS[project][1]} "
            f"test rows, budget {cfg['budget']}, n_pop {cfg['n_pop']}, {cfg['n_offsprings']} offspring): wall "
            f"{wall:.2f} s; stages: training {stages.walls['train']:.2f} s, importance "
            f"{stages.walls['importance']:.3f} s, MoEvA {stages.walls['moeva']:.2f} s, PGD {stages.walls['pgd']:.3f} s, "
            f"the rest (judgement, scaling, I/O) {wall - sum(stages.walls.values()):.2f} s; launches "
            f"{ {k: v for k, v in launches.items() if v} } on {smi}")
        for fit in stages.fits:
            log(f"[defense]   fit_mlp: {fit['rows']} rows x {fit['features']}, {fit['epochs']} epochs run (best "
                f"{fit['best_epoch']}), {fit['wall_s']:.2f} s")
        log(f"[defense]   AUROC (synthetic labels): "
            f"{ {k: round(v, 4) for k, v in aurocs.items() if kind == 'defense' or k in out} }; candidate sets {cand}")
        log(f"[defense]   artifacts: {sorted(os.listdir(d))} and models/{sorted(os.listdir(f'{d}/models'))}")
    log(f"[defense] the three pipeline runs took {time.perf_counter() - t_all:.1f} s")
    check_fit_card_vs_cpu(device, defense_config("lcld", *art["lcld"]), smi)
    return total


def run_defense(device, smi: str, resources: list, records: list) -> dict:
    """Phase 19: training and the defense pipelines (ROADMAP A12b) with
    kernels K11 and K12. Returns the launch counts of K11 and K12
    (``DEFENSE_COUNTERS``) over its main paths' runs, each set to 0 just
    before and read just after."""
    import torch

    t0 = time.perf_counter()
    for k in resources:
        if k["kernel"].startswith(("train_grad_kernel", "adam_kernel", "input_grad_kernel")):
            log(f"[defense] ptxas {k['kernel']}: {k['registers']} registers, {k['smem']} bytes static shared memory, "
                f"{k['stack']} bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    t1 = time.perf_counter()
    got = check_training_kernels(device)
    log(f"[defense] train_step (K11) equals train_step_plain bit for bit (loss, parameters, mu, nu) over "
        f"{got['steps']} steps at {len(TRAIN_SHAPES)} shapes {[f'{b} x {w[0]}' for b, w in TRAIN_SHAPES.values()]} "
        f"(padded tails, class weights {TRAIN_CLASS_WEIGHT} on the later half); train_loss equals train_loss_plain at "
        f"{list(VAL_ROWS.values())} rows; input_grad (K12) equals input_grad_plain at "
        f"{[f'{n} x {w[0]}' for n, w in INPUT_GRAD_SHAPES.values()]} ({time.perf_counter() - t1:.1f} s)")
    records += time_training(device, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches = drive_defense(device, smi, tmp)
    if not all(launches.get(k) for k in DEFENSE_COUNTERS):
        raise AssertionError(f"phase 19 launched no {[k for k in DEFENSE_COUNTERS if not launches.get(k)]}")
    log(f"[defense] phase 19 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    # the attacks' kernels keep their own main paths' counts
    return {k: launches[k] for k in DEFENSE_COUNTERS}


# -- phase 20: the draws (K0) and a chunk's prepare and decode (K13) -----------

DRAW_COUNTERS = ("draws", "pgd_start", "chunk_prepare", "chunk_decode")
#: the generations K0 is held at: the main path's engine (1000 states),
#: botnet's chunks (256 and 131 x 756 genes) and edge counts (1, 31, 33
#: states with 99 offspring: partial last blocks of every field)
DRAW_STATES = {"lcld": (1000, 1, 31, 33), "botnet": (256, 131)}
#: PGD's random starts: (rows, features) of rq1.lcld and rq1.botnet
PGD_START_SHAPES = ((4000, 47), (387, 756))
#: one field of each kind at element counts 1, 31, 33 and 4k + 1, 4k + 2,
#: 4k + 3, from a base past 2**32 (the counter's high word)
DRAW_EDGE_COUNTS = (1, 31, 33, 4001, 4002, 4003)
DRAW_EDGE_BASE = 2**32 - 3
#: operations a Philox block costs (ten rounds of two 32-bit multiplies and
#: their high halves, two XORs, the key bumps) and a field element's map
PHILOX_OPS_PER_BLOCK = 100
MAP_OPS = {"uniform": 2, "symmetric": 4, "integer": 2, "cut": 1, "gumbel": 6, "normal": 10}
#: float64 operations of an element's map: two logs a gumbel; a log, a
#: sqrt, a cos or sin and the products a normal
MAP_OPS_F64 = {"gumbel": 2, "normal": 4}
#: set by ``profile_generation`` and ``run_main_path``: phase 6's traced
#: launches and busy share per LCLD generation, phase 4's generate walls
PROFILE_SUMMARY: dict = {}


def parent_generation_draws(gen, s: int, p: int, n_off: int, l: int, r: int, m: int):
    """The parent's eager draws of one generation: ``torch.randint``,
    ``torch.rand`` and the gumbels' ``rand``, ``clamp``, ``log``, ``neg``,
    ``log``, ``neg`` on a ``torch.Generator``, 17 launches. Timed as K0's
    yardstick only: the port does not call it."""
    import torch

    dev, n_mat = gen.device, (n_off + 1) // 2
    tiny = torch.finfo(torch.float32).tiny
    out = [torch.randint(0, 1 << 30, (2, 3, s, n_mat), generator=gen, device=dev),
           torch.randint(0, p, (s, n_mat, 2), generator=gen, device=dev),
           torch.rand((3, s, n_mat), generator=gen, device=dev),
           torch.rand((s, n_off, l), generator=gen, device=dev),
           torch.rand((s, n_off, l), generator=gen, device=dev)]
    for k in (r, m):
        u = torch.rand((s, k), generator=gen, device=dev)
        out.append(-torch.log(-torch.log(torch.clamp(u, min=tiny))))
    return out


def draw_fields_bound(fields) -> tuple:
    """``(bytes, int ops, float64 ops)`` of one K0 call: each element
    written once, each block's Philox and each element's map."""
    from moeva2_ijcai22_replication_tpu_torch.core import philox

    n_bytes = sum(f.numel * (8 if f.kind in (philox.INTEGER, philox.CUT) else 4) for f in fields)
    _, blocks = philox.layout(fields, __import__("torch").float32)
    ops = PHILOX_OPS_PER_BLOCK * blocks + sum(f.numel * MAP_OPS[philox.KIND_NAMES[f.kind]] for f in fields)
    ops64 = sum(f.numel * MAP_OPS_F64.get(philox.KIND_NAMES[f.kind], 0) for f in fields)
    return n_bytes, ops, ops64


def generation_fields(eng, s: int) -> list:
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import offspring_fields
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import gumbel_fields

    return (offspring_fields(s, eng.pop_size, eng.n_offsprings, eng.codec.gen_length)
            + gumbel_fields(s, eng.n_dirs, eng.pop_size + eng.n_offsprings))


def init_fields(eng, s: int, norm) -> list:
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.initialisation import ball_draw_shape, n_perturbed
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import gumbel_fields
    from moeva2_ijcai22_replication_tpu_torch.core.philox import NORMAL, SYMMETRIC, Field

    shape = ball_draw_shape(norm, (s, n_perturbed(eng.pop_size, eng.init_ratio), eng.codec.gen_length))
    return [Field("ball", NORMAL if norm == 2 else SYMMETRIC, shape)] + gumbel_fields(s, eng.n_dirs, eng.pop_size)


def edge_fields() -> list:
    from moeva2_ijcai22_replication_tpu_torch.core.philox import KIND_NAMES, Field

    return [Field(f"{KIND_NAMES[k]}_{n}", k, (n,), 103) for k in range(len(KIND_NAMES)) for n in DRAW_EDGE_COUNTS]


def check_draws(device, engines: dict) -> dict:
    """K0 against ``draw_plain`` on the card, bit for bit, and against the
    CPU twin: every generation of ``DRAW_STATES``, lp_ratio's initial
    rounds (both balls) at 1000 states, ``edge_fields`` in calls of at most
    8 fields from ``DRAW_EDGE_BASE``, and PGD's starts at
    ``PGD_START_SHAPES`` under both norms (``pgd_start`` against
    ``pgd_start_plain``). Integer and uniform fields must equal the CPU's;
    the gumbel and normal elements that differ (CUDA's float64 log, sin and
    cos against the CPU's) are counted. Returns the counts."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_start_plain, start_fields
    from moeva2_ijcai22_replication_tpu_torch.core.philox import GUMBEL, NORMAL, draw_plain

    calls = []  # (what, fields)
    for name, states in DRAW_STATES.items():
        for s in states:
            eng = engines[name] if s not in (1, 31, 33) else engines["odd"]
            calls.append((f"{name} generation S={s}", generation_fields(eng, s)))
    for norm in (2, "inf"):
        calls.append((f"lcld lp_ratio init ({norm}) S=1000", init_fields(engines["lcld"], 1000, norm)))
    edges = edge_fields()
    for i in range(0, len(edges), 8):
        calls.append((f"edge fields {i // 8}", edges[i:i + 8]))
    transcendental = {"gumbel": [0, 0], "normal": [0, 0]}  # [differing, total]
    n_fields = 0
    for k, (what, fields) in enumerate(calls):
        key, base = 1000 + k, DRAW_EDGE_BASE if what.startswith("edge") else 7 * k
        got = kernels.draws(fields, torch.float32, key, base, device)
        want = draw_plain(fields, torch.float32, key, base, device)
        cpu = draw_plain(fields, torch.float32, key, base, "cpu")
        for f in fields:
            hold_equal(got[f.name], want[f.name], f"draws {what} field {f.name}")
            g = got[f.name].cpu()
            if f.kind in (GUMBEL, NORMAL):
                tally = transcendental["gumbel" if f.kind == GUMBEL else "normal"]
                tally[0] += int((~same_entries(g, cpu[f.name])).sum())
                tally[1] += g.numel()
            elif not bool(same_entries(g, cpu[f.name]).all()):
                raise AssertionError(f"draws {what} field {f.name}: the card's values differ from the CPU twin's")
            n_fields += 1
    cons, sur, scaler, x = pgd_problem()
    bcons, bsur, bscaler, _, bxs, _ = pgd_botnet_problem()
    problems = {47: (cons, sur, scaler, scaler.transform(x)), 756: (bcons, bsur, bscaler, bxs)}
    starts = 0
    for n, d in PGD_START_SHAPES:
        c, sr, sc, scaled = problems[d]
        rows = scaled[np.arange(n) % len(scaled)]
        for norm in (2, "inf"):
            atk = ConstrainedPGD(sr, c, sc, eps=0.2, norm=norm, device=device)
            xs = torch.as_tensor(rows, dtype=torch.float32, device=device)
            fields = start_fields(norm, n, d)
            base = 11 * n
            args = (fields, 77, base, xs, atk.tables.mutable, 0.2, atk.clip, norm == "inf")
            got = kernels.pgd_start(*args)
            hold_equal(got, pgd_start_plain(*args), f"pgd_start {n} x {d} ({norm})")
            cpu = pgd_start_plain(fields, 77, base, xs.cpu(), atk.tables.mutable.cpu(), 0.2, atk.clip, norm == "inf")
            differ = int((~same_entries(got.cpu(), cpu)).sum())
            transcendental.setdefault(f"pgd start {n} x {d} ({norm})", [differ, cpu.numel()])
            if norm == "inf" and differ:
                raise AssertionError(f"pgd_start {n} x {d} (inf) differs from the CPU twin in {differ} entries")
            starts += 1
    log(f"[draws] draws (K0) equals draw_plain bit for bit on the card: {len(calls)} calls, {n_fields} fields "
        f"(generations at {DRAW_STATES}, lp_ratio's initial rounds under both norms, every kind at "
        f"{DRAW_EDGE_COUNTS} elements from block {DRAW_EDGE_BASE}); pgd_start equals pgd_start_plain on {starts} "
        f"starts at {PGD_START_SHAPES} under both norms")
    log("[draws] K0 on the card against the CPU twin: integer, cut, uniform and symmetric fields equal; "
        "transcendental elements that differ (CUDA's float64 log, sin, cos against the CPU's, after rounding "
        "to float32): " + ", ".join(f"{k} {v[0]} of {v[1]}" for k, v in transcendental.items()))
    return transcendental


def check_chunk_io(device, engines: dict) -> None:
    """K13a and K13b against their plain versions on the card, bit for bit:
    the main path's chunk (1000 LCLD states; tile, and lp_ratio under both
    norms with K0's balls), botnet's 256 and 131, a repack's prepare
    without the population, and the decode with and without an archive."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.chunk_io import chunk_decode_plain, chunk_prepare_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import PhiloxDraws

    cases = 0
    for name, states in (("lcld", (1000, 1, 33)), ("botnet", (256, 131))):
        base = engines[name]
        for init, norm in (("tile", 2), ("lp_ratio", 2), ("lp_ratio", "inf")):
            eng = Moeva2(base.classifier, base.constraints, ml_scaler=base.ml_scaler, device=device,
                         n_pop=base.n_pop, n_offsprings=base.n_offsprings, archive_size=base.archive_size,
                         init=init, norm=norm, init_eps=0.3)
            for s in states:
                xs = engines[f"{name}_x"][np.arange(s) % len(engines[f"{name}_x"])]
                draws = PhiloxDraws(eng, s)
                spec = eng.init_spec(draws.init(s).ball)
                run, got = eng._prepare(xs, np.ones(s, dtype=np.int64), spec)
                want = chunk_prepare_plain(eng._chunk, run.x_init_ml, run.xl_ml, run.xu_ml, spec)
                for k, a, b in zip(("xl_gen", "xu_gen", "x_mm", "pop_x", "ideal", "worst", "extreme"),
                                   (got.xl_gen, got.xu_gen, got.x_mm, got.pop_x, *got.norm_state),
                                   (want.xl_gen, want.xu_gen, want.x_mm, want.pop_x, *want.norm_state)):
                    hold_equal(a, b, f"chunk_prepare {name} {init} ({norm}) S={s} {k}")
                bare = kernels.chunk_prepare(eng._chunk, run.x_init_ml, run.xl_ml, run.xu_ml)
                if bare.pop_x is not None or not torch.equal(bare.x_mm, got.x_mm):
                    raise AssertionError("a repack's chunk_prepare differs from the chunk's")
                carry = eng.init_carry(run, *draws.init(s)[1:], start=got)
                for arch in (True, False):
                    ax, af = (carry.arch_x, carry.arch_f) if arch else (carry.arch_x[:, :0], carry.arch_f[:, :0])
                    args = (eng._chunk, carry.pop_x, ax, carry.pop_f, af, run.x_init_ml)
                    for k, a, b in zip(("x_gen", "f", "x_ml"), kernels.chunk_decode(*args), chunk_decode_plain(*args)):
                        hold_equal(a, b, f"chunk_decode {name} S={s} archive {arch} {k}")
                cases += 1
    log(f"[draws] chunk_prepare (K13a) and chunk_decode (K13b) equal their plain versions bit for bit on {cases} "
        "chunks (LCLD at 1000, 1 and 33 states, botnet at 256 and 131; tile and lp_ratio under both norms; the "
        "repack's prepare; the decode with and without the archive)")


def time_draws(device, engines: dict, smi: str) -> list:
    """K0's, K0-PGD's, K13a's and K13b's records at the main path's shapes:
    device ms (a CUDA graph of 20 launches), wrapper ms, plain ms on the
    card, bound; K0's library figure the parent's 17 eager launches of one
    generation (``parent_generation_draws``), summed."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.chunk_io import chunk_decode_plain, chunk_prepare_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import PhiloxDraws
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_start_plain, start_fields
    from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream, draw_plain

    eng = engines["lcld"]
    s = N_STATES
    fields = generation_fields(eng, s)
    gen = torch.Generator(device=device).manual_seed(0)
    l, p, n_off = eng.codec.gen_length, eng.pop_size, eng.n_offsprings
    parent = lambda: parent_generation_draws(gen, s, p, n_off, l, eng.n_dirs, p + n_off)  # noqa: E731
    stream = PhiloxStream(0, device)
    records = []
    # K0 at one generation of the main path
    n_bytes, ops, ops64 = draw_fields_bound(fields)
    b_ms, b_by = bound_ms(n_bytes, ops, ops64)
    rec = {"name": "draws", "route": "cuda", "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/draws.cu",
           "replaces": "moeva2_ijcai22_replication_tpu/attacks/moeva/operators.py:105", "launches": 0,
           "max_abs_err": 0.0, "ms": graph_ms(lambda: kernels.draws(fields, torch.float32, 5, 0, device)),
           "wrapper_ms": cuda_ms(lambda: eng.draw_generation(stream, s)),
           "plain_ms": cuda_ms(lambda: draw_plain(fields, torch.float32, 5, 0, device)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(parent)}
    log(f"[draws] draws (K0), one generation at {s} states (P={p}, N={n_off}, L={l}, R={eng.n_dirs}): device "
        f"{rec['ms']:.4f} ms, through the wrapper {rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes} bytes, {ops} integer and float32 operations, {ops64} float64), the "
        f"parent's 17 eager launches (torch.Generator) {rec['library_ms']:.4f} ms on {smi}")
    records.append(rec)
    # K0's PGD instantiation at rq1.lcld's 4000 x 47, L2
    cons, sur, scaler, x = pgd_problem()
    atk = ConstrainedPGD(sur, cons, scaler, eps=0.2, norm=2, device=device)
    xs = torch.as_tensor(scaler.transform(x), dtype=torch.float32, device=device)
    n, d = xs.shape
    sf = start_fields(2, n, d)
    args = (sf, 3, 0, xs, atk.tables.mutable, 0.2, atk.clip, False)
    sb, sops, sops64 = draw_fields_bound(sf)
    b_ms, b_by = bound_ms(sb + 4 * n * d + d, sops + 6 * n * d, sops64 + 2 * n)
    rec = {"name": "pgd_start", "route": "cuda", "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/draws.cu",
           "replaces": "moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py:275", "launches": 0,
           "max_abs_err": 0.0, "ms": graph_ms(lambda: kernels.pgd_start(*args)),
           "wrapper_ms": cuda_ms(lambda: atk.random_start(stream, xs, 0.2)),
           "plain_ms": cuda_ms(lambda: pgd_start_plain(*args)), "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    log(f"[draws] pgd_start (K0) at {n} x {d} under L2: device {rec['ms']:.4f} ms, through the wrapper "
        f"{rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}) on {smi}")
    records.append(rec)
    # K13a and K13b at the main path's chunk
    xs_np = engines["lcld_x"]
    run, prep = eng._prepare(xs_np, np.ones(len(xs_np), dtype=np.int64), eng.init_spec())
    dd = run.x_init_ml.shape[1]
    spec = eng.init_spec()
    pargs = (eng._chunk, run.x_init_ml, run.xl_ml, run.xu_ml, spec)
    pb = 4 * (3 * s * dd + 2 * s * l + s * dd + s * p * l + 15 * s)
    b_ms, b_by = bound_ms(pb, 4 * s * dd + 2 * s * l, 0)
    rec = {"name": "chunk_prepare", "route": "cuda",
           "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/chunk_io.cu",
           "replaces": "moeva2_ijcai22_replication_tpu/attacks/moeva/engine.py:503", "launches": 0,
           "max_abs_err": 0.0, "ms": graph_ms(lambda: kernels.chunk_prepare(*pargs)),
           "wrapper_ms": cuda_ms(lambda: kernels.chunk_prepare(*pargs)),
           "plain_ms": cuda_ms(lambda: chunk_prepare_plain(*pargs)), "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    log(f"[draws] chunk_prepare (K13a) at {s} states x {dd} features, population {p} x {l} (tile): device "
        f"{rec['ms']:.4f} ms, through the wrapper {rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}, {pb} bytes) on {smi}")
    records.append(rec)
    init = PhiloxDraws(eng, 1).init(s)
    carry = eng.init_carry(run, init.gum_cut, init.gum_mem, start=prep)
    for _ in range(2):
        carry = eng.gen_step(run, carry, eng.draw_generation(stream, s))
    dargs = (eng._chunk, carry.pop_x, carry.arch_x, carry.pop_f, carry.arch_f, run.x_init_ml)
    cols = p + eng.archive_size
    db = 4 * (2 * s * cols * (l + 3) + s * dd + s * cols * dd)
    b_ms, b_by = bound_ms(db, s * cols * dd, 0)
    rec = {"name": "chunk_decode", "route": "cuda",
           "source": "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/chunk_io.cu",
           "replaces": "moeva2_ijcai22_replication_tpu/core/codec.py:160", "launches": 0,
           "max_abs_err": 0.0, "ms": graph_ms(lambda: kernels.chunk_decode(*dargs)),
           "wrapper_ms": cuda_ms(lambda: kernels.chunk_decode(*dargs)),
           "plain_ms": cuda_ms(lambda: chunk_decode_plain(*dargs)), "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    log(f"[draws] chunk_decode (K13b) at {s} states x {cols} columns (population {p}, archive "
        f"{eng.archive_size}) x {dd} features: device {rec['ms']:.4f} ms, through the wrapper "
        f"{rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {db} bytes) "
        f"on {smi}")
    records.append(rec)
    return records


def drive_pgd_starts(device, smi: str) -> int:
    """``ConstrainedPGD.generate`` with 2 random starts at rq1.lcld's 4000
    states (``PGD_LOSS``, 100 iterations) cold and steady, its launch counts
    set to 0 just before and read just after: 2 of ``pgd_start`` and 2 of
    ``pgd_lcld``, and nothing else; two runs equal. Returns the starts'
    launches."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD

    cons, sur, scaler, x = pgd_problem()
    xs = scaler.transform(x)
    y = surrogate_labels(sur, xs)
    atk = ConstrainedPGD(sur, cons, scaler, eps=PGD_EPS, eps_step=0.1, max_iter=100, norm=2,
                         loss_evaluation=PGD_LOSS, num_random_init=2, seed=42, device=device)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = atk.generate(xs, y)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    again = atk.generate(xs, y)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    check_launches(launches, {**{k: 0 for k in launches}, "pgd_start": 2, "pgd_lcld": 2, "restart": 2},
                   "PGD with 2 random starts")
    if not same_entries_np(first, again).all():
        raise AssertionError("two runs of PGD with random starts differ")
    log(f"[draws] ConstrainedPGD.generate with 2 random starts at {len(xs)} states x 100 iterations: launches "
        f"{ {k: v for k, v in launches.items() if v} }, cold {cold:.3f} s, steady {steady:.3f} s, two runs equal, "
        f"success after each start {atk.quality_history['restart_flip_frac']} on {smi}")
    return launches["pgd_start"]


def run_draws(device, smi: str, resources: list, records: list, moeva, x) -> dict:
    """Phase 20: every random draw in kernel K0 and a chunk's prepare and
    decode in kernel K13 (ROADMAP B3). Returns ``pgd_start``'s launches on
    its path; K0's and K13's own come from phase 4's main path."""
    import torch

    t0 = time.perf_counter()
    for k in resources:
        if k["kernel"].startswith(("draws_kernel", "pgd_start_kernel", "prepare_kernel", "decode_kernel")):
            log(f"[draws] ptxas {k['kernel']}: {k['registers']} registers, {k['smem']} bytes static shared memory, "
                f"{k['stack']} bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2

    cons, sur, scaler, xb, _ = botnet_problem()
    engines = {
        "lcld": moeva, "lcld_x": x,
        "odd": Moeva2(moeva.classifier, moeva.constraints, ml_scaler=moeva.ml_scaler, device=device, n_pop=100,
                      n_offsprings=99, archive_size=24),
        "botnet": Moeva2(sur, cons, ml_scaler=scaler, device=device, **BOTNET_KNOBS), "botnet_x": xb,
    }
    with torch.inference_mode():
        check_draws(device, engines)
        check_chunk_io(device, engines)
        records += time_draws(device, engines, smi)
    starts = drive_pgd_starts(device, smi)
    summary = PROFILE_SUMMARY
    log(f"[draws] per LCLD generation at {N_STATES} states (phase 6's trace): {summary.get('traced')} launches "
        f"traced, device busy share {summary.get('busy')}, "
        f"{summary.get('ms')} ms per generation traced; Moeva2.generate on the main path (phase 4): cold "
        f"{summary.get('cold_s')} s, steady {summary.get('steady_s')} s on {smi}")
    log(f"[draws] phase 20 took {time.perf_counter() - t0:.1f} s")
    return {"pgd_start": starts}


# -- phase 21: K14 refdirs, K15 restart, K16 forward; K2, K4a and K3 through two pointers --

#: K14 at the configs' population sizes: LCLD's 100 (the main path's
#: engine), botnet's 200 and ``config/moeva.yaml``'s 300; held against its
#: twin on the card and timed at each, against the twin on the host at
#: botnet's (where the host's float32 points differ from the card's)
REFDIRS_POINTS = (100, 200, 300)
REFDIRS_HOST_POINTS = (200,)
REFDIRS_ITERS = 3000
#: float64 operations of K14 per ordered pair of points and step, for 3
#: dimensions: per dimension a difference, its square, the weight's
#: product and the gradient sum's addition, the squares' 2 additions, and
#: the pow counted as one; and per point and step (the softmax's max, 3 exp,
#: 2 additions and 3 divisions; the gradient's scaling, the dot product and
#: the softmax backward; Adam's 13 a dimension)
REFDIRS_OPS_PER_PAIR = 15
REFDIRS_OPS_PER_POINT = 70
#: K14's dependent float64 operations a step besides the n - 1 additions
#: of a point's ordered sum over j, for 3 dimensions, counted from its
#: source with exp, pow, a division and a square root as one each: the
#: softmax (a subtraction and exp, 2 maxima, 2 additions, a division: 7), a
#: weight (a difference, its square, 2 additions, pow: 5), the sum's first
#: term (a difference and a product: 2) and the gradient, softmax backward
#: and Adam (15)
REFDIRS_CHAIN_PER_STEP = 29
#: K14's cluster barrier at 16 CTAs, in cycles of the card's maximum SM
#: clock: 3000 steps of a copy of K14 that runs nothing but the barrier
#: took 2.38 ms on the H100 (``tools/probe_stages.py``, PERF.md)
CLUSTER_BARRIER_CYCLES = 1570
#: K15 at the AutoPGD runner's shape (rq1.lcld's 4000 states x 47 features,
#: one start, no history), held over 3 starts with a (T, N, C) history too
RESTART_SHAPE = (4000, 47)
RESTART_HIST = (100, 3)
RESTART_STARTS = 3
#: K16 at the PGD runner's labels (rq1's 4000 LCLD and 387 botnet states,
#: rq2.botnet's 387 augmented ones at 927 features) and the pipelines'
#: proba1 (phase 19's test rows, 2000 and 1000)
FORWARD_SHAPES = {"lcld": (4000, 2000), "botnet": (387, 1000), "botnet_augmented": (387, 1000)}


def stage_record(name: str, source: str, replaces: str, ms: float, wrapper_ms: float, plain_ms: float,
                 bound, library_ms, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": f"moeva2_ijcai22_replication_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms, **extra}


def host_ms(fn, repeats: int = 3) -> float:
    """Median host-clock ms of ``fn`` ending in a synchronize (for a run
    that takes longer than a graph of launches should hold)."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def refdirs_math_differs(theta_host, z_card) -> dict:
    """Where the descent's two operations that are not correctly rounded,
    float64 ``exp`` and ``pow``, give other bits on the card than on the
    host for the same inputs: the softmax of the start ``theta_host`` and
    the weights pow(d2_ij, -s/2 - 1), i != j, of the host's start points and
    of ``z_card``, K14's points (the host's d2 in both)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import refdirs

    dev = z_card.device
    z0 = refdirs._softmax_rows(theta_host)
    out = {"softmax": int((refdirs._softmax_rows(theta_host.to(dev)).cpu() != z0).sum())}
    n = theta_host.shape[0]
    off = ~torch.eye(n, dtype=torch.bool)
    expo = torch.full((n, n), -4.0 / 2.0 - 1.0, dtype=torch.float64)
    for name, z in (("pow_start", z0), ("pow_end", z_card.cpu())):
        diff = z[:, None, :] - z[None, :, :]
        d2 = refdirs._left_to_right((diff * diff).transpose(1, 2))
        on_card = torch.pow(d2.to(dev), expo.to(dev)).cpu()
        out[name] = int((on_card != torch.pow(d2, expo))[off].sum())
    out["weights"] = n * (n - 1)
    return out


def refdirs_floor_ms(n: int, steps: int, mhz: float) -> float:
    """K14's latency floor for ``n`` points and ``steps`` steps: a step's
    longest path, ``REFDIRS_CHAIN_PER_STEP`` dependent operations and the
    n - 1 additions of a point's ordered sum each at
    ``CYCLES_PER_DEPENDENT_OP`` cycles, and one cluster barrier, at the
    card's maximum SM clock (exp, pow, divisions and roots counted as one
    operation: a floor, not an estimate)."""
    cycles = (REFDIRS_CHAIN_PER_STEP + n - 1) * CYCLES_PER_DEPENDENT_OP + CLUSTER_BARRIER_CYCLES
    return steps * cycles / (mhz * 1e6) * 1e3


def refdirs_shape(n: int, n_dim: int = 3) -> dict:
    """K14's launch for ``n`` points as its launcher plans it on the current
    card (``moeva_refdirs_shape``)."""
    import ctypes

    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    lib = build.library()
    out = (ctypes.c_int * 5)()
    err = lib.moeva_refdirs_shape(n, n_dim, out)
    if err:
        raise RuntimeError(f"moeva_refdirs_shape failed: {lib.moeva_error_string(err).decode()}")
    return dict(zip(("ctas", "points_per_cta", "tile", "threads", "smem_bytes"), out))


def check_refdirs(device, smi: str, moeva, knobs, x) -> tuple:
    """K14 against ``energy_descent_plain`` on the card bit for bit at every
    size of ``REFDIRS_POINTS`` and 3000 steps, against the twin on the host
    at ``REFDIRS_HOST_POINTS``, with the entries where the card's float64
    ``exp`` and ``pow`` differ from the host's (:func:`refdirs_math_differs`);
    the main path's engine's aspiration points equal to K14's; an engine
    built on a fresh cache (with the host descent made to raise) and its
    ``generate``, launch counts set to 0 just before and read just after:
    one K14 launch, and none for a second engine of the same shape; K14
    timed at each size. Returns (record, launches)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2, refdirs

    n = moeva.n_pop
    sched = refdirs.descent_schedule(REFDIRS_ITERS).to(device)
    mhz = max_sm_clock_mhz()
    shapes = {}
    for pts in REFDIRS_POINTS:
        theta = torch.as_tensor(refdirs.start_point(3, pts, 1), device=device)
        got = kernels.refdirs(theta, sched, 4.0)
        t0 = time.perf_counter()
        want = refdirs.energy_descent_plain(theta, 4.0, sched)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not same_bits(got, want):
            raise AssertionError(f"refdirs (K14) differs from energy_descent_plain at {pts} points on the card")
        if pts == n and not same_bits(moeva.asp_points, got.float()):
            raise AssertionError("the main path's engine's aspiration points are not K14's")
        diffs = refdirs_math_differs(theta.cpu(), got)
        host = ""
        if pts in REFDIRS_HOST_POINTS:
            on_host = refdirs.energy_descent_plain(theta.cpu(), 4.0, sched.cpu())
            diffs["host_max_abs_diff"] = float((got.cpu() - on_host).abs().max())
            diffs["host_f32_differ"] = int((got.float().cpu() != on_host.float()).sum())
            host = (f"; against the twin on the host: max |difference| {diffs['host_max_abs_diff']:.3e}, "
                    f"{diffs['host_f32_differ']} of {got.numel()} coordinates differ in float32")
        ms = graph_ms(lambda: kernels.refdirs(theta, sched, 4.0), launches=1, repeats=3)
        wrapper = cuda_ms(lambda: kernels.refdirs(theta, sched, 4.0), launches=1, repeats=3)
        bound = bound_ms(8 * (2 * 3 * pts + 3 * REFDIRS_ITERS), 0,
                         REFDIRS_ITERS * (REFDIRS_OPS_PER_PAIR * pts * pts + REFDIRS_OPS_PER_POINT * pts))
        floor = refdirs_floor_ms(pts, REFDIRS_ITERS, mhz)
        launch = refdirs_shape(pts)
        shapes[pts] = dict(ms=ms, wrapper_ms=wrapper, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                           ceiling_ms=floor, launch=launch, **diffs)
        log(f"[refdirs] refdirs (K14) equals energy_descent_plain bit for bit at {pts} points x {REFDIRS_ITERS} "
            f"steps on the card (plain version {plain_ms:.1f} ms){host}; the card's float64 exp and pow against "
            f"the host's on the same inputs: {diffs['softmax']} of {got.numel()} softmax entries of the start, "
            f"{diffs['pow_start']} and {diffs['pow_end']} of {diffs['weights']} weights at the start and at K14's "
            f"points differ")
        log(f"[refdirs] refdirs (K14) at {pts} points x {REFDIRS_ITERS} steps: device {ms:.3f} ms, through "
            f"the wrapper {wrapper:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), latency floor {floor:.3f} ms (at "
            f"{mhz:.0f} MHz; {ms / floor:.2f}x) on {smi}; launch: a cluster of {launch['ctas']} CTAs of "
            f"{launch['threads']} threads, {launch['points_per_cta']} points a CTA, weight tiles of "
            f"{launch['tile']} points j, {launch['smem_bytes']} bytes of shared memory a CTA")

    def refuse(*args, **kwargs):
        raise AssertionError("an engine on the card ran the energy descent's plain version")

    twin, refdirs.energy_descent_plain = refdirs.energy_descent_plain, refuse
    try:
        refdirs._ref_points.cache_clear()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = Moeva2(moeva.classifier, moeva.constraints, ml_scaler=moeva.ml_scaler, device=device,
                     **{**knobs, "n_gen": 10})
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        eng.generate(x, minimize_class=1)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        Moeva2(moeva.classifier, moeva.constraints, ml_scaler=moeva.ml_scaler, device=device, **knobs)
        again = kernels.launch_counts()["refdirs"]
    finally:
        refdirs.energy_descent_plain = twin
    if launches["refdirs"] != 1 or again != 1:
        raise AssertionError(f"a fresh engine launched refdirs {launches['refdirs']} times and a second one "
                             f"{again - launches['refdirs']}: K14 runs once per process and shape")
    check_launches(launches, expected_launches(eng, len(x)), "a fresh engine's generate")
    log(f"[refdirs] the main path's aspiration points are K14's at {n} points; an engine built on a fresh cache "
        f"with the host descent refused: launches { {k: v for k, v in launches.items() if v} }, one refdirs and "
        f"none for a second engine of its shape; construction {built_s:.3f} s, construction and a generate of "
        f"{len(x)} states x 10 generations {first_s:.3f} s on {smi}")
    first = shapes[n]
    rec = stage_record("refdirs", "refdirs.cu", "moeva2_ijcai22_replication_tpu/attacks/moeva/refdirs.py:94",
                       first["ms"], first["wrapper_ms"], first["plain_ms"], (first["bound_ms"], first["bound_by"]),
                       None, shape=f"{n}x3x{REFDIRS_ITERS}", ceiling_ms=first["ceiling_ms"], launch=first["launch"],
                       points={str(k): v for k, v in shapes.items()},
                       fresh_engine_s=built_s, fresh_engine_generate_s=first_s)
    return rec, launches["refdirs"]


def check_restart(device, smi: str) -> tuple:
    """K15 against ``restart_plain`` on the card bit for bit over
    ``RESTART_STARTS`` starts at ``RESTART_SHAPE``, with and without a
    history, targeted and not; timed at the AutoPGD runner's shape (one
    start, no history); and an AutoPGD runner point (rq1.lcld's
    ``autopgd+flip``, one random start) through ``experiments.pgd.run``,
    launch counts set to 0 just before and read just after: one K15 and one
    K16 label launch. Returns (record, the runner's launches)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import restart_plain

    n, d = RESTART_SHAPE
    t, c = RESTART_HIST
    rng = np.random.default_rng(21)
    x_init = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=device)
    y = torch.as_tensor(np.arange(n) % 2, device=device)
    for targeted, record in ((False, False), (False, True), (True, True)):
        best, hist_k = x_init, None
        curve = torch.empty((RESTART_STARTS, n), dtype=torch.bool, device=device)
        want_x, want_h, succ = x_init, None, torch.zeros(n, dtype=torch.bool, device=device)
        for r in range(RESTART_STARTS):
            x_adv = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=device)
            pred = torch.as_tensor(rng.integers(0, 2, n), device=device)
            hist = torch.as_tensor(rng.normal(size=(t, n, c)).astype(np.float32), device=device) if record else None
            best, hist_k = kernels.restart(x_adv, pred, y, hist, best, hist_k, curve, r, targeted)
            want_x, want_h, succ = restart_plain(x_adv, pred, y, hist, want_x, want_h, succ, targeted)
            what = f"restart (K15) start {r} targeted={targeted} history={record}"
            hold_equal(best, want_x, f"{what} best_x")
            hold_equal(curve[r], succ, f"{what} success")
            if record:
                hold_equal(hist_k, want_h, f"{what} best_hist")
    x_adv = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=device)
    pred = torch.as_tensor(rng.integers(0, 2, n), device=device)
    curve = torch.empty((1, n), dtype=torch.bool, device=device)
    none = torch.zeros(n, dtype=torch.bool, device=device)
    ms = graph_ms(lambda: kernels.restart(x_adv, pred, y, None, x_init, None, curve, 0, False))
    wrapper = cuda_ms(lambda: kernels.restart(x_adv, pred, y, None, x_init, None, curve, 0, False))
    plain = cuda_ms(lambda: restart_plain(x_adv, pred, y, None, x_init, None, none, False))
    bound = bound_ms(3 * 4 * n * d + 2 * 8 * n + n, 0, 0)
    log(f"[restart] restart (K15) equals restart_plain bit for bit on the card over {RESTART_STARTS} starts at "
        f"{n} x {d} (untargeted, untargeted with a {t} x {n} x {c} history, targeted with it)")
    log(f"[restart] restart (K15) at {n} x {d}, one start, no history: device {ms:.4f} ms, through the wrapper "
        f"{wrapper:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}) on {smi}")
    seen = {}

    def expected(cfg):
        def after():
            seen.update(kernels.launch_counts())
            return point_expected_launches("pgd", cfg)
        return after

    with tempfile.TemporaryDirectory() as tmp:
        art = f"{tmp}/lcld"
        write_runner_artifacts("lcld", art)
        cfg = runner_config("lcld", "pgd", art, "autopgd+flip")
        drive_runner(cfg, smi, expected(cfg), "pgd lcld autopgd+flip (phase 21)")
    if seen.get("restart") != 1 or seen.get("forward_labels") != 1:
        raise AssertionError(f"the AutoPGD runner point launched {seen}: not one restart and one forward_labels")
    log(f"[restart] rq1.lcld's autopgd+flip point through experiments.pgd.run: launches "
        f"{ {k: v for k, v in seen.items() if v} }")
    rec = stage_record("restart", "restart.cu", "moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py:311",
                       ms, wrapper, plain, bound, None, shape=f"{n}x{d}")
    return rec, seen


def check_forward(device, smi: str) -> tuple:
    """K16's two instantiations against their plain versions on the card
    bit for bit (labels: ``predict_plain``'s semantics; proba1:
    ``proba1_plain``) on LCLD's, botnet's and augmented botnet's seeded
    stacks at ``FORWARD_SHAPES``, with a NaN row; each timed at every
    stack's shape beside its bound and, as the library figure, the model's
    own ``nn.Linear`` forward and softmax (device time from a CUDA graph, as
    the kernel's), and at LCLD's also through the wrapper, beside its plain
    version and the library launched eagerly; and ``experiments.defense.proba1``
    on the card, launch counts set to 0 just before and read just after.
    Returns (records, proba1's launches)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.experiments import defense
    from moeva2_ijcai22_replication_tpu_torch.models.mlp import botnet_mlp, lcld_mlp, mlp_proba_plain, proba1_plain
    from moeva2_ijcai22_replication_tpu_torch.models.train import stack_tensors

    timed = {}
    for name, (n_lab, n_p1) in FORWARD_SHAPES.items():
        if name == "lcld":
            model = lcld_mlp(seed=11)
        else:
            model = botnet_mlp(927, seed=13) if name == "botnet_augmented" else botnet_mlp(seed=12)
        rng = np.random.default_rng(len(name))
        w, p32, layers32 = stack_tensors(model, torch.float32, device)
        _, p64, layers64 = stack_tensors(model, torch.float64, device)
        x32 = torch.as_tensor(rng.uniform(0.0, 1.0, (n_lab, w[0])).astype(np.float32), device=device)
        x32[3, 1] = float("nan")
        x64 = torch.as_tensor(rng.uniform(0.0, 1.0, (n_p1, w[0])), device=device)
        x64[5, 0] = float("nan")
        labels = kernels.forward_labels(x32, p32, w)
        hold_equal(labels, torch.argmax(mlp_proba_plain(layers32, x32), dim=-1), f"forward_labels (K16) on {name}")
        p1 = kernels.forward_proba1(x64, p64, w)
        want = proba1_plain(layers64, x64)
        hold_equal(p1, want, f"forward_proba1 (K16) on {name}")
        log(f"[forward] forward_labels and forward_proba1 (K16) equal their plain versions bit for bit on {name}'s "
            f"stack {w} at {n_lab} and {n_p1} rows (a NaN row each); labels of class 1: {int(labels.sum())}")
        lib_model = model.to(device)
        lib_model64 = copy.deepcopy(model).to(device=device, dtype=torch.float64)
        n_params = sum(a * b + b for a, b in zip(w[:-1], w[1:]))
        ops = 2 * sum(a * b for a, b in zip(w[:-1], w[1:]))
        for kind, x_t, params, layers, call, plain_fn, lib, size in (
            ("forward_labels", x32, p32, layers32, kernels.forward_labels,
             lambda: torch.argmax(mlp_proba_plain(layers32, x32), dim=-1),
             lambda: torch.softmax(lib_model(x32), dim=-1), 4),
            ("forward_proba1", x64, p64, layers64, kernels.forward_proba1,
             lambda: proba1_plain(layers64, x64),
             lambda: torch.softmax(lib_model64(x64), dim=-1), 8),
        ):
            rows = x_t.shape[0]
            ms = graph_ms(lambda: call(x_t, params, w))
            library = graph_ms(lib)
            n_bytes = size * (rows * w[0] + n_params) + 8 * rows
            bound = bound_ms(n_bytes, ops * rows if size == 4 else 0, ops * rows if size == 8 else 0)
            what = f"{kind} (K16) at {rows} x {w[0]} ({'float32' if size == 4 else 'float64'})"
            if name != "lcld":
                timed[kind].setdefault("other_shapes", {})[f"{rows}x{w[0]}"] = dict(
                    ms=ms, library_ms=library, bound_ms=bound[0], bound_by=bound[1])
                log(f"[forward] {what}, {name}'s stack: device {ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}), the "
                    f"model's nn.Linear forward and softmax (library) {library:.4f} ms of device time (a CUDA graph, "
                    f"as K16) on {smi}")
                continue
            wrapper = cuda_ms(lambda: call(x_t, params, w))
            plain = cuda_ms(plain_fn, launches=2, repeats=3)
            library_eager = cuda_ms(lib)
            timed[kind] = stage_record(
                kind, "mlp_forward.cu",
                "moeva2_ijcai22_replication_tpu/experiments/pgd.py:157" if kind == "forward_labels" else
                "moeva2_ijcai22_replication_tpu/experiments/defense.py:102",
                ms, wrapper, plain, bound, library, shape=f"{rows}x{w[0]}", library_eager_ms=library_eager)
            log(f"[forward] {what}: device {ms:.4f} ms, through the wrapper {wrapper:.4f} ms, plain {plain:.3f} ms, "
                f"bound {bound[0]:.5f} ms ({bound[1]}), the model's nn.Linear forward and softmax (library) "
                f"{library:.4f} ms of device time (a CUDA graph, as K16), {library_eager:.4f} ms launched eagerly on "
                f"{smi}")
    cons, sur, scaler, x = pgd_problem()
    kernels.reset_launch_counts()
    p1 = defense.proba1(sur, scaler, x[:2000], device)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches != {**{k: 0 for k in launches}, "forward_proba1": 1}:
        raise AssertionError(f"experiments.defense.proba1 on the card launched {launches}")
    if p1.shape != (2000,) or not np.isfinite(p1).all():
        raise AssertionError(f"proba1 gave {p1.shape}, finite {np.isfinite(p1).all()}")
    log(f"[forward] experiments.defense.proba1 at 2000 LCLD rows: launches {{'forward_proba1': 1}}, finite, mean "
        f"{float(p1.mean()):.4f}")
    return [timed["forward_labels"], timed["forward_proba1"]], launches["forward_proba1"]


def check_two_pointers(device, smi: str, moeva, x) -> None:
    """K2, K4a and K3 reading [population, offspring] through two pointers
    against the same kernels on the concatenation and against their plain
    versions, bit for bit, at the main path's generation (1000 states, M =
    203, R = 103), each timed both ways in turns; and one LCLD generation's
    launches: ``GENERATION_LAUNCHES``, no eager op."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import PhiloxDraws
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import associate_plain, survive_norm_plain

    draws = PhiloxDraws(moeva, 7)
    with torch.inference_mode():
        init = draws.init(len(x))
        run, start = moeva._prepare(x, np.ones(len(x), dtype=np.int64), moeva.init_spec(init.ball))
        carry = moeva.init_carry(run, init.gum_cut, init.gum_mem, start=start)
        carry = moeva.gen_step(run, carry, draws.generation(len(x)))
        off = moeva.offspring(run, carry.pop_x, draws.generation(len(x)).offspring)
        pop_f, off_f = carry.pop_f, moeva._evaluate(run, off)
        f = torch.cat([pop_f, off_f], dim=1)
        p = moeva.pop_size
        ranks = kernels.nd_peel(pop_f, p, off_f)
        hold_equal(ranks, kernels.nd_peel(f, p), "nd_peel two pointers against the concatenation")
        hold_equal(ranks, nd_ranks_plain(f, p), "nd_peel two pointers against the plain version")
        norm = kernels.survive_norm(pop_f, ranks, moeva.asp_points, carry.norm_state, off_f)
        state, nadir, dirs = survive_norm_plain(f, ranks, moeva.asp_points, carry.norm_state)
        for g, c, w in zip(norm, kernels.survive_norm(f, ranks, moeva.asp_points, carry.norm_state),
                           (*state, nadir, dirs)):
            hold_equal(g, c, "survive_norm two pointers against the concatenation")
            hold_equal(g, w, "survive_norm two pointers against the plain version")
        ideal, nadir, dirs = norm[0], norm[3], norm[4]
        assoc = kernels.associate(pop_f, dirs, ideal, nadir, off_f)
        for g, c, w in zip(assoc, kernels.associate(f, dirs, ideal, nadir), associate_plain(f, dirs, ideal, nadir)):
            hold_equal(g, c, "associate two pointers against the concatenation")
            hold_equal(g, w, "associate two pointers against the plain version")
        turns = {}
        for name, two, one in (
            ("nd_peel", lambda: kernels.nd_peel(pop_f, p, off_f), lambda: kernels.nd_peel(f, p)),
            ("survive_norm", lambda: kernels.survive_norm(pop_f, ranks, moeva.asp_points, carry.norm_state, off_f),
             lambda: kernels.survive_norm(f, ranks, moeva.asp_points, carry.norm_state)),
            ("associate", lambda: kernels.associate(pop_f, dirs, ideal, nadir, off_f),
             lambda: kernels.associate(f, dirs, ideal, nadir)),
        ):
            turns[name] = [graph_ms(two), graph_ms(one), graph_ms(one), graph_ms(two)]
        cat_ms = graph_ms(lambda: torch.cat([pop_f, off_f], dim=1))
        carry, port, ops = launches_per_generation(moeva, run, carry, draws, len(x))
    check_generation_launches(port, ops, "[two-pointers]")
    log(f"[two-pointers] nd_peel, survive_norm and associate read [population, offspring] through two pointers: "
        f"equal to themselves on the concatenation and to their plain versions, bit for bit, at {len(x)} states "
        f"(M = {f.shape[1]}, R = {dirs.shape[1]})")
    log("[two-pointers] device ms in turns (two pointers, concatenation, concatenation, two pointers): "
        + "; ".join(f"{k} " + " ".join(f"{v:.4f}" for v in t) for k, t in turns.items())
        + f"; the parent's torch.cat {cat_ms:.4f} ms on {smi}")
    log(f"[two-pointers] one LCLD generation at {len(x)} states launches {sum(port.values())} kernels "
        f"({ {k: v for k, v in port.items() if v} }) and no eager op")


def run_stages(device, smi: str, resources: list, records: list, moeva, x, knobs) -> dict:
    """Phase 21. Returns the launches of K14, K15 and K16 on their paths."""
    t0 = time.perf_counter()
    for k in resources:
        if k["kernel"].startswith(("refdirs_kernel", "restart_kernel", "forward_kernel")):
            log(f"[stages] ptxas {k['kernel']}: {k['registers']} registers, {k['smem']} bytes static shared memory, "
                f"{k['stack']} bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    rec, n_refdirs = check_refdirs(device, smi, moeva, knobs, x)
    records.append(rec)
    rec, seen = check_restart(device, smi)
    records.append(rec)
    recs, n_proba1 = check_forward(device, smi)
    records += recs
    check_two_pointers(device, smi, moeva, x)
    log(f"[stages] phase 21 took {time.perf_counter() - t0:.1f} s")
    return {"refdirs": n_refdirs, "restart": seen["restart"], "forward_labels": seen["forward_labels"],
            "forward_proba1": n_proba1}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from moeva2_ijcai22_replication_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1

    t_smoke = t_lap = time.perf_counter()

    def lap(phases: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[smoke] {phases} took {now - t_lap:.1f} s")
        t_lap = now

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card: {smi}")
    import importlib.util

    log("[versions] host libraries: " + ", ".join(
        f"{name} {'yes' if importlib.util.find_spec(name) else 'no'}"
        for name in ("yaml", "msgpack", "joblib", "sklearn", "pandas", "scipy")))

    t0 = time.perf_counter()
    info = build.build()
    build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s ({info.path.name})")
    resources = ptxas_resources(info.log)
    for k in resources:
        log(f"[build] {k['source']}: {k['kernel']}: {k['registers']} registers, {k['smem']} bytes static shared "
            f"memory, {k['stack']} bytes stack frame, {k['spill_stores']} + {k['spill_loads']} bytes spill "
            "stores + loads")
        if k["kernel"].startswith(REDESIGNED) and k["spill_stores"] + k["spill_loads"]:
            raise AssertionError(f"{k['kernel']} spills registers: {k}")
    missing = [name for name in REDESIGNED if not any(k["kernel"].startswith(name) for k in resources)]
    if missing:
        raise AssertionError(f"the build's ptxas report has no entry for {missing}: the spill check cannot run")
    lap("phases 1-2")
    moeva, x, knobs = main_path_engine(device)
    records = check_kernels(device, moeva, x)
    lap("phase 3")
    launches = run_main_path(device, smi, moeva, x, knobs)
    lap("phases 4-6")
    problem = pgd_problem()
    check_pgd_kernel(device, problem)
    records.append(time_pgd(device, problem))
    launches["pgd_lcld"] = run_pgd_path(device, problem, smi)["pgd_lcld"]
    lap("phase 7")
    botnet_rec, botnet_launches, botnet_stage_times = run_botnet(device, smi, resources)
    records.append(botnet_rec)
    for rec in records:
        if rec["name"] in botnet_stage_times:
            rec["botnet_shapes"] = botnet_stage_times[rec["name"]]
    launches["objective_botnet"] = botnet_launches["objective_botnet"]
    lap("phase 8")
    pgd_botnet_rec, pgd_botnet_launches = run_pgd_botnet(device, smi, resources)
    records.append(pgd_botnet_rec)
    launches["pgd_botnet"] = pgd_botnet_launches["pgd_botnet"]
    lap("phase 9")
    run_runners(smi)
    lap("phase 10")
    aug_records, aug_launches = run_augmented(device, smi, resources)
    records += aug_records
    launches.update({name: aug_launches[name] for name in ("objective_lcld_aug", "pgd_lcld_aug")})
    lap("phase 11")
    botnet_aug_rec, botnet_aug_launches, botnet_aug_stage_times, pgd_aug_rec, pgd_aug_launches = (
        run_botnet_augmented(device, smi, resources))
    records.append(botnet_aug_rec)
    for rec in records:
        if rec["name"] in botnet_aug_stage_times:
            rec["botnet_augmented_shapes"] = botnet_aug_stage_times[rec["name"]]
    launches["objective_botnet_aug"] = botnet_aug_launches["objective_botnet_aug"]
    records.append(pgd_aug_rec)
    launches["pgd_botnet_aug"] = pgd_aug_launches
    grid_launches = run_grids(smi)
    # no grid file selects AutoPGD, nor PGD on the augmented botnet domain:
    # their counters are checked on phases 12's and 14's drives
    idle = [name for name, n in grid_launches.items()
            if n == 0 and name not in AUTOPGD_COUNTERS + EARLY_EXIT_COUNTERS + HISTORY_COUNTERS + SPEC_COUNTERS
            + SPEC_PGD_COUNTERS + DEFENSE_COUNTERS + ("pgd_start", "refdirs", "restart", "pgd_botnet_aug")]
    if idle:
        raise AssertionError(f"phase 13's grids launched no {idle}")
    auto_records, auto_launches = run_autopgd(device, smi, resources, problem)
    if not all(auto_launches.values()):
        raise AssertionError(f"phase 14 launched no {[k for k, n in auto_launches.items() if not n]}")
    records += auto_records
    launches.update(auto_launches)
    lap("phases 12-14")
    ee_launches = run_early_exit(device, smi, resources, records)
    launches.update({name: ee_launches[name] for name in EARLY_EXIT_COUNTERS})
    lap("phase 15")
    launches.update(run_history(device, smi, resources, records))
    lap("phase 16")
    launches.update(run_spec(device, smi, resources, records))
    lap("phase 17")
    launches.update(run_spec_pgd(device, smi, resources, records))
    lap("phase 18")
    launches.update(run_defense(device, smi, resources, records))
    lap("phase 19")
    launches.update(run_draws(device, smi, resources, records, moeva, x))
    lap("phase 20")
    launches.update(run_stages(device, smi, resources, records, moeva, x, knobs))
    lap("phase 21")
    log(f"[smoke] phases 1-21 took {time.perf_counter() - t_smoke:.1f} s")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        rec["grid_launches"] = grid_launches[rec["name"]]
        if not all(math.isfinite(rec[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite timing in {rec}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
