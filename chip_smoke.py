#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesianinferencedl_tpu_torch) on one
NVIDIA GPU, from the root of a checkout:

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero with no result:

  0. device   require CUDA; print the card's name and power limit
  1. build    compile kernels K1 (csrc/pcg_stencil.cu), K2r (csrc/pcn_fused_r.cu),
              K2 (csrc/pcn_fused.cu), K3 (csrc/pcg_stencil_tile.cu), K4
              (csrc/pcg_stencil_grid.cu), K4r (csrc/pcg_stencil_grid_resident.cu),
              K5 (csrc/shift_cost.cu), K3r (csrc/pcg_stencil_tile_mma.cu), K4c
              (csrc/pcg_stencil_grid_cluster.cu) and K5r
              (csrc/shift_cost_cluster.cu) with nvcc, one process each,
              started together; each one's registers and spills from ptxas,
              K2r's and K5r's for each template instance
  2. lanes    the lanes layout's kernels at res4, B = 256 log-uniform
              conductivities, m = 128, tol 1e-7, maxiter 1500: first the one
              lanes_route names (K3r through pcg_stencil_tile, or K1 through
              pcg_stencil), then the other, each against the plain torch
              version on the card, deflated, undeflated and warm-started:
              per-sample relative L2 difference <= 1e-4, no sample at the cap,
              the deflated solutions within 1e-4 of a float64 direct solve, and
              iteration counts that show the preconditioner is the plain
              version's (see _lanes_gates). Then K1 and K3r timed in turns by
              CUDA events on the same deflated inputs at B = 1, 128, 256 and
              1,024 (the res4 build's batches and the truth solve's), with the
              plain version's time; if lanes_route names K3r, K3r must be no
              slower than K1 at every one of them
  3. slice    build_pipeline (res4, 256 snapshots, r = 40, 1024 + 128
              training/holdout samples, (64, 64) tanh MLP, 300 epochs) and
              run_inversion (pcn, rom_nn, 1024 chains, 2500 steps, 1000 burn,
              noise 1e-2; cut from 4000 / 1000 for the time limit) on the card; the kernel lanes_route names must carry
              the FOM solves (>= 3 launches in the build, >= 4 with the
              inversion's truth solve) and the other lanes kernel none, every
              output finite, and the surrogate must lower the training-set
              error below the ROM's. The holdout comparison is printed, not
              gated: at these widths in full fp32 the holdout ROM error is
              only 3.6-12.5x the f32 FOM's own error and three of the 128
              samples carry 45-96% of its square, so whether the surrogate
              lowers it depends on the seed, for the JAX reference as much
              as for the port.
  4. K2       the fused pCN sampler (experimental.pcn_fused) on the slice's
              pipeline, data and noise, cg_iters = pipe.rom_pcg_iters. First
              k2r_plan's launch beside the kernel's own count of its shared
              memory (they must agree) and the blocks an SM holds. (a) K2r
              through run_pcn_fused and K2 through its launcher, each against
              the plain torch version on the card, 1,024 chains x 200 steps
              (50 burn-in), the plain version replaying the uniforms K2r wrote:
              both kernels' uniforms equal the plain Philox stream bit for bit
              and pass loose moment and neighbour-correlation gates; for each
              kernel at most 1% of chains accept differently; on the others
              theta and log beta within 1e-4 and phi within 1e-3 relative (see
              _k2_check); (b) the main path, run_pcn_fused over 1,250 steps
              (1,000 burn-in; cut from phase 3's 2,500 / 1,000 for the time
              limit) timed by CUDA events after the warm-up of (a),
              with both kernels' launches counted (K2r must carry it, K2 not):
              posterior means within 5 Monte-Carlo standard errors (bulk ESS of
              both runs) of run_inversion's pcn, sds within 10%, accept rates
              within 0.02; split-R-hat printed beside pcn's; K2 timed beside
              K2r on the same run, in turns; (c) the plain version over the
              same 1,250 steps, timed. For the record, not gated: K2 and K2r
              in turns at C = 4,096 over 1,000 steps.
  5. K3r, K3  the sublanes layout's kernels against their plain torch version
              at res8 (n = 24,960), B = 256, m = 128, tol 1e-7, maxiter 1500.
              First the route: the cluster size tile_cluster gives for the
              batches this phase and the slice send, the shared memory a K3r
              block asks for, how many clusters of each size the card holds
              at once (the capacity tile_cluster reads), and K3r's registers
              and spills from ptxas. K3r (through pcg_stencil_tile) and K3
              (through its launcher), each on the same three cases: deflated
              cold (x0 = None, the da_pcn case), undeflated cold, deflated
              warm. No sample at the cap; deflated counts within 16 of the
              plain version's per sample, undeflated means within 5%;
              deflated runs under half their undeflated iterations; against a
              float64 direct solve (8 samples) within 1e-4, or within 1.5x
              the plain version's own error where f32 CG cannot reach 1e-4
              (printed with the reason); kernel vs plain per sample within
              the plain version's own error against the direct solve. Smaller
              batches on K3r (deflated cold at B = 1, 250 and 128, deflated
              warm at 250: the masked last tile and the holdout's batch)
              against the plain version with the same per-sample gates. Times
              at B = 256 and 1,024 for K3r, K3, K1 on the same inputs (for
              the record) and the plain version, with each kernel's count
              mean, least-work bound, share of it and streaming floor; K3r's
              output there under the per-case gates, and at 1,024 (the
              only batch on clusters of 1) against the direct solve too. A
              sweep of K3r over the cluster sizes at B = 1,024, 256, 128 and
              32 beside tile_cluster's pick (printed). Then res16 (n =
              99,072), K3r's other route: deflated cold at B = 32 against the
              plain version under the same gates and against the direct solve
              on 2 samples; K3r, K3 and the plain version timed at B = 256,
              K3r's output there under the per-case gates
  6. DA       build_pipeline at res8 with phase 3's widths, then
              run_inversion(da_pcn, fom): 1,024 chains, subchains of 64
              rom_nn pCN steps, noise 1e-2, 24 outer steps (8 burn-in; cut
              from 60 / 20 for the time limit; the reference bench runs 500 /
              150). K3r must carry every FOM solve
              (>= 3 launches in the build, >= 25 in the run), K3 and K1 none;
              outputs finite, samples (16, 1024, 5), outer accept > 0.6, inner
              accept in (0.05, 0.9), no audited state at the iteration cap.
              Prints stage seconds, ESS/s, outer steps/s, split-R-hat against
              the reference's 1.05 gate, the posterior mean against the truth
              and the share of a batched fine solve in the outer step, with
              its coarse inverses and K3r timed apart on the same states.

  7. K4r, K4  the single layout's two kernels against the plain torch version
              at res32 (769 x 513 grid, padded to 776 x 640), tol 1e-7, the
              reference CLI's cap max(480, 120 res) = 3,840. First the route:
              grid_route's answer for this grid and card, the bytes a block
              needs (the Python count and the kernel's own, which must agree)
              and K4r's registers from ptxas. K4r, through pcg_stencil_grid,
              at B = 32 cold, B = 32 warm (x0 = the plain version's solutions
              at conductivities 5% away) and B = 1; K4, through its launcher,
              at B = 32 cold on the same inputs. Each: no cold sample at the
              cap; on the 2 samples a float64 direct solve covers, the kernel
              within max(1e-4, 1.5x the plain version's error) of the direct
              solve and a per-sample relative L2 gap from the plain version
              no larger than the plain version's own error (the reasons are
              printed); on every sample a gap below 1e-3; mean counts within
              5% of the plain version's; the warm batch's mean count under the
              cold one's. K4r vs K4 per sample printed. At B = 64 (rom's test
              batch; the snapshot batch of 256 was cut for the time limit: its
              plain version alone took ~54 s; phase 8 runs it through K4r) K4r
              and the plain version are timed by CUDA events
              on the same inputs and held to the same per-sample 1e-3 gap and
              5% mean counts, with both count spreads, how many solves hit the
              cap (printed, not gated: the cap is the reference's own) and
              K4r's time per CG iteration; K4 and K4c (through its launcher,
              its own cluster size; not routed here) are timed beside K4r at
              B = 64, K4c twice (its first launch, then the one recorded)
              under the same per-sample 1e-3 gap and 5% mean counts, with
              its streaming floor.
              K4r alone on one cold sample, timed, and its floor: the same
              launch on one 8-cell row per block, 4 samples of the 5-point
              Laplacian at tol 0 (at least 1,000 iterations in all)
  8. FOM CLI  cli.main in-process at --resolution 32: fom, snapshots --n 256,
              rom --n-snapshots 256 --r 40; then snapshots --resolution 40 --n
              64 (the reference CLI's default n, 256, cut for the time limit),
              a grid whose strips outgrow the card's shared memory. Each with the launch counts set to 0
              before it and read after: K4r carries every batched solve at
              res32 (>= 1 launch for snapshots, >= 2 for rom) and K4c every one
              at res40 (>= 1), the other kernels none (K4 included),
              and no deflation basis is built; JSON lines finite, the fom QoI
              positive with 5 entries; rom's rel_err_vs_fom < 0.1; solves/s
              printed. The fom k is also solved by K4r, its plain version and
              the fom command's flat loop with its matvec summed diagonal
              first: K4r's QoI within 1e-4 of the plain version's, and each of
              the four QoIs within 1e-3 of the float64 direct solve's (the
              readings and which plain solve is the outlier are printed).
  9. K4c      the single layout's kernel past K4r's reach at the shapes of that
              res40 sweep (961 x 641 grid padded to 968 x 768, cap 4,800): the
              route, K4c's shared memory (the Python count and the kernel's
              own, which must agree), how many clusters of 1-16 blocks the card
              holds and grid_cluster's pick for B = 1, 8, 64. One set of
              64 conductivities; B = 8 is its first samples. K4c
              through pcg_stencil_grid at B = 8 against the plain version
              (every per-sample gap < 1e-3, mean counts within 5%, no sample
              at the cap that the plain version does not also hit); sample 0
              against a float64 direct solve (within max(1e-4, 1.5x the plain
              version's error)); one cold sample alone, its count equal to the
              B = 8 run's where grid_cluster picks one size for both; K4
              through its launcher at B = 8 under the same gates; K4c at B = 64
              (phase 8's batch), its first 8 samples under the B = 8 gates,
              and against K4 at B = 64 (gap < 1e-3, mean counts within 5%). Every run timed by
              CUDA events with its least-work bound and streaming floor (K4c
              68 B a true node, K4 80 B a padded cell). Then every cluster
              size at B = 8 and 64 (gap < 1e-3 from the plain run or the
              pick's), and whether grid_cluster's pick was the fastest. Cut
              for the time limit: the batch of 256 (phase 8's sweep is 64)
 10. K5r, K5  the shift-cost probe at B = 64, tile 8, 256 iterations.
              First the route: shift_route's answer at res8 (K5r) and res16
              (K5) on this card, k5r_plan's pick beside the kernel's own count
              of its shared memory and threads (they must agree). At res8 K5r
              (through shift_cost, which must launch it and not K5) and K5
              (through its launcher), at res16 K5 (through shift_cost, which
              must launch it and not K5r): with the shifts on A's planes,
              without them on |A|'s (a CG of an SPD diagonal operator; on A's
              own planes its values are set by rounding, see
              experimental/shift_cost.py), each against the plain version on
              the same inputs within max(1e-4, 3x the plain float32 run's gap
              from its float64 run), reason printed, non-finite output
              failing. Then every cluster size that fits at res8
              (k5r_configs), timed under the same gate, and whether the pick
              was the fastest; the floor (the pick's launch with the per-node
              work removed, its reductions met over mbarriers as K5r meets
              them, then by cluster barriers), per iteration and wave and as a
              share of an iteration. Then the entry point,
              shift_cost.main(["8", "8"]) (K5r >= 2 launches, K5 0) and
              main(["16", "8"]) (K5 >= 2, K5r 0), each counted from 0 (the
              kernel summary's launches are the two runs' sums), with the
              per-tile-iteration times of both variants, their gap and K3r's
              time per batch iteration at res8 from phase 5 beside them; K5
              timed at res8 on the same shape
 11. PT       the tempered samplers, pcn on the fom likelihood and the
              unknown-noise potential, each through run_inversion on the
              card with every FOM kernel's count set to 0 just before it and
              read just after. (a) pt_pcn on phase 3's build and data (rom_nn,
              noise 1e-2): 1,024 chains x 4 levels from lambda_min 0.05, the
              ladder adapted, 1,200 steps (400 burn-in; cut from 4,000 /
              1,000 for the time limit): the cold level's
              means within 5 MCSE of phase 3's pcn posterior and its sds
              within 10% (phase 4's gates), every swap rate in (0, 1), the
              ladder rising strictly to exactly 1 in every chain group, log Z
              and its std finite. (b) the reference bench's headline
              (bench.py:401-445): 4,096 chains x 5 levels, adapted ladder,
              noise 1e-3, data simulated at phase 3's truth, 1,000 steps
              (400 burn-in; the bench runs 15,000 / 2,000; cut from 1,200 /
              500 to make room for phase 17, and before that from 2,500 /
              1,000 for the time limit): samples/s,
              min bulk ESS/s, split-R-hat beside the reference's 1.05, the
              mean ladder, swap rates, log Z and us per step printed; gated
              on finiteness, swap rates and the ladder's shape only. Then the
              parts of its step, each timed alone at its shapes: the move
              (and its misfit), the exchange, the ladder, the accumulators.
              (c) pt_da_pcn on the fom likelihood on phase 6's build and
              data: 256 chains x 4 levels (a fine batch of 1,024), subchains
              of 64, segments of 32, 14 outer steps (4 burn-in; cut from 32 /
              10 for the time limit): K3r carries
              every fine solve (>= outer steps + segments launches), K3 and
              K1 none; on the cold level outer accept > 0.6 and inner in
              (0.05, 0.9); no audited state at the cap; the PT gates of (a)
              but the posterior's. (d) pcn on the fom likelihood, phase 6's
              data: 1,024 chains, 96 steps (48 burn-in; cut from 128 / 64),
              segments of 64:
              K3r carries every solve, outputs finite, accept in (0.05,
              0.9), no audited state at the cap; its posterior mean against
              phase 6's da_pcn in MCSE units and beside (c)'s, printed, not
              gated. (e) pcn with infer_noise on phase 3's data, 1,024
              chains, 600 steps (200 burn-in; cut from 1,000 / 300): finite
              outputs, the noise
              posterior's quantiles ordered q05 < q50 < q95, printed beside
              the true 1e-2 with the shape-PPC p-value
 12. P12      the Laplace and gradient-sampler layer, each cell through
              run_inversion with every FOM kernel's count set to 0 just
              before it and read just after. (h) first: with the caller's
              torch.set_float32_matmul_precision("high") (TF32), the pinned
              values (fin.forward, batched_forward_fn("rom_nn"), the
              differentiable forward and its gradient, the Laplace J and
              covariance) equal those at "highest" bit for bit, while an
              unpinned product differs; the cells then run under "high", and
              after each run_inversion the setting must still read "high". On
              phase 3's build and data (the rom_nn posterior at noise 1e-2
              that its pcn sampled), each cell's means within 5 combined MCSE
              of that pcn's and its sds within 10%: (a) laplace_mh, 4,096
              chains, 600 steps (200 burn-in; the bench runs 15,000 /
              2,000), accept in (0.05, 1], the MAP's nlp and point printed; (b)
              mala_lap, 4,096 chains, 300 steps (110 burn-in; 400 / 150
              before phase 17 came), accept in
              (0.3, 0.85]; (c) at 1,024 chains gpcn, 450 steps (200 burn-in),
              mala, 350 steps (150 burn-in), hmc (n_leap 8), 45 steps (20
              burn-in), and hmc_lap
              (ChEES, its pick printed), 120 steps (60 burn-in; its six
              probes, 3,024 gradients, are most of its time); laplace_mh,
              mala_lap, gpcn and mala, hmc, hmc_lap, pt_mala and (e) cut from
              1,000 / 300, 600 / 200, 600 / 200, 120 / 40, 200 / 100, 600 /
              200 and 20 / 6 for the time limit; the four Laplace-seeded cells share one
              8-start MAP (~26 s on an H100, its BFGS at the 200-iteration
              cap in float32, as the reference's): each would compute the
              same one (the same build, data, likelihood and seed), so the
              first cell's is reused by the other three to make room for
              phase 16; (d) pt_mala,
              1,024 chains x 4 levels, 350 steps (150 burn-in), the PT gates
              of phase 11 and log Z within 4 combined sds of phase 11 (a)'s
              pt_pcn. On phase
              6's build and data: (e) da_pcn with MALA subchains on fom at
              res8, 1,024 chains, subchains of 64, 12 outer steps (5
              burn-in): phase 6's gates (outer accept > 0.6, inner in (0.05,
              0.9), K3r carrying every fine solve, no audited state at the cap)
              and its mean within 5 MCSE of phase 6's da_pcn. (f) gpcn on fom
              at res4 (run_gpcn, the reference measure the Gauss-Newton
              Laplace approximation of the rom_nn posterior at phase 3's pcn
              mean), 256 chains, 200 steps: K3r exactly one launch a step and
              one for the initial misfit, K3 and K1 none. (g)
              the differentiable rom_nn and fom forwards in float64 on the
              card: misfit gradients against central differences, relative
              error <= 1e-6 (rom_nn) and <= 1e-5 (fom at tol 1e-10)
 13. approx   the approximation layer through its api entry points on the card, on
              phase 3's build and data, phase 3's pcn (1,024 chains x 2,500
              steps) the reference posterior, at the bench's widths: (a) EKI
              on rom_nn, J = 1,024, an untimed warm run, then a timed one: the
              knots rise strictly to exactly 1.0, n_iters < 50, n_forward = J
              (n_iters + 1), the ensemble finite, each mean within one pcn
              posterior sd of pcn's; (b) full-rank ADVI on rom_nn, 300 steps
              (cut from the bench's 3,000, and from 400 to make room for
              phase 17) x 32
              draws, then psis_certify with 4,096 draws: the ELBO finite
              and its last-50 mean above its first-50, theta_chol lower
              triangular with a positive diagonal, the means within one pcn
              sd, PSIS ess > 0 and k-hat finite; (c) SVGD on rom_nn, 512
              particles x 200 steps (cut from the bench's 800), annealed,
              then PSIS of its moment-matched
              Gaussian with 4,096 draws: the misfit trace finite, the means
              within one pcn sd, k-hat printed, not gated (the reference's
              0.771 fails its own 0.7); (d) run_smc_evidence on rom_nn with
              phase 3's seed, 4,096 particles in 8 groups, 5 mutations, ESS
              target 0.5, at most 64 stages: its data equal phase 3's bit for
              bit, every group under 64 stages (so at lambda = 1), log Z
              finite and within 4 combined sds of phase 11 (a)'s pt_pcn, the
              particle means within half a pcn sd; (e) the fom likelihood
              through K3r at res4, K3r's launches counted around each call:
              EKI, J = 1,024, the data passed, exactly n_iters + 1 launches
              and its means within one pcn sd; run_smc_evidence, 1,024
              particles in 4 groups, exactly 2 + 5 x (the most stages of a
              group) (the truth solve, the initial sweep, one a mutation sweep
              over all groups); psis_certify of (b)'s fit with 4,096 draws,
              exactly 1; every output finite, the fom log Z printed beside
              (d)'s; (f) run_inversion(init="eki") and (init="vi"), pcn on
              rom_nn, 1,024 chains, 400 steps (150 burn-in; cut for the time
              limit): the "eki_init" / "vi_init" events logged and phase 12's
              moment gates against phase 3's pcn
 14. flow     the normalizing flow and NeuTra through their api entry points on
              the card, on phase 3's build (phase_flow's docstring holds the
              gates): (a) run_flow_vi_inversion at bench.py's flow_neutra widths
              on phase 11 (b)'s 1e-3 headline data (SMC on 4,096 particles,
              8 mutations, at most 256 stages, then 700 MLE steps (the
              bench's 3,000 cut for the time limit, and 1,000 to make room
              for phase 17) of a flow
              of 6 couplings of width 32): SMC under 256 stages, the MLE trace
              rising, the flow's round trip within 1e-4; (b) psis_certify_flow,
              8,192 draws, plain and base-widened by 1.5: k-hat finite (printed
              beside the reference's 0.785), ESS > 0, log Z finite; (c)
              run_neutra_inversion, 4,096 chains x 1,000 steps (400 burn-in,
              thin 4; cut from 10,000 / 2,000 for the time limit): accept in
              (0.05, 0.95), the means within one pt_pcn sd
              of the headline's cold level; (d) the identity reduction at 1,024
              base points within 1e-5 relative; (e) the fom route through K3r:
              the certificate exactly 1 launch, NeuTra 1,024 chains x 64 steps
              exactly 65; (f) pretrain="none" flow-VI on phase 3's data, 400
              steps: the ELBO rising, the means within one pcn sd of pcn's;
              (g)-(i) tests/test_flow.py's weights, degenerate-population and
              NeuTra mode-crossing cases at their sizes and tolerances, (h)'s
              gate printed, not enforced (the reference fails it on 4 of 26
              seeds)
 15. P15      persistence, the online tiers, box priors and resumable chains
              (phase_persist_precision's docstring holds the gates): (a) the
              bf16x3 ("high") and bf16 ("fast") products at C = 4,096, r =
              40 against their plain versions and float64; (b) build_pipeline
              at "high" with phase 3's config, pcn on phase 3's data against
              phase 3's pcn (5 MCSE, sds 10%) and the headline pt_pcn on
              phase 11 (b)'s data under phase 11's ladder and swap gates; (c)
              a "fast" build and pcn run, printed; (d) Pipeline.save / load on
              the card, the rom_nn forward bit-identical and the tier kept;
              (e) a log_uniform [0.1, 10] box prior on phase 6's build and
              data, pcn on rom_nn and da_pcn on fom (K3r one launch an outer
              step, every kept log k inside the box, the two means within one
              pcn sd); (f) run_pt_checkpointed and run_da_checkpointed stopped
              half-way and resumed, bit-identical to uninterrupted runs
 16. P16      multilevel delayed acceptance and the workflow around invert
              (phase_mlda_workflow's docstring holds the gates): (a) mlda_pcn
              on phase 6's res8 build and data with the FOM at res4 as the mid
              rung, against phase 6's da_pcn (5 MCSE), K3r's launches per mesh
              exactly 4 res4 and 1 res8 a top step plus the inits'; (b)
              run_mlda_checkpointed stopped and resumed, bit-identical; (c)
              predict_temperature over (a)'s draws at res8, one K3r launch;
              (d) run_sbc_check of pcn on phase 3's rom_nn build; (e) a 3-sensor
              design at res4 and a pipeline and pcn run on it; (f) a greedy
              build at res4
 17. P17      the full-field slice, K3r on nodal planes (phase_full_field's
              docstring holds the gates): (a) build_full_field_pipeline at
              invert-ff's defaults; (b) K3r against its plain version on the
              build's 256 snapshot fields, the coarse projection against a
              host float64 one, K3r timed at B = 256 and 1,024; (c) pcn on
              rom_nn; (d) da_pcn on fom, K3r one launch an outer step; (e)
              mlda_pcn with a res2 rung, lis_pcn, evidence-ff and
              select-ell, invert-ff through the CLI, at cut sizes; (f)
              make_fom_solver(deflate=False), refine_steps and the native
              assembler
 18. P18      the ELL oracle layout, the hand-coded adjoint and the
              multigrid FCG (phase_ell_multigrid's docstring holds the
              gates): (a) ELL at res8 against the SciPy oracle in float64 and
              against K3r in float32; (b) the adjoints against autograd on
              both layouts at res4 in float64; (c) an ELL build_pipeline at
              res4 beside the stencil build; (d) MG-FCG against K3r (res8,
              res16) and K4r (res32), times, counts and errors
 19. P19      the multi-device path on torch.distributed (phase_parallel's
              docstring holds the gates): a world of 1 under NCCL on cuda:0,
              in-process; (a) run_inversion(da_pcn, fom, mesh=) on phase 6's
              res8 build bit-identical to the unsharded run from the same
              generator; (b) sharded_snapshots at res32, B = 16, bit-identical
              to the unsharded kernel route; (c) solve_fom_domain_sharded at
              res8 in float64 within 1e-8 of the direct solve; (d) the dryrun
              over every sharded family (and, on a machine with more cards,
              at a world of every card)

The last three lines are the kernel summary (JSON: time, launches, bound,
plain time of each kernel), the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import re
import subprocess
import sys
import time

import numpy as np

TOL = 1e-7
MAXITER = 1500
B_CHECK = 256
REL_GATE = 1e-4
CHECK_EVERY = 16  # K1's convergence-check stride (its default)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """One line of phase output, headed by the seconds since the script
    started (where the time limit goes)."""
    print(f"[{phase} {time.perf_counter() - T_START:.1f}s] {msg}", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    return card


KERNEL_SOURCES = ("pcg_stencil", "pcn_fused", "pcn_fused_r", "pcg_stencil_tile", "pcg_stencil_grid",
                  "pcg_stencil_grid_resident", "shift_cost", "pcg_stencil_tile_mma",
                  "pcg_stencil_grid_cluster", "shift_cost_cluster")

# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK_F32 = 67e12  # FLOP/s on the CUDA cores
PEAK_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_HBM = 3.35e12  # bytes/s


def phase_build():
    from bayesianinferencedl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.load_libraries(*KERNEL_SOURCES)
    say("build", f"{len(libs)} kernels ready in {time.perf_counter() - t0:.2f} s")
    for name, lib in zip(KERNEL_SOURCES, libs):
        log = _build.build_logs.get(name)
        if log is None:
            say("build", f"cached {lib._name} (no nvcc run)")
            continue
        say("build", f"{name}.cu -> sm_90a by nvcc in {log['seconds']:.2f} s")
        if name == "pcn_fused_r":  # one line per template instance <padded r>
            for fn, regs, spill in _ptxas_functions(log["ptxas"]):
                inst = re.search(r"kernelILi(\d+)E", fn)
                say("build", f"K2r <{inst[1] if inst else fn}>: {regs}; {spill}")
            continue
        if name == "shift_cost_cluster":  # one line per instance <shifts, floor, nodes a thread>
            for fn, regs, spill in _ptxas_functions(log["ptxas"]):
                inst = re.search(r"kernelILb(\d)ELi(\d)ELi(\d)E", fn)
                say("build", f"K5r <{', '.join(inst.groups()) if inst else fn}>: {regs}; {spill}")
            continue
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say("build", line.strip())


def _ptxas_functions(log: str) -> list[tuple[str, str, str]]:
    """(mangled name, registers line, spill line) of each kernel in a ptxas
    -v log."""
    rows, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m[1], ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and fn is not None:
            rows.append((fn, line.split(":", 1)[-1].strip(), spill))
            fn = None
    return rows


def _bound(nbytes: float, f32_ops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_HBM
    t_ops = f32_ops / PEAK_F32 + bf16_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _k1_bound(B: int, n: int, m: int, iters: np.ndarray) -> tuple[float, str]:
    """K1's bound for one deflated batch with these per-sample iteration
    counts (each sample also does one setup residual and preconditioner).
    Per iteration and sample: the 4-plane stencil (13 n), the two dots, three
    vector updates, the Jacobi scaling and rr (~13 n), the coarse solve
    Binv y (2 m^2, float32), and the two deflation products Wt bf16(r) and
    Wt^T bf16(c) (2 m n each): bf16 operands with float32 sums, the tensor
    cores' type. Bytes: vals4, F, Wt, Binv read once, x and iters written."""
    its = float(np.sum(iters + 1))
    f32 = its * (26 * n + 2 * m * m)
    bf16 = its * 4 * m * n
    nbytes = 4 * (4 * B * n + n + B * m * m + B * n + B) + 2 * m * n
    return _bound(nbytes, f32, bf16)


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


_DIRECT = {}  # (n, biot, k's bytes) -> (A, u*, the f32-rounded u*'s relative residual)


def _direct_solve(fin, k: np.ndarray):
    """The float64 sparse direct solve at conductivities k: (A, u*, the
    relative residual of u* rounded to float32), computed once for each
    mesh and k (the gates hold a kernel and its plain version against the
    same solve)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    key = (fin.op.n, float(fin.op.biot), np.asarray(k, dtype=np.float64).tobytes())
    if key not in _DIRECT:
        As, Mext = fin.host.to_scipy_components()
        mask = sum(A.diagonal() for A in As) > 0
        F = fin.host.F_root
        A = sum(float(ki) * Ai for ki, Ai in zip(k, As)) + fin.op.biot * Mext
        A = (A + sp.diags(np.where(mask, 0.0, 1.0))).tocsc()
        us = spla.spsolve(A, F)
        _DIRECT[key] = (A, us, np.linalg.norm(F - A @ us.astype(np.float32)) / np.linalg.norm(F))
    return _DIRECT[key]


def _direct_rel_err(fin, ks: np.ndarray, u: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Per sample: ||u - u*|| / ||u*|| against the float64 sparse direct
    solve u*, and the f64 relative residual of u; and the max over samples
    of that residual for u* rounded to float32 (the floor any float32
    solution sits on)."""
    F = fin.host.F_root
    err, res, floor = [], [], 0.0
    for k, ub in zip(ks, u):
        A, us, fl = _direct_solve(fin, k)
        ub = ub.astype(np.float64)
        err.append(np.linalg.norm(ub - us) / np.linalg.norm(us))
        res.append(np.linalg.norm(F - A @ ub) / np.linalg.norm(F))
        floor = max(floor, fl)
    return np.array(err), np.array(res), floor


def _direct_qoi(fin, k: np.ndarray) -> np.ndarray:
    """The QoI of the float64 sparse direct solve at conductivities k."""
    return fin.host.qoi @ _direct_solve(fin, k)[1]


LANES_BATCHES = (1, 128, B_CHECK, 1024)  # the res4 build's batches and the truth solve's


def _lanes_gates(kname, fin, ks_np, kernel, vals4, cases, kw):
    """K1's res4 gates on one lanes kernel (phase 2's docstring). Returns
    (max abs difference from the plain version, counts by case)."""
    import torch

    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K1

    op = fin.op
    max_abs = 0.0
    iters = {}
    for name, c in cases.items():
        xk, itk = kernel(vals4, op.F_root, c["x0"], Wt=c["Wt"], Binv=c["Binv"], **kw)
        torch.cuda.synchronize()
        xp, itp = c["plain"]
        if not torch.isfinite(xk).all():
            fail(f"{kname} {name}: non-finite solution")
        rel = (torch.linalg.norm(xk - xp, dim=1) / torch.linalg.norm(xp, dim=1)).max().item()
        abs_err = (xk - xp).abs().max().item()
        max_abs = max(max_abs, abs_err)
        it, itp = itk.cpu().numpy(), itp.cpu().numpy()
        iters[name] = it
        it_diff = np.abs(it - itp)
        mean_shift = abs(it.mean() / itp.mean() - 1)
        say("lanes", f"{kname} {name}: max per-sample rel diff vs plain {rel:.3e} (max abs "
            f"{abs_err:.3e}); iters kernel min/median/max {it.min()}/{int(np.median(it))}/{it.max()}, "
            f"plain {itp.min()}/{int(np.median(itp))}/{itp.max()}; per-sample count difference "
            f"max {it_diff.max()}, {int((it_diff > CHECK_EVERY).sum())} samples > {CHECK_EVERY}; "
            f"mean count {it.mean():.2f} vs {itp.mean():.2f}")
        if rel > REL_GATE:
            fail(f"{kname} {name}: kernel vs plain relative difference {rel:.3e} > {REL_GATE}")
        if it.max() >= MAXITER:
            fail(f"{kname} {name}: {int((it >= MAXITER).sum())} samples hit the {MAXITER}-iteration cap")
        # CG reaches the same x under any SPD preconditioner, so the solution
        # alone cannot show that the preconditioner is right: the iteration
        # counts can. With deflation (<= 48 iterations) they must agree per
        # sample to one check block. Undeflated f32 CG runs 256-448
        # iterations and its residual norm is not monotone near tol, so
        # single samples stop blocks apart under two summation orders; there
        # the batch's mean count must agree to 5%.
        if c["Wt"] is not None and it_diff.max() > CHECK_EVERY:
            fail(f"{kname} {name}: iteration counts differ from the plain version's by "
                 f"{it_diff.max()} > {CHECK_EVERY} for some sample")
        if mean_shift > 0.05:
            fail(f"{kname} {name}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
        if name == "deflated":
            sub = slice(0, 16)
            err, res, floor = _direct_rel_err(fin, ks_np[sub], xk[sub].cpu().numpy())
            err, res = err.max(), res.max()
            say("lanes", f"{kname} {name}: vs float64 direct solve (16 samples): max rel err {err:.3e}; "
                f"f64 rel residual {res:.3e} (float32-rounded exact solution: {floor:.3e})")
            if err > REL_GATE:
                fail(f"{kname} {name}: relative error {err:.3e} against the f64 direct solve > {REL_GATE}")
    for name in ("deflated", "warm"):
        slow = int((2 * iters[name] > iters["undeflated"]).sum())
        if slow:
            fail(f"{kname} {name}: {slow} samples took more than half their undeflated iterations")
    return max_abs, iters


def phase_kernel():
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=4, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=MAXITER)
    defl = fin.deflation_basis()
    op = fin.op
    routes = {m: K1.lanes_route(op.n, m) for m in (0, defl.m)}
    route = routes[defl.m]
    say("lanes", f"res4 n={op.n} offsets={op.offsets[4:]} m={defl.m}; fin + deflation basis "
        f"{time.perf_counter() - t0:.2f} s; lanes_route(n, m) = {route} (m = 0: {routes[0]})")
    rng = np.random.default_rng(0)

    def inputs(B):
        ks_np = np.exp(rng.uniform(np.log(0.1), np.log(10.0), (B, 5)))
        ks = torch.tensor(ks_np, dtype=torch.float32, device="cuda")
        vals4 = K1.upper_planes(op.vals(ks))
        Binv = defl.coarse_inverses(ks, op.biot).contiguous()
        return ks_np, ks, vals4, Binv

    ks_np, ks, vals4, Binv = inputs(B_CHECK)
    offs = op.offsets[4:]
    kw = dict(offsets=offs, tol=TOL, maxiter=MAXITER)
    # warm starts: deflated solutions at conductivities 5% away
    ks_near = ks * 1.05
    x0, _ = K1.pcg_stencil_reference(
        K1.upper_planes(op.vals(ks_near)), op.F_root, None, Wt=defl.Wt_bf16,
        Binv=defl.coarse_inverses(ks_near, op.biot).contiguous(), **kw,
    )
    cases = {
        "deflated": dict(x0=None, Wt=defl.Wt_bf16, Binv=Binv),
        "undeflated": dict(x0=None, Wt=None, Binv=None),
        "warm": dict(x0=x0.contiguous(), Wt=defl.Wt_bf16, Binv=Binv),
    }
    for c in cases.values():
        c["plain"] = K1.pcg_stencil_reference(vals4, op.F_root, c["x0"], Wt=c["Wt"], Binv=c["Binv"], **kw)
    # the route's kernel first, then the other: both held to K1's gates
    kernels = {"K3r": K1.pcg_stencil_tile, "K1": K1.pcg_stencil}
    max_abs, iters = {}, {}
    for kname in sorted(kernels, key=lambda k: k != route):
        max_abs[kname], iters[kname] = _lanes_gates(kname, fin, ks_np, kernels[kname], vals4, cases, kw)

    # K1 and K3r in turns (K1, K3r, K3r, K1) on the same deflated inputs at
    # the res4 build's batches
    times = {}
    for B in LANES_BATCHES:
        if B != B_CHECK:
            _, _, vals4, Binv = inputs(B)
        args = dict(Wt=defl.Wt_bf16, Binv=Binv, **kw)
        t = {"K1": [], "K3r": []}
        for kname in ("K1", "K3r", "K3r", "K1"):
            t[kname].append(_time_ms(lambda: kernels[kname](vals4, op.F_root, None, **args), 5))
        p_ms = _time_ms(lambda: K1.pcg_stencil_reference(vals4, op.F_root, None, **args), 3)
        times[B] = {k: float(np.mean(v)) for k, v in t.items()} | {"plain": p_ms}
        say("lanes", f"deflated B={B}: K3r {times[B]['K3r']:.3f} ms (cluster of {_cluster(B)}), K1 "
            f"{times[B]['K1']:.3f} ms (each the mean of two turns: "
            + ", ".join(f"{k} {' / '.join(f'{x:.3f}' for x in v)}" for k, v in t.items())
            + f"), plain torch {p_ms:.3f} ms per batched solve; K3r / K1 "
            f"{times[B]['K3r'] / times[B]['K1']:.3f}")
    no_slower = all(times[B]["K3r"] <= times[B]["K1"] for B in LANES_BATCHES)
    say("lanes", f"K3r no slower than K1 at every batch {LANES_BATCHES}: {no_slower}; "
        f"lanes_route gives {route}")
    if route == "K3r" and not no_slower:
        fail("lanes_route sends the lanes layout to K3r, which was slower than K1 at some batch")
    bound = _k1_bound(B_CHECK, op.n, defl.m, iters["K1"]["deflated"])
    bound_r = _k1_bound(B_CHECK, op.n, defl.m, iters["K3r"]["deflated"])
    say("lanes", f"deflated B={B_CHECK}: bound K1 {bound[0]:.4f} ms ({bound[1]}), kernel at "
        f"{100 * bound[0] / times[B_CHECK]['K1']:.2f}% of it; K3r {bound_r[0]:.4f} ms, at "
        f"{100 * bound_r[0] / times[B_CHECK]['K3r']:.2f}%")
    return dict(route=route, max_abs=max_abs, times=times, bound={"K1": bound, "K3r": bound_r})


def phase_slice():
    import torch

    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
    )
    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_inversion
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K1
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=4),
        fem=FEMConfig(biot=0.1, cg_tol=TOL, cg_maxiter=MAXITER),
        rom=ROMConfig(n_snapshots=256, basis_size=40, online_precision="highest"),
        surrogate=SurrogateConfig(hidden=(64, 64), n_train=1024, epochs=300),
        mcmc=MCMCConfig(n_chains=1024, n_steps=2500, n_burn=1000, beta=0.25, noise_sigma=1e-2,
                        likelihood="rom_nn", sampler="pcn"),
    )
    log = MetricsLogger()
    counts = lambda: {"K1": K1.launches, "K3r": K1.tile_mma_launches}
    K1.launches = K1.tile_mma_launches = 0
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda", metrics=log)
    build_s = time.perf_counter() - t0
    n_build = counts()
    inv = run_inversion(pipe, metrics=log)
    torch.cuda.synchronize()
    n_main = counts()
    s = log.summary()
    stages = {k: s[k]["seconds"] for k in ("build_fom", "snapshots", "project_rom", "error_dataset",
                                          "train_surrogate", "holdout_eval")}
    route = K1.lanes_route(pipe.fin.op.n, pipe.fin.deflation_for_kernels().m)
    other = "K1" if route == "K3r" else "K3r"
    say("slice", f"build_pipeline {build_s:.2f} s; stages (s) " + json.dumps(stages))
    say("slice", f"lanes_route: {route}; launches " + "; ".join(
        f"{k} {n_build[k]} in the build, {n_main[k]} in build + inversion" for k in (route, other)))
    hold = s["holdout_rel_err"]
    say("slice", f"rom_rel_err {s['rom_rel_err']['value']:.4e} corrected_rel_err "
        f"{s['corrected_rel_err']['value']:.4e}; holdout rom {hold['rom']:.4e} "
        f"corrected {hold['corrected']:.4e} (corrected below rom: {hold['corrected'] < hold['rom']})")
    res = inv.result
    acc = res.accept_rate.mean().item()
    say("slice", f"pcn rom_nn: {inv.samples_per_sec:.1f} samples/s over {inv.wall_seconds:.3f} s "
        f"({res.samples.shape[0]} kept x {res.samples.shape[1]} chains); accept {acc:.3f}; "
        f"split-rhat max {inv.rhat.max().item():.4f}; ESS bulk min {inv.ess.min().item():.1f}, "
        f"tail min {inv.ess_tail.min().item():.1f}; ppc p {inv.ppc['p_value']:.3f}")
    post = res.samples.mean(dim=(0, 1)).cpu().numpy()
    say("slice", f"posterior mean log k {np.round(post, 4).tolist()} vs truth "
        f"{np.round(inv.theta_true.cpu().numpy(), 4).tolist()}")

    if n_build[route] < 3:
        fail(f"{route} was launched {n_build[route]} times in build_pipeline (expected >= 3)")
    if n_main[route] <= n_build[route]:
        fail(f"{route} was not launched for the synthetic-truth solve in run_inversion")
    if n_main[other]:
        fail(f"{other}, the other lanes kernel, was launched {n_main[other]} times on the slice")
    for name, t in (("samples", res.samples), ("phi", res.phi_trace), ("ess", inv.ess),
                    ("ess_tail", inv.ess_tail), ("rhat", inv.rhat), ("data", inv.data)):
        if not torch.isfinite(t).all():
            fail(f"non-finite {name}")
    if tuple(res.samples.shape) != (1500, 1024, 5):
        fail(f"samples shape {tuple(res.samples.shape)}")
    rom_tr, corr_tr = s["rom_rel_err"]["value"], s["corrected_rel_err"]["value"]
    if not corr_tr < rom_tr:
        fail(f"training-set corrected error {corr_tr:.4e} not below ROM error {rom_tr:.4e}")
    if not 0.05 < acc < 0.9:
        fail(f"accept rate {acc:.3f} outside (0.05, 0.9)")
    return n_main, cfg, pipe, inv, s


K2_SEED = 1234
K2_CHECK_STEPS, K2_CHECK_BURN = 200, 50
# (b)/(c): the main path's run and the plain version's, cut from phase 3's
# 2,500 / 1,000 steps for the time limit (over 4,000 steps the plain version
# took ~50 s); the burn-in stays phase 3's, so beta adapts as far as pcn's
# did (after 250 burn-in steps the kept accept rate was 0.21 against pcn's 0.23)
K2_MAIN_STEPS, K2_MAIN_BURN = 1250, 1000
K2_FLIP_GATE = 0.01  # share of chains whose accept sequences may differ
K2_STATE_GATE = 1e-4  # |d theta|, |d log beta| on the chains that agree
K2_PHI_GATE = 1e-3  # |d phi| / max(|phi|, 1) on the chains that agree
K2_MEAN_GATE = 5.0  # posterior-mean difference, in Monte-Carlo standard errors
K2_SD_GATE = 0.10  # relative posterior-sd difference
K2_ACC_GATE = 0.02  # accept-rate difference


def _posterior_z(x, ref):
    """Two runs' kept samples (T, C, d): their posterior means and sds, the
    mean difference in Monte-Carlo standard errors (sd over the root of each
    run's bulk ESS), the relative sd difference and each run's largest
    split-R-hat."""
    from bayesianinferencedl_tpu_torch.infer.diagnostics import ess_bulk, split_rhat

    means, sds, ses, rhats = [], [], [], []
    for s in (x, ref):
        flat = s.reshape(-1, s.shape[-1]).double()
        means.append(flat.mean(0))
        sds.append(flat.std(0))
        ses.append(sds[-1] / ess_bulk(s).double().sqrt())
        rhats.append(float(split_rhat(s).max()))
    z = ((means[0] - means[1]).abs() / (ses[0] ** 2 + ses[1] ** 2).sqrt()).cpu().numpy()
    sd_rel = ((sds[0] - sds[1]).abs() / sds[1]).cpu().numpy()
    return [m.cpu().numpy() for m in means], [v.cpu().numpy() for v in sds], z, sd_rel, rhats


def _corr(a, b) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


def _k2_bound(C: int, T: int, r: int, d: int, m: int, h1: int, h2: int,
              cg: int) -> tuple[float, str]:
    """K2's bound for C chains and T steps: the least work of the function,
    whatever the formulation. One misfit per chain and step (plus the
    initial one), each: A(k) = Bi M + sum_j k_j A_j assembled once (d FMAs
    per entry, 2 d r^2), cg + 1 products A(k) p (2 r^2), cg + 1 products by
    P0 (2 r^2; P0 fhat is one vector for the whole run), ~10 r of dots and
    updates per iteration, y = x Bhat^T for the m observables and the MLP;
    all float32 on the CUDA cores. Bytes: theta0 and the operands read
    once, the (T, C, 8) trace written once."""
    misfit = (2 * d * r * r + (cg + 1) * 4 * r * r + cg * 10 * r + 3 * r + 2 * m * r
              + 2 * (d * h1 + h1 * h2 + h2 * m))
    operands = 7 * r * r + 9 * r + 9 * h1 + h1 * h2 + 9 * h2 + 32
    return _bound(4 * (C * 8 + operands + T * C * 8), C * (T + 1) * float(misfit))


K2_BIG_C, K2_BIG_T = 4096, 1000  # the record-only run where chains outnumber the warp slots


def _k2_check(kname, tk, tp, d):
    """(a)'s gates on one kernel's trace tk against the plain version's tp
    on the same uniforms; returns the max abs difference on agreeing chains."""
    flips = (tk[:, :, 7] != tp[:, :, 7]).any(0)
    agree = ~flips
    dd = (tk[:, agree] - tp[:, agree]).abs()
    d_theta = float(dd[..., :d].max())
    d_lbeta = float(dd[..., 6].max())
    d_phi = float((dd[..., 5] / tp[:, agree, 5].abs().clamp(min=1.0)).max())
    max_abs = float(dd.max())
    C = tk.shape[1]
    say("K2", f"{kname} vs plain, {C} chains x {tk.shape[0]} steps: chains whose accept sequences "
        f"differ {int(flips.sum())} ({100 * float(flips.float().mean()):.2f}%); on the others max "
        f"|d theta| {d_theta:.3e}, |d log beta| {d_lbeta:.3e}, rel |d phi| {d_phi:.3e}, max abs "
        f"{max_abs:.3e}; accept {float(tk[K2_CHECK_BURN:, :, 7].mean()):.4f} vs "
        f"{float(tp[K2_CHECK_BURN:, :, 7].mean()):.4f}")
    if float(flips.float().mean()) > K2_FLIP_GATE:
        fail(f"{kname}: {int(flips.sum())} chains accept differently from the plain version")
    if max(d_theta, d_lbeta) > K2_STATE_GATE or d_phi > K2_PHI_GATE:
        fail(f"{kname}: kernel and plain states differ beyond the gates")
    return max_abs


def phase_k2(cfg, pipe, inv):
    import torch

    from bayesianinferencedl_tpu_torch.experimental import pcn_fused as K2
    from bayesianinferencedl_tpu_torch.ops import _build

    mc = cfg.mcmc
    C, T, NB = mc.n_chains, K2_MAIN_STEPS, K2_MAIN_BURN
    cg = pipe.rom_pcg_iters
    gen = torch.Generator(device="cuda").manual_seed(mc.seed + 2)
    theta0 = pipe.prior.sample(gen, (C,))
    args = (pipe.rom, pipe.P0, pipe.surrogate.params, pipe.surrogate.norm, pipe.prior, inv.data,
            mc.noise_sigma, theta0)
    ops = K2.pack_operands(*args, mc.beta)
    r, (h1, h2) = ops.astack.shape[0], ops.w2.shape
    m = pipe.rom.Bhat.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = K2.k2r_plan(C, r, h1, h2, sms)
    lib = _build.load_library("pcn_fused_r")
    smem_fn = lib.pcn_fused_r_smem_bytes
    smem_fn.restype, smem_fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 4
    occ = lib.pcn_fused_r_blocks_per_sm
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    held = ctypes.c_int()
    err = occ(r, h1, h2, plan.warps, ctypes.byref(held))
    c_bytes = smem_fn(r, h1, h2, plan.warps)
    say("K2", f"C={C} r={r} h=({h1}, {h2}) cg_iters={cg} d={ops.d} m={m}; k2r_plan on {sms} SMs: "
        f"{plan._asdict()}; the kernel's own count {c_bytes} B; {held.value} blocks per SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, error {err})")
    if c_bytes != plan.smem_bytes:
        fail(f"K2r: k2r_plan counts {plan.smem_bytes} B of shared memory, the kernel {c_bytes} B")
    if err != 0 or held.value < 1:
        fail(f"K2r: the card holds {held.value} of its blocks per SM (cudaError_t {err})")

    # (a) each kernel against the plain version on the uniforms it drew: K2r
    # through the main path's entry point, K2 through its launcher
    rk = K2.run_pcn_fused(*args, K2_SEED, n_steps=K2_CHECK_STEPS, n_burn=K2_CHECK_BURN,
                          beta=mc.beta, cg_iters=cg, return_uniforms=True)
    torch.cuda.synchronize()
    u1, u2 = rk.uniforms
    tp, _ = K2.pcn_fused_reference(ops, n_steps=K2_CHECK_STEPS, n_burn=K2_CHECK_BURN,
                                   cg_iters=cg, uniforms=(u1, u2))
    tk = rk.trace
    t2, (v1, v2) = K2._launch(ops, n_steps=K2_CHECK_STEPS, n_burn=K2_CHECK_BURN, cg_iters=cg,
                              seed=K2_SEED, uniforms=None, keep_uniforms=True, kernel="K2")
    torch.cuda.synchronize()
    if not (torch.isfinite(tk).all() and torch.isfinite(tp).all() and torch.isfinite(t2).all()):
        fail("K2: non-finite trace")
    philox = [K2.philox_uniforms(K2_SEED, t, C, device="cuda") for t in range(K2_CHECK_STEPS)]
    p1, p2 = torch.stack([a for a, _ in philox]), torch.stack([b for _, b in philox])
    same = torch.equal(p1, u1) and torch.equal(p2, u2)
    same2 = torch.equal(p1, v1) and torch.equal(p2, v2)
    u = torch.cat([u1, u2], -1)  # (T, C, 16)
    u_mean, u_var = float(u.double().mean()), float(u.double().var())
    c_chain, c_step = _corr(u[:, :-1], u[:, 1:]), _corr(u[:-1], u[1:])
    say("K2", f"uniforms: K2r's equal to the plain Philox stream: {same}, K2's: {same2}; mean "
        f"{u_mean:.6f} (1/2), var {u_var:.6f} (1/12 = {1 / 12:.6f}), corr neighbouring chains "
        f"{c_chain:.2e}, neighbouring steps {c_step:.2e}")
    if not (same and same2):
        fail("K2: a kernel's uniforms differ from the plain Philox4x32-10 stream")
    if abs(u_mean - 0.5) > 0.01 or abs(u_var - 1 / 12) > 0.005 or max(abs(c_chain), abs(c_step)) > 0.01:
        fail("K2: the uniforms fail the moment or correlation gates")
    max_abs = {"K2r": _k2_check("K2r", tk, tp, ops.d), "K2": _k2_check("K2", t2, tp, ops.d)}

    # (b) the main path: run_pcn_fused over the whole run, counted and timed
    K2.r_launches = K2.launches = 0
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    res = K2.run_pcn_fused(*args, K2_SEED + 1, n_steps=T, n_burn=NB, beta=mc.beta, cg_iters=cg)
    e1.record()
    e1.synchronize()
    launches = {"K2r": K2.r_launches, "K2": K2.launches}
    first_ms = e0.elapsed_time(e1)
    eager_us = inv.wall_seconds / mc.n_steps * 1e6
    n_kept = (T - NB) * C
    say("K2", f"run_pcn_fused {T} steps ({NB} burn-in) x {C} chains: {first_ms:.3f} ms, launches "
        f"K2r {launches['K2r']}, K2 {launches['K2']}; the eager pcn step of run_inversion in this "
        f"call: {eager_us:.3f} us/step, {inv.samples_per_sec:.1f} samples/s")
    if launches["K2r"] < 1 or launches["K2"]:
        fail("K2r did not carry the main path alone")
    if not (torch.isfinite(res.samples).all() and torch.isfinite(res.phi_trace).all()):
        fail("K2r: non-finite samples")
    if tuple(res.samples.shape) != (T - NB, C, ops.d):
        fail(f"K2r samples shape {tuple(res.samples.shape)}")
    means, sds, z, sd_rel, rhats = _posterior_z(res.samples, inv.result.samples)
    acc_k, acc_p = float(res.accept_rate.mean()), float(inv.result.accept_rate.mean())
    say("K2", f"posterior mean K2r {np.round(means[0], 4).tolist()} vs pcn "
        f"{np.round(means[1], 4).tolist()}; |diff| / MCSE "
        f"{np.round(z, 2).tolist()}")
    say("K2", f"posterior sd K2r {np.round(sds[0], 4).tolist()} vs pcn "
        f"{np.round(sds[1], 4).tolist()}; accept {acc_k:.4f} vs {acc_p:.4f}; "
        f"split-rhat max {rhats[0]:.4f} vs {rhats[1]:.4f}")
    if z.max() > K2_MEAN_GATE:
        fail(f"K2r: posterior means {z.max():.2f} Monte-Carlo errors from pcn's")
    if sd_rel.max() > K2_SD_GATE:
        fail(f"K2r: posterior sd {100 * sd_rel.max():.1f}% from pcn's")
    if abs(acc_k - acc_p) > K2_ACC_GATE:
        fail(f"K2r: accept rate {acc_k:.4f} vs pcn {acc_p:.4f}")

    # K2 beside K2r on the same run, in turns after the main path's K2r run
    # (K2, K2r, K2); K2r's time is the mean of its two runs
    def timed(ops_, T_, NB_, kname):
        e0.record()
        K2._launch(ops_, n_steps=T_, n_burn=NB_, cg_iters=cg, seed=K2_SEED + 1, uniforms=None,
                   keep_uniforms=False, kernel=kname)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    k2_runs = [timed(ops, T, NB, "K2")]
    r_runs = [first_ms, timed(ops, T, NB, "K2r")]
    k2_runs.append(timed(ops, T, NB, "K2"))
    k_ms, k2_ms = float(np.mean(r_runs)), float(np.mean(k2_runs))

    # (c) the plain version over the same run
    e0.record()
    K2.pcn_fused_reference(ops, n_steps=T, n_burn=NB, cg_iters=cg, seed=K2_SEED + 1)
    e1.record()
    e1.synchronize()
    p_ms = e0.elapsed_time(e1)
    bound = _k2_bound(C, T, r, ops.d, m, h1, h2, cg)
    for kname, ms, runs in (("K2r", k_ms, r_runs), ("K2", k2_ms, k2_runs)):
        say("K2", f"{kname} over {T} steps x {C} chains: {ms:.3f} ms (runs "
            f"{' / '.join(f'{x:.3f}' for x in runs)}), {ms / T * 1e3:.3f} us/step, "
            f"{n_kept / (ms / 1e3):.1f} kept samples/s, {100 * bound[0] / ms:.2f}% of the bound")
    say("K2", f"K2r is {k2_ms / k_ms:.2f}x K2's speed; plain torch version over the same {T} steps: "
        f"{p_ms:.3f} ms; bound {bound[0]:.3f} ms ({bound[1]})")

    # for the record: more chains than the SMs' warp slots
    gen_big = torch.Generator(device="cuda").manual_seed(mc.seed + 3)
    ops_big = K2.pack_operands(*args[:-1], pipe.prior.sample(gen_big, (K2_BIG_C,)), mc.beta)
    big_plan = K2.k2r_plan(K2_BIG_C, r, h1, h2, sms)
    big = {"K2": [], "K2r": []}
    for kname in ("K2", "K2r", "K2r", "K2"):
        big[kname].append(timed(ops_big, K2_BIG_T, 0, kname))
    big = {kname: float(np.mean(v)) for kname, v in big.items()}
    big_bound = _k2_bound(K2_BIG_C, K2_BIG_T, r, ops.d, m, h1, h2, cg)
    say("K2", f"record, C={K2_BIG_C} x {K2_BIG_T} steps (k2r_plan: {big_plan.warps} warps x "
        f"{big_plan.blocks} blocks): " + ", ".join(
            f"{kname} {ms:.3f} ms ({ms / K2_BIG_T * 1e3:.3f} us/step, "
            f"{K2_BIG_C * K2_BIG_T / (ms / 1e3):.1f} samples/s, {100 * big_bound[0] / ms:.2f}% of "
            f"the {big_bound[0]:.3f} ms bound)" for kname, ms in big.items()))
    return {kname: dict(launches=launches[kname], max_abs_err=max_abs[kname], ms=ms, plain_ms=p_ms,
                        bound=bound) for kname, ms in (("K2r", k_ms), ("K2", k2_ms))}


K3_RES = 8
K3_DIRECT = 8  # samples held against the float64 direct solve
K3_BATCHES = (B_CHECK, 1024)


def _cluster(B: int, m: int = 128) -> int:
    """The cluster size K3r launches a batch of B with on this card, for a
    coarse space of m (the wrapper's own choice)."""
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    return K.tile_cluster(B, K.tile_capacity(m, 0))


def _stream_floor(bytes_per: int, n: int, iters: np.ndarray) -> float:
    """A streaming kernel's floor (ms): the bytes its design moves per node
    (or cell), sample and iteration, times n and the batch's sum(iters + 1),
    over HBM's rate. K3 moves ~76 B a node, K3r 64 B, K4 ~80 B a padded
    cell, K4c 68 B a true node (their sources' notes)."""
    return bytes_per * n * float(np.sum(iters + 1)) / PEAK_HBM * 1e3


K3_BYTES, K3R_BYTES = 76, 64
K4_BYTES, K4C_BYTES = 80, 68


def _k3_gates(tag, name, xk, itk, xp, itp, deflated):
    """Phase 5's per-case gates (PERF.md Findings): no sample at the cap; the
    counts show the preconditioner is the plain version's, per sample to one
    check block when deflated, the batch mean to 5% undeflated, where f32
    CG's residual is not monotone near tol. Returns (per-sample rel diffs,
    max abs diff, kernel counts)."""
    import torch

    if not torch.isfinite(xk).all():
        fail(f"{tag} {name}: non-finite solution")
    rel_s = (torch.linalg.norm(xk - xp, dim=1) / torch.linalg.norm(xp, dim=1)).cpu().numpy()
    abs_err = (xk - xp).abs().max().item()
    it, itp = itk.cpu().numpy(), itp.cpu().numpy()
    it_diff = np.abs(it - itp)
    mean_shift = abs(it.mean() / itp.mean() - 1)
    say(tag, f"{name}: per-sample rel diff vs plain max {rel_s.max():.3e} median "
        f"{np.median(rel_s):.3e} (max abs {abs_err:.3e}); iters kernel min/median/max "
        f"{it.min()}/{int(np.median(it))}/{it.max()}, plain {itp.min()}/{int(np.median(itp))}/"
        f"{itp.max()}; per-sample count difference max {it_diff.max()}, "
        f"{int((it_diff > CHECK_EVERY).sum())} samples > {CHECK_EVERY}; mean count "
        f"{it.mean():.2f} vs {itp.mean():.2f}")
    if it.max() >= MAXITER or itp.max() >= MAXITER:
        fail(f"{tag} {name}: {int((it >= MAXITER).sum())} kernel and {int((itp >= MAXITER).sum())} "
             f"plain samples hit the {MAXITER}-iteration cap")
    if deflated and it_diff.max() > CHECK_EVERY:
        fail(f"{tag} {name}: iteration counts differ from the plain version's by "
             f"{it_diff.max()} > {CHECK_EVERY} for some sample")
    if mean_shift > 0.05:
        fail(f"{tag} {name}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
    return rel_s, abs_err, it


def _k3_direct(tag, name, fin, ks_np, xk, xp, rel_s, n_direct, res):
    """The deflated cold case against the float64 direct solve: the kernel
    within max(REL_GATE, 1.5x the plain version's error), and kernel vs plain
    within the plain version's own error. Returns that error."""
    sub = slice(0, n_direct)
    err_k, res_k, floor = _direct_rel_err(fin, ks_np[sub], xk[sub].cpu().numpy())
    err_p, _, _ = _direct_rel_err(fin, ks_np[sub], xp[sub].cpu().numpy())
    say(tag, f"{name}: vs float64 direct solve ({n_direct} samples): kernel max rel err "
        f"{err_k.max():.3e}, plain {err_p.max():.3e}; f64 rel residual {res_k.max():.3e} "
        f"(float32-rounded exact solution: {floor:.3e}); kernel vs plain on these samples "
        f"{np.round(rel_s[sub], 8).tolist()}, plain vs direct {np.round(err_p, 8).tolist()}")
    gate = REL_GATE
    if 1.5 * err_p.max() > REL_GATE:
        gate = 1.5 * err_p.max()
        say(tag, f"accuracy gate {gate:.3e} = 1.5 x the plain version's own error: f32 CG "
            f"at res{res} does not reach {REL_GATE:g} against the direct solve")
    if err_k.max() > gate:
        fail(f"{tag} {name}: relative error {err_k.max():.3e} against the f64 direct solve > {gate:.3e}")
    if rel_s.max() > err_p.max():
        fail(f"{tag} {name}: kernel vs plain {rel_s.max():.3e} exceeds the plain version's own "
             f"error against the direct solve, {err_p.max():.3e}")
    return err_p.max()


def _k3_setup(res):
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=res, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=MAXITER)
    defl = fin.deflation_basis()
    _K3_FINS[res] = fin
    op = fin.op
    say("K3r", f"res{res} n={op.n} offsets={op.offsets[4:]} m={defl.m}; fin + deflation basis "
        f"{time.perf_counter() - t0:.2f} s; solve_fom_stencil takes layout "
        f"{K.layout_for(op.n)} (K1 up to n = {K.LANES_MAX_N})")
    if K.layout_for(op.n) != "sublanes":
        fail(f"solve_fom_stencil does not route n = {op.n} to the sublanes layout")
    rng = np.random.default_rng(0)

    def inputs(B):
        ks_np = np.exp(rng.uniform(np.log(0.1), np.log(10.0), (B, 5)))
        ks = torch.tensor(ks_np, dtype=torch.float32, device="cuda")
        return ks_np, ks, K.upper_planes(op.vals(ks)), defl.coarse_inverses(ks, op.biot).contiguous()

    return fin, defl, op, inputs


def _k3_times(tag, fin, op, defl, inputs, batches, kw, with_k1, n_direct, res):
    """K3r, K3 (and K1 where asked) and the plain version on the same
    deflated cold inputs, each with its count mean, least-work bound, share
    and streaming floor. K3r's output at each batch is held against the
    plain version's under the per-case gates, and on ``n_direct`` samples
    against the float64 direct solve (B = 1,024 is the only batch that runs
    on clusters of 1). Returns (times, K3r's max abs diff from the plain)."""
    import torch

    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    k3 = lambda v, Bi: K._launch("pcg_stencil_tile", v, op.F_root, None, tol=TOL, Wt=defl.Wt_bf16,
                                 Binv=Bi, offsets=kw["offsets"], maxiter=MAXITER, check_every=CHECK_EVERY)
    times, max_abs = {}, 0.0
    for B in batches:
        ks_np, _, vals4, Binv = inputs(B)
        args = dict(Wt=defl.Wt_bf16, Binv=Binv, **kw)
        x_r, it_r = K.pcg_stencil_tile(vals4, op.F_root, None, **args)
        torch.cuda.synchronize()
        c = _cluster(B)
        name = f"deflated cold B={B} (cluster of {c})"
        xp, itp = K.pcg_stencil_reference(vals4, op.F_root, None, **args)
        rel_s, abs_err, _ = _k3_gates(tag, name, x_r, it_r, xp, itp, True)
        max_abs = max(max_abs, abs_err)
        if n_direct:
            _k3_direct(tag, name, fin, ks_np, x_r, xp, rel_s, n_direct, res)
        del x_r, xp
        _, it_3 = k3(vals4, Binv)
        r_ms = _time_ms(lambda: K.pcg_stencil_tile(vals4, op.F_root, None, **args), 5)
        k3_ms = _time_ms(lambda: k3(vals4, Binv), 5)
        k1_ms = _time_ms(lambda: K.pcg_stencil(vals4, op.F_root, None, **args), 3) if with_k1 else None
        p_ms = _time_ms(lambda: K.pcg_stencil_reference(vals4, op.F_root, None, **args), 3)
        rec = dict(ms=r_ms, k3_ms=k3_ms, k1_ms=k1_ms, plain_ms=p_ms, cluster=c)
        for key, it, nbytes in (("", it_r, K3R_BYTES), ("k3_", it_3, K3_BYTES)):
            it = it.cpu().numpy()
            rec[key + "bound"] = _k1_bound(B, op.n, defl.m, it)
            rec[key + "floor"] = _stream_floor(nbytes, op.n, it)
            rec[key + "iters_mean"] = float(it.mean())
        times[B] = rec
        k1 = f", K1 {k1_ms:.3f} ms (for the record)" if with_k1 else ""
        say(tag, f"deflated cold B={B}: K3r {r_ms:.3f} ms (cluster of {c}), K3 {k3_ms:.3f} ms{k1}, "
            f"plain torch {p_ms:.3f} ms per batched solve")
        for name, key, ms, nbytes in (("K3r", "", r_ms, K3R_BYTES), ("K3", "k3_", k3_ms, K3_BYTES)):
            bound, floor = rec[key + "bound"], rec[key + "floor"]
            say(tag, f"  {name}: mean count {rec[key + 'iters_mean']:.2f}; least-work bound "
                f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.2f}% of it; streaming floor "
                f"({nbytes} B per node, sample and iteration) {floor:.3f} ms, "
                f"{100 * floor / ms:.1f}% of it")
    return times, max_abs


K3_SWEEP = (1024, 256, 128, 32)  # the batches of phase 5's cluster sweep


def _k3_sweep(op, defl, inputs, kw):
    """K3r at every cluster size for the batches in K3_SWEEP (deflated
    cold, CUDA events, the mean of 3 after a warm-up), beside the size
    tile_cluster picks. Printed, not gated: it shows whether the rule on
    the card's cluster capacity picks the fastest size."""
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    sweep = {}
    for B in K3_SWEEP:
        _, _, vals4, Binv = inputs(B)
        ms = {c: _time_ms(lambda: K._launch_tile_mma(vals4, op.F_root, None, Wt=defl.Wt_bf16, Binv=Binv,
                                                     check_every=CHECK_EVERY, cluster=c, **kw), 3)
              for c in K.TILE_CLUSTERS}
        pick, best = _cluster(B), min(ms, key=ms.get)
        sweep[B] = ms
        say("K3r", f"cluster sweep B={B}: " + ", ".join(f"c={c} {t:.3f} ms" for c, t in ms.items())
            + f"; tile_cluster picks {pick}, the fastest is {best}"
            + ("" if pick == best else f" (the pick {100 * (ms[pick] / ms[best] - 1):.1f}% slower)"))
    return sweep


def phase_k3():
    """K3r (csrc/pcg_stencil_tile_mma.cu, the sublanes layout's kernel on the
    main path) and K3 (csrc/pcg_stencil_tile.cu, beside it) against their
    plain version at res8, then K3r at res16."""
    import torch

    from bayesianinferencedl_tpu_torch.ops import _build
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    fin, defl, op, inputs = _k3_setup(K3_RES)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.load_library("pcg_stencil_tile_mma")
    lib.pcg_stencil_tile_mma_smem_bytes.restype = ctypes.c_int
    lib.pcg_stencil_tile_mma_smem_bytes.argtypes = [ctypes.c_int]
    held, held0 = K.tile_capacity(defl.m, 0), K.tile_capacity(0, 0)
    say("K3r", f"route: {n_sm} SMs; tile_cluster(B, capacity) = "
        + ", ".join(f"{B}: {_cluster(B)}" for B in (1024, 256, 250, 128, 32, 1))
        + f" deflated, {_cluster(B_CHECK, 0)} undeflated at B={B_CHECK}"
        + "; nodes a block owns: " + ", ".join(
            f"c={c}: {min(b - a for a, b in K.tile_ranges(op.n, c))}-"
            f"{max(b - a for a, b in K.tile_ranges(op.n, c))}" for c in K.TILE_CLUSTERS)
        + f"; {lib.pcg_stencil_tile_mma_smem_bytes(defl.m)} B of shared memory a block; clusters "
        f"the card holds at once (cudaOccupancyMaxActiveClusters): "
        + ", ".join(f"c={c}: {v}" for c, v in held.items())
        + f" ({lib.pcg_stencil_tile_mma_smem_bytes(0)} B and "
        + ", ".join(f"{v}" for v in held0.values()) + " undeflated)")
    if min(held.values()) < 1 or min(held0.values()) < 1:
        fail("K3r: the card holds no cluster of some size")
    for line in _build.build_logs.get("pcg_stencil_tile_mma", {}).get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            say("K3r", f"ptxas: {line.strip()}")

    ks_np, ks, vals4, Binv = inputs(B_CHECK)
    kw = dict(offsets=op.offsets[4:], tol=TOL, maxiter=MAXITER)
    ks_near = ks * 1.05  # warm starts: deflated solutions at conductivities 5% away
    x0, _ = K.pcg_stencil_reference(
        K.upper_planes(op.vals(ks_near)), op.F_root, None, Wt=defl.Wt_bf16,
        Binv=defl.coarse_inverses(ks_near, op.biot).contiguous(), **kw,
    )
    cases = {
        "deflated cold": dict(x0=None, Wt=defl.Wt_bf16, Binv=Binv),
        "undeflated cold": dict(x0=None, Wt=None, Binv=None),
        "deflated warm": dict(x0=x0.contiguous(), Wt=defl.Wt_bf16, Binv=Binv),
    }
    kernels = {
        "K3r": lambda v, x0, Wt, Binv: K.pcg_stencil_tile(v, op.F_root, x0, Wt=Wt, Binv=Binv, **kw),
        "K3": lambda v, x0, Wt, Binv: K._launch("pcg_stencil_tile", v, op.F_root, x0, Wt=Wt, Binv=Binv,
                                                check_every=CHECK_EVERY, **kw),
    }
    max_abs = {"K3r": 0.0, "K3": 0.0}
    full = {}
    rel_gate = None
    for name, c in cases.items():
        xp, itp = K.pcg_stencil_reference(vals4, op.F_root, c["x0"], Wt=c["Wt"], Binv=c["Binv"], **kw)
        for tag, kern in kernels.items():
            xk, itk = kern(vals4, c["x0"], c["Wt"], c["Binv"])
            torch.cuda.synchronize()
            if tag == "K3r":
                m_c = 0 if c["Wt"] is None else defl.m
                say(tag, f"{name} B={B_CHECK}: cluster of {_cluster(B_CHECK, m_c)}")
            rel_s, abs_err, it = _k3_gates(tag, name, xk, itk, xp, itp, c["Wt"] is not None)
            max_abs[tag] = max(max_abs[tag], abs_err)
            full[tag, name] = (xk, it)
            if name == "deflated cold":
                err_p = _k3_direct(tag, name, fin, ks_np, xk, xp, rel_s, K3_DIRECT, K3_RES)
                rel_gate = err_p if tag == "K3r" else rel_gate
    for tag in kernels:
        for name in ("deflated cold", "deflated warm"):
            slow = int((2 * full[tag, name][1] > full[tag, "undeflated cold"][1]).sum())
            if slow:
                fail(f"{tag} {name}: {slow} samples took more than half their undeflated iterations")

    # smaller batches, held against the plain version with the per-sample
    # gates of the full-tile cases: the masked last tile (batches that are not
    # a multiple of the tile's 8 samples, as the synthetic-truth solve B = 1
    # sends) and the holdout's 128, which the card runs on clusters of 4
    for B, name in ((1, "deflated cold"), (250, "deflated cold"), (250, "deflated warm"),
                    (128, "deflated cold")):
        c = cases[name]
        v = vals4[:B].contiguous()
        x0_b = None if c["x0"] is None else c["x0"][:B].contiguous()
        args = dict(Wt=c["Wt"], Binv=c["Binv"][:B].contiguous(), **kw)
        xk, itk = K.pcg_stencil_tile(v, op.F_root, x0_b, **args)
        torch.cuda.synchronize()
        cl = _cluster(B)
        xp, itp = K.pcg_stencil_reference(v, op.F_root, x0_b, **args)
        if not torch.isfinite(xk).all():
            fail(f"K3r {name} B={B}: non-finite solution")
        rel_s = (torch.linalg.norm(xk - xp, dim=1) / torch.linalg.norm(xp, dim=1)).cpu().numpy()
        max_abs["K3r"] = max(max_abs["K3r"], (xk - xp).abs().max().item())
        it, itp = itk.cpu().numpy(), itp.cpu().numpy()
        it_diff = np.abs(it - itp)
        same = torch.equal(xk, full["K3r", name][0][:B])
        say("K3r", f"{name} B={B} (last tile {B % 8 or 8} of 8, cluster of {cl}): per-sample rel diff "
            f"vs plain max {rel_s.max():.3e}; iters kernel min/max {it.min()}/{it.max()}, plain "
            f"{itp.min()}/{itp.max()}, per-sample count difference max {it_diff.max()}; "
            f"bit-identical to the B={B_CHECK} run's first {B} samples: {same}")
        if it.max() >= MAXITER or itp.max() >= MAXITER:
            fail(f"K3r {name} B={B}: samples hit the {MAXITER}-iteration cap")
        if it_diff.max() > CHECK_EVERY:
            fail(f"K3r {name} B={B}: iteration counts differ from the plain version's by "
                 f"{it_diff.max()} > {CHECK_EVERY} for some sample")
        if rel_s.max() > rel_gate:
            fail(f"K3r {name} B={B}: kernel vs plain {rel_s.max():.3e} exceeds the plain version's "
                 f"own error against the direct solve, {rel_gate:.3e}")
    say("K3r", "sum order: K3r groups each sum by block, so it depends on the cluster size, not on n "
        "alone; a sample's bits can differ between batches with other cluster sizes (the "
        "'bit-identical' lines above)")

    times, abs_t = _k3_times("K3r", fin, op, defl, inputs, K3_BATCHES, kw, True, K3_DIRECT, K3_RES)
    max_abs["K3r"] = max(max_abs["K3r"], abs_t)
    sweep = _k3_sweep(op, defl, inputs, kw)
    res16 = phase_k3_res16()
    return dict(max_abs_err=max(max_abs["K3r"], res16["max_abs_err"]), k3_max_abs_err=max_abs["K3"],
                times=times, sweep=sweep, res16=res16)


K3_RES16 = 16
K3_RES16_B = 32
K3_RES16_DIRECT = 2


def phase_k3_res16():
    """K3r on its other route, res16 (n = 99,072): deflated cold at B = 32
    against the plain version under the res8 gates and against the float64
    direct solve on 2 samples; K3r, K3 and the plain version timed at
    B = 256."""
    import torch

    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    fin, defl, op, inputs = _k3_setup(K3_RES16)
    kw = dict(offsets=op.offsets[4:], tol=TOL, maxiter=MAXITER)
    ks_np, _, vals4, Binv = inputs(K3_RES16_B)
    args = dict(Wt=defl.Wt_bf16, Binv=Binv, **kw)
    xk, itk = K.pcg_stencil_tile(vals4, op.F_root, None, **args)
    torch.cuda.synchronize()
    say("K3r", f"res{K3_RES16} deflated cold B={K3_RES16_B}: cluster of {_cluster(K3_RES16_B)}")
    xp, itp = K.pcg_stencil_reference(vals4, op.F_root, None, **args)
    name = f"res{K3_RES16} deflated cold B={K3_RES16_B}"
    rel_s, abs_err, _ = _k3_gates("K3r", name, xk, itk, xp, itp, True)
    _k3_direct("K3r", name, fin, ks_np, xk, xp, rel_s, K3_RES16_DIRECT, K3_RES16)
    times, abs_t = _k3_times(f"K3r res{K3_RES16}", fin, op, defl, inputs, (B_CHECK,), kw, False, 0,
                             K3_RES16)
    return dict(max_abs_err=max(abs_err, abs_t), times=times, n=op.n)


DA_OUTER, DA_BURN = 24, 8  # cut from the reference bench's 500 / 150 outer steps (and from 60 / 20)
RHAT_GATE = 1.05  # the reference bench's split-R-hat gate


def phase_da():
    """The slice: the res8 build and da_pcn on the fom likelihood."""
    import torch

    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_inversion
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
    )
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
    from bayesianinferencedl_tpu_torch.utils.ppc import thin_samples

    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=K3_RES),
        fem=FEMConfig(biot=0.1, cg_tol=TOL, cg_maxiter=MAXITER),
        rom=ROMConfig(n_snapshots=256, basis_size=40, online_precision="highest"),
        surrogate=SurrogateConfig(hidden=(64, 64), n_train=1024, epochs=300),
        mcmc=MCMCConfig(n_chains=1024, n_steps=DA_OUTER, n_burn=DA_BURN, beta=0.25,
                        noise_sigma=1e-2, likelihood="fom", sampler="da_pcn", subchain=64,
                        da_coarse="rom_nn", da_inner="pcn"),
    )
    mc = cfg.mcmc
    log = MetricsLogger()
    K.launches = K.tile_launches = K.tile_mma_launches = 0
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda", metrics=log)
    build_s = time.perf_counter() - t0
    k3_build, k1_build = K.tile_mma_launches, K.launches
    inv = run_inversion(pipe, metrics=log)
    torch.cuda.synchronize()
    k3_all, k1_all, k3_old = K.tile_mma_launches, K.launches, K.tile_launches
    s = log.summary()
    stages = {k: s[k]["seconds"] for k in ("build_fom", "snapshots", "project_rom", "error_dataset",
                                          "train_surrogate", "holdout_eval")}
    say("DA", f"build_pipeline res{K3_RES} (n = {pipe.fin.op.n}) {build_s:.2f} s; stages (s) "
        + json.dumps(stages))
    say("DA", f"K3r launches: {k3_build} in the build, {k3_all - k3_build} in run_inversion; "
        f"K3 launches: {k3_old}; K1 launches: {k1_all} ({k1_build} in the build)")
    res = inv.result
    outer = float(res.accept_rate.mean())
    inner = float(res.inner_accept_rate.mean())
    rhat = float(inv.rhat.max())
    say("DA", f"da_pcn fom, {mc.n_chains} chains, subchain {mc.subchain}, {mc.n_steps} outer steps "
        f"({mc.n_burn} burn-in): {inv.wall_seconds:.3f} s, {mc.n_steps / inv.wall_seconds:.3f} outer "
        f"steps/s, {inv.samples_per_sec:.1f} kept samples/s, ESS/s {inv.ess_per_sec:.2f} (bulk ESS "
        f"min {inv.ess.min().item():.1f}, tail min {inv.ess_tail.min().item():.1f}); outer accept "
        f"{outer:.4f}, inner accept {inner:.4f}; fine evaluations {res.n_fine_evals}")
    say("DA", f"split-rhat max {rhat:.4f} against the reference bench's {RHAT_GATE} gate: "
        f"{'pass' if rhat <= RHAT_GATE else 'fail'} (printed, not gated: {mc.n_steps - mc.n_burn} "
        f"kept outer steps); iteration audit cap {inv.fom_iter_cap}, max {inv.fom_iter_max}, "
        f"at cap {inv.fom_hit_cap_frac}; ppc p {inv.ppc['p_value']:.3f}")
    post = res.samples.mean(dim=(0, 1)).cpu().numpy()
    say("DA", f"posterior mean log k {np.round(post, 4).tolist()} vs truth "
        f"{np.round(inv.theta_true.cpu().numpy(), 4).tolist()}")

    if k3_build < 3:
        fail(f"K3r was launched {k3_build} times in build_pipeline at res{K3_RES} (expected >= 3)")
    if k3_all - k3_build < mc.n_steps + 1:
        fail(f"K3r was launched {k3_all - k3_build} times in the da_pcn run (expected >= "
             f"{mc.n_steps + 1})")
    if k1_all or k3_old:
        fail(f"K1 was launched {k1_all} times and K3 {k3_old} at res{K3_RES}, where K3r carries "
             f"every FOM solve")
    for name, t in (("samples", res.samples), ("phi", res.phi_trace), ("ess", inv.ess),
                    ("ess_tail", inv.ess_tail), ("rhat", inv.rhat), ("data", inv.data)):
        if not torch.isfinite(t).all():
            fail(f"non-finite {name}")
    if tuple(res.samples.shape) != (mc.n_steps - mc.n_burn, mc.n_chains, 5):
        fail(f"samples shape {tuple(res.samples.shape)}")
    if not outer > 0.6:
        fail(f"outer accept {outer:.4f} not above 0.6")
    if not 0.05 < inner < 0.9:
        fail(f"inner accept {inner:.4f} outside (0.05, 0.9)")
    if inv.fom_hit_cap_frac != 0:
        fail(f"{inv.fom_hit_cap_frac:.2%} of audited states hit the FOM iteration cap")

    # the fine correction alone: one batched FOM forward of 1,024 kept states
    fwd = pipe.batched_forward_fn("fom")
    states = thin_samples(res.samples, mc.n_chains)
    fine_ms = _time_ms(lambda: fwd(states), 3)
    step_ms = inv.wall_seconds * 1e3 / mc.n_steps
    say("DA", f"batched fine solve of {states.shape[0]} kept states {fine_ms:.3f} ms (K3r, cluster "
        f"of {_cluster(states.shape[0])}); outer step {step_ms:.3f} ms, of which the fine solve is "
        f"{100 * fine_ms / step_ms:.1f}% and the {mc.subchain} rom_nn steps the rest")
    # the fine solve's two parts on the same states: the coarse inverses (a
    # batched Cholesky factorisation and inverse in torch) and K3r alone
    fin, ks = pipe.fin, torch.exp(states)
    defl = fin.deflation_for_kernels()
    inv_ms = _time_ms(lambda: defl.coarse_inverses(ks, fin.op.biot), 3)
    vals4, Binv = K.upper_planes(fin.op.vals(ks)), defl.coarse_inverses(ks, fin.op.biot).contiguous()
    k3r_ms = _time_ms(lambda: K.pcg_stencil_tile(vals4, fin.op.F_root, None, offsets=fin.op.offsets[4:],
                                                 tol=TOL, maxiter=MAXITER, Wt=defl.Wt_bf16, Binv=Binv), 3)
    say("DA", f"  the same states: coarse inverses {inv_ms:.3f} ms, K3r alone {k3r_ms:.3f} ms")
    return k3_all, pipe, inv


K4_RES = 32
K4_CAP = max(480, 120 * K4_RES)  # the reference CLI's _cg_maxiter in float32
K4_CHECK_B = 32
K4_DIRECT = 2  # samples held against the float64 direct solve
K4_BATCHES = (64,)  # rom's test batch (the snapshot batch of 256 cut for the time limit)
K4_STREAM_B = 64  # the batch at which K4 is timed beside K4r
FLOOR_ITERS, FLOOR_B = 2000, 4  # the cap and batch of K4r's floor run (phase 7)
K4_STREAM_RES = 40  # a mesh past K4r's reach on an H100 (res >= 39), so K4c's route
K4_STREAM_N = 64  # the batch of phase 8's snapshot sweep there (the reference CLI's default --n, 256, cut for the time limit)
K4C_BATCHES = (8, 64)  # K4c's timed batches at res40: the first 8 of phase 8's 64, and all
K4C_CAP = max(480, 120 * K4_STREAM_RES)  # the reference CLI's _cg_maxiter in float32: 4,800


def _time_once_ms(fn) -> tuple[float, object]:
    """One call timed by CUDA events (for calls of seconds, after the kernel
    has been built and run once); returns (ms, the call's result)."""
    import torch

    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), out


def _k4_bound(B: int, cells: int, nodes: int, iters: np.ndarray) -> tuple[float, str]:
    """K4's bound for one cold batch with these per-sample counts (each
    sample also does one setup residual). Per iteration and grid node: the
    7-plane stencil (13), p.Ap, the x and r updates, z, r.z, r.r and the p
    update (13): 26 float32 operations, counted on the true grid's nodes
    (the padded cells have zero planes and need none). Bytes: the (B, 7,
    X, Y) planes and F read once, x and the counts written once."""
    f32 = float(np.sum(iters + 1)) * 26 * nodes
    nbytes = 4 * (7 * B * cells + cells + B * cells + B)
    return _bound(nbytes, f32)


def _rel_gap(a, b) -> np.ndarray:
    """Per-sample relative L2 gap ||a - b|| / ||b|| over (B, X, Y) grids."""
    import torch

    return (torch.linalg.norm((a - b).flatten(1), dim=1)
            / torch.linalg.norm(b.flatten(1), dim=1)).cpu().numpy()


def phase_k4():
    """K4r (csrc/pcg_stencil_grid_resident.cu), the single layout's kernel at
    res32, through pcg_stencil_grid, and K4 (csrc/pcg_stencil_grid.cu)
    through its launcher, each against the plain version."""
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import _build
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=K4_RES, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=K4_CAP)
    op = fin.op
    X, Y = op.grid_shape
    X0, Y0 = op.grid_shape0
    say("K4r", f"res{K4_RES} n={op.n} grid {op.grid_shape0} padded to {op.grid_shape}; fin "
        f"{time.perf_counter() - t0:.2f} s; layout {K.layout_for(op.n)} (K3r up to n = "
        f"{K.SUBLANES_MAX_N}); cap {K4_CAP}")
    if K.layout_for(op.n) != "single":
        fail(f"solve_fom_stencil does not route n = {op.n} to the single layout")
    n_sm, smem = K.device_limits(torch.device("cuda"))
    route = K.grid_route(X0, Y0, n_sm, smem)
    nb = min(n_sm, X0)
    rows = [b - a for a, b in K.grid_strips(X0, nb)]
    lib = _build.load_library("pcg_stencil_grid_resident")
    c_bytes = lib.pcg_stencil_grid_resident_bytes
    c_bytes.restype, c_bytes.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    py_bytes, k_bytes = K.resident_bytes(X0, Y0, nb), int(c_bytes(X0, Y0, nb))
    say("K4r", f"route: grid_route({X0}, {Y0}, {n_sm} SMs, {smem} B a block) = {route}; {nb} blocks "
        f"of {min(rows)}-{max(rows)} rows, {py_bytes} B of shared memory a block (the kernel's own "
        f"count: {k_bytes})")
    for line in _build.build_logs.get("pcg_stencil_grid_resident", {}).get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            say("K4r", f"ptxas: {line.strip()}")
    if route != "resident" or py_bytes != k_bytes:
        fail(f"res{K4_RES} routed to {route}, bytes {py_bytes} vs the kernel's {k_bytes}")
    rng = np.random.default_rng(0)
    F2d = op.to_grid(op.F_root)
    kw = dict(tol=TOL, maxiter=K4_CAP)
    k4r = lambda v, x0=None: K.pcg_stencil_grid(v, F2d, x0, shape0=(X0, Y0), **kw)
    k4 = lambda v, x0=None: K._launch_grid(v, F2d, x0, **kw)

    def inputs(B):
        ks_np = np.exp(rng.uniform(np.log(0.1), np.log(10.0), (B, 5)))
        ks = torch.tensor(ks_np, dtype=torch.float32, device="cuda")
        return ks_np, ks, op.vals_grid(ks)

    ks_np, ks, v2 = inputs(K4_CHECK_B)
    x0, _ = K.pcg_stencil_grid_reference(op.vals_grid(ks * 1.05), F2d, None, **kw)
    cases = (("K4r", "cold", k4r, v2, None), ("K4r", "warm", k4r, v2, x0),
             ("K4r", "cold B=1", k4r, v2[:1].contiguous(), None), ("K4", "cold", k4, v2, None))
    max_abs, iters, sols, plain = {"K4r": 0.0, "K4": 0.0}, {}, {}, {}
    for kern, name, solve, v, x0c in cases:
        n_r, n_s = K.grid_resident_launches, K.grid_launches
        xk, itk = solve(v, x0c)
        torch.cuda.synchronize()
        launched = (K.grid_resident_launches - n_r, K.grid_launches - n_s)
        if launched != ((1, 0) if kern == "K4r" else (0, 1)):
            fail(f"{kern} {name}: launches K4r/K4 {launched}")
        if name not in plain:  # K4's cold case runs on K4r's inputs
            plain[name] = K.pcg_stencil_grid_reference(v, F2d, x0c, **kw)
        xp, itp = plain[name]
        if not torch.isfinite(xk).all():
            fail(f"{kern} {name}: non-finite solution")
        rel_s = _rel_gap(xk, xp)
        max_abs[kern] = max(max_abs[kern], (xk - xp).abs().max().item())
        it, itp = itk.cpu().numpy(), itp.cpu().numpy()
        iters[kern, name], sols[kern, name] = it, xk
        mean_shift = abs(it.mean() / itp.mean() - 1)
        say(kern, f"{name}: per-sample rel diff vs plain max {rel_s.max():.3e} median "
            f"{np.median(rel_s):.3e}; iters kernel min/mean/max {it.min()}/{it.mean():.1f}/{it.max()}, "
            f"plain {itp.min()}/{itp.mean():.1f}/{itp.max()}; per-sample count difference max "
            f"{np.abs(it - itp).max()}")
        if name.startswith("cold") and (it.max() >= K4_CAP or itp.max() >= K4_CAP):
            fail(f"{kern} {name}: {int((it >= K4_CAP).sum())} kernel and {int((itp >= K4_CAP).sum())} "
                 f"plain samples hit the {K4_CAP}-iteration cap")
        if mean_shift > 0.05:
            fail(f"{kern} {name}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
        # f32 CG at res32 stops 0.5-1.5e-4 from the direct solve (its
        # attainable accuracy, which the stencil's rounding sets) and its
        # residual hovers near tol for hundreds of iterations, so the two
        # versions can stop hundreds of iterations apart. With the same
        # summation order and roundings (the kernels contract no FMA) they
        # follow one trajectory: per sample their gap is held against the
        # plain version's own error, and the kernel's error within 1.5x the
        # plain version's, the rule of phase 5. On every sample the gap must
        # stay below 1e-3, ten times that error: beyond it is a fault, not
        # rounding
        sub = slice(0, min(K4_DIRECT, len(it)))
        flat = lambda x: op.from_grid(x[sub]).cpu().numpy()
        err_k, res_k, floor = _direct_rel_err(fin, ks_np[sub], flat(xk))
        err_p, _, _ = _direct_rel_err(fin, ks_np[sub], flat(xp))
        gate = max(REL_GATE, 1.5 * err_p.max())
        say(kern, f"{name}: vs float64 direct solve (samples {sub.start}-{sub.stop - 1}): kernel rel err "
            f"{np.round(err_k, 8).tolist()}, plain {np.round(err_p, 8).tolist()}, kernel vs plain "
            f"{np.round(rel_s[sub], 8).tolist()}; f64 rel residual {res_k.max():.3e} (float32-rounded "
            f"exact solution: {floor:.3e}); accuracy gate {gate:.3e} = max({REL_GATE:g}, 1.5 x the plain "
            f"version's error: f32 CG's attainable accuracy at res{K4_RES} is its own)")
        if err_k.max() > gate:
            fail(f"{kern} {name}: relative error {err_k.max():.3e} against the f64 direct solve > {gate:.3e}")
        if (rel_s[sub] > err_p).any():
            fail(f"{kern} {name}: kernel vs plain {np.round(rel_s[sub], 8).tolist()} exceeds the plain "
                 f"version's own error against the direct solve, {np.round(err_p, 8).tolist()}")
        if rel_s.max() > 1e-3:
            fail(f"{kern} {name}: kernel vs plain {rel_s.max():.3e} > 1e-3 on some sample")
    same = bool(iters["K4r", "cold B=1"][0] == iters["K4r", "cold"][0])
    say("K4r", f"B=1 count equal to the B={K4_CHECK_B} run's first sample: {same}")
    gap = _rel_gap(sols["K4r", "cold"], sols["K4", "cold"])
    dit = np.abs(iters["K4r", "cold"] - iters["K4", "cold"])
    say("K4r", f"cold B={K4_CHECK_B}: K4r vs K4 per-sample rel gap max {gap.max():.3e}, "
        f"{int((gap == 0).sum())} of {len(gap)} samples bit-identical; count difference max {dit.max()}")
    # a warm start lowers the batch's mean count; single samples can take
    # more, since near tol the count moves by hundreds of iterations
    w, c = iters["K4r", "warm"], iters["K4r", "cold"]
    say("K4r", f"warm vs cold: mean count {w.mean():.1f} vs {c.mean():.1f}; {int((w >= c).sum())} of "
        f"{len(c)} samples took no fewer iterations warm")
    if not w.mean() < c.mean():
        fail(f"K4r warm: mean count {w.mean():.1f} not below the cold {c.mean():.1f}")

    # the CLI's batches: timed, and K4r held against the plain version on
    # every sample with the gates that need no direct solve; K4 timed beside
    # it at B = 64
    times = {}
    for B in K4_BATCHES:
        _, ks, v2 = inputs(B)
        r_ms, (xk, it_b) = _time_once_ms(lambda: k4r(v2))
        p_ms, (xp, itp_b) = _time_once_ms(lambda: K.pcg_stencil_grid_reference(v2, F2d, None, **kw))
        rel_s = _rel_gap(xk, xp)
        max_abs["K4r"] = max(max_abs["K4r"], (xk - xp).abs().max().item())
        finite = bool(torch.isfinite(xk).all())
        it, itp = it_b.cpu().numpy(), itp_b.cpu().numpy()
        bound = _k4_bound(B, X * Y, op.n_grid, it)
        us_it = r_ms * 1e3 / float(np.sum(it + 1))
        times[B] = dict(ms=r_ms, plain_ms=p_ms, bound=bound, iters_mean=float(it.mean()), us_iter=us_it)
        say("K4r", f"cold B={B}: K4r {r_ms:.3f} ms ({B / r_ms * 1e3:.2f} solves/s, {us_it:.4f} us per "
            f"CG iteration = ms / sum(iters + 1)), plain torch {p_ms:.3f} ms; bound {bound[0]:.4f} ms "
            f"({bound[1]}), K4r at {100 * bound[0] / r_ms:.2f}% of it")
        say("K4r", f"cold B={B}: per-sample rel diff vs plain max {rel_s.max():.3e} median "
            f"{np.median(rel_s):.3e}; counts min/mean/max kernel {it.min()}/{it.mean():.1f}/{it.max()}, "
            f"plain {itp.min()}/{itp.mean():.1f}/{itp.max()}; per-sample count difference max "
            f"{np.abs(it - itp).max()}; at the {K4_CAP} cap: kernel {int((it >= K4_CAP).sum())}, plain "
            f"{int((itp >= K4_CAP).sum())} (printed, not gated: the cap is the reference CLI's own)")
        if B == K4_STREAM_B:
            s_ms, (x4, it4) = _time_once_ms(lambda: k4(v2))
            max_abs["K4"] = max(max_abs["K4"], (x4 - xp).abs().max().item())
            g4 = _rel_gap(xk, x4)
            it4 = it4.cpu().numpy()
            times["K4"] = dict(ms=s_ms, plain_ms=p_ms, bound=bound)
            say("K4", f"cold B={B}, same inputs: K4 {s_ms:.3f} ms ({B / s_ms * 1e3:.2f} solves/s), "
                f"K4r {r_ms:.3f} ms: K4r {s_ms / r_ms:.2f}x faster; K4 vs plain max {_rel_gap(x4, xp).max():.3e}; "
                f"K4r vs K4 per-sample gap max {g4.max():.3e} ({int((g4 == 0).sum())} of {B} "
                f"bit-identical), count difference max {np.abs(it - it4).max()}")
            del x4
            # K4c, the streaming route past K4r's reach, on the same inputs:
            # recorded beside K4r, not routed here (ISSUE: its streaming
            # floor is no better than K4r's time at res32)
            # timed twice: K4c's first launch in this process, then the
            # second on the same inputs (the first has read seconds slower)
            c1_ms, _ = _time_once_ms(lambda: K._launch_grid_cluster(v2, F2d, None, (X0, Y0), **kw))
            c_ms, (xc, itc) = _time_once_ms(lambda: K._launch_grid_cluster(v2, F2d, None, (X0, Y0), **kw))
            gc, itc = _rel_gap(xc, xp), itc.cpu().numpy()
            g4r = _rel_gap(xc, xk)
            c4c = K.grid_cluster(B, K.grid_capacity(torch.cuda.current_device(), Y0))
            fl = _stream_floor(K4C_BYTES, op.n_grid, itc)
            times["K4c"] = dict(ms=c_ms, first_ms=c1_ms, r_ms=r_ms, floor=fl)
            say("K4c", f"res{K4_RES} cold B={B}, same inputs: K4c (clusters of {c4c}) {c_ms:.3f} ms (its first "
                f"launch {c1_ms:.3f} ms) "
                f"({B / c_ms * 1e3:.2f} solves/s), K4r {r_ms:.3f} ms: K4r/K4c time ratio {r_ms / c_ms:.3f}; "
                f"K4c streaming floor {fl:.3f} ms ({K4C_BYTES} B a true node), K4c at {100 * fl / c_ms:.1f}% of "
                f"it; K4c vs plain max {gc.max():.3e}, counts min/mean/max {itc.min()}/{itc.mean():.1f}/"
                f"{itc.max()} (plain {itp.mean():.1f}); K4c vs K4r per-sample gap max {g4r.max():.3e} "
                f"({int((g4r == 0).sum())} of {B} bit-identical)")
            if not torch.isfinite(xc).all() or gc.max() > 1e-3 or abs(itc.mean() / itp.mean() - 1) > 0.05:
                fail(f"K4c res{K4_RES} B={B}: finite {bool(torch.isfinite(xc).all())}, gap vs plain "
                     f"{gc.max():.3e} (gate 1e-3), mean count {itc.mean():.2f} vs plain {itp.mean():.2f} (5%)")
            del xc
        del xk, xp
        if not finite:
            fail(f"K4r cold B={B}: non-finite solution")
        if abs(it.mean() / itp.mean() - 1) > 0.05:
            fail(f"K4r cold B={B}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
        if rel_s.max() > 1e-3:
            fail(f"K4r cold B={B}: kernel vs plain {rel_s.max():.3e} > 1e-3 on some sample")

    # one cold sample alone, and the floor of an iteration: the same launch on
    # a one-row, 8-cell strip per block, FLOOR_B samples of the 5-point
    # Laplacian (SPD; the fin's own planes are the identity in the grid's
    # corners, outside the fin) with a load of ones at tol 0, each running
    # to the cap unless its residual reaches exactly zero: the two
    # reductions and barriers with next to no sweep
    one_ms, (_, it1) = _time_once_ms(lambda: k4r(v2[:1].contiguous()))
    lap = torch.zeros((FLOOR_B, 7, nb, 8), dtype=torch.float32, device="cuda")
    lap[:, K.DIAG_SLOT] = 4.0
    for s_ in (1, 2, 4, 5):  # (-1, 0), (0, -1), (0, 1), (1, 0)
        lap[:, s_] = -1.0
    ones = torch.ones((nb, 8), dtype=torch.float32, device="cuda")
    fl_ms, (xf, itf) = _time_once_ms(lambda: K.pcg_stencil_grid(
        lap, ones, None, tol=0.0, maxiter=FLOOR_ITERS, shape0=(nb, 8)))
    n_fl = int(itf.sum()) + FLOOR_B
    floor_us = fl_ms * 1e3 / n_fl
    us = times[K4_BATCHES[0]]["us_iter"]
    times[1] = dict(ms=one_ms, iters=int(it1[0]))
    say("K4r", f"cold B=1: {one_ms:.3f} ms for {int(it1[0])} iterations "
        f"({one_ms * 1e3 / (int(it1[0]) + 1):.4f} us each); the floor, {nb} strips of one 8-cell row, "
        f"{FLOOR_B} samples at tol 0, {n_fl} iterations in all: {floor_us:.4f} us per iteration, "
        f"{100 * floor_us / us:.1f}% of the {us:.4f} us at B={K4_BATCHES[0]}")
    if not torch.isfinite(xf).all() or n_fl < 1000:
        fail(f"K4r floor run: {n_fl} iterations, finite {bool(torch.isfinite(xf).all())}")
    return dict(fin=fin, max_abs_err=max_abs, times=times)


def phase_fom_cli(k4):
    """The slice: the reference CLI's FOM commands at res32, in-process, on
    K4r; and a snapshot sweep at res40, where the single layout's strips
    outgrow the card's shared memory, on K4c."""
    import torch

    from bayesianinferencedl_tpu_torch import cli
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis

    builds = []
    create = DeflationBasis.create

    def counted_create(*a, **kw):
        builds.append(1)
        return create(*a, **kw)

    res = str(K4_RES)
    k_fom = ["0.5", "2.0", "1.0", "3.0", "0.8"]
    # (name, argv, the kernel that must carry the batched solves, its least launches)
    commands = (("fom", ["fom", "--resolution", res, "--k", *k_fom], "K4r", 0),
                ("snapshots", ["snapshots", "--resolution", res, "--n", "256"], "K4r", 1),
                ("rom", ["rom", "--resolution", res, "--n-snapshots", "256", "--r", "40"], "K4r", 2),
                (f"snapshots res{K4_STREAM_RES}", ["snapshots", "--resolution", str(K4_STREAM_RES),
                                                   "--n", str(K4_STREAM_N)], "K4c", 1))
    out, counts = {}, {"K4r": 0, "K4c": 0}
    DeflationBasis.create = counted_create
    try:
        for name, argv, kern, least in commands:
            K.launches = K.tile_launches = K.tile_mma_launches = 0
            K.grid_launches = K.grid_resident_launches = K.grid_cluster_launches = 0
            builds.clear()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {"K4r": K.grid_resident_launches, "K4c": K.grid_cluster_launches, "K4": K.grid_launches,
                 "K1": K.launches, "K3r": K.tile_mma_launches, "K3": K.tile_launches}
            nb = len(builds)
            line = buf.getvalue().strip().splitlines()[-1]
            out[name] = rec = json.loads(line)
            say("CLI", f"{' '.join(argv)}: {wall:.2f} s wall; {line}")
            say("CLI", f"{name}: launches " + ", ".join(f"{k} {v}" for k, v in n.items())
                + f"; deflation bases built {nb}")
            other = [k for k, v in n.items() if k != kern and v]
            if n[kern] < least:
                fail(f"{name}: {kern} was launched {n[kern]} times (expected >= {least})")
            if other or nb:
                fail(f"{name}: launches of {other} and {nb} deflation bases, where {kern} carries "
                     f"every batched solve undeflated")
            if not np.isfinite(np.array(list(_numbers(rec)), dtype=float)).all():
                fail(f"{name}: non-finite output {line}")
            counts[kern] += n[kern]
    finally:
        DeflationBasis.create = create

    qoi = np.array(out["fom"]["qoi"])
    if qoi.shape != (5,) or not (qoi > 0).all():
        fail(f"fom: QoI {qoi.tolist()} is not 5 positive entries")
    _fom_qoi_check(k4["fin"], np.array([float(v) for v in k_fom]), qoi)
    rel = out["rom"]["rel_err_vs_fom"]
    say("CLI", f"snapshots: {out['snapshots']['fom_solves_per_sec']:.2f} FOM solves/s at res{K4_RES} "
        f"(K4r), {out[commands[3][0]]['fom_solves_per_sec']:.2f} at res{K4_STREAM_RES} (K4c); rom r=40 "
        f"rel_err_vs_fom {rel:.4e}")
    if not rel < 0.1:
        fail(f"rom: rel_err_vs_fom {rel} not below 0.1")
    return counts


# K4r vs its plain version: one trajectory, with the stencil summed in one order
# and every product and sum rounded on its own (K4r contracts no FMA)
K4_QOI_GAP = 1e-4
# any f32 solve of the fom k vs the float64 direct solve at res32, tol 1e-7:
# f32 Jacobi-PCG stops where the stencil's rounding lets it, 6.4e-5 to 8.4e-4
# from the direct solve's QoI across the summation orders this phase runs
K4_QOI_ERR = 1e-3


def _fom_qoi_check(fin, k_np: np.ndarray, qoi: np.ndarray) -> None:
    """The fom command's QoI at k against the float64 direct solve's, beside
    three more float32 solves of the same k at the same tol and cap: K4r, its
    plain version, and the fom command's flat plain loop with its matvec
    summed diagonal first, as both grid versions sum it. Where the flat loop
    lands with that order tells which of the two plain solves is the outlier:
    f32 CG stops at an accuracy that the matvec's rounding sets."""
    import torch

    from bayesianinferencedl_tpu_torch.fem.solve import pcg
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    op = fin.op
    k = torch.tensor(k_np[None], dtype=torch.float32, device="cuda")
    kw = dict(tol=TOL, maxiter=K4_CAP)
    v2, F2d = op.vals_grid(k), op.to_grid(op.F_root)
    x4, it4 = K.pcg_stencil_grid(v2, F2d, None, shape0=op.grid_shape0, **kw)
    xg, itg = K.pcg_stencil_grid_reference(v2, F2d, None, **kw)
    vals, m = op.vals(k), op.max_offset

    def matvec_diag_first(p):
        pp = torch.nn.functional.pad(p, (m, m))
        acc = vals[..., K.DIAG_SLOT] * p
        for s, o in enumerate(op.offsets):
            if s != K.DIAG_SLOT:
                acc = acc + vals[..., s] * pp[..., m + o : m + o + op.n]
        return acc

    xf, itf, _ = pcg(matvec_diag_first, op.F_root[None], op.diag(vals), **kw)
    q = {"fom": qoi,
         "K4r": fin.qoi(op.from_grid(x4))[0].cpu().numpy(),
         "plain grid": fin.qoi(op.from_grid(xg))[0].cpu().numpy(),
         "flat, diagonal first": fin.qoi(xf)[0].cpu().numpy()}
    its = {"K4r": int(it4[0]), "plain grid": int(itg[0]), "flat, diagonal first": int(itf[0])}
    qd = _direct_qoi(fin, k_np)
    err = {name: np.abs(v - qd).max() / np.abs(qd).max() for name, v in q.items()}
    gap = np.abs(q["K4r"] - q["plain grid"]).max() / np.abs(q["plain grid"]).max()
    say("CLI", f"fom QoI {np.round(qoi, 6).tolist()}; max rel error against the float64 direct solve's "
        f"QoI: " + ", ".join(f"{name} {e:.3e}" + (f" ({its[name]} iterations)" if name in its else "")
                             for name, e in err.items()))
    outlier = "fom (flat, offsets order)" if (abs(err["fom"] - err["flat, diagonal first"])
                                             > abs(err["plain grid"] - err["flat, diagonal first"])) \
        else "plain grid"
    say("CLI", f"the plain solve farther from the flat loop summed diagonal first: {outlier}; K4r vs plain "
        f"grid QoI gap {gap:.3e} (gate {K4_QOI_GAP:g}: one trajectory, one summation order, the same "
        f"roundings); every solve vs direct gated at {K4_QOI_ERR:g} (f32 Jacobi-PCG's attainable "
        f"accuracy at res{K4_RES}, tol {TOL:g}, which the stencil's summation order moves by up to 13x)")
    if gap > K4_QOI_GAP:
        fail(f"fom: K4r's QoI differs from its plain version's by {gap:.3e} > {K4_QOI_GAP:g}")
    for name, e in err.items():
        if e > K4_QOI_ERR:
            fail(f"fom: {name} QoI error {e:.3e} against the direct solve > {K4_QOI_ERR:g}")


def _k4c_gates(tag, x, it, xp, itp, cap):
    """The per-sample gates of a res40 run against the plain version on the
    same inputs: finite, every gap below 1e-3, mean counts within 5%, and no
    sample at the cap that the plain version does not also hit."""
    import torch

    gap = _rel_gap(x, xp)
    it, itp = it.cpu().numpy(), itp.cpu().numpy()
    only = int(((it >= cap) & (itp < cap)).sum())
    say("K4c", f"{tag} vs plain: per-sample rel gap max {gap.max():.3e} median {np.median(gap):.3e}; counts "
        f"min/mean/max {it.min()}/{it.mean():.1f}/{it.max()}, plain {itp.min()}/{itp.mean():.1f}/{itp.max()}; "
        f"per-sample count difference max {np.abs(it - itp).max()}; at the {cap} cap: {int((it >= cap).sum())}, "
        f"plain {int((itp >= cap).sum())}")
    if not torch.isfinite(x).all():
        fail(f"{tag}: non-finite solution")
    if gap.max() > 1e-3:
        fail(f"{tag}: per-sample gap {gap.max():.3e} from the plain version > 1e-3")
    if abs(it.mean() / itp.mean() - 1) > 0.05:
        fail(f"{tag}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
    if only:
        fail(f"{tag}: {only} samples at the {cap} cap where the plain version converged")
    return (x - xp).abs().max().item()


def phase_k4c(k4):
    """K4c (csrc/pcg_stencil_grid_cluster.cu), the single layout's kernel past
    K4r's reach, at the shapes of its main path (phase 8's res40 sweep, cap
    4,800), through pcg_stencil_grid; K4 (csrc/pcg_stencil_grid.cu), off the
    main path, through its launcher beside it. The batches are the first 8
    and all 64 of one set of conductivities."""
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import _build
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=K4_STREAM_RES, biot=0.1, device="cuda", cg_tol=TOL,
                              cg_maxiter=K4C_CAP)
    op = fin.op
    X, Y = op.grid_shape
    X0, Y0 = op.grid_shape0
    cells, nodes = X * Y, op.n_grid
    n_sm, smem = K.device_limits(torch.device("cuda"))
    route = K.grid_route(X0, Y0, n_sm, smem)
    cap = K.grid_capacity(torch.cuda.current_device(), Y0)
    picks = {B: K.grid_cluster(B, cap) for B in (1, *K4C_BATCHES)}
    c_bytes = _build.load_library("pcg_stencil_grid_cluster").pcg_stencil_grid_cluster_smem_bytes
    c_bytes.restype, c_bytes.argtypes = ctypes.c_longlong, [ctypes.c_int]
    py_bytes, k_bytes = K.cluster_bytes(Y0), int(c_bytes(Y0))
    say("K4c", f"res{K4_STREAM_RES} n={op.n} grid {op.grid_shape0} padded to {op.grid_shape} ({nodes} true "
        f"nodes, {cells} cells); fin {time.perf_counter() - t0:.2f} s; cap {K4C_CAP}; route: grid_route({X0}, "
        f"{Y0}, {n_sm} SMs, {smem} B a block) = {route} (K4r's strips would need "
        f"{K.resident_bytes(X0, Y0, min(n_sm, X0))} B a block); {py_bytes} B of shared memory a K4c block "
        f"(the kernel's own count: {k_bytes})")
    say("K4c", f"capacity, clusters of c the card holds at once: {cap}; grid_cluster(B, capacity) = "
        + ", ".join(f"{B}: {c}" for B, c in picks.items()))
    for line in _build.build_logs.get("pcg_stencil_grid_cluster", {}).get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            say("K4c", f"ptxas: {line.strip()}")
    if route != "stream" or py_bytes != k_bytes:
        fail(f"res{K4_STREAM_RES} routed to {route}, bytes {py_bytes} vs the kernel's {k_bytes}")

    ks_np = np.exp(np.random.default_rng(1).uniform(np.log(0.1), np.log(10.0), (K4C_BATCHES[-1], 5)))
    v_all = op.vals_grid(torch.tensor(ks_np, dtype=torch.float32, device="cuda"))
    F2d = op.to_grid(op.F_root)
    kw = dict(tol=TOL, maxiter=K4C_CAP)
    k4c = lambda v: K.pcg_stencil_grid(v, F2d, None, shape0=(X0, Y0), **kw)
    k4 = lambda v: K._launch_grid(v, F2d, None, **kw)
    times, max_abs = {}, {}

    def report(name, B, ms, it, bytes_per, n):
        it = it.cpu().numpy()
        bound, fl = _k4_bound(B, cells, nodes, it), _stream_floor(bytes_per, n, it)
        times[name, B] = dict(ms=ms, bound=bound, floor=fl)
        say(name, f"res{K4_STREAM_RES} cold B={B}: {ms:.3f} ms ({B / ms * 1e3:.2f} solves/s), counts mean "
            f"{it.mean():.1f}, sum(iters + 1) {int(np.sum(it + 1))}; least-work bound {bound[0]:.4f} ms "
            f"({bound[1]}), {name} at {100 * bound[0] / ms:.2f}% of it; streaming floor {fl:.3f} ms "
            f"({bytes_per} B x {n} x sum(iters + 1) / 3.35 TB/s), {name} at {100 * fl / ms:.1f}% of it")

    # B = 8 through the wrapper, against the plain version
    v8 = v_all[: K4C_BATCHES[0]]
    before = (K.grid_cluster_launches, K.grid_launches, K.grid_resident_launches)
    ms8, (x8, it8) = _time_once_ms(lambda: k4c(v8))
    launched = tuple(a - b for a, b in zip((K.grid_cluster_launches, K.grid_launches,
                                            K.grid_resident_launches), before))
    if launched != (1, 0, 0):
        fail(f"res{K4_STREAM_RES}: pcg_stencil_grid launched K4c/K4/K4r {launched}, not K4c once")
    p_ms, (xp, itp) = _time_once_ms(lambda: K.pcg_stencil_grid_reference(v8, F2d, None, **kw))
    times["plain", 8] = dict(ms=p_ms)
    say("K4c", f"cold B=8 through pcg_stencil_grid (clusters of {picks[8]}): {ms8:.3f} ms, plain torch "
        f"{p_ms:.3f} ms: K4c {p_ms / ms8:.2f}x faster than plain")
    max_abs["K4c"] = _k4c_gates("K4c cold B=8", x8, it8, xp, itp, K4C_CAP)
    report("K4c", 8, ms8, it8, K4C_BYTES, nodes)

    # one sample against the float64 direct solve
    flat = lambda x: op.from_grid(x[:1]).cpu().numpy()
    err_k, res_k, floor = _direct_rel_err(fin, ks_np[:1], flat(x8))
    err_p, _, _ = _direct_rel_err(fin, ks_np[:1], flat(xp))
    gate = max(REL_GATE, 1.5 * err_p.max())
    say("K4c", f"sample 0 vs the float64 direct solve: K4c rel err {err_k[0]:.4e}, plain {err_p[0]:.4e}; f64 "
        f"rel residual {res_k[0]:.3e} (float32-rounded exact solution: {floor:.3e}); gate {gate:.4e} = "
        f"max({REL_GATE:g}, 1.5 x the plain version's error: f32 CG's attainable accuracy at "
        f"res{K4_STREAM_RES} is its own)")
    if err_k.max() > gate:
        fail(f"K4c: relative error {err_k.max():.3e} against the f64 direct solve > {gate:.3e}")

    # one cold sample alone
    ms1, (x1, it1) = _time_once_ms(lambda: k4c(v_all[:1]))
    same = int(it1[0]) == int(it8[0])
    say("K4c", f"cold B=1 (clusters of {picks[1]}): {ms1:.3f} ms, {int(it1[0])} iterations; the B=8 run's "
        f"sample 0 (clusters of {picks[8]}): {int(it8[0])}; equal: {same}; bit-identical: "
        f"{bool(torch.equal(x1[0], x8[0]))}" + ("" if picks[1] == picks[8] else
                                                " (other cluster sizes: printed, not gated)"))
    if picks[1] == picks[8] and not same:
        fail(f"K4c B=1: {int(it1[0])} iterations, the B=8 run's sample 0 took {int(it8[0])} on the same c")
    del x1

    # K4, off the main path, at B = 8: its gates against the same plain run
    ms48, (x48, it48) = _time_once_ms(lambda: k4(v8))
    max_abs["K4"] = _k4c_gates("K4 cold B=8", x48, it48, xp, itp, K4C_CAP)
    report("K4", 8, ms48, it48, K4_BYTES, cells)
    g = _rel_gap(x8, x48)
    say("K4c", f"cold B=8: K4 {ms48:.3f} ms, K4c {ms8:.3f} ms: K4c {ms48 / ms8:.2f}x faster; K4c vs K4 "
        f"per-sample gap max {g.max():.3e} ({int((g == 0).sum())} of 8 bit-identical)")
    del x48

    # B = 64, the main path's batch: its first 8 against the plain run, and
    # K4 on the same inputs
    B = K4C_BATCHES[-1]
    msB, (xB, itB) = _time_once_ms(lambda: k4c(v_all))
    report("K4c", B, msB, itB, K4C_BYTES, nodes)
    say("K4c", f"cold B={B} (clusters of {picks[B]}): first 8 samples against the B=8 plain run:")
    max_abs["K4c"] = max(max_abs["K4c"], _k4c_gates(f"K4c cold B={B} [:8]", xB[:8], itB[:8], xp, itp,
                                                    K4C_CAP))
    a = itB.cpu().numpy()
    say("K4c", f"cold B={B}: counts min/mean/max {a.min()}/{a.mean():.1f}/{a.max()}, at the {K4C_CAP} cap "
        f"{int((a >= K4C_CAP).sum())} (printed, not gated: the cap is the reference CLI's own); finite "
        f"{bool(torch.isfinite(xB).all())}")
    if not torch.isfinite(xB).all():
        fail(f"K4c B={B}: non-finite solution")
    ms4B, (x4B, it4B) = _time_once_ms(lambda: k4(v_all))
    report("K4", B, ms4B, it4B, K4_BYTES, cells)
    g, b = _rel_gap(xB, x4B), it4B.cpu().numpy()
    say("K4c", f"cold B={B}, same inputs: K4 {ms4B:.3f} ms, K4c {msB:.3f} ms: K4c {ms4B / msB:.2f}x faster; "
        f"K4c vs K4 per-sample gap max {g.max():.3e} ({int((g == 0).sum())} of {B} bit-identical); counts "
        f"mean {a.mean():.1f} vs {b.mean():.1f}, difference max {np.abs(a - b).max()}")
    if not torch.isfinite(x4B).all() or g.max() > 1e-3 or abs(a.mean() / b.mean() - 1) > 0.05:
        fail(f"K4c B={B} vs K4: gap {g.max():.3e} (gate 1e-3), mean counts {a.mean():.2f} vs {b.mean():.2f} "
             f"(5%)")
    del x4B

    # the cluster sizes beside the pick, at B = 8 (against the plain run) and 64
    for B, v, ref in ((8, v8, xp), (K4C_BATCHES[-1], v_all, xB)):
        t = {}
        for c in K.GRID_CLUSTERS:
            t[c], (xc, _) = _time_once_ms(
                lambda: K._launch_grid_cluster(v, F2d, None, (X0, Y0), cluster=c, **kw))
            g = _rel_gap(xc, ref).max()
            if not torch.isfinite(xc).all() or g > 1e-3:
                fail(f"K4c sweep B={B}, clusters of {c}: gap {g:.3e} from the reference run (gate 1e-3)")
        fastest = min(t, key=t.get)
        say("K4c", f"sweep B={B}: " + ", ".join(f"c={c} {ms:.3f} ms" for c, ms in t.items())
            + f"; grid_cluster picks {picks[B]}, the fastest is {fastest}: the pick is the fastest: "
            f"{picks[B] == fastest} (the pick at {t[picks[B]] / t[fastest]:.3f}x the fastest)")
    return dict(max_abs_err=max_abs, times=times)


def _numbers(rec):
    for v in rec.values():
        if isinstance(v, list):
            yield from v
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v


K5_RES, K5_B, K5_TILE = 8, 64, 8
K5_ITERS = 256  # the reference probe's iteration count
K5_GATE_FLOOR = 1e-4
K5_OTHER_RES = 16  # a mesh whose sample outgrows a cluster of 16 on an H100: K5's side of shift_route


def _k5_bound(B: int, n: int, n_iters: int) -> tuple[float, str]:
    """K5's and K5r's bound for one run: per iteration and node the 7-plane
    matvec (13), p.Ap, the x and r updates, z, r.z and the p update (11): 24
    float32 operations, and ~4 for the setup. Bytes: the (B, n, 7) values
    and F read once, x written once."""
    return _bound(4 * (7 * B * n + n + B * n), float(B) * n * (24 * n_iters + 4))


def _k5_entry(res: int) -> tuple[dict, int, int]:
    """shift_cost.main([res, tile]) with both kernels' counts set to 0 just
    before it and read just after: (its rows by use_rolls, K5r's launches,
    K5's launches)."""
    from bayesianinferencedl_tpu_torch.experimental import shift_cost as K5

    K5.launches = K5.r_launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        K5.main([str(res), str(K5_TILE)])
    counts = K5.r_launches, K5.launches
    rows = {r["use_rolls"]: r for r in (json.loads(line) for line in buf.getvalue().splitlines()
                                        if line.startswith("{"))}
    for r in rows.values():
        say("K5", json.dumps(r))
    if set(rows) != {True, False}:
        fail(f"shift_cost.main at res{res} printed {len(rows)} variants")
    return rows, *counts


def phase_k5(k3):
    """Phase 10 (the module docstring): K5r and K5 against their plain
    version at res8, K5 at res16; K5r's plan, cluster sweep and floor; then
    the entry point on both sides of the route."""
    import torch

    from bayesianinferencedl_tpu_torch.experimental import shift_cost as K5
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops._build import load_library
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform

    fin = FiveParamFin.create(resolution=K5_RES, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=2000)
    op = fin.op
    n, offsets, H = op.n, op.offsets, K5.halo(op.offsets)
    dev = op.device
    vals = op.vals(sample_log_uniform(torch.Generator(device="cuda").manual_seed(1), K5_B))

    # the route and the plan, beside the kernel's own count of its shared memory
    smem, cap = K5.shift_limits(dev, n, H)
    route, plan = K5.shift_route(n, offsets, smem, cap), K5.k5r_plan(n, offsets, K5_B, smem, cap)
    if route != "K5r" or plan is None:
        fail(f"K5r: shift_route names {route} at res{K5_RES} on this card ({smem} B a block, capacity {cap})")
    lib = load_library("shift_cost_cluster")
    lib.shift_cost_cluster_smem_bytes.restype = ctypes.c_longlong
    lib.shift_cost_cluster_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.shift_cost_cluster_threads.restype = ctypes.c_int
    lib.shift_cost_cluster_threads.argtypes = [ctypes.c_int] * 2
    own = lib.shift_cost_cluster_smem_bytes(n, plan["cluster"], H)
    own_threads = lib.shift_cost_cluster_threads(n, plan["cluster"])
    say("K5r", f"res{K5_RES} (n = {n}, offsets {offsets}, halo {H}), B={K5_B}: shift_route = {route}; "
        f"the card holds {cap} clusters of 1-16 blocks, {smem} B a block; k5r_plan: {plan}; "
        f"the kernel's own count {own} B, {own_threads} threads a block")
    if (own, own_threads) != (plan["smem"], plan["threads"]):
        fail(f"K5r: k5r_plan counts {plan['smem']} B and {plan['threads']} threads a block, the kernel "
             f"{own} B and {own_threads}")
    other = FiveParamFin.create(resolution=K5_OTHER_RES, biot=0.1, device="cuda", cg_tol=TOL,
                                cg_maxiter=2000).op
    smem16, cap16 = K5.shift_limits(dev, other.n, K5.halo(other.offsets))
    other_route = K5.shift_route(other.n, other.offsets, smem16, cap16)
    say("K5r", f"res{K5_OTHER_RES} (n = {other.n}): shift_route = {other_route} (capacity {cap16})")
    if other_route != "K5":
        fail(f"K5r: shift_route names {other_route} at res{K5_OTHER_RES}")

    # at res8 K5r (the wrapper's route) then K5, at res16 K5 (the route's
    # other side), each against the plain version on the same inputs
    why = ("a fixed-iteration f32 CG with no stop test keeps every rounding difference of its sums, so "
           "two float32 runs differ by about what each differs from the float64 one")
    max_abs = {"K5r": 0.0, "K5": 0.0}
    plain = {}
    rel = lambda a, b: (torch.linalg.norm(a.double() - b.double(), dim=1)
                        / torch.linalg.norm(b.double(), dim=1)).max().item()

    def check(name, xk, res, use_rolls, what, kernel="K5r"):
        xp, x64, gate = plain[res, use_rolls]
        r_kp, r_k64 = rel(xk, xp), rel(xk, x64)
        if not torch.isfinite(xk).all():
            fail(f"{name} at res{res}: non-finite output")
        max_abs[kernel] = max(max_abs[kernel], (xk - xp).abs().max().item())
        say("K5", f"{name}: res{res}, {'shifts' if use_rolls else 'no shifts'} on {what}, {K5_ITERS} "
            f"iterations, B={K5_B}: kernel vs plain max per-sample rel diff {r_kp:.3e}; kernel vs float64 "
            f"{r_k64:.3e}; gate {gate:.3e}")
        if r_kp > gate:
            fail(f"{name} at res{res}: kernel vs plain {r_kp:.3e} > {gate:.3e}")

    def hold(op, v_shift, res, kernel):
        """shift_cost at res on both variants, which must launch ``kernel``
        alone, against the plain version; at res8 K5 beside K5r."""
        # without the shifts the operator is the diagonal of A's row sums,
        # which cancel to rounding level off the convective boundary, so on
        # A's own planes the values are set by rounding from the second
        # iteration on (experimental/shift_cost.py); on |A|'s planes the row
        # sums are positive, the loop is a CG of an SPD diagonal operator,
        # and the comparison is as tight as with the shifts
        for use_rolls, v, what in ((True, v_shift, "A's planes"), (False, v_shift.abs(), "|A|'s planes")):
            kw = dict(offsets=op.offsets, n_iters=K5_ITERS, use_rolls=use_rolls)
            xp = K5.shift_cost_reference(v, op.F_root, **kw)
            x64 = K5.shift_cost_reference(v.double(), op.F_root.double(), **kw)
            r_p64 = rel(xp, x64)
            plain[res, use_rolls] = (xp, x64, max(K5_GATE_FLOOR, 3 * r_p64))
            say("K5", f"res{res}, {'shifts' if use_rolls else 'no shifts'} on {what}: plain float32 vs its "
                f"float64 run {r_p64:.3e}; gate max({K5_GATE_FLOOR:g}, 3x that) = "
                f"{plain[res, use_rolls][2]:.3e}: {why}")
            del x64
            before = K5.r_launches, K5.launches
            xk = K5.shift_cost(v, op.F_root, tile=K5_TILE, **kw)
            torch.cuda.synchronize()
            if (K5.r_launches - before[0], K5.launches - before[1]) != ((1, 0) if kernel == "K5r" else (0, 1)):
                fail(f"{kernel}: shift_cost on CUDA tensors at res{res} did not launch {kernel} alone")
            check(kernel, xk, res, use_rolls, what, kernel=kernel)
            if kernel == "K5r":
                xk = K5._launch(v.contiguous(), op.F_root, tile=K5_TILE, **kw)
                torch.cuda.synchronize()
                check("K5", xk, res, use_rolls, what, kernel="K5")

    hold(op, vals, K5_RES, "K5r")
    hold(other, other.vals(sample_log_uniform(torch.Generator(device="cuda").manual_seed(1), K5_B)),
         K5_OTHER_RES, "K5")
    plain = {k: v for k, v in plain.items() if k[0] == K5_RES}
    torch.cuda.empty_cache()

    # every cluster size that fits, with shifts, under the same gate; the
    # plan's pick beside the fastest
    kw = dict(offsets=offsets, n_iters=K5_ITERS, use_rolls=True)
    sweep = {}
    for c in K5.k5r_configs(n, offsets, smem, cap):
        clusters = min(cap[c], K5_B)
        run = lambda: K5._launch_r(vals, op.F_root, cluster=c, clusters=clusters, **kw)
        check(f"K5r c={c}", run(), K5_RES, True, "A's planes")
        sweep[c] = (_time_ms(run, 5), -(-K5_B // clusters))  # (ms, waves)
    pick = plan["cluster"]
    fastest = min(sweep, key=lambda k: sweep[k][0])
    say("K5r", "sweep at res8, B=64, with shifts: " + ", ".join(
        f"c={c} {ms:.4f} ms ({w} waves, {ms * 1e3 / (K5_ITERS * w):.4f} us per iteration per wave)"
        for c, (ms, w) in sweep.items())
        + f"; k5r_plan picks c={pick}, the fastest is c={fastest}: the pick is the fastest: {pick == fastest} "
        f"(the pick at {sweep[pick][0] / sweep[fastest][0]:.3f}x the fastest)")

    # the floor: the pick's launch with the per-node work removed, its two
    # reductions met over mbarriers as K5r meets them, then each closed by a
    # cluster barrier instead
    k_ms, waves = sweep[pick]
    it_us = k_ms * 1e3 / (K5_ITERS * waves)
    floors = {}
    for how in ("mbarrier", "cluster_barrier"):
        floors[how] = _time_ms(lambda: K5._launch_r(vals, op.F_root, cluster=pick, clusters=plan["clusters"],
                                                    floor=how, **kw), 5)
        say("K5r", f"floor ({how}: the reductions, no per-node work), c={pick}: "
            f"{floors[how]:.4f} ms, {floors[how] * 1e3 / (K5_ITERS * waves):.4f} us per iteration per wave "
            f"against the kernel's {it_us:.4f}: {100 * floors[how] / k_ms:.1f}% of an iteration")

    # the main path: the probe's entry point, K5r's side of the route, then K5's
    rows, r_launches, k5_launches = _k5_entry(K5_RES)
    say("K5", f"entry point at res{K5_RES}: launches K5r {r_launches}, K5 {k5_launches}")
    if r_launches < 2 or k5_launches != 0:
        fail(f"K5r: the entry point at res{K5_RES} made {r_launches} K5r and {k5_launches} K5 launches")
    rows16, r16, k16 = _k5_entry(K5_OTHER_RES)
    say("K5", f"entry point at res{K5_OTHER_RES}: launches K5r {r16}, K5 {k16}")
    if k16 < 2 or r16 != 0:
        fail(f"K5: the entry point at res{K5_OTHER_RES} made {r16} K5r and {k16} K5 launches")
    us_s, us_n = rows[True]["per_tile_iter_us"], rows[False]["per_tile_iter_us"]
    t3 = k3["times"][B_CHECK]
    k3r_us = t3["ms"] * 1e3 / t3["iters_mean"]
    w_s, w_n = (rows[v]["total_s"] * 1e6 / (K5_ITERS * waves) for v in (True, False))
    say("K5", f"shift cost on K5r at res{K5_RES}, B={K5_B}: per tile-iteration (the reference's division) "
        f"shifts {us_s:.4f} us, no shifts {us_n:.4f} us, shift cost {us_s - us_n:.4f} us "
        f"({100 * (us_s - us_n) / us_s:.1f}%); per iteration per wave {w_s:.4f} / {w_n:.4f} us; K3r deflated "
        f"at res8, B={B_CHECK} (phase 5): {k3r_us:.3f} us per batch iteration, "
        f"{k3r_us / (B_CHECK // 8):.4f} us per tile-iteration in the reference's division")

    vals2 = op.vals(sample_log_uniform(torch.Generator(device="cuda").manual_seed(2), K5_B))
    p_ms, _ = _time_once_ms(lambda: K5.shift_cost_reference(vals2, op.F_root, **kw))
    k5_ms, _ = _time_once_ms(lambda: K5._launch(vals2, op.F_root, tile=K5_TILE, **kw))
    ms = rows[True]["total_s"] * 1e3
    bound = _k5_bound(K5_B, n, K5_ITERS)
    say("K5", f"shifts, {K5_ITERS} iterations: K5r {ms:.3f} ms, K5 {k5_ms:.3f} ms ({k5_ms / ms:.1f}x), plain "
        f"torch {p_ms:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}), K5r at {100 * bound[0] / ms:.2f}% of "
        f"it, K5 at {100 * bound[0] / k5_ms:.3f}%")
    # launches: both entry-point runs (res8 on K5r, res16 on K5)
    return dict(r=dict(launches=r_launches + r16, max_abs_err=max_abs["K5r"], ms=ms, plain_ms=p_ms, bound=bound),
                k5=dict(launches=k5_launches + k16, max_abs_err=max_abs["K5"], ms=k5_ms, plain_ms=p_ms,
                        bound=bound))


PT_TEMPS, PT_LAMBDA_MIN = 4, 0.05  # (a) and (c): a 4-level geometric start from 0.05
PT_A = dict(n_steps=1200, n_burn=400)  # (a): cut from 4,000 / 1,000 for the time limit
PT_HEAD = dict(n_chains=4096, n_temps=5, lambda_min=0.05, noise_sigma=1e-3, n_steps=1000,
               n_burn=400)  # (b): bench.py's headline, cut from 15,000 / 2,000 steps
PT_DA = dict(n_chains=256, n_steps=14, n_burn=4, subchain=64)  # (c): 256 x 4 = 1,024 fine solves
PT_DA_SEGMENT = 32  # run_inversion's segment for pt_da_pcn on fom
FOM_PCN = dict(n_chains=1024, n_steps=96, n_burn=48)  # (d)
FOM_PCN_SEGMENT = 64  # run_inversion's segment for pcn on fom
NOISE_RUN = dict(n_steps=600, n_burn=200)  # (e): cut from 1,000 / 300
PT_PARTS_REPS = 50  # timed repetitions of each part of a PT step


def _with_mcmc(pipe, **mcmc):
    """pipe with its MCMCConfig fields replaced (the build is shared)."""
    import dataclasses

    cfg = pipe.config
    return dataclasses.replace(pipe, config=dataclasses.replace(
        cfg, mcmc=dataclasses.replace(cfg.mcmc, **mcmc)))


def _pt_gates(tag, inv):
    """The gates every tempered run holds: finite outputs, every swap rate in
    (0, 1), a ladder rising strictly and ending at exactly 1 in every chain
    group, a finite log Z and std. Returns the mean ladder and swap rates."""
    import torch

    res = inv.result
    for name, t in (("samples", res.samples), ("phi", res.phi_trace), ("ess", inv.ess),
                    ("rhat", inv.rhat), ("lambdas", res.lambdas), ("swap_rate", res.swap_rate)):
        if not torch.isfinite(t).all():
            fail(f"{tag}: non-finite {name}")
    swap = res.swap_rate.double().cpu().numpy()
    if not (np.all(swap > 0) and np.all(swap < 1)):
        fail(f"{tag}: swap rates {swap.tolist()} not all in (0, 1)")
    lam = res.lambdas
    if not (bool((torch.diff(lam, dim=0) > 0).all()) and bool((lam[-1] == 1).all())):
        fail(f"{tag}: the ladder does not rise strictly to exactly 1 in every chain group")
    if not (np.isfinite(inv.log_evidence) and np.isfinite(inv.log_evidence_std)):
        fail(f"{tag}: log Z {inv.log_evidence} +- {inv.log_evidence_std}")
    return lam.mean(1).double().cpu().numpy(), swap


def _pt_step_parts(pipe, inv):
    """Where the time of a pt_pcn step goes, at the run's shapes and final
    state: each part timed alone by CUDA events over PT_PARTS_REPS calls
    (host-bound parts included): the within-level move (pcn_step over K*G
    states) and its batched misfit alone, the exchange pass, the ladder's
    update and rebuild, and the level accumulators. Returns us per call."""
    import torch

    from bayesianinferencedl_tpu_torch.infer import tempering as T
    from bayesianinferencedl_tpu_torch.infer.pcn import PCNState, gaussian_misfit, pcn_step

    mc, res = pipe.config.mcmc, inv.result
    K, G, d = res.theta.shape
    dev = res.theta.device
    misfit = gaussian_misfit(pipe.batched_forward_fn("rom_nn"), inv.data, mc.noise_sigma)
    phi_all = lambda th: misfit(th.reshape(K * G, d)).reshape(K, G)
    lam, beta = res.lambdas, res.beta
    state = PCNState(theta=res.theta, phi=phi_all(res.theta),
                     n_accept=torch.zeros((K, G), dtype=torch.int32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(mc.seed + 5)
    plans = [T._exchange_plan(K, p, dev) for p in (0, 1)]
    n_swap = torch.zeros((K - 1,), dtype=lam.dtype, device=dev)
    log_gap = torch.log(torch.diff(torch.log(lam), dim=0))
    stats = (lam, torch.ones((K, 1), dtype=lam.dtype, device=dev))
    acc = T._Accumulators(state.phi)
    u_sw = torch.rand((K, G), generator=gen, dtype=lam.dtype, device=dev)
    us = lambda fn: _time_ms(fn, PT_PARTS_REPS) * 1e3
    return {
        "move": us(lambda: pcn_step(phi_all, pipe.prior, beta, state, gen, lam=lam)),
        "misfit": us(lambda: phi_all(state.theta)),
        "exchange": us(lambda: T._replica_exchange(
            7.0, lam, state.phi, (state.theta, state.phi), u_sw, n_swap, True, plans)),
        "ladder": us(lambda: T._lam_from_gaps(T._ladder_update(log_gap, stats, 0, 7.0, 1))),
        "accumulators": us(lambda: acc.add(lam, state.phi)),
    }


def phase_pt(pipe4, inv4, pipe8, inv8):
    """Phase 11: the tempered samplers, pcn on the fom likelihood and the
    unknown-noise potential, each through run_inversion on the card, on the
    builds and data of phases 3 (res4) and 6 (res8). Returns K3r's launches
    over the phase and (a)'s result."""
    import torch

    from bayesianinferencedl_tpu_torch.api import run_inversion
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    def counted(pipe, ref, **mcmc):
        """run_inversion on ref's data (or, with ref = None, data simulated
        at phase 3's truth) with every FOM kernel's count set to 0 just
        before and read just after."""
        data, truth = (None, inv4.theta_true) if ref is None else (ref.data, ref.theta_true)
        K.launches = K.tile_launches = K.tile_mma_launches = 0
        out = run_inversion(_with_mcmc(pipe, **mcmc), data=data, theta_true=truth)
        torch.cuda.synchronize()
        return out, {"K3r": K.tile_mma_launches, "K3": K.tile_launches, "K1": K.launches}

    def fom_gates(tag, inv, n, steps, segment):
        """K3r carries every fom solve (>= one a step and one a segment's
        start), K3 and K1 none; no audited state at the iteration cap."""
        n_seg = -(-steps // segment)
        say("PT", f"{tag}: launches K3r {n['K3r']} (outer steps + segments = {steps + n_seg}), K3 "
            f"{n['K3']}, K1 {n['K1']}; iteration audit cap {inv.fom_iter_cap}, max "
            f"{inv.fom_iter_max}, at cap {inv.fom_hit_cap_frac}")
        if n["K3r"] < steps + n_seg or n["K3"] or n["K1"]:
            fail(f"{tag}: K3r did not carry every fom solve alone")
        if inv.fom_hit_cap_frac != 0:
            fail(f"{tag}: {inv.fom_hit_cap_frac:.2%} of audited states hit the FOM iteration cap")

    k3r = 0
    # (a) pt_pcn against phase 3's pcn on its data: the unimodal posterior
    inv_a, n_a = counted(pipe4, inv4, sampler="pt_pcn", n_temps=PT_TEMPS, lambda_min=PT_LAMBDA_MIN,
                         adapt_ladder=True, **PT_A)
    lam_a, swap_a = _pt_gates("(a)", inv_a)
    means, sds, z, sd_rel, rhats = _posterior_z(inv_a.result.samples, inv4.result.samples)
    say("PT", f"(a) pt_pcn rom_nn, {inv_a.result.samples.shape[1]} chains x {PT_TEMPS} levels, "
        f"{PT_A['n_steps']} steps ({PT_A['n_burn']} burn-in): {inv_a.wall_seconds:.3f} s, "
        f"{inv_a.wall_seconds / PT_A['n_steps'] * 1e6:.1f} us/step, "
        f"{inv_a.samples_per_sec:.1f} cold samples/s; launches {n_a}")
    say("PT", f"(a) cold-level mean {np.round(means[0], 4).tolist()} vs pcn "
        f"{np.round(means[1], 4).tolist()}; |diff| / MCSE {np.round(z, 2).tolist()}; sd "
        f"{np.round(sds[0], 4).tolist()} vs {np.round(sds[1], 4).tolist()}; split-rhat max "
        f"{rhats[0]:.4f} vs {rhats[1]:.4f}")
    say("PT", f"(a) mean ladder {np.round(lam_a, 5).tolist()}; swap rates "
        f"{np.round(swap_a, 4).tolist()}; log Z {inv_a.log_evidence:.4f} +- "
        f"{inv_a.log_evidence_std:.4f}; accept by level "
        f"{np.round(inv_a.result.accept_rate.mean(1).double().cpu().numpy(), 4).tolist()}")
    if z.max() > K2_MEAN_GATE:
        fail(f"(a): cold-level means {z.max():.2f} Monte-Carlo errors from pcn's")
    if sd_rel.max() > K2_SD_GATE:
        fail(f"(a): cold-level sd {100 * sd_rel.max():.1f}% from pcn's")

    # (b) the headline's configuration (bench.py b_pt_headline), its steps cut
    inv_b, n_b = counted(pipe4, None, sampler="pt_pcn", adapt_ladder=True, **PT_HEAD)
    k3r += n_b["K3r"]
    lam_b, swap_b = _pt_gates("(b)", inv_b)
    step_us = inv_b.wall_seconds / PT_HEAD["n_steps"] * 1e6
    rhat_b = float(inv_b.rhat.max())
    say("PT", f"(b) headline pt_pcn rom_nn noise {PT_HEAD['noise_sigma']:g}: {PT_HEAD['n_chains']} "
        f"chains x {PT_HEAD['n_temps']} levels, {PT_HEAD['n_steps']} steps ({PT_HEAD['n_burn']} "
        f"burn-in): {inv_b.wall_seconds:.3f} s, {step_us:.1f} us/step, {inv_b.samples_per_sec:.1f} "
        f"cold samples/s, min bulk ESS/s {inv_b.ess_per_sec:.2f} (bulk ESS min "
        f"{inv_b.ess.min().item():.1f}); split-rhat max {rhat_b:.4f} against the reference's "
        f"{RHAT_GATE}: {'pass' if rhat_b <= RHAT_GATE else 'fail'} (printed, not gated); launches "
        f"{n_b}")
    say("PT", f"(b) mean ladder {np.round(lam_b, 5).tolist()}; swap rates "
        f"{np.round(swap_b, 4).tolist()}; log Z {inv_b.log_evidence:.4f} +- "
        f"{inv_b.log_evidence_std:.4f}; cold accept "
        f"{float(inv_b.result.accept_rate[-1].mean()):.4f}; posterior mean "
        f"{np.round(inv_b.result.samples.mean(dim=(0, 1)).double().cpu().numpy(), 4).tolist()} vs "
        f"truth {np.round(inv_b.theta_true.double().cpu().numpy(), 4).tolist()}")
    parts = _pt_step_parts(_with_mcmc(pipe4, **PT_HEAD), inv_b)
    say("PT", f"(b) a step's parts, each alone over {PT_PARTS_REPS} calls at these shapes (us): "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"; as shares of the run's {step_us:.1f} us/step: move "
        f"{100 * parts['move'] / step_us:.1f}% (its misfit {100 * parts['misfit'] / step_us:.1f}%), "
        f"exchange {100 * parts['exchange'] / step_us:.1f}%, ladder "
        f"{100 * parts['ladder'] / step_us:.1f}%, accumulators "
        f"{100 * parts['accumulators'] / step_us:.1f}%")

    # (c) pt_da_pcn on fom at res8, on phase 6's data
    inv_c, n_c = counted(pipe8, inv8, sampler="pt_da_pcn", likelihood="fom", n_temps=PT_TEMPS,
                         lambda_min=PT_LAMBDA_MIN, **PT_DA)
    k3r += n_c["K3r"]
    lam_c, swap_c = _pt_gates("(c)", inv_c)
    res_c = inv_c.result
    outer, inner = float(res_c.accept_rate[-1].mean()), float(res_c.inner_accept_rate[-1].mean())
    say("PT", f"(c) pt_da_pcn fom res8, {PT_DA['n_chains']} chains x {PT_TEMPS} levels (fine batch "
        f"{PT_DA['n_chains'] * PT_TEMPS}), subchain {PT_DA['subchain']}, {PT_DA['n_steps']} outer "
        f"steps ({PT_DA['n_burn']} burn-in), segment {PT_DA_SEGMENT}: {inv_c.wall_seconds:.3f} s, "
        f"{inv_c.wall_seconds / PT_DA['n_steps'] * 1e3:.1f} ms per outer step; cold outer accept "
        f"{outer:.4f}, inner {inner:.4f}; swap rates {np.round(swap_c, 4).tolist()}; mean ladder "
        f"{np.round(lam_c, 5).tolist()}; log Z {inv_c.log_evidence:.4f} +- "
        f"{inv_c.log_evidence_std:.4f}; fine evaluations {res_c.n_fine_evals}")
    fom_gates("(c)", inv_c, n_c, PT_DA["n_steps"], PT_DA_SEGMENT)
    if not outer > 0.6:
        fail(f"(c): cold outer accept {outer:.4f} not above 0.6")
    if not 0.05 < inner < 0.9:
        fail(f"(c): cold inner accept {inner:.4f} outside (0.05, 0.9)")

    # (d) pcn on fom at res8, on phase 6's data
    inv_d, n_d = counted(pipe8, inv8, sampler="pcn", likelihood="fom", **FOM_PCN)
    k3r += n_d["K3r"]
    res_d = inv_d.result
    for name, t in (("samples", res_d.samples), ("phi", res_d.phi_trace), ("ess", inv_d.ess),
                    ("rhat", inv_d.rhat)):
        if not torch.isfinite(t).all():
            fail(f"(d): non-finite {name}")
    acc_d = float(res_d.accept_rate.mean())
    say("PT", f"(d) pcn fom res8, {FOM_PCN['n_chains']} chains, {FOM_PCN['n_steps']} steps "
        f"({FOM_PCN['n_burn']} burn-in), segment {FOM_PCN_SEGMENT}: {inv_d.wall_seconds:.3f} s, "
        f"{inv_d.wall_seconds / FOM_PCN['n_steps'] * 1e3:.1f} ms/step; accept {acc_d:.4f}; split-rhat "
        f"max {float(inv_d.rhat.max()):.4f}")
    fom_gates("(d)", inv_d, n_d, FOM_PCN["n_steps"], FOM_PCN_SEGMENT)
    if not 0.05 < acc_d < 0.9:
        fail(f"(d): accept rate {acc_d:.4f} outside (0.05, 0.9)")
    means, _, z, _, _ = _posterior_z(res_d.samples, inv8.result.samples)
    say("PT", f"(d) posterior mean pcn fom {np.round(means[0], 4).tolist()} vs phase 6's da_pcn "
        f"{np.round(means[1], 4).tolist()}: |diff| / MCSE {np.round(z, 2).tolist()} (printed, not "
        f"gated: {FOM_PCN['n_steps'] - FOM_PCN['n_burn']} kept steps); (c)'s cold level "
        f"{np.round(res_c.samples.mean(dim=(0, 1)).double().cpu().numpy(), 4).tolist()} with log Z "
        f"{inv_c.log_evidence:.4f}")

    # (e) infer_noise: pcn on phase 3's data with the noise integrated out
    inv_e, n_e = counted(pipe4, inv4, sampler="pcn", infer_noise=True, **NOISE_RUN)
    res_e, post = inv_e.result, inv_e.noise_sigma_post
    for name, t in (("samples", res_e.samples), ("phi", res_e.phi_trace), ("ess", inv_e.ess),
                    ("rhat", inv_e.rhat)):
        if not torch.isfinite(t).all():
            fail(f"(e): non-finite {name}")
    q = (post["sigma_q05"], post["sigma_q50"], post["sigma_q95"])
    say("PT", f"(e) pcn rom_nn infer_noise, {res_e.samples.shape[1]} chains, {NOISE_RUN['n_steps']} "
        f"steps ({NOISE_RUN['n_burn']} burn-in): {inv_e.wall_seconds:.3f} s; accept "
        f"{float(res_e.accept_rate.mean()):.4f}; sigma q05/q50/q95 "
        f"{' / '.join(f'{v:.5f}' for v in q)} (mean {post['sigma_mean']:.5f}) beside the true "
        f"{pipe4.config.mcmc.noise_sigma:g}; shape-PPC p {inv_e.ppc['p_value']:.3f}; launches {n_e}")
    if not all(np.isfinite(v) for v in post.values() if isinstance(v, float)):
        fail(f"(e): non-finite noise posterior {post}")
    if not q[0] < q[1] < q[2]:
        fail(f"(e): sigma quantiles {q} not ordered")
    say("PT", f"K3r launches over phase 11: {k3r} ((b)'s truth solve {n_b['K3r']}, (c) {n_c['K3r']}, "
        f"(d) {n_d['K3r']})")
    return k3r, inv_a, inv_b


# phase 12: the Laplace and gradient-sampler layer (its steps cut for the time limit)
# (a) bench.py's cfg_mh (bench.py:766) runs 15,000 / 2,000 steps
P12_LAP_MH = dict(n_chains=4096, n_steps=600, n_burn=200)
P12_MALA_LAP = dict(n_chains=4096, n_steps=300, n_burn=110)  # (b): bench.py's mala_lap block
P12_GPCN = dict(n_chains=1024, n_steps=450, n_burn=200)  # (c)
P12_MALA = dict(n_chains=1024, n_steps=350, n_burn=150)  # (c)
P12_HMC = dict(n_chains=1024, n_steps=45, n_burn=20, hmc_leap=8)  # (c): 8 gradients a step
P12_CHEES = dict(n_chains=1024, n_steps=120, n_burn=60, hmc_leap=0)  # (c): hmc_lap, ChEES
P12_PT = dict(n_chains=1024, n_temps=4, lambda_min=0.05, n_steps=350, n_burn=150)  # (d)
P12_DA = dict(n_chains=1024, subchain=64, n_steps=12, n_burn=5)  # (e)
P12_DA_SEGMENT = 64  # run_inversion's segment for da_pcn on fom
P12_GPCN_FOM = dict(n_chains=256, n_steps=200, n_burn=50)  # (f)
P12_LOGZ_GATE = 4.0  # (d): |log Z - phase 11 (a)'s| in combined standard deviations
P12_FD = dict(rom_nn=(1e-5, 1e-6), fom=(1e-4, 1e-5))  # (g): central-difference step, relative gate


def _p12_moments(tag, inv, ref, acc_range=None, phase="P12"):
    """A cell's gates against phase 3's pcn posterior (phase 4's): finite
    outputs, the means within K2_MEAN_GATE combined MCSE, the sds within
    K2_SD_GATE, and the accept rate in acc_range = (lo, hi], if given.
    Prints the run's time, samples/s, bulk ESS/s and split-R-hat."""
    import torch

    res = inv.result
    for name, t in (("samples", res.samples), ("ess", inv.ess), ("rhat", inv.rhat),
                    ("accept", res.accept_rate)):
        if not torch.isfinite(t).all():
            fail(f"{tag}: non-finite {name}")
    means, sds, z, sd_rel, rhats = _posterior_z(res.samples, ref.result.samples)
    acc = float(res.accept_rate.mean())
    T, C, _ = res.samples.shape
    say(phase, f"{tag}: {C} chains, {T} kept: {inv.wall_seconds:.3f} s, {inv.samples_per_sec:.1f} "
        f"samples/s, bulk ESS/s {inv.ess_per_sec:.2f} (bulk ESS min {inv.ess.min().item():.1f}), "
        f"split-rhat max {rhats[0]:.4f} (pcn's {rhats[1]:.4f}); accept {acc:.4f}")
    say(phase, f"{tag}: mean {np.round(means[0], 4).tolist()} vs pcn {np.round(means[1], 4).tolist()}; "
        f"|diff| / MCSE {np.round(z, 2).tolist()}; sd {np.round(sds[0], 4).tolist()} vs "
        f"{np.round(sds[1], 4).tolist()}")
    if z.max() > K2_MEAN_GATE:
        fail(f"{tag}: means {z.max():.2f} Monte-Carlo errors from pcn's")
    if sd_rel.max() > K2_SD_GATE:
        fail(f"{tag}: sd {100 * sd_rel.max():.1f}% from pcn's")
    if acc_range is not None and not acc_range[0] < acc <= acc_range[1]:
        fail(f"{tag}: accept {acc:.4f} outside ({acc_range[0]}, {acc_range[1]}]")


def _p12_fd_check(pipe4):
    """(g): the differentiable rom_nn and fom forwards in float64 on the
    card, their misfit gradients against central differences. rom_nn on a
    float64 copy of phase 3's reduced model and surrogate with the reduced
    PCG at r iterations, where the fixed-iteration solve is exact to
    rounding (at fewer, the forward is not the exact solve whose implicit
    derivative the backward takes); fom on a float64 res4 fin at tol 1e-10,
    one solve and its adjoint. Returns the relative errors."""
    import dataclasses

    import torch

    from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
    from bayesianinferencedl_tpu_torch.infer.optimize import value_and_grad
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit

    rom, sur = pipe4.rom, pipe4.surrogate
    arrays = {f: getattr(rom, f).double().cpu().numpy() for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V")}
    arrays["P0"] = pipe4.P0.double().cpu().numpy()
    arrays["rom_pcg_iters"] = rom.r
    for i, (W, b) in enumerate(sur.params):
        arrays[f"W{i}"], arrays[f"b{i}"] = W.double().cpu().numpy(), b.double().cpu().numpy()
    arrays.update({f: getattr(sur.norm, f).double().cpu().numpy()
                   for f in ("x_mean", "x_std", "y_mean", "y_std")})
    cfg = pipe4.config
    cfg64 = dataclasses.replace(cfg, fem=dataclasses.replace(cfg.fem, cg_tol=1e-10, cg_maxiter=4000))
    p64 = pipeline_from_arrays(cfg64, arrays, device="cuda", dtype=torch.float64)
    gen = torch.Generator(device="cuda").manual_seed(12)
    theta = p64.prior.sample(gen)
    data = p64.batched_forward_fn("rom_nn")(p64.prior.sample(gen)[None])[0]
    errs = {}
    for like, (h, gate) in P12_FD.items():
        misfit = gaussian_misfit(p64.batched_forward_fn(like, differentiable=True), data, 1e-2)
        _, g = value_and_grad(misfit, theta[None])
        eye = torch.eye(5, dtype=torch.float64, device="cuda")
        with torch.no_grad():
            fd = (misfit(theta + h * eye) - misfit(theta - h * eye)) / (2 * h)
        err = float(torch.linalg.norm(g[0] - fd) / torch.linalg.norm(fd))
        errs[like] = err
        say("P12", f"(g) {like} float64 gradient vs central differences (h {h:g}): relative error "
            f"{err:.3e} (gate {gate:g}); |grad| {float(torch.linalg.norm(fd)):.4e}")
        if not err <= gate:
            fail(f"(g): the {like} gradient is {err:.3e} from central differences")
    return errs


def _p12_f7(pipe4, inv4):
    """(h): with the caller's setting "high" (TF32 in every matmul it does
    not pin), the pinned values must equal those at "highest" bit for bit:
    pipe.fin.forward, batched_forward_fn("rom_nn"), the differentiable
    forward and its gradient, and the Laplace approximation built on J^T J.
    An unpinned product is computed too, to show that TF32 is on. Leaves
    the setting at "high" for the cells that follow."""
    import torch

    from bayesianinferencedl_tpu_torch.infer.map import _jacobian, laplace_approximation
    from bayesianinferencedl_tpu_torch.infer.optimize import value_and_grad
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit

    gen = torch.Generator(device="cuda").manual_seed(13)
    ths = pipe4.prior.sample(gen, (1024,))
    fd = pipe4.batched_forward_fn("rom_nn", differentiable=True)
    misfit = gaussian_misfit(fd, inv4.data, 1e-2)
    x, w = torch.randn(1024, 40, device="cuda", generator=gen), torch.randn(40, 40, device="cuda",
                                                                             generator=gen)

    def values():
        lap = laplace_approximation(fd, inv4.data, 1e-2, pipe4.prior, ths[0])
        return {
            "fin.forward": pipe4.fin.forward(torch.exp(inv4.theta_true)),
            "batched_forward_fn(rom_nn)": pipe4.batched_forward_fn("rom_nn")(ths),
            "differentiable forward": fd(ths).detach(),
            "its gradient": value_and_grad(misfit, ths)[1],
            "Laplace J": _jacobian(fd, ths[0], 5),
            "Laplace cov": lap.cov,
            "unpinned x @ w": x @ w,
        }

    torch.set_float32_matmul_precision("highest")
    ref = values()
    torch.set_float32_matmul_precision("high")
    got = values()
    same = {k: bool(torch.equal(ref[k], got[k])) for k in ref}
    say("P12", "(h) under set_float32_matmul_precision('high'), bit-identical to 'highest': "
        + ", ".join(f"{k} {v}" for k, v in same.items()))
    if same["unpinned x @ w"]:
        fail("(h): an unpinned matmul is bit-identical under 'high': TF32 is not on, the check is void")
    bad = [k for k, v in same.items() if not v and k != "unpinned x @ w"]
    if bad:
        fail(f"(h): {bad} changed under the caller's TF32 setting")


def phase_gradient(pipe4, inv4, pipe8, inv8, inv_pt):
    """Phase 12: the Laplace and gradient-sampler layer through run_inversion
    on the card, on phase 3's res4 build and data (the rom_nn posterior at
    noise 1e-2 that its pcn sampled) and phase 6's res8 build and data.
    Runs (h) first and keeps the caller's setting at "high" for the cells.
    Returns K3r's launches over the phase."""
    import torch

    from bayesianinferencedl_tpu_torch.api import run_inversion
    from bayesianinferencedl_tpu_torch.infer.map import laplace_approximation
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit
    from bayesianinferencedl_tpu_torch.infer.samplers import run_gpcn
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    import bayesianinferencedl_tpu_torch.api as api

    t_phase = time.perf_counter()
    _p12_f7(pipe4, inv4)
    # the Laplace-seeded cells all run on phase 3's build, data and seed, so
    # each would find the same MAP: the first cell's is computed (and timed),
    # the others reuse it, its event logged again
    map_laplace, shared = api._map_laplace, {}

    def shared_map(pipe, like, mk_misfit, data, b0, gen, log):
        if like not in shared:
            lap = map_laplace(pipe, like, mk_misfit, data, b0, gen, log)
            shared[like] = (lap, {k: v for k, v in log.summary()["map"].items() if k not in ("event", "t")})
        else:
            with log.timer("map_laplace"):
                pass
            log.log("map", **shared[like][1])
        return shared[like][0]

    api._map_laplace = shared_map

    def counted(pipe, ref, **mcmc):
        """run_inversion on ref's data and truth, every FOM kernel's count
        set to 0 just before and read just after; the caller's "high" must
        survive it."""
        K.launches = K.tile_launches = K.tile_mma_launches = 0
        log = MetricsLogger()
        t0 = time.perf_counter()
        out = run_inversion(_with_mcmc(pipe, **mcmc), data=ref.data, theta_true=ref.theta_true,
                            metrics=log)
        torch.cuda.synchronize()
        n = {"K3r": K.tile_mma_launches, "K3": K.tile_launches, "K1": K.launches}
        if torch.get_float32_matmul_precision() != "high":
            fail(f"run_inversion({mcmc.get('sampler')}) reset the caller's matmul precision to "
                 f"{torch.get_float32_matmul_precision()!r}")
        return out, n, log.summary(), time.perf_counter() - t0

    def laplace_line(tag, s, total):
        m = s["map"]
        say("P12", f"{tag}: MAP nlp {m['nlp']:.4f} at {np.round(m['theta_map'], 4).tolist()}; "
            f"map_laplace {s['map_laplace']['seconds']:.2f} s of the call's {total:.2f} s")

    k3r = 0
    # (a) laplace_mh at the bench's width
    inv, n, s, total = counted(pipe4, inv4, sampler="laplace_mh", **P12_LAP_MH)
    k3r += n["K3r"]
    laplace_line("(a) laplace_mh", s, total)
    _p12_moments("(a) laplace_mh", inv, inv4, (0.05, 1.0))
    # (b) mala_lap at the same width
    inv, n, s, total = counted(pipe4, inv4, sampler="mala_lap", **P12_MALA_LAP)
    k3r += n["K3r"]
    laplace_line("(b) mala_lap", s, total)
    _p12_moments("(b) mala_lap", inv, inv4, (0.3, 0.85))
    say("P12", f"(b) adapted step sizes h: median {float(inv.result.step.median()):.4f}")
    # (c) the other gradient samplers at 1,024 chains
    for smp, kw in (("gpcn", P12_GPCN), ("mala", P12_MALA), ("hmc", P12_HMC),
                    ("hmc_lap", P12_CHEES)):
        inv, n, s, total = counted(pipe4, inv4, sampler=smp, **kw)
        k3r += n["K3r"]
        tag = f"(c) {smp}" + (f" n_leap {P12_HMC['hmc_leap']}" if smp == "hmc" else "")
        if "map" in s:
            laplace_line(tag, s, total)
        if smp == "hmc_lap":
            c = s["chees"]
            say("P12", f"(c) hmc_lap ChEES picks n_leap {c['n_leap']} of {c['candidates']}; chees "
                f"per gradient {np.round(c['chees_per_grad'], 4).tolist()}; accept "
                f"{np.round(c['accept'], 3).tolist()}")
        _p12_moments(tag, inv, inv4)
        say("P12", f"{tag}: the call took {total:.2f} s")

    # (d) pt_mala against pcn, and its log Z against phase 11 (a)'s pt_pcn
    inv, n, s, total = counted(pipe4, inv4, sampler="pt_mala", adapt_ladder=True, **P12_PT)
    lam, swap = _pt_gates("(d) pt_mala", inv)
    _p12_moments("(d) pt_mala cold level", inv, inv4)
    dz = abs(inv.log_evidence - inv_pt.log_evidence)
    sz = float(np.hypot(inv.log_evidence_std, inv_pt.log_evidence_std))
    say("P12", f"(d) pt_mala {P12_PT['n_chains']} x {P12_PT['n_temps']}: swap rates "
        f"{np.round(swap, 4).tolist()}; mean ladder {np.round(lam, 5).tolist()}; log Z "
        f"{inv.log_evidence:.4f} +- {inv.log_evidence_std:.4f} vs phase 11 (a)'s pt_pcn "
        f"{inv_pt.log_evidence:.4f} +- {inv_pt.log_evidence_std:.4f}: {dz / sz:.2f} combined sds; "
        f"{inv.wall_seconds / P12_PT['n_steps'] * 1e3:.2f} ms a step")
    if not dz <= P12_LOGZ_GATE * sz:
        fail(f"(d): log Z {dz / sz:.2f} combined sds from phase 11 (a)'s")

    # (e) da_pcn with MALA subchains on fom at res8, phase 6's data
    inv, n, s, total = counted(pipe8, inv8, sampler="da_pcn", likelihood="fom", da_inner="mala",
                               **P12_DA)
    k3r += n["K3r"]
    res = inv.result
    outer, inner = float(res.accept_rate.mean()), float(res.inner_accept_rate.mean())
    n_seg = -(-P12_DA["n_steps"] // P12_DA_SEGMENT)
    say("P12", f"(e) da_pcn --da-inner mala fom res8, {P12_DA['n_chains']} chains, subchain "
        f"{P12_DA['subchain']}, {P12_DA['n_steps']} outer steps ({P12_DA['n_burn']} burn-in): "
        f"{inv.wall_seconds:.3f} s, {inv.wall_seconds / P12_DA['n_steps'] * 1e3:.1f} ms an outer step; "
        f"outer accept {outer:.4f}, inner {inner:.4f}; adapted h median "
        f"{float(res.beta.median()):.4f}; launches K3r {n['K3r']} (outer steps + segments = "
        f"{P12_DA['n_steps'] + n_seg}), K3 {n['K3']}, K1 {n['K1']}; audit cap {inv.fom_iter_cap}, max "
        f"{inv.fom_iter_max}, at cap {inv.fom_hit_cap_frac}")
    if n["K3r"] < P12_DA["n_steps"] + n_seg or n["K3"] or n["K1"]:
        fail("(e): K3r did not carry every fine solve alone")
    if not outer > 0.6:
        fail(f"(e): outer accept {outer:.4f} not above 0.6")
    if not 0.05 < inner < 0.9:
        fail(f"(e): inner accept {inner:.4f} outside (0.05, 0.9)")
    if inv.fom_hit_cap_frac != 0:
        fail(f"(e): {inv.fom_hit_cap_frac:.2%} of audited states hit the FOM iteration cap")
    means, _, z, _, _ = _posterior_z(res.samples, inv8.result.samples)
    say("P12", f"(e) mean {np.round(means[0], 4).tolist()} vs phase 6's da_pcn "
        f"{np.round(means[1], 4).tolist()}: |diff| / MCSE {np.round(z, 2).tolist()}")
    if z.max() > K2_MEAN_GATE:
        fail(f"(e): mean {z.max():.2f} Monte-Carlo errors from phase 6's da_pcn")

    # (f) gpcn on fom at res4: one K3r launch a step. Through the entry
    # points, with the Gauss-Newton Laplace approximation of the rom_nn
    # posterior at phase 3's pcn mean as the reference measure (any Gaussian
    # one keeps gpCN exact): run_inversion would take the fom MAP on the
    # differentiable plain PCG, ~600 s on an H100 (PERF.md)
    fd = pipe4.batched_forward_fn("rom_nn", differentiable=True)
    sigma = pipe4.config.mcmc.noise_sigma
    lap = laplace_approximation(fd, inv4.data, sigma, pipe4.prior, inv4.result.samples.mean(dim=(0, 1)))
    gen = torch.Generator(device="cuda").manual_seed(14)
    theta0 = lap.sample(gen, (P12_GPCN_FOM["n_chains"],))
    misfit_fom = gaussian_misfit(pipe4.batched_forward_fn("fom"), inv4.data, sigma)
    steps = P12_GPCN_FOM["n_steps"]
    K.launches = K.tile_launches = K.tile_mma_launches = 0
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    res = run_gpcn(misfit_fom, pipe4.prior, lap, theta0, gen, n_steps=steps,
                   n_burn=P12_GPCN_FOM["n_burn"], beta=pipe4.config.mcmc.beta)
    t1.record()
    t1.synchronize()
    n = {"K3r": K.tile_mma_launches, "K3": K.tile_launches, "K1": K.launches}
    k3r += n["K3r"]
    ms = t0.elapsed_time(t1)
    say("P12", f"(f) gpcn fom res4, {P12_GPCN_FOM['n_chains']} chains, {steps} steps "
        f"({P12_GPCN_FOM['n_burn']} burn-in): {ms / 1e3:.3f} s, {ms / steps:.2f} ms a step; accept "
        f"{float(res.accept_rate.mean()):.4f}; launches K3r {n['K3r']} (one a step and the initial "
        f"misfit: {steps + 1}), K3 {n['K3']}, K1 {n['K1']}; mean "
        f"{np.round(res.samples.mean(dim=(0, 1)).double().cpu().numpy(), 4).tolist()}")
    if n["K3r"] != steps + 1 or n["K3"] or n["K1"]:
        fail(f"(f): {n} launches, where K3r should make one a step and one for the initial misfit")
    if not torch.isfinite(res.samples).all() or not 0.05 < float(res.accept_rate.mean()) <= 1.0:
        fail("(f): non-finite samples or an accept rate outside (0.05, 1]")

    api._map_laplace = map_laplace
    torch.set_float32_matmul_precision("highest")
    _p12_fd_check(pipe4)
    say("P12", f"K3r launches over phase 12: {k3r}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return k3r


# phase 13: the approximation layer at the bench's widths (bench.py:409-410, 841-954)
P13_EKI_J = 1024  # (a), (e): bench.py's eki block
P13_VI = dict(n_steps=300, n_mc=32)  # (b): bench.py's vi_advi block, its 3,000 steps cut for the time limit
P13_SVGD = dict(n_particles=512, n_steps=200)  # (c): bench.py's svgd block, its 800 steps cut
P13_SMC = dict(n_particles=4096, n_groups=8, n_mutations=5, ess_target=0.5, max_stages=64)  # (d)
P13_SMC_FOM = dict(n_particles=1024, n_groups=4, n_mutations=5, ess_target=0.5, max_stages=64)  # (e)
P13_PSIS = 4096  # draws of every certificate
P13_INIT = dict(n_steps=400, n_burn=150)  # (f): cut for the time limit
P13_LOGZ_GATE = 4.0  # (d): |log Z - phase 11 (a)'s| in combined standard deviations


def phase_approx(pipe4, inv4, inv_pt):
    """Phase 13: the approximation layer through its api entry points on the card,
    on phase 3's res4 build and data; phase 3's pcn run is the reference
    posterior. Returns K3r's launches over the phase."""
    import torch

    from bayesianinferencedl_tpu_torch.api import (
        psis_certify, run_eki_inversion, run_inversion, run_smc_evidence, run_svgd_inversion,
        run_vi_inversion,
    )
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    t_phase = time.perf_counter()
    data, truth = inv4.data, inv4.theta_true
    ref = inv4.result.samples.double()
    pcn_mean = ref.mean(dim=(0, 1)).cpu().numpy()
    pcn_sd = ref.std(dim=(0, 1)).cpu().numpy()
    k3r = 0

    def counted(fn):
        """fn() with K3r's count set to 0 just before and read just after."""
        K.launches = K.tile_launches = K.tile_mma_launches = 0
        out = fn()
        torch.cuda.synchronize()
        if K.launches or K.tile_launches:
            fail(f"K1 {K.launches} / K3 {K.tile_launches} launches where K3r carries the fom solves")
        return out, K.tile_mma_launches

    def near_pcn(tag, mean, frac=1.0):
        """|mean - pcn's mean| per coordinate, gated at frac pcn sds."""
        err = np.abs(np.asarray(mean, np.float64) - pcn_mean)
        say("P13", f"{tag}: mean {np.round(mean, 4).tolist()} vs pcn {np.round(pcn_mean, 4).tolist()}; "
            f"|diff| / pcn sd {np.round(err / pcn_sd, 3).tolist()}; mean_abs_err_vs_pcn "
            f"{err.mean():.4f}")
        if not np.all(err <= frac * pcn_sd):
            fail(f"{tag}: mean {np.max(err / pcn_sd):.2f} pcn sds from pcn's (gate {frac})")
        return float(err.mean())

    def moment_q(ens):
        e = ens.double()
        return e.mean(0), torch.linalg.cholesky(torch.cov(e.T) + 1e-12 * torch.eye(e.shape[1], dtype=e.dtype,
                                                                               device=e.device))

    def eki_gates(tag, res, J):
        n_iters = len(res.ts) - 1
        ts = np.asarray(res.ts)
        if not (np.all(np.diff(ts) > 0) and ts[-1] == 1.0):
            fail(f"{tag}: the knots {res.ts} do not rise strictly to exactly 1.0")
        if not n_iters < 50:
            fail(f"{tag}: {n_iters} iterations")
        if res.n_forward != J * (n_iters + 1):
            fail(f"{tag}: n_forward {res.n_forward} != J (n_iters + 1) = {J * (n_iters + 1)}")
        if not torch.isfinite(res.ensemble).all():
            fail(f"{tag}: non-finite ensemble")
        return n_iters

    # (a) EKI on rom_nn: an untimed warm run, then the timed one
    kw = dict(n_ensemble=P13_EKI_J, data=data, theta_true=truth)
    run_eki_inversion(pipe4, "rom_nn", **kw)
    res, _, _, wall = run_eki_inversion(pipe4, "rom_nn", **kw)
    n_iters = eki_gates("(a)", res, P13_EKI_J)
    say("P13", f"(a) EKI rom_nn J = {P13_EKI_J}: {n_iters} iterations, {res.n_forward} forwards, "
        f"{wall:.3f} s; knots {[round(t, 5) for t in res.ts]}")
    err = near_pcn("(a)", res.mean.double().cpu().numpy())
    say("P13", f"(a) mean_abs_err_vs_pcn {err:.4f} (the reference's BENCH_r05: 0.0124)")

    # (b) full-rank ADVI, then its PSIS certificate
    vi, _, _, wall = run_vi_inversion(pipe4, "rom_nn", data=data, theta_true=truth, **P13_VI)
    elbo = vi.elbo_trace.double().cpu().numpy()
    L = vi.theta_chol
    if not (np.isfinite(elbo).all() and elbo[-50:].mean() > elbo[:50].mean()):
        fail(f"(b): ELBO first-50 {elbo[:50].mean():.3f}, last-50 {elbo[-50:].mean():.3f}")
    if not (torch.equal(L, torch.tril(L)) and bool((torch.diagonal(L) > 0).all())):
        fail("(b): theta_chol is not lower triangular with a positive diagonal")
    say("P13", f"(b) ADVI full rank, {P13_VI['n_steps']} steps x {P13_VI['n_mc']} draws: {wall:.3f} s, "
        f"{wall / P13_VI['n_steps'] * 1e3:.3f} ms a step; ELBO first-50 {elbo[:50].mean():.3f}, "
        f"last-50 {elbo[-50:].mean():.3f}")
    err = near_pcn("(b)", vi.theta_mean.double().cpu().numpy())
    cert = psis_certify(pipe4, vi.theta_mean, vi.theta_chol, data, n_draws=P13_PSIS)
    if not (cert.ess > 0 and np.isfinite(cert.k_hat)):
        fail(f"(b): PSIS ess {cert.ess}, k-hat {cert.k_hat}")
    say("P13", f"(b) PSIS {P13_PSIS} draws: k-hat {cert.k_hat:.4f} (the reference's 0.523), ESS "
        f"{cert.ess:.1f}, reliable {cert.reliable}, log Z {cert.log_evidence:.4f}; error vs pcn {err:.4f}")

    # (c) SVGD, annealed, then PSIS of its moment-matched Gaussian
    sv, _, _, wall = run_svgd_inversion(pipe4, "rom_nn", data=data, theta_true=truth, **P13_SVGD)
    tr = sv.misfit_trace.double().cpu().numpy()
    if not np.isfinite(tr).all():
        fail("(c): non-finite misfit trace")
    say("P13", f"(c) SVGD {P13_SVGD['n_particles']} particles x {P13_SVGD['n_steps']} steps: {wall:.3f} s, "
        f"{wall / P13_SVGD['n_steps'] * 1e3:.3f} ms a step; misfit first {tr[0]:.2f}, last {tr[-1]:.2f}")
    err = near_pcn("(c)", sv.mean.double().cpu().numpy())
    q_mean, q_chol = moment_q(sv.particles)
    cert_c = psis_certify(pipe4, q_mean.float(), q_chol.float(), data, n_draws=P13_PSIS)
    say("P13", f"(c) PSIS of the moment-matched Gaussian: k-hat {cert_c.k_hat:.4f} (printed, not gated; "
        f"the reference's 0.771 fails its own 0.7), ESS {cert_c.ess:.1f}; error vs pcn {err:.4f}")

    # (d) SMC evidence with phase 3's seed: the same observations
    log = MetricsLogger()
    ev = run_smc_evidence(pipe4, metrics=log, **P13_SMC)
    if not torch.equal(ev.data, data):
        fail("(d): run_smc_evidence's observations differ from phase 3's run_inversion's")
    stages = ev.n_stages.cpu().tolist()
    if max(stages) >= P13_SMC["max_stages"]:
        fail(f"(d): a group hit max_stages before lambda = 1: {stages}")
    dz = abs(ev.log_evidence - inv_pt.log_evidence)
    sz = float(np.hypot(ev.log_evidence_std, inv_pt.log_evidence_std))
    say("P13", f"(d) SMC rom_nn {P13_SMC['n_particles']} particles in {P13_SMC['n_groups']} groups: "
        f"{ev.wall_seconds:.3f} s, stages {stages}; log Z {ev.log_evidence:.4f} +- "
        f"{ev.log_evidence_std:.4f} vs phase 11 (a)'s pt_pcn {inv_pt.log_evidence:.4f} +- "
        f"{inv_pt.log_evidence_std:.4f}: {dz / sz:.2f} combined sds; data bit-identical to phase 3's")
    if not (np.isfinite(ev.log_evidence) and dz <= P13_LOGZ_GATE * sz):
        fail(f"(d): log Z {dz / sz:.2f} combined sds from phase 11 (a)'s")
    near_pcn("(d)", ev.particles.double().mean(0).cpu().numpy(), frac=0.5)

    # (e) the fom likelihood through K3r at res4
    (res_e, _, _, wall), n = counted(lambda: run_eki_inversion(pipe4, "fom", **kw))
    k3r += n
    n_iters = eki_gates("(e) EKI fom", res_e, P13_EKI_J)
    say("P13", f"(e) EKI fom J = {P13_EKI_J}: {n_iters} iterations in {wall:.3f} s; launches K3r {n} "
        f"(n_iters + 1 = {n_iters + 1})")
    if n != n_iters + 1:
        fail(f"(e): EKI on fom made {n} K3r launches, not n_iters + 1 = {n_iters + 1}")
    near_pcn("(e) EKI fom", res_e.mean.double().cpu().numpy())
    ev_f, n = counted(lambda: run_smc_evidence(pipe4, likelihood="fom", **P13_SMC_FOM))
    k3r += n
    st = ev_f.n_stages.cpu().tolist()
    want = 2 + P13_SMC_FOM["n_mutations"] * max(st)
    say("P13", f"(e) SMC fom {P13_SMC_FOM['n_particles']} particles in {P13_SMC_FOM['n_groups']} groups: "
        f"{ev_f.wall_seconds:.3f} s, stages {st}; launches K3r {n} (the truth solve, the initial sweep "
        f"and {P13_SMC_FOM['n_mutations']} x {max(st)} sweeps = {want}); log Z fom "
        f"{ev_f.log_evidence:.4f} +- {ev_f.log_evidence_std:.4f} beside rom_nn's {ev.log_evidence:.4f} "
        f"(a Bayes-factor leg, not gated)")
    if n != want:
        fail(f"(e): SMC on fom made {n} K3r launches, not {want}")
    if not (np.isfinite(ev_f.log_evidence) and torch.isfinite(ev_f.particles).all()
            and max(st) < P13_SMC_FOM["max_stages"]):
        fail("(e): SMC on fom: non-finite output or a group at max_stages")
    cert_e, n = counted(lambda: psis_certify(pipe4, vi.theta_mean, vi.theta_chol, data, "fom",
                                             n_draws=P13_PSIS))
    k3r += n
    say("P13", f"(e) PSIS of (b)'s fit on fom, {P13_PSIS} draws: launches K3r {n}; k-hat "
        f"{cert_e.k_hat:.4f}, ESS {cert_e.ess:.1f}")
    if n != 1:
        fail(f"(e): psis_certify on fom made {n} K3r launches, not 1")
    if not (np.isfinite(cert_e.k_hat) and np.isfinite(cert_e.mean).all() and cert_e.ess > 0):
        fail("(e): non-finite PSIS certificate on fom")

    # (f) run_inversion with the EKI and the ADVI warm starts
    for init in ("eki", "vi"):
        log = MetricsLogger()
        t0 = time.perf_counter()
        inv = run_inversion(_with_mcmc(pipe4, **P13_INIT), init=init, data=data, theta_true=truth,
                            metrics=log)
        torch.cuda.synchronize()
        ev_init = [e for e in log.events if e["event"] == f"{init}_init"]
        if len(ev_init) != 2:
            fail(f"(f): the {init}_init timer and event were not both logged")
        say("P13", f"(f) init={init}: {ev_init[0]['seconds']:.2f} s of warm start ({ev_init[1]}) in the "
            f"call's {time.perf_counter() - t0:.2f} s")
        _p12_moments(f"(f) init={init}", inv, inv4, phase="P13")
    say("P13", f"K3r launches over phase 13: {k3r}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return k3r


# phase 14: the normalizing flow and NeuTra at the bench's widths (bench.py:411-412, 956-1005)
P14_FLOW = dict(n_couplings=6, hidden=32, pretrain_particles=4096, pretrain_steps=700, n_mutations=8,
                max_stages=256)  # (a): bench.py's flow_neutra block, its 3,000 MLE steps cut
P14_PSIS = 8192  # (b): 2 x the bench's psis_draws
P14_WIDEN = 1.5  # (b): the base-widened certificate
P14_NEUTRA = dict(n_chains=4096, n_steps=1_000, n_burn=400, thin=4)  # (c): cut from 10,000 / 2,000
P14_IDENT = 1024  # (d): base points of the identity reduction
P14_FOM_PSIS = 4096  # (e)
P14_FOM_NEUTRA = dict(n_chains=1024, n_steps=64, n_burn=32)  # (e)
P14_NONE = dict(n_couplings=6, hidden=32, pretrain="none", n_steps=250, lr=0.01)  # (f): cut from 3,000
P14_ROUND_TRIP = 1e-4  # (a): |inverse(forward(Z)) - Z| and the log-determinants, float32
P14_IDENT_GATE = 1e-5  # (d): relative
P14_REF = {"k_hat": 0.785, "rhat": 1.1085}  # the reference's BENCH_r05 flow_neutra numbers


def _p14_analytic(device):
    """(g)-(i): the reference's analytic flow cases (tests/test_flow.py:299,
    :252, :195) at its sizes and tolerances, on the port's own generators:
    each takes 18-20 s on one CPU thread, past the CPU tests' budget. (g) a
    weighted MLE fit (4,096 particles of the two-basin posterior, basin 1
    weighted 3:1, 2,000 steps) holds the weighted split: 0.65 < f1 < 0.85,
    0.15 < f2 < 0.35 of 8,000 flow draws. (h) MLE on 32 unique float32 rows
    tiled 128x (3,000 steps): every sd ratio of 8,192 flow draws to the rows'
    in (0.5, 2.0), the means within 0.3 (printed). (i) NeuTra pCN from a covering MLE
    flow (2,048 particles, 2,000 steps), 64 chains x 2,000 steps (500
    burn-in), beta 0.3: over 90% of chains visit both basins, basin 1 holds
    40-60% of the samples, R-hat < 1.05; plain pCN on the same budget from
    prior draws: under 5% of chains cross. (h)'s gate is printed, not
    enforced: the reference's own fit fails it on 4 of 26 seeds, the port's on
    2 of 26 (tests/sweep_torch_flow_degenerate.py). Returns the seconds each
    took."""
    import torch

    from bayesianinferencedl_tpu_torch.infer.diagnostics import rhat
    from bayesianinferencedl_tpu_torch.infer.flow import fit_flow_mle, flow_sample, run_neutra_pcn
    from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
    from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

    a, s, d, f64 = 1.5, 0.25, 2, torch.float64
    prior = GaussianPrior.iid(d, sigma=1.0, dtype=f64, device=device)
    m1 = torch.full((d,), a, dtype=f64, device=device)
    g = torch.Generator(device=device).manual_seed(140)

    def misfit(th):  # the posterior is exactly 0.5 N(m1, s^2 I) + 0.5 N(-m1, s^2 I)
        d1 = torch.sum((th - m1) ** 2, -1) / (2 * s * s)
        d2 = torch.sum((th + m1) ** 2, -1) / (2 * s * s)
        return -torch.logaddexp(-d1, -d2) + 0.5 * torch.sum(th * th, -1)

    def particles(n):
        which = torch.rand((n,), generator=g, dtype=f64, device=device) < 0.5
        return torch.where(which[:, None], m1, -m1) + s * torch.randn((n, d), generator=g, dtype=f64,
                                                                       device=device)

    near = lambda th, m: torch.sum((th - m) ** 2, -1) < (4 * s) ** 2
    secs = {}

    t0 = time.perf_counter()
    pts = particles(4096)
    w = torch.where(near(pts, m1), 3.0, 1.0).to(f64)
    th = flow_sample(fit_flow_mle(pts, prior, g, weights=w, n_steps=2000), g, (8000,))
    f1, f2 = float(near(th, m1).double().mean()), float(near(th, -m1).double().mean())
    secs["weights"] = time.perf_counter() - t0
    say("P14", f"(g) weighted MLE (basin 1 at 3:1): mass {f1:.4f} / {f2:.4f} (gates (0.65, 0.85) / (0.15, "
        f"0.35)); {secs['weights']:.1f} s")
    if not (0.65 < f1 < 0.85 and 0.15 < f2 < 0.35):
        fail(f"(g): weighted MLE split {f1:.4f} / {f2:.4f}")

    t0 = time.perf_counter()
    mean = torch.tensor([0.5845, -0.4843, -0.1081, -0.0761, -0.5730], device=device)
    sd = torch.tensor([0.0118, 0.1007, 0.3028, 0.5778, 0.0664], device=device)
    uniq = mean + sd * torch.randn((32, 5), generator=g, device=device)
    res = fit_flow_mle(torch.tile(uniq, (128, 1)), GaussianPrior.iid(5, sigma=0.6, device=device), g,
                       n_couplings=6, hidden=32, n_steps=3000, n_batch=256, lr=0.01)
    th = flow_sample(res, g, (8192,))
    ratio = (th.std(0) / uniq.std(0)).cpu().numpy()
    dmean = float((th.mean(0) - uniq.mean(0)).abs().max())
    secs["degenerate"] = time.perf_counter() - t0
    ok = bool(np.all(ratio > 0.5) and np.all(ratio < 2.0) and dmean < 0.3)
    say("P14", f"(h) MLE on 32 unique rows tiled 128x: sd ratios {[round(float(r), 3) for r in ratio]}, "
        f"mean diff {dmean:.4f}; the reference's gate (0.5, 2) / 0.3: {'pass' if ok else 'fail'} (printed, not "
        f"enforced: the JAX package fails it on 4 of 26 seeds); {secs['degenerate']:.1f} s")

    t0 = time.perf_counter()
    res = fit_flow_mle(particles(2048), prior, g, n_steps=2000)
    out = run_neutra_pcn(res, misfit, prior, g, n_chains=64, n_steps=2000, n_burn=500, beta=0.3)
    n1, n2 = near(out.samples, m1), near(out.samples, -m1)
    both = float((n1.any(0) & n2.any(0)).double().mean())
    frac1, rh = float(n1.double().mean()), float(rhat(out.samples).max())
    plain = run_pcn(misfit, prior, prior.sample(g, (64,)), g, n_steps=2000, n_burn=500, beta=0.3)
    p1, p2 = near(plain.samples, m1), near(plain.samples, -m1)
    cross = float((p1.any(0) & p2.any(0)).double().mean())
    secs["neutra"] = time.perf_counter() - t0
    say("P14", f"(i) NeuTra mode crossing, 64 chains x 2000 steps: {both:.4f} of chains visit both basins "
        f"(gate > 0.9), basin 1 {frac1:.4f} (gate (0.4, 0.6)), R-hat {rh:.4f} (gate 1.05); plain pCN "
        f"{cross:.4f} cross (gate < 0.05); {secs['neutra']:.1f} s")
    if not (both > 0.9 and 0.4 < frac1 < 0.6 and rh < 1.05 and cross < 0.05):
        fail(f"(i): NeuTra {both:.4f} both, {frac1:.4f} basin 1, R-hat {rh:.4f}; plain pCN {cross:.4f}")
    return secs


_CHILDREN: list = []


def _stop_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _p14_analytic_start():
    """Start (g)-(i) in a child process on the host's CPU, one thread: they
    are host-bound two- and five-dimensional problems, 60-70 s in all, which
    run beside phases 11-14 instead of after them. atexit stops the child if this
    process ends first."""
    import atexit
    import os

    if not _CHILDREN:
        atexit.register(_stop_children)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p14-analytic"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _CHILDREN.append(proc)
    return proc


def _p14_analytic_join(proc) -> None:
    """Relay the child's lines; its failure is the phase's."""
    try:
        out, _ = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        print(out, end="", flush=True)
        fail("(g)-(i): the analytic cases did not finish in 900 s")
    print(out, end="", flush=True)
    if proc.returncode != 0:
        fail(f"(g)-(i): the analytic cases' process exited {proc.returncode}")


def phase_flow(pipe4, inv4, inv_head, analytic):
    """Phase 14: the normalizing flow and NeuTra through their api entry points
    on the card, on phase 3's res4 build. (a)-(e) run on phase 11 (b)'s
    headline data (noise 1e-3, phase 3's truth), with its cold-level samples
    as the reference posterior; (f) on phase 3's data against its pcn run.
    Returns K3r's launches over the phase.

    (a) run_flow_vi_inversion at bench.py's widths (6 couplings of width 32,
        SMC on 4,096 particles with 8 mutations and at most 256 stages, 700
        MLE steps, the bench's 3,000 cut for the time limit, then 1,000 to
        make room for phase 17): SMC reaches lambda = 1 under 256 stages, the MLE trace
        rises (its last 100 steps' mean above its first 100's), and on 4,096
        base draws inverse(forward(Z)) is within 1e-4 of Z and the two
        log-determinants within 1e-4 of each other.
    (b) psis_certify_flow with 8,192 draws, then again with base_scale 1.5:
        k-hat finite, ESS > 0, the log evidence finite. k-hat is printed beside
        the reference's 0.785 and against the 0.7 gate (printed, not
        enforced: 0.785 fails it in JAX too), the log evidence beside phase 11
        (b)'s stepping-stone log Z.
    (c) run_neutra_inversion at the bench's 4,096 chains and thin 4, its
        steps cut for the time limit (1,000 steps, 400 burn-in, for the
        bench's 10,000 / 2,000): accept in (0.05, 0.95), every sample
        finite, each coordinate's mean within one pt_pcn sd of the cold
        level's mean. Split-R-hat printed beside the reference's 1.1085.
    (d) The identity reduction: with an identity flow in the prior frame the
        NeuTra potential at 1,024 base points equals the rom_nn misfit at the
        pushed points within 1e-5 relative.
    (e) The fom route through K3r, its launches counted around each call:
        psis_certify_flow with 4,096 draws exactly 1 launch (one batched
        solve); run_neutra_inversion with 1,024 chains and 64 steps (32
        burn-in) exactly 65, one for the chains' start (pcn_init) and one a
        step (run_neutra_inversion adds none: the data are passed and the samples are
        pushed through the flow alone); accept in (0.05, 0.95).
    (f) pretrain="none": annealed reverse-KL flow-VI on phase 3's 1e-2 data,
        250 steps (cut from the default 3,000) at lr 0.01: the ELBO rises
        (last-50 mean above first-50) and each mean is within one pcn sd of
        phase 3's pcn. This is `vi --flow N --flow-pretrain none`.
    (g)-(i) the reference's analytic cases at its sizes and tolerances
        (_p14_analytic): the weighted MLE split, MLE on a population of
        atoms, NeuTra crossing two basins where plain pCN does not. They run
        on the host's CPU in a child process (analytic) that main starts
        before phase 11, beside phases 11-14."""
    import torch

    from bayesianinferencedl_tpu_torch.api import (
        psis_certify_flow, run_flow_vi_inversion, run_neutra_inversion,
    )
    from bayesianinferencedl_tpu_torch.infer.flow import CouplingFlow, FlowVIResult, neutra_misfit
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    t_phase = time.perf_counter()
    pipe_h = _with_mcmc(pipe4, noise_sigma=PT_HEAD["noise_sigma"])
    data, truth = inv_head.data, inv_head.theta_true
    ref = inv_head.result.samples.double()
    pt_mean = ref.mean(dim=(0, 1)).cpu().numpy()
    pt_sd = ref.reshape(-1, ref.shape[-1]).std(0).cpu().numpy()
    k3r = 0

    def counted(fn):
        """fn() with K3r's count set to 0 just before and read just after."""
        K.launches = K.tile_launches = K.tile_mma_launches = 0
        out = fn()
        torch.cuda.synchronize()
        if K.launches or K.tile_launches:
            fail(f"K1 {K.launches} / K3 {K.tile_launches} launches where K3r carries the fom solves")
        return out, K.tile_mma_launches

    # (a) SMC -> MLE flow at the bench's widths
    log = MetricsLogger()
    res, _, _, wall = run_flow_vi_inversion(pipe_h, "rom_nn", data=data, theta_true=truth, metrics=log,
                                            **P14_FLOW)
    stages = log.summary()["flow_vi"]["smc_stages"]
    if not stages < P14_FLOW["max_stages"]:
        fail(f"(a): SMC took {stages} stages, not under {P14_FLOW['max_stages']}")
    tr = res.elbo_trace.double().cpu().numpy()
    if not (np.isfinite(tr).all() and tr[-100:].mean() > tr[:100].mean()):
        fail(f"(a): MLE trace first-100 {tr[:100].mean():.4f}, last-100 {tr[-100:].mean():.4f}")
    with torch.no_grad():
        Z = torch.randn((4096, res.flow.dim), generator=torch.Generator(device="cuda").manual_seed(14),
                        device="cuda")
        Y, ld = res.flow(Z)
        Z2, ld2 = res.flow.inverse(Y)
    e_z, e_ld = float((Z2 - Z).abs().max()), float((ld2 - ld).abs().max())
    fit_err = np.abs(res.theta_mean.double().cpu().numpy() - pt_mean)
    say("P14", f"(a) flow fit rom_nn noise {PT_HEAD['noise_sigma']:g}, {P14_FLOW['n_couplings']} couplings x "
        f"{P14_FLOW['hidden']}, SMC {P14_FLOW['pretrain_particles']} particles: {stages} stages; "
        f"{P14_FLOW['pretrain_steps']} MLE steps; {wall:.2f} s in all; trace first-100 {tr[:100].mean():.4f}, "
        f"last-100 {tr[-100:].mean():.4f}; round trip |dZ| {e_z:.2e}, |d logdet| {e_ld:.2e}; fit mean "
        f"{np.round(res.theta_mean.double().cpu().numpy(), 4).tolist()} vs pt {np.round(pt_mean, 4).tolist()}, "
        f"fit_mean_abs_err_vs_pt {fit_err.mean():.4f}")
    if not (e_z <= P14_ROUND_TRIP and e_ld <= P14_ROUND_TRIP):
        fail(f"(a): round trip |dZ| {e_z:.2e}, |d logdet| {e_ld:.2e} (gate {P14_ROUND_TRIP})")

    # (b) the flow's PSIS certificate, plain and base-widened
    for scale in (1.0, P14_WIDEN):
        t0 = time.perf_counter()
        cert = psis_certify_flow(pipe_h, res, data, n_draws=P14_PSIS, base_scale=scale)
        torch.cuda.synchronize()
        c_err = np.abs(np.asarray(cert.mean) - pt_mean).mean()
        say("P14", f"(b) PSIS {P14_PSIS} draws, base_scale {scale:g}: {time.perf_counter() - t0:.3f} s; "
            f"k-hat {cert.k_hat:.4f} (the reference's {P14_REF['k_hat']}; gate 0.7: "
            f"{'pass' if cert.k_hat < 0.7 else 'fail'}, printed, not enforced), ESS {cert.ess:.1f}, "
            f"log Z {cert.log_evidence:.4f} beside phase 11 (b)'s stepping stone "
            f"{inv_head.log_evidence:.4f} +- {inv_head.log_evidence_std:.4f}; corrected mean abs err vs pt "
            f"{c_err:.4f}")
        if not (np.isfinite(cert.k_hat) and cert.ess > 0 and np.isfinite(cert.log_evidence)):
            fail(f"(b): base_scale {scale}: k-hat {cert.k_hat}, ESS {cert.ess}, log Z {cert.log_evidence}")

    # (c) NeuTra pCN at the bench's widths
    inv_nt = run_neutra_inversion(pipe_h, res, data, theta_true=truth, **P14_NEUTRA)
    s = inv_nt.result.samples
    if not torch.isfinite(s).all():
        fail("(c): non-finite NeuTra samples")
    acc = float(inv_nt.result.accept_rate.mean())
    flat = s.reshape(-1, s.shape[-1]).double()
    nt_mean, nt_sd = flat.mean(0).cpu().numpy(), flat.std(0).cpu().numpy()
    err = np.abs(nt_mean - pt_mean) / pt_sd
    rh = float(inv_nt.rhat.max())
    say("P14", f"(c) NeuTra pCN {P14_NEUTRA['n_chains']} chains x {P14_NEUTRA['n_steps']} steps "
        f"({P14_NEUTRA['n_burn']} burn-in, thin {P14_NEUTRA['thin']}): {inv_nt.wall_seconds:.3f} s, "
        f"{inv_nt.wall_seconds / P14_NEUTRA['n_steps'] * 1e3:.3f} ms a step, {inv_nt.samples_per_sec:.1f} "
        f"samples/s, bulk ESS/s {inv_nt.ess_per_sec:.2f} (bulk ESS min {inv_nt.ess.min().item():.1f}); "
        f"accept {acc:.4f}; split-rhat max {rh:.4f} (the reference's {P14_REF['rhat']}; phase 11 (b)'s "
        f"pt_pcn {float(inv_head.rhat.max()):.4f})")
    say("P14", f"(c) mean {np.round(nt_mean, 4).tolist()} vs pt {np.round(pt_mean, 4).tolist()}: |diff| / pt "
        f"sd {np.round(err, 3).tolist()}, mean_abs_err_vs_pt {np.abs(nt_mean - pt_mean).mean():.4f}; std ratio "
        f"vs pt {np.round(nt_sd / pt_sd, 3).tolist()}")
    if not 0.05 < acc < 0.95:
        fail(f"(c): accept {acc:.4f} outside (0.05, 0.95)")
    if not np.all(err <= 1.0):
        fail(f"(c): NeuTra mean {err.max():.2f} pt sds from the cold level's")

    # (d) the identity reduction on the card
    g = torch.Generator(device="cuda").manual_seed(15)
    prior = pipe_h.prior
    ident = FlowVIResult(
        flow=CouplingFlow(prior.dim, P14_FLOW["n_couplings"], P14_FLOW["hidden"], generator=g,
                          device="cuda"),
        ref_mean=prior.mean, ref_chol=prior.chol, elbo_trace=prior.mean.new_zeros((0,)),
        theta_mean=prior.mean, theta_cov=torch.eye(prior.dim, device="cuda"), n_forward=0)
    misfit = gaussian_misfit(pipe_h.batched_forward_fn("rom_nn"), data, PT_HEAD["noise_sigma"])
    misfit_Z, _, to_theta = neutra_misfit(ident, misfit, prior)
    with torch.no_grad():
        Zi = torch.randn((P14_IDENT, prior.dim), generator=g, device="cuda")
        a, b = misfit_Z(Zi).double(), misfit(to_theta(Zi)).double()
    rel = float(((a - b).abs() / b.abs()).max())
    say("P14", f"(d) identity flow: NeuTra potential vs the misfit at the pushed points, {P14_IDENT} base "
        f"points: max relative difference {rel:.2e} (gate {P14_IDENT_GATE:g})")
    if not rel <= P14_IDENT_GATE:
        fail(f"(d): the identity reduction is off by {rel:.2e} relative")

    # (e) the fom route at res4 through K3r
    cert_f, n = counted(lambda: psis_certify_flow(pipe_h, res, data, "fom", n_draws=P14_FOM_PSIS))
    k3r += n
    say("P14", f"(e) PSIS of (a)'s flow on fom, {P14_FOM_PSIS} draws: launches K3r {n}; k-hat "
        f"{cert_f.k_hat:.4f}, ESS {cert_f.ess:.1f}, log Z {cert_f.log_evidence:.4f}")
    if n != 1:
        fail(f"(e): psis_certify_flow on fom made {n} K3r launches, not 1")
    if not (np.isfinite(cert_f.k_hat) and cert_f.ess > 0 and np.isfinite(cert_f.log_evidence)):
        fail("(e): non-finite PSIS certificate on fom")
    inv_f, n = counted(lambda: run_neutra_inversion(pipe_h, res, data, "fom", theta_true=truth,
                                                    **P14_FOM_NEUTRA))
    k3r += n
    want = P14_FOM_NEUTRA["n_steps"] + 1
    acc_f = float(inv_f.result.accept_rate.mean())
    say("P14", f"(e) NeuTra on fom, {P14_FOM_NEUTRA['n_chains']} chains x {P14_FOM_NEUTRA['n_steps']} steps "
        f"({P14_FOM_NEUTRA['n_burn']} burn-in): {inv_f.wall_seconds:.3f} s, "
        f"{inv_f.wall_seconds / P14_FOM_NEUTRA['n_steps'] * 1e3:.2f} ms a step; launches K3r {n} (the "
        f"chains' start and one a step = {want}); accept {acc_f:.4f}; mean "
        f"{np.round(inv_f.result.samples.double().mean(dim=(0, 1)).cpu().numpy(), 4).tolist()}")
    if n != want:
        fail(f"(e): NeuTra on fom made {n} K3r launches, not {want}")
    if not (0.05 < acc_f < 0.95 and torch.isfinite(inv_f.result.samples).all()):
        fail(f"(e): NeuTra on fom: accept {acc_f:.4f} outside (0.05, 0.95) or non-finite samples")

    # (f) plain annealed reverse-KL flow-VI on phase 3's data
    pcn = inv4.result.samples.double()
    pcn_mean, pcn_sd = pcn.mean(dim=(0, 1)).cpu().numpy(), pcn.reshape(-1, pcn.shape[-1]).std(0).cpu().numpy()
    res_f, _, _, wall = run_flow_vi_inversion(pipe4, "rom_nn", data=inv4.data, theta_true=inv4.theta_true,
                                              **P14_NONE)
    e = res_f.elbo_trace.double().cpu().numpy()
    err_f = np.abs(res_f.theta_mean.double().cpu().numpy() - pcn_mean) / pcn_sd
    say("P14", f"(f) flow-VI pretrain none, {P14_NONE['n_steps']} steps x 64 draws, lr {P14_NONE['lr']}: "
        f"{wall:.3f} s, {wall / P14_NONE['n_steps'] * 1e3:.3f} ms a step; ELBO first-50 {e[:50].mean():.3f}, "
        f"last-50 {e[-50:].mean():.3f}; mean |diff| / pcn sd {np.round(err_f, 3).tolist()}")
    if not (np.isfinite(e).all() and e[-50:].mean() > e[:50].mean()):
        fail(f"(f): ELBO first-50 {e[:50].mean():.3f}, last-50 {e[-50:].mean():.3f}")
    if not np.all(err_f <= 1.0):
        fail(f"(f): flow-VI mean {err_f.max():.2f} pcn sds from pcn's")

    # (g)-(i) the reference's analytic cases, too long for the CPU tests,
    # from the child started before phase 11
    _p14_analytic_join(analytic)
    say("P14", f"K3r launches over phase 14: {k3r}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return k3r


# phase 15: persistence, the online tiers, box priors and resumable chains
P15_SHAPE = (4096, 40)  # (a): the headline's chains of one level x r
P15_PCN = dict(n_steps=700, n_burn=350)  # (b1): phase 3's cell, cut from 4,000 / 1,000 for the time limit
P15_HEAD = {**PT_HEAD, "n_steps": 500, "n_burn": 200}  # (b2): cut from 2,500 / 1,000
P15_FAST = dict(n_steps=400, n_burn=150)  # (c): a short pcn run on the fast build
P15_BOX_PCN = dict(n_chains=1024, n_steps=600, n_burn=200)  # (e): pcn on rom_nn, cut from 1,000 / 300
P15_BOX_DA = dict(n_chains=1024, n_steps=8, n_burn=3, subchain=64)  # (e): da_pcn on fom, cut from 12 / 4
# (f): each stopped at a segment boundary half-way, after its burn-in
P15_PT = dict(n_steps=200, n_burn=50, segment=50, n_temps=4, lambda_min=0.05)  # 1,024 x 4, rom_nn
P15_DA = dict(n_steps=6, n_burn=2, segment=3, subchain=64)  # res8, 1,024 chains
P15_PRODUCT_GATE = {"high": 1e-6, "fast": 1e-5}  # (a): card vs plain, relative
P15_REF_HOLDOUT = (5.7e-5, 1.5e-5)  # docs/DESIGN.md section 4: "high" corrected, "highest" corrected (TPU)
P15_THETA_SLACK = 1e-6  # (e): float32 rounding of to_theta at the box's edges


def _p15_products(pipe4):
    """(a): the tier products at the chain step's shapes, each against its
    plain version on the card and against float64."""
    import torch

    from bayesianinferencedl_tpu_torch.utils import precision as P

    rom = pipe4.rom
    C, r = P15_SHAPE
    g = torch.Generator(device="cuda").manual_seed(15)
    p = torch.randn((C, r), generator=g, device="cuda")
    stack = torch.cat([rom.Ahat, rom.Mhat[None]], 0)
    AT = stack.transpose(1, 2).permute(1, 0, 2).reshape(r, -1).contiguous()  # (r, 6r)
    for tag, b in (("operator (r, 6r)", AT), ("P0^T (r, r)", pipe4.P0.T.contiguous())):
        exact = p.double() @ b.double()
        nrm = torch.linalg.norm(exact)
        with P.fp32_matmul():
            e32 = float(torch.linalg.norm((p @ b).double() - exact) / nrm)
        line = [f"highest err vs f64 {e32:.3e}"]
        for tier in ("high", "fast"):
            op = P.tier_operand(b, tier)
            left = P._left(p, tier)
            card = P.tier_matmul(p, op)
            plain = P.bf16_mm_plain(left, op.mat, torch.float32)
            rel = float(torch.linalg.norm((card - plain).double()) / torch.linalg.norm(plain.double()))
            err = float(torch.linalg.norm(card.double() - exact) / nrm)
            ms = _time_ms(lambda: P.tier_matmul(p, op), 20)
            ms_plain = _time_ms(lambda: P.bf16_mm_plain(P._left(p, tier), op.mat, torch.float32), 20)
            line.append(f"{tier}: card vs plain {rel:.3e} (gate {P15_PRODUCT_GATE[tier]:g}), err vs f64 "
                        f"{err:.3e}, {ms * 1e3:.1f} us (plain {ms_plain * 1e3:.1f} us)")
            if not rel <= P15_PRODUCT_GATE[tier]:
                fail(f"(a) {tier} product {tag}: card vs plain {rel:.3e} above {P15_PRODUCT_GATE[tier]:g}")
        say("P15", f"(a) {C} x {tag}: " + "; ".join(line))


def phase_persist_precision(pipe4, inv4, slice_log, inv_head, pipe8, inv8):
    """Phase 15: the online tiers (the bf16x3 and bf16 products, builds and
    chains at "high" and "fast"), Pipeline.save / load, box priors through
    run_inversion and the checkpointed runners' resume, on the card.

    (a) the tier products at C = 4,096, r = 40 against their plain versions
    (relative difference <= 1e-6 for "high", <= 1e-5 for "fast") and
    float64 (printed). (b) build_pipeline at "high" with phase 3's config:
    the holdout errors printed beside phase 3's and the reference's TPU
    figures; (b1) pcn on phase 3's data and cell, its means within 5 MCSE
    of phase 3's pcn and its sds within 10% (700 steps, 350 burn-in, cut
    from 4,000 / 1,000 for the time limit); (b2) the headline pt_pcn on
    phase 11 (b)'s data, 500 steps (200 burn-in; cut from 2,500 / 1,000
    for the time limit),
    under phase 11's ladder and swap gates, us
    a step, split-R-hat and log Z printed beside phase 11 (b)'s. (c) a
    "fast" build and a short pcn run (400 steps, 150 burn-in; cut from
    1,000 / 300), printed only. (d) (b)'s pipeline saved
    and loaded on the card: the rom_nn batched forward bit-identical, the
    tier "high". (e) a log_uniform [0.1, 10] box prior on phase 6's res8
    build and data: pcn on rom_nn and da_pcn on fom (its subchains from
    pcn's mean adapted step) through run_inversion;
    pcn's accept and da_pcn's inner accept in (0.05, 0.9), da_pcn's outer
    above 0.6, K3r one launch an outer step (the timed run's outer steps and
    segment starts, the warm-up's 3, the audit's and the PPC's 1 each),
    every kept to_theta(z) inside [log 0.1, log 10] (1e-6 of rounding), the
    two runs' means of log k within one pcn sd. (f) run_pt_checkpointed
    (1,024 x 4, rom_nn, phase 3's data) and run_da_checkpointed (res8,
    1,024 chains, phase 6's data), each stopped at its midpoint and resumed:
    samples, final state and accept accounting bit-identical to an
    uninterrupted run from the same generator state. Returns K3r's launches
    over the phase."""
    import dataclasses
    import functools
    import os
    import shutil

    import torch

    from bayesianinferencedl_tpu_torch.api import (
        Pipeline, build_pipeline, run_da_checkpointed, run_inversion, run_pt_checkpointed,
    )
    from bayesianinferencedl_tpu_torch.config import PriorConfig
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit
    from bayesianinferencedl_tpu_torch.infer.priors import BoxPrior
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    t_phase = time.perf_counter()
    k3r = 0

    def counted(fn):
        """fn() with every FOM kernel's count set to 0 just before and read just after."""
        K.launches = K.tile_launches = K.tile_mma_launches = 0
        out = fn()
        torch.cuda.synchronize()
        if K.launches or K.tile_launches:
            fail(f"K1 {K.launches} / K3 {K.tile_launches} launches where K3r carries the fom solves")
        return out, K.tile_mma_launches

    _p15_products(pipe4)

    # (b) the "high" build: phase 3's config at the other tier
    def tier_build(tier):
        cfg = pipe4.config
        cfg = dataclasses.replace(cfg, rom=dataclasses.replace(cfg.rom, online_precision=tier))
        log = MetricsLogger()
        t0 = time.perf_counter()
        pipe, n = counted(lambda: build_pipeline(cfg, device="cuda", metrics=log))
        return pipe, log.summary(), time.perf_counter() - t0, n

    pipe_h, s_h, build_s, n = tier_build("high")
    k3r += n
    hold, hold3 = s_h["holdout_rel_err"], slice_log["holdout_rel_err"]
    say("P15", f"(b) build_pipeline at \"high\": {build_s:.2f} s, K3r {n}, rom_pcg_iters "
        f"{pipe_h.rom_pcg_iters}; holdout rom {hold['rom']:.4e} corrected {hold['corrected']:.4e}; "
        f"phase 3's \"highest\" rom {hold3['rom']:.4e} corrected {hold3['corrected']:.4e}; the "
        f"reference's TPU figures (docs/DESIGN.md 4, for comparison, not targets): corrected "
        f"{P15_REF_HOLDOUT[0]:g} at high, {P15_REF_HOLDOUT[1]:g} at highest")
    if pipe_h.rom_precision != "high":
        fail(f"(b): the build reports the tier {pipe_h.rom_precision!r}")
    if n < 3:
        fail(f"(b): K3r made {n} launches in the build (expected >= 3)")

    # (b1) pcn on phase 3's cell and data
    inv_h, n = counted(lambda: run_inversion(_with_mcmc(pipe_h, **P15_PCN), data=inv4.data,
                                             theta_true=inv4.theta_true))
    k3r += n
    res_h = inv_h.result
    means, sds, z, sd_rel, rhats = _posterior_z(res_h.samples, inv4.result.samples)
    acc_h, mc = float(res_h.accept_rate.mean()), pipe4.config.mcmc
    say("P15", f"(b1) pcn rom_nn at high, {mc.n_chains} chains x {P15_PCN['n_steps']} steps "
        f"({P15_PCN['n_burn']} burn-in): {inv_h.wall_seconds:.3f} s, "
        f"{inv_h.wall_seconds / P15_PCN['n_steps'] * 1e6:.1f} us/step (phase 3 at highest "
        f"{inv4.wall_seconds / mc.n_steps * 1e6:.1f}); accept {acc_h:.4f} vs "
        f"{float(inv4.result.accept_rate.mean()):.4f}; |diff| / MCSE {np.round(z, 2).tolist()}; sd "
        f"rel diff {np.round(sd_rel, 4).tolist()}; split-rhat {rhats[0]:.4f} vs {rhats[1]:.4f}")
    if not torch.isfinite(res_h.samples).all():
        fail("(b1): non-finite samples")
    if z.max() > K2_MEAN_GATE:
        fail(f"(b1): means {z.max():.2f} Monte-Carlo errors from phase 3's")
    if sd_rel.max() > K2_SD_GATE:
        fail(f"(b1): sd {100 * sd_rel.max():.1f}% from phase 3's")

    # (b2) the headline pt_pcn on the "high" build, phase 11 (b)'s data and steps
    head = _with_mcmc(pipe_h, sampler="pt_pcn", adapt_ladder=True, **P15_HEAD)
    inv_b2, n = counted(lambda: run_inversion(head, data=inv_head.data, theta_true=inv_head.theta_true))
    k3r += n
    lam_b2, swap_b2 = _pt_gates("(b2)", inv_b2)
    us, us_11 = inv_b2.wall_seconds / P15_HEAD["n_steps"] * 1e6, inv_head.wall_seconds / PT_HEAD["n_steps"] * 1e6
    say("P15", f"(b2) headline pt_pcn at high, {PT_HEAD['n_chains']} x {PT_HEAD['n_temps']}, "
        f"{P15_HEAD['n_steps']} steps: {us:.1f} us/step vs phase 11 (b)'s {us_11:.1f} ({us_11 / us:.3f}x); "
        f"split-rhat {float(inv_b2.rhat.max()):.4f} vs {float(inv_head.rhat.max()):.4f}; log Z "
        f"{inv_b2.log_evidence:.4f} +- {inv_b2.log_evidence_std:.4f} vs {inv_head.log_evidence:.4f} +- "
        f"{inv_head.log_evidence_std:.4f}; swap rates {np.round(swap_b2, 4).tolist()}; mean ladder "
        f"{np.round(lam_b2, 5).tolist()}")

    # (c) the "fast" tier: a build and a short pcn run, printed only
    pipe_f, s_f, build_s, n = tier_build("fast")
    k3r += n
    inv_f, n = counted(lambda: run_inversion(_with_mcmc(pipe_f, **P15_FAST), data=inv4.data,
                                             theta_true=inv4.theta_true))
    k3r += n
    means, _, z, sd_rel, _ = _posterior_z(inv_f.result.samples, inv4.result.samples)
    say("P15", f"(c) fast: build {build_s:.2f} s, holdout rom {s_f['holdout_rel_err']['rom']:.4e} corrected "
        f"{s_f['holdout_rel_err']['corrected']:.4e}; pcn {P15_FAST['n_steps']} steps "
        f"{inv_f.wall_seconds / P15_FAST['n_steps'] * 1e6:.1f} us/step, accept "
        f"{float(inv_f.result.accept_rate.mean()):.4f}; |diff| / MCSE vs phase 3 {np.round(z, 2).tolist()}, "
        f"sd rel diff {np.round(sd_rel, 4).tolist()} (printed, not gated)")

    # (d) save and load (b)'s pipeline on the card
    root = os.path.join("build", "smoke_p15")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "pipe_high.npz")
    pipe_h.save(path)
    loaded = Pipeline.load(path, device="cuda")
    th = torch.randn((1024, 5), generator=torch.Generator(device="cuda").manual_seed(16), device="cuda") * 0.6
    y0, y1 = pipe_h.batched_forward_fn("rom_nn")(th), loaded.batched_forward_fn("rom_nn")(th)
    same = bool(torch.equal(y0, y1))
    say("P15", f"(d) save / load: {os.path.getsize(path)} B; loaded tier {loaded.rom_precision!r}; rom_nn "
        f"forward at 1,024 points bit-identical: {same}")
    if not same or loaded.rom_precision != "high":
        fail("(d): the loaded pipeline's forward or tier differs")

    # (e) the log_uniform box prior on phase 6's build and data
    box = BoxPrior.create(5, low=0.1, high=10.0, kind="log_uniform", device="cuda")
    pipe_box = dataclasses.replace(pipe8, prior=box, config=dataclasses.replace(
        pipe8.config, prior=PriorConfig(kind="log_uniform", low=0.1, high=10.0)))
    lo, hi = np.log(0.1), np.log(10.0)

    def box_run(tag, **mcmc):
        inv, n = counted(lambda: run_inversion(_with_mcmc(pipe_box, **mcmc), data=inv8.data))
        th = box.to_theta(inv.result.samples).double()
        if not torch.isfinite(th).all():
            fail(f"(e) {tag}: non-finite samples")
        t_lo, t_hi = float(th.min()), float(th.max())
        if t_lo < lo - P15_THETA_SLACK or t_hi > hi + P15_THETA_SLACK:
            fail(f"(e) {tag}: kept theta in [{t_lo:.6f}, {t_hi:.6f}], outside [log 0.1, log 10]")
        return inv, n, th, (t_lo, t_hi)

    inv_p, n_p, th_p, rng_p = box_run("pcn", sampler="pcn", likelihood="rom_nn", **P15_BOX_PCN)
    k3r += n_p
    acc_p, beta_p = float(inv_p.result.accept_rate.mean()), float(inv_p.result.beta.mean())
    # the subchains start from pcn's adapted step: in z the posterior is several times
    # narrower against the prior than in log k, and 4 burn-in outer steps adapt little
    inv_d, n_d, th_d, rng_d = box_run("da_pcn", sampler="da_pcn", likelihood="fom", da_coarse="rom_nn",
                                      beta=beta_p, **P15_BOX_DA)
    k3r += n_d
    res_d = inv_d.result
    outer, inner = float(res_d.accept_rate.mean()), float(res_d.inner_accept_rate.mean())
    steps = P15_BOX_DA["n_steps"]
    want = steps + -(-steps // 64) + 3 + 2
    sd_p = th_p.reshape(-1, 5).std(0)
    err = ((th_p.mean(dim=(0, 1)) - th_d.mean(dim=(0, 1))).abs() / sd_p).cpu().numpy()
    say("P15", f"(e) box log_uniform [0.1, 10]: pcn rom_nn {P15_BOX_PCN['n_chains']} x "
        f"{P15_BOX_PCN['n_steps']}: accept {acc_p:.4f}, adapted beta {beta_p:.4f}, K3r {n_p}, theta in [{rng_p[0]:.4f}, {rng_p[1]:.4f}]; "
        f"da_pcn fom {steps} outer steps: outer {outer:.4f}, inner {inner:.4f}, "
        f"{inv_d.wall_seconds / steps * 1e3:.1f} ms an outer step, K3r {n_d} (outer steps + segments + "
        f"warm-up 3 + audit and PPC 2 = {want}), theta in [{rng_d[0]:.4f}, {rng_d[1]:.4f}]; means of "
        f"log k pcn {np.round(th_p.mean(dim=(0, 1)).cpu().numpy(), 4).tolist()} da "
        f"{np.round(th_d.mean(dim=(0, 1)).cpu().numpy(), 4).tolist()}, |diff| / pcn sd "
        f"{np.round(err, 3).tolist()}; truth {np.round(inv8.theta_true.cpu().numpy(), 4).tolist()}")
    if not 0.05 < acc_p < 0.9:
        fail(f"(e): pcn accept {acc_p:.4f} outside (0.05, 0.9)")
    if not (0.05 < inner < 0.9 and outer > 0.6):
        fail(f"(e): da_pcn inner accept {inner:.4f} outside (0.05, 0.9) or outer {outer:.4f} not above 0.6")
    if n_p:
        fail(f"(e): pcn on rom_nn made {n_p} K3r launches (data given: none expected)")
    if n_d != want:
        fail(f"(e): da_pcn on fom made {n_d} K3r launches, not one an outer step ({want})")
    if not np.all(err <= 1.0):
        fail(f"(e): the two runs' means of log k {err.max():.3f} pcn sds apart")

    # (f) resume: each run stopped at its midpoint, then resumed
    def resume_check(tag, fn, kw, fields):
        full = fn(torch.Generator(device="cuda").manual_seed(77), os.path.join(root, f"{tag}_full.npz"),
                  False, kw)
        crash = os.path.join(root, f"{tag}_crash.npz")
        fn(torch.Generator(device="cuda").manual_seed(77), crash, False,
           {**kw, "n_steps": kw["n_steps"] // 2})
        t0 = time.perf_counter()
        resumed = fn(torch.Generator(device="cuda").manual_seed(5), crash, True, kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        get = lambda res, f: functools.reduce(getattr, f.split("."), res)
        same = {f: bool(torch.equal(get(full, f), get(resumed, f))) for f in fields}
        say("P15", f"(f) {tag}: {kw['n_steps']} steps in segments of {kw['segment']}, stopped at "
            f"{kw['n_steps'] // 2} and resumed ({wall:.2f} s); bit-identical to the uninterrupted run: "
            + ", ".join(f"{f} {v}" for f, v in same.items()))
        if not all(same.values()):
            fail(f"(f) {tag}: the resumed run differs from the uninterrupted one")

    misfit4 = gaussian_misfit(pipe4.working_forward_fn("rom_nn"), inv4.data, pipe4.config.mcmc.noise_sigma)
    theta_pt = pipe4.prior.sample(torch.Generator(device="cuda").manual_seed(78), (1024,))
    resume_check("run_pt_checkpointed", lambda g, path, resume, kw: run_pt_checkpointed(
        misfit4, pipe4.prior, theta_pt, g, ckpt_path=path, resume=resume, adapt_ladder=True, **kw),
        P15_PT, ("samples", "phi_trace", "theta", "beta", "lambdas", "accept_rate", "swap_rate",
                 "ss_level_mean"))
    noise8 = pipe8.config.mcmc.noise_sigma
    fine = gaussian_misfit(pipe8.working_forward_fn("fom"), inv8.data, noise8)
    coarse = gaussian_misfit(pipe8.working_forward_fn("rom_nn"), inv8.data, noise8)
    theta_da = pipe8.prior.sample(torch.Generator(device="cuda").manual_seed(79), (1024,))
    _, n = counted(lambda: resume_check("run_da_checkpointed", lambda g, path, resume, kw: run_da_checkpointed(
        fine, coarse, pipe8.prior, theta_da, g, ckpt_path=path, resume=resume, **kw), P15_DA,
        ("samples", "phi_trace", "state.theta", "state.phi_f", "beta", "accept_rate",
         "inner_accept_rate")))
    k3r += n
    shutil.rmtree(root, ignore_errors=True)
    say("P15", f"K3r launches over phase 15: {k3r}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return k3r


P16_MLDA = dict(n_chains=1024, n_steps=10, n_burn=4, subchain=64, mlda_subchain=4)  # (a): cut from 16 / 6
P16_MID_RES = 4  # (a): the mid rung's mesh (lanes layout) under phase 6's res8
P16_SEGMENT = 32  # run_inversion's segment for mlda_pcn
P16_CKPT = dict(n_steps=8, n_burn=2, segment=2, subchains=(16, 2))  # (b): 256 chains, stopped at 4
P16_PREDICT = 256  # (c): thinned draws
P16_SBC = dict(n_datasets=32, n_chains=31, n_steps=800, n_burn=400)  # (d): the reference's steps, J cut
P16_SENSORS, P16_DRAWS = 3, 16  # (e)
P16_SENSOR_PCN = dict(n_chains=1024, n_steps=400, n_burn=150)  # (e): cut from 600 / 200


def phase_mlda_workflow(card, pipe4, pipe8, inv8):
    """Phase 16: multilevel delayed acceptance and the inversion workflow on
    the card, each entry point counted from 0 (K3r's launches split by mesh
    through a wrapper of pcg_stencil_tile that reads F's length).

    (a) run_inversion(mlda_pcn, init="eki") on phase 6's res8 build and
    data, the mid rung the FOM at res4: 1,024 chains started from an EKI
    ensemble on the fom likelihood (from prior draws 20 top steps were
    measured 21 MCSE off da_pcn's means, not converged), subchains of 64 rom_nn pCN
    steps, 4 mid steps per fine correction, 10 top steps (4 burn-in; cut
    from 16 / 6 for the time limit),
    segments of 32. Gates: the means within 5 combined MCSE of phase 6's
    da_pcn (both sample the exact res8 FOM posterior), the top-level accept
    above 0.6 and the base rate in (0.05, 0.9), no audited state at the
    cap, and K3r exactly 4 res4 launches and 1 res8 launch a top step plus
    each segment's init (1 of each), the EKI start's batched solves, the
    warm-up's 2 steps and init, the audit's and the PPC's res8 solve. ms per top step and ESS/s printed beside
    phase 6's da_pcn. (b) run_mlda_checkpointed on phase 6's misfits, 256
    chains, subchains (16, 2), 8 top steps in segments of 2, stopped at 4
    (a checkpoint of the uninterrupted run: K3r's bits for a sample depend
    on its batch, so a stop off the segment grid re-solves states in other
    batches than the uninterrupted run did) and resumed: bit-identical to
    the uninterrupted run. (c)
    predict_temperature over (a)'s kept draws, 256 thinned draws: exactly
    one K3r launch; the draws' observables (fin.op.observe of the same
    solve) within 1e-5 of the batched fom forward's, and a point on a mesh
    node predicting that node's value to 1e-6. (d) run_sbc_check on phase
    3's rom_nn build with pcn, J = 32 datasets x C = 31 chains, 800 steps
    (400 burn-in; the reference's J = 128 cut for time): p_min > 1e-3 and
    mean accept > 0.05. (e) design_sensors at res4 (3 sensors, 16 prior
    draws, tol 1e-7): the EIG trace rising strictly, every gain > 0; then
    build_pipeline(fin=with_sensor_qoi(...)) with phase 3's config and pcn
    on rom_nn with m = 3 (1,024 chains x 400 steps, 150 burn-in) on data
    simulated there: accept in (0.05, 0.9). (f) build_pipeline with
    ROMConfig.method="greedy" and phase 3's config: the ROM's relative
    error against the FOM on 64 log-uniform conductivities below 0.1 and
    the host float64 basis's V^T V = I to 1e-10. Returns K3r's launches
    over the phase."""
    import dataclasses
    import os
    import shutil

    import torch

    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.infer.oed import design_sensors, solution_indices, with_sensor_qoi
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
    from bayesianinferencedl_tpu_torch.utils.ppc import thin_samples

    t_phase = time.perf_counter()
    by_n = {}
    tile = K.pcg_stencil_tile

    def split_tile(vals4, F, *a, **kw):  # the batch's mesh, by F's length
        by_n[F.shape[-1]] = by_n.get(F.shape[-1], 0) + 1
        return tile(vals4, F, *a, **kw)

    K.pcg_stencil_tile = split_tile
    n4, n8 = pipe4.fin.op.n, pipe8.fin.op.n
    k3r = 0

    def counted(fn):
        """(fn(), K3r launches, {n: launches}), every FOM kernel counted from 0."""
        K.launches = K.tile_launches = K.tile_mma_launches = 0
        by_n.clear()
        out = fn()
        torch.cuda.synchronize()
        if K.launches or K.tile_launches:
            fail(f"K1 {K.launches} / K3 {K.tile_launches} launches where K3r carries the fom solves")
        return out, K.tile_mma_launches, dict(by_n)

    try:
        # (a) mlda_pcn on phase 6's build and data
        m = P16_MLDA
        mc = _with_mcmc(pipe8, sampler="mlda_pcn", likelihood="fom", mlda_resolution=P16_MID_RES,
                        da_coarse="rom_nn", da_inner="pcn", **m)
        log = MetricsLogger()
        inv, n, split = counted(lambda: api.run_inversion(mc, init="eki", data=inv8.data,
                                                          theta_true=inv8.theta_true, metrics=log))
        k3r += n
        res = inv.result
        T, seg = m["n_steps"], -(-m["n_steps"] // P16_SEGMENT)
        n_eki = log.summary()["eki_init"]["n_forward"] // m["n_chains"]  # the EKI start's batched solves
        want8 = n_eki + (1 + 2) + (T + seg) + 2  # EKI, warm-up (init + 2 steps), run, audit + PPC
        want4 = (1 + 2 * m["mlda_subchain"]) + (m["mlda_subchain"] * T + seg)
        outer, rates = float(res.accept_rate.mean()), res.level_rates.mean(1).cpu().numpy()
        means, sds, z, sd_rel, rhats = _posterior_z(res.samples, inv8.result.samples)
        step_ms = inv.wall_seconds * 1e3 / T
        da_ms = inv8.wall_seconds * 1e3 / DA_OUTER
        say("P16", f"[{card}] (a) mlda_pcn fom res{K3_RES}, mid res{P16_MID_RES}, {m['n_chains']} chains, "
            f"subchains ({m['subchain']}, {m['mlda_subchain']}), {T} top steps ({m['n_burn']} burn-in): "
            f"{inv.wall_seconds:.3f} s, {step_ms:.1f} ms a top step (phase 6's da_pcn {da_ms:.1f} ms an "
            f"outer step), ESS/s {inv.ess_per_sec:.2f} (bulk ESS min {float(inv.ess.min()):.1f}); accept "
            f"top {outer:.4f}, per level (base, mid, top) {np.round(rates, 4).tolist()}; evals a step "
            f"{res.evals_per_step}; |diff| / MCSE vs da_pcn {np.round(z, 2).tolist()}, sd rel diff "
            f"{np.round(sd_rel, 3).tolist()}; split-rhat {rhats[0]:.4f} (da_pcn {rhats[1]:.4f}); audit cap "
            f"{inv.fom_iter_cap}, max {inv.fom_iter_max}, at cap {inv.fom_hit_cap_frac}")
        say("P16", f"(a) K3r launches {n}: res{K3_RES} (n = {n8}) {split.get(n8, 0)} (expected {want8}, "
            f"{n_eki} of them the EKI start's), "
            f"res{P16_MID_RES} (n = {n4}) {split.get(n4, 0)} (expected {want4}: {m['mlda_subchain']} a top "
            f"step and 1 a segment, the warm-up's {1 + 2 * m['mlda_subchain']})")
        if not torch.isfinite(res.samples).all() or tuple(res.samples.shape) != (T - m["n_burn"], m["n_chains"], 5):
            fail(f"(a): samples {tuple(res.samples.shape)} not finite or misshapen")
        if z.max() > K2_MEAN_GATE:
            fail(f"(a): means {z.max():.2f} MCSE from phase 6's da_pcn")
        if not (outer > 0.6 and 0.05 < rates[0] < 0.9):
            fail(f"(a): top accept {outer:.4f} not above 0.6 or base rate {rates[0]:.4f} outside (0.05, 0.9)")
        if inv.fom_hit_cap_frac != 0:
            fail(f"(a): {inv.fom_hit_cap_frac:.2%} of audited states at the cap")
        if (split.get(n8, 0), split.get(n4, 0)) != (want8, want4) or n != want8 + want4:
            fail(f"(a): K3r launches {split} (total {n}), expected res8 {want8} and res4 {want4}")

        # (b) run_mlda_checkpointed stopped half-way and resumed
        noise8 = pipe8.config.mcmc.noise_sigma
        fin_mid = FiveParamFin.create(resolution=P16_MID_RES, biot=0.1, device="cuda", cg_tol=TOL,
                                      cg_maxiter=MAXITER)
        mid = api.batched_fom_observe(fin_mid)
        misfits = tuple(gaussian_misfit(f, inv8.data, noise8) for f in (
            pipe8.working_forward_fn("rom_nn"), lambda xs: mid(pipe8.prior.to_theta(xs)),
            pipe8.working_forward_fn("fom")))
        theta0 = pipe8.prior.sample(torch.Generator(device="cuda").manual_seed(81), (256,))
        root = os.path.join("build", "smoke_p16")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        ck = P16_CKPT
        run = lambda path, resume, n_steps: api.run_mlda_checkpointed(
            misfits, pipe8.prior, theta0, torch.Generator(device="cuda").manual_seed(82), n_steps=n_steps,
            n_burn=ck["n_burn"], subchains=ck["subchains"], segment=ck["segment"], ckpt_path=path,
            resume=resume)
        (full, crash, resumed), n_b, _ = counted(lambda: (
            run(os.path.join(root, "full.npz"), False, ck["n_steps"]),
            run(os.path.join(root, "crash.npz"), False, ck["n_steps"] // 2),
            run(os.path.join(root, "crash.npz"), True, ck["n_steps"])))
        k3r += n_b
        fields = ("samples", "phi_trace", "beta", "accept_rate", "level_rates", "state.theta", "state.phi")
        get = lambda r, f: getattr(r.state, f[6:]) if f.startswith("state.") else getattr(r, f)
        same = {f: bool(torch.equal(get(full, f), get(resumed, f))) for f in fields}
        say("P16", f"(b) run_mlda_checkpointed, 256 chains, subchains {ck['subchains']}, {ck['n_steps']} top "
            f"steps in segments of {ck['segment']}, stopped at {ck['n_steps'] // 2} and resumed (K3r {n_b}); "
            "bit-identical: " + ", ".join(f"{f} {v}" for f, v in same.items()))
        if not all(same.values()):
            fail("(b): the resumed MLDA run differs from the uninterrupted one")
        shutil.rmtree(root, ignore_errors=True)

        # (c) predict_temperature over (a)'s kept draws
        fin8 = pipe8.fin
        node = int(np.argmax(fin8.mesh.nodes[:, 1]))  # the top of the post
        pts = np.vstack([[0.1, 2.3], [-2.5, 0.875], fin8.mesh.nodes[node]])
        t0 = time.perf_counter()
        pred, n_c, _ = counted(lambda: api.predict_temperature(pipe8, res.samples, points=pts,
                                                               n_draws=P16_PREDICT, noise_sigma=noise8))
        pred_s = time.perf_counter() - t0
        k3r += n_c
        x = thin_samples(res.samples, P16_PREDICT)
        (u, y_fwd), n_c2, _ = counted(lambda: (
            api.make_fom_solver(fin8, tol=fin8.cg_tol, maxiter=fin8.cg_maxiter)(torch.exp(pipe8.prior.to_theta(x))),
            pipe8.batched_forward_fn("fom")(pipe8.prior.to_theta(x))))
        k3r += n_c2
        obs_gap = float(((fin8.op.observe(u) - y_fwd).abs().max() / y_fwd.abs().max()))
        mean_gap = float(np.abs(pred.mean - u[:, torch.as_tensor(solution_indices(fin8), device=u.device)]
                                .double().mean(0).cpu().numpy()).max())
        node_gap = abs(pred.point_mean[-1] - pred.mean[node]) / abs(pred.mean[node])
        say("P16", f"[{card}] (c) predict_temperature, {pred.n_draws} draws at res{K3_RES}: {pred_s * 1e3:.1f} ms "
            f"host (K3r {n_c}); observables vs the batched fom forward {obs_gap:.3e} (gate 1e-5); field mean vs "
            f"the same solve's {mean_gap:.3e}; node {node} predicted {pred.point_mean[-1]:.6f} vs its value "
            f"{pred.mean[node]:.6f} ({node_gap:.3e}, gate 1e-6); points {pred.summary_rows()[:2]}")
        if n_c != 1:
            fail(f"(c): predict_temperature made {n_c} K3r launches, not 1")
        if not obs_gap <= 1e-5 or not node_gap <= 1e-6 or not np.isfinite(pred.std).all():
            fail(f"(c): observables {obs_gap:.3e} or the node's value {node_gap:.3e} off")

        # (d) simulation-based calibration of pcn on phase 3's rom_nn build
        t0 = time.perf_counter()
        sbc, n_d, _ = counted(lambda: api.run_sbc_check(pipe4, "rom_nn", seed=16, **P16_SBC))
        sbc_s = time.perf_counter() - t0
        k3r += n_d
        p_min, acc = float(sbc.p_values.min()), float(sbc.accept_rate.mean())
        say("P16", f"[{card}] (d) run_sbc_check pcn rom_nn, J = {P16_SBC['n_datasets']} x C = "
            f"{P16_SBC['n_chains']}, {P16_SBC['n_steps']} steps: {sbc_s:.2f} s, p-values "
            f"{np.round(sbc.p_values.numpy(), 4).tolist()}, p_min {p_min:.4f}, accept {acc:.4f} (K3r {n_d})")
        if not (p_min > 1e-3 and acc > 0.05):
            fail(f"(d): p_min {p_min:.4g} or accept {acc:.4f} below the reference's gates")

        # (e) sensor design at res4, then a pipeline on the designed sensors
        t0 = time.perf_counter()
        design = design_sensors(pipe4.fin, pipe4.prior, n_sensors=P16_SENSORS, noise_sigma=1e-2,
                                n_draws=P16_DRAWS, gen=torch.Generator(device="cuda").manual_seed(0), tol=TOL,
                                maxiter=MAXITER)
        torch.cuda.synchronize()
        design_s = time.perf_counter() - t0
        fin_s = with_sensor_qoi(pipe4.fin, design.node_ids)
        cfg_s = dataclasses.replace(pipe4.config, mcmc=dataclasses.replace(pipe4.config.mcmc, **P16_SENSOR_PCN))
        t0 = time.perf_counter()
        pipe_s, n_e, _ = counted(lambda: api.build_pipeline(cfg_s, device="cuda", fin=fin_s))
        build_s = time.perf_counter() - t0
        inv_s, n_e2, _ = counted(lambda: api.run_inversion(pipe_s))
        k3r += n_e + n_e2
        acc_s = float(inv_s.result.accept_rate.mean())
        say("P16", f"[{card}] (e) design_sensors res4, {P16_SENSORS} sensors from {len(design.candidates)} "
            f"candidates, {P16_DRAWS} draws: {design_s:.2f} s, nodes {design.node_ids.tolist()} at "
            f"{np.round(design.xy, 4).tolist()}, EIG trace {np.round(design.eig_trace, 4).tolist()}, gains "
            f"{np.round(design.gains, 4).tolist()}; build on the sensors {build_s:.2f} s (K3r {n_e}), n_obs "
            f"{pipe_s.fin.op.n_obs}; pcn rom_nn m = 3 {inv_s.wall_seconds:.3f} s, accept {acc_s:.4f} (K3r "
            f"{n_e2}, the truth solve)")
        if not (np.all(np.diff(design.eig_trace) > 0) and np.all(design.gains > 0)):
            fail("(e): the EIG trace does not rise strictly")
        if pipe_s.fin.op.n_obs != P16_SENSORS or not 0.05 < acc_s < 0.9:
            fail(f"(e): n_obs {pipe_s.fin.op.n_obs}, accept {acc_s:.4f} outside (0.05, 0.9)")

        # (f) the greedy basis at res4
        hostV = []
        ortho = api.orthonormalize_host
        api.orthonormalize_host = lambda S: hostV.append(ortho(S)) or hostV[-1]
        cfg_g = dataclasses.replace(pipe4.config, rom=dataclasses.replace(pipe4.config.rom, method="greedy"))
        log_g = MetricsLogger()
        t0 = time.perf_counter()
        try:
            pipe_g, n_f, _ = counted(lambda: api.build_pipeline(cfg_g, device="cuda", metrics=log_g))
        finally:
            api.orthonormalize_host = ortho
        build_g = time.perf_counter() - t0
        k3r += n_f
        gen = torch.Generator(device="cuda").manual_seed(1)
        k_test = sample_log_uniform(gen, 64, dtype=torch.float32)
        (y_fom,), n_f2, _ = counted(lambda: (pipe_g.fin.op.observe(api.make_fom_solver(
            pipe_g.fin, tol=TOL, maxiter=MAXITER)(k_test)),))
        k3r += n_f2
        rel = float(torch.linalg.norm(pipe_g.rom.forward(k_test) - y_fom) / torch.linalg.norm(y_fom))
        V = hostV[0]
        orth = float(np.abs(V.T @ V - np.eye(V.shape[1])).max())
        sg = log_g.summary()
        say("P16", f"[{card}] (f) greedy build res4, r = {pipe_g.rom.r} from {cfg_g.rom.greedy_candidates} "
            f"candidates: {build_g:.2f} s (snapshots stage {sg['snapshots']['seconds']:.2f} s), K3r {n_f}; "
            f"rom rel_err_vs_fom {rel:.4e} (gate 0.1); host V^T V - I max {orth:.3e} (gate 1e-10); holdout "
            f"rom {sg['holdout_rel_err']['rom']:.4e} corrected {sg['holdout_rel_err']['corrected']:.4e}")
        if not rel < 0.1 or not orth <= 1e-10 or sg["rom_built"]["method"] != "greedy":
            fail(f"(f): rel err {rel:.4e} or V^T V {orth:.3e} off")
    finally:
        K.pcg_stencil_tile = tile
    say("P16", f"K3r launches over phase 16: {k3r}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return k3r


# (c), (d): the reference's full-field DA test's noise (tests/test_full_field_pipeline.py:213),
# its unimodal regime; at invert-ff's default 1e-3 the posterior is multimodal and a
# 24-step DA run's outer accept read 0.305 (PERF.md). (e)'s invert-ff runs at 1e-3.
P17_NOISE = 1e-2
P17_TIMED = (256, 1024)  # K3r on nodal planes: the snapshot sweep's batch and the dataset's
P17_PCN = dict(n_chains=1024, n_steps=600, n_burn=300)  # (c): cut from invert-ff's 5,000 / 1,000
P17_DA = dict(n_chains=1024, n_steps=24, n_burn=8, subchain=8)  # (d): cut from 5,000 / 1,000
P17_DA_SEGMENT = 64  # run_full_field_inversion's segment for da_pcn on fom
P17_MLDA = dict(n_chains=256, n_steps=6, n_burn=2, subchain=8, mlda_subchain=2, mlda_resolution=2)
P17_MLDA_SEGMENT = 32  # run_full_field_inversion's segment for mlda_pcn
P17_LIS = dict(n_chains=256, n_steps=300, n_burn=100, lis_points=16)  # (e)
P17_SMC = dict(n_particles=1024, n_groups=4, n_mutations=5, max_stages=64)  # (e): evidence-ff on fom
P17_ELL = dict(ells=(0.5, 1.0), ell_true=1.0, resolution=2, n_particles=512, n_groups=4,
               n_mutations=2, max_stages=32, noise_sigma=1e-2)  # (e): select-ell, cut
P17_CLI = ["invert-ff", "--n-snapshots", "64", "--n-train", "256", "--epochs", "20", "--chains", "256",
           "--steps", "200", "--burn", "100"]  # (e): invert-ff through the CLI at cut sizes
# the JSON keys of the reference CLI's invert-ff (its cmd_invert_ff)
P17_CLI_KEYS = {"likelihood", "sampler", "n_features", "samples_per_sec", "ess_min", "accept_rate",
                "rhat_split_max", "data_misfit_posterior_mean", "data_misfit_prior_mean", "ppc_p_value"}
P17_UNDEFLATED_B = 256  # (f)
P17_B_GATE = 1e-5  # (b): the card's coarse matrices against a host float64 projection, relative


def _nodal_direct(pipe, G64, host, k64: np.ndarray) -> np.ndarray:
    """The float64 sparse direct solve of the nodal operator at the nodal
    conductivities k64 (its planes assembled on the host from G in float64)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from bayesianinferencedl_tpu_torch.rom.nonaffine import _nodal_vals_host

    vals = _nodal_vals_host(G64, host.offsets, k64) + pipe.biot * host.ext_mass + host.fixed
    n = host.n
    rows, cols, data = [], [], []
    for s, off in enumerate(host.offsets):
        r = np.arange(n)
        c = r + int(off)
        ok = (c >= 0) & (c < n) & (vals[:, s] != 0)
        rows.append(r[ok])
        cols.append(c[ok])
        data.append(vals[ok, s])
    A = sp.csr_matrix((np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))
    return spla.spsolve(A.tocsc(), host.F_root)


def phase_full_field(card):
    """Phase 17: the full-field slice (api_full_field) on the card, K3r on
    nodal planes. Every FOM kernel's count is set to 0 before each entry
    point and read after it.

    (a) build_full_field_pipeline at invert-ff's defaults (res4, 64 RFF
    features, ell 1, sigma 0.5, 256 snapshots, r 40, k basis 40, 1,024 +
    128 error rows, a (128, 128) tanh MLP over 3,000 steps): the stage
    seconds, each stage's K3r launches (one batched solve in each of the
    snapshot, dataset and holdout stages), every "fom_solve" event's
    highest iteration count against the cap and its failed factorisations,
    the assembler, the ROM and corrected holdout errors. Gates: the
    native assembler, K3r carrying exactly those 3 solves (K1 and K3 none),
    no solve at the cap and none failed, the corrected holdout error below
    the ROM's. (b) K3r against pcg_stencil_reference on the build's 256
    snapshot conductivities, both with the same Binv from
    coarse_inverses_from_vals: every per-sample gap <= 1e-4, counts within
    16 a sample (phase 2's gates), none at the cap, 2 samples within 1e-4
    of a float64 direct solve of the nodal operator; the card's coarse
    matrices against a host float64 projection of the same planes on 4
    samples (relative <= 1e-5); 0 failed factorisations. K3r and the plain
    version timed by CUDA events at B = 256 and 1,024 (the dataset's
    conductivities), with the coarse projection and inverse timed apart,
    the least-work bound and the streaming floor (phase 5's). (c)
    run_full_field_inversion, pcn on rom_nn, 1,024 chains, 600 steps (300
    burn-in; cut from invert-ff's 5,000 / 1,000 for the time limit), noise
    1e-2 (the regime of the reference's own full-field DA test; at
    invert-ff's 1e-3 the posterior is multimodal, see P17_NOISE), seed 0:
    accept in (0.05, 0.9), split-R-hat printed, the
    posterior mean's data misfit below the prior mean's, K3r exactly 1
    launch (the truth solve). (d) da_pcn on fom, subchains of 8, the same
    seed (so the same truth and data), 1,024 chains, 24 outer steps (8
    burn-in; cut from 5,000 / 1,000): K3r exactly one launch an outer step
    plus the truth solve's, the warm-up's (its init and 2 steps), each
    segment's init and the audit's; outer accept > 0.6, inner in (0.05,
    0.9); no audited state at the cap; means within 5 MCSE of (c)'s. (e)
    at cut sizes, each with its seconds: mlda_pcn on (c)'s data with the
    mid rung at res2 (256 chains, subchains (8, 2), 6 top steps, 2
    burn-in), K3r's launches by mesh exactly as the run's structure says;
    lis_pcn on rom_nn (256 chains, 300 steps, 100 burn-in, 16 Jacobian
    points); run_full_field_evidence on fom (1,024 particles in 4 groups, 5
    mutations): log Z finite and K3r exactly 2 + 5 x the most stages of a
    group; select_correlation_length over ell 0.5 and 1.0 at res2 (cut
    from res4; 512 particles in 4 groups, 2 mutations, at most 32 stages,
    noise 1e-2): each log Z finite and K3r exactly 1 + the sum over the
    ells of 1 + 2 x the most stages; invert-ff through cli.main (64
    snapshots, 256 error rows, 200 surrogate steps, 256 chains x 200 steps;
    cut): its JSON keys the reference's. (f) make_fom_solver(deflate=False)
    at res4 on 256 log-uniform conductivities through K3r undeflated (1
    launch) against the plain version (every gap <= 1e-4, mean counts
    within 5%, none at the cap); solve_fom with refine_steps=1 on one
    conductivity, its float64 residual no higher than without; the res4
    FiveParamFin on the native assembler, its host arrays equal to the
    NumPy assembler's (1e-14, summation order). Returns K3r's launches on
    the entry points (the comparisons of (b) not counted), its gap from the
    plain version and the nodal timings."""
    import dataclasses

    import torch

    from bayesianinferencedl_tpu_torch import api, api_full_field as aff, cli
    from bayesianinferencedl_tpu_torch.fem.dia import assemble_fin_dia
    from bayesianinferencedl_tpu_torch.fem.dia_nonaffine import assemble_nodal_coeff
    from bayesianinferencedl_tpu_torch.fem.solve import solve_fom
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin, assemble_host
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.rom.nonaffine import _stencil_apply_host
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    tag = "P17"
    k3r = 0

    def reset():
        K.launches = K.tile_launches = K.tile_mma_launches = 0

    def read(what):
        torch.cuda.synchronize()
        if K.launches or K.tile_launches:
            fail(f"{tag} {what}: K1 {K.launches} / K3 {K.tile_launches} launches where K3r carries "
                 f"the fom solves")
        return K.tile_mma_launches

    class Counting(MetricsLogger):
        """Every event carries K3r's launch count when it was logged."""

        def log(self, event, **fields):
            torch.cuda.synchronize()
            return super().log(event, k3r=K.tile_mma_launches, **fields)

    # (a) the build at invert-ff's defaults
    reset()
    log = Counting()
    t0 = time.perf_counter()
    pipe = aff.build_full_field_pipeline(metrics=log)
    t_build = time.perf_counter() - t0
    n_build = read("(a) build")
    k3r += n_build
    stages, prev = [], 0
    for e in log.events:
        if "seconds" in e:
            stages.append(f"{e['event']} {e['seconds']:.2f} s / K3r {e['k3r'] - prev}")
            prev = e["k3r"]
    ev = {e["event"]: e for e in log.events}
    solves = [e for e in log.events if e["event"] == "fom_solve"]
    hold = ev["holdout_rel_err"]
    say(tag, f"[{card}] (a) build_full_field_pipeline at invert-ff's defaults (res{pipe.op.resolution}, "
        f"n = {pipe.op.n}, M = {pipe.prior.dim}, m = {pipe.deflation.m}): {t_build:.2f} s; stages: "
        + "; ".join(stages))
    say(tag, f"(a) assembler {ev['fom_built']['assembler']}; fom_solve events (batch, max iters / cap, "
        f"at cap, failed): " + ", ".join(f"({e['batch']}, {e['max_iters']}/{e['cap']}, {e['n_at_cap']}, "
                                          f"{e['n_failed']})" for e in solves)
        + f"; ROM rel err {ev['rom_rel_err']['value']:.4e}, corrected (train) "
        f"{ev['corrected_rel_err']['value']:.4e}; holdout ROM {hold['rom']:.4e}, corrected "
        f"{hold['corrected']:.4e}; K3r launches {n_build}")
    if ev["fom_built"]["assembler"] != "native":
        fail(f"{tag} (a): the host operator came from the {ev['fom_built']['assembler']} assembler")
    if [e["batch"] for e in solves] != [256, 1024, 128] or n_build != 3:
        fail(f"{tag} (a): K3r {n_build} launches for the solves {[e['batch'] for e in solves]}, "
             f"expected 3 for (256, 1024, 128)")
    if any(e["n_at_cap"] or e["n_failed"] for e in solves):
        fail(f"{tag} (a): a build solve hit the cap or failed its coarse factorisation")
    if not hold["corrected"] < hold["rom"]:
        fail(f"{tag} (a): holdout corrected {hold['corrected']:.4e} not below the ROM's {hold['rom']:.4e}")

    # (b) K3r against its plain version on nodal planes
    op, defl, dev = pipe.op, pipe.deflation, pipe.device
    host, _ = assemble_host(pipe.mesh)
    G64 = assemble_nodal_coeff(pipe.mesh, host)
    M = pipe.prior.dim
    ks_by_B = {
        256: torch.exp(pipe.field.sample(torch.Generator(device=dev).manual_seed(0), 256)),
        1024: torch.exp(pipe.field.theta(torch.randn(
            (1024, M), generator=torch.Generator(device=dev).manual_seed(1), device=dev))),
    }
    times, max_abs = {}, 0.0
    for B in P17_TIMED:
        ks = ks_by_B[B]
        vals = op.vals(ks)
        vals4 = K.upper_planes(vals)
        Binv = defl.coarse_inverses_from_vals(op, vals).contiguous()
        n_bad = int((~torch.isfinite(Binv).all(dim=(1, 2))).sum())
        kw = dict(offsets=op.offsets[K.DIAG_SLOT + 1:], tol=pipe.cg_tol, maxiter=pipe.cg_maxiter,
                  Wt=defl.Wt_bf16, Binv=Binv, check_every=CHECK_EVERY)
        x_r, it_r = K.pcg_stencil_tile(vals4, op.F_root, None, **kw)
        xp, itp = K.pcg_stencil_reference(vals4, op.F_root, None, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(x_r).all():
            fail(f"{tag} (b) B={B}: non-finite K3r solution")
        rel_s = (torch.linalg.norm(x_r - xp, dim=1) / torch.linalg.norm(xp, dim=1)).cpu().numpy()
        gap = (x_r - xp).abs().max().item()
        max_abs = max(max_abs, gap)
        it, ip = it_r.cpu().numpy(), itp.cpu().numpy()
        d_it = np.abs(it - ip)
        say(tag, f"(b) B={B} nodal planes (cluster of {_cluster(B)}): K3r vs plain per-sample rel max "
            f"{rel_s.max():.3e} (max abs {gap:.3e}); iters K3r min/median/max {it.min()}/"
            f"{int(np.median(it))}/{it.max()}, plain {ip.min()}/{int(np.median(ip))}/{ip.max()}, cap "
            f"{pipe.cg_maxiter}; per-sample count difference max {d_it.max()}; failed coarse "
            f"factorisations {n_bad}")
        if n_bad:
            fail(f"{tag} (b) B={B}: {n_bad} coarse factorisations failed")
        if rel_s.max() > REL_GATE or d_it.max() > CHECK_EVERY:
            fail(f"{tag} (b) B={B}: K3r vs plain {rel_s.max():.3e} (gate {REL_GATE:g}) or count "
                 f"difference {d_it.max()} (gate {CHECK_EVERY})")
        if it.max() >= pipe.cg_maxiter or ip.max() >= pipe.cg_maxiter:
            fail(f"{tag} (b) B={B}: a solve at the {pipe.cg_maxiter}-iteration cap")
        if B == 256:
            errs = []
            for b in range(2):
                us = _nodal_direct(pipe, G64, host, ks[b].double().cpu().numpy())
                errs.append(np.linalg.norm(x_r[b].double().cpu().numpy() - us) / np.linalg.norm(us))
            say(tag, f"(b) K3r vs the float64 direct solve of the nodal operator (2 samples): "
                f"{np.round(errs, 8).tolist()}")
            if max(errs) > REL_GATE:
                fail(f"{tag} (b): K3r {max(errs):.3e} from the float64 direct solve (gate {REL_GATE:g})")
            Bc = defl.coarse_matrices_from_vals(op, vals[:4]).double().cpu().numpy()
            Wt64 = defl.Wt.double().cpu().numpy()
            v64 = vals[:4].double().cpu().numpy()
            Bh = [Wt64 @ _stencil_apply_host(v64[b], host.offsets, Wt64.T) for b in range(4)]
            rel_B = max(np.linalg.norm(Bc[b] - 0.5 * (Bh[b] + Bh[b].T)) / np.linalg.norm(Bh[b])
                        for b in range(4))
            say(tag, f"(b) coarse matrices, card vs host float64 projection of the same planes (4 "
                f"samples): relative {rel_B:.3e} (gate {P17_B_GATE:g})")
            if rel_B > P17_B_GATE:
                fail(f"{tag} (b): the card's coarse projection {rel_B:.3e} from the host's")
        del x_r, xp
        r_ms = _time_ms(lambda: K.pcg_stencil_tile(vals4, op.F_root, None, **kw), 5)
        c_ms = _time_ms(lambda: defl.coarse_inverses_from_vals(op, vals), 5)
        p_ms = _time_ms(lambda: K.pcg_stencil_reference(vals4, op.F_root, None, **kw), 3)
        bound, floor = _k1_bound(B, op.n, defl.m, it), _stream_floor(K3R_BYTES, op.n, it)
        times[B] = dict(ms=r_ms, plain_ms=p_ms, coarse_ms=c_ms, bound=bound, floor=floor,
                        iters_mean=float(it.mean()))
        say(tag, f"(b) B={B}: K3r {r_ms:.3f} ms, plain torch {p_ms:.3f} ms, the coarse projection "
            f"and inverses {c_ms:.3f} ms; mean count {it.mean():.2f}; least-work bound "
            f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / r_ms:.2f}% of it; streaming floor "
            f"({K3R_BYTES} B per node, sample and iteration) {floor:.3f} ms, "
            f"{100 * floor / r_ms:.1f}% of it")

    # (c) pcn on rom_nn
    reset()
    seed0 = lambda: torch.Generator(device=dev).manual_seed(0)
    res_c, z_true, data, ess_c, rh_c, wall_c = aff.run_full_field_inversion(
        pipe, noise_sigma=P17_NOISE, generator=seed0(), **P17_PCN)
    n_c = read("(c) pcn")
    k3r += n_c
    fwd = pipe.batched_forward_fn("rom_nn")
    z_post = res_c.samples.mean(dim=(0, 1))
    fit_post = float(torch.linalg.norm(fwd(z_post[None])[0] - data))
    fit_prior = float(torch.linalg.norm(fwd(torch.zeros_like(z_post)[None])[0] - data))
    acc_c = float(res_c.accept_rate.mean())
    T_c, C_c = res_c.samples.shape[:2]
    say(tag, f"(c) pcn rom_nn, {C_c} chains, {P17_PCN['n_steps']} steps ({P17_PCN['n_burn']} burn-in), "
        f"noise {P17_NOISE:g}: {wall_c:.3f} s, {1e3 * wall_c / P17_PCN['n_steps']:.2f} ms a step, "
        f"{T_c * C_c / wall_c:.0f} kept samples/s; accept {acc_c:.4f}; split-rhat max "
        f"{float(rh_c.max()):.4f}; bulk ESS min {float(ess_c.min()):.1f}; data misfit of the posterior "
        f"mean {fit_post:.4e} vs the prior mean's {fit_prior:.4e}; K3r launches {n_c}")
    if not 0.05 < acc_c < 0.9 or not fit_post < fit_prior or n_c != 1:
        fail(f"{tag} (c): accept {acc_c:.4f}, misfit {fit_post:.4e} vs {fit_prior:.4e}, K3r {n_c} "
             f"(expected 1, the truth solve)")

    # (d) da_pcn on fom
    reset()
    log_d = MetricsLogger()
    d = P17_DA
    res_d, _, data_d, ess_d, rh_d, wall_d = aff.run_full_field_inversion(
        pipe, likelihood="fom", sampler="da_pcn", noise_sigma=P17_NOISE, generator=seed0(),
        metrics=log_d, **d)
    n_d = read("(d) da_pcn")
    k3r += n_d
    T = d["n_steps"]
    seg = -(-T // P17_DA_SEGMENT)
    want = 1 + (1 + 2) + (seg + T) + 1  # truth, warm-up (init + 2 steps), run, audit
    audit = log_d.summary()["fom_iter_audit"]
    outer, inner = float(res_d.accept_rate.mean()), float(res_d.inner_accept_rate.mean())
    means, sds, zz, sd_rel, rhats = _posterior_z(res_d.samples, res_c.samples)
    say(tag, f"(d) da_pcn fom, {d['n_chains']} chains, subchains of {d['subchain']}, {T} outer steps "
        f"({d['n_burn']} burn-in): {wall_d:.3f} s, {1e3 * wall_d / T:.1f} ms an outer step; outer accept "
        f"{outer:.4f}, inner {inner:.4f}; split-rhat {rhats[0]:.4f}; audit cap {audit['cap']}, max "
        f"{audit['max_iters']}, at cap {audit['hit_cap_frac']}; |mean diff| / MCSE vs (c) max "
        f"{zz.max():.2f} (median {np.median(zz):.2f}); K3r launches {n_d} (expected {want}: {T} outer "
        f"steps, the truth solve, the warm-up's 3, {seg} segment init, the audit)")
    if not torch.equal(data_d, data):
        fail(f"{tag} (d): the data differ from (c)'s")
    if n_d != want or outer <= 0.6 or not 0.05 < inner < 0.9 or audit["hit_cap_frac"] > 0:
        fail(f"{tag} (d): K3r {n_d} (expected {want}), outer {outer:.4f}, inner {inner:.4f}, audit "
             f"{audit}")
    if zz.max() > 5.0:
        fail(f"{tag} (d): a posterior mean {zz.max():.2f} MCSE from (c)'s")

    # (e) at cut sizes
    by_n = {}
    tile = K.pcg_stencil_tile

    def split_tile(vals4, F, *a, **kw):  # the batch's mesh, by F's length
        by_n[F.shape[-1]] = by_n.get(F.shape[-1], 0) + 1
        return tile(vals4, F, *a, **kw)

    K.pcg_stencil_tile = split_tile
    try:
        reset()
        m = P17_MLDA
        t0 = time.perf_counter()
        res_m, *_ = aff.run_full_field_inversion(pipe, likelihood="fom", sampler="mlda_pcn", data=data,
                                                 z_true=z_true, noise_sigma=P17_NOISE, generator=seed0(), **m)
        t_m = time.perf_counter() - t0
        n_m = read("(e) mlda_pcn")
        k3r += n_m
        T, ms = m["n_steps"], m["mlda_subchain"]
        seg = -(-T // P17_MLDA_SEGMENT)
        n2 = next(n for n in by_n if n != op.n) if len(by_n) > 1 else None
        want_fine = (1 + 2) + (seg + T) + 1  # warm-up (init + 2 steps), run, audit
        want_mid = (1 + 2 * ms) + (ms * T + seg)
        say(tag, f"(e) mlda_pcn fom, mid rung res{m['mlda_resolution']}, {m['n_chains']} chains, "
            f"subchains ({m['subchain']}, {ms}), {T} top steps: {t_m:.2f} s; accept top "
            f"{float(res_m.accept_rate.mean()):.4f}, per level {np.round(res_m.level_rates.mean(1).cpu().numpy(), 4).tolist()}; "
            f"K3r launches res{pipe.op.resolution} {by_n.get(op.n, 0)} (expected {want_fine}), "
            f"res{m['mlda_resolution']} {by_n.get(n2, 0)} (expected {want_mid})")
        if by_n.get(op.n, 0) != want_fine or by_n.get(n2, 0) != want_mid:
            fail(f"{tag} (e) mlda_pcn: K3r launches by mesh {by_n}")
    finally:
        K.pcg_stencil_tile = tile

    reset()
    t0 = time.perf_counter()
    log_l = MetricsLogger()
    res_l, *_ = aff.run_full_field_inversion(pipe, sampler="lis_pcn", data=data, z_true=z_true,
                                             noise_sigma=P17_NOISE, generator=seed0(), metrics=log_l,
                                             **P17_LIS)
    t_l = time.perf_counter() - t0
    lis_ev = log_l.summary()
    acc_l = float(res_l.accept_rate.mean())
    say(tag, f"(e) lis_pcn rom_nn, {P17_LIS['n_chains']} chains x {P17_LIS['n_steps']} steps: "
        f"{t_l:.2f} s (MAP + Laplace {lis_ev['map_laplace']['seconds']:.2f} s, LIS build "
        f"{lis_ev['build_lis']['seconds']:.2f} s, rank {lis_ev['lis_built']['rank']}); accept {acc_l:.4f}")
    if not torch.isfinite(res_l.samples).all() or not 0.0 < acc_l < 1.0:
        fail(f"{tag} (e) lis_pcn: accept {acc_l:.4f} or non-finite samples")
    k3r += read("(e) lis_pcn")

    reset()
    t0 = time.perf_counter()
    ev_f = aff.run_full_field_evidence(pipe, likelihood="fom", noise_sigma=P17_NOISE, generator=seed0(),
                                       **P17_SMC)
    n_e = read("(e) evidence")
    k3r += n_e
    want = 2 + P17_SMC["n_mutations"] * int(ev_f.n_stages.max())
    say(tag, f"(e) evidence-ff on fom, {P17_SMC['n_particles']} particles in {P17_SMC['n_groups']} "
        f"groups: {time.perf_counter() - t0:.2f} s; log Z {ev_f.log_evidence:.4f} +- "
        f"{ev_f.log_evidence_std:.4f}, stages {ev_f.n_stages.cpu().tolist()}; K3r launches {n_e} "
        f"(expected {want})")
    if not np.isfinite(ev_f.log_evidence) or n_e != want:
        fail(f"{tag} (e) evidence: log Z {ev_f.log_evidence}, K3r {n_e} (expected {want})")

    reset()
    t0 = time.perf_counter()
    log_s = MetricsLogger()
    e = P17_ELL
    sel = aff.select_correlation_length(e["ells"], ell_true=e["ell_true"], resolution=e["resolution"],
                                        noise_sigma=e["noise_sigma"], n_particles=e["n_particles"],
                                        n_groups=e["n_groups"], n_mutations=e["n_mutations"],
                                        max_stages=e["max_stages"], metrics=log_s)
    n_s = read("(e) select-ell")
    k3r += n_s
    stages = [max(x["n_stages"]) for x in log_s.events if x["event"] == "ff_smc_evidence"]
    want = 1 + sum(1 + e["n_mutations"] * s for s in stages)
    say(tag, f"(e) select-ell at res{e['resolution']} over ell {list(e['ells'])} (truth {e['ell_true']}): "
        f"{time.perf_counter() - t0:.2f} s; log Z {sel['log_z']} +- {sel['log_z_std']}, posterior "
        f"{sel['posterior']}, ell_map {sel['ell_map']}; most stages {stages}; K3r launches {n_s} "
        f"(expected {want})")
    if not np.all(np.isfinite(sel["log_z"])) or n_s != want:
        fail(f"{tag} (e) select-ell: log Z {sel['log_z']}, K3r {n_s} (expected {want})")

    reset()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(P17_CLI)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    n_cli = read("(e) invert-ff")
    k3r += n_cli
    say(tag, f"(e) {' '.join(P17_CLI)}: {time.perf_counter() - t0:.2f} s; {json.dumps(rec)}; K3r "
        f"launches {n_cli}")
    if set(rec) != P17_CLI_KEYS or not np.isfinite(rec["data_misfit_posterior_mean"]):
        fail(f"{tag} (e) invert-ff: keys {sorted(rec)} are not the reference's {sorted(P17_CLI_KEYS)}")

    # (f) the undeflated solver, refinement and the native assembler
    fin = FiveParamFin.create(resolution=4, device="cuda", cg_tol=TOL, cg_maxiter=MAXITER)
    ref = assemble_fin_dia(fin.mesh, pad_to=128)
    gaps = {f: float(np.abs(getattr(fin.host, f) - getattr(ref, f)).max())
            for f in ("comp_vals", "ext_mass", "fixed", "F_root", "qoi", "qoi_root")}
    say(tag, f"(f) FiveParamFin res4 assembler {fin.assembler}; host arrays vs the NumPy assembler, "
        f"max abs {max(gaps.values()):.3e}")
    if fin.assembler != "native" or max(gaps.values()) > 1e-14:
        fail(f"{tag} (f): assembler {fin.assembler}, gaps {gaps}")
    rng = np.random.default_rng(17)
    ks_np = np.exp(rng.uniform(np.log(0.1), np.log(10.0), (P17_UNDEFLATED_B, 5)))
    ks = torch.tensor(ks_np, dtype=torch.float32, device=dev)
    reset()
    u, it = api.make_fom_solver(fin, tol=TOL, maxiter=MAXITER, deflate=False, with_iters=True)(ks)
    n_f = read("(f) make_fom_solver(deflate=False)")
    k3r += n_f
    vals4 = K.upper_planes(fin.op.vals(ks))
    up, ip = K.pcg_stencil_reference(vals4, fin.op.F_root, None, offsets=fin.op.offsets[K.DIAG_SLOT + 1:],
                                     tol=TOL, maxiter=MAXITER, check_every=CHECK_EVERY)
    rel_s = (torch.linalg.norm(u - up, dim=1) / torch.linalg.norm(up, dim=1)).cpu().numpy()
    it, ip = it.cpu().numpy(), ip.cpu().numpy()
    max_abs = max(max_abs, (u - up).abs().max().item())
    say(tag, f"(f) make_fom_solver(deflate=False) res4 B={P17_UNDEFLATED_B}: K3r launches {n_f}; vs plain "
        f"per-sample rel max {rel_s.max():.3e}; mean count {it.mean():.1f} vs plain {ip.mean():.1f}, max "
        f"{it.max()} (cap {MAXITER})")
    if n_f != 1 or rel_s.max() > REL_GATE or abs(it.mean() / ip.mean() - 1) > 0.05 or it.max() >= MAXITER:
        fail(f"{tag} (f) undeflated: K3r {n_f}, gap {rel_s.max():.3e}, counts {it.mean():.1f} vs "
             f"{ip.mean():.1f}")
    A, _, _ = _direct_solve(fin, ks_np[0])
    resid = []
    for steps in (0, 1):
        us = solve_fom(fin.op, ks[0], tol=1e-6, maxiter=MAXITER, refine_steps=steps).double().cpu().numpy()
        resid.append(np.linalg.norm(fin.host.F_root - A @ us) / np.linalg.norm(fin.host.F_root))
    say(tag, f"(f) solve_fom tol 1e-6: float64 relative residual {resid[0]:.3e} without refinement, "
        f"{resid[1]:.3e} with refine_steps=1")
    if resid[1] > resid[0]:
        fail(f"{tag} (f): refinement raised the float64 residual")
    say(tag, f"K3r launches over the phase's entry points: {k3r}")
    return dict(launches=k3r, max_abs_err=max_abs, times=times)


# phase 18: the ELL layout, the adjoint oracle and the multigrid FCG
P18_ELL_RES = 8
P18_ELL64 = dict(B=8, tol=1e-10, maxiter=6000)  # (a): float64 against the SciPy oracle
P18_ELL64_GATE = 1e-8
P18_ELL32_B = 64  # (a): float32 against K3r
P18_ELL32_GATE = 1e-4  # the QoI, relative
P18_ADJ_RES = 4  # (b)
P18_ADJ_GATE = 1e-8
# (c): phase 3's mesh, snapshots and basis; the surrogate cut (it does not enter the holdout ROM error)
P18_BUILD = dict(n_snapshots=256, basis_size=40, n_train=256, epochs=20, hidden=(32, 32))
P18_BUILD_GATE = 2.0  # the ELL holdout ROM error at most this times the stencil build's
P18_MG = ((8, 256), (16, 64), (32, 16))  # (d): the JAX package's crossover shapes (res, B)
P18_MG_MAXITER = 150
P18_MG_DIRECT = 2  # samples a shape against the float64 direct solve
_K3_FINS = {}  # res -> phase 5's stencil fin (its deflation basis built), reused by phase 18


def _p18_fin(res):
    """The float32 stencil fin at res with its deflation basis where the
    kernels apply one: phase 5's where it built one, else a new one."""
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin

    if res not in _K3_FINS:
        fin = FiveParamFin.create(resolution=res, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=MAXITER)
        fin.deflation_for_kernels()
        _K3_FINS[res] = fin
    return _K3_FINS[res]


def phase_ell_multigrid(card):
    """Phase 18: the ELL oracle layout, the hand-coded adjoint and the
    multigrid FCG on the card. Every FOM kernel's count is set to 0 before
    each entry point and read after it; an ELL fin and the multigrid must
    reach none, a stencil fin in float32 must reach K3r or K4r.

    (a) ELL at res8 through api.make_fom_solver (the plain PCG of
    fem/solve.py): float64, B = 8, tol 1e-10, within 1e-8 of the port's
    SciPy oracle (fem/oracle.py) on 2 samples; float32, B = 64, tol 1e-7,
    the QoI within 1e-4 (relative) of the stencil fin's K3r solve on the
    same ks, the fields compared at the mesh nodes (infer.oed.
    solution_indices); times and mean counts of both printed. (b) At res4
    in float64 on the card, adjoint_gradient and adjoint_gn_hvp within 1e-8
    (relative) of the fin's autograd gradient and gn_hvp, on both layouts.
    (c) build_pipeline(fin=<ELL fin>) at res4 in float32 with phase 3's
    mesh, 256 snapshots and r = 40 (surrogate cut to (32, 32), 256 samples,
    20 epochs), beside the stencil build from the same config and seeds:
    the ELL build takes the device route (f64_offline False) and its
    holdout ROM error is at most 2x the stencil build's; orthonormality_error
    of both bases printed (float32's method of snapshots loses the trailing
    modes' orthonormality, as the JAX package's does). (d) MGHierarchy.solve
    (float32, tol 1e-7, maxiter 150) at res8 B = 256, res16 B = 64 and
    res32 B = 16, the same ks through make_fom_solver's kernel (K3r
    deflated at res8 and res16, K4r at res32, cap max(1500, 120 res)) and
    at res8 and res16 K3r undeflated (Jacobi-PCG): on 2 samples a shape
    the multigrid's error against the float64 direct solve at most
    max(1e-4, 1.5x the kernel's) per sample; counts, samples at the cap,
    ms (one call after a warm-up, by CUDA events) and solves/s printed, no
    speed gate. Returns the kernels' launches over the phase and the
    crossover rows."""
    import torch
    import torch.nn.functional as F

    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
    )
    from bayesianinferencedl_tpu_torch.experimental.multigrid import MGHierarchy
    from bayesianinferencedl_tpu_torch.fem import oracle
    from bayesianinferencedl_tpu_torch.infer.oed import solution_indices
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.rom.pod import orthonormality_error
    from bayesianinferencedl_tpu_torch.utils.adjoint import adjoint_gn_hvp, adjoint_gradient
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    t_phase = time.perf_counter()
    counters = {"K1": "launches", "K3": "tile_launches", "K3r": "tile_mma_launches", "K4": "grid_launches",
                "K4r": "grid_resident_launches", "K4c": "grid_cluster_launches"}
    launches = {"K3r": 0, "K4r": 0}
    rng = np.random.default_rng(18)
    log_uniform = lambda B: np.exp(rng.uniform(np.log(0.1), np.log(10.0), (B, 5)))
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def counted(fn, want=None):
        """(fn()'s result, its ms by CUDA events), every FOM kernel counted
        from 0: none may launch but ``want``, which must; its count is added
        to the phase's."""
        for attr in counters.values():
            setattr(K, attr, 0)
        ms, out = _time_once_ms(fn)
        got = {k: getattr(K, attr) for k, attr in counters.items()}
        if any(n for k, n in got.items() if k != want) or (want is not None and not got[want]):
            fail(f"P18: kernel launches {got}, expected only {want}")
        if want is not None:
            launches[want] += got[want]
        return out, ms

    # (a) ELL at res8
    c = P18_ELL64
    ell64 = FiveParamFin.create(resolution=P18_ELL_RES, biot=0.1, dtype=torch.float64, device="cuda",
                                layout="ell", cg_tol=c["tol"], cg_maxiter=c["maxiter"])
    ks64 = log_uniform(c["B"])
    solve64 = api.make_fom_solver(ell64, tol=c["tol"], maxiter=c["maxiter"], with_iters=True)
    (u64, it64), ms64 = counted(lambda: solve64(ks64))
    nd = ell64.op.n_dof
    errs = []
    for i in range(2):
        ur = oracle.solve(ell64.mesh, ks64[i], 0.1)
        errs.append(float(np.linalg.norm(u64[i, :nd].cpu().numpy() - ur) / np.linalg.norm(ur)))
    say("P18", f"[{card}] (a) ELL res{P18_ELL_RES} (n = {ell64.op.n}, {nd} nodes, L = "
        f"{ell64.op.cols.shape[1]}) float64 B={c['B']} tol {c['tol']:g}: {ms64:.1f} ms, counts mean "
        f"{float(it64.float().mean()):.1f} max {int(it64.max())}; error vs the SciPy oracle "
        f"{[f'{e:.3e}' for e in errs]} (gate {P18_ELL64_GATE:g})")
    if max(errs) > P18_ELL64_GATE or int(it64.max()) >= c["maxiter"]:
        fail(f"(a): ELL float64 error {max(errs):.3e} or a sample at the cap")
    ell32 = FiveParamFin.create(resolution=P18_ELL_RES, biot=0.1, device="cuda", layout="ell", cg_tol=TOL,
                                cg_maxiter=MAXITER)
    dia = _p18_fin(P18_ELL_RES)
    ks32 = torch.tensor(log_uniform(P18_ELL32_B), dtype=torch.float32, device="cuda")
    s_ell = api.make_fom_solver(ell32, tol=TOL, maxiter=MAXITER, with_iters=True)
    s_dia = api.make_fom_solver(dia, tol=TOL, maxiter=MAXITER, with_iters=True)
    s_ell(ks32), s_dia(ks32)  # warm-up
    (ue, ie), ms_e = counted(lambda: s_ell(ks32))
    (ud, idd), ms_d = counted(lambda: s_dia(ks32), want="K3r")
    ye, yd = ell32.op.observe(ue), dia.op.observe(ud)
    q_rel = float((torch.linalg.norm(ye - yd, dim=-1) / torch.linalg.norm(yd, dim=-1)).max())
    ne, ndia = (torch.as_tensor(solution_indices(f), device="cuda") for f in (ell32, dia))
    f_rel = float((torch.linalg.norm(ue[:, ne] - ud[:, ndia], dim=-1)
                   / torch.linalg.norm(ud[:, ndia], dim=-1)).max())
    say("P18", f"(a) float32 B={P18_ELL32_B} tol {TOL:g}: ELL plain PCG {ms_e:.1f} ms, counts mean "
        f"{float(ie.float().mean()):.1f}; stencil K3r (deflated) {ms_d:.1f} ms, counts mean "
        f"{float(idd.float().mean()):.1f}; ELL / K3r time {ms_e / ms_d:.2f}x; QoI rel diff max {q_rel:.3e} "
        f"(gate {P18_ELL32_GATE:g}), field at the mesh nodes {f_rel:.3e}")
    if not q_rel <= P18_ELL32_GATE or int(ie.max()) >= MAXITER:
        fail(f"(a): ELL float32 QoI {q_rel:.3e} off K3r's, or a sample at the cap")
    out = dict(ell=dict(f64_ms=ms64, f64_iters=float(it64.float().mean()), f32_ms=ms_e,
                        f32_iters=float(ie.float().mean()), k3r_ms=ms_d, k3r_iters=float(idd.float().mean())))

    # (b) the hand-coded adjoints against autograd, float64 on the card
    k = np.array([0.7, 1.4, 2.2, 0.9, 1.1])
    v = np.array([0.3, -0.2, 0.5, 0.1, -0.4])
    for layout in ("ell", "dia"):
        fin = FiveParamFin.create(resolution=P18_ADJ_RES, biot=0.1, dtype=torch.float64, device="cuda",
                                  layout=layout, cg_tol=1e-12, cg_maxiter=4000)
        data = fin.forward_batch(torch.ones(1, 5, dtype=torch.float64, device="cuda"))[0] * 1.02
        g_adj, ms_g = counted(lambda: adjoint_gradient(fin.op, k, data, 0.01))
        h_adj, ms_h = counted(lambda: adjoint_gn_hvp(fin.op, k, v, 0.01))
        g_auto, h_auto = fin.gradient(k, data, 0.01), fin.gn_hvp(k, v, 0.01)
        eg, eh = rel(g_adj, g_auto), rel(h_adj, h_auto)
        say("P18", f"(b) res{P18_ADJ_RES} {layout} float64: adjoint_gradient vs autograd {eg:.3e} "
            f"({ms_g:.1f} ms), adjoint_gn_hvp vs autograd {eh:.3e} ({ms_h:.1f} ms); gate {P18_ADJ_GATE:g}")
        if not max(eg, eh) <= P18_ADJ_GATE:
            fail(f"(b): {layout} adjoint off autograd by {max(eg, eh):.3e}")

    # (c) an ELL pipeline beside the stencil build from the same config and seeds
    b = P18_BUILD
    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=4), fem=FEMConfig(biot=0.1, cg_tol=TOL, cg_maxiter=MAXITER),
        rom=ROMConfig(n_snapshots=b["n_snapshots"], basis_size=b["basis_size"]),
        surrogate=SurrogateConfig(hidden=b["hidden"], n_train=b["n_train"], epochs=b["epochs"]),
        mcmc=MCMCConfig(noise_sigma=1e-2),
    )
    built = {}
    for layout in ("ell", "dia"):
        fin = FiveParamFin.create(resolution=4, biot=0.1, device="cuda", layout=layout, cg_tol=TOL,
                                  cg_maxiter=MAXITER)
        log = MetricsLogger()
        pipe, ms = counted(lambda: api.build_pipeline(cfg, device="cuda", fin=fin, metrics=log),
                           want=None if layout == "ell" else "K3r")
        s = log.summary()
        built[layout] = dict(ms=ms, holdout=s["holdout_rel_err"]["rom"], f64=s["rom_built"]["f64_offline"],
                             orth=float(orthonormality_error(pipe.rom.V)), snap=s["snapshots"]["seconds"])
    e, d = built["ell"], built["dia"]
    say("P18", f"(c) build_pipeline res{cfg.mesh.resolution} float32 r = {b['basis_size']}: ELL {e['ms'] / 1e3:.2f} s (snapshots "
        f"stage {e['snap']:.2f} s, f64_offline {e['f64']}), holdout rom {e['holdout']:.4e}, "
        f"orthonormality_error {e['orth']:.3e}; stencil {d['ms'] / 1e3:.2f} s (snapshots {d['snap']:.2f} s, "
        f"f64_offline {d['f64']}), holdout rom {d['holdout']:.4e}, orthonormality_error {d['orth']:.3e}; "
        f"ratio {e['holdout'] / d['holdout']:.3f} (gate {P18_BUILD_GATE:g})")
    if e["f64"] or not d["f64"] or not e["holdout"] <= P18_BUILD_GATE * d["holdout"]:
        fail(f"(c): the ELL build's route or holdout rom error {e['holdout']:.4e} off")
    out["build"] = built

    # (d) the multigrid FCG against the kernels
    rows = []
    for res, B in P18_MG:
        fin = _p18_fin(res)
        cap = max(MAXITER, 120 * res)
        ks_np = log_uniform(B)
        ks = torch.tensor(ks_np, dtype=torch.float32, device="cuda")
        mg = MGHierarchy.create(res, biot=0.1, dtype=torch.float32, device="cuda")
        mg_solve = lambda: mg.solve(ks, tol=TOL, maxiter=P18_MG_MAXITER)
        mg_solve()  # warm-up
        (u_mg, it_mg), ms_mg = counted(mg_solve)
        kname = "K4r" if K.layout_for(fin.op.n) == "single" else "K3r"
        main = api.make_fom_solver(fin, tol=TOL, maxiter=cap, with_iters=True)
        main(ks)  # warm-up
        (u_k, it_k), ms_k = counted(lambda: main(ks), want=kname)
        row = dict(res=res, B=B, n=fin.op.n, kernel=kname, mg_iters=it_mg.cpu().numpy(), mg_ms=ms_mg,
                   k_iters=it_k.cpu().numpy(), k_ms=ms_k, cap=cap)
        if kname == "K3r":
            jac = api.make_fom_solver(fin, tol=TOL, maxiter=cap, deflate=False, with_iters=True)
            jac(ks)  # warm-up
            (_, it_j), ms_j = counted(lambda: jac(ks), want="K3r")
            row.update(jac_iters=it_j.cpu().numpy(), jac_ms=ms_j)
        else:
            row.update(jac_iters=row["k_iters"], jac_ms=ms_k)  # K4r is Jacobi-PCG
        nd = min(P18_MG_DIRECT, B)
        mg_flat = F.pad(u_mg[:nd].reshape(nd, -1), (0, fin.op.n - fin.op.n_grid))
        e_mg, _, _ = _direct_rel_err(fin, ks_np[:nd], mg_flat.double().cpu().numpy())
        e_k, _, _ = _direct_rel_err(fin, ks_np[:nd], u_k[:nd].double().cpu().numpy())
        gate = np.maximum(1e-4, 1.5 * e_k)
        row.update(mg_err=e_mg, k_err=e_k)
        rows.append(row)
        st = lambda it: f"mean {it.mean():.1f} max {int(it.max())}"
        say("P18", f"[{card}] (d) res{res} B={B} (n = {fin.op.n}): MG-FCG {len(mg.levels)} levels "
            f"{ms_mg:.1f} ms ({B / ms_mg * 1e3:.1f} solves/s), counts {st(row['mg_iters'])}, "
            f"{int((row['mg_iters'] >= P18_MG_MAXITER).sum())} at the cap {P18_MG_MAXITER}; {kname} "
            f"{'deflated ' if kname == 'K3r' else ''}{ms_k:.1f} ms ({B / ms_k * 1e3:.1f} solves/s), counts "
            f"{st(row['k_iters'])}, {int((row['k_iters'] >= cap).sum())} at the cap {cap}; Jacobi-PCG "
            f"({kname}{' undeflated' if kname == 'K3r' else ''}) {row['jac_ms']:.1f} ms "
            f"({B / row['jac_ms'] * 1e3:.1f} solves/s), counts {st(row['jac_iters'])}; error vs the float64 "
            f"direct solve MG {[f'{x:.3e}' for x in e_mg]}, {kname} {[f'{x:.3e}' for x in e_k]} (gate "
            f"{[f'{x:.3e}' for x in gate]})")
        if not np.all(e_mg <= gate):
            fail(f"(d): res{res} MG-FCG error {e_mg.max():.3e} above max(1e-4, 1.5x {kname}'s)")
    out.update(launches=launches, mg=rows)
    say("P18", f"launches over phase 18: {launches}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return out

P19_DA = dict(n_chains=256, n_steps=6, n_burn=2)  # "a few outer steps" of phase 6's da_pcn
P19_SNAP = dict(res=32, B=16)
P19_DOMAIN = dict(res=8, tol=1e-12, maxiter=20000, gate=1e-8)


def _p19_dryrun_rank(mesh) -> None:
    """One rank of phase 19's dryrun over every card."""
    from bayesianinferencedl_tpu_torch.parallel.dryrun import dryrun

    dryrun(mesh, log=False)


def phase_parallel(card, pipe8):
    """Phase 19: the multi-device path (parallel/) on the card, through a
    world of 1 under NCCL on cuda:0 started in this process (a FileStore in
    a temporary directory): the sharded paths' collectives all run, over one
    rank. Every FOM kernel's count is set to 0 before each sharded entry
    point and read after it.

    (a) run_inversion(sampler="da_pcn", likelihood="fom", mesh=) on phase
    6's res8 build and data-generating seed, 256 chains, 6 outer steps (2
    burn-in), subchains of 64, in turns with the unsharded run (sharded,
    unsharded, unsharded, sharded): samples, accept rates and betas of
    every run equal the first's from the same generator bit for bit (rank 0
    draws from the caller's generator, a one-rank gather is a copy); K3r
    carries every fine solve and the first run's launches join the kernels
    line; each run's timed seconds printed, and the overhead of the sharded
    path at a world of 1 as the ratio of the two medians.
    (b) sharded_snapshots at res32, B = 16, tol 1e-7, the CLI's cap: equal
    to the unsharded route (solve_fom_stencil, K4r) bit for bit; K4r's
    launches join the kernels line. (c) solve_fom_domain_sharded at res8 in
    float64 (tol 1e-12): within 1e-8 of the float64 direct solve. (d) the
    dryrun over every sharded family, each finite; on a machine with more
    than one card also at a world of every card (one rank a card, launched
    as processes), else a line says so. Returns the K3r and K4r launches."""
    import torch
    import torch.distributed as dist

    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.parallel.domain import solve_fom_domain_sharded
    from bayesianinferencedl_tpu_torch.parallel.dryrun import dryrun
    from bayesianinferencedl_tpu_torch.parallel.mesh import device_mesh, launch
    from bayesianinferencedl_tpu_torch.parallel.sharding import sharded_snapshots

    t_phase = time.perf_counter()
    counters = {"K1": "launches", "K3": "tile_launches", "K3r": "tile_mma_launches", "K4": "grid_launches",
                "K4r": "grid_resident_launches", "K4c": "grid_cluster_launches"}

    def counted(fn, want):
        for attr in counters.values():
            setattr(K, attr, 0)
        out = fn()
        torch.cuda.synchronize()
        got = {k: getattr(K, attr) for k, attr in counters.items()}
        if any(n for k, n in got.items() if k != want) or not got[want]:
            fail(f"P19: kernel launches {got}, expected only {want}")
        return out, got[want]

    t0 = time.perf_counter()
    mesh = device_mesh(1, device="cuda")
    say("P19", f"[{card}] world of {dist.get_world_size()} under {dist.get_backend()} on "
        f"{torch.cuda.get_device_name(0)}, mesh {mesh.mesh_dim_names} in {time.perf_counter() - t0:.2f} s")
    try:
        # (a) da_pcn on fom through run_inversion(mesh=)
        pipe = _with_mcmc(pipe8, **P19_DA)
        gen = lambda: torch.Generator(device="cuda").manual_seed(pipe8.config.mcmc.seed)
        inv_sh, k3r = counted(lambda: api.run_inversion(pipe, generator=gen(), mesh=mesh), "K3r")
        runs = [("sharded", inv_sh), ("unsharded", api.run_inversion(pipe, generator=gen())),
                ("unsharded", api.run_inversion(pipe, generator=gen())),
                ("sharded", api.run_inversion(pipe, generator=gen(), mesh=mesh))]
        fields = ("samples", "phi_trace", "accept_rate", "inner_accept_rate", "beta")
        same = {f: all(bool(torch.equal(getattr(inv.result, f), getattr(inv_sh.result, f)))
                       for _, inv in runs[1:]) for f in fields}
        wall = {k: float(np.median([inv.wall_seconds for kk, inv in runs if kk == k]))
                for k in ("sharded", "unsharded")}
        say("P19", f"(a) da_pcn fom res{pipe8.fin.op.resolution}, {P19_DA['n_chains']} chains x "
            f"{P19_DA['n_steps']} outer steps, in turns: "
            + ", ".join(f"{k} {inv.wall_seconds:.3f} s" for k, inv in runs)
            + f"; medians {wall['sharded']:.3f} / {wall['unsharded']:.3f} s (overhead "
            f"{wall['sharded'] / wall['unsharded'] - 1:+.1%}); launches K3r {k3r}; bit-identical: {same}")
        if not all(same.values()):
            fail(f"P19 (a): the world-1 sharded da_pcn differs from the unsharded run: {same}")

        # (b) sharded snapshots at res32 through K4r
        c = P19_SNAP
        fin32 = FiveParamFin.create(resolution=c["res"], biot=0.1, dtype=torch.float32, device="cuda",
                                    cg_tol=TOL, cg_maxiter=max(480, 120 * c["res"]))
        ks = torch.exp(torch.empty((c["B"], 5), device="cuda").uniform_(
            np.log(0.1), np.log(10.0), generator=torch.Generator(device="cuda").manual_seed(19)))
        kw = dict(tol=fin32.cg_tol, maxiter=fin32.cg_maxiter)
        S_pl = K.solve_fom_stencil(fin32.op, ks, **kw)[0]  # also builds and warms K4r
        ms_sh, (S_sh, k4r) = _time_once_ms(lambda: counted(
            lambda: sharded_snapshots(mesh, fin32.op, ks, **kw), "K4r"))
        ms_pl, S_pl2 = _time_once_ms(lambda: K.solve_fom_stencil(fin32.op, ks, **kw)[0])
        same_s = bool(torch.equal(S_sh, S_pl)) and bool(torch.equal(S_pl2, S_pl))
        say("P19", f"(b) sharded_snapshots res{c['res']} B={c['B']}: {ms_sh:.1f} ms beside the unsharded "
            f"{ms_pl:.1f} ms; launches K4r {k4r}; bit-identical: {same_s}")
        if not same_s or not bool(torch.isfinite(S_sh).all()):
            fail("P19 (b): the world-1 sharded snapshots differ from the unsharded route")

        # (c) the domain-decomposed solve in float64 against the direct solve
        c = P19_DOMAIN
        fin64 = FiveParamFin.create(resolution=c["res"], biot=0.1, dtype=torch.float64, device="cuda")
        k = np.array([0.4, 1.7, 3.1, 0.9, 1.2])
        ms_d, (u, it) = _time_once_ms(lambda: solve_fom_domain_sharded(
            mesh, fin64.op, torch.tensor(k, device="cuda"), tol=c["tol"], maxiter=c["maxiter"]))
        _, u_star, _ = _direct_solve(fin64, k)
        err = float(np.linalg.norm(u.cpu().numpy() - u_star) / np.linalg.norm(u_star))
        say("P19", f"(c) solve_fom_domain_sharded res{c['res']} float64 tol {c['tol']:g}: {int(it)} "
            f"iterations, {ms_d:.1f} ms, error vs the float64 direct solve {err:.3e} (gate {c['gate']:g})")
        if not err < c["gate"] or int(it) >= c["maxiter"]:
            fail(f"P19 (c): domain solve error {err:.3e} or at the cap")

        # (d) the dryrun over every family
        t0 = time.perf_counter()
        fam = dryrun(mesh, log=False)
        say("P19", f"(d) dryrun at a world of 1: {len(fam)} families in {time.perf_counter() - t0:.1f} s "
            f"{json.dumps(fam)}")
    finally:
        dist.destroy_process_group()
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        t0 = time.perf_counter()
        launch(_p19_dryrun_rank, n_cards, device="cuda")
        say("P19", f"(d) dryrun at a world of {n_cards} cards, one rank a card: "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        say("P19", "(d) one card on this machine: the dryrun at a world of every card is the world of 1")
    say("P19", f"launches over phase 19: K3r {k3r}, K4r {k4r}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"K3r": k3r, "K4r": k4r}


def _kernel_entry(name: str, source: str, replaces: str, launches: int, max_abs_err: float,
                  ms: float, plain_ms: float, bound: tuple) -> dict:
    return {"name": name, "route": "cuda", "source": f"bayesianinferencedl_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


PHASE_SECONDS: dict[str, float] = {}


def _timed(name: str, fn, *args):
    """fn(*args), its wall seconds kept under name for the closing line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    return out


def main() -> None:
    card = _timed("device", phase_device)
    import torch

    _timed("build", phase_build)
    lanes = _timed("lanes", phase_kernel)
    slice_launches, cfg, pipe, inv, slice_log = _timed("slice", phase_slice)
    k2 = _timed("K2", phase_k2, cfg, pipe, inv)
    k3 = _timed("K3r", phase_k3)
    k3_launches, pipe8, inv8 = _timed("DA", phase_da)
    k4 = _timed("K4r", phase_k4)
    k4_launches = _timed("CLI", phase_fom_cli, k4)
    k4c = _timed("K4c", phase_k4c, k4)
    k5 = _timed("K5", phase_k5, k3)
    analytic = _p14_analytic_start()  # phase 14's host-CPU cases, beside phases 11-14
    pt_launches, inv_pt, inv_head = _timed("PT", phase_pt, pipe, inv, pipe8, inv8)
    p12_launches = _timed("P12", phase_gradient, pipe, inv, pipe8, inv8, inv_pt)
    p13_launches = _timed("P13", phase_approx, pipe, inv, inv_pt)
    p14_launches = _timed("P14", phase_flow, pipe, inv, inv_head, analytic)
    p15_launches = _timed("P15", phase_persist_precision, pipe, inv, slice_log, inv_head, pipe8, inv8)
    p16_launches = _timed("P16", phase_mlda_workflow, card, pipe, pipe8, inv8)
    p17 = _timed("P17", phase_full_field, card)
    p18 = _timed("P18", phase_ell_multigrid, card)
    p19 = _timed("P19", phase_parallel, card, pipe8)
    say("time", f"seconds by phase {json.dumps(PHASE_SECONDS)}; {sum(PHASE_SECONDS.values()):.1f} s in all")
    t1 = lanes["times"][B_CHECK]
    t3 = k3["times"][1024]
    t4r = k4["times"][K4_BATCHES[0]]
    # K4c and K4 at res40, B = 8: the batch at which the plain version is
    # timed on the same inputs (phase K4c; the main path's 256 is timed there too)
    t4c, t4, p40 = k4c["times"]["K4c", 8], k4c["times"]["K4", 8], k4c["times"]["plain", 8]["ms"]
    print(json.dumps({"kernels": [
        # K1: res4, deflated, B = 256; its launches are the res4 slice's
        _kernel_entry("pcg_stencil", "pcg_stencil.cu", "bayesianinferencedl_tpu/ops/pcg_stencil.py:236",
                      slice_launches["K1"], lanes["max_abs"]["K1"], t1["K1"], t1["plain"],
                      lanes["bound"]["K1"]),
        # K2r carries run_pcn_fused; K2, off the main path, timed on the same run
        _kernel_entry("pcn_fused_r", "pcn_fused_r.cu",
                      "bayesianinferencedl_tpu/experimental/pcn_fused.py:67",
                      k2["K2r"]["launches"], k2["K2r"]["max_abs_err"], k2["K2r"]["ms"],
                      k2["K2r"]["plain_ms"], k2["K2r"]["bound"]),
        _kernel_entry("pcn_fused", "pcn_fused.cu", "bayesianinferencedl_tpu/experimental/pcn_fused.py:67",
                      k2["K2"]["launches"], k2["K2"]["max_abs_err"], k2["K2"]["ms"],
                      k2["K2"]["plain_ms"], k2["K2"]["bound"]),
        # K3r: res8, B = 1,024; its launches are the res4 slice's (the lanes
        # route), the res8 DA slice's, phase 11's (its fom samplers at res8,
        # the headline's truth solve at res4), phase 12's (DA's fine
        # solves at res8, gpcn on fom at res4), phase 13's (EKI, SMC and
        # PSIS on fom at res4), phase 14's (the flow's PSIS and NeuTra on
        # fom at res4), phase 15's (the high and fast builds at res4, the
        # box-prior da_pcn and the checkpointed DA's fine solves at res8) and
        # phase 16's (MLDA's mid rung at res4 and fine correction at res8,
        # the checkpointed MLDA, the prediction at res8, the sensor and
        # greedy builds at res4) and phase 17's (the full-field build, truth
        # solves, DA's fine solves, MLDA's rungs at res4 and res2, the
        # evidence and the ell selection on nodal planes, the undeflated solver)
        # and phase 18's (the stencil side of the ELL comparison at res8, the
        # stencil build at res4, the multigrid's crossover at res8 and res16)
        # and phase 19's (the sharded da_pcn's fine solves at res8)
        _kernel_entry("pcg_stencil_tile_mma", "pcg_stencil_tile_mma.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:385",
                      slice_launches["K3r"] + k3_launches + pt_launches + p12_launches + p13_launches
                      + p14_launches + p15_launches + p16_launches + p17["launches"]
                      + p18["launches"]["K3r"] + p19["K3r"],
                      max(k3["max_abs_err"], lanes["max_abs"]["K3r"], p17["max_abs_err"]), t3["ms"],
                      t3["plain_ms"], t3["bound"]),
        # K3, off the main path since K3r: timed on the same inputs, for the record
        _kernel_entry("pcg_stencil_tile", "pcg_stencil_tile.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:385", 0,
                      k3["k3_max_abs_err"], t3["k3_ms"], t3["plain_ms"], t3["k3_bound"]),
        _kernel_entry("pcg_stencil_grid_cluster", "pcg_stencil_grid_cluster.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:58", k4_launches["K4c"],
                      k4c["max_abs_err"]["K4c"], t4c["ms"], p40, t4c["bound"]),
        # K4, off the main path since K4c: timed on the same inputs, for the record
        _kernel_entry("pcg_stencil_grid", "pcg_stencil_grid.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:58", 0,
                      max(k4["max_abs_err"]["K4"], k4c["max_abs_err"]["K4"]), t4["ms"], p40, t4["bound"]),
        # K4r: the CLI's res32 commands, phase 18's multigrid crossover at
        # res32 and phase 19's sharded snapshots at res32
        _kernel_entry("pcg_stencil_grid_resident", "pcg_stencil_grid_resident.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:58",
                      k4_launches["K4r"] + p18["launches"]["K4r"] + p19["K4r"],
                      k4["max_abs_err"]["K4r"], t4r["ms"], t4r["plain_ms"], t4r["bound"]),
        # K5r carries the probe's entry point at res8; K5, the route's other
        # side, carries it at res16 (an H100) and is timed at res8 on K5r's shape
        _kernel_entry("shift_cost_r", "shift_cost_cluster.cu", "scripts/diag_roll_cost.py:27",
                      k5["r"]["launches"], k5["r"]["max_abs_err"], k5["r"]["ms"], k5["r"]["plain_ms"],
                      k5["r"]["bound"]),
        _kernel_entry("shift_cost", "shift_cost.cu", "scripts/diag_roll_cost.py:27", k5["k5"]["launches"],
                      k5["k5"]["max_abs_err"], k5["k5"]["ms"], k5["k5"]["plain_ms"], k5["k5"]["bound"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--p14-analytic"]:  # phase 14's child process
        import torch

        torch.set_num_threads(1)
        _p14_analytic("cpu")
    else:
        main()
