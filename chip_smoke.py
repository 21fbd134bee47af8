#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and hold each of
its hand-written CUDA kernels against its plain PyTorch version there.

    python3 chip_smoke.py

Twenty-four main paths, each driven with the kernel counts set to 0 just
before it and read just after:

- the batched Tayal Gibbs fit that ``bench.py`` runs by default (256
  simulated zig-zag series, T=1024, K=4, L=9, hard gate, one chain)
  followed by the walk-forward decode (``TayalHHMMLite.generated``,
  stan gate) on thinned draws;
- the batched ChEES-HMC fit of ``bench.py --sampler chees`` (the stan-
  gate ``TayalHHMM`` on the same 256 x T=1024 batch, 2 chains, so 512
  lanes, at most 16 leapfrogs a transition, 150 warmup + 150 sampling
  transitions), every trajectory one launch of the fused trajectory
  kernel; and its unfused form, every leapfrog one value-and-grad call;
- the zoo's generated quantities (``BaseHMMModel.generated``: guarded
  smoothing and Viterbi): the hard-gate Tayal posterior of the Gibbs
  fit and of the ChEES fit, 32 draws x 256 series = 8192 lanes at
  T=1024, the Gaussian HMM of ``hmm/main.R`` (K=3, T=500, 256 series)
  fitted by Gibbs, decoded and path-sampled, the same model with K=5
  and K=12 states (the 12 of ``bench_zoo.py``'s expanded HSMM), and
  with K=20 decoded (a warp a lane, byte-wide Viterbi maps);
- the zoo above K=32: the same model at K=64 (a block a lane, the
  lane's A in shared memory) on 256 series x T=500 — a short Gibbs fit,
  ``state_draws``, ``generated`` and one value-and-grad call, so every
  semiring kernel in its widest layout;
- the Tayal walk-forward back-test (``apps/tayal/wf.py::wf_trade``, the
  reference's test-strategy.R protocol): 34 symbols x 11 days of
  simulated ticks, 5-day train + 1-day trade windows = 204 tasks of
  about 1,000 to 10,000 in-sample legs, through the native zig-zag
  extractor, length-sorted Gibbs fits in 1024-leg buckets (``FWD`` and
  ``BWD_SAMPLE`` once a sweep a group), the batched median-alpha decode
  (``FWD`` twice a dispatch) and the host trading; then its ChEES arm
  (stan gate, 16 of the tasks: ``FWD`` and ``VG_BWD`` once a
  value-and-grad call);
- NUTS, the JAX package's default sampler: ``fit_batched`` with a
  ``SamplerConfig`` on the ChEES path's batch and model (256 series x
  T=1024, stan gate, one chain, Stan's ``max_treedepth`` 10, 30 + 30
  transitions: 256 lanes in lockstep, ``FWD`` and ``VG_BWD`` once a
  value-and-grad call);
- the ``hmm/main.R`` Gaussian gate under NUTS through ``make_logp``
  (T=500, K=2, 2 chains, 60 + 60: ``FILTER`` forward and ``BETA``
  backward once a log-density call);
- the walk-forward back-test by NUTS (``wf_trade`` with a
  ``SamplerConfig`` on every 8th of the ChEES arm's windows by length,
  20 + 20 transitions) and ``run_window`` on the first of them;
- the multinomial HMMs of ``hmm/main-multinom.R`` (K=3, L=5) and
  ``hmm/main-multinom-semisup.R`` (K=4, L=9, both gates), 256 series x
  T=1024 each: ``fit_batched`` Gibbs 100 + 300 in chunks of 64,
  ``generated``, and 32 ``state_draws`` a series on the gated kernels
  and on the Gumbel-max route;
- ``fit_batched``'s healing ladder on the Tayal batch: a dispatch-level
  fault healed, a sticky one degraded, a crash resumed from the cache,
  and a NUTS fit under an in-scan fault escalated to the ladder's end;
- per-series ChEES adaptation (``ChEESConfig(shared_adaptation=False)``)
  through ``fit_batched`` at the ChEES cell, 50 + 50;
- the replication diagnostics (``apps/tayal/replication.py``) on the
  ChEES draws, their FFBS paths by the Gumbel-max scan;
- the input-output HMMs of ``iohmm-reg/main.R`` (K=3, M=4, stan mode)
  and ``iohmm-mix/main.R`` (the hierarchical mixture, K=4, L=3), 64
  simulated series x T=300 each through ``fit_batched`` NUTS (every
  leapfrog one folded value-and-grad call: ``FWD`` and ``VG_BWD``), then
  their time-varying decode and state draws;
- the Hassan (2005) walk-forward forecaster (``apps/hassan/wf.py::
  wf_forecast``) on the two frozen synthetic benchmarks of
  ``examples/hassan_replication.py``: 30 steps each, a pilot fit, the
  batched fit of the steps and the batched forecast step;
- the tree HHMM's route-augmented Gibbs sampler on the 63-leaf Jangmin
  (2004) market tree (``models/tree.py::TreeHMM``, semi-supervised,
  hard gate): 64 simulated markets x T=100, ``fit_batched`` Gibbs 250 +
  500 (``FWD`` and ``BWD_SAMPLE`` at K=63 once a sweep), then 20 + 20 in
  the stan gate on 8 of them (the gated pair);
- the Jangmin application (``apps/jangmin.py``): the semi-supervised
  NUTS fit of the tree on 64 markets x T=250 through ``fit_batched``
  (100 + 100, depth 5: ``FWD`` and ``VG_BWD`` at K=63 once a
  value-and-grad call), the ungated twin's decode of 50 draws a market
  in one ``generated`` call (3,200 lanes: ``FILTER``, ``BETA``,
  ``VITERBI``, ``BACKTRACK`` at K=63), the true-parameter oracle's
  decode, and ``fit_market`` on one market;
- the explicit-duration HSMMs (``models/hsmm.py``) on the count-down
  expansion: ``bench_zoo.py``'s HSMM arm (K=2, Dmax=6, so K'=12; 256
  series x T=400) by Gibbs through ``fit_batched``, ``generated`` and
  ``state_draws``; ``tests/test_hsmm.py``'s recovery gate on 256 series
  (the HSMM against the geometric HMM on held-out steps, ``FILTER``);
  three regimes of daily returns with dwells up to Dmax=60 (K'=180, the
  kernels' big layout: 64 series x T=1000, Gibbs, the decode of 1,280
  lanes); ``MultinomialHSMM(K=3, Dmax=8, L=5)`` (K'=24, 256 x T=1024);
  and the K'=12 model under NUTS (64 series, depth 6);
- the placement planner (``plan/``): ``bench.py``'s Gibbs fit (256 x
  T=1024, hard gate, 20 + 20) through ``fit_batched(plan=make_plan(...,
  devices=[cuda:0]))`` (``FWD`` and ``BWD_SAMPLE`` once a sweep);
- the serving plane (``serve/``, ``pipeline/``): ``bench.py --serve``'s
  arm, a Gibbs fit of 50 + 128 sweeps on 256 series x 512 steps (``FWD``
  and ``BWD_SAMPLE`` once a sweep) banked as 32-draw snapshots, then
  256 series served tick by tick through ``MicroBatchScheduler`` (the
  ticks are torch ops and launch no kernel);
- the adaptation and maintenance planes (``adapt/``, ``maint/``) on
  ``bench.py --adapt``'s and ``--maint``'s workloads at their defaults:
  256 series of peaked Tayal emissions, a Gibbs fit of 100 + 256 sweeps
  on 64 steps banked as 32-draw snapshots, 256 ticks streamed with the
  alphabet reversed from tick 82 on; the draw-reweighting and
  rejuvenation ladder against a uniform-stale and a refit-only arm
  (``adapt``), and the maintenance loop's drift alarms, warm refits of
  50 + 192 sweeps on the 24-tick windows, shadow gate and promotion,
  judged on 24 held-out ticks (``maint``, whose replay of the trace is
  ``adapt``'s refit-only arm); ``FWD`` and ``BWD_SAMPLE`` once a sweep
  of every fit.
The two NUTS paths of the Tayal batch and the Gaussian gate, the IOHMM,
Hassan, tree and HSMM-NUTS paths, and the adaptation and maintenance
paths run as eleven tasks (NUTS, the Gaussian gate, two IOHMMs, two
benchmarks, the two tree paths, the HSMM, adapt, maint), each in a
spawned process of its own, all at once: each is host-bound, one Gibbs
sweep or NUTS leaf or tick at a time. Each of these processes, and each
example driver's, waits for the card asleep, not spinning on a core.

Phases, one JSON object per line:

1. device  — requires CUDA (exits non-zero without it); prints the
   card's ``nvidia-smi`` name and power limit on a line of its own.
2. build   — builds every kernel from ``hhmm_tpu_torch/kernels/csrc``
   with ``nvcc`` (all sources in parallel, the FFBS pair's from a
   thread of their own, so that the FFBS checks of phase 3 run beside
   the build: their plain versions first, the kernels once the pair is
   built; the line's ``seconds`` is the build's, its timeline group
   holds both); ``ptxas`` reports each
   kernel instantiation's registers, spills and static shared memory
   (line ``ptxas``; line ``ptxas_fwd_core``: the forward core of
   ``FWD``, ``FILTER`` and ``VITERBI`` at K=4 and K=16, the last two
   also at K=32; line ``kernel_resources``: each semiring kernel's
   instantiation at K in {4, 16, 32, 64, 128} with its registers,
   spills, static and dynamic shared bytes).
3. kernels — each kernel against its plain version on the card: the
   FFBS pair bitwise (alpha, ll and every draw) at K in {2, 3, 4, 8},
   ungated and gated, at N=256, T=1024 with a ragged tail and at
   (N, T) = (250, 1000), (1, 1024), (256, 1) and (5, 2100) with masked
   runs at both ends, and at every other K in 2..16 at (64, 1024) and
   (3, 2100) (the maps' device scratch); the value-and-grad pair
   (``FWD`` + ``VG_BWD``) bitwise at N=512, K in {3, 4, 8}, and at every
   other K in 2..16 at N=64; the trajectory kernel at the ChEES shape with 2 leapfrogs,
   against its plain version in float64 with 8, against the unfused
   leapfrogs over ``make_lp_bc`` with 8, and at the odd shapes of
   ``TRAJ_ODD_CASES`` (masked runs at both ends, C in {1, 2, 3}, N=1,
   T in {1, 100, 1000, 6500}, the last on the scratch path, n_steps in
   {0, 1, 2, 16, CAP + 4}); then times each at its main-path shape (the
   FFBS pair also on one lane and at N in {1, 256, 512, 2048, 8192}, in
   ns a step; the trajectory at N in {1, 512, 2048}, in ms a leapfrog
   and ns a recursion step).
4. fit     — the Gibbs fit through the kernels; every chain healthy,
   every logp finite, each FFBS kernel launched exactly once per sweep.
5. decode  — ``generated`` on 8 thinned draws x 256 series (in-sample
   T=1024, out-of-sample T=256): the gated forward kernel over 2048
   lanes, compared with its plain version on the card.
6. chees   — the fused ChEES fit: every chain healthy, every logp
   finite, divergent sampling transitions reported with their count,
   the trajectory kernel launched once per transition, the
   value-and-grad kernel once per call of the log density,
   posterior-mean emission rows near the simulator's.
   chees_repeat — the fused fit again: bitwise the same draws; its
   first divergent sampling trajectories replayed on the CPU are
   unstable in float64 too.
   chees_seeds — the fused fit at three more sampler seeds: divergent
   sampling transitions at most ``DIV_SHARE_MAX`` of all over the four
   fits, emission rows near the simulator's in each.
7. chees_unfused — 10 + 10 transitions with no trajectory kernel: the
   value-and-grad kernel launched once per log-density call, which is
   once per leapfrog plus the initial and step-size-probe calls.
8. kernels_decode — ``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK``
   at N=8192, T=1024, K in {3, 4, 8} (every other K in 2..32 at N=256),
   ragged mask, ``MASK_NEG``-sparse A, tie lanes, with and without all
   -inf evidence rows: bitwise equal to their plain versions, ``FILTER``
   bitwise equal to ``FWD`` on finite inputs; then times each at
   N=8192, T=1024, K=4.
   kernels_wide — every semiring kernel bitwise equal to its plain
   version at K in {17, 24, 32, 33, 48, 64, 96, 128} (a warp a lane to
   32, a block a lane above), at (N, T) = (64, 256) and (9, 75): the FFBS
   and value-and-grad kernels ungated and gated with masked runs at both
   ends, the decode kernels on sparse A with tie lanes and -inf evidence
   rows; then each timed at K=64, N=256, T=500.
   kernels_big — every semiring kernel bitwise equal to its plain
   version above K=128 (``csrc/big_core.cuh``: the lane's A, and
   ``VG_BWD``'s d_A, in a stream-ordered device scratch; byte map
   fields to K=256, 16-bit above; a thread several states above 1024)
   at K in ``BIG_KS`` = {129, 180, 256, 257, 320, 1024, 1025} on 8 lanes
   (T=48, T=12 from K=1024), the FFBS and value-and-grad kernels
   ungated and gated on finite inputs with masked runs at both ends,
   the decode kernels on sparse A with tie lanes and -inf evidence rows;
   each kernel timed at each K beside its bound, and at K=180 on one
   lane.
   kernels_k1 — every semiring kernel at K=1 (a group of two threads,
   the second idle) on 8 lanes x T=48 with masked runs at both ends,
   the FFBS and value-and-grad kernels ungated and gated: bitwise equal
   to its plain version, every draw and path 0, every log-likelihood
   finite, each kernel launched; the public entries (FFBS dispatch,
   value-and-grad, smoothing, Viterbi) on the card against the CPU.
   obs — the obs plane on the first main path's Gibbs fit (256 x T=1024,
   20 + 20): plane off, on, off, the draws and stats bitwise equal;
   ``infer.gibbs.sample`` once and ``kernels.dispatch.ffbs[cuda]`` as
   many times as the FFBS pair launched; the sampler-health counters;
   the span split of a sweep; a manifest (device name, power limit)
   with the span and metrics JSONL in ``chiprun_out/``, rendered by
   ``obs_report_torch.py`` with exit 0; ``device_time`` of ``FWD`` at
   the kernels line's shape within a factor of 1.25 of its time there.
   assoc — the time-parallel scans (``kernels/assoc.py``) at the main
   path's shape (256 x T=1024, K=4, ragged), each dispatch entry forced
   onto ``assoc`` against the ``cuda`` branch on the same operands and
   uniforms: probabilities within ``AS_RTOL`` + ``AS_ATOL``, log-
   likelihoods within ``AS_RTOL``, Viterbi paths and FFBS draws (ungated
   and gated) equal except on lanes where the reference's own margin
   (the top-two score gap, or |u - cum_k|, at the step where the two
   part) is under ``AS_MARGIN`` (those lanes counted); the stan gate's
   time-varying OOS decode (``TayalHHMMLite.generated`` on 8 Gibbs
   draws a series, and its Viterbi pass alone) and an IOHMM-reg decode
   (64 series x T=300, 4 draws a series), ``seq`` against ``assoc``;
   ``forward_filter_seqshard`` over ``AS_SHARDS`` chunks on cuda:0
   against ``forward_filter_assoc``; ms of every branch.
   dispatch_db — ``obs/profile.py``'s ``decode_kernel_fns`` (the
   ``cuda``, ``assoc`` and ``seq`` branches of the filter, Viterbi and
   FFBS) timed by ``device_time`` at K in ``DB_KS`` x T in ``DB_TS`` on
   256 lanes into a kernel cost DB in ``chiprun_out/`` (never
   ``results_torch/``); with it active, ``resolve_auto`` returns its
   measured winner (``cuda`` against ``assoc`` for a homogeneous call,
   ``seq`` against ``assoc`` for a time-varying one; never ``seq`` for a
   homogeneous call) and the spans name the branch that ran; with an
   empty DB every route is the default one; the grid is printed.
   plan — ``make_plan`` on ``[cuda:0]`` at 256 x T=1024: a Gibbs
   ``fit_batched(plan=)`` of 20 + 20 sweeps bitwise equal to the
   unplanned fit (``FWD`` and ``BWD_SAMPLE`` once a sweep in each), the
   manifest's ``plan`` stanza printed; the same fit with
   ``GibbsConfig(time_parallel=True)`` (no kernel launched): the folded
   posterior means, averaged over the 256 series, within ``PLAN_MCSE``
   MCSE of the ``cuda`` route's for every parameter (the share of
   (series, parameter) pairs within it reported: 20 draws make a
   series' MCSE rough), and the sweep ms of both routes.
   serve — the snapshots' fit, ``SnapshotRegistry``, then three arms of
   ``MicroBatchScheduler`` (buckets (8, 64, 256), four tenants, attached
   warm on the 512 fitted steps): staged, resident and pipelined
   (``dispatch_async`` / ``harvest``), 2 warmup and 254 timed ticks each,
   the responses bitwise equal tick for tick; no shed, dispatch error,
   new signature or nvcc build after warmup; the last tick's probs of 8
   series within ``wf_margin(768)`` of ``FWD``'s filter of the same draws;
   the fit's first ``FWD`` and ``BWD_SAMPLE`` launches at its shape
   bitwise against the plain versions and timed; ticks/s, p50 / p99, the
   request plane's shares of host-clock intervals (queue, the dispatch
   stage: dispatch to sync or to commit, other), hidden and stall
   seconds, then a short traced pass for
   the ``serve.*`` spans and the sampled flush profile: the CUDA-event
   time of the staged tick's update, re-run warm, and its share of a
   tick.
   serve_faults — 32 series x 8 draws, 64 ticks, buckets (8,): a device
   loss at dispatches 9–11 sync and pipelined, torn and slow snapshot
   loads through ``SnapshotPager``: every fault a counted shed, the
   series no fault touched bitwise the clean run, the event feeds of the
   clean sync and pipelined arms equal; a ``GaussianHSMM(3, 4)`` served
   32 ticks, its collapsed probs within ``wf_margin`` of ``FILTER``'s.
   decode_smooth — ``TayalHHMM(gate_mode="hard").generated`` on 32
   Gibbs draws x 256 series: shapes, probability rows, each decode
   kernel launched once, every output against the plain versions on
   the same lanes, and (after the path's counts are read) loglik
   identical to ``FWD``'s.
   generated_split — the same call again, warm, its stages timed with
   CUDA events and the host clock by wrapping the functions it calls
   (unpack + ``build``, the lane-layout copies, the four decode
   kernels, the smoothing in the dispatch, the outputs), each wrapped
   function called as often as the path calls it and the outputs
   bitwise the cold call's; beside the cold call's time, and, for both
   calls, the segments and bytes the caching allocator took from the
   device (cudaMalloc) during the call.
   agreement — the ChEES draws through the same decode; the folded
   posterior-mean bull-pair probability against the Gibbs one and the
   Gibbs split-half floor (reported, not gated).
   gaussian — the Gaussian HMM Gibbs fit (FFBS kernels at K=3, once a
   sweep), posterior-mean mu within ``G_MU_TOL``, ``generated`` (each
   decode kernel once, Viterbi accuracy above ``G_ACC_MIN``) and
   ``state_draws`` (one ``FWD`` and one ``BWD_SAMPLE``).
   gaussian_k — the same model at K=5 and K=12 (two map words a step):
   a short Gibbs fit on 256 simulated series (each FFBS kernel once a
   sweep), ``generated`` (each decode kernel once) and ``state_draws``
   (``FWD`` and ``BWD_SAMPLE`` once), every output against the plain
   versions on the same lanes and uniforms.
   decode_wide — ``GaussianHMM(K=20).generated`` on 256 lanes, T=500:
   each decode kernel launched once, every output against the plain
   versions on the same lanes and against the same call on the CPU
   (``WIDE_*`` tolerances).
   zoo_wide — the fourth main path: ``GaussianHMM(K=64)``, 256 series x
   T=500, a 10 + 10 Gibbs fit (``FWD`` and ``BWD_SAMPLE`` once a sweep),
   ``state_draws``, ``generated`` on 2 draws a series (each decode
   kernel once) and one ``forward_value_and_grad`` (``FWD`` and
   ``VG_BWD`` once): every output bitwise equal to the plain versions
   on the card, the decode and value-and-grad of 16 series against the
   CPU within ``WIDE_*``; each of the seven kernels launched.
   walk_forward — the fifth main path: ``wf_trade`` on the 204 tasks
   (their ticks simulated on a host thread during the build, and timed
   there; hard gate, one chain, 100 + 300 sweeps, 64 windows a group):
   the native extractor took every series; ``FWD`` and ``BWD_SAMPLE``
   launched once a sweep a group and ``FWD`` twice a decode dispatch,
   and nothing else; every chain healthy, every logp and buy-and-hold
   return finite, trades for every lag; the first decode dispatch and
   the first at the largest bucket pair again through ``fwd_plain`` on
   the same lanes (filtered probabilities bitwise, leg states
   identical); ``phase_timings``, legs, fit groups
   with their sweeps/s, decode dispatches and the mean OOS return a lag
   against buy-and-hold.
   walk_forward_chees — 16 of the tasks (every 13th) by ChEES (stan
   gate, 2 chains, 50 + 50 transitions, at most 16 leapfrogs, 8 windows
   a group, no fused trajectory): ``FWD`` and ``VG_BWD`` once a
   value-and-grad call (``FWD`` also twice a decode dispatch), every
   chain healthy, mean divergent share a task under ``WF_DIV_MAX``; its
   decode checked against ``fwd_plain`` as above.
   walk_forward_kernels — the first launch of ``FWD``, ``BWD_SAMPLE``
   and ``VG_BWD`` at each shape and gate of each Gibbs and ChEES fit
   group, its inputs kept as the path made them, bitwise equal to the
   plain version on the same inputs and timed on them; the ``FWD`` +
   ``BWD_SAMPLE`` pair as a share of a Gibbs group's sweep.
   walk_forward_assoc — the Gibbs arm's decode again with
   ``time_parallel=True``, its fits replayed from the walk_forward run
   (no refit, no kernel launched): every median-alpha leg state equal to
   the ``FWD`` decode's except where that decode's top-two median gap is
   under the margin (``AS_MARGIN`` at T=1024, growing linearly with the
   bucket's T as the f32 rounding of the unnormalised log-alpha does:
   ``wf_margin``; counted), the median probabilities within twice the
   margin, trade summaries equal on every task whose leg states are
   equal (the others counted), the resolved branch stamped in
   ``phase_timings``.
   nuts — the sixth main path (see above; a process of the pool, with
   the paths from the thirteenth on): every chain healthy, ``FWD``
   and ``VG_BWD`` launched once a value-and-grad call and nothing else,
   posterior-mean emission rows within ``PHI_MAE_MAX`` of the
   simulator's, divergent share under ``NUTS_DIV_MAX``; the first launch
   of each kernel bitwise against its plain version and timed; the
   lockstep cost (leapfrogs the batch ran a transition against the mean
   leaves a lane needed), depth histogram, step sizes, ms a
   value-and-grad call (timed alone, after the pool), host syncs a
   transition, worst-parameter ESS and the gap to the ChEES posterior
   means.
   gaussian_nuts — the seventh (a process of the pool):
   ``tests/test_models.py``'s bounds (mu
   0.08, sigma 0.05, A 0.10 absolute, divergent share under 0.05,
   Viterbi accuracy of ``generated`` above 0.9), ``FILTER`` and ``BETA``
   launched once a log-density call, their first launches bitwise
   against the plain versions and timed.
   walk_forward_nuts — the eighth: launches as for the ChEES arm, every
   chain healthy, trades for every lag, the lockstep cost a fit group;
   then ``run_window`` (``FWD`` and ``VG_BWD`` once a value-and-grad
   call, ``FWD`` twice for its decode).
   multinom — the ninth main path: per model, ``FWD`` and
   ``BWD_SAMPLE`` once a sweep a chunk, each decode kernel once a
   homogeneous ``generated`` (the stan gate's time-varying decode runs
   the scans and launches nothing), every chain healthy, Viterbi
   accuracy and emission error after ``greedy_relabel`` (gated for the
   multinomial and hard-gate models); ``state_draws`` of the stan fit
   on the gated kernels (``FWD`` and ``BWD_SAMPLE`` once) and on the
   Gumbel route (no kernel), their pooled per-step state frequencies
   within ``MN_FREQ_Z_MAX`` sigma; the first launch of each kernel at
   each shape bitwise against its plain version.
   heal — the tenth: the clean, healed, sticky, crashed and resumed
   Gibbs runs and the escalated NUTS ladder (see ``phase_heal``); the
   first launch of each kernel at each shape of the heal re-dispatches
   bitwise against its plain version.
   chees_per_series — the eleventh: ``FWD`` and ``VG_BWD`` once a
   value-and-grad call, every chain healthy, the emission rows within
   ``CPS_PHI_MAE_MAX``; the spread of the per-series step sizes and
   trajectory lengths, the lockstep efficiency, the gap to the shared
   arm's posterior means; first launches bitwise.
   replication — the twelfth: the four functions on the card, no kernel
   launched, the relabel statistics against the CPU's on the same noise.
   iohmm — the thirteenth (a process a model): ``FWD`` and ``VG_BWD`` once a
   value-and-grad call and nothing else, every chain healthy, divergent
   share at most ``IO_DIV_MAX``; IOHMM-reg's posterior-mean ``b_km`` and
   ``s_k`` on the median series within ``IO_B_ATOL`` / ``IO_S_ATOL``
   after matching intercepts; ``generated`` (IOHMM-reg) or
   ``IOHMMHMixLite.generated`` (the mixture) and ``state_draws`` on 8
   draws a series, finite, no kernel launched (the scans and the
   Gumbel-max FFBS); seconds a fit (four processes sharing the host and
   the card), ms a value-and-grad call (timed alone, after the tasks),
   lockstep efficiency, Viterbi accuracy, decode seconds; the first
   launch of each kernel at each shape bitwise against its plain version.
   hassan — the fourteenth (a process a benchmark): ``FWD`` and ``VG_BWD`` once a
   value-and-grad call of the pilot and the fit, none in the forecast
   step; finite forecasts for every step; the gates ``HS_GATES`` and
   ``HS_DIV_MAX``; pilot, fit and forecast seconds (shared as above),
   value-and-grad calls and ms (alone), lockstep efficiency, the three errors beside the JAX record's
   (``results/hassan_replication.json``); first launches bitwise.
   tree_gibbs — the fifteenth (a process): ``FWD`` and ``BWD_SAMPLE``
   once a sweep and nothing else, in each gate; every chain healthy and
   every logp finite; over the markets the median ESS(lp) at least
   ``TG_ESS_MIN`` and the median split-R̂(lp) under ``TG_RHAT_MAX``
   (``tests/test_routes.py``'s bars); ms a sweep and the FFBS pair's
   share of it; the first launch of each kernel at each shape and gate
   at K=63 bitwise against its plain version, its float inputs finite
   (the clamped kernels' rule).
   jangmin — the sixteenth (a process): ``FWD`` and ``VG_BWD`` once a
   value-and-grad call, each decode kernel once a ``generated`` call;
   divergent share under ``JM_DIV_MAX``, every output finite, the mean
   decode accuracy above the mean majority-class rate and the median gap
   to the true-parameter oracle at least ``JM_ORACLE_GAP``
   (``tests/test_jangmin_app.py``'s gates); ``fit_market`` once, finite,
   divergent share under ``JM_DIV_MAX``; seconds a fit, ms a
   value-and-grad call (alone) with the kernel pair's and ``assemble``'s
   shares (``assemble``'s op counts too), lockstep efficiency, decode
   seconds, accuracies beside the oracle's; first launches bitwise, as
   above.
   hsmm — the seventeenth: ``FWD`` and ``BWD_SAMPLE`` at K'=12 once a
   sweep, each decode kernel once for ``generated`` on 32 draws a
   series, the FFBS pair once for ``state_draws``; every fit finite,
   probability rows summing to 1; posterior-mean mu and duration rows
   against the truth, collapsed Viterbi accuracy, the split of a sweep
   (build, FFBS pair, conjugate update); first launches bitwise.
   hsmm_dmax1 — the Dmax=1 contract: ``GaussianHSMM(K=3, Dmax=1)`` and
   ``GaussianHMM(K=3)`` on the same draws give the same built terms,
   ``generated`` outputs and ``state_draws`` paths, bit for bit.
   hsmm_recovery — the eighteenth: both fits' launches as above, one
   ``FILTER`` a model for the held-out log-likelihoods; the HSMM's
   pooled margin over the geometric HMM positive.
   hsmm_daily — the nineteenth, at K'=180: the fit's and the decode's
   launches as above, plus ``VITERBI`` and ``BACKTRACK`` twice for the
   true-parameter decodes; the median collapsed regime accuracy within
   ``HD_ACC_GAP`` of the decode by the true emissions and transitions
   with flat durations (the true-parameter decode's reported beside it);
   the split of a sweep, the decode kernels' share of ``generated``;
   first launches bitwise.
   multinom_hsmm — the twentieth: the fit's launches as above, every fit
   finite, the emission rows after the best relabelling.
   hsmm_nuts — the twenty-first (a process): ``FWD`` and ``VG_BWD``
   once a value-and-grad call and nothing else, divergent share at most
   ``HN_DIV_MAX``; value-and-grad ms alone with the kernel pair's share.
   drivers — each ``examples_torch/`` driver ``--quick`` on the card, a
   process each, all eight at once, started when two of the pool's
   tasks are done and waited for before the pool's parent times
   anything: exit 0 and its expected line printed (the output of each
   in ``chiprun_out/drivers/``).
   The pool's eleven processes start after serve_faults and run beside
   this process's phases from zoo to multinom_hsmm, they and the
   drivers at a lower priority (``POOL_NICE``); each timing taken here
   meanwhile (``time_ms``, ``host_ms``, the warm decode's stages) stops
   them for its length (``quiet``). A ``pool_processes`` line gives
   each task's CPU seconds.
   tooling — the port's tools on the card's host, started with the pool
   as two processes beside it (``POOL_NICE``, listed in ``BESIDE``): the
   static analyzer (``python -m hhmm_tpu_torch.analysis --format json``
   into ``chiprun_out/analysis.json``) and a host check (``import
   hhmm_tpu_torch`` succeeds; ``import hhmm_tpu_torch.viz`` raises
   ``ModuleNotFoundError`` naming matplotlib, or, where matplotlib is
   there, this process draws one figure of the Gibbs decode into
   ``chiprun_out/``). After the pool: both exited 0, the analyzer found
   no unsuppressed error, and ``obs_report_torch.py`` renders the obs
   phase's manifest with the analyzer's report into
   ``chiprun_out/obs_report.txt`` (exit 0, its ``analysis`` section
   CLEAN) — the one part of this phase on this process's path. A
   ``tooling`` line gives the files scanned, the findings and
   suppressions by rule, each process's seconds and the report's
   section titles.
9. the timeline line (host seconds a group of phases), the kernels line
   (every kernel; the semiring kernels with their K range, their time at
   K=64 and their zoo_wide launches; ``FWD``, ``BWD_SAMPLE`` and
   ``VG_BWD`` with their walk_forward launches; ``FWD`` and ``VG_BWD``
   with their NUTS launches and time, ``FILTER`` and ``BETA`` with the
   Gaussian NUTS gate's; each kernel with its launches on the multinom,
   heal, chees_per_series, iohmm, hassan, tree_gibbs, jangmin and HSMM
   paths and their first launches' shapes and times: K=63 on the tree
   paths, K'=180 on ``hsmm_daily``; the semiring kernels with their
   times and bounds at each K of ``kernels_big``), then the last line
   ``{"ok": true, "device": ...}``.

Any failed check raises, so the script exits non-zero and prints no
result line. It imports nothing of JAX or of ``hhmm_tpu``.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import itertools
import json
import multiprocessing
import os
import re
import resource
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hhmm_tpu_torch.adapt import (
    AdaptationLadder,
    uniform_log_weights,
    uniform_mixture_loglik,
    weighted_mixture_loglik,
)
from hhmm_tpu_torch.apps.hassan import DEFAULT_HYPERPARAMS, simulate_ohlc, wf_forecast
from hhmm_tpu_torch.apps.hassan import wf as hassan_wf
from hhmm_tpu_torch.apps.jangmin import _regime_decode, fit_market, simulate_market
from hhmm_tpu_torch.apps.tayal import build_tasks, replication, run_window, simulate_ticks, wf_trade
from hhmm_tpu_torch.apps.tayal import wf as wf_module
from hhmm_tpu_torch.apps.tayal.trading import equity_curve
from hhmm_tpu_torch.apps.tayal.wf import D_DEC, G_DEC, median_states
from hhmm_tpu_torch.batch import default_init, fit_batched
from hhmm_tpu_torch.batch import fit as fit_module
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    SamplerConfig,
    ess_many,
    greedy_relabel,
    init_chains,
    make_lp_bc,
    sample_chees_batched,
    sample_gibbs,
    sample_nuts,
    split_rhat_many,
)
from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.kernels import assoc as tassoc
from hhmm_tpu_torch.kernels import forward_value_and_grad
from hhmm_tpu_torch.kernels.cuda_build import build
from hhmm_tpu_torch.kernels.ffbs import gumbel
from hhmm_tpu_torch.kernels.alpha_fused import forward_alpha
from hhmm_tpu_torch.kernels.duration import collapse_probs
from hhmm_tpu_torch.kernels.filtering import forward_filter, smooth
from hhmm_tpu_torch.maint import MaintenanceLoop, MaintenancePolicy, predictive_logliks
from hhmm_tpu_torch.maint import loop as maint_loop
from hhmm_tpu_torch.models import (
    GaussianHMM,
    GaussianHSMM,
    IOHMMHMix,
    IOHMMHMixLite,
    IOHMMReg,
    MultinomialHMM,
    MultinomialHSMM,
    NIGPrior,
    SemisupMultinomialHMM,
    TayalHHMM,
    TayalHHMMLite,
    TreeHMM,
)
from hhmm_tpu_torch.hhmm import jangmin2004_tree
from hhmm_tpu_torch.models import base as zoo_base
from hhmm_tpu_torch.models.base import broadcast_data
from hhmm_tpu_torch.native import zigzag as native_zigzag
from hhmm_tpu_torch.obs import manifest as obs_manifest
from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs import trace as obs_trace
from hhmm_tpu_torch.obs import profile as obs_profile
from hhmm_tpu_torch.obs import telemetry as obs_telemetry
from hhmm_tpu_torch.obs.profile import bound_ms, device_time, kernel_cost, roofline
from hhmm_tpu_torch.obs.request import RequestRecorder
from hhmm_tpu_torch.plan import WorkloadShape, make_plan
from hhmm_tpu_torch.robust import FaultPlan, RetryPolicy, SimulatedCrash, faults
from hhmm_tpu_torch.serve import (
    LoglikCUSUM,
    MicroBatchScheduler,
    PosteriorSnapshot,
    RegimeEventFeed,
    SnapshotPager,
    SnapshotRegistry,
    model_spec,
    snapshot_from_fit,
)
from hhmm_tpu_torch.sim import (
    hmm_sim,
    hsmm_sim,
    iohmm_sim,
    obsmodel_categorical,
    obsmodel_gaussian,
    obsmodel_mix,
    obsmodel_reg,
)
from hhmm_tpu_torch.sim.tayal import tayal_batch, tayal_phi

# main path: bench.py's default Gibbs workload
N_SERIES, T_FIT, K_TAYAL = 256, 1024, 4
WARMUP, SAMPLES = 100, 300
T_OOS, N_DRAWS = 256, 8
SEED_DATA, SEED_INIT, SEED_SAMPLER = 42, 100, 0
# second main path: bench.py --sampler chees (stan gate, 2 chains)
CHAINS, CAP = 2, 16
CHEES_WARMUP, CHEES_SAMPLES = 150, 150
UNFUSED_WARMUP, UNFUSED_SAMPLES = 10, 10
N_LANES = N_SERIES * CHAINS
T_SHORT = 64  # window of the fused-vs-unfused check (tests/test_pallas_traj.py's regime)
# third main path: the zoo's generated quantities, 32 draws a series
N_DECODE_DRAWS = 32
N_DEC = N_SERIES * N_DECODE_DRAWS  # 8192 lanes
# the Gaussian HMM of hmm/main.R at bench_zoo.py::bench_hmm's Gibbs arm
G_K, G_T = 3, 500
G_A = [[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.05, 0.15, 0.8]]
G_MU, G_SIGMA = [-2.0, 0.5, 3.0], [0.5, 0.8, 0.6]
G_PRIOR = dict(m0=0.0, kappa0=0.1, a0=2.0, b0=1.0)
G_WARMUP, G_SAMPLES = 100, 300
SEED_GAUSS = 7
# the same model with more states: K, sticky A, means 1.5 apart, 8 draws
# a series through the decode
GK_KS, GK_STAY, GK_SIGMA = (5, 12), 0.8, 0.5
GK_WARMUP, GK_SAMPLES, GK_DRAWS = 20, 20, 8
# above K=16 (a warp a lane, byte-wide Viterbi maps): the Gaussian HMM at
# K=20, decoded only, 32 series x 8 random draws = 256 lanes, T=500
K_WIDE, K_WIDE_SERIES, K_WIDE_DRAWS = 20, 32, 8
# above K=32 (a block a lane, the lane's A in shared memory): the same
# model at K=64 on 256 series, T=500, through the whole zoo path — a
# short Gibbs fit, state_draws, generated and one value-and-grad call —
# with 2 draws a series through the decode; the first 16 series also on
# the CPU
ZW_K, ZW_WARMUP, ZW_SAMPLES, ZW_DRAWS, ZW_CPU_SERIES = 64, 10, 10, 2, 16
# every semiring kernel against its plain version above K=16: a warp a
# lane (17..32) and a block a lane (33..128), at (N, T) = (64, 256) and
# at (9, 75), T off every ring's and chunk's length
WIDE_KS = (17, 24, 32, 33, 48, 64, 96, 128)
WIDE_SHAPES = ((64, 256), (9, 75))
# above K=128 (a block a lane, the lane's A in a device scratch): every
# semiring kernel against its plain version at byte map fields (129, 180
# = the HSMM's 3 x 60, 256), 16-bit fields (257, 320) and more states
# than a block's 1024 threads (1025), at T = 48 (T = 12 from K = 1024:
# the plain versions' loops over K set the time), 8 lanes
BIG_KS = (129, 180, 256, 257, 320, 1024, 1025)
BIG_N, BIG_T, BIG_T_HUGE = 8, 48, 12
# fifth main path: the Tayal walk-forward back-test (the reference's
# test-strategy.R protocol: 5-day train + 1-day trade windows), 34
# symbols x 11 days of simulated ticks = 204 tasks; legs a day spread
# evenly in log from 200 to 2000 over the symbols, so in-sample windows
# run from about 1,000 to 10,000 legs
WF_SYMBOLS, WF_DAYS, WF_TRAIN_DAYS, WF_TRADE_DAYS = 34, 11, 5, 1
WF_LEGS_PER_DAY = (200, 2000)
WF_TASKS = WF_SYMBOLS * (WF_DAYS - WF_TRAIN_DAYS - WF_TRADE_DAYS + 1)
WF_WARMUP, WF_SAMPLES, WF_CHUNK = 100, 300, 64
SEED_WF = 2009
# its ChEES arm: every 13th task (16 windows across the length range),
# stan gate, 2 chains, at most 16 leapfrogs, fitted 8 windows a group
WF_CHEES_STRIDE, WF_CHEES_TASKS, WF_CHEES_CHUNK = 13, 16, 8
WF_CHEES_WARMUP, WF_CHEES_SAMPLES = 50, 50
WF_DIV_MAX = 0.2  # mean divergent share a task (tests/test_chees.py's wf_trade gate)
# sixth main path: NUTS, the JAX package's default sampler, through
# fit_batched on the ChEES phase's batch and model (256 series x T=1024,
# stan gate, one chain, one flat batch of 256 lanes) at Stan's
# max_treedepth; 30 + 30 transitions, not the reference's 250 + 250 (at
# 100 + 100 the phase alone took 188 s on the card: 34,668
# value-and-grad calls, 173 lockstep leapfrogs a transition; at 50 + 50
# 111-160 s, cut to make room for the IOHMM and Hassan paths)
NUTS_WARMUP, NUTS_SAMPLES, NUTS_TREEDEPTH = 30, 30, 10
NUTS_DIV_MAX = 0.05  # divergent share of the sampling transitions
# seventh: the hmm/main.R gate under NUTS through make_logp
# (tests/test_models.py::test_gaussian_hmm_recovery: T=500, K=2, its A,
# p1, means and sigma, 2 chains, its bounds), 100 + 100 transitions, not
# the test's 300 + 300: at 300 + 300 the phase took 63-95 s on an NVIDIA
# H100 80GB HBM3 at 700 W, its errors 0.021, 0.015 and 0.032 against the
# bounds 0.08, 0.05 and 0.10 (at 150 + 150, 72 s; at 100 + 100, 69 s on
# a slower host, errors 0.020, 0.016 and 0.029: cut to make room for the
# IOHMM and Hassan paths; 100 + 100 took 126.3 s in the pool of nine with
# the same errors: cut to 60 + 60 when the script passed 1000 s with the
# obs plane and the drivers)
GN_T, GN_A, GN_P1 = 500, [[0.8, 0.2], [0.35, 0.65]], [0.9, 0.1]
GN_MU, GN_SIGMA = [1.0, 2.0], [0.3, 0.3]
GN_WARMUP, GN_SAMPLES, GN_CHAINS = 60, 60, 2
GN_MU_ATOL, GN_SIGMA_ATOL, GN_A_ATOL, GN_DIV_MAX = 0.08, 0.05, 0.10, 0.05
SEED_GN = 42
# eighth: the walk-forward back-test by NUTS (stan gate, one chain),
# 20 + 20 transitions (50 + 50 until the tree paths joined the script's
# budget, 30 + 30 until the serving phases did), not the reference's
# 250 + 250, on every 8th of the
# ChEES arm's 16 windows ordered by in-sample ticks: the shortest (about
# 900 legs) and one of about 3,100 (one fit group of 2); then run_window
# on the shortest. On all 16 windows at 50 + 50 the arm alone took 732 s on the
# card (114,387 value-and-grad calls: the group of windows of 3,100 to
# 8,500 legs ran up to 1023 lockstep leapfrogs a transition); at 10 + 10,
# 115 s, with the step sizes unadapted (one dual-averaging update after
# the mass window: 72 % of the transitions divergent)
WF_NUTS_STRIDE, WF_NUTS_WARMUP, WF_NUTS_SAMPLES = 8, 20, 20
# ninth: the multinomial HMMs of hmm/main-multinom.R:7-27 (K=3, L=5) and
# hmm/main-multinom-semisup.R:7-41 (K=4, L=9, groups (0, 1, 1, 0), the
# sparse Tayal-shaped A), as examples/hmm_main.py builds them, 256
# series x T=1024 each, fit_batched Gibbs 100 + 300 in chunks of 64
MN_CONFIGS = (
    ("multinom", 3, 5, [[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.15, 0.15, 0.7]],
     [1 / 3, 1 / 3, 1 / 3], 0.8, None),
    ("semisup", 4, 9, [[0.0, 0.4, 0.6, 0.0], [1.0, 0.0, 0.0, 0.0], [0.3, 0.0, 0.0, 0.7],
                       [0.0, 0.0, 1.0, 0.0]], [0.5, 0.0, 0.5, 0.0], 1.5, (0, 1, 1, 0)),
)
MN_CHUNK, MN_DRAWS, MN_STATE_DRAWS, SEED_MN = 64, 8, 32, 2017
# the fit's Viterbi accuracy after greedy_relabel, mean over series, at
# most MN_ACC_GAP below the true parameters' own Viterbi accuracy on the
# same series (about two thirds and four fifths for the K=3 and the
# hard-gate K=4 model; the stan gate's own is near 0, its degenerate
# emission-only mode, so it is reported, not gated), and the
# posterior-mean emission rows' error
MN_ACC_GAP, MN_PHI_MAE_MAX = 0.15, 0.12
MN_FREQ_Z_MAX = 6.0  # |z| of the two state-draw routes' pooled frequencies
# tenth: the healing ladder of fit_batched on the Tayal batch (hard gate,
# Gibbs 100 + 300, chunks of 64): the faulted series sits in the second
# chunk; the NUTS heal runs 8 series of T=256, 10 + 10, max_treedepth 5
# (4 at the ladder's third rung; at 6 its four dispatches took about half
# of the phase)
HEAL_SERIES, HEAL_CHUNK = 70, 64
HEAL_NUTS_SERIES, HEAL_NUTS_T, HEAL_NUTS_TREEDEPTH = 8, 256, 5
HEAL_NUTS_WARMUP, HEAL_NUTS_SAMPLES = 10, 10  # 20 + 20 until the HSMM paths
# eleventh: per-series ChEES adaptation at the ChEES cell (stan gate, 2
# chains, cap 16), 256 series in one chunk, 50 + 50 transitions
CPS_WARMUP, CPS_SAMPLES = 50, 50
CPS_PHI_MAE_MAX = 0.08  # the emission rows after 50 + 50 (PHI_MAE_MAX holds 150 + 150)
# twelfth: the replication diagnostics on the ChEES draws of series 0,
# every leg 5 ticks (tayal_batch has no ticks); the card's relabel
# stats against the CPU's on the first REP_CPU_DRAWS draws, same noise
REP_LEG_TICKS, REP_CPU_DRAWS = 5, 16
# thirteenth: the IOHMMs of iohmm-reg/main.R:10-22 (T=300, K=3, M=4,
# stan mode) and iohmm-mix/main.R:10-39 (the hierarchical mixture, K=4,
# L=3, M=4, DEFAULT_HYPERPARAMS), as examples/iohmm_main.py builds them,
# 64 series each (one seed a series), fit_batched NUTS in one chunk, one
# chain, 50 + 50 transitions at max_treedepth 6 (the depth of the frozen
# Hassan record, results/hassan_replication.json; cut from Stan's 10);
# then 8 draws a series through generated / oblik_t and 8 state_draws a
# series (the Gumbel route of the time-varying log_A)
IO_SERIES, IO_T, IO_M, IO_K_REG, IO_K_MIX, IO_L = 64, 300, 4, 3, 4, 3
IO_WARMUP, IO_SAMPLES, IO_TREEDEPTH, IO_DRAWS, SEED_IO = 50, 50, 6, 8, 2005
# the gate: the posterior-mean b_km and s_k of IOHMM-reg, after matching
# intercepts, on the median series, within the bounds of
# tests/test_models.py::test_iohmm_reg_recovery; the divergent share
IO_B_ATOL, IO_S_ATOL, IO_DIV_MAX = 0.25, 0.15, 0.05
# fourteenth: wf_forecast on examples/hassan_replication.py's two frozen
# synthetic benchmarks (T=180, train_len 150: 30 walk-forward steps) at
# K=4, L=3, one chain, max_treedepth 6, 30 + 30 transitions (the
# record's 300 + 300, cut: every tree runs the 63 leapfrogs of depth 6,
# about 9 ms each on the host clock, so at 100 + 100 a benchmark took
# about 200 s, 80 of them the pilot; at 20 + 20 SYN-A missed its gates,
# MAPE 1.65 % and divergence rate 0.157), the pilot by wf_forecast's own
# rule (30 + 50)
HS_BENCHMARKS = {
    "SYN-A": dict(seed=2005, T=180, vol=0.008, regimes=2, drift_spread=-0.015, train_len=150),
    "SYN-B": dict(seed=2006, T=180, vol=0.02, regimes=2, drift_spread=0.01, train_len=150),
}
HS_K, HS_L, HS_WARMUP, HS_SAMPLES, HS_TREEDEPTH = 4, 3, 30, 30, 6
# gates, each at least as loose as the JAX record at 300 + 300 (SYN-A R²
# 0.994, MAPE 0.86 %; SYN-B R² 0.481, MAPE 1.70 %)
HS_GATES = {"SYN-A": dict(r2_min=0.95, mape_max=1.5), "SYN-B": dict(r2_min=None, mape_max=3.0)}
HS_DIV_MAX = 0.05  # divergence rate, mean over the steps
HS_RECORD = "results/hassan_replication.json"
# fifteenth: the route-augmented Gibbs of tests/test_routes.py::
# test_jangmin_single_chain_ess at full width, batched: the 63-leaf
# Jangmin tree semi-supervised (hard gate, order_mu="none") on 64 markets
# of T=100 (simulate_market, default_rng(i) for market i, true regime
# labels), fit_batched Gibbs 250 + 500 in one chunk, one chain; the JAX
# test's bars (there on market 0) on the median market; then 20 + 20 in
# the stan gate on 8 of them (the gated FFBS pair at K=63)
TG_MARKETS, TG_T, TG_WARMUP, TG_SAMPLES = 64, 100, 250, 500
TG_ESS_MIN, TG_RHAT_MAX = 50.0, 1.05
TG_STAN_MARKETS, TG_STAN_WARMUP, TG_STAN_SAMPLES = 8, 20, 20
# sixteenth: the semi-supervised NUTS fit of tests/test_jangmin_app.py::
# test_semisup_fit_recovers_regimes at full width, batched: 64 markets of
# T=250 (default_rng(1000 + i)), hard gate, one chain, 100 + 100 at
# max_treedepth 5 (the test's own configuration); the ungated twin's
# decode of 50 thinned draws a market in one generated call (3,200 lanes
# at K=63); the test's gates (divergent share, majority rate, 0.05 below
# the true-parameter oracle) over the markets; fit_market once at 30 + 30
SEED_TREE = 1000
JM_MARKETS, JM_T, JM_WARMUP, JM_SAMPLES, JM_TREEDEPTH, JM_DRAWS = 64, 250, 100, 100, 5, 50
JM_DIV_MAX, JM_ORACLE_GAP = 0.15, -0.05
JM_APP_WARMUP, JM_APP_SAMPLES = 30, 30
# seventeenth to twenty-second: the explicit-duration HSMMs
# (models/hsmm.py) on the count-down expansion, every series simulated by
# hsmm_sim in one batch on a CPU generator. hsmm: bench_zoo.py::
# bench_hsmm's arm (K=2, Dmax=6, so K'=12; T=400, its A and peaked dur,
# mu +-0.8, sigma 0.7), its one series widened to 256, fit_batched Gibbs
# 100 + 300 in one chunk, then generated and state_draws on 32 draws a
# series (8192 lanes)
HSMM_K, HSMM_DMAX, HSMM_T, HSMM_SERIES = 2, 6, 400, 256
HSMM_A = [[0.0, 1.0], [1.0, 0.0]]
HSMM_DUR = [[0.02, 0.03, 0.15, 0.40, 0.30, 0.10], [0.02, 0.08, 0.30, 0.40, 0.15, 0.05]]
HSMM_MU, HSMM_SIGMA = [-0.8, 0.8], [0.7, 0.7]
HSMM_WARMUP, HSMM_SAMPLES, HSMM_DRAWS, SEED_HSMM = 100, 300, 32, 2010
# hsmm_dmax1: the Dmax=1 contract on the card, GaussianHSMM(K=3, Dmax=1)
# against GaussianHMM(K=3) on the hmm/main.R data, 256 series x T=500, 8
# random draws a series
D1_DRAWS = 8
# hsmm_nuts: the hsmm arm's model without a prior under NUTS, 64 series
# (bench_zoo.py's --max-treedepth 6), 30 + 30 transitions, in the spawned
# pool (FWD + VG_BWD at K'=12 once a value-and-grad call)
HN_SERIES, HN_WARMUP, HN_SAMPLES, HN_TREEDEPTH, HN_DIV_MAX = 64, 30, 30, 6, 0.05
# hsmm_recovery: tests/test_hsmm.py::test_hsmm_beats_geometric_hmm_heldout
# (K=2, Dmax=6, T=300, the first 220 steps to train, its dur) widened
# from 4 series to 256: the HSMM and the geometric GaussianHMM by Gibbs
# 60 + 120, every 4th draw filtered over the whole series (one FILTER
# launch a model); the gate: the pooled held-out one-step log-likelihood
# of the HSMM above the HMM's
HR_T, HR_TRAIN, HR_SERIES, HR_WARMUP, HR_SAMPLES, HR_THIN = 300, 220, 256, 60, 120, 4
HR_DUR = [[0.0, 0.0, 0.1, 0.3, 0.4, 0.2], [0.0, 0.1, 0.4, 0.4, 0.1, 0.0]]
HR_MU, HR_SIGMA = [-0.9, 0.9], [0.75, 0.75]
# hsmm_daily: three regimes of daily returns (means -1, 0, 1 in sigma
# units) whose dwells last up to a quarter (Dmax=60 trading days, so K'=
# 180: every kernel in the big layout), peaked dwells of 10-50 steps
# (modes 15, 30, 45, sd 6), 64 series x T=1000, Gibbs 100 + 200, then the
# decode of 20 thinned draws a series (1,280 lanes); the gate: the median
# over series of the collapsed Viterbi regime accuracy within HD_ACC_GAP
# of the decode by the true emissions and transitions with flat duration
# pmfs (see phase_hsmm_daily; the gap to the true-parameter decode is
# reported)
HD_K, HD_DMAX, HD_T, HD_SERIES = 3, 60, 1000, 64
HD_MU, HD_SIGMA = [-1.0, 0.0, 1.0], [1.0, 1.0, 1.0]
HD_A = [[0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]]
HD_PEAKS, HD_DWELL_SD, HD_DWELL_RANGE = (15, 30, 45), 6.0, (10, 50)
HD_WARMUP, HD_SAMPLES, HD_DRAWS, HD_ACC_GAP = 100, 200, 20, 0.05
# multinom_hsmm: MultinomialHSMM at hmm/main-multinom.R's K=3, L=5 with
# Dmax=8 (K'=24, a block a lane), 256 series x T=1024, Gibbs 100 + 300 in
# one chunk; the emission rows reported after the best relabelling
MH_K, MH_DMAX, MH_L, MH_T, MH_SERIES = 3, 8, 5, 1024, 256
MH_A = [[0.0, 0.6, 0.4], [0.5, 0.0, 0.5], [0.3, 0.7, 0.0]]
MH_DUR = [[0.05, 0.10, 0.20, 0.30, 0.20, 0.10, 0.05, 0.0],
          [0.30, 0.40, 0.20, 0.10, 0.0, 0.0, 0.0, 0.0],
          [0.0, 0.0, 0.05, 0.10, 0.15, 0.20, 0.25, 0.25]]
MH_WARMUP, MH_SAMPLES = 100, 300

# the FFBS checks (each bitwise against the plain versions): every K the
# kernels take, gated and not, at the main path's shape with a ragged
# tail, then (N, T) that are not a multiple of a lane group, a block or a
# ring stage, with masked runs at both ends of every lane; T=2100 puts
# BWD_SAMPLE's maps in its device scratch instead of shared memory
FFBS_KS = (2, 3, 4, 8)
FFBS_SHAPES = ((N_SERIES, T_FIT, False), (250, 1000, True), (1, T_FIT, True), (N_SERIES, 1, True),
               (5, 2100, True))
# every other K of four-bit maps (2..16: groups of 8 and 16 threads a
# lane, two map words a step above 8), at fewer lanes; K above 16 in
# phase_kernels_wide
EXTRA_KS = tuple(k for k in range(2, 17) if k not in FFBS_KS)
# the other K's checks (FFBS, value-and-grad, decode) run at T=500: off
# every ring's and chunk's length, and half the plain versions' host
# loop of the main paths' T=1024, which set the script's time
EXTRA_T = 500
EXTRA_FFBS_SHAPES = ((64, EXTRA_T, True), (3, 2100, True))
EXTRA_VG_LANES = 64
EXTRA_DECODE_LANES = 256
FFBS_TIMING_LANES = (1, 256, 512, 2048, 8192)  # FWD / BWD_SAMPLE timed at T=1024, K=4

# seconds of launches that warm the card up after the build's idle
# stretch, before the first kernel timing
CLOCK_WARMUP_S = 1.0

# tolerances (kernel vs plain version on the card)
DECODE_ATOL = 1e-5  # filtered probabilities, absolute
PHI_MAE_MAX = 0.05  # posterior-mean emission rows vs the simulator's
# divergent share of the ChEES sampling transitions (lanes x transitions):
# one shared step size meets a few genuinely unstable trajectories on
# this batch (they diverge in float64 and through the unfused path too);
# a wrong gradient diverges on a large share. One fit's count is
# heavy-tailed: a chain that settles where the shared step size is
# unstable diverges on about every other transition from then on, so
# the count swings by tens between sampler seeds with either trajectory
# kernel design, and the share is taken over the fits of CHEES_SEEDS
DIV_SHARE_MAX = 1e-3
CHEES_SEEDS = (SEED_SAMPLER, SEED_SAMPLER + 1, SEED_SAMPLER + 2, SEED_SAMPLER + 3)
REPLAY_DH_MIN = 100.0  # a replayed divergence's float64 energy error
PROB_ATOL = 1e-5  # decode probabilities: alpha rows sum to 1, kernels vs plain
# gamma = exp(log_alpha + log_beta - lse(...)) at T=1024: the f32 sum and
# its normaliser are each rounded at |loglik| ~ 1.6e3 (ulp 1.2e-4), so a
# row sums to 1 only within a few of those ulps (in the JAX package too)
GAMMA_SUM_TOL = 1e-3
G_MU_TOL = 0.35  # Gaussian posterior-mean mu, mean over series (tests/test_gibbs.py)
# the K=20 decode on the card against the same call on the CPU: torch's exp
# and log round differently on the two devices (in build and in the plain
# versions). At T=500 a log-alpha of about -1e3 has an f32 ulp of 6.1e-5;
# two runs read gamma 1.22e-4 off (two ulps, the same through the scans
# and through the kernels), alpha 4.5e-5, loglik and logp_zstar 9.9e-7
# relative, and identical paths (the inputs come from a seed, so the
# comparison is deterministic). The limits are twice the readings: four
# ulps, and no path may differ
WIDE_PROB_ATOL, WIDE_LL_RTOL, WIDE_PATH_MISMATCH_MAX = 2.5e-4, 2e-6, 0.0
# the K=64 value-and-grad call on the card against the same call on the
# CPU: d_A is a sum over T=500 steps, compared relative to its largest
# entry (a first run read 5.0e-8; d_pi and d_obs 1.2e-7 absolute, under
# WIDE_PROB_ATOL; loglik 0 relative, under WIDE_LL_RTOL)
WIDE_DA_RTOL = 1e-6
G_ACC_MIN = 0.9  # Gaussian Viterbi accuracy (tests/test_models.py)
# trajectory (tests/test_pallas_traj.py's tolerances): (rtol, atol)
TRAJ_TOL = {"q": (2e-4, 2e-4), "p": (2e-3, 2e-3), "logp": (1e-4, 5e-3), "grad": (2e-3, 2e-3)}
# the trajectory kernel against traj_plain at odd shapes, every lane's
# series with masked runs at both ends: (B, T, C, n_steps). T = 1000 and
# 100 are off the kernel's 16-step chunks, T = 6500 puts its per-step
# buffers in the device scratch, n_steps = CAP + 4 is clamped to CAP
TRAJ_ODD_CASES = ((N_SERIES, T_FIT, CHAINS, 2), (5, 1000, 3, 1), (5, 1000, 1, 0),
                  (1, T_FIT, 1, 1), (5, 1, 2, CAP + 4), (5, 100, 2, 16), (5, 6500, 2, 1))
TRAJ_TIMING_LANES = (1, N_LANES, 2048)  # TRAJ timed at T=1024, 16 leapfrogs
# the largest errors of the one-thread-a-lane kernel this design replaced,
# on the two full-T checks below (its own run of this script)
TRAJ_EARLIER_ERR = {"logp_vs_plain": 1.5e-3, "logp_vs_f64_plain": 1.1e-2}

SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz (time_ms)

# the bound column's peaks: the H100 SXM's HBM rate and its f32 rate
# outside the tensor cores (obs/profile.py's PEAKS row)
BOUND_DEVICE = "NVIDIA H100 80GB HBM3"


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s`` is the host clock's seconds since the
    script started (what the timeline line sums by phase group)."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - T_START}),
          flush=True)


def sync() -> None:
    torch.cuda.synchronize()


# The pool's processes and the example drivers run beside this process's
# phases from the zoo on (:func:`start_pool`). Their ids are listed here
# while they run, and every timing taken here stops them for its length
# (:func:`quiet`), so a kernel or a host stage timed here has the card
# and the host to itself; the stopped processes' queued work ends under
# ``time_ms``'s spin kernel, or in ``QUIET_DRAIN_S``.
BESIDE = {"pids": set(), "lock": threading.Lock()}
QUIET_DRAIN_S = 0.02
POOL_NICE = 10  # the pool's processes and the drivers yield the host to this one


@contextlib.contextmanager
def quiet():
    """Stop (``SIGSTOP``) the processes running beside this one for the
    length of the block, and continue them after it, whatever it raised."""
    with BESIDE["lock"]:
        stopped = []
        try:
            for pid in sorted(BESIDE["pids"]):
                try:
                    os.kill(pid, signal.SIGSTOP)
                    stopped.append(pid)
                except ProcessLookupError:
                    pass
            if stopped:
                time.sleep(QUIET_DRAIN_S)
            yield len(stopped)
        finally:
            for pid in stopped:
                try:
                    os.kill(pid, signal.SIGCONT)
                except ProcessLookupError:
                    pass


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls. The calls
    are queued behind a spin kernel, so that a kernel shorter than its
    wrapper's host time is timed on the card and not at the host's
    launch rate (a plain version, whose host loop outlasts the spin,
    is timed as it runs). The processes beside this one are stopped
    meanwhile (:func:`quiet`)."""
    with quiet():
        for _ in range(warmup):
            fn()
        sync()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_case(seed: int, N: int, T: int, K: int, gated: bool, device, both_ends: bool = False):
    """Random normalized (pi, A), N(-1, 1) emissions, ragged mask of
    lengths in [T/2, T] (with ``both_ends``, each lane's first [0, T/8]
    steps masked too), sign gate on a Tayal-like state key; returned in
    the kernels' lane layout with uniforms ``u [T, N]``."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    f32 = dict(dtype=torch.float32, device=device)
    log_pi = torch.as_tensor(log_norm(rng.normal(size=(N, K))), **f32)
    log_A = torch.as_tensor(log_norm(rng.normal(size=(N, K, K))), **f32)
    log_obs = torch.as_tensor(rng.normal(size=(N, T, K)) - 1.0, **f32)
    lengths = rng.integers(T // 2, T + 1, size=N)
    valid = np.arange(T)[None, :] < lengths[:, None]
    if both_ends:
        valid &= np.arange(T)[None, :] >= rng.integers(0, T // 8 + 1, size=N)[:, None]
    mask = torch.as_tensor(valid, **f32)
    gk = sk = None
    if gated:
        gk = torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32)
        sk = torch.as_tensor(np.resize([1.0, 0.0, 0.0, 1.0], K), **f32)
    u = torch.as_tensor(rng.random((N, T)), **f32)
    lanes = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, mask, gk, sk)
    return lanes, u.t().contiguous()


def _steps(mask_t) -> int:
    """Valid steps after the first over all lanes (a masked step copies
    its carry and does no arithmetic)."""
    return int((mask_t[1:] > 0).sum())


def fwd_bytes_ops(lanes):
    """``FWD``'s counted bytes and f32 operations on these lanes
    (``obs/profile.py::kernel_cost``, the count ``roofline`` reads)."""
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    c = kernel_cost("FWD", K, T, N, gate_t is not None, valid_steps=_steps(mask_t))
    return c["bytes_accessed"], c["flops"]


def bwd_bytes_ops(lanes):
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    c = kernel_cost("BWD_SAMPLE", K, T, N, gate_t is not None)
    return c["bytes_accessed"], c["flops"]


def bound(bytes_, ops):
    return bound_ms({"bytes_accessed": bytes_, "flops": ops}, BOUND_DEVICE)


def vg_bytes_ops(lanes):
    """Bytes and f32 operations of ``VG_BWD`` on these lanes: inputs
    (A, obs, mask, alpha, ll, gate keys) read once, outputs (d_pi, d_A,
    d_obs) written once; the arithmetic of the valid steps."""
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    c = kernel_cost("VG_BWD", K, T, N, gate_t is not None, valid_steps=_steps(mask_t))
    return c["bytes_accessed"], c["flops"]


def traj_bytes_ops(T: int, B: int, C: int, mask_t, n_steps: int):
    """Bytes and f32 operations of ``TRAJ`` for one trajectory of
    ``n_steps`` leapfrogs on ``B`` series x ``C`` chains (``mask_t [T,
    B]``, the series' mask)."""
    c = kernel_cost("TRAJ", 4, T, B * C, valid_steps=_steps(mask_t) * C, series=B,
                    leapfrogs=n_steps)
    return c["bytes_accessed"], c["flops"]


def ffbs_checks(device, ready):
    """``FWD`` and ``BWD_SAMPLE`` bitwise equal to ``fwd_plain`` and
    ``bwd_sample_plain`` (alpha, ll and every draw) in every case of
    ``FFBS_KS`` x gated x ``FFBS_SHAPES`` and ``EXTRA_KS`` x gated x
    ``EXTRA_FFBS_SHAPES``. The plain versions of every case run first,
    while ``nvcc`` builds the kernels (their host loops need none);
    ``ready()`` returns once the two kernels are bound, then each runs on
    the kept inputs. Returns the cases and the largest errors."""
    grid = [(K, g, shape) for K in FFBS_KS for g in (False, True) for shape in FFBS_SHAPES]
    grid += [(K, g, shape) for K in EXTRA_KS for g in (False, True) for shape in EXTRA_FFBS_SHAPES]
    plain = []
    for i, (K, gated, (N, T, both)) in enumerate(grid):
        lanes, u_t = make_case(1000 + i, N, T, K, gated, device, both_ends=both)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_p, a_p = cs.fwd_plain(*lanes)
        z_p = cs.bwd_sample_plain(A_t, mask_t, a_p, u_t, gate_t, sk_t)
        plain.append((lanes, u_t, ll_p, a_p, z_p))
    ready()
    cases = []
    fwd_err = z_err = 0.0
    for (K, gated, (N, T, both)), (lanes, u_t, ll_p, a_p, z_p) in zip(grid, plain):
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_k, a_k = cs.fwd_lanes(*lanes)
        z_k = cs.bwd_sample_lanes(A_t, mask_t, a_k, u_t, gate_t, sk_t)
        sync()
        fwd_err = max(fwd_err, float((a_k - a_p).abs().max()), float((ll_k - ll_p).abs().max()))
        z_err = max(z_err, float((z_k - z_p).abs().max()))
        same = {"alpha": torch.equal(a_k, a_p), "ll": torch.equal(ll_k, ll_p),
                "z": torch.equal(z_k, z_p)}
        if not all(same.values()):
            raise AssertionError(
                f"FFBS K={K} gated={gated} N={N} T={T}: not bitwise equal to the plain "
                f"versions {same}, alpha err {float((a_k - a_p).abs().max()):.3g}, "
                f"{int((z_k != z_p).sum())} draws differ"
            )
        cases.append(dict(K=K, gated=gated, N=N, T=T, masked_both_ends=both,
                          masked_steps=int((mask_t == 0).sum())))
        emit("kernels_vs_plain", bitwise_equal=True, **cases[-1])
    return cases, fwd_err, z_err


def phase_kernels(device, checked):
    """``FWD`` and ``BWD_SAMPLE``, checked by :func:`ffbs_checks`
    (``checked``), timed at the main path's shape, on one lane, and at
    each of ``FFBS_TIMING_LANES`` lanes."""
    cases, fwd_err, z_err = checked
    # timing at the main-path shape: N=256, T=1024, K=4, ungated
    lanes, u_t = make_case(2000, N_SERIES, T_FIT, K_TAYAL, False, device)
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    # the card idles while the last sources build, after the checks: a
    # second of launches brings its clocks back up before the first timing
    t_warm = time.perf_counter() + CLOCK_WARMUP_S
    while time.perf_counter() < t_warm:
        for _ in range(20):
            cs.fwd_lanes(*lanes)
        sync()
    _, alpha = cs.fwd_lanes(*lanes)
    t = {}
    t["fwd_ms"] = time_ms(lambda: cs.fwd_lanes(*lanes), reps=50)
    t["bwd_ms"] = time_ms(lambda: cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t), reps=50)
    t["fwd_plain_ms"] = time_ms(lambda: cs.fwd_plain(*lanes), reps=3, warmup=1)
    t["bwd_plain_ms"] = time_ms(
        lambda: cs.bwd_sample_plain(A_t, mask_t, alpha, u_t), reps=3, warmup=1
    )
    # one lane alone: the serial T-step chain, which no batch size shortens
    one = tuple(None if x is None else x[..., :1].contiguous() for x in lanes)
    _, alpha1 = cs.fwd_lanes(*one)
    u1 = u_t[:, :1].contiguous()
    t["fwd_one_lane_ms"] = time_ms(lambda: cs.fwd_lanes(*one), reps=50)
    t["bwd_one_lane_ms"] = time_ms(
        lambda: cs.bwd_sample_lanes(one[1], one[3], alpha1, u1), reps=50
    )
    # the whole FFBS wrapper as the Gibbs sweep calls it (layout included)
    log_pi = pi_t.t().contiguous()
    log_A = A_t.permute(2, 0, 1).contiguous()
    log_obs = obs_t.permute(2, 0, 1).contiguous()
    mask, u = mask_t.t().contiguous(), u_t.t().contiguous()
    t["ffbs_wrapper_ms"] = time_ms(
        lambda: cs.semiring_ffbs(log_pi, log_A, log_obs, mask, u), reps=50
    )
    # the decode's shape: gated, 2048 lanes
    dlanes, _ = make_case(2001, N_SERIES * N_DRAWS, T_FIT, K_TAYAL, True, device)
    t["fwd_decode_gated_2048_ms"] = time_ms(lambda: cs.fwd_lanes(*dlanes), reps=20)
    del dlanes
    # both kernels across batch sizes, and ns a step (T=1024, dense mask)
    by_lanes = {}
    for N in FFBS_TIMING_LANES:
        nl, nu = make_case(2002, N, T_FIT, K_TAYAL, False, device)
        _, na = cs.fwd_lanes(*nl)
        f = time_ms(lambda: cs.fwd_lanes(*nl), reps=20)
        b = time_ms(lambda: cs.bwd_sample_lanes(nl[1], nl[3], na, nu), reps=20)
        by_lanes[N] = dict(fwd_ms=f, fwd_ns_per_step=f * 1e6 / T_FIT,
                           bwd_ms=b, bwd_ns_per_step=b * 1e6 / T_FIT)
        del nl, nu, na
    t["by_lanes"] = by_lanes
    emit("kernel_timing", shape=dict(N=N_SERIES, T=T_FIT, K=K_TAYAL), **t)
    fb, fo = fwd_bytes_ops(lanes)
    bb, bo = bwd_bytes_ops(lanes)
    return dict(cases=cases, fwd_err=fwd_err, z_err=z_err, timing=t,
                fwd_bound=bound(fb, fo), bwd_bound=bound(bb, bo),
                fwd_bytes=fb, fwd_ops=fo, bwd_bytes=bb, bwd_ops=bo)


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------


ALL_KERNELS = cs.KERNELS + ct.KERNELS

# the bear/bull pair-swap relabeling of the Tayal posterior: p_11 <-> 1-p_11,
# A_row rows swap, phi rows permute [3, 2, 1, 0]
MIRROR = [3, 2, 1, 0]


def canonical_draws(p):
    """Constrained draws ``[B, C, S, 41]`` (p_11, A_row, phi_k) with the
    mirror label modes folded per draw toward each series' first draw
    (the fold ``bench.py`` applies before its worst-parameter ESS), and
    the share of draws folded."""
    p11 = p["p_11"].cpu().numpy()
    B, C, S = p11.shape
    p11 = p11.reshape(B, C * S)
    A_row = p["A_row"].cpu().numpy().reshape(B, C * S, 2, 2)
    phi = p["phi_k"].cpu().numpy().reshape(B, C * S, 4, 9)
    anchor = phi[:, :1]
    swap = ((phi[:, :, MIRROR] - anchor) ** 2).sum(axis=(2, 3)) < (
        (phi - anchor) ** 2
    ).sum(axis=(2, 3))
    p11 = np.where(swap, 1.0 - p11, p11)
    A_row[swap] = A_row[swap][:, ::-1]
    phi[swap] = phi[swap][:, MIRROR]
    mats = np.concatenate(
        [p11[..., None], A_row.reshape(B, C * S, 4), phi.reshape(B, C * S, 36)], axis=-1
    )
    return mats.reshape(B, C, S, -1), float(swap.mean())


def phase_fit(device, kernel_ms_per_sweep):
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode="hard")
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=WARMUP, num_samples=SAMPLES, num_chains=1)
    sync()
    ffbs = (cs.FWD, cs.BWD_SAMPLE)
    before = {k.name: k.launches for k in ffbs}
    t0 = time.perf_counter()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    sweeps = WARMUP + SAMPLES
    rose = {k.name: k.launches - before[k.name] for k in ffbs}
    if any(v != sweeps for v in rose.values()):
        raise AssertionError(f"fit: kernel launches {rose}, expected {sweeps} each")
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError("fit: a chain was quarantined")
    if not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("fit: non-finite logp")
    if tuple(qs.shape) != (N_SERIES, 1, SAMPLES, model.n_free):
        raise AssertionError(f"fit: qs shape {tuple(qs.shape)}")

    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= PHI_MAE_MAX:
        raise AssertionError(f"fit: posterior-mean phi MAE {mae.mean():.3g} > {PHI_MAE_MAX}")
    emit(
        "fit",
        series=N_SERIES, T=T_FIT, chains=1, warmup=WARMUP, samples=SAMPLES,
        seconds=wall, sweeps_per_s=sweeps / wall, series_per_s=N_SERIES / wall,
        sweep_ms=wall / sweeps * 1e3,
        # the two kernels' own time (phase 3, same shape) as a share of a sweep
        kernel_share=kernel_ms_per_sweep / (wall / sweeps * 1e3),
        launches=rose, logp_mean=float(stats["logp"].mean()),
        ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
        mirror_fold_share=swap_share,
        phi_mae_mean=float(mae.mean()), phi_mae_max=float(mae.max()),
    )
    return qs, phi_mean


def fold_and_score(model, qs):
    """Fold the mirror label modes, then per series: the worst-parameter
    ESS, the share of draws folded, the posterior-mean emission rows
    ``[B, 4, 9]`` and their mean absolute error against the simulator's
    rows, up to the mirror relabeling the fold leaves open (each
    series' anchor is its own first draw)."""
    mats, swap_share = canonical_draws(model.constrained_draws(qs))  # [B, C, S, P]
    B, C, S, P = mats.shape
    per_param = ess_many(np.moveaxis(mats, -1, 1).reshape(B * P, C, S)).reshape(B, P)
    phi_true = tayal_phi(SEED_DATA)
    phi_mean = mats[..., 5:].reshape(B, C * S, 4, 9).mean(axis=1)
    mae = np.minimum(
        np.abs(phi_mean - phi_true).mean(axis=(1, 2)),
        np.abs(phi_mean[:, MIRROR] - phi_true).mean(axis=(1, 2)),
    )
    return per_param.min(axis=1), swap_share, phi_mean, mae


def phase_decode(device, qs):
    xs, ss = tayal_batch(N_SERIES, T_FIT + T_OOS, seed=SEED_DATA, device=device)
    data = {
        "x": xs[:, :T_FIT], "sign": ss[:, :T_FIT],
        "x_oos": xs[:, T_FIT:], "sign_oos": ss[:, T_FIT:],
    }
    draws = qs[:, 0, :: SAMPLES // N_DRAWS][:, :N_DRAWS]  # [B, 8, D]
    lite = TayalHHMMLite(gate_mode="stan")
    fwd_before = cs.FWD.launches
    sync()
    t0 = time.perf_counter()
    out = lite.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    shapes = {
        "alpha": (N_SERIES, N_DRAWS, T_FIT, 4),
        "alpha_oos": (N_SERIES, N_DRAWS, T_OOS, 4),
        "zstar_oos": (N_SERIES, N_DRAWS, T_OOS),
    }
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            raise AssertionError(f"decode: {k} shape {tuple(out[k].shape)} != {shp}")
    for k in ("alpha", "alpha_oos"):
        a = out[k]
        if not bool(torch.isfinite(a).all()) or float((a.sum(-1) - 1).abs().max()) > 1e-5:
            raise AssertionError(f"decode: {k} is not a finite probability vector per step")
    z = out["zstar_oos"]
    if not bool(((z >= 0) & (z < 4)).all()):
        raise AssertionError("decode: zstar_oos out of range")

    # the gated forward kernel against its plain version on the same lanes
    n = N_SERIES * N_DRAWS
    params, _ = lite.unpack(draws.reshape(n, -1))
    errs = {}
    for key, xk, sk_ in (("alpha", "x", "sign"), ("alpha_oos", "x_oos", "sign_oos")):
        seg = {"x": data[xk].repeat_interleave(N_DRAWS, 0),
               "sign": data[sk_].repeat_interleave(N_DRAWS, 0)}
        log_pi, log_A, log_obs, _ = lite.build_vg(params, seg)
        gk, skey = lite.gate_keys(seg)
        mask = torch.ones(seg["x"].shape, dtype=torch.float32, device=device)
        _, a_plain = cs.fwd_plain(*cs.to_lanes(log_pi, log_A, log_obs, mask, gk, skey))
        ref = torch.softmax(a_plain.permute(2, 0, 1), dim=-1).reshape(out[key].shape)
        errs[key] = float((out[key] - ref).abs().max())
    if max(errs.values()) > DECODE_ATOL:
        raise AssertionError(f"decode: kernel vs plain filtered probabilities {errs}")
    emit(
        "decode", lanes=n, T=T_FIT, T_oos=T_OOS, seconds=wall,
        fwd_launches=cs.FWD.launches - fwd_before, max_abs_err_vs_plain=errs,
    )


# ---------------------------------------------------------------------------
# phase 3 (cont.): the value-and-grad and trajectory kernels
# ---------------------------------------------------------------------------


def vg_plain_cases(device):
    """The value-and-grad checks' cases (N=512, T=1024, K in {3, 4, 8},
    and N=64, T=``EXTRA_T`` at every other K in 2..16, gated and not,
    ragged mask) with ``fwd_plain`` + ``vg_bwd_plain`` on each: they need
    no kernel, so they run beside the build."""
    main = [(4, False), (4, True), (8, False), (8, True), (3, False)]
    grid = [(N_LANES, T_FIT, K, g) for K, g in main]
    grid += [(EXTRA_VG_LANES, EXTRA_T, K, g) for K in range(2, 17)
             for g in (False, True) if (K, g) not in main]
    out = []
    for i, (N, T, K, gated) in enumerate(grid):
        lanes, _ = make_case(3000 + i, N, T, K, gated, device)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_p, a_p = cs.fwd_plain(*lanes)
        want = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p, gate_t, sk_t)
        out.append(((N, T, K, gated), lanes, ll_p, want))
    return out


def phase_kernels_vg(device, plain):
    """``FWD`` + ``VG_BWD`` bitwise equal to ``fwd_plain`` +
    ``vg_bwd_plain`` on the cases of :func:`vg_plain_cases` (``plain``,
    computed beside the build), then timed on the main path's lanes."""
    errs = {"ll_rel": 0.0, "d_pi": 0.0, "d_obs": 0.0, "d_A_rel": 0.0, "d_A": 0.0}
    for (N, T, K, gated), lanes, ll_p, want in plain:
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_k, a_k = cs.fwd_lanes(*lanes)
        got = cs.vg_bwd_lanes(A_t, obs_t, mask_t, a_k, ll_k, gate_t, sk_t)
        sync()
        e = {
            "ll_rel": float(((ll_k - ll_p).abs() / ll_p.abs()).max()),
            "d_pi": float((got[0] - want[0]).abs().max()),
            "d_obs": float((got[2] - want[2]).abs().max()),
            "d_A_rel": float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)).max()),
            "d_A": float((got[1] - want[1]).abs().max()),
        }
        same = torch.equal(ll_k, ll_p) and all(torch.equal(g, w) for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"value-and-grad K={K} gated={gated} N={N}: not bitwise "
                                 f"equal to the plain versions, {e}")
        errs = {k: max(errs[k], v) for k, v in e.items()}
        emit("vg_vs_plain", N=N, T=T, K=K, gated=gated, bitwise_equal=True, **e)

    # timing on the main path's own lanes: the stan-gate Tayal terms of
    # the ChEES fit's inits (K=4, gated, dense)
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    init = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    lanes = tayal_lanes(model, data, init)
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    ll, alpha = cs.fwd_lanes(*lanes)
    t = {}
    t["ms"] = time_ms(lambda: cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t), reps=50)
    t["plain_ms"] = time_ms(
        lambda: cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t), reps=2, warmup=1
    )
    one = tuple(None if v is None else v[..., :1].contiguous() for v in lanes)
    ll1, alpha1 = cs.fwd_lanes(*one)
    t["one_lane_ms"] = time_ms(
        lambda: cs.vg_bwd_lanes(one[1], one[2], one[3], alpha1, ll1, one[4], one[5]), reps=50
    )
    t["fwd_ms"] = time_ms(lambda: cs.fwd_lanes(*lanes), reps=50)
    lp_bc = make_lp_bc(model, data, device=device)
    t["lp_bc_ms"] = time_ms(lambda: lp_bc(init), reps=20)
    emit("vg_timing", shape=dict(N=N_LANES, T=T_FIT, K=4, gated=True), **t)
    b, o = vg_bytes_ops(lanes)
    return dict(err=errs, timing=t, bound=bound(b, o), bytes=b, ops=o)


def tayal_lanes(model, data, q):
    """The stan-gate Tayal value-and-grad lanes at ``q [B, C, 35]``, as
    ``make_vg`` builds them (dense mask)."""
    B, C, _ = q.shape
    n = B * C
    params, _ = model.unpack(q)
    lanes = {k: broadcast_data(v, (B, C)) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = model.build_vg(params, lanes)
    gk, sk = model.gate_keys(lanes)
    T = log_obs.shape[-2]
    mask = torch.ones((n, T), dtype=torch.float32, device=q.device)
    return cs.to_lanes(
        log_pi.reshape(n, 4), log_A.reshape(n, 4, 4), log_obs.reshape(n, T, 4), mask,
        gk.reshape(n, T), sk.reshape(n, 4),
    )


def state_errors(got, want):
    """Per quantity (q, p, logp, grad): max abs error and the largest
    excess over ``atol + rtol * |want|`` (positive = out of tolerance)."""
    out = {}
    for name, a, b in zip(("q", "p", "logp", "grad"), got, want):
        rtol, atol = TRAJ_TOL[name]
        d = (a - b).abs()
        out[name] = (float(d.max()), float((d - atol - rtol * b.abs()).max()))
    return out


def phase_kernels_traj(device):
    """``TRAJ`` against ``traj_plain`` (2 leapfrogs) and against the
    unfused leapfrogs over ``make_lp_bc`` (8) at the ChEES shape; then
    its time per leapfrog at 16, on one lane, and its plain version."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    q = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.randn(q.shape, generator=gen, **f32)
    inv_mass = torch.exp(0.3 * torch.randn((N_SERIES, ct.DIM), generator=gen, **f32))
    eps = 0.02
    lp_bc = make_lp_bc(model, data, device=device)
    _, g0 = lp_bc(q)
    x_t, s_t, m_t = ct._data_lanes(x, sign, None, device)

    def lanes(a):
        return a.reshape(N_LANES, ct.DIM).t().contiguous()

    args = (lanes(q), lanes(p), lanes(g0), inv_mass.t().contiguous(), x_t, s_t, m_t)
    eps_t = torch.tensor([eps], **f32)

    def n_t(n):
        return torch.tensor([n], dtype=torch.int32, device=device)

    got = ct.traj_lanes(*args, eps_t, n_t(2), CAP, CHAINS)
    want = ct.traj_plain(*args, eps_t, n_t(2), CAP, CHAINS)
    sync()
    vs_plain = state_errors(got, want)
    # the fused trajectory in f32 against its plain version in f64, 8
    # leapfrogs: the f32 kernel is accurate at the full T
    got8 = ct.traj_lanes(*args, eps_t, n_t(8), CAP, CHAINS)
    f64 = [a.double() for a in args]
    f64[4], f64[5] = args[4], args[5]  # symbols and signs stay int32
    want8 = ct.traj_plain(*f64, eps_t.double(), n_t(8), CAP, CHAINS)
    sync()
    vs_f64 = state_errors([a.double() for a in got8], want8)

    def unfused(lp_fn, g, n):
        qu, pu, gu, lpu = q, p, g, None
        for _ in range(n):
            ph = pu + 0.5 * eps * gu
            qu = qu + eps * inv_mass[:, None, :] * ph
            lpu, gu = lp_fn(qu)
            pu = ph + 0.5 * eps * gu
        return qu, pu, lpu, gu

    # fused vs unfused (FWD + VG_BWD kernels), 8 leapfrogs, same inputs,
    # on the first T_SHORT legs of every series: the regime the
    # tolerances were set for. At T=1024 the unfused log-space path
    # itself carries an f32 gradient error of order T * ulp(|loglik|)
    # (every gamma is exp(alpha + beta - ll) with |ll| ~ 1.6e3), so
    # there the gap is reported, not gated.
    short = {"x": x[:, :T_SHORT], "sign": sign[:, :T_SHORT]}
    lp_short = make_lp_bc(model, short, device=device)
    _, g_short = lp_short(q)
    fused = ct.make_tayal_trajectory(short, cap=CAP, device=device)(
        inv_mass, eps, 8, q, p, None, g_short
    )
    vs_unfused = state_errors(fused, unfused(lp_short, g_short, 8))
    traj = ct.make_tayal_trajectory(data, cap=CAP, device=device)
    fused_full = traj(inv_mass, eps, 8, q, p, None, g0)
    gap_full = state_errors(fused_full, unfused(lp_bc, g0, 8))
    sync()
    for what, e in (("plain", vs_plain), ("f64 plain", vs_f64), ("unfused", vs_unfused)):
        bad = {k: v for k, v in e.items() if v[1] > 0}
        if bad:
            raise AssertionError(f"trajectory vs {what}: out of tolerance {bad}")
    emit("traj_vs_plain", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=2,
         max_abs_err={k: v[0] for k, v in vs_plain.items()},
         earlier_design_logp_err=TRAJ_EARLIER_ERR["logp_vs_plain"])
    emit("traj_vs_plain_f64", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=8,
         max_abs_err={k: v[0] for k, v in vs_f64.items()},
         earlier_design_logp_err=TRAJ_EARLIER_ERR["logp_vs_f64_plain"])
    odd = [traj_odd_case(device, 4000 + i, *c) for i, c in enumerate(TRAJ_ODD_CASES)]
    emit("traj_vs_unfused", B=N_SERIES, C=CHAINS, T=T_SHORT, n_steps=8,
         max_abs_err={k: v[0] for k, v in vs_unfused.items()})
    emit("traj_vs_unfused_full_T_reported", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=8,
         max_abs_err={k: v[0] for k, v in gap_full.items()})

    t = {}
    n16 = n_t(16)
    t["launch_ms_16"] = time_ms(lambda: ct.traj_lanes(*args, eps_t, n16, CAP, CHAINS), reps=10)
    t["ms"] = t["launch_ms_16"] / 16
    one = tuple(a[:, :1].contiguous() for a in args)  # lane 0, series 0
    t["one_lane_ms"] = time_ms(lambda: ct.traj_lanes(*one, eps_t, n16, CAP, 1), reps=10) / 16
    t["plain_ms"] = time_ms(
        lambda: ct.traj_plain(*args, eps_t, n_t(2), CAP, CHAINS), reps=1, warmup=0
    ) / 2
    t["closure_ms_16"] = time_ms(lambda: traj(inv_mass, eps, 16, q, p, None, g0), reps=10)
    # a leapfrog across batch sizes, and ns a recursion step (2T steps a
    # leapfrog: the forward and the backward recursion)
    by_lanes = {}
    for n_lanes in TRAJ_TIMING_LANES:
        bx, bs = tayal_batch(max(n_lanes // CHAINS, 1), T_FIT, seed=SEED_DATA, device=device)
        cb = CHAINS if n_lanes >= CHAINS else 1
        lx, ls, lm = ct._data_lanes(bx, bs, None, device)
        la = tuple(torch.randn((ct.DIM, n_lanes), generator=gen, **f32) * s_
                   for s_ in (0.5, 0.7, 1.0))
        lim = torch.ones((ct.DIM, bx.shape[0]), **f32)
        ms = time_ms(lambda: ct.traj_lanes(*la, lim, lx, ls, lm, eps_t, n16, CAP, cb), reps=10) / 16
        by_lanes[n_lanes] = dict(ms=ms, ns_per_step=ms * 1e6 / (2 * T_FIT))
    t["by_lanes"] = by_lanes
    t["ns_per_step"] = t["ms"] * 1e6 / (2 * T_FIT)
    emit("traj_timing", shape=dict(B=N_SERIES, C=CHAINS, T=T_FIT), per="leapfrog", **t)
    b, o = traj_bytes_ops(T_FIT, N_SERIES, CHAINS, m_t, 16)
    bms, by = bound(b, o)
    err = max([v[0] for v in vs_plain.values()] + [max(c["max_abs_err"].values()) for c in odd])
    return dict(err=err, vs_unfused={k: v[0] for k, v in vs_unfused.items()},
                vs_f64={k: v[0] for k, v in vs_f64.items()},
                gap_full={k: v[0] for k, v in gap_full.items()}, timing=t,
                bound=(bms / 16, by), bytes=b, ops=o, odd_cases=len(odd))


def traj_odd_case(device, seed: int, B: int, T: int, C: int, n_steps: int):
    """``TRAJ`` against ``traj_plain`` in f32 within ``TRAJ_TOL`` on a
    simulated batch of ``B`` series x ``C`` chains, each series with a
    ragged tail and a masked head (lengths in [T/2, T], first [0, T/8]
    steps masked), random start states."""
    rng = np.random.default_rng(seed)
    x, sign = tayal_batch(B, T, seed=seed, device=device)
    valid = np.arange(T)[None] < rng.integers(max(T // 2, 1), T + 1, size=B)[:, None]
    valid &= np.arange(T)[None] >= rng.integers(0, T // 8 + 1, size=B)[:, None]
    f32 = dict(dtype=torch.float32, device=device)
    x_t, s_t, m_t = ct._data_lanes(x, sign, torch.as_tensor(valid, **f32), device)
    N = B * C
    lanes = [torch.as_tensor(sc * rng.normal(size=(ct.DIM, N)), **f32) for sc in (0.5, 0.7, 1.0)]
    im = torch.as_tensor(np.exp(0.3 * rng.normal(size=(ct.DIM, B))), **f32)
    eps = torch.tensor([0.02], **f32)
    n = torch.tensor([n_steps], dtype=torch.int32, device=device)
    got = ct.traj_lanes(*lanes, im, x_t, s_t, m_t, eps, n, CAP, C)
    want = ct.traj_plain(*lanes, im, x_t, s_t, m_t, eps, n, CAP, C)
    sync()
    e = state_errors(got, want)
    bad = {k: v for k, v in e.items() if v[1] > 0}
    if bad:
        raise AssertionError(f"trajectory B={B} T={T} C={C} n={n_steps} vs plain: {bad}")
    row = dict(B=B, T=T, C=C, n_steps=n_steps, masked_steps=int((m_t == 0).sum()),
               scratch_path=ct.traj_scratch_bytes(T, N) > 0,
               max_abs_err={k: v[0] for k, v in e.items()})
    emit("traj_vs_plain_odd", **row)
    return row


# ---------------------------------------------------------------------------
# phases 6-7: the ChEES main path, fused and unfused
# ---------------------------------------------------------------------------


class Counted:
    """A log density that counts its calls (``lp_bc`` / ``probe_vg``)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, q):
        self.calls += 1
        return self.fn(q)


class DivergenceRecorder:
    """A ``trajectory_fn`` wrapper that keeps the inputs of the first few
    lanes whose sampling-phase trajectory diverges (energy error above
    1000, or NaN, as the sampler judges it). Its outputs are the wrapped
    trajectory's, untouched."""

    def __init__(self, traj, warmup: int, keep: int = 3):
        self.traj, self.cap, self.warmup, self.keep = traj, traj.cap, warmup, keep
        self.calls, self.cases = 0, []

    def __call__(self, inv_mass, eps, n_steps, q, p, logp, grad):
        out = self.traj(inv_mass, eps, n_steps, q, p, logp, grad)
        if self.calls >= self.warmup and len(self.cases) < self.keep:
            k0 = 0.5 * (inv_mass[:, None, :] * p * p).sum(-1)
            k1 = 0.5 * (inv_mass[:, None, :] * out[1] * out[1]).sum(-1)
            d = (-out[2] + k1) - (-logp + k0)
            for b, c in ((d > 1000.0) | torch.isnan(d)).nonzero().tolist()[: self.keep - len(self.cases)]:
                self.cases.append(dict(
                    t=self.calls, b=b, c=c, eps=float(eps), n=int(n_steps), dH=float(d[b, c]),
                    q=q[b, c].cpu(), p=p[b, c].cpu(), grad=grad[b, c].cpu(),
                    inv_mass=inv_mass[b].cpu(), logp=float(logp[b, c]),
                ))
        self.calls += 1
        return out


def replay_divergence(case, x, sign):
    """Energy error of one recorded divergent trajectory on the CPU: the
    plain trajectory in float64, and the unfused log-space leapfrogs in
    float32 (the start energy uses the sampler's f32 logp)."""
    b, eps, n = case["b"], case["eps"], case["n"]
    data = {"x": x[b : b + 1].cpu(), "sign": sign[b : b + 1].cpu()}
    im, p0 = case["inv_mass"].double(), case["p"].double()
    h0 = -case["logp"] + float(0.5 * (im * p0 * p0).sum())
    x_t, s_t, m_t = ct._data_lanes(data["x"], data["sign"], None, torch.device("cpu"))
    lane = [case[k].double()[:, None] for k in ("q", "p", "grad")]
    _, p1, lp1, _ = ct.traj_plain(
        *lane, im[:, None], x_t, s_t, m_t.double(), torch.tensor([eps], dtype=torch.float64),
        torch.tensor([n]), CAP, 1,
    )
    dh64 = -float(lp1[0]) + float(0.5 * (im * p1[:, 0] ** 2).sum()) - h0
    lp_bc = make_lp_bc(TayalHHMM(), data, device="cpu")
    q, p, g = (case[k][None, None] for k in ("q", "p", "grad"))
    im32 = case["inv_mass"][None]
    for _ in range(n):
        ph = p + 0.5 * eps * g
        q = q + eps * im32[:, None, :] * ph
        lp, g = lp_bc(q)
        p = ph + 0.5 * eps * g
    dh_unfused = -float(lp) + float(0.5 * (case["inv_mass"] * p[0, 0] ** 2).sum()) - h0
    return dict(t=case["t"], series=b, chain=case["c"], eps=eps, n_steps=n,
                dH_fused_f32=case["dH"], dH_plain_f64=dh64, dH_unfused_f32=dh_unfused)


def run_chees(device, warmup, samples, fused, recorder=False, seed=SEED_SAMPLER):
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()  # stan gate, as bench.py --sampler chees
    init = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    cfg = ChEESConfig(num_warmup=warmup, num_samples=samples, num_chains=CHAINS,
                      max_leapfrogs=CAP)
    lp_bc = Counted(make_lp_bc(model, data, device=device))
    probe = Counted(model.make_vg({"x": x[0], "sign": sign[0]}))
    traj = ct.make_tayal_trajectory(data, cap=CAP, device=device) if fused else None
    if recorder:
        traj = DivergenceRecorder(traj, warmup)
    sync()
    before = {k.name: k.launches for k in ALL_KERNELS}
    t0 = time.perf_counter()
    qs, stats = sample_chees_batched(lp_bc, init, cfg, seed=seed, device=device,
                                     probe_vg=probe, trajectory_fn=traj)
    sync()
    wall = time.perf_counter() - t0
    rose = {k.name: k.launches - before[k.name] for k in ALL_KERNELS}
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError("chees: a chain was quarantined")
    if not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("chees: non-finite logp")
    vg_calls = lp_bc.calls + probe.calls
    if rose[cs.VG_BWD.name] != vg_calls or rose[cs.FWD.name] != vg_calls:
        raise AssertionError(f"chees: launches {rose} vs {vg_calls} value-and-grad calls")
    return model, qs, stats, wall, rose, lp_bc.calls, probe.calls, traj


def phase_chees(device, gibbs_phi):
    model, qs, stats, wall, rose, lp_calls, probe_calls, _ = run_chees(
        device, CHEES_WARMUP, CHEES_SAMPLES, fused=True
    )
    transitions = CHEES_WARMUP + CHEES_SAMPLES
    if rose[ct.TRAJ.name] != transitions:
        raise AssertionError(f"chees: {rose[ct.TRAJ.name]} trajectory launches, expected {transitions}")
    if tuple(qs.shape) != (N_SERIES, CHAINS, CHEES_SAMPLES, model.n_free):
        raise AssertionError(f"chees: qs shape {tuple(qs.shape)}")
    n_div = int(stats["diverging"].sum())
    div_share = n_div / stats["diverging"].numel()
    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= PHI_MAE_MAX:
        raise AssertionError(f"chees: posterior-mean phi MAE {mae.mean():.3g} > {PHI_MAE_MAX}")
    gap = np.minimum(
        np.abs(phi_mean - gibbs_phi).mean(axis=(1, 2)),
        np.abs(phi_mean[:, MIRROR] - gibbs_phi).mean(axis=(1, 2)),
    )
    leaves = torch.cat([stats["warmup_num_leaves"][0], stats["num_leaves"][0, 0]]).float()
    emit(
        "chees",
        series=N_SERIES, T=T_FIT, chains=CHAINS, warmup=CHEES_WARMUP, samples=CHEES_SAMPLES,
        cap=CAP, seconds=wall, transitions_per_s=transitions / wall,
        series_per_s=N_SERIES / wall, transition_ms=wall / transitions * 1e3,
        step_size=float(stats["step_size"][0, 0]), traj_length=float(stats["traj_length"][0, 0]),
        leapfrogs_mean=float(leaves.mean()), leapfrogs_total=int(leaves.sum()),
        leapfrogs_sampling=float(stats["num_leaves"][0, 0].float().mean()),
        accept_mean_sampling=float(stats["accept_prob"].mean()),
        divergent_sampling=n_div, divergent_share=div_share,
        divergent_chains=int(stats["diverging"].any(-1).sum()),
        divergent_warmup=int(stats["warmup_diverging"].sum()),
        launches=rose, lp_bc_calls=lp_calls, probe_calls=probe_calls,
        logp_mean=float(stats["logp"].mean()),
        ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
        mirror_fold_share=swap_share,
        phi_mae_mean=float(mae.mean()), phi_mae_max=float(mae.max()),
        phi_gap_vs_gibbs_mean=float(gap.mean()),
    )
    return qs, stats, phi_mean


def phase_chees_seeds(device, stats):
    """The fused fit at the other sampler seeds of ``CHEES_SEEDS`` (the
    main path's fit is the first): every chain healthy, the emission rows
    near the simulator's in each, and divergent sampling transitions at
    most ``DIV_SHARE_MAX`` of all, over the fits of every seed."""
    counts = {CHEES_SEEDS[0]: int(stats["diverging"].sum())}
    total = stats["diverging"].numel()
    maes = {}
    for seed in CHEES_SEEDS[1:]:
        model, qs, st, _, _, _, _, _ = run_chees(device, CHEES_WARMUP, CHEES_SAMPLES, fused=True,
                                                 seed=seed)
        counts[seed] = int(st["diverging"].sum())
        total += st["diverging"].numel()
        maes[seed] = float(fold_and_score(model, qs)[3].mean())
        if not maes[seed] <= PHI_MAE_MAX:
            raise AssertionError(f"chees seed {seed}: posterior-mean phi MAE {maes[seed]:.3g}")
    share = sum(counts.values()) / total
    emit("chees_seeds", seeds=list(CHEES_SEEDS), divergent_sampling=counts, divergent_share=share,
         phi_mae_mean=maes)
    if not share <= DIV_SHARE_MAX:
        raise AssertionError(f"chees: {counts} divergent transitions over seeds, share {share:.3g}")


def phase_chees_repeat(device, qs, stats):
    """The fused fit again: the draws must be bitwise the same (the
    sampler's randomness is one seeded generator and no step sums with
    atomics), and the first divergent trajectories of the sampling phase
    are replayed on the CPU, where each must be unstable in float64 too
    (energy error above ``REPLAY_DH_MIN``): a kernel fault would diverge
    in f32 alone."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    _, qs2, stats2, _, _, _, _, rec = run_chees(
        device, CHEES_WARMUP, CHEES_SAMPLES, fused=True, recorder=True
    )
    if not (torch.equal(qs, qs2) and torch.equal(stats["diverging"], stats2["diverging"])):
        raise AssertionError("chees: a repeated fit gave other draws")
    replays = [replay_divergence(c, x, sign) for c in rec.cases]
    for r in replays:
        if not r["dH_plain_f64"] > REPLAY_DH_MIN:
            raise AssertionError(f"chees: a divergence not unstable in float64: {r}")
    emit("chees_repeat", bitwise_equal=True, divergences_replayed=replays)


def phase_chees_unfused(device):
    _, _, stats, wall, rose, lp_calls, probe_calls, _ = run_chees(
        device, UNFUSED_WARMUP, UNFUSED_SAMPLES, fused=False
    )
    leapfrogs = int(stats["warmup_num_leaves"][0].sum()) + int(stats["num_leaves"][0, 0].sum())
    if lp_calls != 1 + leapfrogs:
        raise AssertionError(f"chees_unfused: {lp_calls} lp_bc calls for {leapfrogs} leapfrogs")
    if rose[ct.TRAJ.name] != 0:
        raise AssertionError("chees_unfused: the trajectory kernel ran")
    transitions = UNFUSED_WARMUP + UNFUSED_SAMPLES
    emit(
        "chees_unfused", series=N_SERIES, T=T_FIT, chains=CHAINS, warmup=UNFUSED_WARMUP,
        samples=UNFUSED_SAMPLES, seconds=wall, transitions_per_s=transitions / wall,
        leapfrogs=leapfrogs, leapfrog_ms=wall / max(leapfrogs, 1) * 1e3,
        divergent_sampling=int(stats["diverging"].sum()),
        launches=rose, lp_bc_calls=lp_calls, probe_calls=probe_calls,
    )
    return rose


# ---------------------------------------------------------------------------
# phase 3 (cont.): the decode kernels
# ---------------------------------------------------------------------------


DECODE_KERNELS = (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK)


def make_decode_case(seed: int, N: int, T: int, K: int, device, finite: bool):
    """Lane-layout ``(pi, A, obs, mask)`` for the decode kernels:
    normalized (pi, A) with about a fifth of the A entries at
    ``MASK_NEG``, N(-1, 1) emissions, ragged mask (lengths in [T/2,
    T]). Every seventh lane is a tie lane (uniform pi and A, emissions
    rounded to integers) where the max-plus scores tie exactly. Unless
    ``finite``, a few lanes get an all -inf evidence row at a valid
    step."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    log_pi = log_norm(rng.normal(size=(N, K)))
    log_A = log_norm(rng.normal(size=(N, K, K)))
    log_A[rng.random((N, K, K)) < 0.2] = MASK_NEG
    log_obs = rng.normal(size=(N, T, K)) - 1.0
    ties = np.arange(N) % 7 == 0
    log_pi[ties] = -np.log(K)
    log_A[ties] = -np.log(K)
    log_obs[ties] = np.round(log_obs[ties])
    lengths = rng.integers(T // 2, T + 1, size=N)
    if not finite:
        for n in rng.choice(N, size=8, replace=False):
            log_obs[n, rng.integers(0, lengths[n])] = -np.inf
    f32 = dict(dtype=torch.float32, device=device)
    mask = np.arange(T)[None, :] < lengths[:, None]
    lanes = cs.to_lanes(*(torch.as_tensor(a, **f32) for a in (log_pi, log_A, log_obs, mask)))
    return lanes[:4]


def decode_bytes_ops(kernel, lanes):
    """Bytes (inputs read once, outputs written once) and f32 operations
    (of the valid steps) of one decode kernel on these lanes; the maps
    and the path are int32."""
    pi_t, A_t, obs_t, mask_t = lanes
    T, K, N = obs_t.shape
    name = {cs.FILTER: "FILTER", cs.BETA: "BETA", cs.VITERBI: "VITERBI",
            cs.BACKTRACK: "BACKTRACK"}[kernel]
    c = kernel_cost(name, K, T, N, valid_steps=_steps(mask_t))
    return c["bytes_accessed"], c["flops"]


def phase_kernels_decode(device):
    """``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK`` against their
    plain versions at N=8192, T=1024, K in {3, 4, 8}, and at N=256,
    T=``EXTRA_T`` at every other K in 2..32: bitwise equal (log-values, -inf at the same
    places, no NaN; maps, paths and scores identical), and ``FILTER``
    bitwise equal to ``FWD`` on finite inputs; then each timed at the
    main shape (K=4, dense mask)."""
    cases = []
    grid = [(N_DEC, T_FIT, K) for K in (3, 4, 8)]
    grid += [(EXTRA_DECODE_LANES, EXTRA_T, K) for K in range(2, 33) if K not in (3, 4, 8)]
    for i, (N, T, K) in enumerate(grid):
        for finite in (True, False):
            lanes = make_decode_case(5000 + 2 * i + finite, N, T, K, device, finite)
            pi_t, A_t, obs_t, mask_t = lanes
            ll_k, a_k = cs.filter_lanes(*lanes)
            b_k = cs.beta_lanes(A_t, obs_t, mask_t)
            sc_k, dl_k, bk_k = cs.viterbi_lanes(*lanes)
            path_k = cs.backtrack_lanes(bk_k, dl_k)
            ll_p, a_p = cs.filter_plain(*lanes)
            b_p = cs.beta_plain(A_t, obs_t, mask_t)
            sc_p, dl_p, bk_p = cs.viterbi_plain(*lanes)
            path_p = cs.backtrack_plain(bk_p, dl_p)
            # the backtrack alone, on the kernel's maps (the same path when
            # the maps are equal, which the viterbi check below holds)
            same_maps = torch.equal(bk_k, bk_p) and torch.equal(dl_k, dl_p)
            path_kp = path_p if same_maps else cs.backtrack_plain(bk_k, dl_k)
            sync()
            got = {"filter": (a_k, ll_k), "beta": (b_k,), "viterbi": (sc_k, dl_k, bk_k),
                   "backtrack": (path_k,)}
            want = {"filter": (a_p, ll_p), "beta": (b_p,), "viterbi": (sc_p, dl_p, bk_p),
                    "backtrack": (path_kp,)}
            bad = [k for k in got if not all(torch.equal(a, b) for a, b in zip(got[k], want[k]))]
            nan = [k for k in ("filter", "beta") if bool(torch.isnan(got[k][0]).any())]
            if bad or nan or not torch.equal(path_k, path_p):
                raise AssertionError(
                    f"decode kernels K={K} finite={finite}: not identical to the plain "
                    f"versions {bad}, NaN in {nan}"
                )
            row = dict(N=N, K=K, finite=finite, neg_inf_alpha=int(torch.isinf(a_k).sum()),
                       neg_inf_beta=int(torch.isinf(b_k).sum()),
                       masked_steps=int((mask_t == 0).sum()))
            if finite:
                ll_f, a_f = cs.fwd_lanes(*lanes)
                sync()
                if not (torch.equal(a_f, a_k) and torch.equal(ll_f, ll_k)):
                    raise AssertionError(f"FILTER K={K}: alpha differs from FWD on finite inputs")
                row["filter_equals_fwd"] = True
            cases.append(row)
            emit("decode_kernels_vs_plain", T=T, bitwise_equal=True, **row)
            del lanes, pi_t, A_t, obs_t, mask_t, a_k, a_p, b_k, b_p, got, want

    # timing at the main shape: N=8192 lanes, T=1024, K=4, dense mask
    rng = np.random.default_rng(6000)
    f32 = dict(dtype=torch.float32, device=device)
    log_A = rng.normal(size=(N_DEC, K_TAYAL, K_TAYAL))
    log_A -= np.log(np.exp(log_A).sum(-1, keepdims=True))
    lanes = cs.to_lanes(
        torch.as_tensor(np.full((N_DEC, K_TAYAL), -np.log(K_TAYAL)), **f32),
        torch.as_tensor(log_A, **f32),
        torch.as_tensor(rng.normal(size=(N_DEC, T_FIT, K_TAYAL)) - 1.0, **f32),
        torch.ones((N_DEC, T_FIT), **f32),
    )[:4]
    pi_t, A_t, obs_t, mask_t = lanes
    _, dl, bk = cs.viterbi_lanes(*lanes)
    one = tuple(v[..., :1].contiguous() for v in lanes)
    _, dl1, bk1 = cs.viterbi_lanes(*one)
    calls = {
        cs.FILTER: (lambda L: cs.filter_lanes(*L), cs.filter_plain),
        cs.BETA: (lambda L: cs.beta_lanes(*L[1:]), lambda *L: cs.beta_plain(*L[1:])),
        cs.VITERBI: (lambda L: cs.viterbi_lanes(*L), cs.viterbi_plain),
    }
    timing = {}
    for k, (run, plain) in calls.items():
        timing[k.name] = dict(
            ms=time_ms(lambda: run(lanes), reps=20),
            one_lane_ms=time_ms(lambda: run(one), reps=20),
            plain_ms=time_ms(lambda: plain(*lanes), reps=2, warmup=1),
        )
    timing[cs.BACKTRACK.name] = dict(
        ms=time_ms(lambda: cs.backtrack_lanes(bk, dl), reps=20),
        one_lane_ms=time_ms(lambda: cs.backtrack_lanes(bk1, dl1), reps=20),
        plain_ms=time_ms(lambda: cs.backtrack_plain(bk, dl), reps=2, warmup=1),
    )
    for k in DECODE_KERNELS:
        b, o = decode_bytes_ops(k, lanes)
        timing[k.name].update(bytes=b, ops=o, bound=bound(b, o))
    emit("decode_kernel_timing", shape=dict(N=N_DEC, T=T_FIT, K=K_TAYAL),
         **{k: {f: v for f, v in t.items() if f != "bound"} for k, t in timing.items()})
    return dict(cases=cases, timing=timing)


# ---------------------------------------------------------------------------
# main path 3: the zoo's generated quantities
# ---------------------------------------------------------------------------


def launch_counts():
    return {k.name: k.launches for k in ALL_KERNELS}


def rose_since(before):
    return {n: v - before[n] for n, v in launch_counts().items() if v != before[n]}


def thin(q, n):
    """``[B, S, D]`` draws → ``n`` evenly spaced draws per series."""
    idx = torch.as_tensor(np.linspace(0, q.shape[1] - 1, n).astype(np.int64), device=q.device)
    return q[:, idx]


def check_probabilities(name, out, key):
    """Finite rows summing to 1: ``alpha`` (a softmax) within
    ``PROB_ATOL``, ``gamma`` within ``GAMMA_SUM_TOL``. Returns the
    largest deviation."""
    p = out[key]
    dev = float((p.sum(-1) - 1).abs().max())
    tol = GAMMA_SUM_TOL if key == "gamma" else PROB_ATOL
    if not bool(torch.isfinite(p).all()) or dev > tol:
        raise AssertionError(
            f"{name}: {key} rows are not probability vectors (off by {dev:.3g}, tol {tol})"
        )
    return dev


def check_decode_once(name, rose):
    """Each decode kernel launched exactly once by one ``generated``."""
    if any(rose.get(k.name, 0) != 1 for k in DECODE_KERNELS):
        raise AssertionError(f"{name}: generated launched {rose}, expected each decode kernel once")


def allocator_growth(before):
    """Device memory segments the caching allocator took from the device
    (``cudaMalloc``) since the ``torch.cuda.memory_stats()`` snapshot
    ``before``, and the bytes they added to its reserve."""
    now = torch.cuda.memory_stats()
    key, res = "segment.all.allocated", "reserved_bytes.all.allocated"
    return {"segments": now.get(key, 0) - before.get(key, 0),
            "bytes": now.get(res, 0) - before.get(res, 0)}


def generated_split(model, draws, data, device, want):
    """One warm ``model.generated``, its stages timed with a CUDA event
    (device clock) and the host clock at each boundary, taken by
    wrapping the functions the call reaches: ``smooth_dispatch`` and
    ``viterbi_dispatch`` as ``models/base.py`` calls them, ``to_lanes``
    as ``smooth_dispatch`` and ``semiring_viterbi`` call it, and the four
    kernel wrappers. Stages: unpack + ``build`` (up to
    ``smooth_dispatch``), the lane-layout copies, the four decode
    kernels, the rest of the two dispatches (the smoothing, the path's
    transpose) and the outputs (after ``viterbi_dispatch``). Each
    wrapped function must be called as often as the path calls it, and
    the outputs must equal ``want`` (the cold call's) bit for bit, so the
    stages are the path's own."""
    marks = []  # (stage entered, event, host time)

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev, time.perf_counter()))

    def timed(fn, stage):
        def run(*args, **kwargs):
            outer = marks[-1][0]
            mark(stage)
            out = fn(*args, **kwargs)
            mark(outer)
            return out
        return run

    wraps = [(zoo_base, "smooth_dispatch", "dispatch"), (zoo_base, "viterbi_dispatch", "dispatch"),
             (td, "to_lanes", "lane_copies"), (cs, "to_lanes", "lane_copies"),
             (td, "filter_lanes", "decode_kernels"), (td, "beta_lanes", "decode_kernels"),
             (cs, "viterbi_lanes", "decode_kernels"), (cs, "backtrack_lanes", "decode_kernels")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wraps]
    sync()
    mem = torch.cuda.memory_stats()
    try:
        for mod, name, stage in wraps:
            setattr(mod, name, timed(getattr(mod, name), stage))
        mark("generated")
        out = model.generated(draws, data, device=device)
        mark("end")
        sync()
        end = time.perf_counter()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    entered = [st for st, _, _ in marks]
    # the path: unpack + build, then smooth_dispatch (a copy, FILTER, BETA),
    # then viterbi_dispatch (a copy in semiring_viterbi, VITERBI, BACKTRACK)
    one_dispatch = ["dispatch", "lane_copies", "dispatch", "decode_kernels", "dispatch",
                    "decode_kernels", "dispatch", "generated"]
    if entered != ["generated", *one_dispatch, *one_dispatch, "end"]:
        raise AssertionError(f"generated_split: the call took {entered}, not the split's path")
    if not all(torch.equal(out[k], want[k]) for k in want):
        raise AssertionError("generated_split: the timed call differs from the cold one")
    device_ms, host_ms = {}, {}
    for i, ((stage, ev, h), (_, ev2, h2)) in enumerate(zip(marks, marks[1:])):
        # in generated itself: unpack + build before the dispatches, the
        # outputs after them (and the nothing between them)
        if stage == "generated":
            stage = "unpack_build" if i == 0 else "outputs"
        device_ms[stage] = device_ms.get(stage, 0.0) + ev.elapsed_time(ev2)
        host_ms[stage] = host_ms.get(stage, 0.0) + (h2 - h) * 1e3
    return dict(device_ms=device_ms, host_enqueue_ms=host_ms,
                total_ms=(end - marks[0][2]) * 1e3,
                device_total_ms=marks[0][1].elapsed_time(marks[-1][1]),
                allocator_growth=allocator_growth(mem))


def phase_decode_smooth(device, qs):
    """``TayalHHMM(gate_mode="hard").generated`` on 32 thinned Gibbs
    draws x 256 series (8192 lanes, T=1024): shapes, probability rows,
    states in range, each decode kernel launched once, and every output
    against the plain versions on the same lanes."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    hard = TayalHHMM(gate_mode="hard")
    draws = thin(qs[:, 0], N_DECODE_DRAWS)  # [B, 32, D]
    before = launch_counts()
    sync()
    mem = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    out = hard.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    cold_alloc = allocator_growth(mem)
    rose = rose_since(before)
    check_decode_once("decode_smooth", rose)
    B, D, T = N_SERIES, N_DECODE_DRAWS, T_FIT
    shapes = {"alpha": (B, D, T, 4), "gamma": (B, D, T, 4), "zstar": (B, D, T),
              "logp_zstar": (B, D), "loglik": (B, D)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            raise AssertionError(f"decode_smooth: {k} shape {tuple(out[k].shape)} != {shp}")
    row_dev = {k: check_probabilities("decode_smooth", out, k) for k in ("alpha", "gamma")}
    if not bool(((out["zstar"] >= 0) & (out["zstar"] < 4)).all()):
        raise AssertionError("decode_smooth: zstar out of range")

    # the plain versions on the same lanes
    params, _ = hard.unpack(draws.reshape(N_DEC, -1))
    lanes = {k: v.repeat_interleave(D, 0) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = hard.build(params, lanes)
    ones = torch.ones((N_DEC, T), dtype=torch.float32, device=device)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A, log_obs, ones)
    ll_p, a_p = cs.filter_plain(pi_t, A_t, obs_t, mask_t)
    b_p = cs.beta_plain(A_t, obs_t, mask_t)
    sc_p, dl_p, bk_p = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    path_p = cs.backtrack_plain(bk_p, dl_p)
    la_p, lb_p = a_p.permute(2, 0, 1), b_p.permute(2, 0, 1)
    ref = {
        "alpha": torch.softmax(la_p, dim=-1),
        "gamma": torch.exp(smooth(la_p, lb_p)),
    }
    errs = {k: float((out[k].reshape(ref[k].shape) - v).abs().max()) for k, v in ref.items()}
    same = {
        "zstar": torch.equal(out["zstar"].reshape(N_DEC, T), path_p.t().long()),
        "logp_zstar": torch.equal(out["logp_zstar"].reshape(-1), sc_p),
        "loglik": torch.equal(out["loglik"].reshape(-1), ll_p),
    }
    if max(errs.values()) > PROB_ATOL or not all(same.values()):
        raise AssertionError(f"decode_smooth: kernels vs plain {errs}, identical {same}")
    emit("decode_smooth", lanes=N_DEC, T=T, K=4, seconds=wall, launches=rose,
         max_abs_err_vs_plain=errs, identical_vs_plain=same, row_sum_max_dev=row_dev,
         loglik_mean=float(out["loglik"].mean()))
    # the same call again, warm, stage by stage, alone on the card
    with quiet():
        split = generated_split(hard, draws, data, device, out)
    emit("generated_split", lanes=N_DEC, T=T, K=4, cold_seconds=wall,
         cold_allocator_growth=cold_alloc, **split)
    return dict(out=out, data=data, lanes=(log_pi, log_A, log_obs, ones))


def check_loglik_vs_fwd(dec):
    """The decode's loglik against the ``FWD`` kernel's on the same
    (finite) lanes: the guarded and the clamped filter agree bit for bit
    there. Run after the main path's counts are read."""
    _, ll_f = cs.forward_chunked(*dec["lanes"])
    sync()
    if not torch.equal(dec["out"]["loglik"].reshape(-1), ll_f):
        raise AssertionError("decode_smooth: loglik differs from FWD's")
    emit("decode_loglik_vs_fwd", lanes=N_DEC, identical=True)


def fold_pairs(p_bull, anchor):
    """Fold the pair swap (p -> 1 - p) per draw toward a per-series
    anchor path, as ``bench.py``'s ``top_state_mean`` does:
    ``p_bull [B, D, T]``, ``anchor [B, T]``."""
    d_id = ((p_bull - anchor[:, None]) ** 2).sum(-1)
    d_sw = ((1.0 - p_bull - anchor[:, None]) ** 2).sum(-1)
    return torch.where((d_sw < d_id)[..., None], 1.0 - p_bull, p_bull)


def phase_agreement(device, dec, chees_qs):
    """The ChEES draws through the same hard-gate ``generated`` (32 a
    series from the pooled chains): posterior-mean smoothed bull-pair
    probability per series, folded against the Gibbs decode's first
    draw, compared with the Gibbs one; and the Gibbs split-half floor.
    Reported, not gated: 300 draws cannot meet ``bench.py``'s absolute
    gate."""
    B = N_SERIES
    draws = thin(chees_qs.reshape(B, -1, chees_qs.shape[-1]), N_DECODE_DRAWS)
    hard = TayalHHMM(gate_mode="hard")
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    out = hard.generated(draws, dec["data"], device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    check_decode_once("agreement", rose)
    row_dev = check_probabilities("agreement", out, "gamma")
    g_gibbs, g_chees = dec["out"]["gamma"], out["gamma"]
    p_gibbs = g_gibbs[..., 2] + g_gibbs[..., 3]  # [B, D, T]
    p_chees = g_chees[..., 2] + g_chees[..., 3]
    anchor = p_gibbs[:, 0]
    f_gibbs, f_chees = fold_pairs(p_gibbs, anchor), fold_pairs(p_chees, anchor)
    gap = (f_gibbs.mean(1) - f_chees.mean(1)).abs().mean(-1)  # [B]
    floor = (f_gibbs[:, 0::2].mean(1) - f_gibbs[:, 1::2].mean(1)).abs().mean(-1)
    emit("agreement", series=B, draws_per_series=N_DECODE_DRAWS, T=T_FIT, seconds=wall,
         launches=rose, gamma_row_sum_max_dev=row_dev,
         gap_mean=float(gap.mean()), gap_worst_series=float(gap.max()),
         gibbs_split_half_floor_mean=float(floor.mean()),
         gibbs_split_half_floor_worst=float(floor.max()),
         chees_fold_share=float((f_chees != p_chees).any(-1).float().mean()))


def phase_gaussian(device):
    """The Gaussian HMM of ``hmm/main.R`` at ``bench_zoo.py::bench_hmm``'s
    Gibbs configuration, batched to 256 series: the fit (FFBS kernels
    at K=3, once a sweep), posterior-mean mu near the truth, then
    ``generated`` (each decode kernel once; Viterbi accuracy > 0.9) and
    ``state_draws`` (FWD and BWD_SAMPLE once each)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS)
    z_true, x = hmm_sim(gen, G_T, G_A, np.ones(G_K) / G_K, obsmodel_gaussian(G_MU, G_SIGMA),
                        batch=(N_SERIES,))
    data = {"x": x}
    model = GaussianHMM(K=G_K, nig_prior=NIGPrior(**G_PRIOR))
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=G_WARMUP, num_samples=G_SAMPLES, num_chains=1)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    sweeps = G_WARMUP + G_SAMPLES
    if rose != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
        raise AssertionError(f"gaussian: fit launches {rose}, expected {sweeps} FWD and BWD_SAMPLE")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("gaussian: an unhealthy chain or a non-finite logp")
    mu_hat = model.constrained_draws(qs)["mu_k"].mean(2)[:, 0]  # [B, K]
    mu_err = (mu_hat - torch.tensor(G_MU, device=device)).abs().max(-1).values
    if not float(mu_err.mean()) <= G_MU_TOL:
        raise AssertionError(f"gaussian: posterior-mean mu off by {float(mu_err.mean()):.3g}")

    draws = thin(qs[:, 0], N_DECODE_DRAWS)
    before = launch_counts()
    sync()
    t1 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    gen_wall = time.perf_counter() - t1
    rose_gen = rose_since(before)
    check_decode_once("gaussian", rose_gen)
    row_dev = check_probabilities("gaussian", out, "gamma")
    acc = (out["zstar"] == z_true[:, None]).float().mean(-1)  # [B, D]
    if not float(acc.mean()) > G_ACC_MIN:
        raise AssertionError(f"gaussian: Viterbi accuracy {float(acc.mean()):.4g}")

    before = launch_counts()
    gen_z = torch.Generator(device=device)
    gen_z.manual_seed(SEED_GAUSS + 1)
    sync()
    t2 = time.perf_counter()
    z_draws = model.state_draws(gen_z, draws, data, device=device)
    sync()
    sd_wall = time.perf_counter() - t2
    rose_sd = rose_since(before)
    if rose_sd != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
        raise AssertionError(f"gaussian: state_draws launched {rose_sd}")
    sd_acc = (z_draws == z_true[:, None]).float().mean()
    emit("gaussian", series=N_SERIES, T=G_T, K=G_K, warmup=G_WARMUP, samples=G_SAMPLES,
         fit_seconds=wall, sweeps_per_s=sweeps / wall, fit_launches=rose,
         mu_abs_err_mean=float(mu_err.mean()), mu_abs_err_worst=float(mu_err.max()),
         mu_hat_mean=mu_hat.mean(0).tolist(), logp_mean=float(stats["logp"].mean()),
         generated_seconds=gen_wall, generated_launches=rose_gen, gamma_row_sum_max_dev=row_dev,
         viterbi_accuracy_mean=float(acc.mean()),
         viterbi_accuracy_worst_series=float(acc.mean(-1).min()),
         state_draws_seconds=sd_wall, state_draws_launches=rose_sd,
         state_draws_accuracy_mean=float(sd_acc))


def check_zoo_vs_plain(name, model, draws, data, out, z_draws=None, seed=None):
    """``generated`` and ``state_draws`` of ``model`` on ``draws [B, D,
    n_free]`` against the plain versions on the same lanes (dense mask):
    alpha and gamma within ``PROB_ATOL``, the Viterbi path, its score and
    the loglik identical, and the state draws (if given) identical given
    the uniforms ``state_draws`` took from a generator seeded ``seed``."""
    B, D = draws.shape[:2]
    params, _ = model.unpack(draws.reshape(B * D, -1))
    lanes = {k: v.repeat_interleave(D, 0) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = model.build(params, lanes)
    N, T, _ = log_obs.shape
    ones = torch.ones((N, T), dtype=torch.float32, device=log_obs.device)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A, log_obs, ones)
    ll_p, a_p = cs.filter_plain(pi_t, A_t, obs_t, mask_t)
    b_p = cs.beta_plain(A_t, obs_t, mask_t)
    sc_p, dl_p, bk_p = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    path_p = cs.backtrack_plain(bk_p, dl_p)
    la_p, lb_p = a_p.permute(2, 0, 1), b_p.permute(2, 0, 1)
    ref = {"alpha": torch.softmax(la_p, dim=-1), "gamma": torch.exp(smooth(la_p, lb_p))}
    errs = {k: float((out[k].reshape(ref[k].shape) - v).abs().max()) for k, v in ref.items()}
    same = {
        "zstar": torch.equal(out["zstar"].reshape(N, T), path_p.t().long()),
        "logp_zstar": torch.equal(out["logp_zstar"].reshape(-1), sc_p),
        "loglik": torch.equal(out["loglik"].reshape(-1), ll_p),
    }
    if z_draws is not None:
        gen = torch.Generator(device=log_obs.device)
        gen.manual_seed(seed)
        u = torch.rand((N, T), generator=gen, dtype=torch.float32, device=log_obs.device)
        _, A_c, _, _, _, _ = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, ones)
        _, alpha_p = cs.fwd_plain(pi_t, A_c, obs_t, mask_t)
        z_p = cs.bwd_sample_plain(A_c, mask_t, alpha_p, u.t().contiguous())
        same["state_draws"] = torch.equal(z_draws.reshape(N, T), z_p.t().long())
    if max(errs.values()) > PROB_ATOL or not all(same.values()):
        raise AssertionError(f"{name}: kernels vs plain {errs}, identical {same}")
    return errs, same


def phase_gaussian_k(device):
    """The Gaussian HMM at each K of ``GK_KS`` (256 simulated series,
    T=500, sticky A, means 1.5 apart): a short Gibbs fit (each FFBS kernel
    once a sweep, every chain healthy), ``generated`` on ``GK_DRAWS``
    draws a series (each decode kernel once) and ``state_draws`` (``FWD``
    and ``BWD_SAMPLE`` once), every output against the plain versions on
    the same lanes."""
    for K in GK_KS:
        A = np.full((K, K), (1 - GK_STAY) / (K - 1))
        np.fill_diagonal(A, GK_STAY)
        mu = (1.5 * (np.arange(K) - (K - 1) / 2)).tolist()
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED_GAUSS + K)
        z_true, x = hmm_sim(gen, G_T, A.tolist(), np.ones(K) / K,
                            obsmodel_gaussian(mu, [GK_SIGMA] * K), batch=(N_SERIES,))
        data = {"x": x}
        model = GaussianHMM(K=K, nig_prior=NIGPrior(**G_PRIOR))
        init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
        cfg = GibbsConfig(num_warmup=GK_WARMUP, num_samples=GK_SAMPLES, num_chains=1)
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
        sync()
        wall = time.perf_counter() - t0
        rose = rose_since(before)
        sweeps = GK_WARMUP + GK_SAMPLES
        if rose != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
            raise AssertionError(f"gaussian_k K={K}: fit launches {rose}, expected {sweeps} "
                                 "FWD and BWD_SAMPLE")
        if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
            raise AssertionError(f"gaussian_k K={K}: an unhealthy chain or a non-finite logp")

        draws = thin(qs[:, 0], GK_DRAWS)
        before = launch_counts()
        sync()
        t1 = time.perf_counter()
        out = model.generated(draws, data, device=device)
        sync()
        gen_wall = time.perf_counter() - t1
        rose_gen = rose_since(before)
        check_decode_once(f"gaussian_k K={K}", rose_gen)
        row_dev = {k: check_probabilities(f"gaussian_k K={K}", out, k) for k in ("alpha", "gamma")}
        if not bool(((out["zstar"] >= 0) & (out["zstar"] < K)).all()):
            raise AssertionError(f"gaussian_k K={K}: zstar out of range")
        before = launch_counts()
        gen_z = torch.Generator(device=device)
        gen_z.manual_seed(SEED_GAUSS + 100 + K)
        z_draws = model.state_draws(gen_z, draws, data, device=device)
        sync()
        rose_sd = rose_since(before)
        if rose_sd != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
            raise AssertionError(f"gaussian_k K={K}: state_draws launched {rose_sd}")
        errs, same = check_zoo_vs_plain(f"gaussian_k K={K}", model, draws, data, out, z_draws,
                                        SEED_GAUSS + 100 + K)
        acc = (out["zstar"] == z_true[:, None]).float().mean()
        emit("gaussian_k", series=N_SERIES, T=G_T, K=K, warmup=GK_WARMUP, samples=GK_SAMPLES,
             fit_seconds=wall, sweeps_per_s=sweeps / wall, fit_launches=rose,
             generated_seconds=gen_wall, generated_launches=rose_gen,
             state_draws_launches=rose_sd, row_sum_max_dev=row_dev,
             max_abs_err_vs_plain=errs, identical_vs_plain=same,
             viterbi_accuracy_mean=float(acc))


def phase_decode_wide(device):
    """``GaussianHMM(K=20).generated`` on 32 simulated series x 8 draws
    (the true parameters plus noise from a seed: 256 lanes, T=500): a
    warp a lane and byte-wide Viterbi maps (K above 16). Each decode
    kernel launched once, every output against the plain versions on the
    same lanes (``check_zoo_vs_plain``), and against the same call on the
    CPU within ``WIDE_*``."""
    K, S, D = K_WIDE, K_WIDE_SERIES, K_WIDE_DRAWS
    A = np.full((K, K), (1 - GK_STAY) / (K - 1))
    np.fill_diagonal(A, GK_STAY)
    mu = 1.5 * (np.arange(K) - (K - 1) / 2)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS + K)
    z_true, x = hmm_sim(gen, G_T, A.tolist(), np.ones(K) / K,
                        obsmodel_gaussian(mu.tolist(), [GK_SIGMA] * K), batch=(S,))
    model = GaussianHMM(K=K, nig_prior=NIGPrior(**G_PRIOR))
    f32 = dict(dtype=torch.float32, device=device)
    truth = {"p_1k": torch.full((K,), 1.0 / K, **f32), "A_ij": torch.as_tensor(A, **f32),
             "mu_k": torch.as_tensor(mu, **f32), "sigma_k": torch.full((K,), GK_SIGMA, **f32)}
    rng = np.random.default_rng(SEED_GAUSS + K)
    noise = torch.as_tensor(0.05 * rng.normal(size=(S, D, model.n_free)), **f32)
    draws = model.pack(truth) + noise
    data = {"x": x}
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    check_decode_once(f"decode_wide K={K}", rose)
    errs_plain, same = check_zoo_vs_plain(f"decode_wide K={K}", model, draws, data, out)
    ref = model.generated(draws.cpu(), {"x": x.cpu()}, device="cpu")
    errs = {k: float((out[k].cpu() - ref[k]).abs().max()) for k in ("alpha", "gamma")}
    ll_rel = float(((out["loglik"].cpu() - ref["loglik"]) / ref["loglik"]).abs().max())
    lp_rel = float(((out["logp_zstar"].cpu() - ref["logp_zstar"]) / ref["logp_zstar"]).abs().max())
    path_mismatch = float((out["zstar"].cpu() != ref["zstar"]).float().mean())
    finite = all(bool(torch.isfinite(out[k]).all()) for k in ("alpha", "gamma", "loglik"))
    if (not finite or max(errs.values()) > WIDE_PROB_ATOL or max(ll_rel, lp_rel) > WIDE_LL_RTOL
            or path_mismatch > WIDE_PATH_MISMATCH_MAX):
        raise AssertionError(f"decode_wide: card vs CPU {errs}, loglik {ll_rel:.3g}, logp_zstar "
                             f"{lp_rel:.3g}, path mismatch {path_mismatch:.3g}, finite {finite}")
    acc = (out["zstar"] == z_true[:, None]).float().mean()
    emit("decode_wide", series=S, draws_per_series=D, lanes=S * D, T=G_T, K=K, seconds=wall,
         launches=rose, max_abs_err_vs_plain=errs_plain, identical_vs_plain=same,
         max_abs_err_vs_cpu=errs, loglik_max_rel_err_vs_cpu=ll_rel,
         logp_zstar_max_rel_err_vs_cpu=lp_rel, zstar_mismatch_share_vs_cpu=path_mismatch,
         row_sum_max_dev=check_probabilities("decode_wide", out, "gamma"),
         viterbi_accuracy_mean=float(acc))


def phase_kernels_wide(device):
    """Every semiring kernel bitwise equal to its plain version at each K
    of ``WIDE_KS`` and (N, T) of ``WIDE_SHAPES``: ``FWD``, ``BWD_SAMPLE``
    and ``VG_BWD`` ungated and gated, ragged masks with masked runs at
    both ends; ``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK`` on
    ``MASK_NEG``-sparse A with tie lanes, with and without all -inf
    evidence rows (``make_decode_case``). Then each kernel timed at K=64
    on the zoo_wide lanes' shape (N=256, T=500)."""
    cases = []
    for i, K in enumerate(WIDE_KS):
        for j, (N, T) in enumerate(WIDE_SHAPES):
            for gated in (False, True):
                lanes, u_t = make_case(7000 + 8 * i + 2 * j + gated, N, T, K, gated, device,
                                       both_ends=True)
                pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
                ll_k, a_k = cs.fwd_lanes(*lanes)
                z_k = cs.bwd_sample_lanes(A_t, mask_t, a_k, u_t, gate_t, sk_t)
                vg_k = cs.vg_bwd_lanes(A_t, obs_t, mask_t, a_k, ll_k, gate_t, sk_t)
                ll_p, a_p = cs.fwd_plain(*lanes)
                z_p = cs.bwd_sample_plain(A_t, mask_t, a_p, u_t, gate_t, sk_t)
                vg_p = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p, gate_t, sk_t)
                sync()
                same = {cs.FWD.name: torch.equal(a_k, a_p) and torch.equal(ll_k, ll_p),
                        cs.BWD_SAMPLE.name: torch.equal(z_k, z_p),
                        cs.VG_BWD.name: all(torch.equal(g, w) for g, w in zip(vg_k, vg_p))}
                if not all(same.values()):
                    raise AssertionError(f"wide K={K} N={N} T={T} gated={gated}: not bitwise "
                                         f"equal to the plain versions {same}, "
                                         f"{int((z_k != z_p).sum())} draws differ")
                cases.append(dict(K=K, N=N, T=T, gated=gated, kernels=list(same)))
            for finite in (True, False):
                lanes = make_decode_case(7500 + 8 * i + 2 * j + finite, N, T, K, device, finite)
                pi_t, A_t, obs_t, mask_t = lanes
                vit = cs.VITERBI.name
                got = {cs.FILTER.name: cs.filter_lanes(*lanes),
                       cs.BETA.name: (cs.beta_lanes(A_t, obs_t, mask_t),),
                       vit: cs.viterbi_lanes(*lanes)}
                got[cs.BACKTRACK.name] = (cs.backtrack_lanes(got[vit][2], got[vit][1]),)
                want = {cs.FILTER.name: cs.filter_plain(*lanes),
                        cs.BETA.name: (cs.beta_plain(A_t, obs_t, mask_t),),
                        vit: cs.viterbi_plain(*lanes)}
                want[cs.BACKTRACK.name] = (cs.backtrack_plain(want[vit][2], want[vit][1]),)
                sync()
                bad = [k for k in got if not all(torch.equal(a, b) for a, b in zip(got[k], want[k]))]
                if bad:
                    raise AssertionError(f"wide decode K={K} N={N} T={T} finite={finite}: not "
                                         f"identical to the plain versions {bad}")
                cases.append(dict(K=K, N=N, T=T, finite=finite, kernels=list(got)))
            emit("wide_kernels_vs_plain", K=K, N=N, T=T, bitwise_equal=True,
                 layout="warp a lane" if K <= 32 else "block a lane")
            del lanes, got, want

    # each kernel at K=64, N=256, T=500 (the zoo_wide lanes), dense mask
    lanes, u_t = make_case(7900, N_SERIES, G_T, ZW_K, False, device)
    pi_t, A_t, obs_t, mask_t, _, _ = lanes
    mask_t.fill_(1.0)
    ll, alpha = cs.fwd_lanes(*lanes)
    _, dl, bk = cs.viterbi_lanes(pi_t, A_t, obs_t, mask_t)
    calls = {
        cs.FWD.name: lambda: cs.fwd_lanes(*lanes),
        cs.BWD_SAMPLE.name: lambda: cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t),
        cs.VG_BWD.name: lambda: cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll),
        cs.FILTER.name: lambda: cs.filter_lanes(pi_t, A_t, obs_t, mask_t),
        cs.BETA.name: lambda: cs.beta_lanes(A_t, obs_t, mask_t),
        cs.VITERBI.name: lambda: cs.viterbi_lanes(pi_t, A_t, obs_t, mask_t),
        cs.BACKTRACK.name: lambda: cs.backtrack_lanes(bk, dl),
    }
    timing = {name: time_ms(fn, reps=5) for name, fn in calls.items()}
    emit("wide_kernel_timing", shape=dict(N=N_SERIES, T=G_T, K=ZW_K), ms=timing)
    return dict(cases=cases, timing=timing)


def phase_kernels_big(device):
    """Every semiring kernel bitwise equal to its plain version at each K
    of ``BIG_KS`` (the big layout of ``csrc/big_core.cuh``, the big
    backward sampler and, above K = 256, the 16-bit maps and their
    backtrack): ``FWD``, ``BWD_SAMPLE`` and ``VG_BWD`` ungated and gated
    on finite (clamped) inputs with masked runs at both ends; ``FILTER``,
    ``BETA``, ``VITERBI`` and ``BACKTRACK`` on ``MASK_NEG``-sparse A with
    tie lanes and all -inf evidence rows (``make_decode_case``). Each
    kernel is then timed at each K on the same lanes (dense mask), beside
    its bound, and at K = 180 on one lane."""
    cases, timing = [], {}
    for i, K in enumerate(BIG_KS):
        N, T = BIG_N, (BIG_T if K < 1024 else BIG_T_HUGE)
        for gated in (False, True):
            lanes, u_t = make_case(9000 + 4 * i + gated, N, T, K, gated, device, both_ends=True)
            pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
            ll_k, a_k = cs.fwd_lanes(*lanes)
            z_k = cs.bwd_sample_lanes(A_t, mask_t, a_k, u_t, gate_t, sk_t)
            vg_k = cs.vg_bwd_lanes(A_t, obs_t, mask_t, a_k, ll_k, gate_t, sk_t)
            ll_p, a_p = cs.fwd_plain(*lanes)
            z_p = cs.bwd_sample_plain(A_t, mask_t, a_p, u_t, gate_t, sk_t)
            vg_p = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p, gate_t, sk_t)
            sync()
            same = {cs.FWD.name: torch.equal(a_k, a_p) and torch.equal(ll_k, ll_p),
                    cs.BWD_SAMPLE.name: torch.equal(z_k, z_p),
                    cs.VG_BWD.name: all(torch.equal(g, w) for g, w in zip(vg_k, vg_p))}
            if not all(same.values()):
                raise AssertionError(f"big K={K} N={N} T={T} gated={gated}: not bitwise "
                                     f"equal to the plain versions {same}, "
                                     f"{int((z_k != z_p).sum())} draws differ")
            cases.append(dict(K=K, N=N, T=T, gated=gated, kernels=list(same)))
        lanes = make_decode_case(9500 + i, N, T, K, device, finite=False)
        pi_t, A_t, obs_t, mask_t = lanes
        vit = cs.VITERBI.name
        got = {cs.FILTER.name: cs.filter_lanes(*lanes),
               cs.BETA.name: (cs.beta_lanes(A_t, obs_t, mask_t),),
               vit: cs.viterbi_lanes(*lanes)}
        got[cs.BACKTRACK.name] = (cs.backtrack_lanes(got[vit][2], got[vit][1]),)
        want = {cs.FILTER.name: cs.filter_plain(*lanes),
                cs.BETA.name: (cs.beta_plain(A_t, obs_t, mask_t),),
                vit: cs.viterbi_plain(*lanes)}
        want[cs.BACKTRACK.name] = (cs.backtrack_plain(want[vit][2], want[vit][1]),)
        sync()
        bad = [k for k in got if not all(torch.equal(a, b) for a, b in zip(got[k], want[k]))]
        if bad:
            raise AssertionError(f"big decode K={K} N={N} T={T}: not identical to the plain "
                                 f"versions {bad}")
        cases.append(dict(K=K, N=N, T=T, kernels=list(got)))
        timing[K] = big_kernel_timing(device, 9900 + i, N, T, K)
        emit("big_kernels_vs_plain", K=K, N=N, T=T, bitwise_equal=True,
             map_bits=cs._map_bits(K), timing=timing[K])
    one_lane = big_kernel_timing(device, 9990, 1, BIG_T, 180)
    emit("big_kernel_one_lane", K=180, T=BIG_T, timing=one_lane)
    return dict(cases=cases, timing=timing, one_lane=one_lane)


def big_kernel_timing(device, seed, N, T, K):
    """``{kernel: {"ms", "bound_ms", "bound_by"}}`` of each semiring kernel
    on ``N`` lanes of ``T`` steps at ``K`` (dense mask; the decode kernels
    on finite sparse lanes), ms from CUDA events."""
    lanes, u_t = make_case(seed, N, T, K, False, device)
    pi_t, A_t, obs_t, mask_t, _, _ = lanes
    mask_t.fill_(1.0)
    ll, alpha = cs.fwd_lanes(*lanes)
    dec = make_decode_case(seed, N, T, K, device, finite=True)
    dec[3].fill_(1.0)
    _, dl, bk = cs.viterbi_lanes(*dec)
    calls = {
        cs.FWD: (lambda: cs.fwd_lanes(*lanes), fwd_bytes_ops(lanes)),
        cs.BWD_SAMPLE: (lambda: cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t), bwd_bytes_ops(lanes)),
        cs.VG_BWD: (lambda: cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll), vg_bytes_ops(lanes)),
        cs.FILTER: (lambda: cs.filter_lanes(*dec), decode_bytes_ops(cs.FILTER, dec)),
        cs.BETA: (lambda: cs.beta_lanes(*dec[1:]), decode_bytes_ops(cs.BETA, dec)),
        cs.VITERBI: (lambda: cs.viterbi_lanes(*dec), decode_bytes_ops(cs.VITERBI, dec)),
        cs.BACKTRACK: (lambda: cs.backtrack_lanes(bk, dl), decode_bytes_ops(cs.BACKTRACK, dec)),
    }
    out = {}
    for k, (fn, (b, ops)) in calls.items():
        bms, by = bound(b, ops)
        out[k.name] = dict(ms=time_ms(fn, reps=5), bound_ms=bms, bound_by=by)
    return out


def phase_zoo_wide(device):
    """The Gaussian HMM at K=64 (a block a lane on the card) on 256
    simulated series, T=500 (sticky A, means 1.5 apart, as
    ``phase_gaussian_k``): a 10 + 10 Gibbs fit (``FWD`` and
    ``BWD_SAMPLE`` once a sweep, every chain healthy), ``state_draws``
    (each once), ``generated`` (each decode kernel once) on 2 draws a
    series, and one ``forward_value_and_grad`` call on the same lanes
    (``FWD`` and ``VG_BWD`` once). Every output against the plain
    versions on the same lanes on the card (bitwise); the decode and the
    value-and-grad call on the first 16 series also against the same
    calls on the CPU, within ``WIDE_*``. Returns the launch counts."""
    K = ZW_K
    A = np.full((K, K), (1 - GK_STAY) / (K - 1))
    np.fill_diagonal(A, GK_STAY)
    mu = (1.5 * (np.arange(K) - (K - 1) / 2)).tolist()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS + K)
    z_true, x = hmm_sim(gen, G_T, A.tolist(), np.ones(K) / K,
                        obsmodel_gaussian(mu, [GK_SIGMA] * K), batch=(N_SERIES,))
    data = {"x": x}
    model = GaussianHMM(K=K, nig_prior=NIGPrior(**G_PRIOR))
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=ZW_WARMUP, num_samples=ZW_SAMPLES, num_chains=1)
    counts = {}
    sync()
    t0 = time.perf_counter()
    before = launch_counts()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    fit_wall = time.perf_counter() - t0
    counts["fit"] = rose_since(before)
    sweeps = ZW_WARMUP + ZW_SAMPLES
    if counts["fit"] != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
        raise AssertionError(f"zoo_wide: fit launches {counts['fit']}, expected {sweeps} FWD "
                             "and BWD_SAMPLE")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("zoo_wide: an unhealthy chain or a non-finite logp")

    draws = thin(qs[:, 0], ZW_DRAWS)
    before = launch_counts()
    gen_z = torch.Generator(device=device)
    gen_z.manual_seed(SEED_GAUSS + 100 + K)
    z_draws = model.state_draws(gen_z, draws, data, device=device)
    sync()
    counts["state_draws"] = rose_since(before)
    if counts["state_draws"] != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
        raise AssertionError(f"zoo_wide: state_draws launched {counts['state_draws']}")
    before = launch_counts()
    sync()
    t1 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    gen_wall = time.perf_counter() - t1
    counts["generated"] = rose_since(before)
    check_decode_once("zoo_wide", counts["generated"])
    row_dev = {k: check_probabilities("zoo_wide", out, k) for k in ("alpha", "gamma")}
    errs_plain, same = check_zoo_vs_plain("zoo_wide", model, draws, data, out, z_draws,
                                          SEED_GAUSS + 100 + K)

    # one value-and-grad call on the decode's lanes
    B, D = draws.shape[:2]
    params, _ = model.unpack(draws.reshape(B * D, -1))
    lanes = {k: v.repeat_interleave(D, 0) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = model.build(params, lanes)
    ones = torch.ones(log_obs.shape[:2], dtype=torch.float32, device=device)
    before = launch_counts()
    vg = forward_value_and_grad(log_pi, log_A, log_obs, ones)
    sync()
    counts["value_and_grad"] = rose_since(before)
    if counts["value_and_grad"] != {cs.FWD.name: 1, cs.VG_BWD.name: 1}:
        raise AssertionError(f"zoo_wide: value-and-grad launched {counts['value_and_grad']}")
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A, log_obs, ones)
    ll_p, a_p = cs.fwd_plain(pi_t, A_t, obs_t, mask_t)
    vg_p = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p)
    sync()
    vg_lanes = (vg[0], vg[1].t(), vg[2].permute(1, 2, 0), vg[3].permute(1, 2, 0))
    if not all(torch.equal(g, w) for g, w in zip(vg_lanes, (ll_p,) + tuple(vg_p))):
        raise AssertionError("zoo_wide: value-and-grad not bitwise equal to the plain versions")

    # the first ZW_CPU_SERIES series on the CPU: decode and value-and-grad
    S, n = ZW_CPU_SERIES, ZW_CPU_SERIES * D
    ref = model.generated(draws[:S].cpu(), {"x": x[:S].cpu()}, device="cpu")
    errs = {k: float((out[k][:S].cpu() - ref[k]).abs().max()) for k in ("alpha", "gamma")}
    ll_rel = float(((out["loglik"][:S].cpu() - ref["loglik"]) / ref["loglik"]).abs().max())
    path_mismatch = float((out["zstar"][:S].cpu() != ref["zstar"]).float().mean())
    vg_cpu = forward_value_and_grad(*(t[:n].cpu() for t in (log_pi, log_A, log_obs, ones)))
    vg_errs = {
        "loglik_rel": float(((vg[0][:n].cpu() - vg_cpu[0]) / vg_cpu[0]).abs().max()),
        "d_pi": float((vg[1][:n].cpu() - vg_cpu[1]).abs().max()),
        "d_obs": float((vg[3][:n].cpu() - vg_cpu[3]).abs().max()),
        "d_A_rel": float((vg[2][:n].cpu() - vg_cpu[2]).abs().max() / vg_cpu[2].abs().max()),
    }
    if (max(errs.values()) > WIDE_PROB_ATOL or ll_rel > WIDE_LL_RTOL
            or path_mismatch > WIDE_PATH_MISMATCH_MAX or vg_errs["loglik_rel"] > WIDE_LL_RTOL
            or max(vg_errs["d_pi"], vg_errs["d_obs"]) > WIDE_PROB_ATOL
            or vg_errs["d_A_rel"] > WIDE_DA_RTOL):
        raise AssertionError(f"zoo_wide: card vs CPU {errs}, loglik {ll_rel:.3g}, path mismatch "
                             f"{path_mismatch:.3g}, value-and-grad {vg_errs}")
    acc = (out["zstar"] == z_true[:, None]).float().mean()
    emit("zoo_wide", series=N_SERIES, T=G_T, K=K, warmup=ZW_WARMUP, samples=ZW_SAMPLES,
         draws_per_series=D, fit_seconds=fit_wall, sweeps_per_s=sweeps / fit_wall,
         generated_seconds=gen_wall, launches=counts, row_sum_max_dev=row_dev,
         max_abs_err_vs_plain=errs_plain, identical_vs_plain=same,
         value_and_grad_identical_vs_plain=True, cpu_series=S, max_abs_err_vs_cpu=errs,
         loglik_max_rel_err_vs_cpu=ll_rel, zstar_mismatch_share_vs_cpu=path_mismatch,
         value_and_grad_err_vs_cpu=vg_errs, viterbi_accuracy_mean=float(acc))
    return counts


# ---------------------------------------------------------------------------
# main path 5: the Tayal walk-forward back-test
# ---------------------------------------------------------------------------


class LaneRecorder:
    """Wraps the lane wrappers of ``FWD``, ``BWD_SAMPLE``, ``VG_BWD``,
    ``FILTER`` and ``BETA`` (with ``decode=True`` also ``VITERBI`` and
    ``BACKTRACK``) for a ``with`` block: keeps a copy of the inputs and outputs of the
    first launch at each shape and gate the path gives a kernel (the
    lanes, uniforms and gate keys the path made), for the check against
    the plain versions and the timing."""

    # kernel: (wrapper, plain version, position of the [T, K, N] input,
    # position of the gate keys); BACKTRACK's (T, K, N) come from its
    # maps and dlast
    SPEC = {cs.FWD.name: ("fwd_lanes", cs.fwd_plain, 2, 4),
            cs.BWD_SAMPLE.name: ("bwd_sample_lanes", cs.bwd_sample_plain, 2, 4),
            cs.VG_BWD.name: ("vg_bwd_lanes", cs.vg_bwd_plain, 1, 5),
            cs.FILTER.name: ("filter_lanes", cs.filter_plain, 2, 4),
            cs.BETA.name: ("beta_lanes", cs.beta_plain, 1, 3),
            cs.VITERBI.name: ("viterbi_lanes", cs.viterbi_plain, 2, 4),
            cs.BACKTRACK.name: ("backtrack_lanes", cs.backtrack_plain, None, 2)}
    DECODE = (cs.VITERBI.name, cs.BACKTRACK.name)

    def __init__(self, decode: bool = False):
        self.calls, self.stack = {}, ExitStack()
        self.names = [n for n in self.SPEC if decode or n not in self.DECODE]

    def wrap(self, name, fn):
        _, _, at, gate = self.SPEC[name]

        def recorded(*args):
            out = fn(*args)
            if at is None:  # BACKTRACK(back [T, (W,) N], dlast [K, N])
                T, (K, N) = args[0].shape[0], args[1].shape
            else:
                T, K, N = args[at].shape
            key = (name, int(N), int(T), int(K), len(args) > gate and args[gate] is not None)
            if key not in self.calls:
                self.calls[key] = (tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                                   tuple(o.clone() for o in as_tuple(out)))
            return out

        return recorded

    def __enter__(self):
        for name in self.names:
            wrapper = self.SPEC[name][0]
            # dispatch.py holds its own names for FILTER's and BETA's wrappers
            for module in (cs, td) if hasattr(td, wrapper) else (cs,):
                self.stack.enter_context(mock.patch.object(
                    module, wrapper, self.wrap(name, getattr(module, wrapper))))
        return self

    def __exit__(self, *exc):
        self.stack.close()


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class FitRecorder:
    """Wraps ``wf.py``'s ``fit_batched``: each fit group's shape, its
    time on the host clock (synchronized) and its chains' health, and in
    ``lanes`` the kernel launches each group made (:class:`LaneRecorder`)."""

    def __init__(self, fit):
        self.fit, self.groups, self.lanes, self.kept = fit, [], [], []

    def __call__(self, model, data, config, **kw):
        sync()
        t0 = time.perf_counter()
        with LaneRecorder() as rec:
            qs, stats = self.fit(model, data, config, **kw)
        sync()
        legs = data["mask"].sum(1)
        self.groups.append({
            "series": int(legs.shape[0]), "T": int(data["mask"].shape[1]),
            "legs_min": int(legs.min()), "legs_max": int(legs.max()),
            "seconds": time.perf_counter() - t0,
            "healthy": bool(stats["chain_healthy"].all()),
            "logp_finite": bool(torch.isfinite(stats["logp"]).all()),
            **(lockstep(stats) if "lockstep_leapfrogs" in stats else {}),
        })
        self.lanes.append(rec.calls)
        self.kept.append((dict(data), qs, stats))  # for a replay of the same fits
        return qs, stats


class KeptDecode:
    """Side effect of ``TayalHHMMLite.filtered`` (a full decode dispatch)
    and ``TayalHHMMLite.generated`` (an under-filled one), each the
    decode's two ``FWD`` launches: counts each path's calls and keeps,
    for each path, the inputs and outputs of its first call and of its
    first at the largest bucket pair, for the check against the plain
    versions."""

    PATHS = ("filtered", "generated")

    def __init__(self):
        self.calls = dict.fromkeys(self.PATHS, 0)
        self.first, self.largest = {}, {}

    def wrap(self, path):
        fn = getattr(TayalHHMMLite, path)

        def recorded(model, theta, data, device=None, **kw):
            out = fn(model, theta, data, device=device, **kw)
            self.calls[path] += 1
            kept = (path, model, theta, dict(data), out)
            self.first.setdefault(path, kept)
            if path not in self.largest or buckets(data) > buckets(self.largest[path][3]):
                self.largest[path] = kept
            return out

        return recorded

    def kept(self):
        """Each path's first call, and its largest if it is another."""
        out = []
        for path in self.PATHS:
            if path in self.first:
                out.append(self.first[path])
                if self.largest[path] is not self.first[path]:
                    out.append(self.largest[path])
        return out

    def clear(self):
        self.first, self.largest = {}, {}


def buckets(data):
    return data["x"].shape[-1], data["x_oos"].shape[-1]


class VGCounter:
    """Side effect of ``make_vg``: every value-and-grad function it
    returns counts its calls (``make_lp_bc``'s and the step-size
    probe's)."""

    def __init__(self, make_vg):
        self.make_vg, self.calls = make_vg, 0

    def __call__(self, model, data):
        fn = self.make_vg(model, data)

        def counted(q):
            self.calls += 1
            return fn(q)

        return counted


def wf_tasks():
    """``(tasks, seconds)``: the walk-forward windows of ``WF_SYMBOLS`` x
    ``WF_DAYS`` days of ``simulate_ticks`` (legs a day spread evenly in
    log over ``WF_LEGS_PER_DAY`` by symbol, +-10 % a day), and the host
    time it took to simulate them."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED_WF)
    legs = np.geomspace(*WF_LEGS_PER_DAY, WF_SYMBOLS)
    days = {
        f"S{s:02d}": [
            dict(zip(("price", "size", "t_seconds"),
                     simulate_ticks(rng, n_legs=int(n * rng.uniform(0.9, 1.1)))[:3]))
            for _ in range(WF_DAYS)
        ]
        for s, n in enumerate(legs)
    }
    tasks = build_tasks(days, train_days=WF_TRAIN_DAYS, trade_days=WF_TRADE_DAYS)
    return tasks, time.perf_counter() - t0


def wf_decode_vs_plain(kept, arm):
    """A decode dispatch (through ``filtered`` or ``generated``) again
    through ``fwd_plain`` on the same lanes on the card, then the same
    median and argmax: the filtered probabilities bitwise and the leg
    states identical."""
    path, model, theta, data, out = kept
    gated = False
    lead, flat, lanes = zoo_base.draw_lanes(theta, data, theta.device)
    params, _ = model.unpack(flat)
    errs = {}
    for key, (xk, sk, mk) in (("alpha", ("x", "sign", "mask")),
                              ("alpha_oos", ("x_oos", "sign_oos", "mask_oos"))):
        seg = {"x": lanes[xk], "sign": lanes[sk]}
        log_pi, log_A, log_obs, _ = model.build_vg(params, seg)
        gk = model.gate_keys(seg)
        gated = gk is not None
        _, a_plain = cs.fwd_plain(*cs.to_lanes(log_pi, log_A, log_obs, lanes[mk],
                                               *(gk if gated else ())))
        probs = torch.softmax(a_plain.permute(2, 0, 1), dim=-1).reshape(out[key].shape)
        errs[key] = float((probs - out[key]).abs().max())
        if not torch.equal(median_states(probs), median_states(out[key])):
            raise AssertionError(f"{arm}: {key} leg states differ from the plain version's")
    if max(errs.values()) != 0.0:
        raise AssertionError(f"{arm}: decode not bitwise equal to fwd_plain: {errs}")
    return {"path": path, "lanes": int(flat.shape[0]), "T": int(data["x"].shape[1]),
            "T_oos": int(data["x_oos"].shape[1]), "gated": gated,
            "max_abs_err": errs}


def wf_run(tasks, config, gate_mode, chunk, device, medians=None):
    """``wf_trade`` with the recorders in place (``medians``: a
    :class:`MedianRecorder` for ``median_states``): ``(results,
    phase_timings, wall seconds, fit recorder, decode recorder,
    value-and-grad calls, launches, native series)``."""
    rec = FitRecorder(wf_module.fit_batched)
    dec = KeptDecode()
    vg = VGCounter(TayalHHMMLite.make_vg)
    phases = {}
    native0 = native_zigzag.series_extracted
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(wf_module, "fit_batched", rec), \
            mock.patch.object(TayalHHMMLite, "filtered", autospec=True,
                              side_effect=dec.wrap("filtered")), \
            mock.patch.object(TayalHHMMLite, "generated", autospec=True,
                              side_effect=dec.wrap("generated")), \
            mock.patch.object(TayalHHMMLite, "make_vg", autospec=True, side_effect=vg), \
            mock.patch.object(wf_module, "median_states", medians or median_states):
        res = wf_trade(tasks, config, gate_mode=gate_mode, chunk_size=chunk,
                       phase_timings=phases, seed=SEED_WF, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    return (res, phases, wall, rec, dec, vg.calls, rose,
            native_zigzag.series_extracted - native0)


def wf_returns(res, lags):
    """Mean over tasks of the compounded OOS return a lag, and of
    buy-and-hold, in percent."""
    out = {str(lag): float(np.mean([100 * (equity_curve(r.trades[lag].ret)[-1] - 1)
                                    if len(r.trades[lag]) else 0.0 for r in res]))
           for lag in lags}
    out["buy_and_hold"] = float(np.mean([100 * (equity_curve(r.bnh)[-1] - 1) for r in res]))
    return out


def phase_walk_forward(device, tasks, data_s):
    """The fifth main path: ``apps/tayal/wf.py::wf_trade`` on the
    ``WF_TASKS`` simulated windows of :func:`wf_tasks` at full width
    (K=4, L=9): native zig-zag features, length-sorted 1024-bucket Gibbs
    fits (hard gate, one chain, 100 + 300 sweeps, 64 windows a group),
    the batched median-alpha decode and the host trading. Then its ChEES
    arm (stan gate) on 16 of the tasks. Returns the fit groups for the
    kernels' check at the shapes they ran."""
    if len(tasks) != WF_TASKS:
        raise AssertionError(f"walk_forward: {len(tasks)} tasks, expected {WF_TASKS}")
    lags = (0, 1, 2, 3, 4, 5)
    cfg = GibbsConfig(num_warmup=WF_WARMUP, num_samples=WF_SAMPLES, num_chains=1)
    medians = MedianRecorder()
    res, phases, wall, fits, filt, _, rose, native = wf_run(tasks, cfg, "hard", WF_CHUNK, device,
                                                            medians)
    groups = fits.groups
    if native != len(tasks):
        raise AssertionError(f"walk_forward: the native extractor took {native} of {len(tasks)} "
                             "series (the NumPy engine ran)")
    sweeps = WF_WARMUP + WF_SAMPLES
    n_groups = -(-len(tasks) // WF_CHUNK)
    dispatches = phases["decode.dispatches"]
    want = {cs.FWD.name: sweeps * n_groups + 2 * dispatches, cs.BWD_SAMPLE.name: sweeps * n_groups}
    if len(groups) != n_groups or rose != want or filt.calls != {"filtered": dispatches,
                                                                 "generated": 0}:
        raise AssertionError(f"walk_forward: launches {rose} over {len(groups)} fit groups and "
                             f"decode calls {filt.calls}, expected {want}")
    if not all(g["healthy"] and g["logp_finite"] for g in groups):
        raise AssertionError(f"walk_forward: an unhealthy chain or a non-finite logp: {groups}")
    for r in res:
        if not np.isfinite(r.bnh).all() or set(r.trades) != set(lags) or r.chains_pooled != 1:
            raise AssertionError(f"walk_forward: task {r.symbol}/{r.window}: bnh finite "
                                 f"{np.isfinite(r.bnh).all()}, lags {sorted(r.trades)}")
        if len(r.leg_topstate) != r.n_ins_legs + r.n_oos_legs:
            raise AssertionError(f"walk_forward: task {r.symbol}/{r.window} leg states")
    plain = [wf_decode_vs_plain(k, "walk_forward") for k in filt.kept()]
    filt.clear()
    ins = np.array([r.n_ins_legs for r in res])
    oos = np.array([r.n_oos_legs for r in res])
    fit_s = sum(g["seconds"] for g in groups)
    emit("walk_forward", tasks=len(tasks), symbols=WF_SYMBOLS, days=WF_DAYS,
         train_days=WF_TRAIN_DAYS, trade_days=WF_TRADE_DAYS, gate_mode="hard",
         warmup=WF_WARMUP, samples=WF_SAMPLES, chunk=WF_CHUNK, data_seconds=data_s,
         seconds=wall, phase_timings=phases, native_series=native,
         legs_in_sample=dict(min=int(ins.min()), median=float(np.median(ins)), max=int(ins.max())),
         legs_oos=dict(min=int(oos.min()), median=float(np.median(oos)), max=int(oos.max())),
         fit_groups=[dict(g, sweeps_per_s=sweeps / g["seconds"]) for g in groups],
         fit_sweeps_per_s=sweeps * n_groups / fit_s,
         decode_dispatches=dispatches, decode_calls=filt.calls,
         decode_lanes_a_dispatch=G_DEC * D_DEC,
         decode_shapes=phases["decode.shapes_pending"], launches=rose,
         decode_vs_plain=plain, swapped=int(sum(r.swapped for r in res)),
         oos_leg_switches_mean=float(np.mean([r.oos_leg_switches for r in res])),
         oos_return_pct_mean=wf_returns(res, lags))

    # the ChEES arm (the Stan-parity model): one value-and-grad call a
    # leapfrog, no fused trajectory, as the JAX fit_batched runs it
    sub = tasks[::WF_CHEES_STRIDE][:WF_CHEES_TASKS]
    ccfg = ChEESConfig(num_warmup=WF_CHEES_WARMUP, num_samples=WF_CHEES_SAMPLES,
                       num_chains=CHAINS, max_leapfrogs=CAP)
    res_c, phases_c, wall_c, fits_c, filt_c, vg_calls, rose_c, _ = wf_run(
        sub, ccfg, "stan", WF_CHEES_CHUNK, device)
    groups_c = fits_c.groups
    want_c = {cs.FWD.name: vg_calls + 2 * phases_c["decode.dispatches"], cs.VG_BWD.name: vg_calls}
    # (a dispatch holding a task whose basin selection kept fewer than
    # D_DEC draws decodes through generated, also two FWD launches)
    if rose_c != want_c:
        raise AssertionError(f"walk_forward_chees: launches {rose_c}, expected {want_c}")
    if not all(g["healthy"] and g["logp_finite"] for g in groups_c):
        raise AssertionError(f"walk_forward_chees: an unhealthy chain: {groups_c}")
    div = float(np.mean([r.diverged for r in res_c]))
    if not div < WF_DIV_MAX or not all(np.isfinite(r.bnh).all() for r in res_c):
        raise AssertionError(f"walk_forward_chees: divergent share {div:.3g} (limit {WF_DIV_MAX})")
    plain_c = [wf_decode_vs_plain(k, "walk_forward_chees") for k in filt_c.kept()]
    filt_c.clear()
    emit("walk_forward_chees", tasks=len(sub), gate_mode="stan", chains=CHAINS, cap=CAP,
         warmup=WF_CHEES_WARMUP, samples=WF_CHEES_SAMPLES, chunk=WF_CHEES_CHUNK,
         seconds=wall_c, phase_timings=phases_c, fit_groups=groups_c,
         value_and_grad_calls=vg_calls, decode_dispatches=phases_c["decode.dispatches"],
         decode_dispatches_under_filled=filt_c.calls["generated"],
         value_and_grad_ms=sum(g["seconds"] for g in groups_c) / max(vg_calls, 1) * 1e3,
         launches=rose_c, decode_vs_plain=plain_c, divergent_share=div,
         divergent_share_max_task=float(max(r.diverged for r in res_c)),
         chains_pooled_mean=float(np.mean([r.chains_pooled for r in res_c])),
         oos_return_pct_mean=wf_returns(res_c, lags))
    return (fits, fits_c), (fits, medians, res)


def kept_vs_plain(calls, phase):
    """The first launch of each kernel at each shape a path made
    (:attr:`LaneRecorder.calls`), bitwise against its plain version on
    the same inputs, then timed on them."""
    rows = []
    for (name, N, T, K, gated), (args, got) in calls.items():
        wrapper, plain, _, _ = LaneRecorder.SPEC[name]
        want = as_tuple(plain(*args))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
            raise AssertionError(f"{phase}: {name} N={N} T={T} K={K} gated={gated} not bitwise "
                                 f"equal to its plain version, max abs errs {errs}")
        fn = getattr(cs, wrapper)
        rows.append(dict(kernel=name, N=N, T=T, K=K, gated=gated, bitwise_equal=True,
                         ms=time_ms(lambda: fn(*args), reps=10)))
    return rows


def phase_walk_forward_kernels(fits, fits_c):
    """The kernels at the shapes and gates the walk-forward fits gave
    them: the first launch of ``FWD``, ``BWD_SAMPLE`` and ``VG_BWD`` at
    each shape of each Gibbs and ChEES fit group, its inputs as the path
    made them, held bitwise against the plain version on the same
    inputs (``BWD_SAMPLE`` on the same alpha and uniforms; past T=2048
    its device-scratch path) and timed on them; a Gibbs group's kernel
    pair as a share of its sweep."""
    out = {}
    for arm, rec in (("gibbs", fits), ("chees", fits_c)):
        rows = []
        for g, calls in zip(rec.groups, rec.lanes):
            kernels = kept_vs_plain(calls, f"walk_forward_kernels ({arm} fit group)")
            row = dict(series=g["series"], T=g["T"], launches=kernels)
            if arm == "gibbs":  # a sweep: one FWD and one BWD_SAMPLE at the group's lanes
                pair = [k for k in kernels if k["N"] == g["series"] and k["T"] == g["T"]]
                if sorted(k["kernel"] for k in pair) != sorted((cs.FWD.name, cs.BWD_SAMPLE.name)):
                    raise AssertionError(f"walk_forward_kernels: a Gibbs group's launches {kernels}")
                row["sweep_ms"] = g["seconds"] / (WF_WARMUP + WF_SAMPLES) * 1e3
                row["kernel_share"] = sum(k["ms"] for k in pair) / row["sweep_ms"]
            rows.append(row)
        rec.lanes = []
        out[arm] = rows
    emit("walk_forward_kernels", **out)
    return out


# ---------------------------------------------------------------------------
# main paths 6-8: NUTS
# ---------------------------------------------------------------------------


def lockstep(stats) -> dict:
    """The lockstep cost of NUTS over a batch: per transition (warmup,
    then sampling) the leapfrogs the batch ran (every lane, finished
    ones included) against the mean leaves a lane needed; their ratio
    over the run is the lockstep efficiency."""
    leaves = torch.cat([stats["warmup_num_leaves"], stats["num_leaves"]], dim=-1).float()
    mean_leaves = leaves.reshape(-1, leaves.shape[-1]).mean(0)
    lock = stats["lockstep_leapfrogs"][0].float()
    syncs = stats["host_syncs"][0].float()
    return {"lockstep_leapfrogs": int(lock.sum()), "mean_lane_leaves": float(mean_leaves.sum()),
            "lockstep_efficiency": float(mean_leaves.sum() / lock.sum()),
            "lockstep_per_transition_mean": float(lock.mean()),
            "lockstep_per_transition_max": int(lock.max()),
            "host_syncs_per_transition": float(syncs.mean())}


def nuts_task(name, device):
    """The sixth main path, in a spawned process: ``fit_batched`` with a
    ``SamplerConfig`` on the ChEES phase's batch and model (stan gate,
    256 series x T=1024, one chain: 256 lanes in lockstep),
    ``max_treedepth`` 10. Every chain healthy, ``FWD`` and ``VG_BWD``
    launched once a value-and-grad call and nothing else, the emission
    rows near the simulator's, divergent share under ``NUTS_DIV_MAX``;
    the lockstep cost, the depths, step sizes and host syncs a
    transition. Returns the phase line's fields (with ``phi_mean`` for
    the gap to the ChEES posterior, taken in the parent) and ``(model,
    data, last draws)`` for :func:`vg_ms_alone`."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = SamplerConfig(num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES, num_chains=1,
                        max_treedepth=NUTS_TREEDEPTH)
    vg = VGCounter(TayalHHMM.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(TayalHHMM, "make_vg", autospec=True, side_effect=vg):
        qs, stats = fit_batched(model, data, cfg, init=init, chunk_size=N_SERIES,
                                seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose != {cs.FWD.name: vg.calls, cs.VG_BWD.name: vg.calls}:
        raise AssertionError(f"nuts: launches {rose} for {vg.calls} value-and-grad calls")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("nuts: an unhealthy chain or a non-finite logp")
    if tuple(qs.shape) != (N_SERIES, 1, NUTS_SAMPLES, model.n_free):
        raise AssertionError(f"nuts: qs shape {tuple(qs.shape)}")
    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= PHI_MAE_MAX:
        raise AssertionError(f"nuts: posterior-mean phi MAE {mae.mean():.3g} > {PHI_MAE_MAX}")
    div_share = float(stats["diverging"].float().mean())
    if not div_share < NUTS_DIV_MAX:
        raise AssertionError(f"nuts: divergent share {div_share:.3g} (limit {NUTS_DIV_MAX})")
    transitions = NUTS_WARMUP + NUTS_SAMPLES
    eps = stats["step_size"].reshape(-1)
    depth = stats["depth"].reshape(-1)
    row = dict(series=N_SERIES, T=T_FIT, chains=1, warmup=NUTS_WARMUP, samples=NUTS_SAMPLES,
               max_treedepth=NUTS_TREEDEPTH, seconds=wall, transitions_per_s=transitions / wall,
               transition_ms=wall / transitions * 1e3, value_and_grad_calls=vg.calls,
               **lockstep(stats),
               depth_histogram_sampling=torch.bincount(depth,
                                                       minlength=NUTS_TREEDEPTH + 1).tolist(),
               leaves_mean_sampling=float(stats["num_leaves"].float().mean()),
               step_size=dict(min=float(eps.min()), median=float(eps.median()),
                              max=float(eps.max())),
               accept_mean_sampling=float(stats["accept_prob"].mean()),
               divergent_share=div_share, divergent_warmup=int(stats["warmup_diverging"].sum()),
               launches=rose, logp_mean=float(stats["logp"].mean()),
               ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
               mirror_fold_share=swap_share,
               phi_mae_mean=float(mae.mean()), phi_mae_max=float(mae.max()), phi_mean=phi_mean)
    return row, (model, data, qs[:, :, -1].contiguous())


def gaussian_nuts_task(name, device):
    """The seventh main path, in a spawned process: the ``hmm/main.R`` gate of
    ``tests/test_models.py::test_gaussian_hmm_recovery`` on the port's
    simulator, ``sample_nuts(model.make_logp(data))`` (the target through
    ``forward_loglik``: ``FILTER`` forward and ``BETA`` backward once a
    log-density call, and nothing else), 60 + 60 transitions on 2
    chains: posterior means within the test's bounds, divergent share
    under ``GN_DIV_MAX``, Viterbi accuracy of ``generated`` above
    ``G_ACC_MIN``. Returns the phase line's fields (its ``launches``: the
    fit's and the decode's together) and no value-and-grad inputs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GN)
    z_true, x = hmm_sim(gen, GN_T, GN_A, GN_P1, obsmodel_gaussian(GN_MU, GN_SIGMA))
    data = {"x": x}
    model = GaussianHMM(K=2)
    init = init_chains(model, data, GN_CHAINS, seed=SEED_INIT, device=device)
    cfg = SamplerConfig(num_warmup=GN_WARMUP, num_samples=GN_SAMPLES, num_chains=GN_CHAINS)
    logp = Counted(model.make_logp(data))
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    qs, stats = sample_nuts(logp, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose != {cs.FILTER.name: logp.calls, cs.BETA.name: logp.calls}:
        raise AssertionError(f"gaussian_nuts: launches {rose} for {logp.calls} logp calls")
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError("gaussian_nuts: a chain was quarantined")
    post = model.constrained_draws(qs)
    est = {k: post[k].mean((0, 1)).cpu().numpy() for k in ("mu_k", "sigma_k", "A_ij")}
    errs = {"mu_k": float(np.abs(est["mu_k"] - GN_MU).max()),
            "sigma_k": float(np.abs(est["sigma_k"] - GN_SIGMA).max()),
            "A_ij": float(np.abs(est["A_ij"] - np.asarray(GN_A)).max())}
    div_share = float(stats["diverging"].float().mean())
    if (errs["mu_k"] > GN_MU_ATOL or errs["sigma_k"] > GN_SIGMA_ATOL or errs["A_ij"] > GN_A_ATOL
            or not div_share < GN_DIV_MAX):
        raise AssertionError(f"gaussian_nuts: posterior-mean errors {errs}, divergent share "
                             f"{div_share:.3g}")
    draws = qs.reshape(-1, model.n_free)[::50]
    before = launch_counts()
    out = model.generated(draws, data, device=device)
    rose_gen = rose_since(before)
    check_decode_once("gaussian_nuts", rose_gen)
    acc = float((out["zstar"] == z_true[None]).float().mean())
    if not acc > G_ACC_MIN:
        raise AssertionError(f"gaussian_nuts: Viterbi accuracy {acc:.4g}")
    transitions = GN_WARMUP + GN_SAMPLES
    path = {n: rose.get(n, 0) + rose_gen.get(n, 0) for n in set(rose) | set(rose_gen)}
    row = dict(T=GN_T, K=2, chains=GN_CHAINS, warmup=GN_WARMUP, samples=GN_SAMPLES,
               seconds=wall, transitions_per_s=transitions / wall, logp_calls=logp.calls,
               logp_call_ms=wall / logp.calls * 1e3,
               **lockstep({k: v[None] for k, v in stats.items()}),
               step_size=stats["step_size"].tolist(), divergent_share=div_share,
               posterior_means={k: v.tolist() for k, v in est.items()}, max_abs_err=errs,
               viterbi_accuracy=acc, generated_draws=int(draws.shape[0]), fit_launches=rose,
               generated_launches=rose_gen, launches=path)
    return row, None


def phase_walk_forward_nuts(device, tasks):
    """The eighth main path: ``wf_trade`` with a ``SamplerConfig`` on
    every ``WF_NUTS_STRIDE``-th of the ChEES arm's windows ordered by
    in-sample ticks (the shortest and one of about 3,100 legs: one fit
    group of 2 windows; stan gate, one chain, 20 + 20 transitions): ``FWD`` and
    ``VG_BWD`` once a value-and-grad call and ``FWD`` twice a decode
    dispatch, every chain healthy, trades for every lag, the lockstep
    cost a fit group. Then ``run_window`` on the first of the windows.
    The first launch of each kernel at each shape of the fit group and
    of ``run_window`` (its fit and its decode), and of each decode path
    of ``wf_trade`` (every dispatch under-filled at 50 draws, so through
    ``generated``), held bitwise against the plain versions."""
    lags = (0, 1, 2, 3, 4, 5)
    chees_arm = sorted(tasks[::WF_CHEES_STRIDE][:WF_CHEES_TASKS], key=lambda t: t.ins_end_tick)
    sub = chees_arm[::WF_NUTS_STRIDE]
    cfg = SamplerConfig(num_warmup=WF_NUTS_WARMUP, num_samples=WF_NUTS_SAMPLES, num_chains=1)
    res, phases, wall, fits, dec, vg_calls, rose, _ = wf_run(sub, cfg, "stan", WF_CHEES_CHUNK,
                                                             device)
    want = {cs.FWD.name: vg_calls + 2 * phases["decode.dispatches"], cs.VG_BWD.name: vg_calls}
    if rose != want:
        raise AssertionError(f"walk_forward_nuts: launches {rose}, expected {want}")
    groups = fits.groups
    if not all(g["healthy"] and g["logp_finite"] for g in groups):
        raise AssertionError(f"walk_forward_nuts: an unhealthy chain: {groups}")
    for r in res:
        if not np.isfinite(r.bnh).all() or set(r.trades) != set(lags):
            raise AssertionError(f"walk_forward_nuts: task {r.symbol}/{r.window}: no trades")
    fit_kernels = [kept_vs_plain(calls, "walk_forward_nuts (fit group)") for calls in fits.lanes]
    fits.lanes = []
    plain = [wf_decode_vs_plain(k, "walk_forward_nuts") for k in dec.kept()]
    if not plain:
        raise AssertionError("walk_forward_nuts: no decode call was kept")
    dec.clear()

    task = sub[0]
    vg = VGCounter(TayalHHMMLite.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(TayalHHMMLite, "make_vg", autospec=True, side_effect=vg), \
            LaneRecorder() as rec:
        win = run_window(task.price, task.size, task.t_seconds, task.ins_end_tick, config=cfg,
                         seed=SEED_WF, device=device)
    sync()
    win_s = time.perf_counter() - t0
    rose_w = rose_since(before)
    # the fit's value-and-grad calls, then the decode's two filtered passes
    if rose_w != {cs.FWD.name: vg.calls + 2, cs.VG_BWD.name: vg.calls}:
        raise AssertionError(f"run_window: launches {rose_w} for {vg.calls} value-and-grad calls")
    if not win.stats["chain_healthy"].all() or set(win.trades) != set(lags) \
            or not np.isfinite(win.bnh).all():
        raise AssertionError("run_window: an unhealthy chain or no trades")
    # the fit's pair at T = the window's legs, and the decode's FWD at the
    # in-sample and out-of-sample lengths
    win_kernels = kept_vs_plain(rec.calls, "run_window")
    emit("walk_forward_nuts", tasks=len(sub), gate_mode="stan", chains=1,
         warmup=WF_NUTS_WARMUP, samples=WF_NUTS_SAMPLES, chunk=WF_CHEES_CHUNK, seconds=wall,
         phase_timings=phases, fit_groups=groups, value_and_grad_calls=vg_calls,
         value_and_grad_ms=sum(g["seconds"] for g in groups) / max(vg_calls, 1) * 1e3,
         decode_dispatches=phases["decode.dispatches"], decode_calls=dec.calls,
         launches=rose, fit_kernels_vs_plain=fit_kernels, decode_vs_plain=plain,
         divergent_share=float(np.mean([r.diverged for r in res])),
         divergent_share_max_task=float(max(r.diverged for r in res)),
         oos_return_pct_mean=wf_returns(res, lags),
         run_window=dict(symbol=task.symbol, window=task.window, seconds=win_s,
                         legs_in_sample=win.n_ins_legs, legs=len(win.zig),
                         value_and_grad_calls=vg.calls, launches=rose_w,
                         kernels_vs_plain=win_kernels,
                         divergent_share=float(win.stats["diverging"].mean()),
                         step_size=win.stats["step_size"].tolist(),
                         **lockstep({k: torch.as_tensor(v)[None]
                                     for k, v in win.stats.items()})))
    return {n: rose.get(n, 0) + rose_w.get(n, 0) for n in set(rose) | set(rose_w)}


# ---------------------------------------------------------------------------
# main paths 9-12: the multinomial HMMs, fit_batched's healing ladder,
# per-series ChEES adaptation and the replication diagnostics
# ---------------------------------------------------------------------------


class GumbelRoute(SemisupMultinomialHMM):
    """The stan-gate model without its gate keys: ``state_draws`` takes
    ``build``'s time-varying ``log_A`` through the Gumbel-max FFBS, the
    JAX package's route, instead of the gated kernels."""

    def gate_keys(self, data):
        return None


def mn_batch(cfg, device):
    """``(z, data, phi, A)``: ``N_SERIES`` series of ``T_FIT`` steps of one
    ``MN_CONFIGS`` configuration, simulated on the card (the semisup
    labels ``g`` are the groups of the true states, as
    ``examples/hmm_main.py`` makes them)."""
    _, K, L, A, p1, conc, groups = cfg
    phi = np.random.default_rng(SEED_MN + K).dirichlet(np.ones(L) * conc, size=K)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_MN + K)
    z, x = hmm_sim(gen, T_FIT, A, p1, obsmodel_categorical(phi), batch=(N_SERIES,),
                   validate=False)
    data = {"x": x}
    if groups is not None:
        data["g"] = torch.as_tensor(groups, device=device)[z]
    return z, data, phi, np.asarray(A)


def p1_of(model, name):
    """The simulator's initial distribution of the configuration."""
    return next(c[4] for c in MN_CONFIGS if c[1] == model.K and c[2] == model.L)


def mn_fit(name, model, data, z, phi, A, device):
    """One multinomial model through ``fit_batched`` (Gibbs, chunks of
    ``MN_CHUNK``) and ``generated`` (cold, then warm): launches, health,
    and per series after ``greedy_relabel`` of the Viterbi path against
    the simulated states, the accuracy and the emission and transition
    errors of the posterior means."""
    K = model.K
    cfg = GibbsConfig(num_warmup=WARMUP, num_samples=SAMPLES, num_chains=1)
    sweeps, n_chunks = WARMUP + SAMPLES, -(-N_SERIES // MN_CHUNK)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    qs, stats = fit_batched(model, data, cfg, chunk_size=MN_CHUNK, seed=SEED_MN, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    want = {cs.FWD.name: sweeps * n_chunks, cs.BWD_SAMPLE.name: sweeps * n_chunks}
    if rose != want:
        raise AssertionError(f"multinom {name}: launches {rose}, expected {want}")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError(f"multinom {name}: an unhealthy chain or a non-finite logp")
    draws = thin(qs[:, 0], MN_DRAWS)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    cold = time.perf_counter() - t0
    rose_gen = rose_since(before)
    homogeneous = getattr(model, "gate_mode", "hard") == "hard"
    if homogeneous:
        check_decode_once(f"multinom {name}", rose_gen)
    elif rose_gen:  # the stan gate's time-varying log_A runs the scans
        raise AssertionError(f"multinom {name}: the time-varying decode launched {rose_gen}")
    check_probabilities(f"multinom {name}", out, "alpha")
    check_probabilities(f"multinom {name}", out, "gamma")
    t0 = time.perf_counter()
    out2 = model.generated(draws, data, device=device)
    sync()
    warm = time.perf_counter() - t0
    if not torch.equal(out["zstar"], out2["zstar"]):
        raise AssertionError(f"multinom {name}: a repeated generated call gave other paths")
    z_hat = torch.mode(out["zstar"], dim=1).values.cpu().numpy()
    z_true = z.cpu().numpy()
    post = model.constrained_draws(qs)
    phi_hat = post["phi_k"].mean((1, 2)).cpu().numpy()
    A_hat = post["A_ij"].mean((1, 2)).cpu().numpy()
    acc, phi_err, A_err = [], [], []
    for b in range(N_SERIES):
        perm = greedy_relabel(z_true[b], z_hat[b], K)
        inv = np.argsort(perm)
        acc.append(float((perm[z_hat[b]] == z_true[b]).mean()))
        phi_err.append(float(np.abs(phi_hat[b][inv] - phi).mean()))
        A_err.append(float(np.abs(A_hat[b][np.ix_(inv, inv)] - A).mean()))
    acc, phi_err, A_err = map(np.asarray, (acc, phi_err, A_err))
    # the true parameters' own Viterbi accuracy on the same series
    true = {"p_1k": torch.as_tensor(np.asarray(p1_of(model, name)), dtype=torch.float32),
            "A_ij": torch.as_tensor(A, dtype=torch.float32),
            "phi_k": torch.as_tensor(phi, dtype=torch.float32)}
    true = {k: v.clamp_min(1e-6) / v.clamp_min(1e-6).sum(-1, keepdim=True) for k, v in true.items()}
    theta = model.pack({k: v.to(device) for k, v in true.items()})
    z_or = model.generated(theta.expand(N_SERIES, 1, -1), data, device=device)["zstar"][:, 0]
    oracle = float((z_or == z).float().mean())
    emit("multinom", model=name, K=K, L=model.L, gate_mode=getattr(model, "gate_mode", None),
        series=N_SERIES, T=T_FIT, warmup=WARMUP, samples=SAMPLES, chunk=MN_CHUNK,
        seconds=wall, sweeps_per_s=sweeps * n_chunks / wall, sweep_ms=wall / (sweeps * n_chunks) * 1e3,
        launches=rose, generated_launches=rose_gen, generated_lanes=N_SERIES * MN_DRAWS,
        generated_first_s=cold, generated_warm_s=warm,
        viterbi_accuracy_mean=float(acc.mean()), viterbi_accuracy_min=float(acc.min()),
        viterbi_accuracy_true_params=oracle,
        phi_mae_mean=float(phi_err.mean()), phi_mae_max=float(phi_err.max()),
        A_mae_mean=float(A_err.mean()), A_mae_max=float(A_err.max()),
        logp_mean=float(stats["logp"].mean()))
    if not phi_err.mean() <= MN_PHI_MAE_MAX or (
            homogeneous and not acc.mean() >= oracle - MN_ACC_GAP):
        raise AssertionError(f"multinom {name}: Viterbi accuracy {acc.mean():.3f} (true "
                             f"parameters {oracle:.3f}, gap at most {MN_ACC_GAP}), phi MAE "
                             f"{phi_err.mean():.3f} (max {MN_PHI_MAE_MAX})")
    return qs


def state_freq_z(z1, z2, K):
    """The two routes' per-step state frequencies pooled over series,
    ``F_r[t, k] = mean_b mean_d 1[z_r = k]``, against each other: the
    largest ``|F_1 - F_2| / sd`` over (t, k), ``sd`` the binomial
    standard deviation of the difference of two independent draws of
    ``D`` paths a series from the same posterior (estimated from the
    pooled frequencies); and the largest gap where ``sd`` is 0."""
    D = z1.shape[1]
    f1 = torch.stack([(z1 == k).float().mean(1) for k in range(K)], -1)  # [B, T, K]
    f2 = torch.stack([(z2 == k).float().mean(1) for k in range(K)], -1)
    p = 0.5 * (f1 + f2)
    sd = torch.sqrt((2.0 * p * (1.0 - p) / D).sum(0)) / f1.shape[0]
    gap = (f1.mean(0) - f2.mean(0)).abs()
    pos = sd > 0
    return float((gap[pos] / sd[pos]).max()), float(gap[~pos].max()) if bool((~pos).any()) else 0.0


def phase_multinom(device):
    """The ninth main path: ``MultinomialHMM(K=3, L=5)`` and
    ``SemisupMultinomialHMM(K=4, L=9)`` under both gates (see
    ``MN_CONFIGS``), each fitted and decoded (:func:`mn_fit`); then 32
    ``state_draws`` a series of the stan-gate fit twice, on the gated
    kernels and on the Gumbel route, whose pooled per-step state
    frequencies must agree within ``MN_FREQ_Z_MAX`` sigma. The first
    launch of each kernel at each shape, bitwise against its plain
    version."""
    with LaneRecorder(decode=True) as rec:
        mn = MN_CONFIGS[0]
        z, data, phi, A = mn_batch(mn, device)
        mn_fit("multinom", MultinomialHMM(mn[1], mn[2]), data, z, phi, A, device)
        ss = MN_CONFIGS[1]
        z, data, phi, A = mn_batch(ss, device)
        mn_fit("semisup_hard", SemisupMultinomialHMM(ss[1], ss[2], ss[6], gate_mode="hard"),
               data, z, phi, A, device)
        stan = SemisupMultinomialHMM(ss[1], ss[2], ss[6])
        qs = mn_fit("semisup_stan", stan, data, z, phi, A, device)
        draws = thin(qs[:, 0], MN_STATE_DRAWS)
        timing = {}
        paths = {}
        for route, model in (("gated_kernels", stan), ("gumbel", GumbelRoute(ss[1], ss[2], ss[6]))):
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED_MN + len(route))
            before = launch_counts()
            sync()
            t0 = time.perf_counter()
            paths[route] = model.state_draws(gen, draws, data, device=device)
            sync()
            timing[route] = time.perf_counter() - t0
            rose = rose_since(before)
            want = ({cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1} if route == "gated_kernels" else {})
            if rose != want:
                raise AssertionError(f"multinom state_draws {route}: launches {rose}, expected {want}")
    launches = {k.name: k.launches for k in ALL_KERNELS if k.launches}
    zmax, flat_gap = state_freq_z(paths["gated_kernels"], paths["gumbel"], ss[1])
    if not (zmax < MN_FREQ_Z_MAX and flat_gap == 0.0):
        raise AssertionError(f"multinom state_draws: the routes' frequencies differ by {zmax:.2f} "
                             f"sigma (bound {MN_FREQ_Z_MAX}), {flat_gap} where sd is 0")
    consistent = (torch.as_tensor(ss[6], device=device)[paths["gumbel"]] == data["g"][:, None]).float()
    kernels = kept_vs_plain(rec.calls, "multinom")
    emit("multinom_state_draws", series=N_SERIES, draws=MN_STATE_DRAWS, T=T_FIT,
         lanes=N_SERIES * MN_STATE_DRAWS, seconds=timing, freq_z_max=zmax,
         freq_z_bound=MN_FREQ_Z_MAX, gumbel_group_consistency=float(consistent.mean()),
         launches=launches, kernels_vs_plain=kernels)
    return launches, kernels


class StderrLines:
    """``fit_batched``'s log lines (stderr) for a ``with`` block: copied
    to the real stderr and kept in ``lines``."""

    def __init__(self):
        self.lines, self.buf = [], io.StringIO()

    def __enter__(self):
        self.ctx = contextlib.redirect_stderr(self.buf)
        self.ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self.ctx.__exit__(*exc)
        text = self.buf.getvalue()
        sys.stderr.write(text)
        self.lines = [ln for ln in text.splitlines() if ln.startswith("# fit_batched")]


def ladder_lines(lines):
    return [ln for ln in lines if "healing attempt" in ln or "still quarantined" in ln]


def phase_heal(device):
    """The tenth main path: ``fit_batched``'s healing ladder on the Tayal
    batch (hard gate, Gibbs 100 + 300, chunks of 64): a clean run; a
    dispatch-level fault on one series of the second chunk, healed, every
    other series bitwise the clean run's; the same fault sticky under
    ``RetryPolicy(max_heal_attempts=2)``, returned with its mask down
    after both log lines; a crash after one chunk and a rerun from the
    cache, bitwise the clean run; and a small NUTS fit under an in-scan
    fault that fires on every dispatch, so the ladder escalates to its
    end. Launches: ``FWD`` and ``BWD_SAMPLE`` once a sweep a dispatch,
    ``FWD`` and ``VG_BWD`` once a value-and-grad call; the first launch
    of each kernel at each shape of the heal re-dispatches bitwise
    against its plain version."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode="hard")
    cfg = GibbsConfig(num_warmup=WARMUP, num_samples=SAMPLES, num_chains=1)
    heal_calls = {}
    real_heal = fit_module._heal

    def recorded_heal(*args, **kw):  # the re-dispatches' launches
        with LaneRecorder() as r:
            out = real_heal(*args, **kw)
        for key, val in r.calls.items():
            heal_calls.setdefault(key, val)
        return out

    def fit(plan=None, **kw):
        sync()
        t0 = time.perf_counter()
        with StderrLines() as log, (faults.inject(plan) if plan is not None
                                    else contextlib.nullcontext()):
            qs, st = fit_batched(model, data, cfg, chunk_size=HEAL_CHUNK, seed=SEED_SAMPLER,
                                 device=device, **kw)
        sync()
        return qs, st, log.lines, time.perf_counter() - t0

    s = HEAL_SERIES
    n_chunks = -(-N_SERIES // HEAL_CHUNK)
    label = f"chunk {s // HEAL_CHUNK + 1}/{n_chunks}"
    others = torch.arange(N_SERIES, device=device) != s
    before = launch_counts()
    report = {}
    with mock.patch.object(fit_module, "_heal", side_effect=recorded_heal):
        clean, st0, _, report["clean_s"] = fit()
        if not bool(st0["chain_healthy"].all()):
            raise AssertionError("heal: the clean run has a quarantined chain")
        plan = FaultPlan(kind="unhealthy_result", series=s, chain=0, step=3)
        qs, st, lines, report["healed_s"] = fit(plan)
        if not bool(st["chain_healthy"].all()):
            raise AssertionError("heal: the faulted series was not healed")
        if not torch.equal(qs[others], clean[others]):
            raise AssertionError("heal: a healthy series' draws moved")
        if not bool(torch.isfinite(qs[s]).all()) or torch.equal(qs[s], clean[s]):
            raise AssertionError("heal: the healed series is not a fresh finite dispatch")
        report["healed_lines"] = ladder_lines(lines)
        if report["healed_lines"] != [f"# fit_batched {label}: healing attempt 1/3 for 1 "
                                      "quarantined series"]:
            raise AssertionError(f"heal: log lines {report['healed_lines']}")
        sticky = FaultPlan(kind="unhealthy_result", series=s, chain=0, step=3, sticky=True)
        qs, st, lines, report["sticky_s"] = fit(sticky, retry=RetryPolicy(max_heal_attempts=2))
        healthy = st["chain_healthy"][:, 0]
        if bool(healthy[s]) or not bool(healthy[others].all()):
            raise AssertionError("heal: the sticky fault did not come back with its mask down")
        if not torch.equal(qs[others], clean[others]) or int(st["quarantine_step"][s, 0]) != 3:
            raise AssertionError("heal: the sticky run moved a healthy series or the step")
        report["sticky_lines"] = ladder_lines(lines)
        if not (any("healing attempt 2/2" in ln for ln in lines)
                and any("still quarantined after 2 healing attempts" in ln for ln in lines)):
            raise AssertionError(f"heal: sticky log lines {report['sticky_lines']}")
        with tempfile.TemporaryDirectory() as d:
            try:
                fit(FaultPlan(crash_after_chunks=1), cache_dir=d)
                raise AssertionError("heal: no simulated crash")
            except SimulatedCrash:
                pass
            qs, st, lines, report["resumed_s"] = fit(cache_dir=d)
        if not torch.equal(qs, clean) or not any(f"chunk 1/{n_chunks}: cache hit" in ln
                                                 for ln in lines):
            raise AssertionError("heal: the resumed run is not the clean run from the cache")
        # clean, healed (+1), sticky (+2), crashed after one, resumed
        gibbs_dispatches = n_chunks + (n_chunks + 1) + (n_chunks + 2) + 1 + (n_chunks - 1)
        # NUTS: an in-scan fault on every dispatch, the escalated configs
        nuts_model = TayalHHMM()
        nuts_data = {"x": x[:HEAL_NUTS_SERIES, :HEAL_NUTS_T].contiguous(),
                     "sign": sign[:HEAL_NUTS_SERIES, :HEAL_NUTS_T].contiguous()}
        ncfg = SamplerConfig(num_warmup=HEAL_NUTS_WARMUP, num_samples=HEAL_NUTS_SAMPLES,
                             num_chains=1, max_treedepth=HEAL_NUTS_TREEDEPTH)
        ladder = []
        real_escalate = fit_module.escalate

        def spy(config, attempt, policy):
            out = real_escalate(config, attempt, policy)
            ladder.append({"attempt": attempt, "max_treedepth": out.max_treedepth,
                           "init_step_size": out.init_step_size,
                           "target_accept": out.target_accept})
            return out

        vg = VGCounter(TayalHHMM.make_vg)
        sync()
        t0 = time.perf_counter()
        with mock.patch.object(TayalHHMM, "make_vg", autospec=True, side_effect=vg), \
                mock.patch.object(fit_module, "escalate", side_effect=spy), StderrLines() as log, \
                faults.inject(FaultPlan(kind="nan_grad", step=3, chain=0, series=1)):
            _, nst = fit_batched(nuts_model, nuts_data, ncfg, chunk_size=HEAL_NUTS_SERIES,
                                 seed=SEED_SAMPLER, device=device)
        sync()
        report["nuts_s"] = time.perf_counter() - t0
    rose = rose_since(before)
    sweeps = (WARMUP + SAMPLES) * gibbs_dispatches
    want = {cs.FWD.name: sweeps + vg.calls, cs.BWD_SAMPLE.name: sweeps, cs.VG_BWD.name: vg.calls}
    if rose != want:
        raise AssertionError(f"heal: launches {rose}, expected {want}")
    nh = nst["chain_healthy"][:, 0]
    if bool(nh[1]) or not bool(nh[torch.arange(HEAL_NUTS_SERIES, device=device) != 1].all()):
        raise AssertionError(f"heal: NUTS health {nh.tolist()}, expected series 1 alone down")
    # the ladder of RetryPolicy(): step size halved from the second rung,
    # max_treedepth cut by 2, to a floor of 4, at the third
    expect = [(1, HEAL_NUTS_TREEDEPTH, 0.1), (2, HEAL_NUTS_TREEDEPTH, 0.05),
              (3, max(4, HEAL_NUTS_TREEDEPTH - 2), 0.025)]
    if [(r["attempt"], r["max_treedepth"], round(r["init_step_size"], 6)) for r in ladder] != expect:
        raise AssertionError(f"heal: NUTS ladder {ladder}")
    kernels = kept_vs_plain(heal_calls, "heal")
    emit("heal", series=N_SERIES, T=T_FIT, chunk=HEAL_CHUNK, faulted_series=s,
         gibbs_dispatches=gibbs_dispatches, **report,
         nuts=dict(series=HEAL_NUTS_SERIES, T=HEAL_NUTS_T, warmup=HEAL_NUTS_WARMUP,
                   samples=HEAL_NUTS_SAMPLES,
                   value_and_grad_calls=vg.calls, ladder=ladder,
                   lines=ladder_lines(log.lines)),
         launches=rose, heal_dispatch_kernels_vs_plain=kernels)
    return rose, kernels


def phase_chees_per_series(device, chees_phi):
    """The eleventh main path: ``fit_batched`` with
    ``ChEESConfig(shared_adaptation=False)`` at the ChEES cell (stan gate,
    2 chains, cap 16), 256 series in one chunk (512 lanes), 50 + 50: each
    series adapts its own step size and trajectory length, one
    value-and-grad call over the lanes a leapfrog (``FWD`` and ``VG_BWD``
    once each), a transition as long as its longest series. The spread of
    the step sizes and trajectory lengths, the lockstep efficiency, and
    the emission rows against the simulator's and the shared arm's fit."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    init = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    cfg = ChEESConfig(num_warmup=CPS_WARMUP, num_samples=CPS_SAMPLES, num_chains=CHAINS,
                      max_leapfrogs=CAP, shared_adaptation=False)
    vg = VGCounter(TayalHHMM.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(TayalHHMM, "make_vg", autospec=True, side_effect=vg), \
            LaneRecorder() as rec:
        qs, stats = fit_batched(model, data, cfg, init=init, chunk_size=N_SERIES,
                                seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose != {cs.FWD.name: vg.calls, cs.VG_BWD.name: vg.calls}:
        raise AssertionError(f"chees_per_series: launches {rose} for {vg.calls} calls")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("chees_per_series: an unhealthy chain or a non-finite logp")
    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= CPS_PHI_MAE_MAX:
        raise AssertionError(f"chees_per_series: phi MAE {mae.mean():.3g} > {CPS_PHI_MAE_MAX}")
    gap = np.minimum(np.abs(phi_mean - chees_phi).mean(axis=(1, 2)),
                     np.abs(phi_mean[:, MIRROR] - chees_phi).mean(axis=(1, 2)))
    eps, tau = stats["step_size"][:, 0], stats["traj_length"][:, 0]
    lock = stats["lockstep_leapfrogs"][0].float()
    transitions = CPS_WARMUP + CPS_SAMPLES
    kernels = kept_vs_plain(rec.calls, "chees_per_series")

    def spread(v):
        q = torch.quantile(v.float(), torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], device=v.device))
        return dict(zip(("min", "p10", "median", "p90", "max"), q.tolist()))

    emit("chees_per_series", series=N_SERIES, T=T_FIT, chains=CHAINS, warmup=CPS_WARMUP,
         samples=CPS_SAMPLES, cap=CAP, seconds=wall, transitions_per_s=transitions / wall,
         transition_ms=wall / transitions * 1e3, value_and_grad_calls=vg.calls,
         step_size=spread(eps), traj_length=spread(tau),
         lockstep_efficiency=float(stats["lockstep_efficiency"][0]),
         lockstep_leapfrogs=int(lock.sum()), lockstep_per_transition_mean=float(lock.mean()),
         divergent_share=float(stats["diverging"].float().mean()),
         accept_mean_sampling=float(stats["accept_prob"].mean()),
         ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
         mirror_fold_share=swap_share, phi_mae_mean=float(mae.mean()),
         phi_mae_max=float(mae.max()), phi_gap_vs_shared_chees_mean=float(gap.mean()),
         launches=rose, kernels_vs_plain=kernels)
    return rose, kernels


def rep_ticks(x, sign):
    """Leg spans and a tick price path for one series of ``tayal_batch``
    (which has no ticks): every leg ``REP_LEG_TICKS`` ticks, the price
    moving linearly across a leg by ``0.01 * (1 + x)`` in the leg's
    direction."""
    x, sign = x.cpu().numpy(), sign.cpu().numpy()
    T = len(x)
    leg_start = np.arange(T) * REP_LEG_TICKS
    leg_end = leg_start + REP_LEG_TICKS
    moves = np.where(sign == 0, 1.0, -1.0) * 0.01 * (1.0 + x)
    levels = 100.0 + np.concatenate([[0.0], np.cumsum(moves)])
    price = np.interp(np.arange(T * REP_LEG_TICKS + 1), np.append(leg_start, leg_end[-1]), levels)
    return leg_start, leg_end, price.astype(np.float32)


def phase_replication(device, chees_qs):
    """The twelfth main path: the replication protocol's diagnostics on
    the stan-gate ChEES draws of series 0 (2 chains x 150), on the card:
    ``chain_marginal_ll`` + ``ml_weighted_pool``,
    ``degenerate_mode_probe`` on the last draw and
    ``per_draw_relabel_stats`` on every draw, their FFBS paths by the
    Gumbel-max scan on the time-varying ``log_A`` (no kernel launches);
    then the relabel statistics of the first ``REP_CPU_DRAWS`` draws on
    the card against the same call on the CPU with the same noise."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x[0], "sign": sign[0]}
    model = TayalHHMM()
    leg_start, leg_end, price = rep_ticks(x[0], sign[0])
    draws = chees_qs[0].reshape(-1, model.n_free)
    C = chees_qs.shape[1]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_SAMPLER)
    before = launch_counts()
    secs = {}
    sync()
    t0 = time.perf_counter()
    mll = replication.chain_marginal_ll(model, chees_qs[0].cpu().numpy(), data, device=device)
    sync()
    secs["chain_marginal_ll"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = replication.degenerate_mode_probe(model, draws[-1], data, gen, device=device)
    sync()
    secs["degenerate_mode_probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rel = replication.per_draw_relabel_stats(model, draws, data, leg_start, leg_end, price,
                                             generator=gen, device=device)
    sync()
    secs["per_draw_relabel_stats"] = time.perf_counter() - t0
    pooled = replication.ml_weighted_pool(
        {k: rel[k].reshape(C, -1).mean(1) for k in ("phi_45", "phi_25")}, mll)
    rose = rose_since(before)
    if rose:
        raise AssertionError(f"replication: launched {rose}; the Gumbel route runs no kernel")
    for k in ("phi_45", "phi_25", "ll"):
        if not np.isfinite(rel[k]).all():
            raise AssertionError(f"replication: non-finite {k}")
    # the card against the CPU on the same draws and noise
    n = REP_CPU_DRAWS
    noise = gumbel(gen, (n, T_FIT, model.K))
    card = replication.per_draw_relabel_stats(model, draws[:n], data, leg_start, leg_end, price,
                                              noise=noise, device=device)
    cpu = replication.per_draw_relabel_stats(
        model, draws[:n].cpu(), {k: v.cpu() for k, v in data.items()}, leg_start, leg_end, price,
        noise=noise.cpu(), device="cpu")
    same = card["swapped"] == cpu["swapped"]
    ll_err = float(np.abs(card["ll"] - cpu["ll"]).max() / np.abs(cpu["ll"]).max())
    # phi comes from each device's own unpack (exp, log-sigmoid): equal
    # within f32 rounding, not bitwise
    if same.mean() < (n - 1) / n or ll_err > 1e-5 or not np.allclose(
            card["phi_45"][same], cpu["phi_45"][same], rtol=1e-5, atol=1e-7):
        raise AssertionError(f"replication: card vs CPU swapped agree {same.mean()}, "
                             f"ll rel err {ll_err:.3g}")
    emit("replication", series=0, draws=int(draws.shape[0]), T=T_FIT, seconds=secs,
         chain_marginal_ll=mll.tolist(), pool=pooled, degenerate_mode_probe=probe,
         phi_45_mean=float(rel["phi_45"].mean()), phi_25_mean=float(rel["phi_25"].mean()),
         swapped_share=float(rel["swapped"].mean()),
         cpu_check=dict(draws=n, swapped_agree=float(same.mean()), ll_rel_err=ll_err),
         launches=rose)


# ---------------------------------------------------------------------------
# main paths 13-14: the IOHMMs and the Hassan walk-forward forecaster
# ---------------------------------------------------------------------------


def io_batch(kind, device):
    """``(data, truth)``: ``IO_SERIES`` series of the reference script's
    configuration ``kind`` (``"reg"`` or ``"hmix"``), simulated on the
    card by ``iohmm_sim``, series i from seed ``SEED_IO + i`` (its inputs,
    weights and emissions as ``examples/iohmm_main.py`` draws them)."""
    xs, us, zs, truth = [], [], [], []
    for i in range(IO_SERIES):
        rng = np.random.default_rng(SEED_IO + i)
        K = IO_K_REG if kind == "reg" else IO_K_MIX
        u = np.column_stack([np.ones(IO_T), rng.normal(size=(IO_T, IO_M - 1))])
        w = rng.normal(size=(K, IO_M)) * 1.5
        if kind == "reg":
            b = rng.normal(size=(K, IO_M)) * 2.0
            obs, t = obsmodel_reg(b, np.full(K, 0.4)), {"b_km": b, "s_k": np.full(K, 0.4)}
        else:
            lam = rng.dirichlet(np.ones(IO_L), size=K)
            mu = np.sort(rng.normal(size=(K, IO_L)) * 3.0, axis=1) + np.arange(K)[:, None] * 4.0
            obs, t = obsmodel_mix(lam, mu, np.full((K, IO_L), 0.5)), {"mu_kl": mu}
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED_IO + i)
        sim = iohmm_sim(gen, u, w, obs)
        xs.append(sim["x"])
        us.append(sim["u"])
        zs.append(sim["z"])
        truth.append(t)
    return {"x": torch.stack(xs), "u": torch.stack(us)}, torch.stack(zs), truth


def reg_errors(post, truth):
    """Per series, after matching intercepts (the permutation of the
    fitted states nearest the true intercepts, over all K!), the largest
    absolute error of the posterior-mean ``b_km`` and of ``s_k``."""
    b_hat = post["b_km"].mean((1, 2)).cpu().numpy()
    s_hat = post["s_k"].mean((1, 2)).cpu().numpy()
    eb, es = [], []
    for i, t in enumerate(truth):
        perm = min(itertools.permutations(range(IO_K_REG)),
                   key=lambda p: np.abs(b_hat[i][list(p), 0] - t["b_km"][:, 0]).sum())
        eb.append(float(np.abs(b_hat[i][list(perm)] - t["b_km"]).max()))
        es.append(float(np.abs(s_hat[i][list(perm)] - t["s_k"]).max()))
    return np.asarray(eb), np.asarray(es)


def io_fit(name, model, data, device):
    """``fit_batched`` NUTS on the batch in one chunk: the launches
    (``FWD`` and ``VG_BWD`` once a value-and-grad call, nothing else),
    health, the divergent share, the lockstep cost."""
    cls = type(model)
    init = default_init(model, data, IO_SERIES, 1, seed=SEED_IO, device=device)
    cfg = SamplerConfig(num_warmup=IO_WARMUP, num_samples=IO_SAMPLES, num_chains=1,
                        max_treedepth=IO_TREEDEPTH)
    vg = VGCounter(cls.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(cls, "make_vg", autospec=True, side_effect=vg):
        qs, stats = fit_batched(model, data, cfg, init=init, chunk_size=IO_SERIES,
                                seed=SEED_IO, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose != {cs.FWD.name: vg.calls, cs.VG_BWD.name: vg.calls}:
        raise AssertionError(f"iohmm {name}: launches {rose} for {vg.calls} value-and-grad calls")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError(f"iohmm {name}: an unhealthy chain or a non-finite logp")
    if tuple(qs.shape) != (IO_SERIES, 1, IO_SAMPLES, model.n_free):
        raise AssertionError(f"iohmm {name}: qs shape {tuple(qs.shape)}")
    div_share = float(stats["diverging"].float().mean())
    if not div_share <= IO_DIV_MAX:
        raise AssertionError(f"iohmm {name}: divergent share {div_share:.3g} (limit {IO_DIV_MAX})")
    eps = stats["step_size"].reshape(-1)
    transitions = IO_WARMUP + IO_SAMPLES
    row = dict(model=name, K=model.K, M=model.M, trans_mode=model.trans_mode, series=IO_SERIES,
               T=IO_T, chains=1, warmup=IO_WARMUP, samples=IO_SAMPLES,
               max_treedepth=IO_TREEDEPTH, seconds=wall, transitions_per_s=transitions / wall,
               value_and_grad_calls=vg.calls, **lockstep(stats),
               step_size=dict(min=float(eps.min()), median=float(eps.median()),
                              max=float(eps.max())),
               divergent_share=div_share, launches=rose, logp_mean=float(stats["logp"].mean()))
    return qs, row


def io_outputs(name, model, qs, data, z_true, device):
    """``IO_DRAWS`` draws a series through the time-varying decode
    (``generated`` for IOHMM-reg, ``IOHMMHMixLite.generated`` for the
    mixture) and as many ``state_draws`` (the Gumbel route): no kernel
    launched, every output finite; for IOHMM-reg the Viterbi accuracy
    of the per-step mode over draws against the simulated states after
    ``greedy_relabel``."""
    draws = thin(qs[:, 0], IO_DRAWS)
    row = {}
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    if name == "reg":
        out = model.generated(draws, data, device=device)
        check_probabilities(f"iohmm {name}", out, "alpha")
        check_probabilities(f"iohmm {name}", out, "gamma")
    else:
        lite = IOHMMHMixLite(model.K, model.M, model.L, model.hyperparams, model.trans_mode)
        out = lite.generated(draws, data, device=device)
        if tuple(out["oblik_t"].shape) != (IO_SERIES, IO_DRAWS, IO_T):
            raise AssertionError(f"iohmm {name}: oblik_t shape {tuple(out['oblik_t'].shape)}")
    sync()
    row["decode_seconds"] = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v.float()).all()) for v in out.values()):
        raise AssertionError(f"iohmm {name}: a non-finite generated quantity")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_IO)
    sync()
    t0 = time.perf_counter()
    zs = model.state_draws(gen, draws, data, device=device)
    sync()
    row["state_draws_seconds"] = time.perf_counter() - t0
    rose = rose_since(before)
    if rose:  # the time-varying log_A runs the scans
        raise AssertionError(f"iohmm {name}: the time-varying decode launched {rose}")
    if tuple(zs.shape) != (IO_SERIES, IO_DRAWS, IO_T) or not bool(
            ((zs >= 0) & (zs < model.K)).all()):
        raise AssertionError(f"iohmm {name}: state_draws {tuple(zs.shape)} out of range")
    row["decode_lanes"] = IO_SERIES * IO_DRAWS
    zt = z_true.cpu().numpy()
    for key, path in (("viterbi", out.get("zstar")), ("state_draws", zs)):
        if path is None:
            continue
        z_hat = torch.mode(path, dim=1).values.cpu().numpy()
        acc = [float((greedy_relabel(zt[b], z_hat[b], model.K)[z_hat[b]] == zt[b]).mean())
               for b in range(IO_SERIES)]
        row[f"{key}_accuracy_mean"] = float(np.mean(acc))
        row[f"{key}_accuracy_median"] = float(np.median(acc))
    return row


def iohmm_task(name, device):
    """One IOHMM configuration of the thirteenth main path (``"reg"``:
    IOHMM-reg in stan mode; ``"hmix"``: the hierarchical mixture) on
    ``IO_SERIES`` simulated series: ``fit_batched`` NUTS (every leapfrog
    one folded value-and-grad call, ``FWD`` + ``VG_BWD`` ungated at K=3
    or 4), then the time-varying decode and state draws. Gates: for
    IOHMM-reg the posterior-mean ``b_km`` and ``s_k`` on the median
    series within ``IO_B_ATOL`` / ``IO_S_ATOL``; every output finite, the
    divergent share at most ``IO_DIV_MAX``. Returns the phase line's
    fields and ``(model, data, last draws)`` for :func:`vg_ms_alone`."""
    data, z, truth = io_batch(name, device)
    if name == "reg":
        model = IOHMMReg(K=IO_K_REG, M=IO_M)
    else:
        model = IOHMMHMix(K=IO_K_MIX, M=IO_M, L=IO_L, hyperparams=DEFAULT_HYPERPARAMS)
    qs, row = io_fit(name, model, data, device)
    if name == "reg":
        eb, es = reg_errors(model.constrained_draws(qs), truth)
        row.update(b_err_median=float(np.median(eb)), s_err_median=float(np.median(es)),
                   b_err_max=float(eb.max()), s_err_max=float(es.max()),
                   b_within_share=float((eb <= IO_B_ATOL).mean()))
        if not (np.median(eb) <= IO_B_ATOL and np.median(es) <= IO_S_ATOL):
            raise AssertionError(f"iohmm reg: median-series b error {np.median(eb):.3g} (bound "
                                 f"{IO_B_ATOL}), s error {np.median(es):.3g} (bound {IO_S_ATOL})")
    else:
        mu_hat = model.constrained_draws(qs)["mu_kl"].mean((1, 2)).cpu().numpy()
        mu_err = [float(np.abs(np.sort(mu_hat[i].ravel()) - np.sort(t["mu_kl"].ravel())).mean())
                  for i, t in enumerate(truth)]
        row["mu_sorted_mae_median"] = float(np.median(mu_err))
    row.update(io_outputs(name, model, qs, data, z, device))
    return row, (model, data, qs[:, :, -1].contiguous())


class Timed:
    """Wraps a function of ``wf.py`` for a ``with`` block: its host
    seconds (synchronized around each call), its calls, and the
    value-and-grad calls (``vg``) made inside it."""

    def __init__(self, module, name, vg):
        self.module, self.name, self.vg = module, name, vg
        self.seconds, self.calls, self.vg_calls, self.out = 0.0, 0, 0, None

    def __enter__(self):
        fn = getattr(self.module, self.name)

        def timed(*args, **kw):
            sync()
            t0, c0 = time.perf_counter(), self.vg.calls
            self.out = fn(*args, **kw)
            sync()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.vg_calls += self.vg.calls - c0
            return self.out

        self.patch = mock.patch.object(self.module, self.name, timed)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()


def hassan_task(name, device):
    """One benchmark of the fourteenth main path: ``wf_forecast`` on the
    frozen synthetic benchmark ``name`` of ``examples/hassan_replication.
    py``: the pilot (``sample`` on step 0's data), the batched fit of the
    30 steps and the batched forecast step, each timed; ``FWD`` and
    ``VG_BWD`` once a value-and-grad call (pilot and fit), the forecast
    step none. Gates (``HS_GATES``, ``HS_DIV_MAX``) on the errors and the
    divergence rate, beside the JAX record's at 300 + 300. Returns the
    phase line's fields and ``(model, data of the 30 steps, last draws)``
    for :func:`vg_ms_alone`."""
    record = json.loads((Path(__file__).resolve().parent / HS_RECORD).read_text())
    spec = HS_BENCHMARKS[name]
    ohlc = simulate_ohlc(np.random.default_rng(spec["seed"]), T=spec["T"], vol=spec["vol"],
                         regimes=spec["regimes"], drift_spread=spec["drift_spread"])
    cfg = SamplerConfig(num_warmup=HS_WARMUP, num_samples=HS_SAMPLES, num_chains=1,
                        max_treedepth=HS_TREEDEPTH)
    vg = VGCounter(IOHMMHMixLite.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(IOHMMHMixLite, "make_vg", autospec=True, side_effect=vg), \
            Timed(hassan_wf, "sample", vg) as pilot, \
            Timed(hassan_wf, "fit_batched", vg) as fit, \
            Timed(hassan_wf, "step_forecasts", vg) as fc:
        res = wf_forecast(ohlc, spec["train_len"], K=HS_K, L=HS_L, config=cfg,
                          seed=spec["seed"], device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose != {cs.FWD.name: vg.calls, cs.VG_BWD.name: vg.calls} or fc.vg_calls:
        raise AssertionError(f"hassan {name}: launches {rose} for {vg.calls} "
                             f"value-and-grad calls ({fc.vg_calls} in the forecast)")
    S = spec["T"] - spec["train_len"]
    if (res.forecasts.shape[0], res.point.shape, pilot.calls, fit.calls) != (
            S, (S,), 1, 1) or not np.isfinite(res.forecasts).all():
        raise AssertionError(f"hassan {name}: forecasts {res.forecasts.shape}, "
                             f"finite {np.isfinite(res.forecasts).all()}")
    stats = fit.out[1]
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError(f"hassan {name}: an unhealthy chain")
    # the fit's value-and-grad call: the steps' lanes at the last draws
    x_pad, u_pad, mask = hassan_wf.pad_steps(hassan_wf.step_datasets(ohlc, spec["train_len"]))
    data = {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in (("x", x_pad), ("u", u_pad), ("mask", mask))}
    vg_in = (IOHMMHMixLite(HS_K, 4, HS_L, DEFAULT_HYPERPARAMS), data,
             fit.out[0][:, :, -1].contiguous())
    e, div = res.errors, float(res.diverged.mean())
    jax_rec = record["benchmarks"][name]
    g = HS_GATES[name]
    if not (e["mape"] <= g["mape_max"] and (g["r2_min"] is None or e["r2"] >= g["r2_min"])
            and div <= HS_DIV_MAX):
        raise AssertionError(f"hassan {name}: MAPE {e['mape']:.3g} %, R² {e['r2']:.4g}, "
                             f"divergence rate {div:.3g} against the gates {g}")
    return dict(
        benchmark=name, steps=S, T_max=spec["T"] - 2, train_len=spec["train_len"], K=HS_K,
        L=HS_L, warmup=HS_WARMUP, samples=HS_SAMPLES, max_treedepth=HS_TREEDEPTH,
        seconds=wall, pilot_seconds=pilot.seconds, fit_seconds=fit.seconds,
        forecast_seconds=fc.seconds, pilot_value_and_grad_calls=pilot.vg_calls,
        fit_value_and_grad_calls=fit.vg_calls, **lockstep(stats), launches=rose, mse=e["mse"],
        mape_pct=e["mape"], r2=e["r2"], divergence_rate=div,
        jax_record=dict(mse=jax_rec["mse"], mape_pct=jax_rec["mape_pct"], r2=jax_rec["r2"],
                        divergence_rate=jax_rec["divergence_rate"],
                        warmup=record["config"]["warmup"], samples=record["config"]["samples"]),
        gates=dict(g, divergence_max=HS_DIV_MAX)), vg_in


# ---------------------------------------------------------------------------
# main paths 15-16: the tree HHMM (the 63-leaf Jangmin market tree)
# ---------------------------------------------------------------------------


def markets(n, T, seed0):
    """``(data, regimes)``: ``n`` markets of ``simulate_market(T)``,
    market i from ``np.random.default_rng(seed0 + i)``; ``data`` holds
    the returns ``x [n, T]`` (float32) and the true regime labels ``g``
    (the semi-supervision), ``regimes [n, T]`` the same labels."""
    ms = [simulate_market(T, np.random.default_rng(seed0 + i)) for i in range(n)]
    g = np.stack([m["regime"] for m in ms])
    return {"x": np.stack([m["x"] for m in ms]).astype(np.float32), "g": g}, g


def jangmin_model(gate_mode="hard", semisup=True):
    return TreeHMM(jangmin2004_tree(), semisup=semisup, gate_mode=gate_mode, order_mu="none")


def tree_gibbs_task(name, device):
    """The fifteenth main path (``tree_gibbs``): the route-augmented
    Gibbs sampler of ``tests/test_routes.py::
    test_jangmin_single_chain_ess`` at full width, batched:
    ``fit_batched`` Gibbs ``TG_WARMUP + TG_SAMPLES`` on ``TG_MARKETS``
    markets in one chunk (hard gate: ``FWD`` + ``BWD_SAMPLE`` ungated at
    K=63 once a sweep), then ``TG_STAN_WARMUP + TG_STAN_SAMPLES`` in the
    stan gate on ``TG_STAN_MARKETS`` of them (the gated pair through the
    gate keys). Gates: every chain healthy and every logp finite; over
    the markets the median ESS(lp) at least ``TG_ESS_MIN`` and the median
    split-R̂(lp) under ``TG_RHAT_MAX``. Returns the phase line's fields
    and no value-and-grad inputs."""
    data, _ = markets(TG_MARKETS, TG_T, 0)
    row = {}
    for gate, n, warm, samp in (("hard", TG_MARKETS, TG_WARMUP, TG_SAMPLES),
                                ("stan", TG_STAN_MARKETS, TG_STAN_WARMUP, TG_STAN_SAMPLES)):
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        qs, stats = fit_batched(jangmin_model(gate), {k: v[:n] for k, v in data.items()},
                                GibbsConfig(warm, samp, 1), chunk_size=n, seed=SEED_TREE,
                                device=device)
        sync()
        wall = time.perf_counter() - t0
        sweeps = warm + samp
        rose = rose_since(before)
        if rose != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
            raise AssertionError(f"tree_gibbs {gate}: launches {rose} for {sweeps} sweeps")
        if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()) \
                or not bool(torch.isfinite(qs).all()):
            raise AssertionError(f"tree_gibbs {gate}: an unhealthy chain or a non-finite draw")
        row[gate] = dict(markets=n, T=TG_T, warmup=warm, samples=samp, seconds=wall,
                         sweep_ms=wall / sweeps * 1e3, launches=rose)
        if gate == "hard":  # ESS and split-R-hat of lp, per market
            lp = stats["logp"].cpu().numpy().astype(np.float64)  # [markets, 1, samples]
            e, r = ess_many(lp), split_rhat_many(lp)
            row[gate].update(ess_lp_median=float(np.median(e)), ess_lp_min=float(e.min()),
                             rhat_lp_median=float(np.median(r)), rhat_lp_max=float(r.max()))
            if not (np.median(e) >= TG_ESS_MIN and np.median(r) < TG_RHAT_MAX):
                raise AssertionError(f"tree_gibbs: median ESS(lp) {np.median(e):.3g} (bound "
                                     f"{TG_ESS_MIN}), median split-R-hat {np.median(r):.4g} "
                                     f"(bound {TG_RHAT_MAX})")
    return row, None


def jangmin_task(name, device):
    """The sixteenth main path (``jangmin``): the semi-supervised NUTS
    fit of ``tests/test_jangmin_app.py::test_semisup_fit_recovers_
    regimes`` at full width, batched: ``fit_batched`` NUTS on
    ``JM_MARKETS`` markets of T=``JM_T`` in one chunk (hard gate, one
    chain, ``JM_WARMUP + JM_SAMPLES`` at ``max_treedepth`` ``JM_TREEDEPTH``:
    ``FWD`` + ``VG_BWD`` at K=63 once a value-and-grad call), then the
    ungated twin's decode of ``JM_DRAWS`` thinned draws a market in one
    ``generated`` call (``FILTER``, ``BETA``, ``VITERBI``, ``BACKTRACK``
    once each on 3,200 lanes), the true-parameter oracle's decode (one
    more call), and ``fit_market`` once on market 0 at ``JM_APP_WARMUP +
    JM_APP_SAMPLES``. Gates: divergent share under ``JM_DIV_MAX``, every
    output finite, the mean accuracy above the mean majority-class rate,
    the median of (accuracy - oracle accuracy) at least
    ``JM_ORACLE_GAP``; ``fit_market`` finite with a divergent share under
    ``JM_DIV_MAX``. Returns the phase line's fields and ``(model, data,
    last draws)`` for :func:`vg_ms_alone`."""
    data, regimes = markets(JM_MARKETS, JM_T, SEED_TREE)
    model = jangmin_model()
    cfg = SamplerConfig(num_warmup=JM_WARMUP, num_samples=JM_SAMPLES, num_chains=1,
                        max_treedepth=JM_TREEDEPTH)
    vg = VGCounter(TreeHMM.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(TreeHMM, "make_vg", autospec=True, side_effect=vg):
        qs, stats = fit_batched(model, data, cfg, chunk_size=JM_MARKETS, seed=SEED_TREE,
                                device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose != {cs.FWD.name: vg.calls, cs.VG_BWD.name: vg.calls}:
        raise AssertionError(f"jangmin: launches {rose} for {vg.calls} value-and-grad calls")
    div_share = float(stats["diverging"].float().mean())
    if not (bool(stats["chain_healthy"].all()) and bool(torch.isfinite(qs).all())
            and bool(torch.isfinite(stats["logp"]).all())):
        raise AssertionError("jangmin: an unhealthy chain or a non-finite draw")
    if not div_share < JM_DIV_MAX:
        raise AssertionError(f"jangmin: divergent share {div_share:.3g} (limit {JM_DIV_MAX})")
    eps = stats["step_size"].reshape(-1)
    row = dict(markets=JM_MARKETS, T=JM_T, K=model.K, n_free=model.n_free, chains=1,
               warmup=JM_WARMUP, samples=JM_SAMPLES, max_treedepth=JM_TREEDEPTH, seconds=wall,
               seconds_a_market=wall / JM_MARKETS, value_and_grad_calls=vg.calls,
               **lockstep(stats), divergent_share=div_share,
               step_size=dict(min=float(eps.min()), median=float(eps.median()),
                              max=float(eps.max())), launches=rose)

    # the unsupervised decode through the ungated twin, and the oracle's
    twin = jangmin_model(semisup=False)
    x = torch.as_tensor(data["x"], device=device)
    draws = qs[:, 0, :: max(1, JM_SAMPLES // JM_DRAWS)]
    theta_true = twin.pack({k: torch.as_tensor(v, dtype=torch.float32, device=device)
                            for k, v in twin.spec_params().items()})
    groups = np.asarray(twin.groups)
    acc, row["launches_decode"] = {}, {}
    for key, theta in (("fit", draws), ("oracle", theta_true.expand(JM_MARKETS, 1, -1))):
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        out = twin.generated(theta, {"x": x}, device=device)
        sync()
        row[f"decode_seconds_{key}"] = time.perf_counter() - t0
        rose = rose_since(before)
        if rose != {k.name: 1 for k in DECODE_KERNELS}:
            raise AssertionError(f"jangmin decode ({key}): launches {rose}")
        for k, v in rose.items():
            row["launches_decode"][k] = row["launches_decode"].get(k, 0) + v
        if not all(bool(torch.isfinite(v.float()).all()) for v in out.values()):
            raise AssertionError(f"jangmin decode ({key}): a non-finite generated quantity")
        hat = _regime_decode(out["gamma"].mean(1).cpu().numpy(), groups)
        acc[key] = (hat == regimes).mean(1)
        del out
    row["decode_lanes"] = int(draws.shape[0] * draws.shape[1])
    majority = np.asarray([np.bincount(r).max() / JM_T for r in regimes])
    gap = acc["fit"] - acc["oracle"]
    row.update(accuracy_mean=float(acc["fit"].mean()), accuracy_median=float(np.median(acc["fit"])),
               oracle_accuracy_mean=float(acc["oracle"].mean()),
               majority_rate_mean=float(majority.mean()), gap_median=float(np.median(gap)),
               gap_min=float(gap.min()))
    if not (acc["fit"].mean() > majority.mean() and np.median(gap) >= JM_ORACLE_GAP):
        raise AssertionError(f"jangmin: accuracy {acc['fit'].mean():.3g} (majority rate "
                             f"{majority.mean():.3g}), median gap to the oracle "
                             f"{np.median(gap):.3g} (bound {JM_ORACLE_GAP})")

    # the app's entry point once, on market 0
    app_cfg = SamplerConfig(num_warmup=JM_APP_WARMUP, num_samples=JM_APP_SAMPLES, num_chains=1,
                            max_treedepth=JM_TREEDEPTH)
    vg_app = VGCounter(TreeHMM.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(TreeHMM, "make_vg", autospec=True, side_effect=vg_app):
        fit = fit_market(data["x"][0], data["g"][0], app_cfg, seed=SEED_TREE,
                         regime_true=regimes[0], device=device)
    sync()
    app = dict(seconds=time.perf_counter() - t0, value_and_grad_calls=vg_app.calls,
               launches=rose_since(before), accuracy=fit.accuracy,
               divergent_share=float(fit.stats["diverging"].float().mean()))
    want = {cs.FWD.name: vg_app.calls, cs.VG_BWD.name: vg_app.calls,
            **{k.name: 1 for k in DECODE_KERNELS}}
    if app["launches"] != want:
        raise AssertionError(f"jangmin fit_market: launches {app['launches']}, want {want}")
    if not (bool(torch.isfinite(fit.samples).all()) and app["divergent_share"] < JM_DIV_MAX
            and fit.regime_hat.shape == (JM_T,)):
        raise AssertionError(f"jangmin fit_market: non-finite samples or divergent share "
                             f"{app['divergent_share']:.3g}")
    row["fit_market"] = app
    return row, (model, {k: torch.as_tensor(v) for k, v in data.items()},
                 qs[:, :, -1].contiguous())


class OpCount(TorchDispatchMode):
    """Counts the torch ops dispatched inside a ``with`` block (views
    included)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def assemble_cost(model, q, device) -> dict:
    """``TreeHMM.assemble`` alone at the draws ``q [N, 1, n_free]``: the
    torch ops of one forward and of its backward, and ms a forward +
    backward on the host clock (one warm call, then 20 synchronized
    ones)."""
    params, _ = model.unpack(q.to(device))
    rows = params.slots.detach().requires_grad_(True)

    def call():
        pi, A = model._expansion(rows)
        return torch.autograd.grad(pi.sum() + A.sum(), rows)

    call()
    with OpCount() as fwd:
        pi, A = model._expansion(rows)
    loss = pi.sum() + A.sum()
    with OpCount() as bwd:
        torch.autograd.grad(loss, rows)
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    sync()
    return dict(ops_forward=fwd.n, ops_backward=bwd.n, ms=(time.perf_counter() - t0) / 20 * 1e3,
                lanes=int(rows.shape[0] * rows.shape[1]))


# ---------------------------------------------------------------------------
# main paths 17-22: the explicit-duration HSMMs
# ---------------------------------------------------------------------------


def hsmm_batch(seed, B, T, A, dur, device, mu=None, sigma=None, phi=None):
    """``(z [B, T]`` regime paths, ``x [B, T])`` by ``hsmm_sim`` on a CPU
    generator seeded ``seed`` (uniform initial regime), on ``device``:
    Gaussian emissions, or categorical ones from the rows of ``phi``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    obs = obsmodel_gaussian(mu, sigma) if phi is None else obsmodel_categorical(phi)
    z, x = hsmm_sim(gen, T, A, dur, np.ones(len(A)) / len(A), obs, batch=(B,))
    return z.to(device), x.to(device)


def hsmm_gibbs(name, model, data, warmup, samples, seed, device):
    """``fit_batched`` Gibbs in one chunk, one chain, of an HSMM or (in
    ``hsmm_recovery``) the geometric HMM, from ``default_init`` (timed
    apart: a k-means a series on the host for the Gaussian models):
    ``(qs [B, 1, S, D], fields)``; ``FWD`` and ``BWD_SAMPLE`` exactly once
    a sweep, every chain healthy, every logp finite."""
    B = data["x"].shape[0]
    t0 = time.perf_counter()
    init = default_init(model, data, B, 1, seed=seed, device=device)
    init_wall = time.perf_counter() - t0
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    qs, stats = fit_batched(model, data, GibbsConfig(warmup, samples, 1), init=init,
                            chunk_size=B, seed=seed, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose, sweeps = rose_since(before), warmup + samples
    if rose != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
        raise AssertionError(f"{name}: fit launches {rose}, expected {sweeps} FWD and BWD_SAMPLE")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError(f"{name}: an unhealthy chain or a non-finite logp")
    return qs, dict(series=B, K=model.K, Dmax=getattr(model, "Dmax", 1),
                    T=int(data["x"].shape[1]), warmup=warmup, samples=samples,
                    init_seconds=init_wall, fit_seconds=wall, sweep_ms=wall / sweeps * 1e3,
                    fit_launches=rose)


def host_ms(fn, reps: int = 10) -> float:
    """Synchronized host ms of a call, one warm call first, the processes
    beside this one stopped (:func:`quiet`)."""
    with quiet():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3


def sweep_split(model, q, data, device) -> dict:
    """Host ms of the three parts of a Gibbs sweep on the fit's lanes at
    the draws ``q [B, D]``: ``unpack`` + ``build`` (the count-down
    expansion), the FFBS pair (``ffbs_dispatch``) and ``gibbs_update``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params, _ = model.unpack(q)
    terms = model.build(params, data)
    z, _ = td.ffbs_dispatch(gen, *terms)
    return dict(build_ms=host_ms(lambda: model.build(model.unpack(q)[0], data)),
                ffbs_ms=host_ms(lambda: td.ffbs_dispatch(gen, *terms)),
                update_ms=host_ms(lambda: model.gibbs_update(gen, z, data, params)))


def pair_ms(kernels, names, N, T):
    """Sum of the kept launches' ms of ``names`` at ``(N, T)``."""
    return sum(k["ms"] for k in kernels if k["kernel"] in names and k["N"] == N and k["T"] == T)


def phase_hsmm(device):
    """Main path 17, the ``bench_zoo.py`` HSMM arm on 256 series: the
    Gibbs fit (``FWD`` + ``BWD_SAMPLE`` at K'=12 once a sweep), then
    ``generated`` (each decode kernel once) and ``state_draws`` (the FFBS
    pair once) on 32 draws a series; every fit finite. Reports the
    posterior-mean mu and duration rows against the truth, the collapsed
    Viterbi accuracy and the split of a sweep. Returns the path's
    launches and its first launches at each shape against the plain
    versions."""
    z, x = hsmm_batch(SEED_HSMM, HSMM_SERIES, HSMM_T, HSMM_A, HSMM_DUR, device,
                      mu=HSMM_MU, sigma=HSMM_SIGMA)
    data = {"x": x}
    model = GaussianHSMM(HSMM_K, HSMM_DMAX, nig_prior=NIGPrior(**G_PRIOR))
    reset_all()
    with LaneRecorder(decode=True) as rec:
        qs, row = hsmm_gibbs("hsmm", model, data, HSMM_WARMUP, HSMM_SAMPLES, SEED_HSMM, device)
        draws = thin(qs[:, 0], HSMM_DRAWS)
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        out = model.generated(draws, data, device=device)
        sync()
        gen_wall = time.perf_counter() - t0
        rose_gen = rose_since(before)
        check_decode_once("hsmm", rose_gen)
        gen_z = torch.Generator(device=device)
        gen_z.manual_seed(SEED_HSMM + 1)
        before = launch_counts()
        zs = model.state_draws(gen_z, draws, data, device=device)
        sync()
        rose_sd = rose_since(before)
    launches = launch_counts()
    if rose_sd != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
        raise AssertionError(f"hsmm: state_draws launched {rose_sd}")
    dev = {k: check_probabilities("hsmm", out, k) for k in ("alpha", "gamma")}
    if not (int(zs.min()) >= 0 and int(zs.max()) < model.n_states):
        raise AssertionError("hsmm: a state draw outside the expanded chain")
    cons = model.constrained_draws(qs[:, 0])
    mu_err = (cons["mu_k"].mean(1) - torch.tensor(HSMM_MU, device=device)).abs().max(-1).values
    dur_l1 = (cons["dur_kd"].mean(1) - torch.tensor(HSMM_DUR, device=device)).abs().sum(-1)
    acc = (model.regime_path(out["zstar"]) == z[:, None]).float().mean(-1)  # [B, D]
    split = sweep_split(model, qs[:, 0, -1], data, device)
    kernels = kept_vs_plain(rec.calls, "hsmm")
    pair = pair_ms(kernels, (cs.FWD.name, cs.BWD_SAMPLE.name), HSMM_SERIES, HSMM_T)
    emit("hsmm", **row, draws_per_series=HSMM_DRAWS, generated_seconds=gen_wall,
         launches=dict(fit=row.pop("fit_launches"), generated=rose_gen, state_draws=rose_sd),
         row_sum_max_dev=dev, mu_err_max_mean=float(mu_err.mean()),
         dur_l1_mean=[float(v) for v in dur_l1.mean(0)],
         regime_accuracy_median=float(acc.mean(1).median()), sweep_split=split,
         ffbs_pair_ms=pair, ffbs_share=pair / row["sweep_ms"], kernels_vs_plain=kernels)
    return launches, kernels


def phase_hsmm_dmax1(device):
    """The Dmax=1 contract on the card: ``GaussianHSMM(K=3, Dmax=1)`` and
    ``GaussianHMM(K=3)`` on the same draws (``D1_DRAWS`` random ones a
    series) of the ``hmm/main.R`` data, 256 series x T=500: the built
    terms, every output of ``generated`` (the four decode kernels) and the
    ``state_draws`` paths (the FFBS pair, same generator seed) bit for
    bit."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS)
    _, x = hmm_sim(gen, G_T, G_A, np.ones(G_K) / G_K, obsmodel_gaussian(G_MU, G_SIGMA),
                   batch=(N_SERIES,))
    data = {"x": x}
    hmm, hsmm = GaussianHMM(K=G_K), GaussianHSMM(G_K, 1)
    theta = 0.5 * torch.randn((N_SERIES, D1_DRAWS, hmm.n_free), generator=gen, device=device)
    flat = theta.reshape(-1, hmm.n_free)
    lanes = {"x": x.repeat_interleave(D1_DRAWS, 0)}
    terms = [m.build(m.unpack(flat)[0], lanes)[:3] for m in (hmm, hsmm)]
    same = {"build": all(torch.equal(a, b) for a, b in zip(*terms))}
    outs = [m.generated(theta, data, device=device) for m in (hmm, hsmm)]
    same["generated"] = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    paths = []
    for m in (hmm, hsmm):
        g = torch.Generator(device=device)
        g.manual_seed(SEED_GAUSS + 5)
        paths.append(m.state_draws(g, theta, data, device=device))
    sync()
    same["state_draws"] = torch.equal(*paths)
    launches = launch_counts()
    if not all(same.values()):
        raise AssertionError(f"hsmm_dmax1: not bitwise the GaussianHMM {same}")
    emit("hsmm_dmax1", series=N_SERIES, T=G_T, K=G_K, draws_per_series=D1_DRAWS,
         bitwise_equal=same, launches={k: v for k, v in launches.items() if v})
    return launches


def phase_hsmm_recovery(device):
    """Main path 18, ``tests/test_hsmm.py``'s recovery gate on 256 series:
    the HSMM and the geometric ``GaussianHMM`` fitted by Gibbs on the
    first ``HR_TRAIN`` steps, every ``HR_THIN``-th draw filtered over the
    whole series (one ``FILTER`` launch a model); the held-out one-step
    log-likelihood ``ll(x_{1:T}) - ll(x_{1:T_train})`` averaged over
    draws, paired per series. Gate: the pooled margin of the HSMM over
    the HMM is positive."""
    z, x = hsmm_batch(SEED_HSMM + 100, HR_SERIES, HR_T, HSMM_A, HR_DUR, device,
                      mu=HR_MU, sigma=HR_SIGMA)
    train = {"x": x[:, :HR_TRAIN].contiguous()}
    prior = NIGPrior(**G_PRIOR)
    rows, heldout = {}, {}
    reset_all()
    with LaneRecorder() as rec:
        for tag, model in (("hsmm", GaussianHSMM(HSMM_K, HSMM_DMAX, nig_prior=prior)),
                           ("hmm", GaussianHMM(HSMM_K, nig_prior=prior))):
            qs, row = hsmm_gibbs(f"hsmm_recovery {tag}", model, train, HR_WARMUP, HR_SAMPLES,
                                 SEED_HSMM + 200, device)
            draws = qs[:, 0, ::HR_THIN]
            B, D = draws.shape[:2]
            log_pi, log_A, log_obs, _ = model.build(model.unpack(draws.reshape(B * D, -1))[0],
                                                    {"x": x.repeat_interleave(D, 0)})
            before = launch_counts()
            log_alpha, ll_full = td.forward_filter_dispatch(
                log_pi, log_A, log_obs, torch.ones(log_obs.shape[:2], device=device))
            sync()
            if rose_since(before) != {cs.FILTER.name: 1}:
                raise AssertionError(f"hsmm_recovery {tag}: the filter launched "
                                     f"{rose_since(before)}")
            ll_train = torch.logsumexp(log_alpha[:, HR_TRAIN - 1], -1)
            heldout[tag] = (ll_full - ll_train).reshape(B, D).mean(1)
            row["filter_lanes"] = B * D
            rows[tag] = row
    launches = launch_counts()
    margins = heldout["hsmm"] - heldout["hmm"]
    pooled = float(margins.sum())
    kernels = kept_vs_plain(rec.calls, "hsmm_recovery")
    emit("hsmm_recovery", fits=rows, series=HR_SERIES, T=HR_T, T_train=HR_TRAIN,
         heldout_mean={k: float(v.mean()) for k, v in heldout.items()},
         pooled_margin=pooled, series_won_share=float((margins > 0).float().mean()),
         launches={k: v for k, v in launches.items() if v}, kernels_vs_plain=kernels)
    if not pooled > 0.0:
        raise AssertionError(f"hsmm_recovery: the HSMM's pooled held-out margin {pooled:.4g} "
                             "over the geometric HMM is not positive")
    return launches, kernels


def daily_dur():
    """``[HD_K, HD_DMAX]`` duration pmfs: a Gaussian bump of sd
    ``HD_DWELL_SD`` at each of ``HD_PEAKS``, cut to ``HD_DWELL_RANGE``."""
    d = np.arange(1, HD_DMAX + 1)
    lo, hi = HD_DWELL_RANGE
    rows = [np.exp(-0.5 * ((d - p) / HD_DWELL_SD) ** 2) * ((d >= lo) & (d <= hi)) for p in HD_PEAKS]
    return np.array([r / r.sum() for r in rows])


def phase_hsmm_daily(device):
    """Main path 19, the K'=180 HSMM (``HD_*``): the Gibbs fit of 64
    series x T=1000 (``FWD`` + ``BWD_SAMPLE`` in the big layout once a
    sweep), the decode of 20 thinned draws a series in one ``generated``
    call (1,280 lanes: ``FILTER``, ``BETA``, ``VITERBI``, ``BACKTRACK``
    at K=180) and two true-parameter Viterbi decodes of the same series
    (``VITERBI`` + ``BACKTRACK`` on 64 lanes each): with the true duration
    pmfs, and with flat ones (the true emissions and transitions, the
    durations at what a fit of one series can learn: the Dirichlet(1)
    prior's 60 pseudo-counts a regime outweigh the about 11 dwells a
    regime that T=1000 holds). Gate: the median over series of the fitted
    decode's collapsed regime accuracy (mean over its draws) within
    ``HD_ACC_GAP`` of the flat-duration decode's; the gap to the
    true-duration decode is reported."""
    dur = daily_dur()
    z, x = hsmm_batch(SEED_HSMM + 300, HD_SERIES, HD_T, HD_A, dur, device,
                      mu=HD_MU, sigma=HD_SIGMA)
    data = {"x": x}
    model = GaussianHSMM(HD_K, HD_DMAX, nig_prior=NIGPrior(**G_PRIOR))
    f32 = dict(dtype=torch.float32, device=device)
    truth = {"p_1k": torch.full((HD_K,), 1.0 / HD_K, **f32), "A_ij": torch.tensor(HD_A, **f32),
             "dur_kd": torch.tensor(dur, **f32), "mu_k": torch.tensor(HD_MU, **f32),
             "sigma_k": torch.tensor(HD_SIGMA, **f32)}
    truth = {k: v.expand((HD_SERIES,) + v.shape) for k, v in truth.items()}
    flat = dict(truth, dur_kd=torch.full_like(truth["dur_kd"], 1.0 / HD_DMAX))
    reset_all()
    with LaneRecorder(decode=True) as rec:
        qs, row = hsmm_gibbs("hsmm_daily", model, data, HD_WARMUP, HD_SAMPLES, SEED_HSMM + 300,
                             device)
        draws = thin(qs[:, 0], HD_DRAWS)
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        out = model.generated(draws, data, device=device)
        sync()
        gen_wall = time.perf_counter() - t0
        rose_gen = rose_since(before)
        check_decode_once("hsmm_daily", rose_gen)
        ones = torch.ones(HD_SERIES, HD_T, device=device)
        acc = {}
        for tag, params in (("truth", truth), ("truth_flat_dur", flat)):
            z_dec, _ = td.viterbi_dispatch(*model.build(params, data)[:3], ones)
            acc[tag] = (model.regime_path(z_dec) == z).float().mean(-1)
        sync()
    launches = launch_counts()
    dev = {k: check_probabilities("hsmm_daily", out, k) for k in ("alpha", "gamma")}
    acc_fit = (model.regime_path(out["zstar"]) == z[:, None]).float().mean(-1).mean(1)
    med_fit, med_true = float(acc_fit.median()), float(acc["truth"].median())
    med_flat = float(acc["truth_flat_dur"].median())
    cons = model.constrained_draws(qs[:, 0])
    mu_err = (cons["mu_k"].mean(1) - torch.tensor(HD_MU, device=device)).abs().max(-1).values
    mean_dwell = (cons["dur_kd"].mean(1) * torch.arange(1, HD_DMAX + 1, device=device)).sum(-1)
    split = sweep_split(model, qs[:, 0, -1], data, device)
    kernels = kept_vs_plain(rec.calls, "hsmm_daily")
    pair = pair_ms(kernels, (cs.FWD.name, cs.BWD_SAMPLE.name), HD_SERIES, HD_T)
    decode_ms = pair_ms(kernels, [k.name for k in DECODE_KERNELS], HD_SERIES * HD_DRAWS, HD_T)
    emit("hsmm_daily", **row, draws_per_series=HD_DRAWS, generated_seconds=gen_wall,
         launches={k: v for k, v in launches.items() if v}, row_sum_max_dev=dev,
         regime_accuracy_median=med_fit, true_parameter_accuracy_median=med_true,
         accuracy_gap=med_true - med_fit, flat_duration_accuracy_median=med_flat,
         accuracy_gap_flat=med_flat - med_fit, mu_err_max_mean=float(mu_err.mean()),
         mean_dwell={"fit": [float(v) for v in mean_dwell.mean(0)],
                     "truth": [float(v) for v in (dur * np.arange(1, HD_DMAX + 1)).sum(-1)]},
         sweep_split=split, ffbs_pair_ms=pair, ffbs_share=pair / row["sweep_ms"],
         decode_kernels_ms=decode_ms, decode_kernel_share=decode_ms / (gen_wall * 1e3),
         kernels_vs_plain=kernels)
    if not med_fit >= med_flat - HD_ACC_GAP:
        raise AssertionError(f"hsmm_daily: median regime accuracy {med_fit:.4f}, the true "
                             f"emissions and transitions' with flat durations {med_flat:.4f} "
                             f"(gap limit {HD_ACC_GAP}; the true parameters' {med_true:.4f})")
    return launches, kernels


def phase_multinom_hsmm(device):
    """Main path 20, ``MultinomialHSMM(K=3, Dmax=8, L=5)`` on 256 series x
    T=1024 (K'=24): the Gibbs fit (``FWD`` + ``BWD_SAMPLE`` once a sweep);
    every fit finite; the posterior-mean emission rows against the
    simulator's after the best of the 3! relabellings a series."""
    phi = np.random.default_rng(SEED_HSMM + 400).dirichlet(np.ones(MH_L) * 0.8, size=MH_K)
    z, x = hsmm_batch(SEED_HSMM + 400, MH_SERIES, MH_T, MH_A, MH_DUR, device, phi=phi)
    model = MultinomialHSMM(MH_K, MH_DMAX, MH_L)
    reset_all()
    with LaneRecorder() as rec:
        qs, row = hsmm_gibbs("multinom_hsmm", model, {"x": x}, MH_WARMUP, MH_SAMPLES,
                             SEED_HSMM + 400, device)
    launches = launch_counts()
    phi_hat = model.constrained_draws(qs[:, 0])["phi_k"].mean(1).cpu().numpy()  # [B, K, L]
    perms = [list(p) for p in itertools.permutations(range(MH_K))]
    mae = np.array([min(np.abs(ph[p] - phi).mean() for p in perms) for ph in phi_hat])
    kernels = kept_vs_plain(rec.calls, "multinom_hsmm")
    pair = pair_ms(kernels, (cs.FWD.name, cs.BWD_SAMPLE.name), MH_SERIES, MH_T)
    emit("multinom_hsmm", **row, launches={k: v for k, v in launches.items() if v},
         phi_mae_median=float(np.median(mae)), phi_mae_max=float(mae.max()),
         ffbs_pair_ms=pair, ffbs_share=pair / row["sweep_ms"], kernels_vs_plain=kernels)
    return launches, kernels


def hsmm_nuts_task(name, device):
    """Main path 21 in a spawned process: the ``hsmm`` arm's model without
    a prior (``GaussianHSMM(2, 6)``) on ``HN_SERIES`` series by
    ``fit_batched`` NUTS (depth ``HN_TREEDEPTH``, one chunk), ``FWD`` +
    ``VG_BWD`` at K'=12 once a value-and-grad call. Gate: the divergent
    share at most ``HN_DIV_MAX``. Returns the phase line's fields and
    ``(model, data, last draws)`` for :func:`vg_ms_alone`."""
    _, x = hsmm_batch(SEED_HSMM + 500, HN_SERIES, HSMM_T, HSMM_A, HSMM_DUR, device,
                      mu=HSMM_MU, sigma=HSMM_SIGMA)
    data = {"x": x}
    model = GaussianHSMM(HSMM_K, HSMM_DMAX)
    init = default_init(model, data, HN_SERIES, 1, seed=SEED_HSMM, device=device)
    cfg = SamplerConfig(num_warmup=HN_WARMUP, num_samples=HN_SAMPLES, num_chains=1,
                        max_treedepth=HN_TREEDEPTH)
    vg = VGCounter(GaussianHSMM.make_vg)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(GaussianHSMM, "make_vg", autospec=True, side_effect=vg):
        qs, stats = fit_batched(model, data, cfg, init=init, chunk_size=HN_SERIES,
                                seed=SEED_HSMM, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose != {cs.FWD.name: vg.calls, cs.VG_BWD.name: vg.calls}:
        raise AssertionError(f"hsmm_nuts: launches {rose} for {vg.calls} value-and-grad calls")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("hsmm_nuts: an unhealthy chain or a non-finite logp")
    div_share = float(stats["diverging"].float().mean())
    mu_hat = model.constrained_draws(qs[:, 0])["mu_k"].mean(1)
    mu_err = (mu_hat - torch.tensor(HSMM_MU, device=device)).abs().max(-1).values
    eps = stats["step_size"].reshape(-1)
    transitions = HN_WARMUP + HN_SAMPLES
    row = dict(model=name, K=model.K, Dmax=model.Dmax, n_states=model.n_states,
               series=HN_SERIES, T=HSMM_T, warmup=HN_WARMUP, samples=HN_SAMPLES,
               max_treedepth=HN_TREEDEPTH, seconds=wall, transitions_per_s=transitions / wall,
               value_and_grad_calls=vg.calls, **lockstep(stats),
               step_size=dict(min=float(eps.min()), median=float(eps.median()),
                              max=float(eps.max())),
               divergent_share=div_share, mu_err_max_mean=float(mu_err.mean()), launches=rose)
    if not div_share <= HN_DIV_MAX:
        raise AssertionError(f"hsmm_nuts: divergent share {div_share:.3g} (limit {HN_DIV_MAX})")
    return row, (model, data, qs[:, :, -1].contiguous())


# ---------------------------------------------------------------------------
# main paths 13-16 in spawned processes
# ---------------------------------------------------------------------------

# the six tasks of main paths 13 to 16, each in a process of its own
# ---------------------------------------------------------------------------
# adaptation and maintenance: bench.py --adapt's and --maint's workloads
# ---------------------------------------------------------------------------

AM_SERIES, AM_HIST, AM_TICKS, AM_DRAWS = 256, 64, 256, 32
AM_TAIL, AM_EVAL, AM_MIN_FIT, AM_HOLDOUT = 32, 8, 16, 24
AM_SHIFT = AM_HIST + 2 + 16  # the stream tick the alphabet reverses
AM_FIT = (100, max(8 * AM_DRAWS, 64))  # the history fit's warmup + samples
AM_REFIT = (50, max(6 * AM_DRAWS, 48))  # a warm refit's
AM_BUCKETS, AM_TENANTS, AM_ALPHA = (8, 64, 256), 4, 0.5
AM_SEED_LOOP, AM_SEED_LADDER = 7, 11


class SweepCounter:
    """Wraps ``batch/fit.py``'s ``sample_gibbs``: the Gibbs sweeps every
    dispatch asked for (each one ``FWD`` and one ``BWD_SAMPLE``)."""

    def __init__(self):
        self.sweeps, self.fn = 0, fit_module.sample_gibbs

    def __call__(self, model, data, init, config, *args, **kw):
        self.sweeps += config.num_warmup + config.num_samples
        return self.fn(model, data, init, config, *args, **kw)


def first_refit_recorded(rec):
    """``maint/loop.py``'s ``warm_refit``, under ``rec`` until a call
    has fitted something (the first passes may skip every request)."""
    real, fitted = maint_loop.warm_refit, []

    def refit(*args, **kw):
        if fitted:
            return real(*args, **kw)
        with rec:
            candidates, skipped = real(*args, **kw)
        if candidates:
            fitted.append(True)
        return candidates, skipped

    return refit


class AMWorkload:
    """``bench.py``'s adapt / maint workload on the port: 256 series of
    peaked Tayal emissions (Dirichlet 0.5), the alphabet reversed (``8 -
    x``) from stream tick ``AM_SHIFT`` on under ``RegimeShiftPlan``, the
    history fit on the first ``AM_HIST`` steps banked as 32-draw
    snapshots, and one isolated registry and scheduler an arm."""

    def __init__(self, prefix, holdout, device, tmp, rec):
        self.device, self.tmp = device, tmp
        self.model = TayalHHMM(gate_mode="hard")
        x, sign = tayal_batch(AM_SERIES, AM_HIST + 2 + AM_TICKS + holdout, seed=SEED_DATA,
                              alpha=AM_ALPHA, device=device)
        self.x, self.sign = x.cpu().numpy(), sign.cpu().numpy()
        self.x_alt = (8 - self.x).astype(self.x.dtype)
        self.names = [f"{prefix}{i:04d}" for i in range(AM_SERIES)]
        sync()
        t0 = time.perf_counter()
        with rec:
            qs, stats = fit_batched(self.model, {"x": x[:, :AM_HIST], "sign": sign[:, :AM_HIST]},
                                    GibbsConfig(*AM_FIT, 1), chunk_size=AM_SERIES,
                                    seed=SEED_SAMPLER, device=device)
            qh = qs.cpu().numpy()
        self.fit_s = time.perf_counter() - t0
        healthy = stats["chain_healthy"].cpu().numpy().reshape(AM_SERIES, -1)
        self.snaps = {n: snapshot_from_fit(self.model, qh[i], healthy[i], n_draws=AM_DRAWS,
                                           meta={"series": i, "n_hist": AM_HIST})
                      for i, n in enumerate(self.names)}

    def arm(self, tag):
        reg = SnapshotRegistry(os.path.join(self.tmp, tag))
        for n in self.names:
            reg.promote(n, self.snaps[n])
        sched = MicroBatchScheduler(self.model, buckets=AM_BUCKETS, registry=reg,
                                    history_tail=AM_TAIL, device=self.device)
        rej = sched.attach_many([
            (n, reg.load_serving(n), {"x": self.x[i, :AM_HIST], "sign": self.sign[i, :AM_HIST]},
             f"tenant{i % AM_TENANTS}") for i, n in enumerate(self.names)])
        if rej:
            raise AssertionError(f"{tag}: attach rejected {rej[:3]}")
        return reg, sched

    def loop(self, sched, reg, adapt=None):
        return MaintenanceLoop(
            sched, reg, self.model, GibbsConfig(*AM_REFIT, 1), AM_SEED_LOOP,
            policy=MaintenancePolicy(min_interval_ticks=40, max_concurrent=max(4, AM_SERIES)),
            eval_ticks=AM_EVAL, min_fit_ticks=AM_MIN_FIT,
            detector_factory=lambda sid: LoglikCUSUM(series=sid, threshold=5.0, calibrate=12),
            adapt=adapt, device=self.device)

    def drive(self, sched, t):
        xx = self.x_alt if faults.regime_shift_active(t) else self.x
        for i, n in enumerate(self.names):
            sched.submit(n, {"x": int(xx[i, t]), "sign": int(self.sign[i, t])})
        return sched.flush()

    def stream(self):
        return range(AM_HIST + 2, AM_HIST + 2 + AM_TICKS)


def am_clean(tag, sched, warm_sigs, warm_nvcc):
    """An arm sheds nothing, fails no dispatch and, after its warmup, adds
    no scheduler signature and no ``nvcc`` build."""
    m = sched.metrics
    bad = dict(shed=m.shed_ticks, dispatch_errors=m.dispatch_errors,
               new_signatures=m.compile_count - warm_sigs,
               new_nvcc=obs_telemetry.backend_compiles() - warm_nvcc)
    if any(bad.values()):
        raise AssertionError(f"{tag}: not clean after warmup: {bad}")
    return bad


def am_pass_split(loop):
    """A maintenance pass's host seconds by stage (``maint.refit``, the
    shadow gate, promotion), summed and a pass."""
    passes = max(1, loop.passes)
    return dict(passes=loop.passes, seconds=dict(loop.stage_seconds),
                seconds_a_pass={k: v / passes for k, v in loop.stage_seconds.items()})


def am_launches(tag, before, sweeps):
    rose = rose_since(before)
    if rose != {cs.FWD.name: sweeps.sweeps, cs.BWD_SAMPLE.name: sweeps.sweeps}:
        raise AssertionError(f"{tag}: launches {rose} for {sweeps.sweeps} Gibbs sweeps")
    return rose


def am_mixture(sched, resps, weighted):
    """One flush's one-step mixture predictive loglik a series, before its
    weights move: the ladder's weighted mixture, or the uniform one."""
    rows = [r for r in resps if not r.shed and r.per_draw_loglik is not None]
    if not rows:
        return {}
    inc = torch.as_tensor(np.stack([r.per_draw_loglik for r in rows]))
    ok = torch.as_tensor(np.stack([r.draw_ok for r in rows]))
    if weighted:
        lws = [sched.weight_state_of(r.series_id) for r in rows]
        lw = torch.as_tensor(np.stack([uniform_log_weights(inc.shape[-1]) if w is None
                                       else np.asarray(w) for w in lws]))
        v = weighted_mixture_loglik(lw, inc, ok)
    else:
        v = uniform_mixture_loglik(inc, ok)
    return {r.series_id: float(x) for r, x in zip(rows, v.numpy())}


def adapt_task(name, device, rec):
    """Main path 24, in a spawned process: ``bench.py --adapt``'s arms at
    its defaults on the same shifted trace from the same history fit — W
    (the ladder, ``AdaptationLadder``, wired into the maintenance loop)
    and U (uniform-stale, no adaptation and no maintenance). Its third
    arm, M (the loop alone, refits only), is the ``maint`` task's replay
    of the same trace (:func:`join_adapt_maint`). Gates, the JAX bench's:
    W beats U on the post-shift one-step predictive loglik, paired a
    series and pooled; a rejuvenation ran and each restored ESS to the
    floor or above; after warmup no new scheduler or rejuvenator
    signature and no ``nvcc`` build; no shed and no dispatch error (W
    refits fewer series than M: checked once both tasks are done).
    ``FWD`` and ``BWD_SAMPLE`` once a Gibbs sweep of the history fit and
    of every warm refit; ``rec`` (a :class:`LaneRecorder`) keeps the
    history fit's and the first warm refit's launches."""
    sweeps = SweepCounter()
    before = launch_counts()
    shift = faults.RegimeShiftPlan(at_tick=AM_SHIFT)
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(fit_module, "sample_gibbs", sweeps), \
            mock.patch.object(maint_loop, "warm_refit", first_refit_recorded(rec)):
        wl = AMWorkload("a", AM_HOLDOUT, device, tmp, rec)  # maint's trace
        preds = {"W": {}, "U": {}}
        arms = {"U": adapt_arm_u(wl, shift, preds["U"])}
        reg_w, sched_w = wl.arm("w")
        ladder = AdaptationLadder(sched_w, AM_SEED_LADDER, escalate_after=2, device=device)
        loop_w = wl.loop(sched_w, reg_w, adapt=ladder)
        t0 = time.perf_counter()
        for t in range(AM_HIST, AM_HIST + 2):
            resp = wl.drive(sched_w, t)
            ladder.observe(resp)
            loop_w.observe(resp)
        warm_swap = sched_w.swap_snapshot(wl.names[0])
        ladder.rejuvenate([wl.names[0]], reason="warmup")
        # a move at each bucket shape (zeros, committed nowhere): every
        # rejuvenation of the window then lands on a warmed signature
        bank = sched_w.draw_bank_of(wl.names[0])
        K = wl.model.K
        for b in AM_BUCKETS:
            ladder.rejuvenator.move(
                torch.zeros((b,) + tuple(bank.shape), dtype=bank.dtype, device=device),
                torch.zeros((b, AM_DRAWS), device=device),
                torch.zeros((b, AM_DRAWS, K), device=device),
                torch.zeros((b, AM_DRAWS), device=device),
                torch.ones((b, AM_DRAWS), dtype=torch.bool, device=device))
        sync()
        warmup_s = time.perf_counter() - t0
        warm_w = (sched_w.metrics.compile_count, obs_telemetry.backend_compiles())
        rejuv_warm = ladder.rejuvenator.compile_count
        t0 = time.perf_counter()
        with faults.inject(shift):
            for t in wl.stream():
                resp = wl.drive(sched_w, t)
                for sid, v in am_mixture(sched_w, resp, True).items():
                    preds["W"][(sid, t)] = v
                ladder.observe(resp)
                loop_w.observe(resp)
                loop_w.maybe_maintain()
        arms["W"] = am_arm_line(time.perf_counter() - t0, loop_w,
                                am_clean("adapt W", sched_w, *warm_w))
        stanza = ladder.stanza()
        new_rejuv = ladder.rejuvenator.compile_count - rejuv_warm
    launches = am_launches("adapt", before, sweeps)
    # the tracking gate: W against U on the same post-shift ticks
    per_series, pooled = [], []
    for sid in wl.names:
        d = [preds["W"][(sid, t)] - preds["U"][(sid, t)]
             for t in range(AM_SHIFT, AM_HIST + 2 + AM_TICKS)
             if (sid, t) in preds["W"] and (sid, t) in preds["U"]
             and np.isfinite(preds["W"][(sid, t)]) and np.isfinite(preds["U"][(sid, t)])]
        if d:
            pooled.extend(d)
            per_series.append(float(np.mean(d)))
    paired = float(np.mean(per_series)) if per_series else float("nan")
    pooled_mean = float(np.mean(pooled)) if pooled else float("nan")
    rejuv = [e for e in stanza["events"] if e.get("kind") == "rejuvenate"]
    floor = ladder.ess_floor(AM_DRAWS)
    failures = []
    if warm_swap is not None:
        failures.append(f"warmup swap rejected: {warm_swap}")
    if stanza["reweight_ticks"] == 0:
        failures.append("no tick reweighted")
    if not (per_series and paired > 0 and pooled_mean > 0):
        failures.append(f"W did not beat U after the shift (paired {paired}, pooled {pooled_mean})")
    if not (stanza["rejuvenations"] > 0 and rejuv and all(e["ess_after"] >= floor for e in rejuv)):
        failures.append(f"no rejuvenation restored ESS to the floor {floor} "
                        f"(rejuvenations {stanza['rejuvenations']})")
    if new_rejuv:
        failures.append(f"{new_rejuv} new rejuvenator signatures after warmup")
    if failures:
        raise AssertionError(f"adapt: {failures}")
    return dict(
        series=AM_SERIES, draws=AM_DRAWS, n_hist=AM_HIST, ticks=AM_TICKS,
        tail=AM_TAIL, eval_ticks=AM_EVAL, shift_at=AM_SHIFT, buckets=list(AM_BUCKETS),
        tenants=AM_TENANTS, fit_sweeps=sum(AM_FIT), refit_sweeps=sum(AM_REFIT), fit_s=wl.fit_s,
        warmup_s=warmup_s, paired_mean_delta=paired, pooled_mean_delta=pooled_mean,
        tracking_advantage=True, series_paired=len(per_series), ticks_paired=len(pooled),
        rejuvenations=stanza["rejuvenations"], escalations=stanza["escalations"],
        ess_floor=floor, ess_min=stanza["ess_min"], floor_breaches=stanza["floor_breaches"],
        ess_after_min=min(e["ess_after"] for e in rejuv), refits_w=arms["W"]["refits"],
        new_rejuvenator_signatures_after_warmup=new_rejuv,
        rejuvenator_signatures=ladder.rejuvenator.compile_count,
        ticks_per_s={a: AM_TICKS / r["seconds"] for a, r in arms.items()},
        series_ticks_per_s={a: AM_TICKS * AM_SERIES / r["seconds"] for a, r in arms.items()},
        arms=arms,
        gibbs_sweeps=sweeps.sweeps, launches=launches), None


def adapt_arm_u(wl, shift, preds):
    """Arm U: uniform-stale, its one-step mixture predictives in ``preds``."""
    _, sched = wl.arm("u")
    for t in range(AM_HIST, AM_HIST + 2):
        wl.drive(sched, t)
    warm = (sched.metrics.compile_count, obs_telemetry.backend_compiles())
    t0 = time.perf_counter()
    with faults.inject(shift):
        for t in wl.stream():
            for sid, v in am_mixture(sched, wl.drive(sched, t), False).items():
                preds[(sid, t)] = v
    return dict(seconds=time.perf_counter() - t0, clean=am_clean("adapt U", sched, *warm))


def join_adapt_maint(ad, mt):
    """The adapt path's arm M from the maint task's row: the maintenance
    loop alone on the same trace from the same history fit is the maint
    path's replay, run once. Then the gate that needs both: W refits
    fewer series than M."""
    ad["arms"]["M"] = dict(seconds=mt["replay_s"], refits=mt["refits"],
                           promotions=mt["promotions"],
                           shadow_rejections=mt["shadow_rejections"],
                           maintenance=mt["maintenance"], clean=mt["clean"], run_by="maint")
    ad["refits_m"] = mt["refits"]
    ad["ticks_per_s"]["M"] = AM_TICKS / mt["replay_s"]
    ad["series_ticks_per_s"]["M"] = AM_TICKS * AM_SERIES / mt["replay_s"]
    if not ad["refits_w"] < ad["refits_m"]:
        raise AssertionError(f"adapt: W refits {ad['refits_w']} not fewer than M's "
                             f"{ad['refits_m']}")


def am_arm_line(seconds, loop, clean):
    st = loop.stanza()
    return dict(seconds=seconds, refits=st["refits"], promotions=st["promotions"],
                shadow_rejections=st["shadow_rejections"], maintenance=am_pass_split(loop),
                clean=clean)


def maint_task(name, device, rec):
    """Main path 25, in a spawned process: ``bench.py --maint`` at its
    defaults — the maintenance loop inline with the serve loop on the
    shifted stream (drift alarms, debounced warm refits over the history
    tails, the shadow gate, promotion), then the promoted snapshots
    against the stale ones on ``AM_HOLDOUT`` never-streamed shifted
    ticks. Gates, the JAX bench's: a drift-alarm refit won the gate and
    was promoted; the promoted snapshots beat the stale ones (paired
    mean delta > 0); no new scheduler signature and no ``nvcc`` build
    after warmup; no shed and no dispatch error. ``FWD`` and
    ``BWD_SAMPLE`` once a Gibbs sweep of every fit; ``rec`` keeps the
    history fit's and the first warm refit's launches."""
    sweeps = SweepCounter()
    before = launch_counts()
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(fit_module, "sample_gibbs", sweeps), \
            mock.patch.object(maint_loop, "warm_refit", first_refit_recorded(rec)):
        wl = AMWorkload("m", AM_HOLDOUT, device, tmp, rec)
        reg, sched = wl.arm("reg")
        loop = wl.loop(sched, reg)
        t0 = time.perf_counter()
        for t in range(AM_HIST, AM_HIST + 2):
            loop.observe(wl.drive(sched, t))
        warm_swap = sched.swap_snapshot(wl.names[0])
        warmup_s = time.perf_counter() - t0
        warm = (sched.metrics.compile_count, obs_telemetry.backend_compiles())
        sched.metrics.reset_throughput_window()
        t0 = time.perf_counter()
        with faults.inject(faults.RegimeShiftPlan(at_tick=AM_SHIFT)):
            for t in wl.stream():
                loop.observe(wl.drive(sched, t))
                loop.maybe_maintain()
        replay_s = time.perf_counter() - t0
        clean = am_clean("maint", sched, *warm)
        stanza = loop.stanza()
        promoted = loop.promoted_series()
        t0 = time.perf_counter()
        deltas = []
        for sid in promoted:
            i = wl.names.index(sid)
            ev = {"x": wl.x_alt[i, -AM_HOLDOUT:], "sign": wl.sign[i, -AM_HOLDOUT:]}
            new = predictive_logliks(wl.model, reg.load_serving(sid), ev, device=device)
            old = predictive_logliks(wl.model, wl.snaps[sid], ev, device=device)
            deltas.append(float(np.mean(new)) - float(np.mean(old)))
        recovery_s = time.perf_counter() - t0
        summary = sched.metrics.summary()
    launches = am_launches("maint", before, sweeps)
    mean_delta = float(np.mean(deltas)) if deltas else float("nan")
    failures = []
    if warm_swap is not None:
        failures.append(f"warmup swap rejected: {warm_swap}")
    # no staleness bound: every trigger is a drift alarm
    if loop.policy.max_staleness_s is not None or stanza["triggers"] == 0:
        failures.append("no drift alarm triggered a refit")
    if stanza["refits"] == 0 or stanza["promotions"] == 0:
        failures.append(f"refits {stanza['refits']}, promotions {stanza['promotions']}")
    if not promoted or not mean_delta > 0:
        failures.append(f"promoted {len(promoted)} series, holdout mean delta {mean_delta}")
    if any(e.get("trigger") not in (None, "drift-alarm") for e in stanza["events"]):
        failures.append("a refit not triggered by a drift alarm")
    if failures:
        raise AssertionError(f"maint: {failures}")
    return dict(
        series=AM_SERIES, draws=AM_DRAWS, n_hist=AM_HIST, ticks=AM_TICKS, tail=AM_TAIL,
        eval_ticks=AM_EVAL, holdout_ticks=AM_HOLDOUT, shift_at=AM_SHIFT,
        buckets=list(AM_BUCKETS), tenants=AM_TENANTS, fit_sweeps=sum(AM_FIT),
        refit_sweeps=sum(AM_REFIT), fit_s=wl.fit_s, warmup_s=warmup_s, replay_s=replay_s,
        ticks_per_s=AM_TICKS / replay_s, series_ticks_per_s=summary["ticks_per_sec"],
        triggers=stanza["triggers"], refits=stanza["refits"], promotions=stanza["promotions"],
        shadow_rejections=stanza["shadow_rejections"], skipped_refits=stanza["skipped_refits"],
        failed_swaps=stanza["failed_swaps"], dropped_triggers=stanza["dropped_triggers"],
        promoted_series=len(promoted), holdout_mean_delta=mean_delta,
        holdout_delta_min=min(deltas), recovery_s=recovery_s,
        maintenance=am_pass_split(loop), refit_seconds=stanza["refit_seconds"],
        latency_p50_ms=summary["latency_p50_ms"], latency_p99_ms=summary["latency_p99_ms"],
        clean=clean, gibbs_sweeps=sweeps.sweeps, launches=launches), None


POOL_TASKS = (("iohmm", "reg"), ("iohmm", "hmix"), ("hassan", "SYN-A"), ("hassan", "SYN-B"),
              ("tree_gibbs", "jangmin"), ("jangmin", "nuts"), ("hsmm_nuts", "gaussian_hsmm"),
              ("nuts", "tayal"), ("gaussian_nuts", "hmm_main"), ("adapt", "tayal"),
              ("maint", "tayal"))
POOL_PATHS = ("iohmm", "hassan", "tree_gibbs", "jangmin", "hsmm_nuts", "nuts", "gaussian_nuts",
              "adapt", "maint")


def blocking_sync() -> int:
    """Have this process's CUDA context sleep, not spin, while it waits
    for the card: set ``CU_CTX_SCHED_BLOCKING_SYNC`` on device 0's
    primary context before the process first touches CUDA. The driver's
    default spins whenever a process holds fewer contexts than the host
    has cores, so a score of processes sharing one card and eight cores
    spend the cores waiting that the others need for their host work.
    Returns the driver's result code (0: set)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    dev = ctypes.c_int()
    return (cu.cuInit(0) or cu.cuDeviceGet(ctypes.byref(dev), 0)
            or cu.cuDevicePrimaryCtxSetFlags_v2(dev, 4))


SYNC_RC = None  # blocking_sync's result in a pool process


def pool_init():
    global SYNC_RC
    os.nice(POOL_NICE)
    SYNC_RC = blocking_sync()


def cpu_seconds(who=resource.RUSAGE_SELF) -> float:
    """User and system CPU seconds of this process (or its reaped children)."""
    r = resource.getrusage(who)
    return r.ru_utime + r.ru_stime


def _host_tensors(v):
    return tuple(a.cpu() if torch.is_tensor(a) else a for a in v)


def pool_worker(task):
    """Run one task ``(path, name, device)`` of ``POOL_TASKS`` in a
    spawned process. Returns ``(path, row, vg_in, kept, (sync_rc,
    cpu))``: the phase line's fields (its launches the task's own count,
    checked there against its sweeps, value-and-grad calls and decode
    calls), the value-and-grad inputs for :func:`vg_ms_alone` (None for
    the Gibbs path) and the first launch of each kernel at each shape
    (:class:`LaneRecorder`; the decode kernels too on the ``jangmin``
    path; on the adaptation and maintenance paths, of the history fit
    and the first warm refit only), their tensors on the host,
    :func:`blocking_sync`'s result code in this process and the task's
    CPU seconds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, name, device = task
    device = torch.device(device)
    cpu0 = cpu_seconds()
    run = {"iohmm": iohmm_task, "hassan": hassan_task, "tree_gibbs": tree_gibbs_task,
           "jangmin": jangmin_task, "hsmm_nuts": hsmm_nuts_task, "nuts": nuts_task,
           "gaussian_nuts": gaussian_nuts_task, "adapt": adapt_task, "maint": maint_task}[path]
    rec = LaneRecorder(decode=path == "jangmin")
    if path in ("adapt", "maint"):
        row, vg_in = run(name, device, rec)
    else:
        with rec:
            row, vg_in = run(name, device)
    if vg_in is not None:
        model, data, q = vg_in
        vg_in = (model, {k: v.cpu() for k, v in data.items()}, q.cpu())
    kept = {key: (_host_tensors(args), _host_tensors(outs)) for key, (args, outs) in rec.calls.items()}
    return path, row, vg_in, kept, (SYNC_RC, cpu_seconds() - cpu0)


def vg_ms_alone(model, data, q, device) -> float:
    """ms a call of ``model.make_vg(data)`` at the draws ``q`` on the
    host clock: one warm call, then 20 synchronized calls, with nothing
    else on the host or the card."""
    fn = model.make_vg({k: v.to(device) for k, v in data.items()})
    q = q.to(device)
    return host_ms(lambda: fn(q), reps=20)


def check_finite_inputs(calls, phase):
    """The clamped kernels' rule on the path's own inputs: every kept
    ``FWD``, ``BWD_SAMPLE`` and ``VG_BWD`` launch saw finite floats only
    (structural zeros arrive as ``safe_log(0)``, hard-gated emissions as
    ``MASK_NEG``)."""
    clamped = (cs.FWD.name, cs.BWD_SAMPLE.name, cs.VG_BWD.name)
    for (name, N, T, K, gated), (args, _) in calls.items():
        if name in clamped and not all(bool(torch.isfinite(a).all()) for a in args
                                       if torch.is_tensor(a) and a.is_floating_point()):
            raise AssertionError(f"{phase}: {name} N={N} T={T} K={K} gated={gated} "
                                 f"got a non-finite input")


def start_pool(device, on_task_done=None):
    """Start the eleven tasks of ``POOL_TASKS``, each in a spawned process
    of its own, all at once, at ``POOL_NICE``, their ids listed in
    ``BESIDE`` (so that this process's timings stop them). Returns
    ``(pool, handles, start time)`` for :func:`phase_pool`;
    ``on_task_done(n)`` is called as the n-th task finishes."""
    t0 = time.perf_counter()
    finished = itertools.count(1)
    pool = multiprocessing.get_context("spawn").Pool(len(POOL_TASKS), initializer=pool_init)
    try:
        with BESIDE["lock"]:
            BESIDE["pids"].update(p.pid for p in multiprocessing.active_children())
        handles = [pool.apply_async(
            pool_worker, (t + (str(device),),),
            callback=None if on_task_done is None else lambda _r: on_task_done(next(finished)))
            for t in POOL_TASKS]
    except BaseException:
        stop_pool(pool)
        raise
    return pool, handles, t0


def stop_pool(pool, wait=False):
    """Take the pool's processes off ``BESIDE``, then end them: let them
    exit once their tasks are done (``wait``), or terminate them."""
    with BESIDE["lock"]:
        BESIDE["pids"].difference_update(p.pid for p in multiprocessing.active_children())
    if wait:
        pool.close()
    else:
        pool.terminate()
    pool.join()


def phase_pool(started, device, chees_phi, after_workers=None):
    """Main paths 6 (``nuts``), 7 (``gaussian_nuts``), 13 (``iohmm``:
    IOHMM-reg and the mixture), 14 (``hassan``: SYN-A and SYN-B), 15
    (``tree_gibbs``), 16 (``jangmin``), 21 (``hsmm_nuts``), 24
    (``adapt``) and 25 (``maint``): the eleven tasks of
    :func:`start_pool`, waited for (each is host-bound: one process
    runs one sweep, NUTS leaf or tick at a time; the reference fits its
    symbols in parallel too). A task's seconds are taken with the eleven
    sharing the host and the card (``shared_by_processes``), with this
    process's phases from the zoo on and, from the second task's end,
    the example drivers; each process's context set to sleep, not spin,
    while it waits for the card (:func:`blocking_sync`), its CPU
    seconds reported beside. Each task checks its own launches and
    gates; here, with the workers done, the adapt path takes its arm M
    from the maint task (:func:`join_adapt_maint`), each NUTS task's
    value-and-grad call is timed alone (and the Jangmin tree's
    ``assemble``), and per path the tasks' launches are summed and the
    first launch of each kernel at each shape is held bitwise against
    its plain version on the card and timed. ``after_workers()`` is
    called once the workers are done, before anything is timed here.
    Returns ``{path: (launches, kept rows)}``."""
    pool, handles, t0 = started
    try:
        results = [h.get() for h in handles]
    except BaseException:
        stop_pool(pool)
        raise
    stop_pool(pool, wait=True)
    wall = time.perf_counter() - t0
    sync_rcs = sorted({r[-1][0] for r in results}, key=str)
    emit("pool_processes", processes_wall_seconds=wall, cpu_seconds={
        f"{t[0]}/{t[1]}": r[-1][1] for t, r in zip(POOL_TASKS, results)},
         cpu_seconds_total=sum(r[-1][1] for r in results), host_cores=os.cpu_count())
    results = [r[:-1] for r in results]
    if after_workers is not None:
        after_workers()
    join_adapt_maint(*(next(r for p, r, _, _ in results if p == path) for path in ("adapt", "maint")))
    out = {}
    for path in POOL_PATHS:
        launches, calls, rows = {}, {}, []
        for p, row, vg_in, kept in results:
            if p != path:
                continue
            if vg_in is not None:
                row["value_and_grad_ms_alone"] = vg_ms_alone(*vg_in, device)
            if path == "jangmin":
                row["assemble"] = assemble_cost(vg_in[0], vg_in[2], device)
            rows.append(row)
            for r in (row.values() if path == "tree_gibbs" else (row,)):
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            if path == "jangmin":
                for r in (row["launches_decode"], row["fit_market"]["launches"]):
                    for k, v in r.items():
                        launches[k] = launches.get(k, 0) + v
            for key, (args, outs) in kept.items():
                calls.setdefault(key, (tuple(a.to(device) if torch.is_tensor(a) else a
                                             for a in args),
                                       tuple(o.to(device) for o in outs)))
        check_finite_inputs(calls, path)
        kernels = kept_vs_plain(calls, path)
        for row in rows:
            if path == "tree_gibbs":  # a sweep: FWD + BWD_SAMPLE at the fit's lanes
                for gate, r in row.items():
                    pair = [k["ms"] for k in kernels if k["N"] == r["markets"]
                            and k["gated"] == (gate == "stan")]
                    r["ffbs_pair_ms"] = sum(pair)
                    r["ffbs_share"] = sum(pair) / r["sweep_ms"]
            elif path == "jangmin":
                pair = pair_ms(kernels, (cs.FWD.name, cs.VG_BWD.name), JM_MARKETS, JM_T)
                vgms = row["value_and_grad_ms_alone"]
                row.update(kernel_pair_ms=pair, kernel_pair_share=pair / vgms,
                           assemble_share=row["assemble"]["ms"] / vgms)
            elif path == "hsmm_nuts":
                pair = pair_ms(kernels, (cs.FWD.name, cs.VG_BWD.name), HN_SERIES, HSMM_T)
                vgms = row["value_and_grad_ms_alone"]
                row.update(kernel_pair_ms=pair, kernel_pair_share=pair / vgms)
            elif path == "nuts":  # the gap to the ChEES posterior, the leaf's share
                phi_mean = row.pop("phi_mean")
                gap = np.minimum(np.abs(phi_mean - chees_phi).mean(axis=(1, 2)),
                                 np.abs(phi_mean[:, MIRROR] - chees_phi).mean(axis=(1, 2)))
                vgms = row["value_and_grad_ms_alone"]
                row.update(phi_gap_vs_chees_mean=float(gap.mean()),
                           value_and_grad_share=row["value_and_grad_calls"] * vgms / 1e3
                           / row["seconds"])
            if path in ("adapt", "maint"):
                row["card"] = CARD
            emit(path, **row, shared_by_processes=len(POOL_TASKS))
        emit(f"{path}_kernels", launches=launches, kernels_vs_plain=kernels,
             processes_wall_seconds=wall, blocking_sync_rcs=sync_rcs)
        out[path] = (launches, kernels)
    return out


def ptxas_usage(log: str) -> dict:
    """``{kernel<template args>: [registers, spill store bytes, spill load
    bytes, static shared bytes]}`` from an ``nvcc -Xptxas -v`` log (its
    entries named from the mangled symbols: ``Li16E`` is 16, ``Lb1E``
    true)."""
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(?<=\d)([a-z_]+_kernel)I(\w*?)EEv", ln)
        if m:
            args = re.findall(r"L([ib])(\d+)E", m.group(2))
            vals = [str(int(v)) if t == "i" else ("true" if v == "1" else "false") for t, v in args]
            name = f"{m.group(1)}<{','.join(vals)}>"
            usage[name] = [None, 0, 0, 0]
        elif name and "spill" in ln:
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if st:
                usage[name][1:3] = [int(st.group(1)), int(st.group(2))]
        elif name and "Used" in ln:
            r = re.search(r"Used (\d+) registers", ln)
            if r:
                usage[name][0] = int(r.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            if sm:
                usage[name][3] = int(sm.group(1))
    return usage


# the K of the kernel table's resource columns, and the main path's shape
# for the two kernels whose dynamic shared memory depends on it
TABLE_KS = (4, 16, 32, 64, 128)


def dynamic_smem(kernel, K: int, T: int = T_FIT, N: int = N_DEC) -> int:
    """Bytes of dynamic shared memory a block of ``kernel`` takes at K
    (the kernels' own formulas: wide_core.cuh's wide_smem_bytes,
    ffbs_bwd_sample.cu's smem_stride and wide_bwd_smem_bytes,
    semiring_viterbi.cu's bt_smem_bytes); the group kernels take none."""
    if kernel is cs.BWD_SAMPLE:
        if K <= 16:  # kLanes rows of W map_words(T) + 8 words, if they fit 2048 a lane
            W, words = -(-K // 8), -(-T // 32) * 32
            return 0 if W * words > 2048 else 4 * 4 * (W * words + 8)
        return 4 * (K * K + 32 * (K + 3)) + 32 * K
    if kernel is cs.BACKTRACK:  # up to 32 lanes a block, a block an SM, at most 100 KB
        W = 1 if K <= 8 else 2 if K <= 16 else -(-K // 4)
        chunk, stages = (64, 4) if K <= 16 else (32, 3)

        def ring(lanes):
            return 4 * (stages * lanes * (chunk * W + 4) + 2 * chunk * lanes)

        lanes = 32
        while lanes > 1 and (-(-N // lanes) < 132 or ring(lanes) > 100 * 1024):
            lanes //= 2
        return ring(lanes)
    if K <= 32:
        return 0
    return 4 * (2 * K * K + 3 * K) if kernel is cs.VG_BWD else 4 * (K * K + 2 * K)


def kernel_resources(usage) -> dict:
    """Per semiring kernel and K of ``TABLE_KS``: the instantiation that
    runs (ungated), its registers, spill bytes (stores, loads), static
    shared bytes and dynamic shared bytes."""
    def inst(k, K):
        if k is cs.BACKTRACK:
            return f"viterbi_backtrack_kernel<{1 if K <= 8 else 2 if K <= 16 else 0}>"
        if k is cs.BWD_SAMPLE:
            return (f"ffbs_bwd_sample_kernel<{K},false>" if K <= 16
                    else "ffbs_bwd_sample_wide_kernel<false>")
        mode = {cs.FWD: "0", cs.FILTER: "1", cs.VITERBI: "2"}.get(k)
        if mode is not None:
            return (f"forward_kernel<{K},{mode},false>" if K <= 32
                    else f"wide_forward_kernel<{mode},false>")
        vg = "true" if k is cs.VG_BWD else "false"
        return f"beta_kernel<{K},{vg},false>" if K <= 32 else f"wide_beta_kernel<{vg},false>"

    out = {}
    for k in cs.KERNELS:
        rows = {}
        for K in TABLE_KS:
            name = inst(k, K)
            regs, st, ld, static = usage.get(k.source.name, {}).get(name) or [None] * 4
            rows[K] = dict(instance=name, registers=regs, spill_stores=st, spill_loads=ld,
                           static_smem=static, dynamic_smem=dynamic_smem(k, K))
        out[k.name] = rows
    return out


# ---------------------------------------------------------------------------
# K = 1, the obs plane, the example drivers (the sixteenth slice)
# ---------------------------------------------------------------------------

K1_N, K1_T = 8, 48  # kernels_k1: lanes and steps
# assoc, dispatch_db, plan, walk_forward_assoc: the time-parallel scans,
# the measured dispatch and the planner
AS_RTOL, AS_ATOL = 1e-5, 1e-4  # the scans' probabilities against the kernels'
AS_MARGIN = 1e-4  # a path or draw may differ where the reference's own margin is under it
AS_SHARDS = 4  # forward_filter_seqshard's chunks, all on cuda:0
AS_IO_DRAWS = 4  # IOHMM-reg draws a series for the time-varying decode
SEED_AS = 1717
DB_KS, DB_TS = (2, 4, 8), (256, 1024, 4096)  # the probe's grid, 256 lanes
DB_REPS = {"cuda": 3, "assoc": 3, "seq": 1}  # seq: a host loop 30 to 1000 times the others
DB_SEQ_T_MAX = 1024  # seq timed at T up to this only (the script's time limit)
PLAN_WARMUP, PLAN_SAMPLES = 20, 20
PLAN_MCSE = 4.0  # the time_parallel=True fit's series-averaged means against cuda's
OBS_WARMUP, OBS_SAMPLES = 20, 20  # obs: the main-path Gibbs fit, twice
OBS_DEVICE_TIME_RATIO = 1.25  # device_time of FWD against the kernels line's time
OUT_DIR = Path("chiprun_out")
ROOT = Path(__file__).resolve().parent
# examples_torch/ drivers run --quick as subprocesses, all at once: (driver,
# the line each must print); DRIVER_ARGS are extra arguments (the Hassan
# replication's walk-forward cut from --quick's 10 steps a benchmark to 5,
# since the serving phases joined the script's budget)
DRIVERS = (("hmm_main.py", "filtered accuracy"), ("iohmm_main.py", "filtered accuracy"),
           ("hassan_main.py", "out-of-sample errors"), ("hassan_replication.py", "SYN-B"),
           ("hhmm_main.py", "top-state recovery"),
           ("jangmin_main.py", "unsupervised regime decode accuracy"),
           ("tayal_main.py", "out-of-sample trading"), ("tayal_strategy.py", "(symbol, window) tasks"))
DRIVER_ARGS = {"hassan_replication.py": ("--steps", "5")}
DRIVER_TIMEOUT_S = 400
DRIVERS_AFTER_TASKS = 2  # the pool's tasks done before the drivers start


def phase_kernels_k1(device):
    """K = 1 on the card: every semiring kernel through its lane wrapper
    on ``K1_N`` lanes x ``K1_T`` steps (masked runs at both ends; ``FWD``,
    ``BWD_SAMPLE`` and ``VG_BWD`` gated and not), bitwise equal to its
    plain version on the same CUDA tensors; every draw and path 0, every
    log-likelihood finite; each kernel launched. Then the public entries
    (``ffbs_dispatch``, ``forward_value_and_grad``, ``smooth_dispatch``,
    ``viterbi_dispatch``) on the card against the same calls on the CPU
    (paths and draws exact, values within 1e-5)."""
    before = {k.name: k.launches for k in cs.KERNELS}
    cases = []
    for gated in (False, True):
        lanes, u_t = make_case(3000 + gated, K1_N, K1_T, 1, gated, device, both_ends=True)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        got = {"fwd": cs.fwd_lanes(*lanes)}
        want = {"fwd": cs.fwd_plain(*lanes)}
        ll, alpha = got["fwd"]
        got["bwd_sample"] = cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t, gate_t, sk_t)
        want["bwd_sample"] = cs.bwd_sample_plain(A_t, mask_t, alpha, u_t, gate_t, sk_t)
        got["vg_bwd"] = cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        want["vg_bwd"] = cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        if not gated:
            dec = (pi_t, A_t, obs_t, mask_t)
            got["filter"], want["filter"] = cs.filter_lanes(*dec), cs.filter_plain(*dec)
            got["beta"], want["beta"] = cs.beta_lanes(*dec[1:]), cs.beta_plain(*dec[1:])
            got["viterbi"], want["viterbi"] = cs.viterbi_lanes(*dec), cs.viterbi_plain(*dec)
            _, dlast, back = got["viterbi"]
            got["backtrack"] = cs.backtrack_lanes(back, dlast)
            want["backtrack"] = cs.backtrack_plain(back, dlast)
        sync()
        for name in got:
            g = got[name] if isinstance(got[name], tuple) else (got[name],)
            w = want[name] if isinstance(want[name], tuple) else (want[name],)
            if not all(torch.equal(a, b) for a, b in zip(g, w)):
                raise AssertionError(f"kernels_k1: {name} (gated={gated}) differs from its plain version")
        zeros = [got["bwd_sample"]] + ([got["backtrack"], got["viterbi"][2]] if not gated else [])
        if any(bool(z.any()) for z in zeros):
            raise AssertionError("kernels_k1: a K = 1 draw, path or map is not all zero")
        lls = [ll] + ([got["filter"][0], got["viterbi"][0]] if not gated else [])
        if not all(bool(torch.isfinite(x).all()) for x in lls):
            raise AssertionError("kernels_k1: a non-finite log-likelihood")
        cases.append(dict(gated=gated, kernels=sorted(got)))
    rose = {k.name: k.launches - before[k.name] for k in cs.KERNELS}
    if any(v == 0 for v in rose.values()):
        raise AssertionError(f"kernels_k1: a kernel never launched at K = 1: {rose}")
    # the public entries, on the card and on the CPU
    rng = np.random.default_rng(3002)
    host = {
        "log_pi": torch.zeros(K1_N, 1), "log_A": torch.zeros(K1_N, 1, 1),
        "log_obs": torch.as_tensor(rng.normal(size=(K1_N, K1_T, 1)) - 1.0, dtype=torch.float32),
        "mask": torch.as_tensor(np.arange(K1_T)[None, :] < rng.integers(K1_T // 2, K1_T + 1, (K1_N, 1)),
                                dtype=torch.float32),
    }
    card = {k: v.to(device) for k, v in host.items()}
    args_h, args_c = list(host.values()), list(card.values())
    gen = torch.Generator(device=device).manual_seed(0)
    z, ll_z = td.ffbs_dispatch(gen, *args_c)
    entries = {
        "forward_value_and_grad": (forward_value_and_grad(*args_c), forward_value_and_grad(*args_h)),
        "smooth_dispatch": (td.smooth_dispatch(*args_c), td.smooth_dispatch(*args_h)),
        "viterbi_dispatch": (td.viterbi_dispatch(*args_c), td.viterbi_dispatch(*args_h)),
    }
    entry_err = {}
    for name, (on_card, on_cpu) in entries.items():
        errs = []
        for a, b in zip(on_card, on_cpu):
            a = a.cpu()
            if a.dtype.is_floating_point:
                errs.append(float((a - b).abs().max()))
            elif not torch.equal(a, b):
                raise AssertionError(f"kernels_k1: {name}'s path differs from the CPU's")
        entry_err[name] = max(errs)
    if max(entry_err.values()) > 1e-5 or bool(z.any()) or not bool(torch.isfinite(ll_z).all()):
        raise AssertionError(f"kernels_k1: the entries at K = 1: {entry_err}, draws {int(z.abs().sum())}")
    out = dict(N=K1_N, T=K1_T, cases=cases, launches=rose, entries_max_abs_err_vs_cpu=entry_err)
    emit("kernels_k1", bitwise_equal=True, **out)
    return out


def phase_obs(device, fwd_ms):
    """The obs plane on the main path: the ``bench.py`` Gibbs fit at full
    width (``tayal_batch``, 256 x T=1024, hard gate) for ``OBS_WARMUP`` +
    ``OBS_SAMPLES`` sweeps, with the plane off, on, then off again, same
    seed: the draws and stats bitwise equal; the span table holds
    ``infer.gibbs.sample`` once and ``kernels.dispatch.ffbs[cuda]`` as
    many times as the FFBS pair launched; the sampler-health counters are
    there. The span split of a sweep is emitted. A manifest (device name
    and power limit) is written to ``chiprun_out/`` with the span JSONL
    and the metrics, and ``obs_report_torch.py`` renders it (exit 0).
    ``device_time`` of ``FWD`` at rows 1-2's shape is held within a factor
    of ``OBS_DEVICE_TIME_RATIO`` of the kernels line's time."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode="hard")
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=OBS_WARMUP, num_samples=OBS_SAMPLES, num_chains=1)
    sweeps = OBS_WARMUP + OBS_SAMPLES
    # the FWD launch at rows 1-2's shape, on the canonical harness
    lanes, _ = make_case(2000, N_SERIES, T_FIT, K_TAYAL, False, device)
    dt = device_time(cs.fwd_lanes, *lanes, reps=21)
    cost = kernel_cost("FWD", K_TAYAL, T_FIT, N_SERIES, valid_steps=_steps(lanes[3]))
    name = torch.cuda.get_device_name(0)
    path = OUT_DIR / "obs_manifest.json"
    runs = {}
    try:
        for run, on in enumerate((False, True, False)):
            if on:
                obs_trace.reset()
                obs_metrics.reset()
            (obs_trace.enable if on else obs_trace.disable)()
            before = {k.name: k.launches for k in (cs.FWD, cs.BWD_SAMPLE)}
            sync()
            t0 = time.perf_counter()
            qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
            sync()
            wall = time.perf_counter() - t0
            rose = {k.name: k.launches - before[k.name] for k in (cs.FWD, cs.BWD_SAMPLE)}
            runs[run] = dict(qs=qs, stats=stats, seconds=wall, launches=rose)
            if run == 2 and obs_trace.aggregate() != table:
                raise AssertionError("obs: the plane recorded spans while it was off")
            if not on:
                continue
            # the plane-on run's table, counters, exports and manifest
            table = obs_trace.aggregate()
            snap = obs_metrics.snapshot()
            OUT_DIR.mkdir(exist_ok=True)
            obs_trace.export_jsonl(str(OUT_DIR / "obs_spans.jsonl"))
            obs_metrics.export_jsonl(str(OUT_DIR / "obs_metrics.jsonl"))
            split = {n: {"count": r["count"], "ms_per_sweep": r["total_s"] * 1e3 / sweeps}
                     for n, r in table.items()}
            man = obs_manifest.collect_manifest(
                config=dict(vars(cfg), series=N_SERIES, T=T_FIT), model=model, seed=SEED_SAMPLER,
                extra={"obs_phase": {"sweep_split": split, "fwd_device_time": dt.to_json(),
                                     "fwd_roofline": roofline(cost, dt.p50_s, name)}})
            obs_manifest.write_manifest(str(path), man)
    finally:
        obs_trace.reset()
        obs_metrics.reset()
        obs_trace.tracer.use_env()
        obs_metrics.use_env()
    off, on, off2 = runs[0], runs[1], runs[2]
    for r in (on, off2):
        if not torch.equal(off["qs"], r["qs"]) or any(
                not torch.equal(off["stats"][k], r["stats"][k]) for k in off["stats"]):
            raise AssertionError("obs: the draws with the plane on differ from the draws with it off")
    branch = "cuda" if torch.device(device).type == "cuda" else "plain"
    ffbs_spans = table.get(f"kernels.dispatch.ffbs[{branch}]", {}).get("count")
    if not (ffbs_spans == on["launches"][cs.FWD.name] == on["launches"][cs.BWD_SAMPLE.name] == sweeps):
        raise AssertionError(f"obs: ffbs[{branch}] spans {ffbs_spans} against launches {on['launches']}")
    if table.get("infer.gibbs.sample", {}).get("count") != 1:
        raise AssertionError(f"obs: infer.gibbs.sample not in the span table {sorted(table)}")
    want = {"infer.transitions{sampler=gibbs}": N_SERIES * OBS_SAMPLES,
            "infer.chains{sampler=gibbs}": N_SERIES}
    got = {k: snap.get(k, {}).get("value") for k in want}
    if got != want:
        raise AssertionError(f"obs: sampler-health counters {got}, expected {want}")
    if man["device_kind"] != name or not man["power_limit"]:
        raise AssertionError(f"obs: the manifest's device {man['device_kind']!r} / {man['power_limit']!r}")
    rep = subprocess.run([sys.executable, str(ROOT / "obs_report_torch.py"), str(path),
                          "--metrics", str(OUT_DIR / "obs_metrics.jsonl")],
                         capture_output=True, text=True, timeout=120)
    (OUT_DIR / "obs_report.txt").write_text(rep.stdout + rep.stderr)
    if rep.returncode != 0 or name not in rep.stdout or "infer.gibbs.sample" not in rep.stdout:
        raise AssertionError(f"obs: obs_report_torch.py exited {rep.returncode}: {rep.stderr[-500:]}")
    ratio = dt.p50_s * 1e3 / fwd_ms
    if not 1 / OBS_DEVICE_TIME_RATIO <= ratio <= OBS_DEVICE_TIME_RATIO:
        raise AssertionError(f"obs: device_time of FWD {dt.p50_s * 1e3:.6f} ms against "
                             f"{fwd_ms:.6f} ms on the kernels line")
    # off, on, off: the first run pays the first calls' allocations, so the
    # plane's cost is read against the third
    out = dict(series=N_SERIES, T=T_FIT, warmup=OBS_WARMUP, samples=OBS_SAMPLES,
               seconds_off_on_off=[off["seconds"], on["seconds"], off2["seconds"]],
               sweep_ms_on=on["seconds"] * 1e3 / sweeps, sweep_ms_off=off2["seconds"] * 1e3 / sweeps,
               launches=on["launches"], sweep_split=split, metrics=snap,
               fwd_device_time_ms=dt.p50_s * 1e3, fwd_device_time_min_ms=dt.min_s * 1e3,
               fwd_kernels_line_ms=fwd_ms, device_time_ratio=ratio,
               fwd_roofline=roofline(cost, dt.p50_s, name), manifest=str(path),
               power_limit=man["power_limit"], builds=man["compile"]["backend_compiles"],
               build_seconds=man["compile"]["compile_seconds"], peak_memory=man["peak_memory"])
    emit("obs", draws_bitwise_equal=True, **out)
    return out


# a driver runs as ``python examples_torch/<driver> ...`` would, at the
# niceness its first argument gives, after blocking_sync (its source,
# then this) in its own process
DRIVER_LAUNCH = """
import os, runpy, sys
os.nice(int(sys.argv.pop(1)))
blocking_sync()
sys.argv = sys.argv[1:]
sys.path[0] = os.path.dirname(sys.argv[0])
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def start_drivers():
    """Start each ``examples_torch/`` driver ``--quick`` on the card, a
    process of its own, all at once (at ``POOL_NICE``, its context set to
    sleep while it waits for the card, as the pool's are; listed in
    ``BESIDE`` while it runs), each with a thread that reads its output
    and its seconds to exit; returns ``(processes, {driver: future}, the
    threads' executor)``."""
    procs = {}
    launch = inspect.getsource(blocking_sync) + DRIVER_LAUNCH
    try:
        with BESIDE["lock"]:
            for driver, _ in DRIVERS:
                procs[driver] = subprocess.Popen(
                    [sys.executable, "-c", launch, str(POOL_NICE),
                     str(ROOT / "examples_torch" / driver), "--quick",
                     *DRIVER_ARGS.get(driver, ())], cwd=ROOT,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                BESIDE["pids"].add(procs[driver].pid)
    except BaseException:
        stop_processes(procs)
        raise
    t0 = time.perf_counter()

    def wait(driver):
        try:
            out, _ = procs[driver].communicate(timeout=DRIVER_TIMEOUT_S)
        finally:
            with BESIDE["lock"]:
                BESIDE["pids"].discard(procs[driver].pid)
        return out, time.perf_counter() - t0

    waiters = ThreadPoolExecutor(max_workers=len(DRIVERS))
    return procs, {driver: waiters.submit(wait, driver) for driver, _ in DRIVERS}, waiters


def stop_processes(procs) -> None:
    with BESIDE["lock"]:
        BESIDE["pids"].difference_update(p.pid for p in procs.values())
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_drivers(started):
    """The drivers of :func:`start_drivers`, waited for: each exits 0
    within ``DRIVER_TIMEOUT_S`` and prints its line; its output goes to
    ``chiprun_out/drivers/``. Every process still running at the end (a
    timeout, an error) is killed."""
    procs, done, waiters = started
    out_dir = OUT_DIR / "drivers"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = {}
    try:
        for driver, line in DRIVERS:
            out, secs = done[driver].result()
            (out_dir / f"{Path(driver).stem}.log").write_text(out)
            rows[driver] = dict(rc=procs[driver].returncode, seconds=secs,
                                line=next((ln for ln in out.splitlines() if line in ln), None))
    finally:
        stop_processes(procs)
        waiters.shutdown(wait=True)
    bad = {d: r for d, r in rows.items() if r["rc"] != 0 or r["line"] is None}
    if bad or len(rows) != len(DRIVERS):
        raise AssertionError(f"drivers: {bad or 'not all ran'} (chiprun_out/drivers/)")
    emit("drivers", drivers=rows, seconds=max(r["seconds"] for r in rows.values()))
    return rows


# ---------------------------------------------------------------------------
# the tooling: the port's static analyzer and run report on the card's host
# ---------------------------------------------------------------------------

# a tool runs as ``python -m <module> ...`` would, at the niceness its
# first argument gives
TOOL_LAUNCH = """
import os, runpy, sys
os.nice(int(sys.argv.pop(1)))
module = sys.argv.pop(1)
sys.argv[0] = module
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
# the host check: the package imports, its plot library names matplotlib
# when it is missing
HOST_CHECK = """
import json, os, sys
os.nice(int(sys.argv[1]))
import hhmm_tpu_torch
out = {"import_hhmm_tpu_torch": True}
try:
    import hhmm_tpu_torch.viz
    out["viz"] = "imported"
except ModuleNotFoundError as e:
    out["viz"] = "missing"
    out["viz_error"] = {"name": e.name, "message": str(e)}
print(json.dumps(out))
"""
TOOLING_TIMEOUT_S = 300


def start_tooling():
    """Start the analyzer and the host check, each a process of its own
    beside the pool (at ``POOL_NICE``, listed in ``BESIDE`` while it
    runs, so that this process's timings stop them), each with a thread
    that waits for it and takes its seconds; returns ``(processes,
    {name: future}, the threads' executor, open files)``."""
    OUT_DIR.mkdir(exist_ok=True)
    files = {"analysis": open(OUT_DIR / "analysis.json", "w"),
             "analysis_err": open(OUT_DIR / "analysis.stderr.txt", "w")}
    cmds = {
        "analysis": ([sys.executable, "-c", TOOL_LAUNCH, str(POOL_NICE), "hhmm_tpu_torch.analysis",
                      "--format", "json"], files["analysis"], files["analysis_err"]),
        "host_check": ([sys.executable, "-c", HOST_CHECK, str(POOL_NICE)], subprocess.PIPE,
                       subprocess.PIPE),
    }
    procs = {}
    try:
        with BESIDE["lock"]:
            for name, (cmd, out, err) in cmds.items():
                procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err, text=True)
                BESIDE["pids"].add(procs[name].pid)
    except BaseException:
        stop_processes(procs)
        for f in files.values():
            f.close()
        raise
    t0 = time.perf_counter()

    def wait(name):
        try:
            out, err = procs[name].communicate(timeout=TOOLING_TIMEOUT_S)
        finally:
            with BESIDE["lock"]:
                BESIDE["pids"].discard(procs[name].pid)
        return out, err, time.perf_counter() - t0

    waiters = ThreadPoolExecutor(max_workers=len(procs))
    return procs, {n: waiters.submit(wait, n) for n in procs}, waiters, files


def stop_tooling(started) -> None:
    procs, _, waiters, files = started
    stop_processes(procs)
    waiters.shutdown(wait=True)
    for f in files.values():
        f.close()


def draw_gibbs_decode(decode) -> str:
    """One figure of the Gibbs decode (``plot_stateprobability`` of the
    first series' draws) into ``chiprun_out/``; only where matplotlib is
    there."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from hhmm_tpu_torch.viz import plot_stateprobability

    fig = plot_stateprobability(decode["alpha"], decode["gamma"])
    path = OUT_DIR / "tooling_gibbs_decode.png"
    fig.savefig(path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return str(path)


def phase_tooling(started, decode):
    """The tooling processes of :func:`start_tooling`, waited for: each
    exits 0; the analyzer's JSON reports no unsuppressed error; the host
    imported the package and its plot library raised naming matplotlib
    (or drew); then ``obs_report_torch.py`` renders the obs phase's
    manifest with the analyzer's report into ``chiprun_out/
    obs_report.txt`` (exit 0, the analysis section CLEAN)."""
    procs, done, _, files = started
    secs, outs = {}, {}
    for name in procs:
        out, err, secs[name] = done[name].result()
        outs[name] = out
        if procs[name].returncode != 0:
            raise AssertionError(f"tooling: {name} exited {procs[name].returncode}: "
                                 f"{(err or '')[-500:]} (chiprun_out/analysis.stderr.txt)")
    files["analysis"].close()
    report = json.loads((OUT_DIR / "analysis.json").read_text())
    errors = [f for f in report["findings"] if f["severity"] == "error"]
    if errors or not report["ok"]:
        raise AssertionError(f"tooling: the analyzer found {errors[:5]}")
    host = json.loads(outs["host_check"].strip().splitlines()[-1])
    figure = None
    if host["viz"] == "missing":
        if host["viz_error"]["name"] != "matplotlib":
            raise AssertionError(f"tooling: viz raised for {host['viz_error']}, not matplotlib")
    else:
        figure = draw_gibbs_decode(decode)
    t0 = time.perf_counter()
    rep = subprocess.run([sys.executable, str(ROOT / "obs_report_torch.py"),
                          str(OUT_DIR / "obs_manifest.json"), "--analysis",
                          str(OUT_DIR / "analysis.json")],
                         capture_output=True, text=True, timeout=120)
    secs["obs_report"] = time.perf_counter() - t0
    (OUT_DIR / "obs_report.txt").write_text(rep.stdout + rep.stderr)
    titles = re.findall(r"^== (.*) ==$", rep.stdout, flags=re.M)
    if rep.returncode != 0 or "analysis" not in titles or \
            "CLEAN (zero unsuppressed findings)" not in rep.stdout:
        raise AssertionError(f"tooling: obs_report_torch.py exited {rep.returncode}: "
                             f"{rep.stderr[-500:]}")
    by_rule = {rid: {"findings": r["findings"], "suppressed": r["suppressed"]}
               for rid, r in sorted(report["rules"].items())
               if r["findings"] or r["suppressed"]}
    emit("tooling", files_scanned=report["files_scanned"], rules=len(report["rules"]),
         findings=len(report["findings"]), suppressed=report["suppressed_count"],
         by_rule=by_rule, allowlist_entries=report["allowlist_entries"],
         lock_order=report["extras"]["lock_order"]["verdict"],
         locks=len(report["extras"]["lock_order"]["locks"]), host=host, figure=figure,
         seconds=secs, report_sections=titles)


# ---------------------------------------------------------------------------
# the time-parallel scans, the measured dispatch and the placement planner
# ---------------------------------------------------------------------------


def scan_case(seed: int, N: int, T: int, K: int, device):
    """``(log_pi, log_A, log_obs, mask, u, gate_key, state_key)`` in the
    dispatch layout ``[N, T, K]``: normalized (pi, A), N(-1, 1)
    emissions, ragged mask (lengths in [T/2, T]), uniforms, a sign gate
    on a Tayal-like state key."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    f32 = dict(dtype=torch.float32, device=device)
    lengths = rng.integers(T // 2, T + 1, size=N)
    return (torch.as_tensor(log_norm(rng.normal(size=(N, K))), **f32),
            torch.as_tensor(log_norm(rng.normal(size=(N, K, K))), **f32),
            torch.as_tensor(rng.normal(size=(N, T, K)) - 1.0, **f32),
            torch.as_tensor(np.arange(T)[None, :] < lengths[:, None], **f32),
            torch.as_tensor(rng.random((N, T)), **f32),
            torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32),
            torch.as_tensor(np.resize([1.0, 0.0, 0.0, 1.0], (N, K)), **f32))


def parted(a, b):
    """``{lane: t*}`` of the lanes where two ``[N, T]`` paths differ, t*
    the last step where they do."""
    diff = (a != b).float()
    lanes = (diff.sum(1) > 0).nonzero()[:, 0].tolist()
    last = (a.shape[1] - 1 - diff.flip(1).argmax(1)).tolist()
    return {n: last[n] for n in lanes}


def top_gap(v):
    s = torch.sort(v, descending=True).values
    return float(s[0] - s[1]) if v.numel() > 1 else float("inf")


def viterbi_margins(log_pi, log_A, log_obs, mask, path, parts):
    """For each parting lane, the reference's own margin at its parting
    step t*: the top-two gap of delta at T-1, or of ``delta[t*] +
    A[:, path[t*+1]]`` (the plain max-plus recursion of that lane)."""
    out = {}
    for n, ts in parts.items():
        tv = log_A.ndim == 4
        d = log_pi[n] + log_obs[n, 0]
        deltas = [d]
        for t in range(1, ts + 1):
            lA = log_A[n, t - 1] if tv else log_A[n]
            new = (d[:, None] + lA).amax(0) + log_obs[n, t]
            d = torch.where(mask[n, t] > 0, new, d) if mask is not None else new
            deltas.append(d)
        if ts == log_obs.shape[1] - 1:
            out[n] = top_gap(deltas[ts])
        else:
            lA = log_A[n, ts] if tv else log_A[n]
            out[n] = top_gap(deltas[ts] + lA[:, path[n, ts + 1]])
    return out


def ffbs_margins(log_pi, log_A, log_obs, mask, u, z, parts, gk=None, sk=None):
    """For each parting lane, min_k |u - cum_k| of the reference's draw at
    its parting step (the gated filter of that lane, the draw rule of
    ``ffbs_invcdf_reference``)."""
    out = {}
    for n, ts in parts.items():
        # a padded tail repeats the last valid draw: the parting is there
        ts = min(ts, int(mask[n].sum()) - 1)
        if gk is None:
            la, _ = forward_filter(log_pi[n], log_A[n], log_obs[n], mask[n])
        else:
            c = gk[n][:, None] == sk[n][None, :]
            la, _ = forward_filter(log_pi[n], torch.where(c[1:, None, :], log_A[n], 0.0),
                                   log_obs[n], mask[n])
        logits = la[ts]
        if ts < log_obs.shape[1] - 1:
            j = int(z[n, ts + 1])
            g = bool(mask[n, ts + 1] > 0) and (gk is None or bool(gk[n, ts + 1] == sk[n, j]))
            if g:
                logits = logits + log_A[n][:, j]
        cum = torch.cumsum(torch.softmax(logits, -1)[:-1], 0)
        out[n] = float((u[n, ts] - cum).abs().min()) if cum.numel() else float("inf")
    return out


def gate_parted(name, parts, margins):
    """Every parting lane's margin under ``AS_MARGIN``; returns the counts."""
    wide = {n: m for n, m in margins.items() if not m < AS_MARGIN}
    if wide:
        raise AssertionError(f"{name}: {len(wide)} lanes part from the reference with a margin "
                             f"of at least {AS_MARGIN}: {dict(list(wide.items())[:5])}")
    return {"lanes_differing": len(parts), "lanes_under_margin": len(margins)}


def close(name, got, want, rtol=AS_RTOL, atol=AS_ATOL):
    """Finite where ``want`` is, within ``rtol`` + ``atol``; returns the
    largest absolute difference."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: finite entries differ")
    diff = (got[fin] - want[fin]).abs()
    bad = diff > atol + rtol * want[fin].abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries beyond rtol {rtol} + atol {atol}, "
                             f"max abs {float(diff.max()):.3g}")
    return float(diff.max()) if diff.numel() else 0.0


def branch_ms(fn, branches, reps):
    return {b: time_ms(lambda b=b: fn(b), reps=reps, warmup=1) for b in branches}


def phase_assoc(device, qs):
    """The time-parallel scans on the card (see the module docstring):
    each dispatch entry's ``assoc`` branch against its ``cuda`` branch at
    the main path's shape, the two time-varying decodes ``seq`` against
    ``assoc``, the sequence-sharded filter; ms of every branch."""
    N, T, K = N_SERIES, T_FIT, K_TAYAL
    lp, lA, lo, m, u, gk, sk = scan_case(SEED_AS, N, T, K, device)
    before = launch_counts()
    rows, counts, errs = {}, {}, {}
    gen = lambda: torch.Generator(device=device).manual_seed(SEED_AS)  # noqa: E731
    out = {b: {"filter": td.forward_filter_dispatch(lp, lA, lo, m, time_parallel=b),
               "backward": td.backward_dispatch(lA, lo, m, time_parallel=b),
               "smooth": td.smooth_dispatch(lp, lA, lo, m, time_parallel=b),
               "viterbi": td.viterbi_dispatch(lp, lA, lo, m, time_parallel=b),
               "ffbs": td.ffbs_dispatch(gen(), lp, lA, lo, m, time_parallel=b),
               "ffbs_gated": td.ffbs_dispatch(gen(), lp, lA, lo, m, gk, sk, time_parallel=b)}
           for b in ("cuda", "assoc")}
    c, a = out["cuda"], out["assoc"]
    errs["alpha_probs"] = close("assoc filter", torch.softmax(a["filter"][0], -1),
                                torch.softmax(c["filter"][0], -1))
    errs["loglik"] = close("assoc loglik", a["filter"][1], c["filter"][1], atol=0.0)
    errs["beta"] = close("assoc beta", a["backward"], c["backward"])
    errs["gamma"] = close("assoc gamma", a["smooth"][2].exp(), c["smooth"][2].exp())
    errs["smooth_loglik"] = close("assoc smooth loglik", a["smooth"][3], c["smooth"][3], atol=0.0)
    errs["viterbi_score"] = close("assoc viterbi score", a["viterbi"][1], c["viterbi"][1], atol=0.0)
    p = parted(a["viterbi"][0], c["viterbi"][0])
    counts["viterbi"] = gate_parted("assoc viterbi", p,
                                    viterbi_margins(lp, lA, lo, m, c["viterbi"][0], p))
    uf = torch.rand((N, T), generator=gen(), device=device)  # the uniforms both routes drew
    for key, gate in (("ffbs", (None, None)), ("ffbs_gated", (gk, sk))):
        errs[f"{key}_loglik"] = close(f"assoc {key} loglik", a[key][1], c[key][1], atol=0.0)
        p = parted(a[key][0], c[key][0])
        counts[key] = gate_parted(f"assoc {key}", p,
                                  ffbs_margins(lp, lA, lo, m, uf, c[key][0], p, *gate))
    want = {cs.FWD.name: 2, cs.BWD_SAMPLE.name: 2, cs.FILTER.name: 2, cs.BETA.name: 2,
            cs.VITERBI.name: 1, cs.BACKTRACK.name: 1}
    if rose_since(before) != want:  # the cuda branch's, and nothing from assoc
        raise AssertionError(f"assoc: launches {rose_since(before)}, expected {want}")
    # ms of every branch at this shape
    ms = {
        "filter": branch_ms(lambda b: td.forward_filter_dispatch(lp, lA, lo, m, time_parallel=b),
                            ("cuda", "assoc", "seq"), 3),
        "smooth": branch_ms(lambda b: td.smooth_dispatch(lp, lA, lo, m, time_parallel=b),
                            ("cuda", "assoc", "seq"), 3),
        "viterbi": branch_ms(lambda b: td.viterbi_dispatch(lp, lA, lo, m, time_parallel=b),
                             ("cuda", "assoc", "seq"), 3),
        "ffbs": branch_ms(lambda b: td.ffbs_dispatch(gen(), lp, lA, lo, m, time_parallel=b),
                          ("cuda", "assoc", "seq"), 3),
        "ffbs_gated": branch_ms(
            lambda b: td.ffbs_dispatch(gen(), lp, lA, lo, m, gk, sk, time_parallel=b),
            ("cuda", "assoc", "seq"), 3),
    }
    # the sequence-sharded filter: AS_SHARDS chunks, all on this card
    sa, sl = tassoc.forward_filter_seqshard(lp, lA, lo, m, devices=[device] * AS_SHARDS)
    fa, fl = a["filter"]
    errs["seqshard_probs"] = close("seqshard", torch.softmax(sa, -1), torch.softmax(fa, -1))
    errs["seqshard_loglik"] = close("seqshard loglik", sl, fl, atol=0.0)
    ms["seqshard"] = time_ms(lambda: tassoc.forward_filter_seqshard(
        lp, lA, lo, m, devices=[device] * AS_SHARDS), reps=3, warmup=1)

    # the stan gate's OOS decode: time-varying operators
    xs, ss = tayal_batch(N_SERIES, T_FIT + T_OOS, seed=SEED_DATA, device=device)
    data = {"x": xs[:, :T_FIT], "sign": ss[:, :T_FIT], "x_oos": xs[:, T_FIT:],
            "sign_oos": ss[:, T_FIT:]}
    draws = qs[:, 0, :: SAMPLES // N_DRAWS][:, :N_DRAWS]
    lite = TayalHHMMLite(gate_mode="stan")
    gs = {b: lite.generated(draws, data, device=device, time_parallel=b) for b in ("seq", "assoc")}
    errs["tayal_alpha"] = close("tayal alpha", gs["assoc"]["alpha"], gs["seq"]["alpha"])
    errs["tayal_alpha_oos"] = close("tayal alpha_oos", gs["assoc"]["alpha_oos"],
                                    gs["seq"]["alpha_oos"])
    n = N_SERIES * N_DRAWS
    params, _ = lite.unpack(draws.reshape(n, -1))
    ops = lite._gated(params, data["x_oos"].repeat_interleave(N_DRAWS, 0),
                      data["sign_oos"].repeat_interleave(N_DRAWS, 0))
    za, zs_ = (gs[b]["zstar_oos"].reshape(n, T_OOS) for b in ("assoc", "seq"))
    p = parted(za, zs_)
    counts["tayal_oos_viterbi"] = gate_parted("tayal oos viterbi", p,
                                              viterbi_margins(*ops, None, zs_, p))
    ms["tayal_generated"] = branch_ms(
        lambda b: lite.generated(draws, data, device=device, time_parallel=b), ("seq", "assoc"), 2)
    ms["tayal_oos_viterbi"] = branch_ms(
        lambda b: td.viterbi_dispatch(*ops, time_parallel=b), ("seq", "assoc"), 3)

    # an IOHMM-reg decode: the rank-1 time-varying log_A
    io_data, _, _ = io_batch("reg", device)
    io = IOHMMReg(K=IO_K_REG, M=IO_M)
    io_draws = default_init(io, io_data, IO_SERIES, AS_IO_DRAWS, seed=SEED_AS, device=device)
    go = {b: io.generated(io_draws, io_data, device=device, time_parallel=b) for b in ("seq", "assoc")}
    for key in ("alpha", "gamma"):
        errs[f"iohmm_{key}"] = close(f"iohmm {key}", go["assoc"][key], go["seq"][key])
    errs["iohmm_loglik"] = close("iohmm loglik", go["assoc"]["loglik"], go["seq"]["loglik"], atol=0.0)
    _, flat, lanes = zoo_base.draw_lanes(io_draws, io_data, device, io.event_ndim)
    io_ops = io.build(io.unpack(flat)[0], lanes)
    ni = IO_SERIES * AS_IO_DRAWS
    za, zs_ = (go[b]["zstar"].reshape(ni, IO_T) for b in ("assoc", "seq"))
    p = parted(za, zs_)
    counts["iohmm_viterbi"] = gate_parted("iohmm viterbi", p, viterbi_margins(*io_ops, zs_, p))
    ms["iohmm_generated"] = branch_ms(
        lambda b: io.generated(io_draws, io_data, device=device, time_parallel=b), ("seq", "assoc"), 2)
    row = dict(shape=dict(N=N, T=T, K=K), max_abs_err=errs, parted=counts, ms=ms,
               tayal=dict(lanes=n, T_oos=T_OOS), iohmm=dict(lanes=ni, T=IO_T, K=IO_K_REG),
               seqshard_shards=AS_SHARDS, margin=AS_MARGIN)
    emit("assoc", **row)
    return row


def phase_dispatch_db(device):
    """The measured dispatch: ``decode_kernel_fns`` timed at the probe's
    grid (``seq`` up to ``DB_SEQ_T_MAX``) into a DB in ``OUT_DIR``;
    with it active, ``"auto"``
    resolves to the measured winner and the spans say so; with an empty
    DB, the default routes."""
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "kernel_costs_probe.json"
    if path.exists():
        path.unlink()
    db = obs_profile.KernelCostDB(str(path))
    fns = obs_profile.decode_kernel_fns()
    rng = np.random.default_rng(SEED_AS)
    name = torch.cuda.get_device_name(0)
    grid = {}
    for K in DB_KS:
        for T in DB_TS:
            inputs = obs_profile.dirichlet_hmm_inputs(rng, K, T, batch=N_SERIES, device=device)
            for kernel, branches in fns.items():
                cell = grid.setdefault((kernel, K, T), {})
                for b, fn in branches.items():
                    if b == "seq" and T > DB_SEQ_T_MAX:
                        continue
                    t = device_time(fn, *inputs, reps=DB_REPS[b])
                    db.put_row(kernel=kernel, branch=b, K=K, T=T, B=N_SERIES, dtype="float32",
                               timing=t, source="chip_smoke.py dispatch_db")
                    cell[b] = t.p50_s * 1e3
    db.save()
    hom, tv = ("cuda", "assoc"), ("seq", "assoc")
    try:
        obs_profile.set_db(str(path))
        for key, cell in grid.items():
            kernel, K, T = key
            for allowed in (hom, tv):
                if not all(b in cell for b in allowed):
                    continue  # a branch not timed at this T
                want = min(allowed, key=lambda b: (cell[b], {"seq": 0, "assoc": 1}.get(b, 2)))
                got = td.resolve_auto(K, T, kernel=kernel, device_type="cuda", allowed=allowed)
                if got != (want, "db"):
                    raise AssertionError(f"dispatch_db: {key} {allowed} resolved {got}, "
                                         f"measured winner {want}")
                cell[f"winner_{'homogeneous' if allowed == hom else 'time_varying'}"] = want
            if td.resolve_routed(K, T, kernel=kernel, cuda_ok=True, device_type="cuda") == "seq":
                raise AssertionError(f"dispatch_db: {key} routed a homogeneous call to seq")
        # a dispatch under the DB names the branch that ran
        obs_trace.reset()
        obs_trace.enable()
        lp, lA, lo, m = obs_profile.dirichlet_hmm_inputs(rng, 4, 1024, batch=N_SERIES,
                                                         device=device)
        td.forward_filter_dispatch(lp, lA, lo, m)
        td.viterbi_dispatch(lp, lA, lo, m)
        spans = sorted(obs_trace.aggregate())
        want = sorted(f"kernels.dispatch.{e}[{grid[(k, 4, 1024)]['winner_homogeneous']}]"
                      for e, k in (("forward_filter", "filter"), ("viterbi", "viterbi")))
        if spans != want:
            raise AssertionError(f"dispatch_db: spans {spans}, expected {want}")
        # an empty DB: every route the default one
        obs_profile.set_db(obs_profile.KernelCostDB(str(OUT_DIR / "kernel_costs_empty.json")))
        for K in DB_KS:
            for T in DB_TS:
                for kernel in fns:
                    got = (td.resolve_auto(K, T, kernel=kernel, device_type="cuda", allowed=hom),
                           td.resolve_auto(K, T, kernel=kernel, device_type="cuda", allowed=tv))
                    if got != (("cuda", "default"), ("seq", "default")):
                        raise AssertionError(f"dispatch_db: empty DB resolved {got}")
    finally:
        obs_trace.reset()
        obs_trace.tracer.use_env()
        obs_profile.set_db(None)
    emit("dispatch_db", device_kind=name, lanes=N_SERIES, reps=DB_REPS, db=str(path),
         rows=len(db.rows()), spans=spans,
         ms={f"{k} K={K} T={T}": cell for (k, K, T), cell in grid.items()})
    return grid


def phase_plan(device):
    """The planner on one card: a planned Gibbs fit bitwise equal to the
    unplanned one, the manifest's stanza, and the time_parallel=True
    fit against the kernels' route (see the module docstring). Returns
    the planned fit's launches."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode="hard")
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    sweeps = PLAN_WARMUP + PLAN_SAMPLES
    plan = make_plan(WorkloadShape(B=N_SERIES, T=T_FIT, C=1, K=K_TAYAL), devices=[device],
                     chunk_size=N_SERIES)
    runs = {}
    for key, cfg, kw in (
            ("planned", GibbsConfig(PLAN_WARMUP, PLAN_SAMPLES, 1), dict(plan=plan)),
            ("unplanned", GibbsConfig(PLAN_WARMUP, PLAN_SAMPLES, 1), dict(chunk_size=N_SERIES)),
            ("assoc", GibbsConfig(PLAN_WARMUP, PLAN_SAMPLES, 1, time_parallel=True),
             dict(chunk_size=N_SERIES))):
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        qs, stats = fit_batched(model, data, cfg, init=init, seed=SEED_SAMPLER, device=device, **kw)
        sync()
        runs[key] = dict(qs=qs, stats=stats, seconds=time.perf_counter() - t0,
                         launches=rose_since(before))
        if key == "planned":
            stanza = obs_manifest.noted_stanza("plan")
    pl, un, asc = runs["planned"], runs["unplanned"], runs["assoc"]
    if stanza != plan.stanza():
        raise AssertionError(f"plan: the manifest's stanza {stanza} is not the plan's")
    if not torch.equal(pl["qs"], un["qs"]) or any(
            not torch.equal(pl["stats"][k], un["stats"][k]) for k in pl["stats"]):
        raise AssertionError("plan: the planned fit is not bitwise the unplanned fit")
    want = {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}
    if pl["launches"] != want or un["launches"] != want or asc["launches"]:
        raise AssertionError(f"plan: launches {pl['launches']}, {un['launches']}, "
                             f"{asc['launches']} (assoc), expected {want}, {want}, none")
    if not bool(asc["stats"]["chain_healthy"].all()):
        raise AssertionError("plan: a time_parallel=True chain was quarantined")
    # folded posterior means, averaged over the series, in MCSE
    mats = {k: canonical_draws(model.constrained_draws(runs[k]["qs"]))[0] for k in ("unplanned", "assoc")}
    B, C, S, P = mats["assoc"].shape
    mean = {k: v.mean(axis=(1, 2)) for k, v in mats.items()}  # [B, P]
    ess = {k: ess_many(np.moveaxis(v, -1, 1).reshape(B * P, C, S)).reshape(B, P)
           for k, v in mats.items()}
    mcse2 = {k: v.var(axis=(1, 2), ddof=1) / np.maximum(ess[k], 1.0) for k, v in mats.items()}
    pooled = np.sqrt((mcse2["assoc"] + mcse2["unplanned"]).sum(0)) / B  # MCSE of the mean over B
    z = np.abs((mean["assoc"] - mean["unplanned"]).mean(0)) / np.maximum(pooled, 1e-12)
    # per series and parameter (reported: 20 draws make each MCSE a rough estimate)
    z_each = np.abs(mean["assoc"] - mean["unplanned"]) / np.maximum(
        np.sqrt(mcse2["assoc"] + mcse2["unplanned"]), 1e-12)
    if not z.max() <= PLAN_MCSE:
        raise AssertionError(f"plan: series-averaged posterior means {z.max():.3g} MCSE from the "
                             f"cuda route's (limit {PLAN_MCSE})")
    same = int(sum(torch.equal(asc["qs"][b], un["qs"][b]) for b in range(B)))
    emit("plan", stanza=stanza, planned_bitwise_equal=True, launches=pl["launches"],
         sweeps=sweeps, series=N_SERIES, T=T_FIT,
         sweep_ms={k: runs[k]["seconds"] * 1e3 / sweeps for k in runs},
         assoc_mean_gap_mcse_max=float(z.max()), assoc_series_bitwise_equal=same,
         assoc_series_param_within_mcse_share=float((z_each <= PLAN_MCSE).mean()),
         assoc_launches=asc["launches"])
    return pl["launches"]


def wf_margin(T: int) -> float:
    """The margin rule of a decode bucket of ``T`` steps: ``AS_MARGIN`` at
    the main path's T, growing with T as the f32 rounding of the
    unnormalised log-alpha does (its magnitude, so its ulp, grows
    linearly in T)."""
    return AS_MARGIN * max(1.0, T / T_FIT)


class MedianRecorder:
    """Side effect of ``wf.py``'s ``median_states``: each call's states,
    median probabilities and the top-two gap of the medians, in call
    order, on the host."""

    def __init__(self):
        self.calls = []

    def __call__(self, probs):
        states = median_states(probs)
        D = probs.shape[1]
        srt = torch.sort(probs, dim=1).values
        med = srt[:, D // 2] if D % 2 else (srt[:, D // 2 - 1] + srt[:, D // 2]) / 2
        top = torch.topk(med, 2, dim=-1).values
        self.calls.append((states.cpu(), med.cpu(), (top[..., 0] - top[..., 1]).cpu()))
        return states


class ReplayFit:
    """``wf.py``'s ``fit_batched`` replayed: each call returns the kept
    result of the same call of an earlier run, its data checked equal."""

    def __init__(self, kept):
        self.kept, self.i = kept, 0

    def __call__(self, model, data, config, **kw):
        want, qs, stats = self.kept[self.i]
        self.i += 1
        if set(want) != set(data) or not all(np.array_equal(want[k], data[k]) for k in data):
            raise AssertionError("walk_forward_assoc: a fit group's data differ from the run's")
        return qs, stats


def phase_walk_forward_assoc(device, tasks, fits, medians, res):
    """The Gibbs arm's decode with ``time_parallel=True`` on the
    walk_forward run's draws (see the module docstring)."""
    rec = MedianRecorder()
    phases = {}
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(wf_module, "fit_batched", ReplayFit(fits.kept)), \
            mock.patch.object(wf_module, "median_states", rec):
        res_a = wf_trade(tasks, GibbsConfig(num_warmup=WF_WARMUP, num_samples=WF_SAMPLES,
                                            num_chains=1),
                         gate_mode="hard", chunk_size=WF_CHUNK, phase_timings=phases,
                         seed=SEED_WF, device=device, time_parallel=True)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    if rose:
        raise AssertionError(f"walk_forward_assoc: the assoc decode launched {rose}")
    stamps = sorted(k for k in phases if k.startswith("decode.time_parallel["))
    if not stamps or any("a1v:assoc" not in k for k in stamps):
        raise AssertionError(f"walk_forward_assoc: stamps {stamps}")
    if len(rec.calls) != len(medians.calls):
        raise AssertionError(f"walk_forward_assoc: {len(rec.calls)} median calls against "
                             f"{len(medians.calls)}")
    legs = under = 0
    gaps, dmed = [], {}
    for (sa, ma, _), (sk_, mk, gap) in zip(rec.calls, medians.calls):
        T_b = int(ma.shape[1])
        margin = wf_margin(T_b)
        diff = sa != sk_
        legs += int(diff.sum())
        under += int((diff & (gap < margin)).sum())
        gaps += gap[diff].tolist()
        dmed[T_b] = max(dmed.get(T_b, 0.0), float((ma - mk).abs().max()))
        if not dmed[T_b] <= 2 * margin:
            raise AssertionError(f"walk_forward_assoc: median probabilities {dmed[T_b]:.3g} apart "
                                 f"at T={T_b} (limit {2 * margin:.3g})")
    if legs != under:
        raise AssertionError(f"walk_forward_assoc: {legs - under} leg states differ from the FWD "
                             "decode's where its top-two median gap is at least the margin")
    same_legs = [bool(np.array_equal(a.leg_topstate, b.leg_topstate)) for a, b in zip(res_a, res)]
    def summary(r):  # NaN-aware: a NaN statistic equals itself
        return json.dumps(r.summary, sort_keys=True, default=float)

    for a, b, same in zip(res_a, res, same_legs):
        if same and summary(a) != summary(b):
            raise AssertionError(f"walk_forward_assoc: task {a.symbol}/{a.window}: equal leg "
                                 "states, different trade summaries")
    emit("walk_forward_assoc", tasks=len(tasks), seconds=wall, phase_timings=phases,
         decode_seconds=phases["decode"], legs_differing=legs, legs_under_margin=under,
         gaps_of_differing_legs=sorted(gaps), median_max_abs_diff_by_T=dmed,
         tasks_with_other_leg_states=int(len(tasks) - sum(same_legs)),
         tasks_summaries_equal=int(sum(summary(a) == summary(b) for a, b in zip(res_a, res))),
         margin_by_T={T_b: wf_margin(T_b) for T_b in dmed})


# ---------------------------------------------------------------------------
# the serving plane: bench.py --serve's arm on the card, then its faults
# ---------------------------------------------------------------------------

SERVE_HIST, SERVE_WARM_TICKS, SERVE_TICKS = 512, 2, 254  # 512 + 2 + 254 = 768 steps
SERVE_WARMUP, SERVE_SAMPLES, SERVE_DRAWS = 50, 128, 32
SERVE_BUCKETS, SERVE_TENANTS = (8, 64, 256), 4
SERVE_TRACE_TICKS = 16
SF_SERIES, SF_DRAWS, SF_TICKS, SF_BUCKETS = 32, 8, 64, (8,)
SH_SERIES, SH_DRAWS, SH_TICKS, SH_K, SH_DMAX = 16, 8, 32, 3, 4
CARD = None  # the nvidia-smi name and power limit, set by main()


def serve_ticks(x, sign, t):
    """One tick of observations a series, the scheduler's ``obs`` dicts."""
    return [{"x": int(a), "sign": int(b)} for a, b in zip(x[:, t], sign[:, t])]


def serve_arm(model, reg, n, x, sign, t0, n_ticks, warm, *, tenants=SERVE_TENANTS,
              buckets=SERVE_BUCKETS, history=True, events=False, overlap=False, **kw):
    """Attach ``n`` series from ``reg`` (warm from steps ``[0, t0)``), run
    ``warm`` ticks, reset the throughput window, then run the rest of the
    ``n_ticks`` ticks: sync ``flush`` per tick, or with ``overlap`` the
    pipelined drive (submit tick t while tick t-1 is in the air, then
    harvest it and dispatch tick t). Returns the responses per tick
    (series order), the scheduler, and its seconds and counters."""
    rec = RequestRecorder(enabled=True, window_s=3600.0)
    feed = RegimeEventFeed(hold=1) if events else None
    sched = MicroBatchScheduler(model, buckets=buckets, registry=reg, recorder=rec, events=feed,
                                device=x.device, **kw)
    sids = [f"s{i}" for i in range(n)]
    xh, sh = x.cpu().numpy(), sign.cpu().numpy()
    sync()
    t_a = time.perf_counter()
    rej = sched.attach_many([
        (sid, reg.load(sid), {"x": xh[i, :t0], "sign": sh[i, :t0]} if history else None,
         f"t{i % tenants}") for i, sid in enumerate(sids)])
    sync()
    attach_s = time.perf_counter() - t_a
    if rej:
        raise AssertionError(f"serve: attach rejected {rej[:3]}")
    out = []
    marks = {}

    def take(resps):
        by = {}
        for r in resps:
            by.setdefault(r.series_id, []).append(r)
        return by

    def collect(by):
        for sid in sids:
            for r in by.get(sid, ()):
                out.append(r)

    def mark_warm(t):
        if t == warm:
            sched.metrics.reset_throughput_window()
            rec.reset_window()
            marks.update(compile=sched.metrics.compile_count, nvcc=obs_telemetry.backend_compiles(),
                         t=time.perf_counter())

    if not overlap:
        for t in range(n_ticks):
            mark_warm(t)
            for sid, obs in zip(sids, serve_ticks(xh, sh, t0 + t)):
                sched.submit(sid, obs)
            collect(take(sched.flush()))
    else:
        for t in range(n_ticks + 1):
            mark_warm(t)
            if t < n_ticks:
                for sid, obs in zip(sids, serve_ticks(xh, sh, t0 + t)):
                    sched.submit(sid, obs)
            if t:
                collect(take(sched.harvest()))
            if t < n_ticks:
                sched.dispatch_async()
    wall = time.perf_counter() - marks["t"]
    # every series of a flight shares its stamps: the per-tick sums over
    # n series are n times the per-flight seconds
    sums = rec.totals()
    return out, sched, dict(attach_s=attach_s, wall_s=wall, compile_warm=marks["compile"],
                            nvcc_warm=marks["nvcc"], stanza=rec.stanza(top=SERVE_TENANTS),
                            hidden_s=sums["hidden"] / n, stall_s=sums["stall"] / n,
                            dispatch_stage_s=sums["device"] / n)


def serve_keys(resps):
    """The bytes of every response field a bitwise comparison holds."""
    return [(r.series_id, r.shed, r.degraded, r.healthy_draws, np.asarray(r.probs).tobytes(),
             np.float64(r.loglik).tobytes(),
             None if r.per_draw_loglik is None else np.asarray(r.per_draw_loglik).tobytes(),
             None if r.draw_ok is None else np.asarray(r.draw_ok).tobytes()) for r in resps]


def serve_clean(name, sched, info, n_resp):
    """A clean arm sheds nothing, fails no dispatch and adds no signature
    and no nvcc build after warmup."""
    m = sched.metrics
    bad = dict(shed=m.shed_ticks, dispatch_errors=m.dispatch_errors,
               new_signatures=m.compile_count - info["compile_warm"],
               new_nvcc=obs_telemetry.backend_compiles() - info["nvcc_warm"])
    if any(bad.values()) or n_resp == 0:
        raise AssertionError(f"serve: the {name} arm is not clean: {bad}, {n_resp} responses")


def phase_serve(device):
    """bench.py --serve's arm through hhmm_tpu_torch.serve at full width
    (see the module docstring). Returns the serve path's launches, read
    before the batch filter checks the served state, and the fit's first
    launches at its shape against the plain versions."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    model = TayalHHMM(gate_mode="hard")
    sync()
    t0 = time.perf_counter()
    with LaneRecorder() as rec:
        qs, stats = fit_batched(model, {"x": x[:, :SERVE_HIST], "sign": sign[:, :SERVE_HIST]},
                                GibbsConfig(SERVE_WARMUP, SERVE_SAMPLES, 1), chunk_size=N_SERIES,
                                seed=SEED_SAMPLER, device=device)
        sync()
    fit_s = time.perf_counter() - t0
    healthy = stats["chain_healthy"].cpu().numpy()
    n_ticks = SERVE_WARM_TICKS + SERVE_TICKS
    arms = {}
    with tempfile.TemporaryDirectory() as tmp:
        reg = SnapshotRegistry(tmp)
        qh = qs.cpu().numpy()
        for i in range(N_SERIES):
            reg.save(f"s{i}", snapshot_from_fit(model, qh[i], healthy[i], n_draws=SERVE_DRAWS))
        for name, kw in (("staged", {}), ("resident", dict(resident=True)),
                         ("pipelined", dict(pipeline=True, overlap=True))):
            arms[name] = serve_arm(model, reg, N_SERIES, x, sign, SERVE_HIST, n_ticks,
                                   SERVE_WARM_TICKS, **kw)
        # the tick's host / device split from the obs plane's spans: a
        # short traced pass a mode, the sync one with the sampled flush
        # profile (CUDA events around a warm re-run of the tick's update)
        spans, profiled = {}, {}
        obs_trace.reset()
        obs_trace.enable()
        try:
            for name, kw in (("staged", dict(profile_every=4)),
                             ("pipelined", dict(pipeline=True, overlap=True))):
                _, _, info = serve_arm(model, reg, N_SERIES, x, sign, SERVE_HIST,
                                       SERVE_WARM_TICKS + SERVE_TRACE_TICKS, SERVE_WARM_TICKS, **kw)
                spans[name] = {k: v for k, v in obs_trace.aggregate().items() if k.startswith("serve.")}
                profiled.update(info["stanza"]["profiled_device_ms"])
                obs_trace.reset()
        finally:
            obs_trace.disable()
    launches = launch_counts()
    kernels = kept_vs_plain(rec.calls, "serve")
    # the staged tick's update (one dispatch of the full bucket a tick):
    # its CUDA-event time, launch gaps between its ops included
    update_ms = profiled.get(f"update/b{SERVE_BUCKETS[-1]}")
    if update_ms is None:
        raise AssertionError(f"serve: no flush profile of the full bucket's update: {profiled}")
    ref = serve_keys(arms["staged"][0])
    if len(ref) != N_SERIES * n_ticks:
        raise AssertionError(f"serve: {len(ref)} responses, expected {N_SERIES * n_ticks}")
    for name in ("resident", "pipelined"):
        if serve_keys(arms[name][0]) != ref:
            raise AssertionError(f"serve: the {name} arm's responses are not bitwise the staged arm's")
    for name, (resps, sched, info) in arms.items():
        serve_clean(name, sched, info, len(resps))
    # the last tick's served probabilities of 8 series against the batch
    # filter (FWD) of the same 32 draws over the same 768 steps
    T_all = SERVE_HIST + n_ticks
    sched = arms["staged"][1]
    check = list(range(0, N_SERIES, N_SERIES // 8))
    draws = torch.stack([sched.draw_bank_of(f"s{i}") for i in check])  # [8, D, dim]
    params, _ = model.unpack(draws)
    log_pi, log_A, log_obs, _ = model.build(
        params, {"x": x[check, :T_all], "sign": sign[check, :T_all]})
    D = draws.shape[1]
    before = launch_counts()
    la, _ = forward_alpha(log_pi.reshape(-1, K_TAYAL), log_A.reshape(-1, K_TAYAL, K_TAYAL),
                          log_obs.reshape(-1, T_all, K_TAYAL))
    if rose_since(before) != {cs.FWD.name: 1}:
        raise AssertionError(f"serve: the batch filter launched {rose_since(before)}")
    batch_p = torch.softmax(la[:, -1], dim=-1).reshape(len(check), D, K_TAYAL).mean(1).cpu().numpy()
    last = {r.series_id: r for r in arms["staged"][0][-N_SERIES:]}
    served = np.stack([last[f"s{i}"].probs for i in check])
    gap = float(np.abs(served - batch_p).max())
    if not gap <= wf_margin(T_all):
        raise AssertionError(f"serve: served probs {gap:.3g} from the batch filter "
                             f"(limit {wf_margin(T_all):.3g})")
    lines = {}
    for name, (resps, sched, info) in arms.items():
        summ = sched.metrics.summary()
        ov = info["stanza"]["overall"]
        pipe = info["stanza"]["pipeline"]
        tick_ms = info["wall_s"] / SERVE_TICKS * 1e3
        # the request plane's shares are of host-clock intervals: its
        # "device" stage, the dispatch stage here, runs from dispatch to
        # sync (sync arms) or to commit (pipelined), host launch work
        # included; the card's share of a tick is the flush profile's
        # update time over the tick
        lines[name] = dict(
            attach_s=info["attach_s"], timed_s=info["wall_s"],
            ticks_per_s=SERVE_TICKS / info["wall_s"], series_ticks_per_s=summ["ticks_per_sec"],
            latency_p50_ms=summ["latency_p50_ms"], latency_p99_ms=summ["latency_p99_ms"],
            tick_ms=tick_ms, card_share_of_tick=update_ms / tick_ms,
            queue_share=ov["queue_share"], dispatch_stage_share=ov["device_share"],
            other_share=ov["other_share"], hidden_share_of_dispatch_stage=ov["overlap_share"],
            compile_count=summ["compile_count"],
            new_signatures_after_warmup=summ["compile_count"] - info["compile_warm"],
            nvcc_builds_after_warmup=obs_telemetry.backend_compiles() - info["nvcc_warm"],
            shed=summ["shed_ticks"], h2d_bytes=summ["h2d_bytes"],
            d2h_bytes=summ["d2h_bytes"], carry_resident_bytes=summ["carry_resident_bytes"],
            harvested_flights=pipe["harvested_flights"],
            dispatch_stage_s=info["dispatch_stage_s"], hidden_s=info["hidden_s"],
            stall_s=info["stall_s"])
    emit("serve", card=CARD, series=N_SERIES, draws=SERVE_DRAWS, fit_steps=SERVE_HIST,
         fit_sweeps=SERVE_WARMUP + SERVE_SAMPLES, fit_s=fit_s, ticks=SERVE_TICKS,
         warm_ticks=SERVE_WARM_TICKS, buckets=list(SERVE_BUCKETS), tenants=SERVE_TENANTS,
         arms=lines, bitwise_equal_arms=True, probs_vs_fwd_max_abs=gap,
         margin=wf_margin(T_all), launches={k: v for k, v in launches.items() if v},
         update_device_ms=update_ms, profiled_device_ms=profiled, spans=spans,
         kernels_vs_plain=kernels)
    return launches, kernels


def phase_serve_faults(device):
    """The fault replay (32 series, 8 draws, 64 ticks, buckets (8,)):
    device loss at given dispatches in the sync and pipelined arms, torn
    and slow snapshot loads through the pager; every injected fault comes
    back as a counted shed, series no fault touched equal the clean run
    bitwise, and the event feed emits the same events sync and
    pipelined. Then a GaussianHSMM served 32 ticks, its collapsed probs
    against the batch filter (FILTER)."""
    x, sign = tayal_batch(SF_SERIES, SF_TICKS, seed=SEED_DATA + 1, device=device)
    model = TayalHHMM(gate_mode="hard")
    rng = np.random.default_rng(SEED_DATA)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        reg = SnapshotRegistry(tmp)
        for i in range(SF_SERIES):
            qs = (0.3 * rng.normal(size=(1, 4 * SF_DRAWS, model.n_free))).astype(np.float32)
            reg.save(f"s{i}", snapshot_from_fit(model, qs, n_draws=SF_DRAWS))
        common = dict(buckets=SF_BUCKETS, history=False, events=True)
        clean, sc, _ = serve_arm(model, reg, SF_SERIES, x, sign, 0, SF_TICKS, 1, **common)
        clean_p, sp, _ = serve_arm(model, reg, SF_SERIES, x, sign, 0, SF_TICKS, 1, pipeline=True,
                                   overlap=True, **common)
        if serve_keys(clean_p) != serve_keys(clean):
            raise AssertionError("serve_faults: the clean pipelined arm is not the sync arm")
        ref = {}
        for r in clean:
            ref.setdefault(r.series_id, []).append(serve_keys([r])[0])
        for name, plan, kw in (
                ("device_loss_sync", faults.TrafficFaultPlan(device_loss_at_dispatch=9,
                                                             device_loss_count=3), {}),
                ("device_loss_pipelined", faults.TrafficFaultPlan(device_loss_at_dispatch=9,
                                                                  device_loss_count=3),
                 dict(pipeline=True, overlap=True))):
            with faults.inject(plan):
                resps, sched, _ = serve_arm(model, reg, SF_SERIES, x, sign, 0, SF_TICKS, 1,
                                            **common, **kw)
            out[name] = serve_fault_check(name, resps, sched, ref, expect_shed=3 * SF_BUCKETS[0],
                                          expect_loss=3)
        for name, plan in (("torn_loads", faults.TrafficFaultPlan(tear_load_every=5)),
                           ("slow_loads", faults.TrafficFaultPlan(slow_load_s=0.01,
                                                                  slow_load_every=7))):
            with tempfile.TemporaryDirectory() as tmp2:
                reg2 = SnapshotRegistry(tmp2)
                for i in range(SF_SERIES):
                    reg2.save(f"s{i}", reg.load(f"s{i}"))
                pager = SnapshotPager(reg2, budget_bytes=1 << 30, retry_sleep=lambda d: None,
                                      device=device)
                sched = MicroBatchScheduler(model, buckets=SF_BUCKETS, registry=reg2, pager=pager,
                                            device=device)
                xh, sh = x.cpu().numpy(), sign.cpu().numpy()
                resps = []
                with faults.inject(plan):
                    for t in range(SF_TICKS):
                        for i, obs in enumerate(serve_ticks(xh, sh, t)):
                            sched.submit(f"s{i}", obs)
                        by = {}
                        for r in sched.flush():
                            by.setdefault(r.series_id, []).append(r)
                        resps += [r for i in range(SF_SERIES) for r in by.get(f"s{i}", ())]
                # a torn page-in quarantines the file: that series sheds
                # every tick (it pages in at tick 0, and retries find no file)
                lost = sum(os.path.exists(reg2.path(f"s{i}") + ".corrupt") for i in range(SF_SERIES))
            if (name == "torn_loads") != (lost > 0):
                raise AssertionError(f"serve_faults[{name}]: {lost} snapshots quarantined")
            out[name] = serve_fault_check(name, resps, sched, ref, expect_shed=lost * SF_TICKS,
                                          expect_loss=0, pager=pager.stats())
            if name == "slow_loads":
                out[name]["max_latency_s"] = max(r.latency_s for r in resps)
        # the same events from the clean sync and pipelined arms
    out["events"] = serve_events_equal(sc, sp)
    out["hsmm"] = serve_hsmm(device)
    emit("serve_faults", card=CARD, series=SF_SERIES, draws=SF_DRAWS, ticks=SF_TICKS, **out)


def serve_fault_check(name, resps, sched, ref, expect_shed, expect_loss, pager=None):
    """Every injected fault came back as a counted shed (none escaped:
    the run returned), the shed count is the injected one, and every
    series no fault touched equals the clean run bitwise."""
    m = sched.metrics
    shed = [r for r in resps if r.shed]
    if len(shed) != m.shed_ticks or m.shed_ticks != expect_shed or m.device_loss_events != expect_loss:
        raise AssertionError(f"serve_faults[{name}]: {len(shed)} shed responses, counted "
                             f"{m.shed_ticks}, expected {expect_shed}; device losses "
                             f"{m.device_loss_events}, expected {expect_loss}")
    touched = {r.series_id for r in shed}
    by = {}
    for r in resps:
        by.setdefault(r.series_id, []).append(serve_keys([r])[0])
    untouched = [s for s in ref if s not in touched]
    if not untouched or any(by.get(s) != ref[s] for s in untouched):
        raise AssertionError(f"serve_faults[{name}]: a series no fault touched differs from the "
                             "clean run")
    rec = dict(shed=len(shed), series_touched=len(touched), series_untouched_bitwise=len(untouched),
               device_loss_events=m.device_loss_events, dispatch_errors=m.dispatch_errors)
    if pager is not None:
        rec["pager"] = {k: pager[k] for k in ("loads", "misses", "load_retries")}
    return rec


def serve_events_equal(sync_sched, pipe_sched):
    """The clean sync and pipelined arms' event feeds hold the same flips
    and drift alarms, series by series."""
    evs = [sorted((e.series_id, e.tick, e.kind, e.regime, e.prev_regime)
                  for e in s.events.drain()) for s in (sync_sched, pipe_sched)]
    if evs[0] != evs[1] or not evs[0]:
        raise AssertionError(f"serve_faults: events differ sync/pipelined ({len(evs[0])}, {len(evs[1])})")
    return dict(events=len(evs[0]), flips=sum(e[2] == "flip" for e in evs[0]))


def serve_hsmm(device):
    """A GaussianHSMM (K=3, Dmax=4) served 32 ticks on 16 series x 8
    draws: the collapsed response probabilities against collapse_probs of
    the batch filter (FILTER) of the same draws on the card."""
    model = GaussianHSMM(SH_K, SH_DMAX)
    rng = np.random.default_rng(SEED_DATA + 2)
    x = (rng.normal(size=(SH_SERIES, SH_TICKS)) + rng.integers(-1, 2, size=(SH_SERIES, 1))
         ).astype(np.float32)
    gen = torch.Generator()
    gen.manual_seed(SEED_INIT)
    base = [model.init_unconstrained(gen, {"x": torch.as_tensor(x[i])}).numpy() for i in range(SH_SERIES)]
    draws = np.stack([b + 0.1 * rng.normal(size=(SH_DRAWS, b.shape[0])) for b in base]).astype(np.float32)
    sched = MicroBatchScheduler(model, buckets=(SH_SERIES,), device=device)
    spec = model_spec(model)
    sched.attach_many([(f"h{i}", PosteriorSnapshot(spec=spec, draws=draws[i]), None)
                       for i in range(SH_SERIES)])
    for t in range(SH_TICKS):
        last = sched.tick({f"h{i}": {"x": float(x[i, t])} for i in range(SH_SERIES)})
    if any(r.shed or r.degraded for r in last.values()):
        raise AssertionError("serve_faults[hsmm]: a response was shed or degraded")
    served = collapse_probs(np.stack([last[f"h{i}"].probs for i in range(SH_SERIES)]), SH_DMAX)
    th = torch.as_tensor(draws, device=device).reshape(-1, model.n_free)
    params, _ = model.unpack(th)
    log_pi, log_A, log_obs, _ = model.build(
        params, {"x": torch.as_tensor(x, device=device).repeat_interleave(SH_DRAWS, 0)})
    before = launch_counts()
    la, _ = td.forward_filter_dispatch(log_pi, log_A, log_obs)
    if rose_since(before) != {cs.FILTER.name: 1}:
        raise AssertionError(f"serve_faults[hsmm]: the batch filter launched {rose_since(before)}")
    batch_p = collapse_probs(torch.softmax(la[:, -1], -1).reshape(SH_SERIES, SH_DRAWS, -1).mean(1),
                             SH_DMAX).cpu().numpy()
    gap = float(np.abs(served - batch_p).max())
    if not gap <= wf_margin(SH_TICKS):
        raise AssertionError(f"serve_faults[hsmm]: collapsed probs {gap:.3g} from the batch filter")
    return dict(series=SH_SERIES, draws=SH_DRAWS, ticks=SH_TICKS, K=SH_K, Dmax=SH_DMAX,
                collapsed_probs_vs_filter_max_abs=gap)


def build_with_ffbs_checks(device, t0):
    """Every kernel's source built, one ``nvcc`` each, all started
    together from two host threads: ``FWD``'s and ``BWD_SAMPLE``'s
    sources on one, the rest on the other. Meanwhile this thread runs
    :func:`ffbs_checks`, whose plain versions need no kernel and whose
    kernels wait for the first thread only, then the value-and-grad
    checks' plain versions (:func:`vg_plain_cases`) until the build ends.
    Returns the build report, the build's seconds from ``t0``, the checks
    and the value-and-grad plain cases."""
    first = (cs.FWD, cs.BWD_SAMPLE)
    first_src = [k.source for k in first]
    rest_src = [src for src in dict.fromkeys(k.source for k in ALL_KERNELS)
                if src not in first_src]

    def timed(sources):
        out = build(sources)
        return out, time.perf_counter() - t0

    def ready():
        built.result()
        for k in first:
            k.load()

    with ThreadPoolExecutor(max_workers=2) as pool:
        built = pool.submit(timed, first_src)
        rest = pool.submit(timed, rest_src)
        ffbs = ffbs_checks(device, ready)
        vg_plain = vg_plain_cases(device)
        (r1, s1), (r2, s2) = built.result(), rest.result()
    for k in ALL_KERNELS:
        k.load()
    return {**r1, **r2}, max(s1, s2), ffbs, vg_plain


def reset_all() -> None:
    for k in ALL_KERNELS:
        k.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # the walk-forward ticks are simulated on a host thread while nvcc
    # builds (the build waits on its compilers, so the two overlap)
    sim_pool = ThreadPoolExecutor(max_workers=1)
    sim = sim_pool.submit(wf_tasks)
    sim_pool.shutdown(wait=False)
    # (phase group, start) on the host clock, for the timeline line; the
    # build group holds the FFBS checks, run beside it
    t0 = time.perf_counter()
    clock = [("build", t0)]
    report, build_s, ffbs, vg_plain = build_with_ffbs_checks(device, t0)
    per_source = {s: {"seconds": r["seconds"], "cached": r["cached"]} for s, r in report.items()}
    emit("build", seconds=build_s, per_source=per_source,
         with_ffbs_checks_seconds=time.perf_counter() - t0)
    usage = {src: ptxas_usage(r["log"]) for src, r in report.items()}
    emit("ptxas", **usage)
    # the forward core (fwd_core.cuh) in its three modes (0 clamped: FWD,
    # ungated and gated; 1 guarded: FILTER; 2 max-plus: VITERBI) at K=4,
    # 16 and, for the decode, 32: registers, spill store and load bytes
    # (None for a cached build)
    emit("ptxas_fwd_core", **{
        f"{mode}_K{K}": usage[k.source.name].get(f"forward_kernel<{K},{args}>")
        for mode, k, args, ks in (
            ("fwd", cs.FWD, "0,false", (4, 16)), ("fwd_gated", cs.FWD, "0,true", (4, 16)),
            ("filter", cs.FILTER, "1,false", (4, 16, 32)),
            ("viterbi", cs.VITERBI, "2,false", (4, 16, 32)))
        for K in ks})

    emit("kernel_resources", K=list(TABLE_KS), **kernel_resources(usage))

    clock.append(("kernels_ffbs_vg_traj", time.perf_counter()))
    kern = phase_kernels(device, ffbs)
    vgk = phase_kernels_vg(device, vg_plain)
    del vg_plain
    trk = phase_kernels_traj(device)

    # main path 1, the Gibbs fit and its decode: counts from zero, read
    # after the decode
    clock.append(("gibbs", time.perf_counter()))
    reset_all()
    qs, gibbs_phi = phase_fit(device, kern["timing"]["fwd_ms"] + kern["timing"]["bwd_ms"])
    phase_decode(device, qs)
    gibbs = {k.name: k.launches for k in ALL_KERNELS}
    # main path 2, the fused ChEES fit
    clock.append(("chees", time.perf_counter()))
    reset_all()
    chees_qs, chees_stats, chees_phi = phase_chees(device, gibbs_phi)
    chees = {k.name: k.launches for k in ALL_KERNELS}
    phase_chees_repeat(device, chees_qs, chees_stats)
    phase_chees_seeds(device, chees_stats)
    # its unfused form
    clock.append(("chees_unfused", time.perf_counter()))
    reset_all()
    phase_chees_unfused(device)
    unfused = {k.name: k.launches for k in ALL_KERNELS}
    clock.append(("kernels_decode", time.perf_counter()))
    deck = phase_kernels_decode(device)
    clock.append(("kernels_wide", time.perf_counter()))
    widek = phase_kernels_wide(device)
    clock.append(("kernels_big", time.perf_counter()))
    bigk = phase_kernels_big(device)
    clock.append(("kernels_k1", time.perf_counter()))
    k1 = phase_kernels_k1(device)
    # the obs plane on main path 1 (plane off, then on; its own counts)
    clock.append(("obs", time.perf_counter()))
    obs = phase_obs(device, kern["timing"]["fwd_ms"])
    # the time-parallel scans against the kernels, the measured dispatch,
    # and the planner (main path 22: the planned Gibbs fit, its own counts)
    clock.append(("assoc", time.perf_counter()))
    phase_assoc(device, qs)
    clock.append(("dispatch_db", time.perf_counter()))
    phase_dispatch_db(device)
    clock.append(("plan", time.perf_counter()))
    reset_all()
    planned = phase_plan(device)
    # main path 23, the serving plane: a Gibbs fit banked as snapshots,
    # then 256 series served tick by tick in three arms (its own counts);
    # then the fault replay and the HSMM served state
    clock.append(("serve", time.perf_counter()))
    reset_all()
    served, serve_kept = phase_serve(device)
    clock.append(("serve_faults", time.perf_counter()))
    phase_serve_faults(device)
    # main paths 6, 7, 13 to 16, 21, 24 and 25: NUTS on the Tayal batch, the
    # Gaussian NUTS gate, the IOHMMs (fits, decodes, state draws), the
    # Hassan walk-forward forecaster, the Jangmin tree's Gibbs fit and its
    # NUTS fit with the decode, the HSMM under NUTS, and paths 24 and 25,
    # adaptation and maintenance on the shifted Tayal stream, their eleven
    # tasks in parallel processes (each counts its own launches from 0),
    # started here to run beside the phases below (which time nothing on
    # the card or the host without stopping them first: quiet), and the
    # example drivers, eight processes of their own, started once
    # DRIVERS_AFTER_TASKS of the pool's tasks are done (started later, the
    # drivers became the pool's critical path once the pool grew by the
    # adaptation and maintenance tasks) and waited for before the pool's
    # parent times anything (its workers and the drivers time nothing on
    # the card)
    drivers = []

    def start_on(n_done):  # in the pool's result thread: keep its error for below
        if n_done == DRIVERS_AFTER_TASKS:
            try:
                drivers.append(start_drivers())
            except BaseException as e:
                drivers.append(e)

    def finish_drivers():
        if not drivers:
            drivers.append(start_drivers())
        if isinstance(drivers[0], BaseException):
            raise drivers[0]
        phase_drivers(drivers[0])

    started = start_pool(device, start_on)
    tooling = start_tooling()
    try:
        # main path 3, the zoo's generated quantities: the hard-gate Tayal
        # decode of the Gibbs draws, the same decode of the ChEES draws, and
        # the Gaussian HMM's fit, decode and state draws
        clock.append(("zoo", time.perf_counter()))
        reset_all()
        dec = phase_decode_smooth(device, qs)
        # the first series' decode, kept on the host for the tooling figure
        tooling_decode = {k: dec["out"][k][0].cpu().numpy() for k in ("alpha", "gamma")}
        phase_agreement(device, dec, chees_qs)
        phase_gaussian(device)
        phase_gaussian_k(device)
        phase_decode_wide(device)
        zoo = {k.name: k.launches for k in ALL_KERNELS}
        check_loglik_vs_fwd(dec)
        del dec
        # main path 4, the zoo above K=32: the K=64 Gaussian HMM's fit, state
        # draws, decode and value-and-grad, every semiring kernel a block a lane
        clock.append(("zoo_wide", time.perf_counter()))
        reset_all()
        phase_zoo_wide(device)
        zoo_wide = {k.name: k.launches for k in ALL_KERNELS}
        # main path 5, the walk-forward back-test: features, batched fits,
        # the median-alpha decode and the trades of 204 windows, then the
        # ChEES arm on 16 of them
        clock.append(("walk_forward", time.perf_counter()))
        wf_task_list, wf_data_s = sim.result()
        reset_all()
        wf_fits, wf_gibbs = phase_walk_forward(device, wf_task_list, wf_data_s)
        walk = {k.name: k.launches for k in ALL_KERNELS}
        clock.append(("walk_forward_assoc", time.perf_counter()))
        phase_walk_forward_assoc(device, wf_task_list, *wf_gibbs)
        clock.append(("walk_forward_kernels", time.perf_counter()))
        phase_walk_forward_kernels(*wf_fits)
        del wf_fits, wf_gibbs
        # main paths 6 (NUTS through fit_batched on the ChEES phase's batch)
        # and 7 (the Gaussian NUTS gate through make_logp) run in the pool
        # below; main path 8, the walk-forward back-test by NUTS, and
        # run_window (each NUTS phase returns its path's launches, read before
        # its kernels are checked and timed on the kept inputs)
        clock.append(("walk_forward_nuts", time.perf_counter()))
        reset_all()
        wf_nuts = phase_walk_forward_nuts(device, wf_task_list)
        # main path 9, the multinomial HMMs: fits, decodes and both state-draw
        # routes (each phase of this slice returns its path's launches, read
        # before its kernels are checked and timed on the kept inputs)
        clock.append(("multinom", time.perf_counter()))
        reset_all()
        mn, mn_kept = phase_multinom(device)
        # main path 10, fit_batched's healing ladder
        clock.append(("heal", time.perf_counter()))
        reset_all()
        heal, heal_kept = phase_heal(device)
        # main path 11, per-series ChEES adaptation through fit_batched
        clock.append(("chees_per_series", time.perf_counter()))
        reset_all()
        cps, cps_kept = phase_chees_per_series(device, chees_phi)
        # main path 12, the replication diagnostics (no kernel)
        clock.append(("replication", time.perf_counter()))
        reset_all()
        phase_replication(device, chees_qs)
        # main paths 17 to 20, the explicit-duration HSMMs (each phase zeroes
        # the counts after making its data and returns them read after its
        # run, before its kept launches are checked and timed), and the
        # Dmax=1 contract
        clock.append(("hsmm", time.perf_counter()))
        hm, hm_kept = phase_hsmm(device)
        reset_all()
        d1 = phase_hsmm_dmax1(device)
        clock.append(("hsmm_recovery", time.perf_counter()))
        hr, hr_kept = phase_hsmm_recovery(device)
        clock.append(("hsmm_daily", time.perf_counter()))
        hd, hd_kept = phase_hsmm_daily(device)
        clock.append(("multinom_hsmm", time.perf_counter()))
        mh, mh_kept = phase_multinom_hsmm(device)
        clock.append(("pool", time.perf_counter()))
        pooled = phase_pool(started, device, chees_phi, finish_drivers)
        clock.append(("tooling", time.perf_counter()))
        phase_tooling(tooling, tooling_decode)
    finally:
        stop_pool(started[0])
        stop_tooling(tooling)
        for d in drivers:
            if not isinstance(d, BaseException):
                stop_processes(d[0])
                d[2].shutdown(wait=True)
    (io, io_kept), (hs, hs_kept) = pooled["iohmm"], pooled["hassan"]
    (tg, tg_kept), (jm, jm_kept) = pooled["tree_gibbs"], pooled["jangmin"]
    hn, hn_kept = pooled["hsmm_nuts"]
    nuts, nuts_kept = pooled["nuts"]
    nuts_ms = {k["kernel"]: k["ms"] for k in nuts_kept}
    gnuts, gn_kept = pooled["gaussian_nuts"]
    (ad, ad_kept), (mt, mt_kept) = pooled["adapt"], pooled["maint"]
    gn_ms = {k["kernel"]: k["ms"] for k in gn_kept if k["N"] == GN_CHAINS}
    clock.append(("end", time.perf_counter()))
    emit("timeline", seconds={a: b - ta for (a, ta), (_, b) in zip(clock, clock[1:])},
         total_seconds=clock[-1][1] - clock[0][1], cpu_seconds=cpu_seconds(),
         children_cpu_seconds=cpu_seconds(resource.RUSAGE_CHILDREN))
    missing = [n for n in (cs.FWD.name, cs.BWD_SAMPLE.name) if gibbs[n] == 0]
    missing += [f"{n} (plan)" for n in (cs.FWD.name, cs.BWD_SAMPLE.name) if not planned.get(n)]
    missing += [f"{n} (serve)" for n in (cs.FWD.name, cs.BWD_SAMPLE.name) if not served.get(n)]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name, ct.TRAJ.name) if chees[n] == 0]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name) if unfused[n] == 0]
    missing += [k.name for k in (cs.FWD, cs.BWD_SAMPLE) + DECODE_KERNELS if zoo[k.name] == 0]
    missing += [f"{k.name} (zoo_wide)" for k in cs.KERNELS if zoo_wide[k.name] == 0]
    missing += [f"{k.name} (walk_forward)" for k in (cs.FWD, cs.BWD_SAMPLE, cs.VG_BWD)
                if walk[k.name] == 0]
    missing += [f"{n} (nuts)" for n in (cs.FWD.name, cs.VG_BWD.name) if not nuts.get(n)]
    missing += [f"{n} (gaussian_nuts)" for n in (cs.FILTER.name, cs.BETA.name)
                if not gnuts.get(n)]
    missing += [f"{n} (walk_forward_nuts)" for n in (cs.FWD.name, cs.VG_BWD.name)
                if not wf_nuts.get(n)]
    missing += [f"{k.name} (multinom)" for k in (cs.FWD, cs.BWD_SAMPLE) + DECODE_KERNELS
                if not mn.get(k.name)]
    missing += [f"{k.name} (heal)" for k in (cs.FWD, cs.BWD_SAMPLE, cs.VG_BWD)
                if not heal.get(k.name)]
    missing += [f"{n} (chees_per_series)" for n in (cs.FWD.name, cs.VG_BWD.name)
                if not cps.get(n)]
    missing += [f"{n} ({path})" for path, counts in (("iohmm", io), ("hassan", hs))
                for n in (cs.FWD.name, cs.VG_BWD.name) if not counts.get(n)]
    missing += [f"{n} (tree_gibbs)" for n in (cs.FWD.name, cs.BWD_SAMPLE.name) if not tg.get(n)]
    missing += [f"{k.name} (jangmin)" for k in (cs.FWD, cs.VG_BWD) + DECODE_KERNELS
                if not jm.get(k.name)]
    for path, counts, ks in (
            ("hsmm", hm, (cs.FWD, cs.BWD_SAMPLE) + DECODE_KERNELS),
            ("hsmm_dmax1", d1, (cs.FWD, cs.BWD_SAMPLE) + DECODE_KERNELS),
            ("hsmm_recovery", hr, (cs.FWD, cs.BWD_SAMPLE, cs.FILTER)),
            ("hsmm_daily", hd, (cs.FWD, cs.BWD_SAMPLE) + DECODE_KERNELS),
            ("multinom_hsmm", mh, (cs.FWD, cs.BWD_SAMPLE)),
            ("hsmm_nuts", hn, (cs.FWD, cs.VG_BWD)),
            ("adapt", ad, (cs.FWD, cs.BWD_SAMPLE)),
            ("maint", mt, (cs.FWD, cs.BWD_SAMPLE))):
        missing += [f"{k.name} ({path})" for k in ks if not counts.get(k.name)]
    if missing:
        raise AssertionError(f"a main path never launched {missing}")
    # the first launch of each kernel at each shape of paths 9 to 21 and 23 to 25
    kept = {"multinom": mn_kept, "heal": heal_kept, "chees_per_series": cps_kept,
            "iohmm": io_kept, "hassan": hs_kept, "tree_gibbs": tg_kept, "jangmin": jm_kept,
            "hsmm": hm_kept, "hsmm_dmax1": [], "hsmm_recovery": hr_kept, "hsmm_daily": hd_kept,
            "multinom_hsmm": mh_kept, "hsmm_nuts": hn_kept, "serve": serve_kept,
            "adapt": ad_kept, "maint": mt_kept}

    t = kern["timing"]
    vt, tt, dt = vgk["timing"], trk["timing"], deck["timing"]
    rows = []
    for k, launches, ms, plain, (bms, by), err, extra in (
        (cs.FWD, gibbs[cs.FWD.name], t["fwd_ms"], t["fwd_plain_ms"], kern["fwd_bound"],
         kern["fwd_err"],
         dict(ns_per_step=t["fwd_ms"] * 1e6 / T_FIT, one_lane_ms=t["fwd_one_lane_ms"],
              one_lane_ns_per_step=t["fwd_one_lane_ms"] * 1e6 / T_FIT,
              decode_gated_2048_ms=t["fwd_decode_gated_2048_ms"],
              by_lanes={n: {k: v for k, v in r.items() if k.startswith("fwd")}
                        for n, r in t["by_lanes"].items()},
              launches_chees=chees[cs.FWD.name], launches_chees_unfused=unfused[cs.FWD.name],
              device_time_ms=obs["fwd_device_time_ms"], launches_obs=obs["launches"][cs.FWD.name],
              bitwise_equal_cases=len(kern["cases"]),
              bytes=kern["fwd_bytes"], ops=kern["fwd_ops"])),
        (cs.BWD_SAMPLE, gibbs[cs.BWD_SAMPLE.name], t["bwd_ms"], t["bwd_plain_ms"],
         kern["bwd_bound"], kern["z_err"],
         dict(ns_per_step=t["bwd_ms"] * 1e6 / T_FIT, one_lane_ms=t["bwd_one_lane_ms"],
              one_lane_ns_per_step=t["bwd_one_lane_ms"] * 1e6 / T_FIT,
              by_lanes={n: {k: v for k, v in r.items() if k.startswith("bwd")}
                        for n, r in t["by_lanes"].items()},
              ffbs_wrapper_ms=t["ffbs_wrapper_ms"], bitwise_equal_cases=len(kern["cases"]),
              bytes=kern["bwd_bytes"], ops=kern["bwd_ops"])),
        (cs.VG_BWD, chees[cs.VG_BWD.name], vt["ms"], vt["plain_ms"], vgk["bound"],
         max(vgk["err"]["d_pi"], vgk["err"]["d_obs"], vgk["err"]["d_A"]),
         dict(one_lane_ms=vt["one_lane_ms"], launches_chees_unfused=unfused[cs.VG_BWD.name],
              max_errs=vgk["err"], fwd_ms_same_lanes=vt["fwd_ms"], lp_bc_ms=vt["lp_bc_ms"],
              bytes=vgk["bytes"], ops=vgk["ops"])),
        (ct.TRAJ, chees[ct.TRAJ.name], tt["ms"], tt["plain_ms"], trk["bound"], trk["err"],
         dict(per="leapfrog", one_lane_ms=tt["one_lane_ms"], launch_ms_16=tt["launch_ms_16"],
              ns_per_step=tt["ns_per_step"], by_lanes=tt["by_lanes"],
              odd_cases_vs_plain=trk["odd_cases"],
              closure_ms_16=tt["closure_ms_16"], max_abs_err_vs_f64_plain_8=trk["vs_f64"],
              max_abs_err_vs_unfused_T64=trk["vs_unfused"],
              max_abs_err_vs_unfused_T1024=trk["gap_full"],
              bytes_16=trk["bytes"], ops_16=trk["ops"])),
        *(
            (k, zoo[k.name], dt[k.name]["ms"], dt[k.name]["plain_ms"], dt[k.name]["bound"], 0.0,
             dict(one_lane_ms=dt[k.name]["one_lane_ms"], bytes=dt[k.name]["bytes"],
                  ops=dt[k.name]["ops"], bitwise_equal_cases=len(deck["cases"]),
                  shape=dict(N=N_DEC, T=T_FIT, K=K_TAYAL)))
            for k in DECODE_KERNELS
        ),
    ):
        rows.append({
            "name": k.name,
            "route": "cuda",
            "source": str(k.source.relative_to(k.source.parents[3])),
            "replaces": k.replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
            **extra,
        })
        if k in cs.KERNELS:  # the semiring kernels' K range, and K=64 (a block a lane)
            rows[-1].update(k_range=list(cs.K_RANGE), ms_k64=widek["timing"][k.name],
                            shape_k64=dict(N=N_SERIES, T=G_T, K=ZW_K),
                            launches_zoo_wide=zoo_wide[k.name],
                            bitwise_equal_cases_above_16=sum(
                                k.name in c["kernels"] for c in widek["cases"]),
                            big_k={K: t[k.name] for K, t in bigk["timing"].items()},
                            shape_big_k=dict(N=BIG_N, T=BIG_T, T_from_1024=BIG_T_HUGE),
                            one_lane_k180=bigk["one_lane"][k.name],
                            bitwise_equal_cases_above_128=sum(
                                k.name in c["kernels"] for c in bigk["cases"]),
                            bitwise_equal_k1=k1["launches"][k.name] > 0)
        if k in (cs.FWD, cs.BWD_SAMPLE, cs.VG_BWD):
            rows[-1]["launches_walk_forward"] = walk[k.name]
        if k in (cs.FWD, cs.BWD_SAMPLE):
            rows[-1]["launches_plan"] = planned[k.name]
        if k in (cs.FWD, cs.VG_BWD):  # the NUTS paths
            rows[-1].update(launches_nuts=nuts[k.name], ms_nuts=nuts_ms[k.name],
                            shape_nuts=dict(N=N_SERIES, T=T_FIT, K=K_TAYAL, gated=True),
                            launches_walk_forward_nuts=wf_nuts[k.name])
        if k in (cs.FILTER, cs.BETA):
            rows[-1].update(launches_gaussian_nuts=gnuts[k.name], ms_gaussian_nuts=gn_ms[k.name],
                            shape_gaussian_nuts=dict(N=GN_CHAINS, T=GN_T, K=2))
        for path, counts in (("multinom", mn), ("heal", heal), ("chees_per_series", cps),
                             ("iohmm", io), ("hassan", hs), ("tree_gibbs", tg), ("jangmin", jm),
                             ("hsmm", hm), ("hsmm_dmax1", d1), ("hsmm_recovery", hr),
                             ("hsmm_daily", hd), ("multinom_hsmm", mh), ("hsmm_nuts", hn),
                             ("serve", served), ("adapt", ad), ("maint", mt)):
            if counts.get(k.name):
                rows[-1][f"launches_{path}"] = counts[k.name]
                rows[-1][f"kept_{path}"] = [
                    {f: r[f] for f in ("N", "T", "K", "gated", "ms", "bitwise_equal")}
                    for r in kept[path] if r["kernel"] == k.name]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
