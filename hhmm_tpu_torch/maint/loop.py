"""The maintenance driver: drift alarms in, promoted snapshots out
(counterpart of ``hhmm_tpu/maint/loop.py``).

:class:`MaintenanceLoop` closes the train→serve loop inline with the
serve loop: the caller feeds it each flush's responses (:meth:`observe`)
and gives it a maintenance opportunity a tick (:meth:`maybe_maintain`).
It is tick-driven and single-threaded: a refit blocks the loop for its
duration, bounded by the policy's batch cap.

One maintenance pass:

1. **detect**: a per-series :class:`~hhmm_tpu_torch.serve.online.
   LoglikCUSUM` watches each stream's per-tick loglik increments;
   alarms and staleness breaches feed the debounced
   :class:`~hhmm_tpu_torch.maint.triggers.MaintenancePolicy`;
2. **refit** (span ``maint.refit``): the due requests batch into one
   warm :func:`~hhmm_tpu_torch.maint.refit.warm_refit` over the
   scheduler's history tails, seeded ``derive_seed(seed, pass index)``
   (the JAX loop splits its key once a pass);
3. **gate** (span ``maint.shadow``): each candidate must win
   :func:`~hhmm_tpu_torch.maint.shadow.shadow_evaluate` on the held-out
   tail; losers are counted and discarded;
4. **promote** (span ``maint.promote``): winners go through
   :func:`~hhmm_tpu_torch.maint.promote.promote_snapshot`, and the
   series' drift detector resets.

The ``maint.*`` counters attach to the shared metrics plane, every pass
re-notes the ``maint`` manifest stanza (the JAX loop's keys), and
:attr:`MaintenanceLoop.stage_seconds` sums each stage's host seconds.
With an :class:`~hhmm_tpu_torch.adapt.AdaptationLadder` wired
(``adapt=``), a fresh alarm first climbs reweight → rejuvenate, and only
a persisting one escalates to the refit queue.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.batch.fit import derive_seed
from hhmm_tpu_torch.maint.promote import promote_snapshot
from hhmm_tpu_torch.maint.refit import split_window, warm_refit
from hhmm_tpu_torch.maint.shadow import shadow_evaluate
from hhmm_tpu_torch.maint.triggers import MaintenancePolicy, RefitRequest
from hhmm_tpu_torch.obs import manifest as obs_manifest
from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs import request as obs_request
from hhmm_tpu_torch.obs.trace import span
from hhmm_tpu_torch.serve.online import LoglikCUSUM

__all__ = ["MaintMetrics", "MaintenanceLoop"]

# per-series detector-state entries retained (LRU): a fleet churning
# ephemeral series ids must not grow the loop's host state without
# bound — the coldest stream's detector re-calibrates if the series
# ever comes back (same rationale and scale as the scheduler's
# TENANT_BINDINGS_CAP)
SERIES_STATE_CAP = 65536


class MaintMetrics:
    """Always-on product counters for one maintenance loop, attached to
    the shared metrics plane (the `serve/metrics.py` pattern: weakref
    attach, counters sum across instances; exports and
    `scripts/obs_report.py` read them without knowing this class)."""

    def __init__(self):
        self._triggers = obs_metrics.Counter()
        self._refits = obs_metrics.Counter()
        self._promotions = obs_metrics.Counter()
        self._shadow_rejections = obs_metrics.Counter()
        self._skipped = obs_metrics.Counter()
        self._failed_swaps = obs_metrics.Counter()
        self._refit_seconds = obs_metrics.Counter()
        for name, inst in (
            ("maint.triggers", self._triggers),
            ("maint.refits", self._refits),
            ("maint.promotions", self._promotions),
            ("maint.shadow_rejections", self._shadow_rejections),
            ("maint.skipped_refits", self._skipped),
            ("maint.failed_swaps", self._failed_swaps),
            ("maint.refit_seconds", self._refit_seconds),
        ):
            obs_metrics.attach(name, inst)

    @property
    def triggers(self) -> int:
        return int(self._triggers.get())

    @property
    def refits(self) -> int:
        return int(self._refits.get())

    @property
    def promotions(self) -> int:
        return int(self._promotions.get())

    @property
    def shadow_rejections(self) -> int:
        return int(self._shadow_rejections.get())

    @property
    def skipped_refits(self) -> int:
        return int(self._skipped.get())

    @property
    def failed_swaps(self) -> int:
        return int(self._failed_swaps.get())

    @property
    def refit_seconds(self) -> float:
        return float(self._refit_seconds.get())


class MaintenanceLoop:
    """See the module docstring.

    ``sampler_config`` is any `batch/fit.py` config (Gibbs/ChEES/NUTS)
    sized for the sliding window — a refit is a small fit, not the
    offline budget. ``detector_factory`` builds the per-series drift
    detector (default: a :class:`LoglikCUSUM` labeled with the series
    id); pass a tuned factory to move h/k/calibrate. ``seed`` seeds the
    refits; ``device`` (None: the card) is where they and the shadow
    gate run."""

    def __init__(
        self,
        scheduler,
        registry,
        model,
        sampler_config,
        seed: int = 0,
        *,
        policy: Optional[MaintenancePolicy] = None,
        eval_ticks: int = 16,
        min_fit_ticks: int = 16,
        margin: float = 0.0,
        n_draws: Optional[int] = None,
        snapshot_dtype: Optional[str] = None,
        detector_factory: Optional[Callable[[str], LoglikCUSUM]] = None,
        metrics: Optional[MaintMetrics] = None,
        plan=None,
        retry=None,
        max_events: int = 32,
        staleness_sweep_every: int = 64,
        adapt=None,
        device: DeviceLike = None,
    ):
        if scheduler.history_tail <= 0:
            raise ValueError(
                "MaintenanceLoop needs a scheduler with history_tail > 0 "
                "(the sliding refit window); construct the "
                "MicroBatchScheduler with history_tail="
            )
        if eval_ticks <= 0:
            raise ValueError(f"eval_ticks must be positive, got {eval_ticks}")
        self.scheduler = scheduler
        self.registry = registry
        self.model = model
        self.sampler_config = sampler_config
        self.policy = policy if policy is not None else MaintenancePolicy()
        self.eval_ticks = int(eval_ticks)
        self.min_fit_ticks = int(min_fit_ticks)
        self.margin = float(margin)
        self.n_draws = n_draws
        self.snapshot_dtype = snapshot_dtype
        self.metrics = metrics if metrics is not None else MaintMetrics()
        self.plan = plan
        self.retry = retry
        if int(staleness_sweep_every) <= 0:
            raise ValueError(
                f"staleness_sweep_every must be positive, got "
                f"{staleness_sweep_every}"
            )
        self.staleness_sweep_every = int(staleness_sweep_every)
        # the adaptation ladder (adapt/ladder.py, a rank
        # BELOW maint — we call down, it never calls up): when wired,
        # CUSUM alarms climb reweight→rejuvenate first and only a
        # persisting alarm escalates into the refit queue; promotions
        # report back so strikes/weights reset with the new posterior
        self.adapt = adapt
        self._factory = detector_factory or (
            lambda sid: LoglikCUSUM(series=sid)
        )
        # ONE LRU-bounded table per observed series: the drift
        # detector, the last running loglik, and the attach generation
        # it was read under. An increment spanning a generation change
        # (swap, pager evict→page-in, external re-attach) is a
        # filter-evidence RESTART, not drift — it must be dropped, or
        # a page-in's phantom ±thousands-of-nats jump poisons the
        # detector. LRU-capped at SERIES_STATE_CAP: churning ephemeral
        # series must not grow this without bound.
        self._streams: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._tick = 0
        self._events: deque = deque(maxlen=int(max_events))
        # per-series promotion counts — unbounded by design (one int
        # per promoted series): the bounded event window is a UI
        # surface, not the ledger consumers (bench gates) read
        self._promoted_count: Dict[str, int] = {}
        # one fit seed a maintenance pass: derive_seed(seed, pass index)
        self.seed = int(seed)
        self.passes = 0
        self.device = resolve_device(device)
        # cumulative host seconds of a pass's three stages
        self.stage_seconds = {"refit": 0.0, "shadow": 0.0, "promote": 0.0}

    # ---- detection (per flush) ----

    def _stream_state(self, series_id: str) -> Dict[str, Any]:
        st = self._streams.get(series_id)
        if st is None:
            st = self._streams[series_id] = {
                "det": self._factory(series_id),
                "ll": None,
                "gen": None,
                "seen": None,  # loop tick of the last folded response
                "owed": False,  # consumed alarm not yet enqueued
            }
            while len(self._streams) > SERIES_STATE_CAP:
                self._streams.popitem(last=False)
        else:
            self._streams.move_to_end(series_id)
        return st

    def detector(self, series_id: str) -> LoglikCUSUM:
        return self._stream_state(series_id)["det"]

    def observe(self, responses) -> int:
        """Fold one flush's responses into the per-series drift
        detectors and the staleness trigger; returns how many refit
        requests were newly enqueued. Shed ticks never reach a
        detector (their observation was not folded); a degraded
        response's non-finite loglik counts as a maximal drop (a dead
        stream IS drifted — the CUSUM contract; the recovery tick
        after it is a ``+inf`` increment the detector treats as
        no-drop)."""
        self._tick += 1
        enqueued = 0
        pol = self.policy
        for r in responses:
            if r.shed:
                continue
            sid = r.series_id
            ll = float(r.loglik)
            gen = self.scheduler.attach_generation(sid)
            st = self._stream_state(sid)
            prev, same_gen = st["ll"], st["gen"] == gen
            st["ll"], st["gen"] = ll, gen
            st["seen"] = self._tick
            alarmed = False
            if prev is not None and same_gen:
                # increments are meaningful only WITHIN one attach
                # generation: across a swap / evict→page-in the running
                # evidence restarts, and the spanning "increment" would
                # be a phantom jump of the whole evidence scale
                _, alarmed = st["det"].update(ll - prev)
            if alarmed and not st.get("owed") and self.adapt is not None:
                # the escalation ladder's cheap rung: a fresh alarm is
                # first answered by a Liu–West rejuvenation; only an
                # alarm that persists through the configured number of
                # adapted windows falls through to the refit queue.
                # OWED alarms already escalated — they stay owed to
                # the policy, not to the ladder (re-rejuvenating while
                # a refit is stuck would mask the very signal the
                # policy is waiting to act on).
                if self.adapt.on_alarm(sid) == "rejuvenate":
                    continue
            if alarmed or st.get("owed"):
                # an alarm CONSUMES the detector (it re-baselines on
                # the post-shift distribution — the alarm-storm fix),
                # so a trigger the policy cannot take right now (queue
                # full, debounced) must stay OWED and retry until it
                # lands, or the shift would be absorbed as the new
                # normal and the series would serve stale forever
                if pol.note_alarm(sid, self._tick):
                    st["owed"] = False
                    self.metrics._triggers.inc()
                    enqueued += 1
                else:
                    st["owed"] = True
        if pol.max_staleness_s is not None:
            enqueued += self._staleness_sweep()
        return enqueued

    def _staleness_sweep(self) -> int:
        """Every ``staleness_sweep_every`` ticks, check EVERY attached
        series' posterior age — a series receiving no traffic (feed
        stopped, ticks consistently shed) must still trigger its
        staleness refit; piggybacking on response traffic would starve
        exactly the series that most need it."""
        if self._tick % self.staleness_sweep_every:
            return 0
        enqueued = 0
        pol = self.policy
        for sid in self.scheduler.series_ids():
            age = self.scheduler.staleness_of(sid)
            if pol.note_staleness(sid, age, self._tick):
                self.metrics._triggers.inc()
                enqueued += 1
        return enqueued

    # ---- maintenance (per tick opportunity) ----

    def maybe_maintain(self) -> Optional[Dict[str, Any]]:
        """Run one maintenance pass if any refit requests are due;
        returns the pass summary (also appended to the event log and
        re-noted into the ``maint`` manifest stanza), or ``None`` when
        there is nothing to do."""
        due = self.policy.due(self._tick)
        if not due:
            return None
        return self._maintain(due)

    def _maintain(self, due: List[RefitRequest]) -> Dict[str, Any]:
        # whatever happens below, the drained requests' concurrency
        # slots MUST come back: an exception escaping a refit (retry
        # ladder exhausted, registry disk full) that leaked inflight
        # slots would shrink — and after max_concurrent leaks, zero —
        # the maintenance plane's budget forever, while the caller that
        # caught the exception keeps serving none the wiser
        try:
            return self._maintain_inner(due)
        finally:
            for req in due:
                self.policy.finish(req.series_id)  # idempotent

    def _maintain_inner(self, due: List[RefitRequest]) -> Dict[str, Any]:
        t0 = obs_request.now()
        sched, reg = self.scheduler, self.registry
        tails = {r.series_id: sched.history_tail_of(r.series_id) for r in due}
        champions = {
            r.series_id: reg.load_serving(r.series_id) for r in due
        }
        self.passes += 1
        t_stage = obs_request.now()
        with span("maint.refit") as sp:
            sp.annotate(series=len(due), tick=self._tick)
            candidates, skipped = warm_refit(
                self.model,
                due,
                tails,
                champions,
                self.sampler_config,
                derive_seed(self.seed, self.passes),
                eval_ticks=self.eval_ticks,
                min_fit_ticks=self.min_fit_ticks,
                n_draws=self.n_draws,
                snapshot_dtype=self.snapshot_dtype,
                plan=self.plan,
                retry=self.retry,
                device=self.device,
            )
        self.stage_seconds["refit"] += obs_request.now() - t_stage
        promoted: List[str] = []
        rejected: List[str] = []
        window = self.min_fit_ticks + self.eval_ticks
        for sid, reason in skipped:
            self.metrics._skipped.inc()
            st = self._streams.get(sid)
            active = (
                st is not None
                and st.get("seen") is not None
                and self._tick - st["seen"] <= window
            )
            if active:
                # an actively-ticking series' tail is FILLING: nothing
                # ran, so the trigger must not burn its debounce window
                # — it re-enqueues as soon as the signal fires again
                # and the tail will be long enough within one window
                self.policy.reset_clock(sid)
            # else (feed stopped, ticks shed): the full debounce
            # stands — a tail that can never fill must retry at refit
            # cadence, not every staleness sweep, or perpetual
            # skip-requests would crowd genuine alarms out of the
            # bounded pending queue
            self._events.append(
                {"tick": self._tick, "series": sid, "outcome": "skipped",
                 "reason": reason}
            )
        for req in due:
            sid = req.series_id
            cand = candidates.get(sid)
            if cand is None:
                continue  # already accounted as skipped
            self.metrics._refits.inc()
            _, eval_tail = split_window(tails[sid], self.eval_ticks)
            t_stage = obs_request.now()
            with span("maint.shadow"):
                verdict = self._judge(sid, champions[sid], cand, eval_tail)
            self.stage_seconds["shadow"] += obs_request.now() - t_stage
            if verdict.accepted:
                t_stage = obs_request.now()
                with span("maint.promote"):
                    result = promote_snapshot(sched, reg, sid, cand)
                self.stage_seconds["promote"] += obs_request.now() - t_stage
                if result.swapped:
                    self.metrics._promotions.inc()
                    promoted.append(sid)
                    self._promoted_count[sid] = (
                        self._promoted_count.get(sid, 0) + 1
                    )
                    # the promoted posterior defines the new normal:
                    # re-arm the drift detector and forget the old
                    # running loglik (the replayed filter restarts its
                    # evidence — an increment across the swap would be
                    # a phantom shift, and the attach-generation guard
                    # in observe() backs this up)
                    st = self._stream_state(sid)
                    st["det"].reset()
                    st["ll"] = None
                    st["gen"] = None
                    if self.adapt is not None:
                        # promotion resets the ladder too: strikes
                        # clear, and the swap's committed attach
                        # already reset the weights to uniform
                        self.adapt.on_promoted(sid)
                else:
                    self.metrics._failed_swaps.inc()
                self._events.append(
                    {"tick": self._tick, "series": sid,
                     "outcome": "promoted" if result.swapped
                     else "swap-failed",
                     "trigger": req.reason,
                     "shadow": verdict.stanza(),
                     "promotion": result.stanza()}
                )
            else:
                self.metrics._shadow_rejections.inc()
                rejected.append(sid)
                if req.reason == "drift-alarm" and verdict.mean_delta > 0:
                    # a NEAR-MISS (candidate genuinely better, blocked
                    # by margin or health): the alarm was consumed (the
                    # detector re-baselined) but the posterior did not
                    # change — re-owe it so the series comes back once
                    # the debounce allows, with a longer post-shift
                    # window to fit on. A decisively-LOST candidate
                    # (delta <= 0) stays absorbed: the refit found no
                    # better posterior, and re-owing it would churn a
                    # refit per debounce window forever on a false
                    # alarm
                    self._stream_state(sid)["owed"] = True
                self._events.append(
                    {"tick": self._tick, "series": sid,
                     "outcome": "shadow-rejected",
                     "trigger": req.reason,
                     "shadow": verdict.stanza()}
                )
        seconds = obs_request.now() - t0
        self.metrics._refit_seconds.inc(seconds)
        summary = {
            "tick": self._tick,
            "requested": len(due),
            "refits": len(candidates),
            "promoted": promoted,
            "shadow_rejected": rejected,
            "skipped": [s for s, _ in skipped],
            "seconds": round(seconds, 4),
        }
        obs_manifest.note_stanza("maint", self.stanza())
        return summary

    def _judge(self, sid: str, champion, candidate, eval_tail):
        """The shadow gate: with the ladder wired, the champion defends
        under its adapted mixture, the tilt the responses serve."""
        return shadow_evaluate(
            self.model,
            champion,
            candidate,
            eval_tail,
            margin=self.margin,
            series_id=sid,
            champion_weights=(
                self.scheduler.weight_state_of(sid) if self.adapt is not None else None
            ),
            device=self.device,
        )

    # ---- reporting ----

    def promoted_series(self) -> List[str]:
        """Every series this loop has promoted, sorted — the UNBOUNDED
        ledger (the stanza's event window is capped at ``max_events``
        and rotates; gates that enumerate promotions, like the bench's
        predictive-recovery check, must read this, not the events)."""
        return sorted(self._promoted_count)

    def stanza(self) -> Dict[str, Any]:
        """The ``maint`` manifest stanza: cumulative counters + the
        recent event window — what `scripts/obs_report.py` renders as
        ``== maintenance ==`` and `scripts/bench_diff.py` gates
        (``promotions > 0 → 0`` between comparable records)."""
        m = self.metrics
        return {
            "triggers": m.triggers,
            "refits": m.refits,
            "promotions": m.promotions,
            "shadow_rejections": m.shadow_rejections,
            "skipped_refits": m.skipped_refits,
            "failed_swaps": m.failed_swaps,
            "refit_seconds": round(m.refit_seconds, 4),
            "dropped_triggers": self.policy.dropped,
            "pending": self.policy.pending_count,
            "events": list(self._events),
        }
