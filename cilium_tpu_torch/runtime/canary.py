"""Shadow/canary policy rollout with a verdict-diff gate (a copy of
the reference's ``runtime/canary.py``, without its command-line lane).

The loader stages generation N+1 alongside the serving generation N
(:meth:`~cilium_tpu_torch.runtime.loader.Loader.stage_canary` — the
shadow is the CPU oracle over the N+1 snapshot), the serve loop
double-dispatches a configured sample fraction of ring traffic through
both generations in the same pack cycle, and :class:`CanaryController`
keeps the verdict-diff ledger. Commit is REFUSED — serving generation
N untouched — when the diff fraction exceeds the declared budget or the
sample floor wasn't reached.

Sample selection is a pure counter walk (``floor(c·f) ≠
floor((c-1)·f)``), deterministic under any PYTHONHASHSEED — never an
RNG, never an id hash.

The ``canary.dispatch`` fault point fires on every shadow dispatch: a
fired fault ABORTS the canary safely while generation N keeps serving.

The reference's ``python -m cilium_tpu.runtime.canary`` lane
(``_build_world``, ``_drive``, ``main``) needs the provenance stamp of
``runtime/provenance.py`` and arrives with it (queue 1, Q12).
"""

from __future__ import annotations

import threading
from typing import Dict

from cilium_tpu_torch.runtime import faults
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import (
    CANARY_COMMITS,
    CANARY_DIFF_FRACTION,
    CANARY_SAMPLES,
    METRICS,
)

LOG = get_logger("canary")

#: fires on every shadow (N+1) dispatch of a sampled chunk: a fired
#: fault models the shadow evaluation path failing and must ABORT the
#: canary — counted, staged generation dropped — while the serving
#: generation N is untouched
CANARY_DISPATCH_POINT = faults.register_point(
    "canary.dispatch", "shadow verdict dispatch in CanaryController")

#: controller states; terminal ones keep their final report readable
STATE_IDLE = "idle"
STATE_SAMPLING = "sampling"
STATE_COMMITTED = "committed"
STATE_REFUSED = "refused"
STATE_ABORTED = "aborted"


class CanaryRefused(RuntimeError):
    """The verdict-diff gate refused the commit: the diff fraction
    exceeded the declared budget (or the sample floor wasn't met with
    a non-zero diff). Serving generation N is untouched."""

    def __init__(self, report: Dict):
        super().__init__(
            f"canary refused: diff_fraction="
            f"{report.get('diff_fraction')} over budget="
            f"{report.get('diff_budget')} after "
            f"{report.get('samples')} samples")
        self.report = report


class CanaryController:
    """The verdict-diff ledger of one staged rollout.

    One per service/loader. ``stage()`` installs generation N+1 as
    the loader's shadow; the serve loop calls ``should_sample`` on
    its chunk counter and ``observe_chunk`` with each sampled chunk's
    (flows, served verdicts); ``try_commit`` is the gate. Thread-safe:
    observes land from the pack thread while status/commit come from
    the API thread."""

    def __init__(self, loader, sample_fraction: float = 0.25,
                 diff_budget: float = 0.0, min_samples: int = 64):
        self.loader = loader
        self.sample_fraction = float(sample_fraction)
        self.diff_budget = float(diff_budget)
        self.min_samples = max(1, int(min_samples))
        self._lock = threading.Lock()
        self.state = STATE_IDLE
        self.revision = 0
        self.samples = 0       # sampled flow verdicts compared
        self.diffs = 0         # ... that disagreed across generations
        self.chunks = 0        # sampled chunks double-dispatched
        self.reason = ""       # terminal detail (abort cause, ...)

    @classmethod
    def from_config(cls, loader, cfg=None) -> "CanaryController":
        ccfg = cfg if cfg is not None else loader.config.canary
        return cls(loader,
                   sample_fraction=ccfg.sample_fraction,
                   diff_budget=ccfg.diff_budget,
                   min_samples=ccfg.min_samples)

    # -- rollout lifecycle ------------------------------------------------
    def stage(self, per_identity, revision: int = 0) -> None:
        """Stage generation N+1 and start sampling. Restaging while a
        rollout is live replaces it (the old ledger resets — a new
        generation earns its own samples)."""
        self.loader.stage_canary(per_identity, revision=revision)
        with self._lock:
            self.state = STATE_SAMPLING
            self.revision = int(revision)
            self.samples = 0
            self.diffs = 0
            self.chunks = 0
            self.reason = ""
        LOG.info("canary staged", extra={"fields": {
            "revision": revision,
            "sample_fraction": self.sample_fraction,
            "diff_budget": self.diff_budget}})

    def active(self) -> bool:
        with self._lock:
            return self.state == STATE_SAMPLING

    def should_sample(self, counter: int) -> bool:
        """Deterministic counter-walk sample selection: chunk ``c``
        (1-based) is sampled iff ``floor(c·f) != floor((c-1)·f)`` —
        exactly a fraction ``f`` of chunks, the SAME chunks on every
        host and under every PYTHONHASHSEED."""
        f = self.sample_fraction
        if f <= 0.0:
            return False
        c = int(counter)
        return int(c * f) != int((c - 1) * f)

    # -- the double-dispatch observe path ---------------------------------
    def observe_chunk(self, flows, served_verdicts) -> bool:
        """Dispatch one sampled chunk's flows through the SHADOW
        generation and diff against the verdicts generation N served.
        Returns False when the canary is not sampling (or just
        aborted) — the caller simply stops sampling; serving is never
        affected either way."""
        with self._lock:
            if self.state != STATE_SAMPLING:
                return False
        shadow = self.loader.canary_engine
        if shadow is None:
            return False
        try:
            faults.maybe_fail(CANARY_DISPATCH_POINT)
            shadow_verdicts = shadow.verdict_flows(flows)["verdict"]
        except Exception as e:  # noqa: BLE001 — ANY shadow-dispatch
            # failure (armed fault or real) aborts the canary safely:
            # the staged generation is advisory until commit, so the
            # only safe degradation is to stop the rollout — never to
            # guess a diff, never to touch generation N
            self.abort(f"dispatch-failed: {type(e).__name__}: {e}")
            return False
        matches = 0
        diffs = 0
        for served, shadowed in zip(served_verdicts, shadow_verdicts):
            if int(served) == int(shadowed):
                matches += 1
            else:
                diffs += 1
        with self._lock:
            self.samples += matches + diffs
            self.diffs += diffs
            self.chunks += 1
            frac = self.diffs / max(1, self.samples)
        if matches:
            METRICS.inc(CANARY_SAMPLES, matches,
                        labels={"result": "match"})
        if diffs:
            METRICS.inc(CANARY_SAMPLES, diffs,
                        labels={"result": "diff"})
        METRICS.set_gauge(CANARY_DIFF_FRACTION, frac)
        return True

    # -- terminal transitions ---------------------------------------------
    def abort(self, reason: str) -> None:
        """Stop the rollout without committing: staged generation
        dropped, ledger kept for the report, serving generation N
        untouched by construction."""
        with self._lock:
            if self.state not in (STATE_SAMPLING, STATE_IDLE):
                return
            self.state = STATE_ABORTED
            self.reason = str(reason)
        self.loader.clear_canary()
        METRICS.inc(CANARY_COMMITS, labels={"result": "aborted"})
        LOG.warning("canary aborted", extra={"fields": {
            "revision": self.revision, "reason": reason}})

    def diff_fraction(self) -> float:
        with self._lock:
            return self.diffs / max(1, self.samples)

    def try_commit(self):
        """The verdict-diff gate. Passes only when the sample floor
        was reached AND the diff fraction is within the declared
        budget; then — and only then — the staged snapshot promotes
        through the loader's normal regenerate. A refusal drops the
        staged generation and raises :class:`CanaryRefused`; the
        serving generation N never moves."""
        with self._lock:
            if self.state != STATE_SAMPLING:
                raise RuntimeError(
                    f"no canary sampling (state={self.state})")
            samples = self.samples
            frac = self.diffs / max(1, self.samples)
        ok = samples >= self.min_samples and frac <= self.diff_budget
        if not ok:
            report = self.report()
            with self._lock:
                self.state = STATE_REFUSED
                self.reason = (
                    f"diff_fraction {round(frac, 6)} > budget "
                    f"{self.diff_budget}" if frac > self.diff_budget
                    else f"samples {samples} < floor "
                         f"{self.min_samples}")
                report["reason"] = self.reason
            self.loader.clear_canary()
            METRICS.inc(CANARY_COMMITS, labels={"result": "refused"})
            LOG.error("canary REFUSED", extra={"fields": {
                "revision": self.revision,
                "diff_fraction": round(frac, 6),
                "budget": self.diff_budget, "samples": samples}})
            raise CanaryRefused(report)
        engine = self.loader.commit_canary()
        with self._lock:
            self.state = STATE_COMMITTED
        METRICS.inc(CANARY_COMMITS, labels={"result": "committed"})
        LOG.info("canary committed", extra={"fields": {
            "revision": self.revision, "samples": samples,
            "diff_fraction": round(frac, 6)}})
        return engine

    # -- introspection ----------------------------------------------------
    def report(self) -> Dict:
        """The verdict-diff report (`GET /v1/canary`, `cilium-tpu
        canary`)."""
        with self._lock:
            return {
                "state": self.state,
                "revision": self.revision,
                "sample_fraction": self.sample_fraction,
                "diff_budget": self.diff_budget,
                "min_samples": self.min_samples,
                "chunks": self.chunks,
                "samples": self.samples,
                "diffs": self.diffs,
                "diff_fraction": round(
                    self.diffs / max(1, self.samples), 6),
                "reason": self.reason,
            }
