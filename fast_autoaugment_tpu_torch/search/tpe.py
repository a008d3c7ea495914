"""In-tree Tree-structured Parzen Estimator (TPE) optimizer: the port's own
copy of ``fast_autoaugment_tpu/search/tpe.py`` (numpy only).

The reference drives its policy search with HyperOpt's TPE through Ray Tune
(``search.py:230-245``): 200 samples over a space of {op-choice x prob x
level} x (5 policies x 2 ops), maximizing ``top1_valid``.  Here the
optimizer is a plain ask-tell loop around the TTA step:

- mixed space: categorical ('choice') and box ('uniform') dimensions;
- startup phase of pure random sampling (n_startup, hyperopt default 20);
- after startup, observations are split into good/bad by the gamma
  quantile of the objective (hyperopt's adaptive
  ``min(ceil(0.25 * sqrt(n)), 25)`` rule);
- uniform dims: 1-D Parzen mixtures over good/bad with Silverman-style
  bandwidths; candidates drawn from the good mixture and ranked by the
  density ratio l(x)/g(x);
- choice dims: smoothed categorical counts, same ratio ranking;
- n_ei_candidates (default 24) proposals scored per suggestion.

Deterministic given the seed: given the same rewards its trial log is
byte-equal to the JAX package's.  ``suggest``/``tell`` serve the sequential
loop, ``ask(n)``/``tell_batch`` synchronous batches of n concurrent
proposals (constant-liar posterior; ``ask(1)`` is bit-for-bit
``suggest``).

The async pipeline (``search/pipeline.py``) uses the PROPOSAL LEDGER:
:meth:`ask_tagged` gives each proposal a trial id and keeps it pending until
:meth:`tell` gets that id.  Pending proposals carry the constant-liar
placeholder, and the posterior is always materialized in trial-id order,
so tells that arrive out of order give the state in-order tells give, and a
resume replays the exact ask/tell interleaving from the trial log.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = ["Dim", "choice", "uniform", "TPE"]


@dataclass(frozen=True)
class Dim:
    name: str
    kind: str  # 'choice' | 'uniform'
    n: int = 0
    low: float = 0.0
    high: float = 1.0


def choice(name: str, n: int) -> Dim:
    return Dim(name, "choice", n=n)


def uniform(name: str, low: float = 0.0, high: float = 1.0) -> Dim:
    return Dim(name, "uniform", low=low, high=high)


@dataclass
class TPE:
    space: Sequence[Dim]
    seed: int = 0
    n_startup: int = 20
    n_ei_candidates: int = 24
    observations: list = field(default_factory=list)  # (x: dict, reward: float)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # proposal ledger (async pipeline): trial_id -> proposal for
        # asked-but-untold trials, trial_id -> (proposal, reward) once
        # told.  Ledger state is disjoint from `observations` — the
        # sequential/batched paths never touch it, so their streams
        # stay bit-for-bit.
        self._pending: dict[int, dict] = {}
        self._told: dict[int, tuple[dict, float]] = {}
        self._next_trial_id = 0
        #: tells that arrived while an earlier-asked trial was still
        #: pending (the out-of-order count the driver stamps)
        self.tell_reorders = 0

    # ------------------------------------------------------------------
    def _random_sample(self) -> dict:
        out = {}
        for d in self.space:
            if d.kind == "choice":
                out[d.name] = int(self._rng.integers(0, d.n))
            else:
                out[d.name] = float(self._rng.uniform(d.low, d.high))
        return out

    def _split(self):
        """Good/bad split by the hyperopt gamma rule (maximization)."""
        n = len(self.observations)
        n_good = min(int(math.ceil(0.25 * math.sqrt(n))), 25)
        order = sorted(range(n), key=lambda i: -self.observations[i][1])
        good = [self.observations[i][0] for i in order[:n_good]]
        bad = [self.observations[i][0] for i in order[n_good:]]
        return good, bad

    @staticmethod
    def _parzen_logpdf(x: np.ndarray, points: np.ndarray, low: float, high: float):
        """Log density of a 1-D Parzen mixture with a uniform prior component."""
        span = high - low
        if len(points) == 0:
            return np.full_like(x, -np.log(span))
        sigma = max(span * 1.06 * len(points) ** -0.2 / 4.0, 1e-3 * span)
        diff = (x[:, None] - points[None, :]) / sigma
        comp = -0.5 * diff**2 - 0.5 * np.log(2 * np.pi) - np.log(sigma)
        # include the uniform prior as one extra mixture component
        prior = np.full((x.shape[0], 1), -np.log(span))
        comp = np.concatenate([comp, prior], axis=1)
        return np.logaddexp.reduce(comp, axis=1) - np.log(comp.shape[1])

    @staticmethod
    def _categorical_probs(values: list[int], n: int) -> np.ndarray:
        counts = np.ones(n)  # +1 smoothing (hyperopt's prior)
        for v in values:
            counts[v] += 1.0
        return counts / counts.sum()

    # ------------------------------------------------------------------
    def suggest(self) -> dict:
        if len(self.observations) < self.n_startup:
            return self._random_sample()

        good, bad = self._split()
        proposal: dict = {}
        for d in self.space:
            gvals = [g[d.name] for g in good]
            bvals = [b[d.name] for b in bad]
            if d.kind == "choice":
                pg = self._categorical_probs(gvals, d.n)
                pb = self._categorical_probs(bvals, d.n)
                cands = self._rng.choice(d.n, size=self.n_ei_candidates, p=pg)
                scores = np.log(pg[cands]) - np.log(pb[cands])
                proposal[d.name] = int(cands[int(np.argmax(scores))])
            else:
                gp = np.asarray(gvals, np.float64)
                span = d.high - d.low
                sigma = max(span * 1.06 * max(len(gp), 1) ** -0.2 / 4.0, 1e-3 * span)
                if len(gp):
                    centers = self._rng.choice(gp, size=self.n_ei_candidates)
                    cands = np.clip(
                        centers + self._rng.normal(0, sigma, self.n_ei_candidates),
                        d.low, d.high,
                    )
                else:
                    cands = self._rng.uniform(d.low, d.high, self.n_ei_candidates)
                lg = self._parzen_logpdf(cands, gp, d.low, d.high)
                lb = self._parzen_logpdf(
                    cands, np.asarray(bvals, np.float64), d.low, d.high
                )
                proposal[d.name] = float(cands[int(np.argmax(lg - lb))])
        return proposal

    # ------------------------------------------------------------------
    def ask(self, n: int = 1) -> list[dict]:
        """Propose `n` candidates for CONCURRENT evaluation.

        ``ask(1)`` is exactly one :meth:`suggest` call — same RNG
        stream, same proposal — so a batch-1 ask/tell loop reproduces
        the sequential loop bit-for-bit.  For ``n > 1`` the proposals
        are generated by the CONSTANT-LIAR strategy (Ginsbourger et
        al.'s kriging-believer family, the standard synchronous-batch
        adaptation of sequential model-based search): after each
        proposal a pessimistic placeholder reward — the worst
        observation so far — is told to a TEMPORARY copy of the
        posterior, pushing the next proposal away from the still-
        pending point; the lies are discarded before returning.  The
        liar value is the conservative choice for maximization: an
        optimistic lie would cluster the whole batch on one mode.

        While the batch stays inside the random-startup phase the lies
        change nothing (the proposals are prior draws), matching
        batched random search; a batch that CROSSES the startup
        boundary switches to the (liar-informed) posterior mid-batch,
        exactly as the sequential loop would switch at that count.
        """
        if n <= 1:
            return [self.suggest()]
        lie = (min(r for _, r in self.observations)
               if self.observations else 0.0)
        proposals: list[dict] = []
        n_real = len(self.observations)
        try:
            for _ in range(n):
                p = self.suggest()
                proposals.append(p)
                self.observations.append((dict(p), lie))
        finally:
            # drop the lies, never the real observations
            del self.observations[n_real:]
        return proposals

    # ---------------------------------------------- proposal ledger
    def _lie(self) -> float:
        """The constant-liar placeholder for pending ledger trials:
        the worst reward told so far (0.0 before any tell) — the same
        pessimistic value :meth:`ask` uses within a batch."""
        return (min(r for _, r in self._told.values())
                if self._told else 0.0)

    def _materialized(self, lie: float) -> list:
        """The ledger's posterior view in CANONICAL trial-id order:
        told trials carry their true reward, pending ones the liar
        placeholder.  A pure function of the (id -> reward) SET, so
        the posterior is invariant to tell arrival order."""
        out = []
        for t in range(self._next_trial_id):
            if t in self._told:
                p, r = self._told[t]
                out.append((p, r))
            else:
                out.append((self._pending[t], lie))
        return out

    def ask_tagged(self, n: int = 1) -> list[tuple[int, dict]]:
        """Propose `n` candidates tagged with monotonically increasing
        trial ids, registering each as PENDING in the ledger until its
        :meth:`tell` arrives (in any order).

        The posterior for each proposal is the canonical-order
        materialization above: real rewards for told trials, the
        constant-liar placeholder for every pending one (in-flight
        rounds of the async pipeline).  With NO pending trials this
        consumes exactly the RNG stream of :meth:`ask` — the property
        that makes a one-actor in-order pipeline reproduce the serial
        trial log bit-for-bit, and that lets a resume replay the exact
        ask/tell interleaving by re-asking the logged rounds."""
        if n < 1:
            raise ValueError(f"ask_tagged needs n >= 1, got {n}")
        lie = self._lie()
        saved = self.observations
        work = self._materialized(lie)
        self.observations = work
        tagged: list[tuple[int, dict]] = []
        try:
            for _ in range(n):
                p = self.suggest()
                tid = self._next_trial_id
                self._next_trial_id += 1
                self._pending[tid] = dict(p)
                tagged.append((tid, p))
                # within-batch constant liar, exactly like ask()
                work.append((dict(p), lie))
        finally:
            self.observations = saved
        return tagged

    def _tell_id(self, trial_id: int, reward: float):
        if trial_id not in self._pending:
            state = "already told" if trial_id in self._told else "never asked"
            raise KeyError(f"ledger tell for trial {trial_id}: {state}")
        if any(t < trial_id for t in self._pending):
            self.tell_reorders += 1
        self._told[trial_id] = (self._pending.pop(trial_id), float(reward))

    @property
    def num_told(self) -> int:
        return len(self._told)

    @property
    def pending_ids(self) -> list[int]:
        return sorted(self._pending)

    def pending_proposal(self, trial_id: int) -> dict:
        return dict(self._pending[trial_id])

    def pending_rounds(self, trial_batch: int) -> list[list[int]]:
        """Group the pending trial ids back into their original ask
        ROUNDS (round ``r`` covers ids ``[r*K, (r+1)*K)``), in id
        order — the unit the async/fleet schedulers re-dispatch after
        a resume replay (:func:`~fast_autoaugment_tpu_torch.search.pipeline.
        replay_trial_log` reconstructed them as ledger-pending)."""
        K = max(1, int(trial_batch))
        rounds: list[list[int]] = []
        for tid in self.pending_ids:
            if rounds and tid // K == rounds[-1][0] // K:
                rounds[-1].append(tid)
            else:
                rounds.append([tid])
        return rounds

    def round_payload(self, ids: Sequence[int]) -> list[dict]:
        """JSON-safe proposal dicts for a round of PENDING ids — the
        ledger's wire form for the cross-host round transport.  Python's
        ``json`` round-trips floats exactly (repr-based), so a decoded
        payload reproduces ``policy_decoder`` output bit for bit."""
        return [self.pending_proposal(int(t)) for t in ids]

    def worst_told(self) -> float:
        """Worst real reward in the ledger (the quarantine placeholder
        value); 0.0 before any tell — mirrors the driver's serial
        ``_quarantine`` semantics."""
        return self._lie()

    @property
    def best_told(self):
        """Ledger counterpart of :attr:`best`: the (proposal, reward)
        with the highest TOLD reward, in canonical id order."""
        if not self._told:
            return None
        tid = max(sorted(self._told), key=lambda t: self._told[t][1])
        return self._told[tid]

    # ------------------------------------------------------------------
    def tell(self, x, reward: float):
        """Record one result.  ``x`` is either the proposal dict
        (sequential/batched path — appends to ``observations``) or an
        int trial id from :meth:`ask_tagged` (ledger path — resolves
        the pending proposal, in any completion order)."""
        if isinstance(x, (int, np.integer)):
            return self._tell_id(int(x), float(reward))
        self.observations.append((dict(x), float(reward)))

    def tell_batch(self, xs: Sequence[dict], rewards: Sequence[float]):
        """Record the true rewards for a completed :meth:`ask` batch."""
        xs, rewards = list(xs), list(rewards)
        if len(xs) != len(rewards):
            raise ValueError(
                f"tell_batch: {len(xs)} proposals vs {len(rewards)} rewards")
        for x, r in zip(xs, rewards):
            self.tell(x, r)

    @property
    def best(self):
        if not self.observations:
            return None
        return max(self.observations, key=lambda o: o[1])
