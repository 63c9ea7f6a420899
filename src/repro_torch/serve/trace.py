"""Synthesized sustained mixed arrival traces (DESIGN.md §10).

The port's own copy of ``repro.serve.trace`` (numpy and stdlib only).

A trace is the scheduler's workload: per step, how many requests arrive
(Bernoulli-thinned Poisson-ish arrivals with bursts), their prompt
lengths and decode budgets, which earlier requests cancel mid-flight,
and which sequences the read-side probe traffic references (zipfian —
the hot-key shape the op-combining pass exists for).

Everything is precomputed from one seed so a trace replays identically
across engines and processes (the churn-parity test and the
``serve_trace`` benchmark replay the same plan).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StepPlan", "synth_trace"]


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One step's workload: arrivals [(prompt, max_new)], indices (into
    the submission order) of requests cancelling this step, and probe
    references (indices into the submission order, zipf-skewed)."""

    arrivals: list
    cancels: list
    probe_refs: np.ndarray


def synth_trace(steps: int, seed: int = 0, *, arrive_p: float = 0.7,
                burst: int = 2, prompt_lens=(3, 17), max_new=(4, 12),
                cancel_p: float = 0.0, probes_per_step: int = 0,
                zipf_a: float = 1.3, vocab: int = 128) -> list[StepPlan]:
    """Build a ``steps``-long replayable plan.

    arrive_p / burst:   each step draws Binomial(burst, arrive_p) arrivals.
    prompt_lens/max_new: inclusive [lo, hi) ranges per request.
    cancel_p:           per step, probability one not-yet-finished earlier
                        request cancels (uniform over submissions so far).
    probes_per_step:    zipf(zipf_a)-ranked references into the submission
                        order — duplicates are the point.
    """
    rng = np.random.default_rng(seed)
    plans = []
    submitted = 0
    for _ in range(steps):
        n_arrive = int(rng.binomial(burst, arrive_p))
        arrivals = []
        for _ in range(n_arrive):
            plen = int(rng.integers(*prompt_lens))
            arrivals.append(
                (rng.integers(1, vocab, size=plen).astype(np.int32),
                 int(rng.integers(*max_new))))
        cancels = []
        if submitted and rng.random() < cancel_p:
            cancels.append(int(rng.integers(0, submitted)))
        submitted += n_arrive
        if probes_per_step and submitted:
            refs = np.minimum(rng.zipf(zipf_a, size=probes_per_step) - 1,
                              submitted - 1).astype(np.int64)
        else:
            refs = np.zeros((0,), np.int64)
        plans.append(StepPlan(arrivals, cancels, refs))
    return plans
