"""MaintenanceScheduler — the update-step round loop (port of
``repro.maintenance.scheduler``, eager policy).

One round = (op phase) + (maintenance phase).  The op phase finds every
pending op's leaf position in one frontier pass (`kernels.ops.delta_walk`
under the lockstep engine, one host-driven descent per op otherwise),
applies the non-conflicting ops with the vectorized fast path, then runs up
to ``budget`` leftovers one by one in batch order.  The maintenance phase
processes every flagged ΔNode (Rebalance / Expand, then Merge), round after
round, until the fixpoint — the eager policy, bit-identical to the JAX
scheduler: same phase order, same per-phase budget, same round count.

JAX's ``lax.cond`` / ``fori_loop(0, budget)`` with no-op iterations become
Python loops over the real entries; the per-op and per-ΔNode work reads
the rows it needs to the host (`repro_torch.core.deltatree`).

The ``deferred`` and ``budgeted:K`` policies are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.core import deltatree as DT
from repro_torch.maintenance.policy import parse_policy
from repro_torch.maintenance.stats import MaintenanceStats
from repro_torch.obs import trace as TR


def require_eager(policy) -> None:
    """Raise for a maintenance policy this package does not run yet."""
    policy = parse_policy(policy)
    if not policy.eager:
        raise NotImplementedError(
            f"maintenance policy {str(policy)!r} is not ported to "
            f"repro_torch yet (only 'eager'); see ROADMAP.md, Queue 1")


def pending_count(cfg, t) -> int:
    """Buffered items still awaiting maintenance (the I5' carry)."""
    return int(torch.where(t.alive, t.bcount, 0).sum())


# --------------------------------------------------------------------------
# frontier positions — the lockstep update descent
# --------------------------------------------------------------------------


def _positions(cfg, t, q: torch.Tensor):
    """(dn, b) leaf positions for every packed query in ``q``.

    Under the lockstep engine this is ONE `delta_walk` frontier pass for
    the whole batch — the same kernel call the read path makes
    (`core.engine._lockstep_walk`); otherwise one `_descend` per query.
    Both return identical positions.
    """
    if cfg.engine == "lockstep":
        from repro_torch.core import engine as E

        _, lb, dn, _, _ = E._lockstep_walk(cfg, t, q)
        return dn, lb
    root = int(t.root)
    walks = [DT._descend(cfg, t, qq, root, 1) for qq in q.tolist()]
    dev = t.value.device
    dns = torch.tensor([w[0] for w in walks], dtype=torch.int32, device=dev)
    bs = torch.tensor([w[1] for w in walks], dtype=torch.int32, device=dev)
    return dns, bs


# --------------------------------------------------------------------------
# op phase
# --------------------------------------------------------------------------


def _ops_phase(cfg, t, results, pending, kinds, keys, payloads, budget):
    """One round's op applications: frontier positions -> vectorized fast
    path -> up to ``budget`` sequential leftovers in batch order.

    Under the lockstep engine the round's positions also seed the
    sequential ops as descent *hints*: within an op phase the structure
    only grows downward, so restarting `_descend` from the round-start
    endpoint reaches the true endpoint.  Returns (t, results, pending).
    """
    if not bool(pending.any()):
        return t, results, pending
    dns, bs = _positions(cfg, t, cfg.qpack(keys))
    if cfg.parallel_updates:
        t, results, pending = DT._parallel_fastpath(
            cfg, t, kinds, keys, payloads, results, pending, dns, bs)
    if not bool(pending.any()):
        return t, results, pending

    pend, res = pending.tolist(), results.tolist()
    kinds_h, keys_h, pays_h = kinds.tolist(), keys.tolist(), payloads.tolist()
    hints = cfg.engine == "lockstep"
    dns_h, bs_h = (dns.tolist(), bs.tolist()) if hints else (None, None)
    for i in [j for j, p in enumerate(pend) if p][:budget]:
        # batch order is the linearization: an op waits while an *earlier*
        # op on the same key is still pending (e.g. an insert blocked on a
        # full buffer), else a later delete would miss its predecessor
        if any(pend[j] and keys_h[j] == keys_h[i] for j in range(i)):
            continue
        dn0, b0 = (dns_h[i], bs_h[i]) if hints else (None, None)
        if kinds_h[i] == DT.OP_INSERT:
            t, ok, pd = DT._insert_op(cfg, t, keys_h[i], pays_h[i], dn0, b0)
        else:
            t, ok, pd = DT._delete_op(cfg, t, keys_h[i], dn0, b0)
        res[i], pend[i] = ok, pd
    dev = results.device
    return (t, torch.tensor(res, dtype=torch.bool, device=dev),
            torch.tensor(pend, dtype=torch.bool, device=dev))


# --------------------------------------------------------------------------
# maintenance sweeps
# --------------------------------------------------------------------------


def _flagged(flag: torch.Tensor, alive: torch.Tensor, budget: int) -> list:
    """The first ``budget`` ΔNode ids (in arena order) with ``flag`` set."""
    return torch.nonzero(flag & alive)[:budget, 0].tolist()


def _ins_sweep(cfg, t, work, ids):
    """Rebalance or Expand each ΔNode in ``ids``.  Returns (t, work)."""
    for dn in ids:
        t, rebuilds, expands = DT._process_ins(cfg, t, dn)
        work = (work[0] + rebuilds, work[1] + expands, work[2], work[3])
    return t, work


def _del_sweep(cfg, t, work, ids):
    """Merge each candidate in ``ids``; freed arena slots are counted as
    freelist growth across the splice."""
    for dn in ids:
        ft = int(t.free_top)
        t, merged = DT._process_del(cfg, t, dn)
        work = (work[0], work[1], work[2] + merged,
                work[3] + int(t.free_top) - ft)
    return t, work


def _maint_phases(cfg, t, work, budget):
    """One eager maintenance pass: up to ``budget`` ins-flagged ΔNodes
    (Rebalance / Expand), then up to ``budget`` Merge candidates, each set
    taken when its sweep starts.  Shared by `_run_eager` and `flush`."""
    t, work = _ins_sweep(cfg, t, work, _flagged(t.ins_flag, t.alive, budget))
    t, work = _del_sweep(cfg, t, work, _flagged(t.del_flag, t.alive, budget))
    return t, work


def _busy(t) -> bool:
    return bool(((t.ins_flag | t.del_flag) & t.alive).any())


def _run_eager(cfg, t, kinds, keys, payloads, results, pending, budget):
    rounds, work = 0, (0, 0, 0, 0)
    while rounds < cfg.max_rounds and (bool(pending.any()) or _busy(t)):
        with TR.annotate("maint.ops"):
            t, results, pending = _ops_phase(cfg, t, results, pending, kinds,
                                             keys, payloads, budget)
        with TR.annotate("maint.sweep"):
            t, work = _maint_phases(cfg, t, work, budget)
        rounds += 1
    return t, results, rounds, work


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def run_update(cfg, t, kinds, keys, payloads=None):
    """Apply one update batch under ``cfg.maintenance`` (eager only).

    Returns (tree, results[K] bool, MaintenanceStats); the tree is updated
    in place.
    """
    require_eager(cfg.maintenance)
    dev = t.value.device
    kinds = torch.as_tensor(kinds, dtype=torch.int32, device=dev)
    keys = torch.as_tensor(keys, dtype=torch.int32, device=dev)
    k = keys.shape[0]
    if payloads is None:
        payloads = torch.zeros(k, dtype=torch.int32, device=dev)
    payloads = torch.as_tensor(payloads, dtype=torch.int32, device=dev)
    results = torch.zeros(k, dtype=torch.bool, device=dev)
    pending = kinds != DT.OP_SEARCH
    budget = min(k, 64)  # sequential work per round (leftovers re-round)
    t, results, rounds, work = _run_eager(cfg, t, kinds, keys, payloads,
                                          results, pending, budget)
    stats = MaintenanceStats(
        rounds=rounds, rebuilds=work[0], expands=work[1], merges=work[2],
        pending=pending_count(cfg, t), reclaimed=work[3])
    return t, results, stats


def flush(cfg, t, budget: int = 64):
    """Drain every flagged ΔNode to the maintenance fixpoint (restores I5),
    in rounds structured exactly like the eager loop's.  Returns (tree,
    MaintenanceStats)."""
    rounds, work = 0, (0, 0, 0, 0)
    while rounds < cfg.max_rounds and _busy(t):
        with TR.annotate("maint.sweep"):
            t, work = _maint_phases(cfg, t, work, budget)
        rounds += 1
    stats = MaintenanceStats(
        rounds=rounds, rebuilds=work[0], expands=work[1], merges=work[2],
        pending=pending_count(cfg, t), reclaimed=work[3])
    return t, stats
