"""MaintenanceScheduler — the update-step round loop (port of
``repro.maintenance.scheduler``).

One round = (op phase) + (maintenance phase).  The op phase finds every
pending op's leaf position in one frontier pass (`kernels.ops.delta_walk`
under the lockstep engine, one host-driven descent per op otherwise),
applies the non-conflicting ops with the vectorized fast path, then runs up
to ``budget`` leftovers one by one in batch order.  The maintenance phase
is what the policy controls (`policy.parse_policy`):

- ``eager``:      every flagged ΔNode (Rebalance / Expand, then Merge),
                  round after round, until the fixpoint;
- ``deferred``:   no voluntary maintenance; *forced* repairs only, where a
                  full buffer blocks a pending op or a repair left items
                  that break invariant I5' (residual);
- ``budgeted:K``: up to K voluntary repairs per batch, highest buffer
                  occupancy first, then Merge candidates; forced repairs on
                  top.

Every policy is bit-identical to the JAX scheduler: same phase order, same
per-phase budget, same ΔNode order, same round count.

JAX's ``lax.cond`` / ``fori_loop(0, budget)`` with no-op iterations become
Python loops over the real entries; the per-op and per-ΔNode work reads
the rows it needs to the host (`repro_torch.core.deltatree`).

Spans (`repro_torch.obs.trace`, under ``REPRO_TRACE``): ``maint.batch`` is
one `run_update` or `flush` call; a round's op phase is ``maint.ops``,
with the vectorized fast path ``maint.fastpath`` and the one-by-one
leftovers ``maint.seq`` inside it (the counter ``maint.seq_ops`` counts
the ops those ran); its repairs are ``maint.sweep``, each repair inside it
``maint.rebalance``, ``maint.expand`` or ``maint.merge``
(`core.deltatree`).
"""

from __future__ import annotations

import torch

from repro_torch.core import deltatree as DT
from repro_torch.maintenance.policy import MaintenancePolicy, parse_policy
from repro_torch.maintenance.stats import MaintenanceStats
from repro_torch.obs import trace as TR


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
    endpoint reaches the true endpoint.

    Returns (t, results, pending, dns): the round-start positions go back
    to the relaxed policies' `forced_mask`, which reads them only where
    an op is still pending (zeros when nothing was pending).
    """
    if not bool(pending.any()):
        return t, results, pending, torch.zeros_like(keys)
    dns, bs = _positions(cfg, t, cfg.qpack(keys))
    if cfg.parallel_updates:
        with TR.annotate("maint.fastpath"):
            t, results, pending = DT._parallel_fastpath(
                cfg, t, kinds, keys, payloads, results, pending, dns, bs)
    if not bool(pending.any()):
        return t, results, pending, dns
    with TR.annotate("maint.seq"):
        pend, res = pending.tolist(), results.tolist()
        kinds_h, keys_h = kinds.tolist(), keys.tolist()
        pays_h = payloads.tolist()
        hints = cfg.engine == "lockstep"
        dns_h, bs_h = (dns.tolist(), bs.tolist()) if hints else (None, None)
        ran = 0
        for i in [j for j, p in enumerate(pend) if p][:budget]:
            # batch order is the linearization: an op waits while an
            # *earlier* op on the same key is still pending (e.g. an insert
            # blocked on a full buffer), else a later delete would miss its
            # predecessor
            if any(pend[j] and keys_h[j] == keys_h[i] for j in range(i)):
                continue
            dn0, b0 = (dns_h[i], bs_h[i]) if hints else (None, None)
            if kinds_h[i] == DT.OP_INSERT:
                t, ok, pd = DT._insert_op(cfg, t, keys_h[i], pays_h[i], dn0,
                                          b0)
            else:
                t, ok, pd = DT._delete_op(cfg, t, keys_h[i], dn0, b0)
            res[i], pend[i] = ok, pd
            ran += 1
        TR.bump("maint.seq_ops", ran)
        dev = results.device
        results = torch.tensor(res, dtype=torch.bool, device=dev)
        pending = torch.tensor(pend, dtype=torch.bool, device=dev)
    return t, results, pending, dns


# --------------------------------------------------------------------------
# maintenance sweeps
# --------------------------------------------------------------------------


def _first(mask: torch.Tensor, budget: int) -> list:
    """The first ``budget`` ΔNode ids (in arena order) set in ``mask``."""
    return torch.nonzero(mask)[:budget, 0].tolist()


def _ins_sweep(cfg, t, work, mask, budget):
    """Rebalance or Expand the first ``budget`` ΔNodes of ``mask``, taken
    when the sweep starts.  Returns (t, work, processed-mask)."""
    ids = _first(mask, budget)
    for dn in ids:
        t, rebuilds, expands = DT._process_ins(cfg, t, dn)
        work = (work[0] + rebuilds, work[1] + expands, work[2], work[3])
    pmask = torch.zeros_like(mask)
    pmask[ids] = True
    return t, work, pmask


def _del_sweep(cfg, t, work, mask, budget):
    """Merge the first ``budget`` candidates of ``mask``; freed arena
    slots are counted as freelist growth across the splice."""
    for dn in _first(mask, budget):
        ft = int(t.free_top)
        t, merged = DT._process_del(cfg, t, dn)
        work = (work[0], work[1], work[2] + merged,
                work[3] + int(t.free_top) - ft)
    return t, work


def _maint_phases(cfg, t, work, budget):
    """One eager maintenance pass: up to ``budget`` ins-flagged ΔNodes
    (Rebalance / Expand), then up to ``budget`` Merge candidates, each set
    taken when its sweep starts.  Shared by `_run_eager` and `flush`."""
    t, work, _ = _ins_sweep(cfg, t, work, t.ins_flag & t.alive, budget)
    t, work = _del_sweep(cfg, t, work, t.del_flag & t.alive, budget)
    return t, work


def _busy(t) -> bool:
    return bool(((t.ins_flag | t.del_flag) & t.alive).any())


def _run_eager(cfg, t, kinds, keys, payloads, results, pending, budget):
    rounds, work = 0, (0, 0, 0, 0)
    while rounds < cfg.max_rounds and (bool(pending.any()) or _busy(t)):
        with TR.annotate("maint.ops"):
            t, results, pending, _ = _ops_phase(cfg, t, results, pending,
                                                kinds, keys, payloads, budget)
        with TR.annotate("maint.sweep"):
            t, work = _maint_phases(cfg, t, work, budget)
        rounds += 1
    return t, results, rounds, work


# --------------------------------------------------------------------------
# deferred / budgeted — carry flags forward, force only what blocks
# --------------------------------------------------------------------------


def _forced_mask(cfg, t, pending, residual, dns):
    """ΔNodes that must be repaired now: targets of *blocked* pending ops
    (full target buffer — an op merely carried past the per-round
    sequential budget retries next round without maintenance), residual
    (I5'-violating) nodes, and — while residual exists — every full buffer
    (a keep's blocker is a full child buffer).  ``dns`` are the round's
    op-phase positions (no second walk)."""
    m = cfg.max_dnodes
    blocked = pending & (t.bcount[dns.long().clamp(0, m - 1)] >= cfg.buf_cap)
    mask = torch.zeros_like(t.alive)
    mask[dns[blocked].long()] = True
    full = t.bcount >= cfg.buf_cap
    mask = mask | residual | (full & bool(residual.any()))
    return mask & t.ins_flag & t.alive


def _voluntary_phase(cfg, t, work, repairs, residual, vol: int):
    """Budgeted only: top-occupancy Rebalance / Expand repairs, then Merge
    candidates, sharing one per-batch repair budget ``vol``.  Returns
    (t, work, repairs, residual)."""
    m = cfg.max_dnodes
    vol_k = min(vol, m)
    low_water = max(1, m // 8)  # freelist pressure threshold (slots)
    occ = torch.where(t.ins_flag & t.alive, t.bcount, -1)
    # top_k order: highest occupancy first, ties to the lower id
    ids = torch.argsort(-occ, stable=True)[:vol_k]
    for dn, val in zip(ids.tolist(), occ[ids].tolist()):
        if val < 0 or repairs >= vol:
            break
        t, rb, ex = DT._process_ins(cfg, t, dn)
        # an Expand that "kept" items (full child) left dn I5'-violating:
        # residual, drained by the forced sweep before the step returns
        residual[dn] = bool(t.bcount[dn] > 0)
        work = (work[0] + rb, work[1] + ex, work[2], work[3])
        repairs += 1
    # Merge candidates run in arena order, except under freelist pressure:
    # then candidates whose splice returns a child slot (live sibling, no
    # children, drained buffer) run first
    idx = torch.arange(m, dtype=torch.int32, device=t.alive.device)
    cand = t.del_flag & t.alive
    par = t.parent.long().clamp(min=0)
    sib_ok = t.child[par, (t.pslot ^ 1).long()] >= 0
    reclaim = (t.parent >= 0) & sib_ok & (t.nchild == 0) & (t.bcount == 0)
    pressure = int(t.free_top) < low_water
    rank = torch.where(cand, idx + (m if pressure else 0) * (~reclaim).int(),
                       2 * m)
    order = torch.argsort(rank, stable=True)[:vol_k]
    del_ids = order[rank[order] < 2 * m].tolist()
    for dn in del_ids:
        # merging under a parent with buffered items would re-route those
        # items' descents into the merged child (an I5' violation a budget
        # would strand): defer the merge until the parent drains
        if repairs >= vol:
            break
        if int(t.bcount[max(int(t.parent[dn]), 0)]) != 0:
            continue
        ft = int(t.free_top)
        t, mg = DT._process_del(cfg, t, dn)
        work = (work[0], work[1], work[2] + mg,
                work[3] + int(t.free_top) - ft)
        repairs += 1
    return t, work, repairs, residual


def _run_relaxed(cfg, policy: MaintenancePolicy, t, kinds, keys, payloads,
                 results, pending, budget):
    vol = policy.budget if policy.kind == "budgeted" else 0
    rounds, work, repairs = 0, (0, 0, 0, 0), 0
    residual = torch.zeros_like(t.alive)
    while rounds < cfg.max_rounds and (
            bool(pending.any()) or bool((residual & t.alive).any())
            or (repairs < vol and _busy(t))):
        with TR.annotate("maint.ops"):
            t, results, pending, dns = _ops_phase(
                cfg, t, results, pending, kinds, keys, payloads, budget)
        if repairs < vol and _busy(t):
            with TR.annotate("maint.sweep"):
                t, work, repairs, residual = _voluntary_phase(
                    cfg, t, work, repairs, residual, vol)
        fmask = _forced_mask(cfg, t, pending, residual, dns)
        if bool(fmask.any()):
            with TR.annotate("maint.sweep"):
                t, work, pmask = _ins_sweep(cfg, t, work, fmask, budget)
            residual = (residual & ~pmask) | (pmask & (t.bcount > 0)
                                              & t.alive)
        rounds += 1
    return t, results, rounds, work


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def run_update(cfg, t, kinds, keys, payloads=None):
    """Apply one update batch under ``cfg.maintenance``.

    Returns (tree, results[K] bool, MaintenanceStats); the tree is updated
    in place.
    """
    with TR.annotate("maint.batch"):
        policy = parse_policy(cfg.maintenance)
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
        if policy.eager:
            t, results, rounds, work = _run_eager(
                cfg, t, kinds, keys, payloads, results, pending, budget)
        else:
            t, results, rounds, work = _run_relaxed(
                cfg, policy, t, kinds, keys, payloads, results, pending, budget)
        stats = MaintenanceStats(
            rounds=rounds, rebuilds=work[0], expands=work[1], merges=work[2],
            pending=pending_count(cfg, t), reclaimed=work[3])
    return t, results, stats


def flush(cfg, t, budget: int = 64):
    """Drain every flagged ΔNode to the maintenance fixpoint (restores I5),
    in rounds structured exactly like the eager loop's: a deferred batch
    followed by ``flush(budget=min(K, 64))`` reproduces the eager tree bit
    for bit whenever no op was force-blocked mid-batch.  Returns (tree,
    MaintenanceStats)."""
    with TR.annotate("maint.batch"):
        rounds, work = 0, (0, 0, 0, 0)
        while rounds < cfg.max_rounds and _busy(t):
            with TR.annotate("maint.sweep"):
                t, work = _maint_phases(cfg, t, work, budget)
            rounds += 1
        stats = MaintenanceStats(
            rounds=rounds, rebuilds=work[0], expands=work[1], merges=work[2],
            pending=pending_count(cfg, t), reclaimed=work[3])
    return t, stats
