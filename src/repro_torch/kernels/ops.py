"""The multi-round walk around the kernels (port of ``repro.kernels.ops``).

- `delta_walk`     — multi-round walk over the query frontier: every active
  query descends its current ΔNode fully, hops to the child ΔNode, repeats
  until it lands on its leaf.  Reports per-query hop counts (= rounds
  active = ΔNodes visited) and the folded successor candidate.  ``root``
  may be per-query.  This is the engine room of the ``"lockstep"``
  SearchEngine (`repro_torch.core.engine`) and of the lockstep update
  path.  Two loops share the contract bit for bit:
    * fused (default): all rounds inside one `veb_search.veb_walk_fused`
      launch;
    * per-round (``fused=False``): one `veb_search.veb_walk_rows` launch
      per frontier round over rows gathered here — the parity oracle for
      the fused kernel.
- `delta_search`   — the 3-tuple (leaf_val, leaf_b, final_dn) contract.
- `delta_contains` — paper SEARCHNODE set semantics on top (mark bit +
  overflow buffer check).
- `delta_scan`     — the emit-cursor range scan: every FIND/VERIFY pass of
  every lane inside one `veb_search.veb_scan_fused` launch.

The walks' ``q_tile`` is the kernels' block size (`default_q_tile`:
``REPRO_TORCH_QTILE``, else `kernels.autotune`'s table, else 64).  The JAX
package's other execution-mode knobs (interpret resolution, the
``REPRO_PALLAS_*`` variables, the TPU VMEM budget and 128-lane padding) were
derived for a TPU and have no counterpart here: the arena is read in place
on the card and no batch padding is needed.
"""

from __future__ import annotations

import math
import os

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.veb_search import (
    DEFAULT_BLOCK, check_q_tile, pos_table, veb_scan_fused, veb_walk_fused,
    veb_walk_rows, walk_big,
)
from repro_torch.obs import trace as TR


def walk_round_cap(height: int, max_dnodes: int) -> int:
    """Walk round bound derived from the arena geometry.

    An arena of M ΔNodes holds at most ``M * 2**(height-1)`` leaves, so a
    *balanced* ΔNode tree is ``ceil(log2(M * leaf_cap) / (height-1))``
    ΔNodes deep; maintenance keeps the tree within a constant factor of
    that, and the cap doubles the balanced depth and adds slack for
    overflow-chase hops mid-maintenance.
    """
    leaf_cap = 2 ** (height - 1)
    balanced = math.ceil(
        math.log2(max(max_dnodes, 2) * leaf_cap) / max(height - 1, 1))
    return 2 * balanced + 8


def default_q_tile(height: int | None = None, payload_bits: int = 0, *,
                   compiled: bool = True) -> int:
    """The walk kernels' block size: the ``REPRO_TORCH_QTILE`` pin, else
    the autotuned height→size table (`kernels.autotune`: the
    ``REPRO_TORCH_AUTOTUNE`` cache file over the committed ``BAKED``
    winners; ``compiled`` keys the card's entries), else 64.  A pin or a
    table entry that is not a built size raises."""
    env = os.environ.get("REPRO_TORCH_QTILE", "").strip()
    if env:
        try:
            tile = int(env)
        except ValueError:
            raise ValueError(
                f"REPRO_TORCH_QTILE must be an integer, got {env!r}"
            ) from None
        return check_q_tile(tile, f"REPRO_TORCH_QTILE={env!r}")
    if height is not None:
        tile = autotune.best_q_tile(height, compiled=compiled,
                                    bits=64 if payload_bits else 32)
        if tile is not None:
            return check_q_tile(tile, "autotune table")
    return DEFAULT_BLOCK


def _resolve_q_tile(q_tile: int | None, height: int | None = None,
                    payload_bits: int = 0, *, compiled: bool = True) -> int:
    if q_tile is None:
        return default_q_tile(height, payload_bits, compiled=compiled)
    return check_q_tile(q_tile, "explicit q_tile")


def _roots(root, k: int, device) -> torch.Tensor:
    root = torch.as_tensor(root, dtype=torch.int32, device=device)
    return root.expand(k).contiguous()


def delta_walk(value: torch.Tensor, child: torch.Tensor, root,
               queries: torch.Tensor, *, height: int,
               max_rounds: int | None = None, fused: bool = True,
               q_tile: int | None = None):
    """Multi-hop ΔTree walk in lockstep rounds over the query frontier.

    value/child are the arena arrays (value int32, or int64 packed map
    mode); ``queries`` are *packed* values (`TreeConfig.qpack`), cast to the
    value dtype.  ``root`` is a scalar (single-arena walk) or a per-query
    (K,) int32 tensor of seeds.  A query equal to ``walk_big(dtype)`` (the
    reserved ROUTE_LEFT key, packed) is born resolved — hops 0, miss leaf,
    no successor candidate.  ``max_rounds=None`` derives the round cap from
    the arena geometry (`walk_round_cap`).  ``q_tile`` is the kernels'
    block size; None resolves it by `default_q_tile` (the CPU's plain
    versions ignore it, but a size that is not built raises there too).

    Returns per query:
      leaf_val: packed value at the final position (EMPTY on miss)
      leaf_b:   final BFS position in the final ΔNode
      final_dn: final ΔNode id
      hops:     rounds the query stayed active = ΔNodes visited — exactly
                the scalar engine's `_descend` transfer statistic
      cand:     min left-turn router over the whole walk (successor lower
                bound; ``walk_big(dtype)`` when no left turn happened)
    """
    if max_rounds is None:
        max_rounds = walk_round_cap(height, value.shape[0])
    q_tile = _resolve_q_tile(q_tile, height,
                             0 if value.dtype == torch.int32 else 1,
                             compiled=value.device.type == "cuda")
    queries = queries.to(value.dtype).contiguous()
    roots = _roots(root, queries.shape[0], value.device)
    with TR.annotate("delta_walk"):
        if fused:
            return veb_walk_fused(value, child, roots, queries,
                                  height=height, max_rounds=int(max_rounds),
                                  q_tile=q_tile)
        return _delta_walk(value, child, roots, queries, height=height,
                           max_rounds=int(max_rounds), q_tile=q_tile)


def _delta_walk(value, child, roots, queries, *, height, max_rounds, q_tile):
    """Per-round walk: gather each lane's current ΔNode row and child
    row, descend it with one `veb_walk_rows` launch, hop, repeat until every
    lane is resolved (one host check per round)."""
    k = queries.shape[0]
    dev = value.device
    big = walk_big(value.dtype)
    dn = roots.clone()
    resolved = queries == big
    leaf_val = torch.zeros(k, dtype=value.dtype, device=dev)
    leaf_b = torch.ones(k, dtype=torch.int32, device=dev)
    final_dn = dn.clone()
    hops = torch.zeros(k, dtype=torch.int32, device=dev)
    cand = torch.full((k,), big, dtype=value.dtype, device=dev)
    rounds = 0
    while rounds < max_rounds and not bool(resolved.all()):
        dnc = dn.clamp(0, value.shape[0] - 1).long()
        lv, lb, nxt, rcand = veb_walk_rows(
            value[dnc], child[dnc], queries, height=height, q_tile=q_tile)
        act = ~resolved
        done_now = act & (nxt < 0)
        final_dn = torch.where(done_now, dn, final_dn)
        dn = torch.where(act & (nxt >= 0), nxt, dn)
        resolved = resolved | done_now
        leaf_val = torch.where(done_now, lv, leaf_val)
        leaf_b = torch.where(done_now, lb, leaf_b)
        hops = hops + act.to(torch.int32)
        cand = torch.where(act & (rcand < cand), rcand, cand)
        rounds += 1
    return leaf_val, leaf_b, final_dn, hops, cand


def delta_search(value: torch.Tensor, child: torch.Tensor, root,
                 queries: torch.Tensor, *, height: int,
                 max_rounds: int | None = None, fused: bool = True,
                 q_tile: int | None = None):
    """(leaf_val, leaf_b, final_dn) per query — `delta_walk` without the
    hop and candidate columns."""
    lv, lb, dn, _, _ = delta_walk(value, child, root, queries, height=height,
                                  max_rounds=max_rounds, fused=fused,
                                  q_tile=q_tile)
    return lv, lb, dn


def delta_contains(value: torch.Tensor, mark: torch.Tensor,
                   child: torch.Tensor, buf: torch.Tensor, root,
                   queries: torch.Tensor, *, height: int,
                   max_rounds: int | None = None, fused: bool = True,
                   q_tile: int | None = None):
    """Paper SEARCHNODE on top of the kernel walk: leaf match & ~mark, else
    the ΔNode's overflow buffer (paper Fig. 8 lines 9..17)."""
    pos = pos_table(height, value.device).long()
    queries = queries.to(value.dtype)
    lv, lb, dn = delta_search(value, child, root, queries, height=height,
                              max_rounds=max_rounds, fused=fused,
                              q_tile=q_tile)
    dn = dn.long()
    leaf_hit = lv == queries
    leaf_live = leaf_hit & ~mark[dn, pos[lb.long()]]
    in_buf = (buf[dn] == queries[:, None]).any(dim=1)
    return torch.where(leaf_hit, leaf_live, in_buf)


def scan_round_cap(height: int, max_dnodes: int, max_out: int,
                   chase_slack: int = 16) -> int:
    """Round bound for the emit-cursor scan: each emitted item costs at
    most two full walk passes (FIND + VERIFY), each bounded by
    `walk_round_cap`, plus slack passes for tombstone chases.  Generous by
    design: a lane stops as soon as it is done."""
    return walk_round_cap(height, max_dnodes) * 2 * (max_out + chase_slack)


def delta_scan(value: torch.Tensor, mark: torch.Tensor, child: torch.Tensor,
               root, starts: torch.Tensor, his: torch.Tensor, *,
               height: int, max_out: int, pmask: int = 0,
               max_rounds: int | None = None):
    """Ordered range / successor-k scan over the lane frontier — the
    emit-cursor variant of `delta_walk`, one `veb_scan_fused` launch for
    the whole scan.

    value/mark/child are the arena arrays, read in place; ``starts`` /
    ``his`` are *packed* ``qpack`` bounds per lane (start exclusive, hi
    inclusive in key space), cast to the value dtype.  ``root`` is a scalar
    or per-lane (K,) seeds.  A lane whose start equals ``walk_big(dtype)``
    is born done.  ``max_rounds=None`` derives the cap from the arena
    geometry (`scan_round_cap`).

    Takes no ``q_tile``: the scan kernel's lane is a warp, and the lanes
    of a block follow the shared memory its rows take (4, fewer at tall
    heights; on an H100 1, 2 and 4 lanes a block read alike).

    Returns per lane:
      out:  (K, max_out) packed live *leaf* values in (start, hi], key
            ascending, ``walk_big`` padding (overflow buffers are merged
            by the engine dispatch — I5' correctness lives there)
      n:    emitted count
      hops: ΔNode visits across every pass (`delta_walk` accounting)
      more: bool — the row filled with live items remaining; resume from
            ``key_of(out[lane, n-1])``
    """
    if max_rounds is None:
        max_rounds = scan_round_cap(height, value.shape[0], max_out)
    starts = starts.to(value.dtype).contiguous()
    his = his.to(value.dtype).contiguous()
    roots = _roots(root, starts.shape[0], value.device)
    with TR.annotate("delta_scan"):
        return veb_scan_fused(value, mark, child, roots, starts, his,
                              height=height, max_out=max_out, pmask=pmask,
                              max_rounds=int(max_rounds))
