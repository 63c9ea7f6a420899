"""Continuous-batching serve scheduler (port of ``repro.serve.scheduler``).

Each ``step()``, as in the JAX package:

  1. reap departures — cancelled live lanes release their slot and stage
     page frees;
  2. admit — free slots fill FIFO from the waiting queue; each admission
     prefills (dense prefill, K/V copied into staged-allocated pages) and
     joins this step's decode batch;
  3. grow — live lanes crossing a page boundary stage tail allocations;
  4. apply — all staged ops run the same-key elimination pass and hit the
     index as ONE update batch (`DeltaPager.apply_staged`);
  5. decode — one `decode.paged_decode_step` over the live lanes (block
     tables via one wait-free lookup on the device, then the paged
     attention kernel per layer); the step's tokens come to the host in
     one transfer;
  6. finish — lanes reaching ``max_new`` release their slot and stage
     frees, then a second admission pass re-fills the freed lanes;
  7. barrier — ``MaintenanceWorker.maybe_drain`` runs off the decode path,
     triggered by the pending high-water mark.

``view_hits`` / ``view_builds`` count the forest's fused-view cache over
each step (non-zero only with a forest-backed pager).  ``metrics()``
snapshots every stats source the scheduler touches (`obs.export`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.api import Index
from repro_torch.distributed import forest as DF
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.obs import trace as OT
from repro_torch.obs.stats import ScanStats, ServeStats
from repro_torch.serve import decode as D
from repro_torch.serve.combine import dedupe_lookups
from repro_torch.serve.queue import RequestQueue, ServeRequest
from repro_torch.serve.worker import MaintenanceWorker
from repro_torch.serving.pager import DeltaPager, PagerConfig, make_pager

__all__ = ["SchedulerConfig", "ServeScheduler"]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static scheduler knobs (the model/pager configs ride separately).

    max_live:    decode-lane count — the bounded live-batch size.
    max_waiting: admission-control bound on the waiting FIFO (0 = none;
                 rejected submissions count in ``queue.rejected``).
    maint_high_water: overrides the pager config's field when not None.
    combine:     run the same-key elimination pass over staged batches.
    """

    max_live: int = 8
    max_waiting: int = 0
    maint_high_water: int | None = None
    combine: bool = True


def check_servable(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla:
        raise NotImplementedError(
            f"serving the {cfg.family!r} family{' with MLA' if cfg.mla else ''}"
            f" is not ported to repro_torch yet (ROADMAP.md, Queue 1)")


def page_tensors(cfg: ModelConfig, num_pages: int, page_size: int,
                 dtype, device):
    """Zero (L, NP, PS, KVH, HD) K and V page tensors."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


class ServeScheduler:
    """Continuous-batching scheduler over the paged-KV DeltaPager.

    ``model`` is the port's `Transformer` (the JAX package passes its
    params tree); the pager's index and the KV pages live on its device.
    Surface: ``submit() -> sid``, ``cancel``, ``step() -> {sid: tok}``,
    ``probe``, ``scan``, ``run_trace``, ``drain``, ``active[sid].out``,
    ``pager``, ``queue``, ``worker``, ``obs``, ``scan_obs``.
    """

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 pager_cfg: PagerConfig, sched: SchedulerConfig | None = None,
                 *, index: Index | None = None,
                 pager: DeltaPager | None = None):
        check_servable(cfg)
        self.cfg = cfg
        self.model = model
        self.sched = sched if sched is not None else SchedulerConfig()
        self.pager = pager if pager is not None else make_pager(
            pager_cfg, index, device=model.device)
        pager_cfg = self.pager.cfg
        self.ps = pager_cfg.page_size
        self.queue = RequestQueue(self.sched.max_live,
                                  self.sched.max_waiting)
        self.worker = MaintenanceWorker(
            self.pager, high_water=self.sched.maint_high_water)
        self.layers = D.layer_params(cfg, model)
        self.k_pages, self.v_pages = page_tensors(
            cfg, pager_cfg.num_pages, self.ps, model.act_dtype, model.device)
        self.active: dict[int, ServeRequest] = {}   # every request ever
        self.lengths: dict[int, int] = {}
        self._next_id = 0
        self._steps = 0
        self._probe_combined = 0
        self._combined_mark = 0   # combined ops already folded into obs
        self.obs = ServeStats.zero()
        self.scan_obs = ScanStats.zero()
        self.last_step_info: dict = {}

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------- arrival ---

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        """Enqueue a request (admission happens inside ``step``).  Returns
        its seq id; a rejected submission still gets an id, with
        ``active[sid].cancelled`` set."""
        sid = self._next_id
        self._next_id += 1
        req = ServeRequest(sid, np.asarray(prompt, np.int32), max_new,
                           submit_step=self._steps)
        self.active[sid] = req
        self.queue.submit(req)
        return sid

    def cancel(self, sid: int) -> str:
        """Departure mid-flight; live lanes are reaped at the next step."""
        return self.queue.cancel(sid)

    # ---------------------------------------------------------------- step ---

    def step(self) -> dict[int, int]:
        """One scheduler step; returns {sid: token} for decoded lanes.
        Records one ``ServeStats`` sample whenever any work happened —
        latency, queue depth, admission waits, combined ops, fused-view
        cache hits and builds (a forest-backed pager's), pending
        high-water, worker drains."""
        t0 = time.perf_counter()
        v0 = DF.fused_view_cache_stats()
        with OT.span("serve.sched_step"):
            out, info = self._step()
        v1 = DF.fused_view_cache_stats()
        # combining counts the staged batches and the probe service
        total_combined = self.pager.stats["combined"] + self._probe_combined
        info.update(
            queue_depth=self.queue.depth,
            combined=total_combined - self._combined_mark,
            view_hits=v1["hits"] - v0["hits"],
            view_builds=v1["builds"] - v0["builds"],
        )
        self._combined_mark = total_combined
        self.last_step_info = info
        if out or info["admitted"] or info["applied"]:
            self.obs = self.obs.record(
                time.perf_counter() - t0,
                pending=self.pager.pending,
                flushed=info["drained"],
                queue_depth=info["queue_depth"],
                admitted=info["admitted"],
                admit_wait=info["admit_wait"],
                combined=info["combined"],
                view_hits=info["view_hits"],
                view_builds=info["view_builds"],
            )
        return out

    def _admit(self) -> list[tuple[int, ServeRequest]]:
        """One admission pass: fill free slots, stage page allocations,
        prefill into the staged pages."""
        admitted = self.queue.admit(self._steps)
        for _, req in admitted:
            n_blocks = -(-len(req.prompt) // self.ps)
            pages = self.pager.stage_allocate(req.seq_id, n_blocks)
            with OT.span("serve.prefill"):
                self.k_pages, self.v_pages, s, tok = D.prefill_to_pages(
                    self.cfg, self.model, self.ps, self.k_pages,
                    self.v_pages, req.prompt, pages)
            self.lengths[req.seq_id] = s
            req.out.append(tok)
        return admitted

    def _retire(self, slot: int, req: ServeRequest) -> None:
        """Departure: release the lane, stage the sequence's page frees."""
        self.queue.release(slot)
        self.pager.stage_free(req.seq_id)
        self.lengths.pop(req.seq_id, None)

    def _decode(self, sids: list[int]) -> list[int]:
        """One paged decode step over ``sids`` (slot order); the tokens."""
        lens = np.asarray([self.lengths[s] for s in sids], np.int32)
        maxp = int(lens.max()) // self.ps + 1
        bt = self.pager.block_tables(sids, maxp)   # ΔTree hot path
        tokens = torch.as_tensor([[self.active[s].out[-1]] for s in sids],
                                 dtype=torch.int32).to(self.device)
        with OT.span("serve.decode"):
            logits, self.k_pages, self.v_pages = D.paged_decode_step(
                self.model, self.cfg, self.layers, tokens, self.k_pages,
                self.v_pages, bt, torch.as_tensor(lens).to(self.device),
                self.ps)
        return torch.argmax(logits[:, 0], dim=-1).tolist()

    def _step(self):
        # 1. reap departures marked since the last barrier
        for slot, req in self.queue.live():
            if req.cancelled:
                self._retire(slot, req)
        # 2. admission: freed/initial slots join this step's decode
        admitted = self._admit()
        # 3. growth: lanes whose next token crosses a page boundary
        for _, req in self.queue.live():
            sid = req.seq_id
            needed = self.lengths[sid] // self.ps + 1
            have = self.pager.seq_blocks[sid]
            if needed > have:
                self.pager.stage_allocate(sid, needed - have)
        # 4. one combined index update for everything staged
        applied = self.pager.apply_staged(self.sched.combine)
        # 5. decode all live lanes (slot order)
        out: dict[int, int] = {}
        lanes = self.queue.live()
        if lanes:
            toks = self._decode([r.seq_id for _, r in lanes])
            for tok, (slot, req) in zip(toks, lanes):
                req.out.append(tok)
                out[req.seq_id] = tok
                self.lengths[req.seq_id] += 1
                # 6a. finish check after the decode append (the prefill
                # token alone never finishes a request)
                if len(req.out) >= req.max_new:
                    req.done = True
                    self._retire(slot, req)
        self._steps += 1
        # 6b. slot recycling: re-fill lanes freed by this step's finishers
        # now (prefill this step, decode joins the next)
        admitted += self._admit()
        # 7. step barrier: background maintenance off the decode path
        drained = self.worker.maybe_drain(self._steps)
        info = dict(
            admitted=len(admitted),
            admit_wait=sum(r.wait_steps for _, r in admitted),
            applied=applied["applied"],
            inline_maint=applied["inline_maint"],
            drained=drained,
        )
        return out, info

    # ------------------------------------------------------- read service ---

    def probe(self, seq_ids) -> np.ndarray:
        """Read-side service traffic: the head-block page of each referenced
        sequence (-1 when unmapped) through one wait-free lookup; duplicate
        references collapse to one lookup each (`dedupe_lookups`)."""
        keys = self.pager._key(np.asarray(seq_ids, np.int64),
                               np.zeros(len(seq_ids), np.int64))
        uniq, inverse, combined = dedupe_lookups(keys)
        self._probe_combined += combined
        with OT.span("serve.probe"):
            found, pages, hops = self.pager._lookup(uniq)
        self.pager.stats["searches"] += len(uniq)
        self.pager.stats["hops"] += int(hops.sum())
        out = np.where(found.cpu().numpy(), pages.cpu().numpy(), -1)[inverse]
        self.obs = self.obs.record_probe(len(seq_ids),
                                         int((out >= 0).sum()))
        return out

    def scan(self, seq_ids, max_items: int | None = None):
        """Ordered read service: each referenced sequence's block -> page
        mapping in block order through ONE engine scan dispatch (one lane
        per sequence over its contiguous key band); staged allocations are
        invisible until the step barrier applies them.  Returns {seq_id:
        page ids in block order}; folds one ``ScanStats`` sample into
        ``scan_obs``."""
        pg = self.pager
        ix = pg.index
        ix._require("range_scan", ix.spec.backend.scan)
        if max_items is None:
            max_items = pg.cfg.max_blocks
        sids = np.asarray(seq_ids, np.int64)
        # the band (key(sid, -1), key(sid, max_blocks - 1)] is exactly the
        # sequence's block table (start bound exclusive)
        starts = pg._key(sids, np.full(sids.shape, -1))
        his = pg._key(sids, np.full(sids.shape, pg.cfg.max_blocks - 1))
        with OT.span("serve.scan"):
            _, pages, n, hops, more = ix.spec.backend.scan(
                ix.spec.cfg, ix.state, starts, his, max_items)
        pg.stats["searches"] += len(sids)
        pg.stats["hops"] += int(hops.sum())
        self.scan_obs = self.scan_obs.merge(ScanStats.of(n, hops, more))
        pages, n = pages.cpu().numpy(), n.cpu().numpy()
        return {int(s): pages[i, : n[i]] for i, s in enumerate(sids)}

    def metrics(self, fmt: str = "dict"):
        """Point-in-time metrics snapshot across every stats source the
        scheduler touches: the decode loop's ``ServeStats``, the scan
        service's ``ScanStats``, the maintenance worker's drain counters,
        the pager's op counters, the read path's last ``ReadStats`` legs
        (search / router / transfers — present when the index was built
        with ``collect_stats``), and any ``REPRO_TRACE`` counters.
        ``fmt``: "dict" (nested plain dict), "prometheus" (text
        exposition), or "json"."""
        from repro_torch.obs import export as OX

        if fmt not in ("dict", "prometheus", "json"):
            raise ValueError(f"unknown metrics fmt {fmt!r}")
        rs = self.pager.last_read_stats
        snap = OX.snapshot(
            serve=self.obs,
            scan=self.scan_obs,
            maintenance=self.worker.stats(),
            pager=self.pager.stats,
            search=rs.search if rs is not None else None,
            router=rs.router if rs is not None else None,
            transfers=rs.transfers if rs is not None else None,
            trace=OT.counters() or None,
        )
        if fmt == "prometheus":
            return OX.to_prometheus(snap)
        if fmt == "json":
            return OX.to_json(snap)
        return snap

    # ------------------------------------------------------------ trace ---

    def run_trace(self, plans, *, drain: bool = True) -> dict:
        """Replay a ``synth_trace`` plan: per step submit the arrivals,
        issue the cancels and probe traffic, then ``step()``.  Returns a
        summary dict."""
        tokens = 0
        for plan in plans:
            for prompt, max_new in plan.arrivals:
                self.submit(prompt, max_new=max_new)
            for ref in plan.cancels:
                self.cancel(ref)
            if len(plan.probe_refs):
                self.probe(plan.probe_refs)
            tokens += len(self.step())
        if drain:
            self.drain()
        finished = sum(r.done for r in self.active.values())
        return {
            "submitted": self._next_id,
            "finished": finished,
            "rejected": self.queue.rejected,
            "decode_tokens": tokens,
            "steps": self._steps,
        }

    # ------------------------------------------------------------ drain ---

    def drain(self, max_steps: int = 10_000) -> None:
        """Step until every submitted request departed, then apply any
        staged frees and force a final maintenance drain."""
        for _ in range(max_steps):
            if not self.queue.live() and not self.queue.waiting:
                break
            self.step()
        self.pager.apply_staged(self.sched.combine)
        self.worker.maybe_drain(self._steps, force=True)
