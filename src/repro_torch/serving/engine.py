"""Serving engines over the ΔTree-paged KV cache (port of
``repro.serving.engine``).

``ServeEngine`` — the public name — is a thin shim over the
continuous-batching scheduler (`repro_torch.serve.scheduler.ServeScheduler`):
the legacy constructor, with ``max_batch`` as the scheduler's live-lane
count.  ``LockstepServeEngine`` is the pre-scheduler loop, kept as the
parity oracle: it steps all live requests in lockstep, applies every pager
mutation immediately, and drains maintenance on the decode path when the
``maint_high_water`` mark is reached.  Both
share `repro_torch.serve.decode`: dense prefill copied into pages, then
per step one paged-attention pass over the pager-resolved block tables.

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import PagerConfig, ServeEngine

    cfg = get_smoke_config("granite_8b")
    model = Transformer(cfg, device="cpu", seed=0)   # on the card: no device
    eng = ServeEngine(cfg, model, PagerConfig(num_pages=64, page_size=4,
                      max_blocks=64, tree_height=4, engine="lockstep"))
    sid = eng.submit(prompt, max_new=6)
    while not eng.active[sid].done:
        eng.step()
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.api import Index
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.obs import trace as OT
from repro_torch.obs.stats import ServeStats
from repro_torch.serve import decode as D
from repro_torch.serve.scheduler import (
    SchedulerConfig,
    ServeScheduler,
    check_servable,
    page_tensors,
)
from repro_torch.serving.pager import DeltaPager, PagerConfig, make_pager


class ServeEngine(ServeScheduler):
    """The legacy constructor over the scheduler: ``max_batch`` becomes
    ``SchedulerConfig.max_live``."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 pager_cfg: PagerConfig, max_batch: int = 8, *,
                 index: Index | None = None, pager: DeltaPager | None = None):
        super().__init__(cfg, model, pager_cfg,
                         SchedulerConfig(max_live=max_batch),
                         index=index, pager=pager)
        self.max_batch = max_batch


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class LockstepServeEngine:
    """The legacy loop: submit prefills immediately, every step decodes all
    live requests (capped at ``max_batch``), mutations hit the index one
    call at a time, maintenance drains inline."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 pager_cfg: PagerConfig, max_batch: int = 8, *,
                 index: Index | None = None, pager: DeltaPager | None = None):
        check_servable(cfg)
        self.cfg = cfg
        self.model = model
        self.pager = pager if pager is not None else make_pager(
            pager_cfg, index, device=model.device)
        pager_cfg = self.pager.cfg
        self.ps = pager_cfg.page_size
        self.max_batch = max_batch
        self.layers = D.layer_params(cfg, model)
        self.k_pages, self.v_pages = page_tensors(
            cfg, pager_cfg.num_pages, self.ps, model.act_dtype, model.device)
        self.active: dict[int, Request] = {}
        self.lengths: dict[int, int] = {}
        self._next_id = 0
        self.obs = ServeStats.zero()

    # ------------------------------------------------------------- submit ---

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        sid = self._next_id
        self._next_id += 1
        req = Request(sid, np.asarray(prompt, np.int32), max_new)
        n_blocks = -(-len(req.prompt) // self.ps)
        pages = self.pager.allocate(sid, n_blocks)
        self.k_pages, self.v_pages, s, tok = D.prefill_to_pages(
            self.cfg, self.model, self.ps, self.k_pages, self.v_pages,
            req.prompt, pages)
        self.lengths[sid] = s
        req.out.append(tok)
        self.active[sid] = req
        return sid

    # --------------------------------------------------------------- step ---

    def step(self) -> dict[int, int]:
        """One decode step for all active sequences; returns {seq: token}.
        Every non-empty step records one sample into ``self.obs``."""
        t0 = time.perf_counter()
        with OT.span("serve.step"):
            out, flushed = self._step()
        if out:
            self.obs = self.obs.record(time.perf_counter() - t0,
                                       pending=self.pager.pending,
                                       flushed=flushed)
        return out

    def _step(self):
        sids = [s for s, r in self.active.items()
                if not r.done][: self.max_batch]
        if not sids:
            return {}, False
        # grow pages where the next token crosses a page boundary
        for sid in sids:
            needed = self.lengths[sid] // self.ps + 1
            have = self.pager.seq_blocks[sid]
            if needed > have:
                self.pager.allocate(sid, needed - have)

        lens = np.asarray([self.lengths[s] for s in sids], np.int32)
        maxp = int(lens.max()) // self.ps + 1
        bt = self.pager.block_tables(sids, maxp)          # ΔTree hot path
        dev = self.model.device
        tokens = torch.as_tensor([[self.active[s].out[-1]] for s in sids],
                                 dtype=torch.int32).to(dev)
        logits, self.k_pages, self.v_pages = D.paged_decode_step(
            self.model, self.cfg, self.layers, tokens, self.k_pages,
            self.v_pages, bt, torch.as_tensor(lens).to(dev), self.ps)
        for sid in sids:
            self.lengths[sid] += 1
        # inline maintenance on the pending high-water mark
        hw = self.pager.cfg.maint_high_water
        flushed = bool(hw and self.pager.pending >= hw)
        if flushed:
            self.pager.flush()
        out = {}
        toks = torch.argmax(logits[:, 0], dim=-1).tolist()
        for tok, sid in zip(toks, sids):
            req = self.active[sid]
            req.out.append(tok)
            out[sid] = tok
            if len(req.out) >= req.max_new:
                req.done = True
                self.finish(sid)
        return out, flushed

    def finish(self, sid: int):
        self.pager.free_seq(sid)
        self.lengths.pop(sid, None)
