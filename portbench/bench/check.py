"""The comparison that decides ``correct``.

After the window, the plain reference (``portbench/reference/``) starts
from the same initial keys and replays every step's update batch in
order.  Before each step's updates it answers that step's reads where
the client kept them, and each kept answer is compared: a found flag, a
payload, or a successor row as far as the scan's length.  Every update
result is compared, and at the end the whole live set.  Each number is a
count of wrong answers, and its limit is 0: the configuration states
exact answers.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

LIMITS = {"read_wrong": 0, "update_wrong": 0, "final_wrong": 0}


def reference_class(config: dict):
    mod = importlib.import_module(f"portbench.reference.{config['reference']}")
    return mod.SortedIndex


def _read_wrong(ref, op, stream, i, got) -> int:
    q = stream.reads(i)
    if op == "search":
        return int((ref.search(q).cpu() != got[0]).sum())
    if op == "lookup":
        found, pay = ref.lookup(q)
        bad = (found.cpu() != got[0]) | (pay.cpu().to(torch.int64)
                                         != got[1].to(torch.int64))
        return int(bad.sum())
    ks, ps, n = ref.successor_k(q, stream.k)
    lens = torch.as_tensor(stream.lengths[stream.row(i)])
    keep = torch.arange(stream.k)[None, :] < lens[:, None]
    bad = (((ks.cpu() != got[0].to(torch.int64))
            | (ps.cpu() != got[1].to(torch.int64))) & keep).any(1)
    bad |= torch.minimum(n.cpu(), lens) != torch.minimum(
        got[2].to(torch.int64), lens)
    return int(bad.sum())


def final_wrong(want, got) -> int:
    """Keys in one live set and not the other, plus shared keys whose
    payloads differ."""
    wk, wp = want
    gk, gp = got
    if wk.size == gk.size and (wk == gk).all() and (wp == gp).all():
        return 0
    common, wi, gi = np.intersect1d(wk, gk, return_indices=True)
    return int(wk.size + gk.size - 2 * common.size
               + (wp[wi] != gp[gi]).sum())


def compare(config, ds, stream, client, n_steps: int, live, device) -> dict:
    """Replays steps 0 .. n_steps - 1 and returns each number compared,
    with the counts of answers it covered."""
    ref = reference_class(config)(ds.keys, ds.payloads, device)
    read_bad = upd_bad = reads = updates = 0
    for i in range(n_steps):
        got = client.read_answers(i)
        if got is not None:
            read_bad += _read_wrong(ref, stream.read_op, stream, i, got)
            reads += got[0].shape[0]
        upd = stream.updates(i) if stream.update_kind else None
        if upd is None:
            continue
        res = ref.apply(*upd).cpu()
        upd_bad += int((res != client.update_results(i)).sum())
        updates += res.numel()
    return {"read_wrong": read_bad, "update_wrong": upd_bad,
            "final_wrong": final_wrong(ref.items(), live),
            "reads_compared": reads, "updates_compared": updates}
