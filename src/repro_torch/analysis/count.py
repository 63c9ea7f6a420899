"""What a step costs, counted from the ops it dispatches (the port's stand-in
for XLA's ``cost_analysis()`` and ``memory_analysis()``).

`count` runs a callable under one dispatch mode and returns a `Count`:

- ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts,
  from its formulas (``flop_registry``): the products only (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention), two
  operations a multiply-add.  XLA's ``flops`` also counts elementwise
  work, so the two do not compare.  The mode itself is not used: its
  module tracker hooks every module's outputs and holds them, which
  quadrupled a remat train step's live bytes at a narrow width.
- ``bytes accessed``: for every aten op that moves data, the bytes it
  reads plus the bytes it writes: the eager program's traffic, op by op,
  unfused.  A tensor's bytes are its distinct elements' (a broadcast
  dimension, stride 0, once).  An op reads each tensor it takes and
  writes each it returns, but for the ops that touch part of a tensor:
  a gather (``index.Tensor``, ``index_select``, ``embedding``,
  ``gather``) reads the indices and only the rows it returns; a scatter
  in place (``index_put_``, ``index_add_``) reads the indices and the
  values and writes only the elements it indexes (reading them first
  when it accumulates); ``copy_``, ``fill_``, ``zero_`` and an ``out=``
  write their destination without reading it.  An op moves no data
  when every tensor it returns shares its storage with one it takes and
  it writes none of its arguments (``view``, ``transpose``, ``expand``,
  ``_unsafe_view``, ``detach``): such ops are left out.
- peak live bytes: every storage alive when the step starts (the
  arguments) plus every storage an op creates, from its creation until
  the storage is freed, each storage once however many views share it
  and each rounded up to the caching allocator's 512 bytes; the most
  that was ever live.  That is what ``torch.cuda.max_memory_allocated``
  reads after ``reset_peak_memory_stats`` over the same step, but for
  the allocator's own slack and the scratch memory a kernel allocates
  inside one op.

Only the ops that touch the step's device are counted (``device``): host
bookkeeping on CPU tensors, such as the random-number states that
``torch.utils.checkpoint`` stashes and restores on a card, is not the
step's device work.

The mode sees the ops the autograd engine dispatches too (the backward
pass, and ``torch.utils.checkpoint``'s replay of the forward), since the
engine carries them to its threads.  On the meta device nothing is
computed or allocated, so a full-width step is counted on the host; the
same count of the same step on the card gives the same ``flops`` and
``bytes`` (the op stream depends on shapes only), which is how
``chip_smoke.py`` holds the count to the card.  That equality shows that
the meta device and the card run the same op stream; it does not measure
what the card's memory moves (no counter of the card is read), so the
bytes are a model of the traffic, held to hand counts in the tests.  A step that reads a
tensor's value on the host (``.item()``, ``nonzero``) cannot run on meta
tensors and raises.

Sharded (DTensor parameters and activations, `repro_torch.parallel`),
the mode counts this rank's local ops: it lets a DTensor op fall through
to DTensor's own handler and counts the ops that handler runs on the
blocks, so ``flops`` and ``bytes`` are per device, as JAX's post-SPMD
module's (the ops DTensor's sharding propagation runs on fake tensors of
the global shapes are not the step's and are left out).  The collectives are not ops of the count: their buffers count
toward neither ``bytes`` nor ``ops`` (the copy `parallel.comm` makes of
an operand, and the empty result it allocates, do; the copies a backend
makes inside a collective, such as gloo's, do not), and each is a
`parallel.comm.Record` in ``collectives``, which
`analysis.roofline.collective_stats` turns into wire bytes.  An op of
DTensor's functional collectives raises, as under
`parallel.comm.no_functional_collectives`.  On a fake
process group (`launch.mesh.fake_process_group`) over the meta device
the same step gives rank 0's count of a real group's.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel import comm

ALLOC_ROUND = 512   # the CUDA caching allocator's block granularity


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree, out=None) -> list:
    """The tensors in nested lists, tuples and dicts, in order (a
    DTensor's block)."""
    out = [] if out is None else out
    if isinstance(tree, DTensor):
        out.append(tree._local_tensor)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@functools.cache
def _writes(func) -> bool:
    """Whether the op writes one of its arguments (in place, ``out=``)."""
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` spans: a broadcast
    dimension (stride 0) counts once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0 or size == 0:
            n *= size
    return n


aten = torch.ops.aten
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}


def _indexed(t: torch.Tensor, indices, values: torch.Tensor) -> int:
    """How many elements of ``t`` ``t[indices] = values`` writes (integer
    indices, None for a whole dimension); with a mask, whose count
    depends on its values, the values' own."""
    if any(ix is not None and ix.dtype in (torch.bool, torch.uint8)
           for ix in indices):
        return values.numel()
    n = 1
    for d, size in enumerate(t.shape):
        if d >= len(indices) or indices[d] is None:
            n *= size
    shapes = [ix.shape for ix in indices if ix is not None]
    for size in torch.broadcast_shapes(*shapes):
        n *= size
    return n


def _traffic(func, args, kwargs, ins: list, outs: list) -> int:
    """The bytes an op that moves data reads and writes (see the module
    docstring)."""
    packet = func._overloadpacket
    if packet in _GATHERS:
        return (sum(map(_nbytes, ins[1:]))
                + 2 * sum(map(_nbytes, outs)))
    if packet in (aten.index_put_, aten._index_put_impl_):
        dst, indices, values = args[0], args[1], args[2]
        accumulate = (args[3] if len(args) > 3
                      else kwargs.get("accumulate", False))
        written = _indexed(dst, indices, values) * dst.element_size()
        return (sum(_nbytes(ix) for ix in indices if ix is not None)
                + _nbytes(values) + written * (2 if accumulate else 1))
    if packet is aten.index_add_:
        dst, index, source = args[0], args[2], args[3]
        return (_nbytes(index) + _nbytes(source)
                + 2 * source.numel() * dst.element_size())
    if packet in _OVERWRITES:
        return sum(map(_nbytes, ins[1:] + outs))
    if "out" in kwargs:
        unread = {id(t) for t in _tensors(kwargs["out"])}
        ins = [t for t in ins if id(t) not in unread]
    return sum(map(_nbytes, ins + outs))


@dataclasses.dataclass
class Count:
    flops: int            # products only (FlopCounterMode's formulas)
    bytes: int            # what every op that moves data reads and writes
    argument_bytes: int   # storages alive when the step started
    output_bytes: int     # storages the step returned that it created
    peak_bytes: int       # arguments + the most the step held besides
    ops: int              # aten ops dispatched (views included)
    by_op: dict           # op name -> times dispatched
    collectives: list = dataclasses.field(default_factory=list)
    # ^ `parallel.comm.Record` of each collective, in order

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes


class _StepCounter(TorchDispatchMode):
    """Sums each product's FLOPs and each data-moving op's tensor bytes;
    with ``live`` also tracks every storage from its creation (or the
    start) to its release."""

    def __init__(self, live: bool, device: str | None):
        super().__init__()
        self.device = device
        self.by_op: dict[str, int] = {}
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._track = live
        self._refs: dict[int, weakref.ref] = {}
        self._lock = threading.RLock()   # a free may run inside _add (gc)

    def hold(self, tensors) -> int:
        """Track the storages of ``tensors`` (the arguments); returns the
        bytes they add."""
        before = self.live
        for t in tensors:
            self._add(t)
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._refs:
                return
            size = _rounded(st.nbytes())
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, size=size: self._free(key, size))
            self.live += size
            self.peak = max(self.peak, self.live)

    def _free(self, key: int, size: int) -> None:
        with self._lock:
            if self._refs.pop(key, None) is not None:
                self.live -= size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if comm.BUSY[0]:                 # inside a collective's backend
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # count the ops on the blocks
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs an op on fake tensors of
            # the global shapes to learn its output's: no work of the step
            return func(*args, **(kwargs or {}))
        if func.namespace in comm.FUNCTIONAL:
            raise RuntimeError(f"{func} ran: a DTensor rule communicated "
                               "where the step's collectives are "
                               "parallel.comm's")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                   # a factory of those fake tensors
        if self.device is not None and not any(
                t.device.type == self.device for t in ins + outs):
            return out
        self.ops += 1
        name = str(func)
        self.by_op[name] = self.by_op.get(name, 0) + 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if outs and not _writes(func):
            seen = {_key(t) for t in ins}
            moves = any(_key(t) not in seen for t in outs)
        else:
            moves = True
        if moves:
            self.bytes += _traffic(func, args, kwargs, ins, outs)
        if self._track:
            for t in outs:
                self._add(t)
        return out


def count(fn, arguments=(), live: bool = True, device: str | None = None):
    """``fn()`` under the counters; returns (its result, a `Count`).
    ``arguments`` are the tensors alive before the step (parameters,
    buffers, optimizer state, batch, caches); with ``live`` their storages
    and every one the step creates are tracked for the peak (the card
    reads its own peak, so its count turns this off).  ``device`` (a
    device type: "meta", "cuda", "cpu") leaves out every op none of
    whose tensors lies there; None counts every op."""
    counter = _StepCounter(live, device)
    arg_bytes = counter.hold(_tensors(arguments)) if live else 0
    before = set(counter._refs)
    with comm.recording() as records, counter:
        out = fn()
    made = {_key(t): t for t in _tensors(out) if _key(t) not in before}
    out_bytes = sum(_rounded(t.untyped_storage().nbytes())
                    for t in made.values()) if live else 0
    return out, Count(flops=int(counter.flops),
                      bytes=int(counter.bytes), argument_bytes=arg_bytes,
                      output_bytes=out_bytes, peak_bytes=counter.peak,
                      ops=counter.ops, by_op=counter.by_op,
                      collectives=list(records))
