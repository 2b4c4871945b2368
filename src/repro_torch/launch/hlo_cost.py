"""Per-device cost analysis of one step from a dispatch trace: the port's
counterpart of ``repro.launch.hlo_cost``, which parses compiled XLA HLO
text.  PyTorch produces no HLO, so ``trace_step`` runs the step once
under a ``TorchDispatchMode`` and records every op that runs on a
device's *local* tensors (the shards of the DTensors, on ``meta`` in the
dry-run, so nothing is allocated):

  flops            ``torch.utils.flop_counter``'s formulas (the ones
                   ``FlopCounterMode`` applies) on the local ops.  Around
                   DTensor ops ``FlopCounterMode`` would count the global
                   op; a mode that returns ``NotImplemented`` for DTensor
                   ops lets DTensor run its local ops under it, and those
                   are what one device computes.
  hbm_bytes        the reference's rule: every op's output written once
                   plus each of its inputs read once; views and metadata
                   ops are free.  Eager PyTorch fuses nothing, so this is
                   an upper bound on what a fused step would move.
  collective_bytes operand bytes of the ``c10d_functional`` collectives
                   DTensor issues, by the reference's five kinds.
  peak_bytes       the peak of live bytes in storages the step created
                   and used (its outputs included).

Ops that DTensor's sharding propagation runs on ``FakeTensor``s to learn
output shapes are not part of the step and are skipped.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# collective op name fragments -> the reference's kinds
_KINDS = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("permute", "collective-permute"),
          ("send", "collective-permute"), ("recv", "collective-permute"))

# ops that move no data: allocation without a fill, and bookkeeping
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_wrap_tensor_autograd", "wait_tensor", "_local_scalar_dense",
         "set_", "resize_", "_has_compatible_shallow_copy_type"}


def _is_collective(func) -> bool:
    return func.namespace in ("_c10d_functional", "c10d", "_dtensor",
                              "c10d_functional") and \
        func.__name__.split(".")[0] not in _FREE


def _kind(name: str) -> str:
    return next((k for frag, k in _KINDS if frag in name), "other")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0

    def __iadd__(self, o):
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.coll_bytes += o.coll_bytes
        return self


@dataclasses.dataclass
class OpRecord:
    name: str
    flops: float
    hbm_bytes: float
    coll_kind: str = ""
    coll_bytes: float = 0.0


@dataclasses.dataclass
class StepTrace:
    """What one device did in one step (the counterpart of the compiled
    module the reference analyzes)."""
    ops: List[OpRecord]
    argument_bytes: float
    output_bytes: float
    alias_bytes: float
    peak_bytes: float
    trace_s: float
    out: object = None


class _Recorder(TorchDispatchMode):
    def __init__(self, arg_storages):
        super().__init__()
        self._args = arg_storages  # the step's arguments: not its temps
        self.ops: List[OpRecord] = []
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}  # storage -> bytes, counted
        self._pending: Dict[int, int] = {}  # allocated, not yet used

    def _drop(self, key):
        if key in self._live:
            self.live -= self._live.pop(key)
        self._pending.pop(key, None)

    def _track(self, t: torch.Tensor, used: bool):
        """Count ``t``'s storage as live once a recorded op uses it.  An
        allocation without a fill (``empty_strided``) waits in pending:
        sharding propagation allocates global-shape tensors that only its
        shape inference touches."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._args:
            return
        if key not in self._pending:
            if not used:
                self._pending[key] = st.nbytes()
                weakref.finalize(st, self._drop, key)
                return
            weakref.finalize(st, self._drop, key)
        self._pending.pop(key, None)
        self._live[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local ops under us
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or \
                torch._C._meta_in_tls_dispatch_include():
            return out  # sharding propagation's shape inference
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.__name__.split(".")[0]
        if func.is_view or name in _FREE:
            for t in outs:
                self._track(t, used=False)
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            if t.untyped_storage()._cdata in self._pending:
                self._track(t, used=True)
        for t in outs:
            self._track(t, used=True)
        in_bytes = sum(_nbytes(t) for t in ins)
        hbm = in_bytes + sum(_nbytes(t) for t in outs)
        if _is_collective(func):
            self.ops.append(OpRecord(str(func), 0.0, hbm, _kind(name),
                                     in_bytes))
            return out
        fl = flop_registry.get(func._overloadpacket)
        flops = float(fl(*args, **kwargs, out_val=out)) if fl else 0.0
        self.ops.append(OpRecord(str(func), flops, hbm))
        return out


def local_bytes(tree) -> int:
    """Bytes one device holds of ``tree``'s tensors (a DTensor's local
    shard)."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _storage_keys(tree) -> Dict[int, int]:
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            out[loc.untyped_storage()._cdata] = _nbytes(loc)
    return out


def trace_step(fn, *args, **kwargs) -> StepTrace:
    """Run ``fn(*args, **kwargs)`` once and record what one device does."""
    arg_keys = _storage_keys((args, kwargs))
    rec = _Recorder(arg_keys)
    t0 = time.time()
    with rec:
        out = fn(*args, **kwargs)
    trace_s = time.time() - t0
    out_keys = _storage_keys(out)
    return StepTrace(
        ops=rec.ops, argument_bytes=float(local_bytes((args, kwargs))),
        output_bytes=float(local_bytes(out)),
        alias_bytes=float(sum(b for k, b in out_keys.items()
                              if k in arg_keys)),
        peak_bytes=float(rec.peak), trace_s=trace_s, out=out)


def analyze(trace: StepTrace) -> Cost:
    c = Cost()
    for op in trace.ops:
        c += Cost(op.flops, op.hbm_bytes, op.coll_bytes)
    return c

