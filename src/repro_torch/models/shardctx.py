"""Activation-sharding context, mirroring ``repro.models.shardctx``: lets
launchers annotate model internals with sharding specs without the model
code depending on any mesh.

The model calls ``constrain(x, name)`` at layer boundaries.  Outside a
sharding context, and for a plain tensor, ``constrain`` returns ``x``
itself, so the unsharded paths (the CPU tests, serving on one card) run
exactly the ops they ran before.  Inside ``activation_sharding(specs)`` a
``DTensor`` whose spec has ``x.ndim`` entries is redistributed to the
spec's placements on its own mesh: the DTensor counterpart of
``with_sharding_constraint``, which pins what sharding propagation would
otherwise choose op by op.  An axis that does not divide its dim (a
short sequence's one SSD chunk on a 16-way axis) is left out: XLA pads
such a dim, while DTensor's view ops refuse an uneven shard.  So is an
axis of size 1, which shards nothing but still stops DTensor from
merging the dim with its neighbours.

``reshape(x, *shape)`` is ``x.reshape`` for the reshapes that split a dim
the specs may shard (heads out of a projection's width, microbatches out
of the batch).  DTensor cannot split a dim sharded n ways into dims whose
first is not a multiple of n, where XLA would reshard; so such a dim is
gathered first.

``on_shards(fn, args, dims, out_dims)`` runs the parts of a layer that
are independent across batch rows and heads (attention's scores and
softmax, the SSD scan, the Mamba2 decode update, the MoE dispatch) on
each device's own rows and heads.  Those are einsum and view chains whose
DTensor rules differ between torch releases and refuse sharded dims they
merge; on local tensors they are the plain ops.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.sharding import _axis_size, _fit, spec_placements

_state = threading.local()


def _specs() -> Optional[Dict]:
    return getattr(_state, "specs", None)


@contextlib.contextmanager
def activation_sharding(specs: Dict):
    prev = getattr(_state, "specs", None)
    _state.specs = specs
    try:
        yield
    finally:
        _state.specs = prev


def constrain(x, name: str):
    specs = _specs()
    if specs is None or not isinstance(x, DTensor):
        return x
    spec = specs.get(name)
    if spec is None or len(spec) != x.ndim:
        return x
    mesh = x.device_mesh
    spec = tuple(None if e is None or _axis_size(mesh, e) == 1
                 else _fit(d, mesh, e) for d, e in zip(x.shape, spec))
    placements = spec_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def _uneven_splits(old, new, counts) -> set:
    """Dims of ``old`` that the reshape to ``new`` splits into dims whose
    first is not a multiple of the dim's shard count ``counts[d]``."""
    bad, i, j = set(), 0, 0
    while i < len(old) and j < len(new):
        ins, outs = [i], [j]
        a, b = old[i], new[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= old[i]
                ins.append(i)
                i += 1
            else:
                b *= new[j]
                outs.append(j)
                j += 1
        if len(ins) == 1 and len(outs) > 1 and new[outs[0]] % counts[ins[0]]:
            bad.add(ins[0])
    return bad


def reshape(x, *shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape = tuple(x.numel() // known if s == -1 else s for s in shape)
    mesh = x.device_mesh
    counts = [1] * x.ndim
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            counts[p.dim] *= mesh.size(m)
    bad = _uneven_splits(tuple(x.shape), tuple(shape), counts)
    if bad:
        x = x.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim in bad else p
            for p in x.placements])
    return x.reshape(shape)


def on_shards(fn, args, dims, out_dims):
    """``fn(*args)`` on each device's batch rows and heads.

    ``dims[i]`` is the (batch dim, head dim) of ``args[i]``, either None;
    ``out_dims`` is that pair for ``fn``'s output, or a tuple of pairs for
    several outputs.  Plain tensors go straight to ``fn``.  On DTensors,
    each mesh axis that shards the first argument's batch dim shards every
    argument's batch dim; each axis that shards its head dim shards every
    argument's head dim, when every head count divides; every other axis
    holds whole copies.  ``fn`` runs on the local tensors and its outputs
    come back as DTensors of that layout.  An argument whole on an axis
    that shards the others gets its gradient as a partial sum there: each
    device's share comes from its own rows or heads."""
    first = args[0]
    if not isinstance(first, DTensor):
        return fn(*args)
    mesh = first.device_mesh
    b0, h0 = dims[0]

    def axes(d):
        return [m for m, p in enumerate(first.placements)
                if d is not None and isinstance(p, Shard) and p.dim == d]

    batch, heads = axes(b0), axes(h0)
    n = math.prod(mesh.size(m) for m in heads)
    if any(isinstance(a, torch.Tensor) and h is not None and a.shape[h] % n
           for a, (_, h) in zip(args, dims)):
        heads = []

    def placements(d, whole=Replicate()):
        b, h = d
        return tuple(Shard(b) if b is not None and m in batch
                     else Shard(h) if h is not None and m in heads
                     else whole if m in batch + heads
                     else Replicate() for m in range(mesh.ndim))

    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            else a for a in args]
    in_pl = tuple(placements(d) if isinstance(a, DTensor) else None
                  for a, d in zip(args, dims))
    grad_pl = tuple(placements(d, Partial()) if isinstance(a, DTensor)
                    else None for a, d in zip(args, dims))
    several = isinstance(out_dims[0], tuple)
    out_pl = tuple(placements(d) for d in (out_dims if several
                                           else (out_dims,)))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
