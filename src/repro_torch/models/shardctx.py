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
merging the dim with its neighbours.  Besides the reference's names,
the models constrain each product's operands (a weight, a norm's scale,
the head's input) by the names of ``launch.sharding.product_specs``
before the product, as the reference's XLA lays them out, so that no
torch release's op-by-op choice decides how much of a product each
device computes.  A spec may hold one ``...``, which stands for as many
``None`` entries as ``x`` has dims beyond the spec's others (an operand
with or without a sequence dim).

``row_block(x, start, stop)`` is ``x[start:stop]`` laid out as ``x``:
where ``x``'s rows are sharded, each device receives its share of the
block from the devices that hold it, in one all-to-all (DTensor's slice
of a sharded dim would gather the whole dim to every device: the whole
batch, for a microbatch).

``reshape(x, *shape)`` is ``x.reshape`` for the reshapes that split or
merge a dim the specs may shard (heads out of a projection's width,
a head's dims back into the width).
DTensor cannot split a dim sharded n ways into dims whose first is not a
multiple of n, nor (torch 2.11) merge a sharded dim into the dim before
it, where XLA would reshard; so such a dim is gathered first.

``grad_in_layout(x)`` is ``x``, but the gradient that reaches it in the
backward pass is redistributed to ``x``'s own placements (a partial sum to
a replica).  Sharding propagation of the backward ops may leave a
gradient sharded on a dim that the forward never sharded; torch 2.11's
DTensor does so on the sequence dim (behind the MoE router's and the
Mamba2 ``dt`` products, and qwen3's key heads), and then refuses the
backward of the view that made ``x`` (a reshape's, or the one inside a
3-D by 2-D matmul) because it would flatten that dim.  In the forward
layout that backward view is the forward one reversed.  ``reshape``
applies it to what it returns.

``on_shards(fn, args, dims, out_dims)`` runs the parts of a layer that
are independent across batch rows and heads (attention's scores and
softmax, the SSD scan, the Mamba2 decode update, the MoE dispatch) on
each device's own rows and heads, or its slice of a third dim (queries,
keys, chunks, vocab rows) where the heads leave the model axis free.
Those are einsum and view chains whose DTensor rules differ between
torch releases and refuse sharded dims they merge; on local tensors they
are the plain ops.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

import torch
import torch.distributed._functional_collectives as funcol
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


def layout_key():
    """The active specs in a hashable form, None outside a sharding
    context: ``core.jit`` keys its captures on it, since a capture
    records the redistributions that the specs chose."""
    specs = _specs()
    return None if specs is None else frozenset(specs.items())


def spec_of(name: str):
    """The active spec named ``name`` (None outside a sharding context)."""
    specs = _specs()
    return None if specs is None else specs.get(name)


def constrain(x, name: str):
    specs = _specs()
    if specs is None or not isinstance(x, DTensor):
        return x
    spec = specs.get(name)
    if spec is not None and ... in spec:
        k = spec.index(...)
        spec = spec[:k] + (None,) * (x.ndim - len(spec) + 1) + spec[k + 1:]
    if spec is None or len(spec) != x.ndim:
        return x
    return _to_spec(x, spec)


def _like(y, x):
    """``y`` laid out as ``x`` is, on each dim that the axes sharding it
    in ``x`` divide in ``y``; ``y`` itself where ``x`` is plain."""
    if not isinstance(x, DTensor):
        return y
    names = x.device_mesh.mesh_dim_names
    spec = [()] * x.ndim
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            spec[p.dim] += (names[m],)
    return _to_spec(y, tuple(e or None for e in spec))


def row_block(x, start: int, stop: int):
    """Rows ``[start, stop)`` of ``x``, laid out as ``x`` is.  On a
    DTensor whose rows are sharded (evenly, also in the block) and which
    is whole on its other mesh axes, device t of the n that shard the rows
    (in the order of their shards) receives the block's rows
    ``[t * m/n, (t+1) * m/n)`` from the devices that hold them, in one
    all-to-all over those axes; else the rows are gathered first."""
    if not isinstance(x, DTensor):
        return x[start:stop]
    mesh, m = x.device_mesh, stop - start
    axes = [d for d, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == 0]
    n = math.prod(mesh.size(d) for d in axes)
    if not axes or m % n or any(
            not (p.is_replicate() or d in axes)
            for d, p in enumerate(x.placements)):
        whole = x.redistribute(mesh, [Replicate() if d in axes else p
                                      for d, p in enumerate(x.placements)])
        return _like(whole[start:stop], x)
    r, q = x.shape[0] // n, m // n  # rows a device holds, and receives
    me = 0
    for d in axes:
        me = me * mesh.size(d) + mesh.get_local_rank(d)

    def overlap(src, dst):  # rows of device src's shard that dst receives
        lo = max(src * r, start + dst * q)
        return max(0, min((src + 1) * r, start + (dst + 1) * q) - lo)

    sends = [overlap(me, t) for t in range(n)]
    recvs = [overlap(s, me) for s in range(n)]
    lo = max(me * r, start) - me * r
    loc = x.to_local()[lo:lo + sum(sends)].contiguous()
    group = (mesh, axes[0]) if len(axes) == 1 else \
        mesh[tuple(mesh.mesh_dim_names[d] for d in axes)]._flatten()
    out = funcol.wait_tensor(funcol.all_to_all_single(loc, recvs, sends,
                                                      group))
    shape = (m,) + tuple(x.shape[1:])
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _to_spec(x, spec):
    mesh = x.device_mesh
    spec = tuple(None if e is None or _axis_size(mesh, e) == 1
                 else _fit(d, mesh, e) for d, e in zip(x.shape, spec))
    placements = spec_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    out = redistribute(x, placements)
    loc, src = out.to_local(), x.to_local()
    same = loc.data_ptr() == src.data_ptr() and loc.shape == src.shape
    if not same and \
            loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        # a shard cut out of a gathered tensor (gloo has no all-to-all, so
        # DTensor moves a shard between dims by an all-gather and a chunk)
        # would keep the whole gather alive: copied out.  Where only the
        # placements on axes of size 1 changed, ``loc`` is ``x``'s own
        # local tensor (a group's slice of a stacked weight), not a gather
        out = DTensor.from_local(loc.clone(), mesh, placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


def _flat_gather_axes(x, placements) -> tuple:
    """The mesh dims of a redistribution that only makes one tensor dim,
    sharded evenly over two or more mesh dims, whole on them (an FSDP
    weight on ("pod", "data")), keeping every other placement; () for
    any other redistribution."""
    moved = [m for m, (a, b) in enumerate(zip(x.placements, placements))
             if a != b]
    if len(moved) < 2 or any(type(x.placements[m]) is not Shard
                             or not placements[m].is_replicate()
                             for m in moved):
        return ()
    d = x.placements[moved[0]].dim
    sharding = [m for m, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == d]
    n = math.prod(x.device_mesh.size(m) for m in moved)
    if sharding != moved or x.shape[d] % n:
        return ()
    return tuple(moved)


def redistribute(x, placements):
    """``x.redistribute`` to ``placements`` on its mesh; a tensor dim
    sharded over several mesh dims that all become whole is gathered in
    one all-gather over their flattened group (``_FlatGather``)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    axes = _flat_gather_axes(x, placements)
    if axes:
        return _FlatGather.apply(x, axes, placements)
    return x.redistribute(x.device_mesh, placements)


# ``all_gather_tensor`` / ``reduce_scatter_tensor`` in older releases
_all_gather = getattr(funcol, "all_gather_single", None) or \
    funcol.all_gather_tensor
_reduce_scatter = getattr(funcol, "reduce_scatter_single", None) or \
    funcol.reduce_scatter_tensor


class _FlatGather(torch.autograd.Function):
    """``x`` redistributed to ``placements``, which make its dim ``d``,
    sharded over the mesh dims ``axes``, whole on them: one all-gather of
    the local shard over the flattened group of those dims, where
    DTensor gathers over each dim in turn and the last gather's operand
    is the others' product times the shard (XLA gathers once over the
    flattened group).  The backward is one reduce-scatter over the same
    group: the gradient of a gathered weight is a partial sum over the
    devices that used it, and the sum becomes their shards."""

    @staticmethod
    def forward(ctx, x, axes, placements):
        mesh = x.device_mesh
        names = tuple(mesh.mesh_dim_names[m] for m in axes)
        group = mesh[names]._flatten()
        # DTensor shards a dim over several mesh dims major to minor in
        # mesh order: device (i, j, ...) holds chunk i*n_j*... + j*... + ...,
        # which must be its rank in the flattened group, the gather's order
        me = 0
        for m in axes:
            me = me * mesh.size(m) + mesh.get_local_rank(m)
        assert group.get_local_rank() == me, (me, group.get_local_rank())
        ctx.mesh, ctx.group, ctx.axes = mesh, group, axes
        ctx.d = x.placements[axes[0]].dim
        ctx.in_pl, ctx.out_pl = tuple(x.placements), tuple(placements)
        loc = funcol.wait_tensor(_all_gather(x.to_local().contiguous(),
                                             ctx.d, group))
        return DTensor.from_local(loc, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, g):
        pl = tuple(g.placements)
        if all(pl[m] == Partial() for m in ctx.axes) and all(
                p == q for m, (p, q) in enumerate(zip(pl, ctx.out_pl))
                if m not in ctx.axes):
            loc = funcol.wait_tensor(_reduce_scatter(
                g.to_local().contiguous(), "sum", ctx.d, ctx.group))
            return DTensor.from_local(loc, ctx.mesh, ctx.in_pl,
                                      run_check=False), None, None
        return g.redistribute(ctx.mesh, ctx.in_pl), None, None


def _unviewable(old, new, counts) -> set:
    """Sharded dims of ``old`` (``counts[d]`` shards) that the reshape to
    ``new`` splits into dims whose first is not a multiple of the shard
    count, or merges into a dim after a preceding dim of size > 1."""
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
        for k in range(1, len(ins) if len(outs) == 1 else 0):
            if counts[ins[k]] > 1 and math.prod(old[e] for e in ins[:k]) > 1:
                bad.add(ins[k])
    return bad


class _GradInLayout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_in_layout(x):
    if not (isinstance(x, DTensor) and x.requires_grad
            and torch.is_grad_enabled()):
        return x
    return _GradInLayout.apply(x)


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
    bad = _unviewable(tuple(x.shape), tuple(shape), counts)
    if bad:
        x = x.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim in bad else p
            for p in x.placements])
    return grad_in_layout(x.reshape(shape))


# an ``out_dims`` split entry: the output is a partial sum over the
# split axes (each device's share comes from its slice of a contraction)
SUM = "sum"


def split_axes() -> tuple:
    """Inside ``on_shards``'s ``fn``: the mesh axes that split the
    arguments' split dims (empty on plain tensors)."""
    return getattr(_state, "split", (None, ()))[1]


def split_index() -> int:
    """Inside ``on_shards``'s ``fn``: this device's index among the
    devices that split the split dims, in the order of its slices (0 where
    nothing is split)."""
    mesh, axes = getattr(_state, "split", (None, ()))
    i = 0
    for m in axes:
        i = i * mesh.size(m) + mesh.get_local_rank(m)
    return i


def split_reduce(t, op: str):
    """Inside ``on_shards``'s ``fn``: ``t`` all-reduced with ``op`` ("max"
    or "sum") over the split axes, so each device holds the reduction over
    every device's slice; ``t`` itself where nothing is split."""
    mesh, axes = getattr(_state, "split", (None, ()))
    for m in axes:
        t = funcol.all_reduce(t, op, (mesh, m))
    return t


def on_shards(fn, args, dims, out_dims):
    """``fn(*args)`` on each device's batch rows and heads, or its rows
    and a slice of a third dim.

    ``dims[i]`` is the (batch dim, head dim) or (batch dim, head dim,
    split dim) of ``args[i]``, each None or an int; ``out_dims`` is that
    triple or pair for ``fn``'s output, or a tuple of them for several
    outputs, and a split entry ``SUM`` marks an output that is a partial
    sum over the split axes.  Plain tensors go straight to ``fn``.  On
    DTensors, each mesh axis that shards the first argument's batch dim
    shards every argument's batch dim; each axis that shards its head dim
    shards every argument's head dim, when every head count divides.
    When the arguments name split dims, the other axes of size > 1 (those
    of them that already shard an argument's split dim, where any does)
    shard every argument's split dim, the innermost of them whose product
    every split dim divides (attention's queries, where the heads do not
    divide the model axis, or a decode step's keys, as the cache holds
    them); inside ``fn``, ``split_axes``, ``split_index`` and
    ``split_reduce`` see those axes.  Every
    other axis holds whole copies.  ``fn`` runs on the local tensors and
    its outputs come back as DTensors of that layout.  An argument whole
    on an axis that shards the others gets its gradient as a partial sum
    there: each device's share comes from its own rows, heads or slice."""
    first = args[0]
    if not isinstance(first, DTensor):
        return fn(*args)
    mesh = first.device_mesh
    dims = [tuple(d) + (None,) * (3 - len(d)) for d in dims]
    b0, h0, _ = dims[0]

    def axes(d):
        return [m for m, p in enumerate(first.placements)
                if d is not None and isinstance(p, Shard) and p.dim == d]

    def size(ms):
        return math.prod(mesh.size(m) for m in ms)

    def fits(k, n):
        return not any(isinstance(a, torch.Tensor) and d[k] is not None
                       and a.shape[d[k]] % n for a, d in zip(args, dims))

    batch, heads = axes(b0), axes(h0)
    if not fits(1, size(heads)):
        heads = []
    free = [m for m in range(mesh.ndim)
            if m not in batch + heads and mesh.size(m) > 1]
    held = [m for m in free if any(
        isinstance(a, DTensor) and d[2] is not None
        and a.placements[m] == Shard(d[2]) for a, d in zip(args, dims))]
    split = held or free
    if not any(d[2] is not None for d in dims):
        split = []
    while split and not fits(2, size(split)):
        split = split[1:]

    def placements(d, whole=Replicate()):
        d = tuple(d) + (None,) * (3 - len(d))
        b, h, s = d
        out = []
        for m in range(mesh.ndim):
            if b is not None and m in batch:
                out.append(Shard(b))
            elif h is not None and m in heads:
                out.append(Shard(h))
            elif m in split and s == SUM:
                out.append(Partial())
            elif m in split and s is not None:
                out.append(Shard(s))
            elif m in batch + heads + split:
                out.append(whole)
            else:
                out.append(Replicate())
        return tuple(out)

    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            else a for a in args]
    in_pl = tuple(placements(d) if isinstance(a, DTensor) else None
                  for a, d in zip(args, dims))
    args = [redistribute(a, p) if p is not None else a
            for a, p in zip(args, in_pl)]
    grad_pl = tuple(placements(d, Partial()) if isinstance(a, DTensor)
                    else None for a, d in zip(args, dims))
    several = isinstance(out_dims[0], tuple)
    out_pl = tuple(placements(d) for d in (out_dims if several
                                           else (out_dims,)))

    def local(*xs):
        prev = getattr(_state, "split", (None, ()))
        _state.split = (mesh, tuple(split))
        try:
            return fn(*xs)
        finally:
            _state.split = prev

    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
