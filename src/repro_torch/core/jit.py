"""``jit``: the port's counterpart of ``jax.jit``.

``jax.jit`` traces a function once per argument shape and dispatches the
compiled program whole.  Here, on CUDA arguments, ``jit(fn)`` captures
``fn`` as a ``torch.cuda.CUDAGraph`` once per key and replays it:

* the key holds the static arguments (every leaf of the arguments that
  is not a tensor, and the arguments' tree structure) and the shape,
  dtype, stride and device of every tensor leaf;
* the arguments that carry weights (named ``p`` or ``params``) and the
  donated ones (``jit(fn, donate=(names...))``, the counterpart of
  ``donate_argnums``) are bound by address: their ``data_ptr``s are part
  of the key and they are never copied, so an in-place update is seen,
  and another tensor captures again, as a new ``jax.Array`` compiles
  again;
* every other tensor leaf (activations, tokens, a cache, a position, a
  batch) is copied into the graph's input buffers on each call;
* before the first capture of a key, ``fn`` runs once eagerly on a side
  stream (the lazy extension, cuBLAS handles and the like are made
  there, which no capture may do); all graphs of one ``jit`` share one
  private memory pool, and are replayed on the caller's stream one at a
  time;
* the outputs are cloned out of the pool, as ``jax.jit`` returns fresh
  arrays (callers such as the async executor hold several at once); an
  output that is a donated input comes back as the caller's tensor, not
  as a clone (a train step's params and optimizer state are updated in
  place, and a clone of them would not fit beside them);
* a key's first call with donated arguments returns the warm-up's
  outputs and does not replay: the warm-up already updated the donated
  tensors once, and a replay would update them a second time;
* ``captures``, ``replays`` and ``copies`` (input copies and output
  clones, each one launch) count what each ``jit`` did;
* while ``obs.runtime`` records, a call is a ``jit`` span around
  ``jit.key`` (flatten, bind, key), ``jit.copy_in``, ``jit.replay``
  (with the replay's device interval) and ``jit.clone_out``, and
  ``jit.capture`` for a key's first call.

DTensor leaves are taken, as ``jax.jit`` takes sharded arrays:

* a DTensor's key entry holds its local tensor's shape, dtype, stride
  and device and its own layout (device mesh, placements, global shape
  and stride); a bound one (weights, donated state) is bound by its local
  tensor's address;
* a copied DTensor's local tensor is copied into the graph's input
  buffer, which the capture sees as a DTensor of the same layout;
* a DTensor output comes back as a fresh DTensor of the same layout
  around a clone of its local tensor (a donated one as the caller's own);
* the layout in force (``shardctx.activation_sharding``'s specs) is part
  of every key: a capture records the redistributions those specs chose,
  so a call under another layout, or under none, captures again, as
  ``jax.jit`` keys its cache on the context mesh.

On CPU arguments (CPU DTensors too) ``fn`` is called directly: there is
no CUDA graph on the CPU.  On CUDA a failed capture raises; ``fn`` is
never run eagerly in its place.  The failed capture's graph and memory
pool are dropped, so the next call captures again, as ``jax.jit`` traces
again after a failed trace.  Arguments that require grad raise
``TypeError``: a train step makes its own gradient leaves inside
(``launch/steps.py``), so the capture holds the whole backward pass.
"""

from __future__ import annotations

import gc
import inspect

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.models.shardctx import layout_key
from repro_torch.obs import runtime as RT

BOUND = ("p", "params")  # the arguments bound by address


def _record(graph, pool, stream, call):
    """``call()`` captured into ``graph`` on ``stream``, its memory drawn
    from ``pool``; returns its outputs.  A capture that raises is ended,
    and what it left behind undone, before the error propagates."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the warm-up's blocks, which no graph reuses
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = call()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                _undo_capture(pool, stream)
            raise
        try:
            graph.capture_end()
        except BaseException:
            _undo_capture(pool, stream)
            raise
    return out


def _undo_capture(pool, stream):
    """Undo what a capture that could not end (a sync in it spoils it)
    leaves behind: torch's ``capture_end`` then raises before it stops
    the allocator recording into ``pool`` (the next capture into the pool
    would fail at its start), before it drops the capture's use of the
    pool, and before it takes the default CUDA generator out of its
    capture state (the card's next random draw outside a capture would
    raise).  One small capture that ends does the last."""
    device = torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(device, pool)
    except RuntimeError:  # the capture got as far as ending the recording
        pass
    torch._C._cuda_releasePool(device, pool)
    closing = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        closing.capture_begin()
        torch.zeros((1,), device=device)
        closing.capture_end()


class jit:
    """``fn``, captured as a CUDA graph once a key and replayed on CUDA
    arguments, called as it is on CPU arguments.  ``donate`` names the
    arguments that ``fn`` updates in place (see the module docstring)."""

    def __init__(self, fn, donate=()):
        self.fn = fn
        self._sig = inspect.signature(fn)
        unknown = sorted(set(donate) - set(self._sig.parameters))
        if unknown:
            raise ValueError(f"jit: donate names no argument of fn: "
                             f"{unknown}")
        self.donate = tuple(donate)
        self._bound = set(BOUND) | set(self.donate)
        self._graphs = {}
        self._pool = self._stream = None
        self.captures = self.replays = self.copies = 0

    def key(self, *args, **kwargs):
        """The capture key of a call with these arguments."""
        return self._flatten(args, kwargs)[0]

    def _flatten(self, args, kwargs):
        """(key, tensor leaf devices, the indices of the leaves that are
        copied, the indices of the donated leaves, the leaves and their
        tree); raises for a leaf that requires grad."""
        bound = self._sig.bind(*args, **kwargs)
        leaves, spec = pytree.tree_flatten(bound.arguments)
        names = [n for n, v in bound.arguments.items()
                 for _ in pytree.tree_leaves(v)]
        tensors = [i for i, x in enumerate(leaves)
                   if isinstance(x, torch.Tensor)]
        for i in tensors:
            if leaves[i].requires_grad:
                raise TypeError("jit takes no argument that requires grad")
        key = (spec, layout_key(), tuple(
            _tensor_key(x, names[i] in self._bound)
            if isinstance(x, torch.Tensor) else x
            for i, x in enumerate(leaves)))
        kinds = {leaves[i].device.type for i in tensors}
        copied = [i for i in tensors if names[i] not in self._bound]
        donated = [i for i in tensors if names[i] in self.donate]
        return key, kinds, copied, donated, leaves, spec

    def __call__(self, *args, **kwargs):
        rec = RT.recording()
        if rec is not None:
            rec.begin("jit")
            rec.step("jit.key")
        try:
            key, kinds, copied, donated, leaves, spec = self._flatten(args,
                                                                      kwargs)
            if kinds <= {"cpu"}:
                if rec is not None:
                    rec.step("jit.replay")
                return self.fn(*args, **kwargs)
            if kinds != {"cuda"}:
                raise ValueError(f"jit: arguments on {sorted(kinds)}")
            if key not in self._graphs:
                if rec is not None:
                    rec.step("jit.capture")
                self._graphs[key], first = self._capture(leaves, copied,
                                                         donated, spec)
                if donated:
                    return self._hand_back(first, _aliases(first, donated,
                                                           leaves), leaves,
                                           clone=False)
            graph, buffers, out, aliases = self._graphs[key]
            if rec is not None:
                rec.step("jit.copy_in")
            for i, buf in zip(copied, buffers):
                buf.copy_(_local(leaves[i]))
            if rec is None:
                graph.replay()
            else:
                rec.replay(graph)
            self.replays += 1
            self.copies += len(buffers)
            if rec is not None:
                rec.step("jit.clone_out")
            return self._hand_back(out, aliases, leaves, clone=True)
        finally:
            if rec is not None:
                rec.end()

    def _hand_back(self, out, aliases, leaves, clone):
        """``out`` with each output that is a donated input (``aliases``:
        output leaf -> argument leaf) replaced by the caller's tensor at
        that place and, with ``clone``, every other tensor cloned out of
        the pool (a DTensor's local tensor, in a DTensor of its layout);
        without ``clone`` (the warm-up's outputs, made on its
        side stream) the caller's stream is recorded on them, so that
        their memory is not handed out again before the caller's work on
        them is done."""
        outs, out_spec = pytree.tree_flatten(out)
        caller = torch.cuda.current_stream()
        for j, x in enumerate(outs):
            if j in aliases:
                outs[j] = leaves[aliases[j]]
            elif not isinstance(x, torch.Tensor):
                continue
            elif clone:
                outs[j] = _like(x, _local(x).clone())
                self.copies += 1
            else:
                _local(x).record_stream(caller)
        return pytree.tree_unflatten(outs, out_spec)

    def _capture(self, leaves, copied, donated, spec):
        """((graph, input buffers, the graph's outputs, their aliases of
        donated inputs), the warm-up's outputs) for a new key."""
        leaves = list(leaves)
        buffers = [_local(leaves[i]).clone() for i in copied]
        for i, buf in zip(copied, buffers):
            leaves[i] = _like(leaves[i], buf)
        args = inspect.BoundArguments(self._sig,
                                      pytree.tree_unflatten(leaves, spec))

        def call():
            return self.fn(*args.args, **args.kwargs)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = call()
        torch.cuda.current_stream().wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        # no cycle collection in the capture: a CUDA graph that it frees
        # there (held by unreachable objects) would spoil the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            out = _record(graph, self._pool, self._stream, call)
        except BaseException:
            # the next capture gets a new pool; the graphs captured before
            # keep theirs
            self._pool = self._stream = None
            raise
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return (graph, buffers, out, _aliases(out, donated, leaves)), first


def _aliases(out, donated, leaves):
    """{index of an output leaf: index of the donated argument leaf that
    it is}."""
    return {j: i for j, x in enumerate(pytree.tree_leaves(out))
            for i in donated if x is leaves[i]}


def _local(x):
    """A DTensor's local tensor; a tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def _like(x, local):
    """``local`` in ``x``'s layout: a DTensor of ``x``'s mesh, placements,
    global shape and stride around it where ``x`` is a DTensor (no
    communication: ``local`` is this device's part), else ``local``."""
    if not isinstance(x, DTensor):
        return local
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _tensor_key(x, bound):
    """A tensor leaf's part of the key: its (local) shape, dtype, stride
    and device, its address where it is ``bound``, and a DTensor's
    layout."""
    loc = _local(x)
    entry = (tuple(loc.shape), loc.dtype, loc.stride(), loc.device,
             loc.data_ptr() if bound else None)
    if isinstance(x, DTensor):
        entry += (x.device_mesh, tuple(x.placements), tuple(x.shape),
                  x.stride())
    return entry
