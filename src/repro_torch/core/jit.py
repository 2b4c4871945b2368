"""``jit``: the port's counterpart of ``jax.jit`` on the serving path.

``jax.jit`` traces a function once per argument shape and dispatches the
compiled program whole.  Here, on CUDA arguments, ``jit(fn)`` captures
``fn`` as a ``torch.cuda.CUDAGraph`` once per key and replays it:

* the key holds the static arguments (every leaf of the arguments that
  is not a tensor, and the arguments' tree structure) and the shape,
  dtype, stride and device of every tensor leaf;
* the arguments that carry weights (named ``p`` or ``params``) are bound
  by address: their ``data_ptr``s are part of the key and they are never
  copied, so an in-place update is seen, and another tensor captures
  again, as a new ``jax.Array`` compiles again;
* every other tensor leaf (activations, tokens, a cache, a position) is
  copied into the graph's input buffers on each call;
* before the first capture of a key, ``fn`` runs once eagerly on a side
  stream (the lazy extension, cuBLAS handles and the like are made
  there, which no capture may do); all graphs of one ``jit`` share one
  private memory pool, and are replayed on the caller's stream one at a
  time;
* the outputs are cloned out of the pool, as ``jax.jit`` returns fresh
  arrays (callers such as the async executor hold several at once);
* ``captures``, ``replays`` and ``copies`` (input copies and output
  clones, each one launch) count what each ``jit`` did.

On CPU arguments ``fn`` is called directly: there is no CUDA graph on the
CPU.  On CUDA a failed capture raises; ``fn`` is never run eagerly in its
place.  DTensor arguments and arguments that require grad raise
``TypeError``: this serves one card, and training is not captured.
"""

from __future__ import annotations

import gc
import inspect

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

BOUND = ("p", "params")  # the arguments bound by address


class jit:
    """``fn``, captured as a CUDA graph once a key and replayed on CUDA
    arguments, called as it is on CPU arguments."""

    def __init__(self, fn):
        self.fn = fn
        self._sig = inspect.signature(fn)
        self._graphs = {}
        self._pool = None
        self.captures = self.replays = self.copies = 0

    def key(self, *args, **kwargs):
        """The capture key of a call with these arguments."""
        return self._flatten(args, kwargs)[0]

    def _flatten(self, args, kwargs):
        """(key, bound arguments, tensor leaf devices, the indices of the
        leaves that are copied, the leaves and their tree); raises for a
        DTensor or a leaf that requires grad."""
        bound = self._sig.bind(*args, **kwargs)
        leaves, spec = pytree.tree_flatten(bound.arguments)
        weights = [n in BOUND for n, v in bound.arguments.items()
                   for _ in pytree.tree_leaves(v)]
        tensors = [i for i, x in enumerate(leaves)
                   if isinstance(x, torch.Tensor)]
        for i in tensors:
            if isinstance(leaves[i], DTensor):
                raise TypeError("jit takes no DTensor arguments")
            if leaves[i].requires_grad:
                raise TypeError("jit takes no argument that requires grad")
        key = (spec, tuple(
            (tuple(x.shape), x.dtype, x.stride(), x.device,
             x.data_ptr() if weights[i] else None)
            if isinstance(x, torch.Tensor) else x
            for i, x in enumerate(leaves)))
        kinds = {leaves[i].device.type for i in tensors}
        copied = [i for i in tensors if not weights[i]]
        return key, bound, kinds, copied, leaves, spec

    def __call__(self, *args, **kwargs):
        key, bound, kinds, copied, leaves, spec = self._flatten(args, kwargs)
        if kinds <= {"cpu"}:
            return self.fn(*args, **kwargs)
        if kinds != {"cuda"}:
            raise ValueError(f"jit: arguments on {sorted(kinds)}")
        if key not in self._graphs:
            self._graphs[key] = self._capture(bound, leaves, copied, spec)
        graph, buffers, out = self._graphs[key]
        for i, buf in zip(copied, buffers):
            buf.copy_(leaves[i])
        graph.replay()
        self.replays += 1
        outs, out_spec = pytree.tree_flatten(out)
        outs = [x.clone() if isinstance(x, torch.Tensor) else x
                for x in outs]
        self.copies += len(buffers) + sum(isinstance(x, torch.Tensor)
                                          for x in outs)
        return pytree.tree_unflatten(outs, out_spec)

    def _capture(self, bound, leaves, copied, spec):
        leaves = list(leaves)
        buffers = [leaves[i].clone() for i in copied]
        for i, buf in zip(copied, buffers):
            leaves[i] = buf
        args = inspect.BoundArguments(self._sig,
                                      pytree.tree_unflatten(leaves, spec))

        def call():
            return self.fn(*args.args, **args.kwargs)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # no cycle collection in the capture: a CUDA graph that it frees
        # there (held by unreachable objects) would spoil the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = call()
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return graph, buffers, out
