"""Fixed sequences of small ops replayed as CUDA graphs.

Some loops of the port repeat one fixed sequence of small ops on tensors
of fixed shapes: a Kogbetliantz sweep (N(N−1)/2 pair steps), a run of
classic Jacobi rotations, block Jacobi's inner sweep. The JAX package
compiles each into one XLA loop; run eagerly, each op costs the host's
dispatch (tens of microseconds) for a kernel of a few microseconds on the
card. :func:`run` captures such a body into a CUDA graph the second time
it meets the body's key and shapes (the first run, eager, loads its
kernels) and replays the graph after, so a body costs one launch. On the
CPU it just calls the body.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

__all__ = ["run"]

# the graphs kept, least recently used first, and the keys met once
_GRAPHS: OrderedDict = OrderedDict()
_SEEN: set = set()
_KEEP = 16


def run(name, body, *args):
    """``body(*args)``: a tuple of tensors computed from tensors ``args``
    by ops that neither read a value on the host nor write into ``args``.

    For CUDA tensors the body runs eagerly the first time its (``name``,
    shapes, dtypes, device) is met, and from the second time as a CUDA
    graph: ``args`` are copied into the graph's own inputs and its
    outputs are returned. Those outputs are the graph's buffers, which its
    next replay overwrites: clone what must outlive it."""
    if not args[0].is_cuda:
        return body(*args)
    key = (name,) + tuple((tuple(a.shape), a.dtype, str(a.device))
                          for a in args)
    entry = _GRAPHS.get(key)
    if entry is None:
        if key not in _SEEN:
            if len(_SEEN) >= _KEEP * 16:
                _SEEN.clear()
            _SEEN.add(key)
            return body(*args)
        _SEEN.discard(key)
        inputs = [a.clone() for a in args]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = body(*inputs)
        entry = _GRAPHS[key] = (graph, inputs, outputs)
        if len(_GRAPHS) > _KEEP:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(key)
    graph, inputs, outputs = entry
    for dst, src in zip(inputs, args):
        dst.copy_(src)
    graph.replay()
    return outputs
