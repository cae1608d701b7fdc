"""CUDA graphs for the stretches of a loop between its traversals.

A loop that alternates a traversal (which waits on the card or launches
kernels from Python that a wrapper must see) with long stretches of
small torch operations replays each stretch as one CUDA graph: the
path loop's shading (integrators/surface.py PathGraphs) and the photon
shoot's batch (photon/shooter.py ShootGraphs).

Each stretch reads only tensors whose addresses stay put: the static
buffers of `put`, which each call refills with one copy_ a field, the
constants its owner keeps, and the outputs of the stretches before it.
Its first call runs it eagerly under torch's sync debug mode "error",
so that a stretch that waits on the card or copies a host number to it
never reaches a capture (where that raises, once more after an ordinary
run: the first use of a device constant copies it from the host),
captures it and replays it; later calls replay it and return the same
output tensors, refilled. The graphs replay in the order they were
captured, and every output stays referenced here, so no later capture
in the shared pool writes over an output another stretch still reads.
A warm-up or capture that raises leaves the owner eager for good
(counted in `<name>/graph_fallbacks`); each replay is a `<name>/graph`
span and each capture counts in `<name>/graph_captures`.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core.error import warning


class StretchGraphs:
    """The CUDA graphs of one loop's stretches, sharing one memory pool;
    `name` prefixes its span and counters ("path", "photon")."""

    def __init__(self, device, name: str):
        self.device = device
        self.name = name
        self.pool = None       # made at the first capture
        self.stream = None
        self.graphs = {}       # stretch name -> (CUDAGraph, outputs)
        self.bufs = {}         # static buffers by name
        self.failed = False

    def put(self, name: str, x):
        """Copies a tensor, or a NamedTuple of them, into the static
        buffers `name` (made at its first use, outside every capture)."""
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            buf = self.bufs.get(name)
            if buf is None:
                buf = self.bufs[name] = torch.empty_like(x, memory_format=torch.contiguous_format)
            buf.copy_(x)
            return buf
        return type(x)(*(self.put(f"{name}.{f}", v) for f, v in zip(x._fields, x)))

    def run(self, name, fn):
        """fn() of a stretch: replayed from its graph, captured at its
        first call; eagerly once the owner has fallen back."""
        if self.failed:
            return fn()
        if name not in self.graphs:
            try:
                self.graphs[name] = self._capture(fn)
            except Exception as e:    # the stretch cannot be captured: eager for good
                self.failed = True
                self.graphs.clear()
                probes.count(f"{self.name}/graph_fallbacks")
                warning(f"{self.name} graphs: stretch {name} stays eager "
                        f"({type(e).__name__}: {e})")
                return fn()
            probes.count(f"{self.name}/graph_captures")
        graph, out = self.graphs[name]
        with probes.scope(f"{self.name}/graph"):
            graph.replay()
        return out

    def _capture(self, fn):
        try:
            out = without_syncs(fn)
        except RuntimeError:
            fn()    # an ordinary run fills the lazy caches of device constants
            out = without_syncs(fn)
        if any(t.requires_grad for t in tensors(out)):
            raise RuntimeError("an output needs autograd, which a replay does not record")
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device=self.device)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        current.wait_stream(self.stream)
        return graph, out


def without_syncs(fn):
    """fn() under torch's sync debug mode "error": a call that waits on
    the card or copies a host number to it raises instead."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def tensors(x):
    """The tensors of a (nested) tuple of tensors and None."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in tensors(v)]
    return []
