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

Where the stretches replay is one rule, `graphs_for`; everywhere else an
owner gets EAGER, which has the graph sets' interface and runs each
stretch as a plain call, so the owner's loop has one form. An owner's
own precondition (the path loop's: no medium) is a plain `if` at its
call site.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core.error import warning


def graphs_for(scene, cls, lanes, key: tuple):
    """The rule for where a loop's stretches replay -> the scene's `cls`
    graph set for `key` (made at its first call) where the lanes are on
    a card, autograd would record nothing, the scene object has the
    table (CompiledScene.graphs) and the key has not fallen back; else
    EAGER."""
    table = getattr(scene, "graphs", None)
    if table is None or not lanes.is_cuda or _needs_grad(scene):
        return EAGER
    key = (cls.name,) + key
    if key not in table:
        table[key] = cls(lanes.device)
    return EAGER if table[key].failed else table[key]


def _needs_grad(scene) -> bool:
    """Whether autograd would record the stretches: grad mode is on and a
    scene tensor they read requires grad (diff.apply_params)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors((scene.geom, scene.lights, scene.volume,
                                          scene.kd_scale, scene.meas_tables)))


class Eager:
    """The stretches as plain calls, behind the graph sets' interface:
    nothing is buffered or kept, and a result is handed out as it is."""

    put = staticmethod(lambda name, x: x)
    run = keep = staticmethod(lambda name, fn: fn())
    result = staticmethod(lambda x: x)


EAGER = Eager()


class StretchGraphs:
    """The CUDA graphs of one loop's stretches, sharing one memory pool;
    a subclass names the owner (`name` prefixes its span and counters)
    and declares the constants it keeps."""

    name = ""

    def __init__(self, device):
        self.device = device
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

    def keep(self, name: str, make):
        """The attribute `name`, made by make() at the key's first call: a
        constant of the owner's that every replay reads."""
        if getattr(self, name) is None:
            setattr(self, name, make())
        return getattr(self, name)

    def result(self, x):
        """A copy of an output for the caller to keep: the next replay
        writes over x."""
        return x.clone()

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
