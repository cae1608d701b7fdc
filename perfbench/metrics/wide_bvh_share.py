"""wide_bvh_share: 100 x the host seconds of the program's
`scene/wide_bvh` span (the wide BVH's build and upload) over those of
its `scene/compile` span, in one more compile_scene of the cell's scene
with the spans on; that scene is freed afterwards."""
from perfbench.bench import spans


def read(run):
    probes = spans.program_probes()
    if probes is None:
        return None
    from pbrt_tpu_torch.scene.compile import compile_scene

    port = run.port

    def compile_once():
        scene = compile_scene(port.ro, port.device)
        port.sync()
        del scene

    _, rows = spans.with_spans(probes, compile_once)
    if port.device.type == "cuda":
        port.torch.cuda.empty_cache()
    table = probes.span_table(rows)
    total = table.get("scene/compile", (0, 0.0, 0.0))[1]
    wide = table.get("scene/wide_bvh", (0, 0.0, 0.0))[1]
    if total <= 0 or not wide:
        return None
    return 100.0 * wide / total
