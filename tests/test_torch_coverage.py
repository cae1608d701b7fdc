"""The port does all that the JAX package does, name for name.

Walks both packages' sources with `ast` (neither package is imported)
and holds every top-level function and class of each module of
pbrt_tpu/, and every method of those classes, against the module of the
same path in pbrt_tpu_torch/. A name without a counterpart there fails
the test unless it is on one of the lists below, each entry with its
counterpart or its reason; an entry that is no longer needed, or whose
counterpart is gone, fails too.
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "pbrt_tpu")
PORT_ROOT = os.path.join(REPO, "pbrt_tpu_torch")

# Modules whose port lives at another path; their names are looked up there.
MOVED = {
    # K1: the Pallas kernel became csrc/intersect.cu behind this wrapper
    "ops/intersect_pallas.py": "ops/intersect_cuda.py",
    # K2: the Pallas sweep became csrc/bvh_sweep.cu behind this wrapper
    "ops/bvh_pallas.py": "ops/bvh_cuda.py",
    # the C++ builder's loader: the port compiles its copy,
    # csrc/bvh_builder.cpp, from accel/bvh.py
    "native/__init__.py": "accel/bvh.py",
}

# (module, name) -> the counterpart's name in the port's module.
RENAMED = {
    ("accel/bvh.py", "_prim_bounds"): "prim_bounds",
    ("accel/intersect.py", "_tri_t"): "mt_t",
    ("accel/intersect.py", "_quad_candidates"): "quad_candidates",
    ("accel/intersect.py", "_quad_t_pass"): "quad_t_pass",
    ("accel/intersect.py", "_quad_detail"): "quad_detail",
    # the port reconstructs from the packed rows only, under the public name
    ("accel/intersect.py", "_reconstruct_packed"): "reconstruct",
    # the unpacked reconstruct's frame; the packed one's is componentwise
    ("accel/intersect.py", "_coord_sys"): "_coord_sys_c",
    ("photon/map.py", "_candidate_count"): "candidate_count",
    ("photon/map.py", "_default_cap"): "default_cap",
    ("photon/map.py", "_topk_phase"): "topk_phase",
    ("photon/shooter.py", "_compute_radiance_map"): "compute_radiance_map",
    ("photon/shooter.py", "_shoot_batch_fn"): "shoot_batch_fn",
    ("renderers/driver.py", "_first_hit_t"): "first_hit_t",
    # K1's body and its pallas_call: k1_sweep_kernel, launched by this wrapper
    ("ops/intersect_pallas.py", "_tri_kernel"): "tri_t_pass_cuda",
    ("ops/intersect_pallas.py", "_tri_t_pass"): "tri_t_pass_cuda",
    ("ops/intersect_pallas.py", "tri_t_pass_pallas"): "tri_t_pass",
    # K2's body and its pallas_call: k2_sweep_kernel, launched by this wrapper
    ("ops/bvh_pallas.py", "_make_sweep_kernel"): "wide_sweep_cuda",
    ("ops/bvh_pallas.py", "_sweep_pairs"): "wide_sweep",
    ("native/__init__.py", "load_native"): "_load_native",
    ("native/__init__.py", "native_build_bvh"): "_native_build",
}

# (module, name) -> why the port has no counterpart (JAX-only machinery,
# or a one-line helper the port writes inline).
NOT_PORTED = {
    ("ops/intersect_pallas.py", "pallas_available"):
        "the port picks a kernel or its plain twin by the tensor's device",
    ("native/__init__.py", "_build_dir"):
        "the port builds into pbrt_tpu_torch/_build/ (accel/bvh.py _BUILD_ROOT)",
    ("native/__init__.py", "_cache_dir"):
        "the port builds into pbrt_tpu_torch/_build/ (accel/bvh.py _BUILD_ROOT)",
    ("parallel/mesh.py", "make_mesh"):
        "a jax.sharding mesh; a torch.distributed process group replaces it "
        "(mesh_from_options)",
    ("parallel/mesh.py", "batch_sharding"):
        "a jax.sharding spec; each rank takes its slice (shard_batch)",
    ("parallel/mesh.py", "replicate"):
        "a jax.sharding spec; ranks all-gather what they share (gather_replicated)",
    ("photon/map.py", "_block_map"):
        "the TPU's memory shaping of kNN query blocks; the port sizes its blocks "
        "from free card memory (query_block)",
    ("photon/map.py", "_pack4"):
        "the TPU's [4, P] lane layout; the port keeps [P, 3] rows",
    ("accel/intersect.py", "_round_up"):
        "the block scan's padding; the port's t_pass_brute steps over the "
        "triangles unpadded",
    ("materials/bsdf.py", "_cos_theta"): "inlined as w[..., 2]",
    ("materials/bsdf.py", "_oren_nayar_terms"): "inlined in _diffuse_f",
    ("lights/lighting.py", "_gather"): "inlined as tensor indexing",
    ("core/probes.py", "start_trace"):
        "a profiler exporter nothing ran; the port's spans (scope, spans) and the "
        "benchmark's own profiler passes replace it",
    ("core/probes.py", "stop_trace"):
        "a profiler exporter nothing ran; the port's spans (scope, spans) and the "
        "benchmark's own profiler passes replace it",
}


def names(path):
    """Top-level def/class names of a module and Class.method names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return out


def jax_modules():
    found = []
    for root, dirs, files in os.walk(JAX_ROOT):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        found += [os.path.relpath(os.path.join(root, f), JAX_ROOT).replace(os.sep, "/")
                  for f in sorted(files) if f.endswith(".py")]
    return found


MODULES = jax_modules()


def port_names(rel):
    path = os.path.join(PORT_ROOT, MOVED.get(rel, rel))
    return names(path) if os.path.exists(path) else None


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_its_counterpart(rel):
    """Every name of the JAX module has a counterpart at the same path in
    the port (or at its MOVED path), under its own name or its RENAMED
    one, or a reason in NOT_PORTED."""
    got = port_names(rel)
    assert got is not None, f"pbrt_tpu_torch/{MOVED.get(rel, rel)} does not exist"
    missing = []
    for name in sorted(names(os.path.join(JAX_ROOT, rel))):
        if name in got or (rel, name) in NOT_PORTED:
            continue
        target = RENAMED.get((rel, name))
        if target is None or target not in got:
            missing.append(name if target is None else f"{name} -> {target}")
    assert not missing, f"pbrt_tpu/{rel}: no counterpart in the port for {missing}"


def test_allowance_lists_are_current():
    """Every listed name exists in the JAX package and is still missing
    from the port under its own name; every rename's target exists and
    every reason is given."""
    jax_names = {rel: names(os.path.join(JAX_ROOT, rel)) for rel in MODULES}
    for rel in MOVED:
        assert rel in jax_names and port_names(rel) is not None, rel
    for (rel, name), why in list(RENAMED.items()) + list(NOT_PORTED.items()):
        assert name in jax_names.get(rel, ()), f"{rel}:{name} is not in pbrt_tpu/"
        assert name not in port_names(rel), f"{rel}:{name} is ported: drop its entry"
        assert why, f"{rel}:{name} names no counterpart or reason"
    for (rel, name), target in RENAMED.items():
        assert target in port_names(rel), f"{rel}:{name} -> {target} is not in the port"
    assert not set(RENAMED) & set(NOT_PORTED)
