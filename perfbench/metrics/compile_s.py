"""compile_s: host seconds of `compile_scene` in set-up (the front end's
records to device tensors, the native BVH build, the wide BVH), with the
card synchronised at its end."""


def read(run):
    return run.spans.get("compile_s")
