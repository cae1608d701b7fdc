"""setup_s: seconds from the process's start to the first timed frame:
imports, the kernels' load (their build on a cold cache), the scene's
build and compile, the warm-up."""


def read(window):
    return window.setup_s
