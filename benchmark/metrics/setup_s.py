"""setup_s: process start to the first timed call (imports, the scene, the
BVH build or autotune, the exact fallback's build, the warm-up call)."""


def read(run):
    return run.setup_s
