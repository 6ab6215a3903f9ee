"""bvh_build_s: the set-up's BVH build (the host SAH cluster build, or the
autotune's three builds and probe runs), a span around it."""


def read(run):
    return run.spans.get("bvh_build_s")
