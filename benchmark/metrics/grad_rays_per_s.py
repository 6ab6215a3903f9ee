"""grad_rays_per_s: the forward's closest-hit segments and counted shadow
rays of every gradient step completed in the window, over the window's
time (forward, backward and the SGD step)."""


def read(run):
    return sum(r["rays"] for r in run.records) / run.window_s
