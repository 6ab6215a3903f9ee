"""rays_per_s: the useful rays (closest-hit segments and counted shadow
rays, as the renderer counts them on the device) of every image completed
in the window, over the window's time."""


def read(run):
    return sum(r["rays"] for r in run.records) / run.window_s
