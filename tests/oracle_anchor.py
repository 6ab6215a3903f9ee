"""Hardware-free anchor for chip_smoke.py's ``render_oracle`` phase.

Renders ``cornell("spheres")`` with the JAX package's oracle renderer
(``tpu_pt.render.driver.render``, backend ``"brute"``) on the CPU at the
command line's defaults and prints the image's mean radiance:

    JAX_PLATFORMS=cpu python tests/oracle_anchor.py [size [spp [depth [seed]]]]

The value printed for ``512 16 4 0`` is the constant ``ORACLE_ANCHOR`` in
chip_smoke.py.  Not a test: pytest does not collect this file.
"""

import json
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

from tpu_pt.config import RenderConfig  # noqa: E402
from tpu_pt.render.driver import render  # noqa: E402
from tpu_pt.scene import cornell  # noqa: E402


def main(argv):
    defaults = [512, 16, 4, 0]
    size, spp, depth, seed = [int(a) for a in argv] + defaults[len(argv):]
    scene = cornell.cornell("spheres")
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=depth)
    t0 = time.time()
    img = render(scene, cornell.camera(size, size), cfg, jax.random.key(seed),
                 backend="brute")
    print(json.dumps({
        "scene": "cornell-spheres", "backend": "brute", "size": size,
        "spp": spp, "max_depth": depth, "seed": seed,
        "mean_radiance": float(np.mean(img, dtype=np.float64)),
        "finite": bool(np.isfinite(img).all()),
        "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main(sys.argv[1:])
