"""Where a run of chip_smoke.py spends its time.

    python3 chip_smoke_timing.py [chip_smoke.py's arguments]

Runs chip_smoke.py's main() in this process (on the card, as chip_smoke.py
runs) with every top-level function of the script, the wavefront entry
points and ``subprocess.run`` wrapped by an inclusive timer, then prints
one more JSON line: ``{"timing": {"total_s": ..., "by_fn": [[name, calls,
seconds], ...]}}``, the 90 largest, nested calls counted in their callers
too.  chip_smoke.py's own output is unchanged above it.
"""

import collections
import functools
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.argv = ["chip_smoke.py"] + sys.argv[1:]
import chip_smoke as cs  # noqa: E402

acc = collections.defaultdict(lambda: [0, 0.0])


def timed(name, fn):
    @functools.wraps(fn)
    def call(*a, **kw):
        t0 = time.time()
        try:
            return fn(*a, **kw)
        finally:
            acc[name][0] += 1
            acc[name][1] += time.time() - t0
    return call


for name, fn in list(vars(cs).items()):
    if isinstance(fn, types.FunctionType) and fn.__module__ == cs.__name__ \
            and name not in ("main", "emit", "sync"):
        setattr(cs, name, timed(name, fn))
for mod, names in ((cs.wavefront, ("render_wavefront_counts",
                                   "render_wavefront", "wavefront_accum")),
                   (cs.subprocess, ("run",))):
    for n in names:
        setattr(mod, n, timed(mod.__name__ + "." + n, getattr(mod, n)))

t0 = time.time()
try:
    cs.main()
finally:
    rows = sorted(acc.items(), key=lambda kv: -kv[1][1])
    print(json.dumps({"timing": {
        "total_s": round(time.time() - t0, 1),
        "by_fn": [[k, v[0], round(v[1], 2)] for k, v in rows[:90]]}}),
        flush=True)
