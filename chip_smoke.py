#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_pt_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # all phases, one card
    python3 chip_smoke.py --profile   # plus torch.profiler windows of the
                                      # steady-state loop for each form of
                                      # the pair stage (device busy share,
                                      # device time of the port's kernels)
                                      # and the fused kernel's launches in
                                      # the loop matched to their operands
    python3 chip_smoke.py --paired 10 # instead of the phases: the headline
                                      # render through the fused and the
                                      # split pair stage, ten times each in
                                      # turns (run_s medians and ratio)
    python3 chip_smoke.py --determinism  # instead of the phases: only the
                                         # spp 4 render twice, held bitwise
    python3 chip_smoke.py --dist      # instead of the phases: only the
                                      # dist phase (after the headline render
                                      # and the grad cell's hint it needs)
    python3 chip_smoke.py --walks     # instead of the phases: the A/B
                                      # mode: the times of both walks (both
                                      # designs), of the pair kernels and
                                      # of the dense kernels (copied into
                                      # another checkout of the port it
                                      # times that tree's kernels; with
                                      # --paired N, then the headline too)
    python3 chip_smoke.py --modes     # instead of the phases: traverse,
                                      # determinism, kernels_modes,
                                      # render_main and render_modes (with
                                      # the "split" twin of "frontier" and
                                      # the sliced headline; with --profile
                                      # also "frontier"'s steps profiled in
                                      # both pair stages, with --paired N
                                      # its headline in both stages, N each
                                      # in turns)

Builds the native SAH builder and the CUDA kernel library from the sources
in this checkout (the headline scene's BVHs must come from the native
builder; the Python SAH builder and its packing are timed on the Cornell
scenes), holds every kernel against its plain PyTorch version on
the card, checks the cluster traversal (every form of its pair stage,
every traversal mode) against the brute-force oracle, and drives these
paths at full width:

- ``render_main``: the 1.3M-triangle scene through the wavefront renderer
  and the cluster BVH (1024x1024, spp 1, depth 4, queue 4096) with the
  one-kernel pair stage (``pair_stage="fused"``, the default), after the
  same scene rendered small with the fused kernel, the split stage's
  kernels and plain versions; twice (``run_s`` the faster), then the
  band;
- the headline's band (``BAND_ROWS``: rows 384-639, a quarter of its
  pixels, each as in the full render; ``render_main`` renders it once
  more, its rows bit for bit, as the reference of the band's counts and
  ``run_s``): the main path's twins render the band at full width (queue
  4096), not the whole image;
- ``render_split``: the band through the two-kernel pair stage
  (``pair_stage="split"``); its rows must equal ``render_main``'s bit for
  bit, and the two band ``run_s`` are printed side by side;
- ``render_modes``: the same render through the cluster BVH's two other
  traversal modes (``ClusterBVH.traversal_mode`` "frontier": per-ray sorted
  frontiers and best-t feedback rounds; "pairs": the pair-major walk),
  whose pair batches all go through ``pair_ray_reduce`` (the frontier
  walk's round 1 as gapped segments); "frontier" must give ``render_main``'s
  image bit for bit, "pairs" (which cuts the headline at its default
  budgets, as the JAX package's walk does) its recorded cut, counts and
  mean exactly; with ``--modes`` "frontier" once more through the "split"
  twin (``pair_tile_isect`` and array code: the same bits and rounds) and
  the compact render with every step as two lane slices
  (``step_slices=2``), timed, bit for bit ``render_main``'s; then the
  pair-major walk's capacity (``pairs_stats``, ``candidate_stats``) on a
  camera and a mixed batch of 4,096 rays;
- ``render_oracle``: the unrolled oracle renderer through the dense-sweep
  backend (``backend="pallas"``) and through the flat SAH BVH walk
  (``backend="bvh"``, the kernel ``flat_walk``) at the command line's
  defaults (512x512, spp 16, depth 4) on two Cornell scenes, after small
  renders held against the brute backend, the plain versions and the
  wavefront renderer (through ``"bvh"``, its default backend, it must
  have launched the row walk);
- ``render_autotune``: the capacity autotuner (``cluster.
  autotune_for_render``, the wavefront probe) at ``render_exact``'s 256²
  cell, whose tuned image (after the command line's verify-then-retry
  where it still overflows) must be ``render_exact``'s fallback render bit
  for bit, and at the headline as the command line's ``--autotune`` runs
  it (probed at 512²), with one render of the band on the tuned BVH
  beside ``render_main``'s;
- ``render_dedup``: the band through the cluster-major pair stage
  (``pair_stage="dedup"``);
- exact repair of capacity overflow: ``render_exact`` takes the 256² render
  of the same scene, where the default capacities overflow, through the
  command line's flow (a render that flags suspect pixels, the packed
  fallback attached with ``cluster.attach_fallback``, the same render on
  it, the repair of only the suspect pixels, and the render on the packed
  walk alone), and ``render_fallback`` renders the band with the fallback
  attached: the walk kernel (``packed_walk``) is launched on every
  traversal sub-batch, and the rows must equal ``render_main``'s bit for
  bit;
- the device builds: ``build_device`` builds big-1m's LBVH
  (``lbvh.build_lbvh``) and its Morton-chunk cluster BVH
  (``cluster.build_cluster_device``) on the card, times them beside the
  host builds, checks their invariants and holds each equal, array by
  array, to the same build on the CPU; ``render_lbvh`` renders the
  band through the packed walk on the LBVH (counts and mean beside
  ``render_main``'s band render's; the 256² cell against ``render_exact``'s packed
  render; both walk designs bitwise against the plain walk on a camera and
  a bounce batch, timed beside the SAH packed BVH); ``render_device``
  renders the band through the fused pair stage on the device cluster
  build (``render_main``'s rows at overflow 0, else the whole headline in
  the command line's flow, repaired, held to its image); ``render_atrium`` renders the atrium
  (``meshes.atrium_scene``, two area lights) at 256² on the autotuned BVH
  and on the device cluster build, each repaired where it overflows, and
  holds the two images to each other;
- ``cli``: the command line (``tpu_pt_torch.cli.main``, in-process, its
  launches counted): the headline through ``render big-1m`` (the PNG byte
  for byte ``render_main``'s image), the repair flow at 256² (the PNG
  ``render_exact``'s repaired image), ``--checkpoint`` (stopped at the
  first overflowing chunk, resumed on the fallback; bitwise the
  progressive render, and an interrupted run resumed the same bits),
  big-1m loaded from a COLLADA file and lit by an EXR sky (``-e``),
  ``--backend bvh`` / ``wavefront``, ``visualize-bvh``, ``dump-bvh``, and
  the sanitizer (``render_wavefront_checked``) on the 256² cell;
- ``determinism``: the same scene at 128², spp 4, rendered twice; the two
  images must be the same bits (several samples of a pixel are in flight in
  one step, and the accumulate adds them in one fixed order), and once more
  with whole-step lane slicing (``wavefront_accum(step_slices=2)``): the same
  bits and counts;
- ``dist``: the distribution layer (``tpu_pt_torch.dist.sharding``): one
  NCCL rank in this process runs ``loss_and_grad_sharded`` on the grad
  cell against ``loss_and_grad_wavefront`` (the gradient all-reduced chunk
  by chunk during backward) and ``dryrun_multichip(1)``; two gloo ranks on
  the one card (two processes of this script, ``--dist-child``) render the
  headline interleaved (``render_main``'s image bit for bit, the shards'
  counts summing to the port's record), take the grad cell's step (both
  ranks equal, and equal to the one rank's) and render 256² interleaved
  and contiguous (the same bits);
- the differentiable path: ``render_grad`` takes gradients of an L2 image
  loss through the differentiable wavefront loop at the JAX package's grad
  cell (256², target zeros), times forward and backward apart, and holds
  that no kernel is launched in backward, that an albedo gradient matches
  a central difference, that the same step with the exact fallback
  attached renders ``render_exact``'s fallback image, and, on two small
  scenes, that kernels and plain versions give the same loss and gradients
  bit for bit; every step past 16 steps recomputes its √steps chunks in
  backward (``remat``, ``chunks``, the device memory the step adds), and
  the grad cell's step once more as the twin without recomputation
  (``remat=False``: the same gradients, its memory beside);
- ``grad_headline``: the headline as a gradient step (the JAX package's
  ``BENCH_GRAD=1 BENCH_SIZE=1024``: 1024², spp 1, target zeros, the hint
  from ``render_main``'s steps), once recomputing and once as the twin:
  forward and backward seconds, the memory each step adds, no kernel in
  backward, the pair kernel 8 times a step in forward, gradients equal,
  and the forward image ``render_main``'s bit for bit where nothing
  overflowed.

The descent of every cluster traversal above fetches its children's box
fields through the kernel ``fetch_fields`` (``csrc/fetch_rows.cu``), so
every render launches it, and never its twin ``fetch_rows`` (the row form,
``_descend_compact(fetch="rows")``); the exact fallback's walk runs the
window design of ``packed_walk`` (``csrc/packed_walk.cu``), never its twin
(``design="thread"``); the oracle's ``"bvh"`` renders run the row design of
``flat_walk`` (``csrc/flat_walk.cu``), never its twin (``design="thread"``).
The kernels phase holds each redesign bitwise against its plain version
and against its twin and times the two inside this call, and holds both
designs of both walks to the port's brute force, bit for bit, on 20,000
rays aimed up at the reduced atrium's coplanar beam faces (``--walks``
also renders the Cornell mesh and spheres once through each design of the
flat walk, under the profiler, and sums the durations and the bounds of
each render's 320 walks).  ``fetch_probes`` runs the three ported fetch probes
(``tpu_pt_torch/tools/microbench_*``: ``fetch_rows``, ``fetch_rows_t``,
``take_along``) at the JAX tools' full shapes and at the real descent.

It prints one JSON object per phase (``done``: the total and each phase's
seconds, ``phase_s``).  Any failed phase raises and the process exits
non-zero.  Without a CUDA device it exits with code 2 before
printing any result.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is ``{"kernels": [...]}`` with, per kernel, its launches
on the full-width path that runs it, its error against the plain version,
its time, the plain version's time and its roofline bound.  ``ms`` is the
median of single launches between CUDA events; for the pair kernels, which
run a few microseconds, ``trace_us`` is the kernel's own duration in a
profiler trace of the same launches (``trace_warm_us``: without the cache
flush between them; ``trace_n`` and ``trace_warm_n``: the kernel records
the two medians rest on), and ``launch_floor_us`` what either method reports
for a kernel that does nothing.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import functools
import io
import json
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py needs a CUDA device; none is available\n")
    sys.exit(2)

from tpu_pt_torch import cli as port_cli  # noqa: E402
from tpu_pt_torch.bvh import cluster, flat, lbvh, native, packed, sah  # noqa: E402
from tpu_pt_torch.config import RenderConfig  # noqa: E402
from tpu_pt_torch.core.camera import Camera, generate_rays, pixel_xy  # noqa: E402
from tpu_pt_torch.core.intersect import INF  # noqa: E402
from tpu_pt_torch.kernels import _build  # noqa: E402
from tpu_pt_torch.kernels.cluster_isect import (  # noqa: E402
    DEDUP_WARPS_PER_BLOCK, check_pair_out, dedup_grid_blocks, pair_tile_isect,
    pair_tile_isect_dedup, pair_tile_isect_dedup_ref, pair_tile_isect_ref)
from tpu_pt_torch.kernels.intersect import (  # noqa: E402
    PallasScene, anyhit_ref, closest_ref, dense_anyhit, dense_closest)
from tpu_pt_torch.kernels import pair_fused  # noqa: E402
from tpu_pt_torch.kernels.pair_fused import (  # noqa: E402
    pair_ray_reduce, pair_ray_reduce_checked, pair_ray_reduce_ref)
from tpu_pt_torch.kernels.pair_scan import pair_segmin, pair_segmin_ref  # noqa: E402
from tpu_pt_torch.kernels.packed_walk import (  # noqa: E402
    DESIGNS as WALK_DESIGNS, packed_walk, packed_walk_ref)
from tpu_pt_torch.kernels.flat_walk import (  # noqa: E402
    DESIGNS as FLAT_DESIGNS, flat_walk, flat_walk_counts, flat_walk_ref,
    rows_kernel_attrs)
from tpu_pt_torch.kernels.fetch import (  # noqa: E402
    fetch_fields, fetch_fields_ref, fetch_rows, fetch_rows_ref, fetch_rows_t,
    fetch_rows_t_ref)
from tpu_pt_torch.kernels.take_along import (  # noqa: E402
    take_along, take_along_form, take_along_ref)
from tpu_pt_torch.render import brute, film, integrator, wavefront  # noqa: E402
from tpu_pt_torch.render.envmap import gradient_sky, load_envmap  # noqa: E402
from tpu_pt_torch.render.progressive import render_progressive  # noqa: E402
from tpu_pt_torch.render.driver import (  # noqa: E402
    _intersectors, _intersectors_counted, _render_chunks, render)
from tpu_pt_torch.scene import collada, cornell, exr, meshes, obj  # noqa: E402
from tpu_pt_torch.scene.types import (  # noqa: E402
    LIGHT_AREA, MAT_DIFFUSE, make_lights, make_materials, make_scene)
from tpu_pt_torch.tools import _probe as probe  # noqa: E402
from tpu_pt_torch.tools import flat_chains  # noqa: E402
from tpu_pt_torch.tools import microbench_dyngather as dyngather_tool  # noqa: E402
from tpu_pt_torch.tools import microbench_fetch_kernel as fetch_tool  # noqa: E402
from tpu_pt_torch.tools import microbench_vmem_gather as vmem_tool  # noqa: E402

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
N_SM, FP32_LANES_PER_SM = 132, 128   # H100 SXM

# FP32 operations per (ray, primitive row) test, counted from
# csrc/pair_isect_common.cuh::prim_test (each add, subtract, multiply,
# divide, square root, compare and abs as one): a triangle or padding row
# costs 54 (edge products 9, det 5, parallel test 2, 1 / det 1, tvec 3,
# u 6, qvec 9, v 6, t 6, type test 1, six range tests); a sphere row 47
# more for its solve (sphere_hit: r^2 1, a 5, b 5, 1 / a 1, b / a 1, l 6,
# |l|^2 5, disc 2, the test disc > 0 1, c 6, sqrt 1, q 3, the roots 2,
# their order 1, q != 0 1, four range tests, two ANDs).  A ray with
# disc <= 0 leaves after 27 of them; the sphere rows are a handful (the placeholder, or the
# Cornell spheres' two), so all are counted at 47.  The closest-hit sweep
# adds 3 (the shrinking range and the strict compare), the any-hit sweep 1.
OPS_TRI_ROW, OPS_SPH_ROW = 54, 101
OPS_CLOSEST, OPS_ANYHIT = 3, 1
# FP32 operations of csrc/packed_walk.cu, counted the same way: a node step
# costs 38 (six subtracts and six multiplies of the slab test, six
# NaN-keeping min / max of two compares each, six NaN maps, three max and
# three min over the axes, the box test, the leaf test); a row tested costs
# OPS_TRI_ROW or OPS_SPH_ROW plus OPS_CLOSEST (t <, t ==, gid <, in both
# forms); a ray 6 (three reciprocals, three sign tests for its octant).
OPS_NODE, OPS_WALK_RAY = 38, 6
# csrc/flat_walk.cu: a node step as OPS_NODE (its leaf test is count > 0);
# a ray 3 (its reciprocals).  The thread walk's triangle tested costs
# OPS_TRI_ROW, 6 for its two edges and 4 for the take-over test (t <, t ==,
# t < 1e30, id <), a sphere OPS_SPH_ROW + 4.  The row walk reads the edges
# made (the primitive rows), so its triangle costs OPS_TRI_ROW + 4.
OPS_FLAT_TRI, OPS_FLAT_SPH, OPS_FLAT_RAY = OPS_TRI_ROW + 10, OPS_SPH_ROW + 4, 3
OPS_ROWS_TRI, OPS_ROWS_SPH = OPS_TRI_ROW + 4, OPS_SPH_ROW + 4

# mean_radiance of cornell("spheres") at 512x512, spp 16, depth 4, key 0,
# backend "brute", rendered by the JAX package's oracle renderer on a CPU:
# what `JAX_PLATFORMS=cpu python tests/oracle_anchor.py 512 16 4 0` prints.
ORACLE_ANCHOR = 0.4897062356149342

# Accounting of the same render recorded by the JAX package's benchmark run
# (hardware-free fields of BENCH_r05.json).
# Wavefront steps run before the mixed-depth batch the kernels are timed on
# is taken: by then the camera sweep has reached the displaced sphere.
N_WARM = 150

RECORDED = dict(n_closest=1876297, n_shadow=910236, steps_run=459,
                overflow=0, mean_radiance=0.21129)
# The same render by this port, in every earlier smoke run of it on an H100:
# the image rests on exact selections (bitwise kernels, an exact fetch), so
# these are held exactly.
PORT_RECORD = dict(n_closest=1877097, n_shadow=911322, steps_run=459,
                   overflow=0, mean_radiance=0.211140438914299)
# The headline in the pair-major walk at the BVH's own budgets, which cut
# it as the JAX package's walk does: the figures its K2 stage printed in
# render_modes, held exactly in the fused stage (both select the same
# (t, lowest gid) from the same tile test).
PAIRS_RECORD = dict(overflow=281374, n_closest=1858624, n_shadow=890492,
                    steps_run=454, mean_radiance=0.20668214559555054)
# Pair-kernel launches of one headline render in each of the two modes: a
# launch a pair batch (the frontier walk's round 1 and each feedback round;
# the pair-major walk's one list a traversal), as K2 ran them.
MODE_LAUNCHES = {"frontier": 1855, "pairs": 908}


def emit(obj):
    print(json.dumps(obj), flush=True)


def sync():
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# Phase 1 — device
# --------------------------------------------------------------------------

def nvidia_smi(query, *fmt):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader") + fmt)],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device():
    """Returns nvidia-smi's name and power limit, and the card's non-fused
    FP32 rate: SMs x FP32 lanes x the maximum SM clock.  The kernel library
    is compiled with -fmad=false, so one lane retires one operation (not
    one fused multiply-add) a clock: this, and not the data sheet's FMA
    figure of twice as much, is the ceiling of its arithmetic."""
    smi = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm", "nounits"))
    fp32_ops_per_s = N_SM * FP32_LANES_PER_SM * sm_mhz * 1e6
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "clocks_max_sm_MHz": sm_mhz,
          "fp32_nonfused_ops_per_s": fp32_ops_per_s})
    return smi, fp32_ops_per_s


# --------------------------------------------------------------------------
# Phase 2 — build
# --------------------------------------------------------------------------

def built_by(fn):
    """(fn(), the builder that built it): "native", or "python_sah" where
    the build emitted a ``native.BuilderFallbackWarning`` (the native
    library could not be built or loaded).  Other warnings pass on."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    fell = False
    for w in rec:
        if issubclass(w.category, native.BuilderFallbackWarning):
            fell = True
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    return out, "python_sah" if fell else "native"


def build_libraries():
    """The native SAH builder's library and the kernel library (nvcc, one
    process a source), built from this checkout and loaded: (the native
    library or None, its seconds, the kernels' seconds)."""
    t0 = time.time()
    lib = native._load()
    t_bvh = time.time() - t0
    t0 = time.time()
    _build.load(verbose_ptxas=True)
    return lib, t_bvh, time.time() - t0


def start_host_work():
    """Start, in two threads, the host work of the default run that needs
    neither the scene nor the card, so that it overlaps the scene's build:
    :func:`build_libraries` (returns its future, which :func:`phase_build`
    waits for) and :func:`atrium_brute_host` (which the kernels phase's
    walk checks wait for).  Nothing else loads a library before
    ``phase_build``."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    builds = pool.submit(build_libraries)
    HOST_WORK["atrium_brute"] = pool.submit(atrium_brute_host)
    pool.shutdown(wait=False)
    return builds


def phase_build(scene_h, builds=None):
    """The two libraries (``builds``: the future of
    :func:`build_libraries`, else built now), then the packed BVH (the
    exact fallback's tables) and the cluster BVH of the headline scene,
    built on the host; both must come from the native builder.  Then the
    Python SAH builder and its octant packing on the two Cornell scenes of
    the oracle.  Returns (the packed BVH on the card, the host cluster BVH,
    its build seconds, the packed BVH's build seconds)."""
    lib, t_bvh, t_k = builds.result() if builds is not None \
        else build_libraries()
    assert lib is not None, f"native SAH builder: {native.load_error}"
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "error" in ln.lower()
             or ("Compiling entry" in ln and ("packed_walk" in ln
                                              or "flat_walk" in ln
                                              or "pair_major" in ln))]
    t0 = time.time()
    pk, pk_by = built_by(lambda: native.build_packed_any(scene_h))
    t_pk = time.time() - t0
    t0 = time.time()
    cb_h, cb_by = built_by(lambda: cluster.build_cluster_bvh(scene_h))
    build_s = time.time() - t0
    host = {}
    for name, sc in (("cornell_mesh_4", cornell.cornell("mesh",
                                                          mesh_subdiv=4)),
                     ("cornell_spheres", cornell.cornell("spheres"))):
        t0 = time.time()
        fb = sah.build_bvh(sc)
        t1 = time.time()
        pkc = packed.pack_bvh(fb, sc)
        t2 = time.time()
        host[name] = {"n_prims": int(sc.n_prims), "n_nodes": fb.n_nodes,
                      "build_bvh_s": round(t1 - t0, 4),
                      "pack_bvh_s": round(t2 - t1, 4),
                      "packed_rows": int(pkc.table.shape[0]),
                      "builder": "python_sah (bvh/sah.py::build_bvh), "
                                 "packed by bvh/packed.py::pack_bvh"}
    emit({"phase": "build", "libbvh_s": round(t_bvh, 2),
          "kernels_s": round(t_k, 2), "nvcc_flags": _build.NVCC_FLAGS,
          "sources": [os.path.relpath(s, os.path.dirname(__file__) or ".")
                      for s in _build.sources()],
          "ptxas": ptxas, "packed_build_s": round(t_pk, 2),
          "n_nodes": pk.n_nodes, "n_tables": pk.n_tables,
          "table_rows": int(pk.table.shape[0]),
          "table_MB": round(pk.table.nbytes / 1e6, 1),
          "builder": {"big1m_packed": pk_by, "big1m_cluster": cb_by},
          "cluster_build_s": round(build_s, 2),
          "flat_host_builds": host})
    assert pk_by == "native" and cb_by == "native", \
        f"big-1m not built by the native builder: packed {pk_by}, " \
        f"cluster {cb_by}"
    return pk.to(DEV), cb_h, build_s, t_pk


# --------------------------------------------------------------------------
# Phase 3 — kernels against their plain versions, on the card
# --------------------------------------------------------------------------

def pair_inputs(cb, ro, rd, t_max, mult):
    """Operands of the pair kernels for one traversal sub-batch: what
    ``_traverse_compact_1`` hands to the ray-major pair stage and to the
    reduce, what it hands to the cluster-major pair stage, and (``fused``)
    what it hands to the one-kernel stage: its own tensors as they are."""
    Q = ro.shape[0]
    t_min1 = torch.zeros((Q,), device=DEV)
    t_max1 = t_max[:, 0]
    cand, live, _ = cluster._descend_compact(
        cb, ro, 1.0 / rd, t_min1[:, None], t_max1[:, None])
    rayP, cidP, _, cnt, right, _ = cluster._flat_pairs(cand, live, Q, mult * Q)
    pair_ok = rayP < Q
    rayPc = torch.clamp_max(rayP, Q - 1)
    cidc = torch.clamp(cidP, 0, cb.n_clusters - 1)
    cid_p, rays = cluster._pair_rows(ro, rd, t_min1, t_max1, rayPc, cidc,
                                     pair_ok)
    # The same list as the cluster-major stage takes it: sorted by cid.
    cid_s, rays_s, _, _ = cluster._dedup_rows(cb, ro, rd, t_min1, t_max1,
                                              rayP, cidP)
    fused = dict(ro=ro, rd=rd, t_min1=t_min1, t_max1=t_max1, rayP=rayP,
                 cidP=cidP, cnt=cnt, right=right)
    return (cid_p, rays, cnt.to(torch.int32), right.to(torch.int32),
            cid_s, rays_s, fused)


def queue_batches(scene, cam, cb, cfg, key, queue, n_warm):
    """Ray batches of the real wavefront (sub-batch 0 of the 4-way strided
    split, as the traversal sees it): the closest-hit batch of the first
    camera wave, the mixed-depth closest-hit batch after ``n_warm`` steps,
    and the shadow batch of the last of those steps, which the any-hit
    traversal takes at its narrow pair budget; then the last two again as
    the whole queue (``queue`` lanes, before the split)."""
    isect, occl_counted = _intersectors_counted("cluster", cb)
    shadow = []

    def occl(scene, ro, rd, t_max, narrow=False):
        shadow[:] = [ro, rd, t_max]
        return occl_counted(scene, ro, rd, t_max, narrow=narrow)
    st = wavefront.init_queue(queue, cfg.n_pixels, DEV)

    def batch(st, k):
        st = wavefront._respawn(cam, cfg, key, st, 0, cfg.n_pixels, 0, cfg.spp)
        t_max = torch.where(st.alive, 1e30, -1.0).to(torch.float32)
        return (st.ro[0::k].contiguous(), st.rd[0::k].contiguous(),
                t_max[0::k].contiguous())

    k = cluster._split_batches(queue, cluster.SPLIT_CLOSEST)
    with torch.no_grad():
        first = batch(st, k)
        for i in range(n_warm):
            st, _ = wavefront._step(scene, cam, cfg, key, isect, occl, st, 0,
                                    cfg.n_pixels, 0, cfg.spp,
                                    shadow_narrow=i >= 2)
        mid, mid_full = batch(st, k), batch(st, 1)
    k = cluster._split_batches(queue, cluster.SPLIT_ANYHIT)
    return (first, mid, tuple(x[0::k].contiguous() for x in shadow), mid_full,
            tuple(shadow))


def compare_k2(tiles, cid, rays, label):
    """Kernel vs plain version.  Bitwise is the aim (-fmad=false, same
    operation order); the stated tolerance is the fallback."""
    out_k = pair_tile_isect(tiles, cid, rays)
    sync()
    out_r = pair_tile_isect_ref(tiles, cid, rays)
    check_pair_out(out_k, rays)
    bitwise = bool(torch.equal(out_k, out_r))
    tk, tr = out_k[:, 0], out_r[:, 0]
    hit_k, hit_r = tk < INF, tr < INF
    both = hit_k & hit_r
    err = float((tk[both] - tr[both]).abs().max()) if bool(both.any()) else 0.0
    uv_err = float((out_k[both][:, 2:4] - out_r[both][:, 2:4]).abs().max()) \
        if bool(both.any()) else 0.0
    res = {"case": label, "pairs": int(cid.shape[0]),
           "hits": int(hit_r.sum()), "bitwise": bitwise,
           "max_abs_err_t": err, "max_abs_err_uv": uv_err}
    if not bitwise:
        lane_eq = (out_k[:, 1] == out_r[:, 1])[both]
        res["lane_agreement"] = float(lane_eq.float().mean()) \
            if bool(both.any()) else 1.0
        res["n_rows_differ"] = int((out_k != out_r).any(dim=1).sum())
        assert bool(torch.equal(hit_k, hit_r)), f"K2 {label}: hit mask differs"
        assert torch.allclose(tk[both], tr[both], rtol=1e-6, atol=1e-6), \
            f"K2 {label}: t beyond rtol 1e-6, atol 1e-6"
        t_same = (tk == tr)[both]
        assert bool(lane_eq[t_same].all()), \
            f"K2 {label}: lane differs where t is bitwise equal"
        assert res["lane_agreement"] > 0.99, f"K2 {label}: lane agreement"
    return res, out_k


def compare_k1(t, g, u, v, cnt, right, label):
    out_k = pair_segmin(t, g, u, v, cnt, right)
    sync()
    out_r = pair_segmin_ref(t, g, u, v, cnt, right)
    ok = True
    err = 0.0
    for a, b in zip(out_k, out_r):
        # Bitwise, NaN included: compare the raw 32-bit words.
        ok &= bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
        if a.dtype == torch.float32:
            d = (a - b).abs()
            d = d[~torch.isnan(d)]
            err = max(err, float(d.max()) if d.numel() else 0.0)
    assert ok, f"K1 {label}: kernel and plain version differ (must be bitwise)"
    return {"case": label, "rays": int(cnt.shape[0]), "pairs": int(t.shape[0]),
            "bitwise": True, "max_abs_err": err}


def k2_edge_case():
    """Sphere tile, all-padding tile, two-lanes-equal-t tile, dead pairs."""
    scene = cornell.cornell("spheres")
    cb = cluster.build_cluster_bvh(scene)          # 128-lane tiles
    tiles = torch.from_numpy(cb.tiles)
    dup = tiles[0:1].clone()
    dup[0, :, 5] = dup[0, :, 2]                    # lane 5 := lane 2 (equal t)
    tiles = torch.cat([tiles, torch.zeros_like(tiles[0:1]), dup]).to(DEV)
    C = tiles.shape[0]
    g = torch.Generator().manual_seed(11)
    P = 1024
    ro = (torch.rand((P, 3), generator=g) * 6 - 3)
    ro[:, 1] = ro[:, 1].abs()
    rd = torch.randn((P, 3), generator=g)
    rd = rd / rd.norm(dim=1, keepdim=True)
    rays = torch.zeros((P, 16))
    rays[:, 0:3], rays[:, 3:6] = ro, rd
    rays[:, 7] = 1e30
    rays[:, 8] = (torch.arange(P) % 7 != 0).float()   # every 7th pair dead
    cid = (torch.arange(P) % C).to(torch.int32)
    return tiles, cid.to(DEV), rays.to(DEV)


def k1_edge_case():
    """Empty rays, a long segment (> one warp pass), ties in t broken by
    gid, and a NaN that heads a segment."""
    rs = np.random.RandomState(5)
    cnt = rs.randint(0, 9, size=512).astype(np.int32)
    cnt[::5] = 0
    cnt[3] = 4
    cnt[7] = 200
    cnt[100] = 70
    right = np.cumsum(cnt).astype(np.int32)
    P = int(right[-1])
    t = rs.choice(np.array([0.5, 1.0, 2.0, 1e30], np.float32), size=P)
    g = rs.randint(0, 1 << 30, size=P).astype(np.int32)
    u = rs.rand(P).astype(np.float32)
    v = rs.rand(P).astype(np.float32)
    t[right[3] - cnt[3]] = np.nan                   # NaN heads ray 3's segment
    return tuple(torch.from_numpy(x).to(DEV) for x in (t, g, u, v, cnt, right))


def max_abs_diff(a, b):
    """Largest |a - b| over the entries where both are finite and below
    INF (0.0 for bitwise-equal tensors)."""
    a, b = a.float(), b.float()
    m = torch.isfinite(a) & torch.isfinite(b) & (a < INF) & (b < INF)
    return float((a[m] - b[m]).abs().max()) if bool(m.any()) else 0.0


def pair_kernel_bytes(live_tiles, P, L):
    """Bytes a pair-tile kernel must move, each input read once: the 10
    rows the test uses (rows 10, 11 are padding) of every DISTINCT tile a
    live pair names, the cid and ray rows; each output row written once."""
    return live_tiles * 10 * L * 4 + P * (16 * 4 + 4) + P * 8 * 4


def tile_fetches(cid, rays):
    """Distinct (block, cluster id) pairs among the live pairs of this list
    under the grid the cluster-major kernel is launched with (slot s is
    taken by warp s mod W, W the grid's warps, four warps a block): the
    tile reads that a block cannot share with another of its warps through
    the SM's L1 cache."""
    P = cid.shape[0]
    W = DEDUP_WARPS_PER_BLOCK * dedup_grid_blocks(P, _build.sm_count(DEV))
    idx = torch.nonzero(rays[:, 8] > 0)[:, 0]
    block = (idx % W) // DEDUP_WARPS_PER_BLOCK
    return int(torch.unique(block * (int(cid.max()) + 1)
                            + cid[idx].long()).numel())


def compare_k3(tiles, cid, rays, label):
    """The cluster-major kernel against its plain version AND against the
    ray-major kernel on the same rows: bitwise, no tolerance."""
    out_k = pair_tile_isect_dedup(tiles, cid, rays)
    sync()
    out_r = pair_tile_isect_dedup_ref(tiles, cid, rays)
    out_2 = pair_tile_isect(tiles, cid, rays)
    check_pair_out(out_k, rays, label="pair_tile_isect_dedup")
    assert bool(torch.equal(out_k, out_r)), \
        f"K3 {label}: kernel and plain version differ (must be bitwise)"
    assert bool(torch.equal(out_k, out_2)), \
        f"K3 {label}: differs from pair_tile_isect on the same rows"
    live = rays[:, 8] > 0
    return {"case": label, "pairs": int(cid.shape[0]),
            "live_pairs": int(live.sum()),
            "live_tiles": int(cid[live].unique().numel()),
            "tile_fetches": tile_fetches(cid, rays),
            "sorted": bool((cid[1:] >= cid[:-1]).all()),
            "hits": int((out_k[:, 0] < INF).sum()), "bitwise": True,
            "equals_pair_tile_isect": True,
            "max_abs_err": max_abs_diff(out_k[:, 0], out_r[:, 0])}


def k3_edge_case():
    """On the tiles of the ray-major edge case (sphere lanes, an all-padding
    tile, a tile with two equal lanes): one cluster id throughout; an id
    that changes at every pair; ids in runs of 12, so that runs of 8
    straddle two ids; a block of dead pairs only.  Every 7th pair of the
    first three parts is dead too."""
    tiles, _, rays = k2_edge_case()                # P = 1024
    C = tiles.shape[0]
    i = torch.arange(256)
    cid = torch.cat([torch.zeros(256, dtype=torch.int64), i % C,
                     (i // 12) % C, i % C]).to(torch.int32)
    rays[768:, 8] = 0.0
    return tiles, cid.to(DEV), rays


def edge_pair_rays(P, seed, live_every=7):
    """(P, 16) ray rows from around the Cornell box in random directions;
    every ``live_every``-th pair dead."""
    g = torch.Generator().manual_seed(seed)
    ro = torch.rand((P, 3), generator=g) * 6 - 3
    ro[:, 1] = ro[:, 1].abs()
    rd = torch.randn((P, 3), generator=g)
    rd = rd / rd.norm(dim=1, keepdim=True)
    rays = torch.zeros((P, 16))
    rays[:, 0:3], rays[:, 3:6] = ro, rd
    rays[:, 7] = 1e30
    rays[:, 8] = (torch.arange(P) % live_every != 0).float()
    return rays.to(DEV)


def k3_grid_edge_cases():
    """Cases for the cluster-major kernel's grid, which strides a warp over
    the slots w, w + W, ... (W = 4 x blocks): (label, tiles, cid, rays)."""
    tiles, _, _ = k2_edge_case()
    C = tiles.shape[0]
    # One id over 8,192 pairs, more than the grid's stride of 2,640 slots
    # on 132 SMs: each warp meets several live slots of one tile.
    P = 8192
    yield ("one_id_longer_than_stride", tiles,
           torch.full((P,), 2, dtype=torch.int32, device=DEV),
           edge_pair_rays(P, 21))
    # Sorted ids, liveness in no order: live pairs after dead ones.
    P = 1024
    rays = edge_pair_rays(P, 22)
    g = torch.Generator().manual_seed(23)
    rays[:, 8] = (torch.rand(P, generator=g) < 0.5).float().to(DEV)
    cid = torch.sort(torch.randint(0, C, (P,), generator=g))[0]
    yield "live_after_dead", tiles, cid.to(torch.int32).to(DEV), rays
    # Narrower tiles, the kernel's V = 1 and 2: Cornell spheres' (sphere
    # lanes) and Cornell mesh's.
    for L in (32, 64):
        t_l = torch.cat([torch.from_numpy(cluster.build_cluster_bvh(
            sc, tile=L).tiles) for sc in (cornell.cornell("spheres"),
                                          cornell.cornell("mesh",
                                                          mesh_subdiv=2))])
        t_l = t_l.to(DEV)
        P = 2048
        cid = torch.sort(torch.randint(0, t_l.shape[0], (P,), generator=g))[0]
        yield (f"L{L}", t_l, cid.to(torch.int32).to(DEV),
               edge_pair_rays(P, 24 + L))
    # One block's worth of pairs.
    P = 128
    cid = (torch.arange(P) // 5 % C).to(torch.int32)
    yield "P128", tiles, cid.to(DEV), edge_pair_rays(P, 25, live_every=3)


def box_rays(n, seed, t_max):
    """(n, 8) ray rows from inside the Cornell box in random directions
    (most hit); every 9th ray has t_max < t_min and can never hit."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([-0.9, 0.1, -0.9])
    ro = lo + torch.rand((n, 3), generator=g) * 1.8
    rd = torch.randn((n, 3), generator=g)
    rd = rd / rd.norm(dim=1, keepdim=True)
    rows = torch.zeros((n, 8))
    rows[:, 0:3], rows[:, 4:7] = ro, rd
    rows[:, 7] = t_max
    rows[::9, 7] = -1.0
    return rows.to(DEV)


def dense_edge_case():
    """Two identical triangles 128 rows apart and two in one tile (the
    lowest slot must win), a farther triangle in a lower slot, a sphere
    row, zero padding rows; rays that hit each, one that misses and one
    with t_max < t_min."""
    prims = torch.zeros((384, 16))
    tri = torch.tensor([-1.0, -1, 0, 2, 0, 0, 0, 2, 0])
    for slot in (5, 133, 261, 300):
        prims[slot, 0:9] = tri
    prims[2, 0:9] = tri
    prims[2, 2] = -1.0
    prims[140, 0:4] = torch.tensor([3.0, 0.0, 0.0, 0.5])   # sphere at x = 3
    prims[140, 10] = 1.0
    ro = torch.tensor([[-0.5, -0.5, 3.0], [0.2, -0.7, 1.0], [5.0, 5.0, 5.0],
                       [3.0, 0.1, 4.0], [-0.5, -0.5, 3.0]])
    rows = torch.zeros((5, 8))
    rows[:, 0:3] = ro
    rows[:, 6] = -1.0
    rows[:, 7] = 1e30
    rows[4, 7] = -1.0                                       # never hits
    return rows.to(DEV), prims.to(DEV)


def compare_dense(rows, prims, label):
    """Both dense kernels against their plain versions: bitwise."""
    out_k = dense_closest(rows, prims)
    occ_k = dense_anyhit(rows, prims)
    sync()
    out_r = closest_ref(rows, prims)
    occ_r = anyhit_ref(rows, prims)
    for name, a, b in zip(("t", "u", "v", "slot"), out_k, out_r):
        assert a.dtype == b.dtype and bool(torch.equal(a, b)), \
            f"K4 {label}: {name} differs from the plain version (must be bitwise)"
    assert bool(torch.equal(occ_k, occ_r)), \
        f"K5 {label}: differs from the plain version (must be bitwise)"
    hit = out_k[0] < INF
    # A ray is occluded inside [t_min, t_max] exactly when it has a nearest
    # hit there.
    assert bool(torch.equal(occ_k > 0.5, hit)), f"{label}: K4 and K5 disagree"
    return {"case": label, "rays": int(rows.shape[0]),
            "rows": int(prims.shape[0]), "hits": int(hit.sum()),
            "bitwise": True,
            "max_abs_err": max(max_abs_diff(a, b)
                               for a, b in zip(out_k[:3], out_r[:3])),
            "max_abs_err_occ": float((occ_k - occ_r).abs().max())}, out_k


def oracle_chunk_rays(scene, cam, ps, cfg, key):
    """The ray rows the dense kernels get in the first chunk of the
    full-size oracle render: its camera rays (closest hit) and the shadow
    rays cast from their hit points (any hit)."""
    isect, occl = _intersectors("pallas", ps)
    got = {}

    def isect_spy(scene, ro, rd, t_min, t_max):
        got.setdefault("closest", torch.cat([ro, t_min, rd, t_max], 1))
        return isect(scene, ro, rd, t_min, t_max)

    def occl_spy(scene, ro, rd, t_max):
        got.setdefault("anyhit", torch.cat(
            [ro, torch.zeros_like(t_max), rd, t_max], 1))
        return occl(scene, ro, rd, t_max)

    pix_chunk = (1 << 17) // cfg.spp
    pixel_ids = torch.arange(pix_chunk, device=DEV).repeat_interleave(cfg.spp)
    sample_ids = torch.arange(cfg.spp, device=DEV).repeat(pix_chunk)
    with torch.no_grad():
        integrator.render_chunk(scene, cam, cfg.replace(direct_only=True), key,
                                pixel_ids, sample_ids, isect_spy, occl_spy)
    return got["closest"].contiguous(), got["anyhit"].contiguous()


def fused_ops(tiles, tile_gid, f):
    return (tiles, tile_gid, f["ro"], f["rd"], f["t_min1"], f["t_max1"],
            f["cidP"], f["cnt"], f["right"])


def compare_fused(cb, f, label):
    """The one-kernel pair stage, closest-hit and any-hit form: bitwise
    against its plain version AND against the split stage's kernels
    (pair_tile_isect -> pair_segmin and the array code around them) on the
    card."""
    ops = fused_ops(cb.tiles, cb.tile_gid, f)
    args = (cb, f["ro"], f["rd"], f["t_min1"], f["t_max1"], f["rayP"],
            f["cidP"], f["cnt"], f["right"])
    ref = pair_ray_reduce_ref(*ops)
    ref_occ = pair_ray_reduce_ref(*ops, any_hit=True)
    split = cluster._reduce_pairs_closest_scan(*args)
    split_occ = cluster._reduce_pairs_anyhit_scan(*args)
    out = pair_ray_reduce(*ops)
    occ = pair_ray_reduce(*ops, any_hit=True)
    sync()
    for name, a, b, c in zip(("t", "gid", "u", "v"), out, ref, split):
        assert a.dtype == b.dtype and bool(torch.equal(a, b)), \
            f"fused {label}: {name} differs from the plain version"
        assert a.dtype == c.dtype and bool(torch.equal(a, c)), \
            f"fused {label}: {name} differs from K1(K2)"
    assert occ.dtype == torch.bool and bool(torch.equal(occ, ref_occ)), \
        f"fused {label}: any-hit differs from the plain version"
    assert bool(torch.equal(occ, split_occ)), \
        f"fused {label}: any-hit differs from K1(K2)"
    live = f["rayP"] < f["ro"].shape[0]
    cnt = f["cnt"]
    return {"case": label, "rays": int(cnt.shape[0]),
            "pairs": int(f["cidP"].shape[0]), "live_pairs": int(cnt.sum()),
            "live_tiles": int(f["cidP"][live].unique().numel()),
            "rays_with_pairs": int((cnt > 0).sum()),
            "max_pairs_of_a_ray": int(cnt.max()),
            "hits": int((ref[0] < INF).sum()),
            "bitwise": True, "equals_split_kernels": True,
            "max_abs_err": max(max_abs_diff(a, b)
                               for a, b in zip(out[:1] + out[2:],
                                               ref[:1] + ref[2:]))}


class _Tiles:
    """What compare_fused reads of a ClusterBVH, for hand-made tiles."""

    def __init__(self, tiles, tile_gid):
        self.tiles, self.tile_gid = tiles, tile_gid
        self.n_clusters = tiles.shape[0]


def fused_edge_case(L):
    """Hand-made tiles and segments for the fused kernel.  Tiles: 0 a
    square floor at y = 0 (two triangles, gids 100, 101); 1 the SAME floor
    with gids 50, 51 (equal t in another tile: the lower gid must win);
    2 a floor at y = -1 (gids 10, 11); 3 a sphere of radius 1 at y = 2
    (gid 7); 4 padding only.  Rays fall straight down from y = 5 inside the
    sphere's outline.  Segments: empty ones; the tie in both orders; the
    sphere above the floors; cluster ids outside [0, C); and a pair budget
    that ends inside ray 12's segment (its second pair and every later ray
    are cut, as ``_flat_pairs`` cuts them).  Returns (tiles holder, operand
    dict, gid each ray must report, -1 for a miss)."""
    def floor(y, gid0):
        t = torch.zeros((12, L))
        t[0:3, 0] = torch.tensor([-1.0, y, -1.0])
        t[3, 0], t[8, 0] = 2.0, 2.0
        t[0:3, 1] = torch.tensor([1.0, y, 1.0])
        t[3, 1], t[8, 1] = -2.0, -2.0
        g = torch.zeros((L,), dtype=torch.int32)
        g[0], g[1] = gid0, gid0 + 1
        return t, g

    sph = torch.zeros((12, L))
    sph[1, 3], sph[3, 3], sph[9, 3] = 2.0, 1.0, 1.0
    g_sph = torch.zeros((L,), dtype=torch.int32)
    g_sph[3] = 7
    parts = [floor(0.0, 100), floor(0.0, 50), floor(-1.0, 10), (sph, g_sph),
             (torch.zeros((12, L)), torch.zeros((L,), dtype=torch.int32))]
    tiles = torch.stack([p[0] for p in parts]).to(DEV)
    gid = torch.stack([p[1] for p in parts]).to(DEV)
    segs = [[0], [], [0, 1], [1, 0], [2, 0, 1], [4, 1, 0], [4], [0, 3],
            [3, 2], [-5], [99], [99, -5, 2], [2, 0], [0], [1]]
    want = [100, -1, 50, 50, 50, 50, -1, 7, 7, 100, -1, 100, 10, -1, -1]
    budget = sum(len(x) for x in segs[:12]) + 1
    Q = len(segs)
    g = torch.Generator().manual_seed(3)
    ro = torch.rand((Q, 3), generator=g) - 0.5
    ro[:, 1] = 5.0
    rd = torch.tensor([0.0, -1.0, 0.0]).repeat(Q, 1)
    cnt = torch.tensor([len(x) for x in segs])
    right = torch.cumsum(cnt, 0)
    base = right - cnt
    right_c = right.clamp_max(budget)
    cnt_c = (right_c - base.clamp_max(budget)).clamp_min(0)
    cid = torch.tensor([c for x in segs for c in x])[:budget]
    ray = torch.repeat_interleave(torch.arange(Q), cnt)[:budget]
    f = dict(ro=ro, rd=rd, t_min1=torch.zeros(Q), t_max1=torch.full((Q,), 1e30),
             rayP=ray, cidP=cid, cnt=cnt_c, right=right_c)
    return _Tiles(tiles, gid), {k: v.to(DEV) for k, v in f.items()}, want


def check_fused_edge_case(L):
    """compare_fused on the hand-made case, and the winners it must name: a
    square's two triangles share the diagonal, so its first gid or the next."""
    cb, f, want = fused_edge_case(L)
    label = f"edge_empty_cut_tie_sphere_cid_range_L{L}"
    res = compare_fused(cb, f, label)
    t, g, u, v = pair_ray_reduce(*fused_ops(cb.tiles, cb.tile_gid, f))
    got = g.tolist()
    for q, w in enumerate(want):
        assert bool(t[q] < INF) == (w >= 0), f"{label}: ray {q} hit mask"
        assert got[q] in ((0,) if w < 0 else (w,) if w == 7 else (w, w + 1)), \
            f"{label}: ray {q} reports gid {got[q]}, not {w}"
    assert float(u[7]) == 0.0 and float(v[8]) == 0.0     # sphere winners
    assert 1.9 < float(t[7]) < 3.0
    return res


def capture_calls(fn, names):
    """fn() with the ``cluster`` functions ``names`` spied on: returns (fn's
    result, per name the (args, kwargs) of each call, in order)."""
    real = {n: getattr(cluster, n) for n in names}
    got = {n: [] for n in names}

    def spy(n):
        def call(*a, **kw):
            got[n].append((a, kw))
            return real[n](*a, **kw)
        return call

    for n in names:
        setattr(cluster, n, spy(n))
    try:
        out = fn()
    finally:
        for n in names:
            setattr(cluster, n, real[n])
    return out, got


def same_bits(a, b, label, prim_where=None):
    """(t, gid, u, v) per ray equal bit for bit; gid only where
    ``prim_where`` when it is given."""
    for name, x, y in zip(("t", "gid", "u", "v"), a, b):
        if name == "gid" and prim_where is not None:
            x, y = x[prim_where], y[prim_where]
        assert x.dtype == y.dtype and bool(torch.equal(x, y)), \
            f"{label}: {name} differs"


def packed_segments(cid_rows, n):
    """``pair_fused.row_segments``' segments packed densely, without a sort:
    ray q's ``n[q]`` pairs at ``[right[q] - n[q], right[q])``, ``right`` the
    running sum of ``n``, moved by one scatter (the slots past
    ``right[Q - 1]`` hold 0): the losing side of the round-1 layout A/B."""
    Q, R = cid_rows.shape
    cnt = n.to(torch.int64)
    right = torch.cumsum(cnt, 0)
    cols = torch.arange(R, device=cnt.device)[None, :]
    pos = torch.where(cols < cnt[:, None], (right - cnt)[:, None] + cols,
                      Q * R)
    out = cid_rows.new_zeros((Q * R + 1,))
    out.scatter_(0, pos.reshape(-1), cid_rows.reshape(-1))
    return out[:Q * R], cnt, right


def check_mode_batches(cb, mid_full, flush, ab=False):
    """The pair batches of the cluster BVH's "frontier" and "pairs" modes on
    the whole mid-render queue (``mid_full``: the headline's 4,096 lanes
    after N_WARM steps, closest hit), captured from the traversals
    themselves in both pair stages: the frontier walk's round 1 (4,096 x
    pb slots, each ray's live candidates at the start of its row, the rest
    a gap), its first feedback round and the pair-major walk's one list.
    Held: each traversal "fused" == "split" bit for bit with as many
    rounds; at each batch ``pair_ray_reduce`` bitwise its plain version and
    the split twin's per-ray result; round 1's operands as ``_first_round``
    builds them.  Timed at each batch: the kernel (time_both) and the
    twin's span (K2 and the array code around it, ``twin_path_ms``: one
    span between CUDA events with the L2 overwritten before it).  With
    ``ab`` (``--modes``) also round 1 packed densely (``packed_segments``:
    the same bits), and at each batch the fused path (the operands built
    from the walk's tensors and the launch, ``path_ms``, timed as the
    twin's span), the plain version and K2 alone.  Returns (cases, timing
    entries)."""
    ro, rd, t_max = mid_full
    Q, L = ro.shape[0], cb.tiles.shape[2]
    t_min = torch.zeros_like(t_max)
    t_min1, t_max1 = t_min[:, 0].contiguous(), t_max[:, 0].contiguous()
    names = ("pair_ray_reduce", "_test_pair_batch", "_list_closest")
    runs = {}
    for mode, walk in (("frontier", cluster._traverse),
                       ("pairs", cluster._traverse_pairs)):
        cbm = cb._replace(traversal_mode=mode)
        for stage in cluster.MODE_PAIR_STAGES:
            runs[mode, stage] = capture_calls(
                lambda: walk(cbm, ro, rd, t_min, t_max, pair_stage=stage),
                names)
        (out_f, got_f), (out_s, got_s) = runs[mode, "fused"], \
            runs[mode, "split"]
        hit = out_s[0][:, 0] < INF
        same_bits([x.reshape(-1) for x in out_f[:4]],
                  [x.reshape(-1) for x in out_s[:4]], f"{mode} traversal",
                  None if mode == "frontier" else hit)
        assert int(out_f[4]) == int(out_s[4]), f"{mode}: overflow differs"
        assert len(got_f["_list_closest"]) == len(got_s["_list_closest"]), \
            f"{mode}: rounds differ"
        assert len(got_f["_test_pair_batch"]) == 0 \
            and len(got_s["pair_ray_reduce"]) == 0, f"{mode}: stage leak"
    got_f, got_s = runs["frontier", "fused"][1], runs["frontier", "split"][1]
    n_feedback = len(got_f["_list_closest"])
    assert n_feedback >= 1, "frontier: no feedback round on the queue"

    # Round 1, rebuilt from the descent as _first_round builds it.
    cand, cand_t, _ = cluster._descend(cb, ro, 1.0 / rd, t_min, t_max)
    pb = min(cb.pair_budget, cand.shape[1])
    assert cluster._cand_sorted(cb), "the headline's candidates are sorted"
    live = cand_t[:, :pb] < INF
    rows = cand[:, :pb]
    n = torch.sum(live, dim=1)
    head = (cb.tiles, cb.tile_gid, ro.contiguous(), rd.contiguous(), t_min1,
            t_max1)
    row_ops = head + pair_fused.row_segments(rows, n)
    a, _ = got_f["pair_ray_reduce"][0]
    assert all(bool(torch.equal(x, y))
               for x, y in zip(a[6:9], row_ops[6:9])), \
        "round 1's operands differ from _first_round's"
    arq = torch.arange(Q, device=DEV)

    def round1_twin():
        t_p, u_p, v_p, g_p = cluster._test_pair_batch(
            cb, ro, rd, t_min1, t_max1, arq.repeat_interleave(pb),
            rows.reshape(-1), live.reshape(-1))
        t, u, v, g = cluster._round_min(t_p, u_p, v_p, g_p, Q, pb)
        return t, g, u, v

    def round1_path(segments):
        return pair_ray_reduce(*head, *segments(rows, torch.sum(live, dim=1)))

    twin1 = round1_twin()
    batches = {"frontier_round1": dict(
        ops=row_ops, twin=twin1,
        path=lambda: round1_path(pair_fused.row_segments),
        twin_path=round1_twin,
        k2=k2_operands(cb, got_s["_test_pair_batch"][0][0]))}
    if ab:
        batches["frontier_round1_packed"] = dict(
            ops=head + packed_segments(rows, n), twin=twin1,
            path=lambda: round1_path(packed_segments))
    # The first list of each walk: the frontier walk's first feedback round
    # (its second pair batch), the pair-major walk's list (its only one).
    for name, mode, k in (("frontier_feedback", "frontier", 1),
                          ("pairs", "pairs", 0)):
        got_f, got_s = runs[mode, "fused"][1], runs[mode, "split"][1]
        lst = got_f["_list_closest"][0][0][:7]
        for x, y in zip(lst[5:7], got_s["_list_closest"][0][0][5:7]):
            assert bool(torch.equal(x, y)), f"{name}: the stages' lists differ"
        twin = cluster._list_closest(*lst, True, "split")
        batches[name] = dict(
            ops=got_f["pair_ray_reduce"][k][0], twin=twin[:4],
            prim_where=twin[0] < INF,
            path=lambda lst=lst: cluster._list_closest(*lst, True, "fused"),
            twin_path=lambda lst=lst: cluster._list_closest(*lst, True,
                                                           "split"),
            k2=k2_operands(cb, got_s["_test_pair_batch"][k][0]))
    cases, timing = [], {}
    for name, b in batches.items():
        ops = b["ops"]
        out = pair_ray_reduce(*ops)
        ref = pair_ray_reduce_ref(*ops)
        occ = pair_ray_reduce(*ops, any_hit=True)
        sync()
        same_bits(out, ref, f"{name}: kernel vs plain")
        occ_ref = pair_ray_reduce_ref(*ops, any_hit=True)
        assert bool(torch.equal(occ, occ_ref)), f"{name}: any hit vs plain"
        # A list's t comes back with -0 as +0 (``_list_closest``), round
        # 1's as the reduce leaves it, in both stages.
        t_out = out[0] if name.startswith("frontier_round1") else out[0] + 0.0
        same_bits((t_out,) + tuple(out[1:]), b["twin"],
                  f"{name}: fused vs split", b.get("prim_where"))
        cnt, right, cid = ops[7], ops[8], ops[6]
        P = int(cid.shape[0])
        start = right - cnt
        slot = torch.arange(P, device=DEV)
        ray_of = torch.searchsorted(right, slot, right=True).clamp_max(Q - 1)
        in_seg = (slot >= start[ray_of]) & (slot < right[ray_of])
        live_pairs = int(cnt.sum())
        live_tiles = int(cid[in_seg].unique().numel())
        shape = {"P": P, "Q": Q, "L": L, "live_pairs": live_pairs,
                 "live_tiles": live_tiles,
                 "max_pairs_of_a_ray": int(cnt.max()),
                 "gapped": bool((start[1:] > right[:-1]).any()),
                 "any_hit": False}
        cases.append({"case": name, **shape, "hits": int((ref[0] < INF).sum()),
                      "bitwise_plain": True, "equals_split_twin": True})
        tm = dict(shape=shape,
                  **time_both(lambda: pair_ray_reduce(*ops), flush,
                              "pair_major_kernel"),
                  bytes=fused_bytes(live_tiles, live_pairs, Q, L, False),
                  flops=live_pairs * L * 100)
        if "twin_path" in b:
            tm["twin_path_ms"] = time_launches(b["twin_path"], flush)
        if ab:
            tm["path_ms"] = time_launches(b["path"], flush)
        if ab and "k2" in b:
            tm["plain_ms"] = time_launches(
                lambda: pair_ray_reduce_ref(*ops), flush, repeats=10)
            cid_p, rays = b["k2"]
            k2_live = int((rays[:, 8] > 0).sum())
            timing["pair_tile_isect@" + name] = dict(
                shape={"P": int(cid_p.shape[0]), "L": L,
                       "live_pairs": k2_live, "live_tiles": live_tiles},
                **time_both(lambda: pair_tile_isect(cb.tiles, cid_p, rays),
                            flush, "pair_tile_isect_kernel"),
                bytes=pair_kernel_bytes(live_tiles, int(cid_p.shape[0]), L),
                flops=k2_live * L * 100)
        timing["pair_ray_reduce@" + name] = tm
    cases.append({"case": "rounds", "frontier_feedback_rounds": n_feedback,
                  "equal_in_both_stages": True})
    return cases, timing


def k2_operands(cb, test_args):
    """K2's operands for one captured ``_test_pair_batch`` call: the padded
    cluster ids and (P, 16) ray rows, as that function builds them."""
    _, ro, rd, t_min1, t_max1, ray_c, cid_c, pair_ok = test_args[:8]
    cid_c = torch.clamp(cid_c, 0, cb.n_clusters - 1)
    return cluster._pair_rows(ro, rd, t_min1, t_max1, ray_c, cid_c, pair_ok)


def fused_bytes(live_tiles, live_pairs, Q, L, any_hit):
    """Bytes the fused stage must move, each input read once and each
    output written once: rows 0-9 of every DISTINCT tile a live pair names
    and, for the closest hit, its row of tile_gid; 8 B of cluster id per
    live pair; per ray 48 B in (origin, direction, two bounds, two segment
    bounds) and 16 B out (1 B for any hit)."""
    per_tile = 10 * L * 4 + (0 if any_hit else L * 4)
    return live_tiles * per_tile + live_pairs * 8 + Q * (48 + (1 if any_hit
                                                               else 16))


def launch_floor(blocks, threads=128):
    """One launch of the library's empty kernel on the current stream."""
    err = _build.load().launch_floor_launch(
        blocks, threads, torch.cuda.current_stream(DEV).cuda_stream)
    assert err == 0, f"launch_floor: CUDA launch error {err}"


def trace_launches(fn, flush, name_part, repeats=30):
    """Median microseconds of the kernel whose name contains ``name_part``
    over ``repeats`` calls of ``fn`` under torch.profiler, and the number of
    kernel records the median rests on; the L2 cache
    overwritten before each as in :func:`time_launches`: the kernel's own
    duration on the device, without the launch latency and the two event
    records that lie between a pair of events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as profiler

    for _ in range(3):
        fn()
    sync()
    # The tracer now and then loses records of kernels this short: a window
    # with fewer than `repeats` of them is taken again, a third of them must
    # be there in the end, and how many there were goes out with the median.
    us = []
    for _ in range(3):
        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                flush.zero_()
                fn()
            sync()
        got = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and name_part in e.name]
        assert len(got) <= repeats, \
            f"trace: {len(got)} kernels named *{name_part}* in {repeats} calls"
        us = max(us, got, key=len)
        if len(us) == repeats:
            break
    assert 3 * len(us) >= repeats, \
        f"trace: {len(us)} kernels named *{name_part}* in {repeats} calls"
    return statistics.median(us), len(us)


def time_both(fn, flush, name_part, repeats=30):
    """A short kernel's three times: between events and in the trace with
    the L2 cache overwritten before each launch, and in the trace with the
    cache left as the launch before left it (the renderer lies between: a
    step's four sub-batches share most of their tiles)."""
    cold, n_cold = trace_launches(fn, flush, name_part, repeats)
    warm, n_warm = trace_launches(fn, flush[:16], name_part, repeats)
    return {"ms": time_launches(fn, flush, repeats), "trace_us": cold,
            "trace_n": n_cold, "trace_warm_us": warm, "trace_warm_n": n_warm}


def time_launches(fn, flush, repeats=30, warmup=3):
    """Median milliseconds of one call, each timed alone between CUDA
    events after the L2 cache was overwritten (the renderer touches ~100 MB
    of tiles and many other tensors between two calls of a kernel).

    The overwrite of ``flush`` (1 GiB, a few hundred microseconds on the
    device) is queued BEFORE the first event, so the host has enqueued the
    call and the second event while the device is still busy: what lies
    between the two events is then device time, not the host's time to
    validate arguments and launch.  A plain version of many small launches
    outlasts that head start, so its time includes host launch time, as it
    does in the renderer."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(repeats):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        sync()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# The device name of each design's kernel, for the profiler's records.
WALK_KERNEL = {"window": "packed_walk_window_kernel",
               "thread": "packed_walk_kernel"}


def walk_args(pk, ro, rd, t_min, t_max):
    """Operands of the packed walk (t bounds as (R,) columns)."""
    return (pk.table, pk.prim_gid, ro.contiguous(), rd.contiguous(),
            t_min.reshape(-1).contiguous(), t_max.reshape(-1).contiguous(),
            pk.n_nodes, pk.n_tables, pk.max_leaf)


def compare_walk(args, label, any_hit):
    """packed_walk in both designs (window, thread) against packed_walk_ref
    and against each other, bitwise (the raw 32-bit words), and the plain
    version's counts: lockstep iterations, node steps, windows of node rows
    and leaves per ray, rows tested (as the kernel tests them)."""
    outs_k = {d: packed_walk(*args, any_hit=any_hit, design=d)
              for d in WALK_DESIGNS}
    sync()
    stats = {}
    out_r = packed_walk_ref(*args, any_hit=any_hit, stats=stats)
    outs_r = (out_r,) if any_hit else out_r
    form = "any hit" if any_hit else "closest"

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32)) \
            if a.dtype == torch.float32 else torch.equal(a, b)

    for d, out_k in outs_k.items():
        for a, b in zip((out_k,) if any_hit else out_k, outs_r):
            assert same(a, b), f"packed_walk {label} ({form}, design {d}): " \
                "kernel and plain version differ (must be bitwise)"
    window, thread = (outs_k[d] for d in ("window", "thread"))
    assert all(same(a, b) for a, b in zip(
        (window,) if any_hit else window, (thread,) if any_hit else thread)), \
        f"packed_walk {label} ({form}): the two designs differ"
    t_max = args[5]
    steps, windows, leaves = (stats[k] for k in ("steps", "windows",
                                                  "leaves"))
    res = {"case": label, "form": "any_hit" if any_hit else "closest",
           "rays": int(t_max.shape[0]),
           "walking_rays": int((t_max >= args[4]).sum()),
           "hits": int(out_r.sum()) if any_hit else int((out_r[0] < t_max).sum()),
           "bitwise": True, "designs": list(WALK_DESIGNS),
           "window_vs_thread_bitwise": True,
           "max_abs_err": 0.0 if any_hit else max(
               max_abs_diff(o[0], out_r[0]) for o in outs_k.values()),
           "plain_iterations": stats["iterations"],
           "max_steps": int(steps.max()), "mean_steps": float(steps.float().mean()),
           "max_windows": int(windows.max()),
           "mean_windows": float(windows.float().mean()),
           "max_leaves": int(leaves.max()),
           "mean_leaves": float(leaves.float().mean()),
           "rows_tri": stats["rows_tri"], "rows_sph": stats["rows_sph"]}
    return res, stats, out_r


def walk_work(stats, R, any_hit):
    """Bytes and FP32 operations the walk must spend on these rays.  Bytes:
    each input it needs read once (every node row any ray fetched, 32 bytes;
    every primitive row any ray tested, 48 bytes and its 4-byte id; per ray
    32 bytes in) and each output written once (16 bytes a ray, 1 for any
    hit).  Operations as counted in OPS_NODE, per node step and row tested.
    Also the traffic of the walk as it runs: every node step and row test
    reading its bytes again."""
    steps = int(stats["steps"].sum())
    rows = stats["rows_tri"] + stats["rows_sph"]
    ray_io = R * (32 + (1 if any_hit else 16))
    n_bytes = (int(stats["node_seen"].sum()) * 32
               + int(stats["row_seen"].sum()) * 52 + ray_io)
    ops = (steps * OPS_NODE + stats["rows_tri"] * (OPS_TRI_ROW + OPS_CLOSEST)
           + stats["rows_sph"] * (OPS_SPH_ROW + OPS_CLOSEST)
           + R * OPS_WALK_RAY)
    return n_bytes, ops, steps * 32 + rows * 48 + ray_io


def overflow_batches(scene, cb):
    """The first closest-hit and the first shadow traversal sub-batch that
    overflow in the 256² render of ``render_small`` (the traversal's own
    operands, caught on their way in): form -> (ro, rd, t_min (Q,),
    t_max (Q,), suspect (Q,)), for each form that overflowed at all; and
    how many sub-batches of each form overflowed."""
    cfg = RenderConfig(width=256, height=256, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(256, 256).to(DEV)
    real = {"closest": cluster._traverse_compact_1,
            "any_hit": cluster._traverse_compact_anyhit_1}
    got, n_over = {}, {"closest": 0, "any_hit": 0}

    def spy(form):
        def run(cb_, ro, rd, t_min, t_max, *a, suspect_out=None, **kw):
            sus = []
            out = real[form](cb_, ro, rd, t_min, t_max, *a, suspect_out=sus,
                             **kw)
            if suspect_out is not None:
                suspect_out.append(sus[0])
            if bool(sus[0].any()):
                n_over[form] += 1
                got.setdefault(form, (ro, rd, t_min[:, 0], t_max[:, 0],
                                      sus[0]))
            return out
        return run

    cluster._traverse_compact_1 = spy("closest")
    cluster._traverse_compact_anyhit_1 = spy("any_hit")
    try:
        wavefront.render_wavefront_counts(scene, cam, cfg, (0, 3), cb,
                                          queue=4096, backend="cluster",
                                          device=DEV)
    finally:
        cluster._traverse_compact_1 = real["closest"]
        cluster._traverse_compact_anyhit_1 = real["any_hit"]
    assert got, "the 256² render did not overflow"
    return got, n_over


def atrium_up_rays(n=20000):
    """The coplanar case of the walks' CPU tests (tests/torch_port_util.py::
    atrium_upward): n seeded rays from the reduced atrium's hall aimed up
    at its crossing ceiling beams, as numpy (ro, rd)."""
    rs = np.random.RandomState(0)
    ro = rs.uniform([-11, 0.5, -4.5], [11, 8.0, 4.5],
                    (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3))
    rd[:, 1] = np.abs(rd[:, 1]) * 2
    return ro, (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(
        np.float32)


def with_up_rays(ro, rd, t_max, up):
    """The edge rays with ``up`` ((ro, rd) numpy, t_max 1e30) after them."""
    if up is None:
        return ro, rd, t_max
    return (np.concatenate([ro, up[0]]), np.concatenate([rd, up[1]]),
            np.concatenate([t_max, np.full((len(up[0]),), 1e30, np.float32)]))


SPHERE_KINDS = ("out", "in", "tangent", "far")
SPHERE_EDGE_N = 256      # rays of each kind at each sphere


def sphere_edge_rays(kinds=SPHERE_KINDS):
    """The sphere solve's edge rays (``tools/sphere_edges.py``) at each
    sphere of the Cornell spheres, ``SPHERE_EDGE_N`` of each kind a sphere:
    origins on the sphere leaving outward and inward, near-tangent rays and
    far rays; with ``kinds=("placeholder",)``, rays at the radius-0
    placeholder of a scene without spheres.  (ro, rd) float32 numpy, for
    t_min 0 and t_max 1e30."""
    from tpu_pt_torch.tools import sphere_edges   # this checkout's own

    sc = cornell.cornell("spheres")
    ro, rd = [], []
    for k, kind in enumerate(kinds):
        spheres = [sphere_edges.PLACEHOLDER] if kind == "placeholder" else \
            list(zip(sc.sph_center, sc.sph_radius))
        for i, (c, r) in enumerate(spheres):
            o, d, _, _ = sphere_edges.edge_rays(c, r, kind, SPHERE_EDGE_N,
                                                seed=40 + 7 * k + i)
            ro.append(o)
            rd.append(d)
    return np.concatenate(ro), np.concatenate(rd)


def sphere_edge_pairs():
    """The pair stage's and the dense sweep's operands for the sphere
    solve's edge rays: on the Cornell spheres (their kinds) and on the
    Cornell mesh (the placeholder's rays; its radius-0 sphere is in its
    tiles and rows), each through the descent of the scene's cluster BVH
    as a traversal hands them on.  Yields (label, cluster BVH, pair_inputs'
    operands, dense ray rows, dense primitive rows)."""
    for label, scene_e, kinds in (
            ("edge_sphere_solve_cornell_spheres", cornell.cornell("spheres"),
             SPHERE_KINDS),
            ("edge_sphere_solve_placeholder", cornell.cornell("mesh"),
             ("placeholder",))):
        cb_e = cluster.build_cluster_bvh(scene_e).to(DEV)
        ro, rd = (torch.from_numpy(x).to(DEV) for x in sphere_edge_rays(kinds))
        R = ro.shape[0]
        t_max = torch.full((R, 1), 1e30, device=DEV)
        ops = pair_inputs(cb_e, ro, rd, t_max, cb_e.pair_mults[2])
        rows = torch.zeros((R, 8), device=DEV)
        rows[:, 0:3], rows[:, 4:7], rows[:, 7] = ro, rd, 1e30
        yield label, cb_e, ops, rows, PallasScene(scene_e).to(DEV).prims


def walk_edge_rays(pk, n, seed, up=None):
    """Rays with the walk's edge cases: half aimed into random leaf boxes,
    axis-parallel directions (components +0 and -0), origins ON a node box
    face with the direction in its plane (0 * inf = NaN in the slab test),
    t_max = -1 (leaves at the root) and t_max = 0.5; then the rays ``up``
    (:func:`atrium_up_rays`), if given."""
    rs = np.random.RandomState(seed)
    boxes = pk.node_rows()[0]
    leaves = boxes[boxes[:, 7].view(np.int32) >= 0]
    # Origins in the box of most leaves, widened by half (a scene's root
    # box may reach a far placeholder primitive).
    lo = np.percentile(leaves[:, 0:3], 1, axis=0)
    hi = np.percentile(leaves[:, 3:6], 99, axis=0)
    lo, hi = lo - (hi - lo) / 2, hi + (hi - lo) / 2
    ro = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3))
    pick = leaves[rs.randint(0, len(leaves), n)]
    aim = rs.uniform(pick[:, 0:3], np.maximum(pick[:, 3:6], pick[:, 0:3])) - ro
    rd[1::2] = aim[1::2]
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    axes = np.eye(3, dtype=np.float32)
    for i in range(0, n, 7):
        rd[i] = axes[i % 3] * (1 if i % 2 else -1)
        if i % 4 == 0:
            rd[i, (i + 1) % 3] = -0.0
    for i in range(5, n, 13):
        b = boxes[rs.randint(0, len(boxes))]
        ro[i] = rs.uniform(b[0:3], np.maximum(b[3:6], b[0:3]))
        ax = i % 3
        ro[i, ax] = b[ax]                          # on the min face
        rd[i, ax] = 0.0                            # inside its plane
        rd[i] /= max(np.linalg.norm(rd[i]), 1e-6)
    t_max = np.full((n,), 1e30, np.float32)
    t_max[8::19] = 0.5
    t_max[::17] = -1.0
    ro, rd, t_max = with_up_rays(ro, rd, t_max, up)
    return tuple(torch.from_numpy(x).to(DEV) for x in
                 (ro, rd, np.zeros_like(t_max), t_max))


def atrium_brute_host():
    """The port's brute force (``render/brute.py``) of
    :func:`atrium_up_rays` on the reduced atrium, run on the host in chunks
    of 500 rays: there its dot products sum left to right, as the walks'
    row test does (the CPU tests hold the plain walks to it bit for bit);
    torch's reduction on the card sums them in another order, so the card's
    brute force rounds t apart from every walk.  A ``Hit`` on the host."""
    scene = meshes.atrium_scene(col_rad=16, col_ny=6).to("cpu")
    ro, rd = (torch.from_numpy(x) for x in atrium_up_rays())
    R = ro.shape[0]
    parts = [brute.intersect(scene, ro[i:i + 500], rd[i:i + 500],
                             torch.zeros((min(500, R - i), 1)),
                             torch.full((min(500, R - i), 1), 1e30))
             for i in range(0, R, 500)]
    return brute.Hit(*(torch.cat(f) for f in zip(*parts)))


# Host work that the default run starts in threads before it builds the
# scene (start_host_work): here the future of atrium_brute_host's result.
HOST_WORK = {}


@functools.lru_cache(maxsize=1)
def atrium_brute():
    """:func:`atrium_brute_host`'s ``Hit`` on the card: the thread's result
    where :func:`start_host_work` started one, else computed now."""
    fut = HOST_WORK.pop("atrium_brute", None)
    hb = fut.result() if fut is not None else atrium_brute_host()
    return brute.Hit(*(f.to(DEV) for f in hb))


def hold_to_brute(label, hit_of, occluded):
    """A walk's nearest hits on :func:`atrium_up_rays` (t_min 0, t_max
    1e30) against the port's brute force (:func:`atrium_brute`), bit for
    bit: hit and t on every ray, primitive, u and v where brute force hits.
    ``hit_of(t_max)`` gives the walk's (t, primitive id, u, v);
    ``occluded(t_max)`` its any-hit bits, one tensor a design, which at
    t_max = brute force's t (the nearest hit on the bound) must be brute
    force's hit bits.  Returns the counts."""
    hb = atrium_brute()
    R = int(hb.t.shape[0])
    t_max = torch.full((R,), 1e30, device=DEV)
    t, g, u, v = hit_of(t_max)
    m = hb.hit[:, 0]
    apart = ((t < t_max) != m) | (t != hb.t[:, 0]) \
        | (m & ((g != hb.prim) | (u != hb.u[:, 0]) | (v != hb.v[:, 0])))
    occ_apart = [int((o != m).sum()) for o in occluded(hb.t[:, 0])]
    res = {"rays": R, "hits": int(m.sum()), "apart_from_brute": int(
        apart.sum()), "any_hit_at_brute_t_apart": occ_apart}
    assert res["apart_from_brute"] == 0 and not any(occ_apart), \
        f"{label}: the walk is not brute force's bit for bit on the " \
        f"coplanar rays: {res}"
    return res


def packed_walk_edge_cases(pk):
    """(c) of check_packed_walk: edge cases on the headline's table, on
    spheres, on coincident triangles and on the reduced atrium's coplanar
    faces (there also against brute force).  Returns the cases."""
    cases = []
    v, f = meshes.icosphere(subdiv=1)
    f = np.concatenate([f, f[:12]])          # 12 faces twice, higher ids
    twin = make_scene(v, f, np.zeros(len(f), np.int32),
                      make_materials([dict(albedo=(0.5,) * 3)]),
                      make_lights([]))
    pk_twin = native.build_packed(twin).to(DEV)
    atrium = meshes.atrium_scene(col_rad=16, col_ny=6)
    up = atrium_up_rays()
    for name, pk_e in (("edge_big1m", pk),
                       ("edge_cornell_spheres",
                        native.build_packed(cornell.cornell("spheres")).to(DEV)),
                       ("edge_coincident_triangles", pk_twin),
                       ("edge_atrium_coplanar",
                        native.build_packed(atrium).to(DEV))):
        coplanar = name == "edge_atrium_coplanar"
        # Appended rays: the atrium's upward ones, the sphere solve's edge
        # rays on the spheres and at big-1m's radius-0 placeholder.
        extra = {"edge_atrium_coplanar": up,
                 "edge_cornell_spheres": sphere_edge_rays(),
                 "edge_big1m": sphere_edge_rays(("placeholder",))}.get(name)
        args = walk_args(pk_e, *walk_edge_rays(pk_e, 3000, 31, extra))
        for form in (False, True):
            res, _, out = compare_walk(args, name, form)
            assert res["hits"] > 0, f"packed_walk {name}: no hit"
            cases.append(res)
        if name == "edge_cornell_spheres":
            assert res["rows_sph"] > 0, "no sphere row tested"
        if coplanar:
            # The upward rays (the last ones) against brute force.
            ro_u, rd_u = (x[-len(up[0]):] for x in args[2:4])

            def hit_of(t_max):
                t, slot, u, v = packed_walk_ref(*walk_args(
                    pk_e, ro_u, rd_u, torch.zeros_like(t_max), t_max))
                return t, pk_e.prim_gid[slot.long()], u, v

            res["vs_brute"] = hold_to_brute(
                "packed_walk " + name, hit_of,
                lambda t_max: [packed_walk(*walk_args(
                    pk_e, ro_u, rd_u, torch.zeros_like(t_max), t_max),
                    any_hit=True, design=d) for d in WALK_DESIGNS])
    c = torch.from_numpy(v[f[:12]].mean(axis=1)).float()
    args = walk_args(pk_twin, (c * 3.0).to(DEV),
                     (-c / c.norm(dim=1, keepdim=True)).to(DEV),
                     torch.zeros(12, device=DEV), torch.full((12,), 1e30,
                                                             device=DEV))
    res, _, (t, slot, _, _) = compare_walk(args, "coincident_lowest_gid", False)
    assert bool((t < INF).all()) and \
        pk_twin.prim_gid[slot.long()].tolist() == list(range(12)), \
        "coincident triangles: not the lowest id"
    cases.append(res)
    return cases


def check_packed_walk(scene, cb, pk, mid, mid_full, shadow_full, flush,
                      edges=True):
    """The walk kernel in both designs against its plain version and
    against each other, bitwise, closest and any hit: (a) the first
    overflowing closest-hit and shadow sub-batch of the 256² render (of each
    form that overflows there) as the retrace hands them over (t_max = -1
    where a ray is not suspect); (b) the whole 4,096-lane queue after
    N_WARM steps, and its shadow batch; (c) edge cases
    (:func:`packed_walk_edge_cases`, where ``edges``).  Times the kernel and
    the plain version on (a) and (b), the two designs one after the other
    on the same operands.  Returns (cases, timing)."""
    cases, timing = [], {}
    got, n_over = overflow_batches(scene, cb)
    batches = []
    for form, (ro, rd, t_min, t_max, sus) in got.items():
        t_max_f = torch.where(sus, t_max, torch.full_like(t_max, -1.0))
        batches.append((f"overflow_{form}_sub_batch", ro, rd, t_min, t_max_f,
                        form == "any_hit", int(sus.sum())))
    for name, (ro, rd, t_max), any_hit in (("queue_4096", mid_full, False),
                                           ("queue_4096_shadow", shadow_full,
                                            True)):
        batches.append((name, ro, rd, torch.zeros_like(t_max[:, 0]),
                        t_max[:, 0], any_hit, None))
    for name, ro, rd, t_min, t_max, any_hit, n_sus in batches:
        args = walk_args(pk, ro, rd, t_min, t_max)
        for form in (False, True):
            res, stats, _ = compare_walk(args, name, form)
            if n_sus is not None:
                res["suspect_rays"] = n_sus
            cases.append(res)
            if form != any_hit:
                continue
            R = int(t_max.shape[0])
            n_bytes, ops, traffic = walk_work(stats, R, form)
            key = "packed_walk" + {"queue_4096": "",
                                   "queue_4096_shadow": "@queue_4096_shadow",
                                   "overflow_closest_sub_batch":
                                       "@overflow_closest",
                                   "overflow_any_hit_sub_batch":
                                       "@overflow_shadow"}[name]
            shape = {"R": R, "walking_rays": res["walking_rays"],
                     "any_hit": form, "max_steps": res["max_steps"],
                     "mean_steps": round(res["mean_steps"], 3),
                     "max_windows": res["max_windows"],
                     "mean_windows": round(res["mean_windows"], 3),
                     "max_leaves": res["max_leaves"],
                     "mean_leaves": round(res["mean_leaves"], 3),
                     "plain_iterations": res["plain_iterations"],
                     "rows": stats["rows_tri"] + stats["rows_sph"],
                     "least_MB": round(n_bytes / 1e6, 4),
                     "traffic_MB": round(traffic / 1e6, 4)}
            # Both designs on the same operands, one after the other.
            timing[key] = dict(
                shape=shape,
                **time_both(lambda: packed_walk(*args, any_hit=form), flush,
                            WALK_KERNEL["window"]),
                # The plain version ran on these operands just before.
                plain_ms=time_launches(
                    lambda: packed_walk_ref(*args, any_hit=form), flush,
                    repeats=2, warmup=0),
                bytes=n_bytes, flops=ops)
            timing[key.replace("packed_walk", "packed_walk_thread", 1)] = \
                dict(shape=shape, **time_both(
                    lambda: packed_walk(*args, any_hit=form, design="thread"),
                    flush, WALK_KERNEL["thread"]), bytes=n_bytes, flops=ops)
    # (c) Edge cases (unless ``edges`` is false); a batch in which no ray is
    # suspect (all leave at the root).
    if edges:
        cases += packed_walk_edge_cases(pk)
    ro, rd, t_max = mid
    args = walk_args(pk, ro, rd, torch.zeros_like(t_max[:, 0]),
                     torch.full_like(t_max[:, 0], -1.0))
    for form in (True, False):
        res, stats, _ = compare_walk(args, "no_suspect_sub_batch", form)
        assert res["max_steps"] == 1 and res["hits"] == 0
        cases.append(res)
    n_bytes, ops, _ = walk_work(stats, int(ro.shape[0]), False)
    for design in WALK_DESIGNS:
        name = "packed_walk" if design == "window" else "packed_walk_thread"
        timing[name + "@no_suspect"] = dict(
            shape={"R": int(ro.shape[0]), "walking_rays": 0},
            **time_both(lambda: packed_walk(*args, design=design), flush,
                        WALK_KERNEL[design]),
            bytes=n_bytes, flops=ops)
    return cases, timing, n_over


def flat_args(fb, sc, ro, rd, t_min, t_max):
    """Operands of the flat walk: a FlatBVH and a scene on the card, rays
    (t bounds as (R,) columns)."""
    return (fb.node_min, fb.node_max, fb.skip, fb.prim_start, fb.prim_count,
            fb.prim_ids, sc.tri_idx, sc.vertices, sc.sph_center,
            sc.sph_radius, ro.contiguous(), rd.contiguous(),
            t_min.reshape(-1).contiguous(), t_max.reshape(-1).contiguous(),
            sah.MAX_LEAF)


# The device name of each design's kernel, for the profiler's records (the
# row walk's STATS form is never profiled).
FLAT_KERNEL = {"rows": "flat_walk_rows_kernel", "thread": "flat_walk_kernel"}


def compare_flat(args, rows, label, any_hit):
    """flat_walk in both designs (rows, thread) against flat_walk_ref and
    against each other, bitwise (the raw 32-bit words), and the plain
    version's counts: lockstep iterations, node steps, leaves and
    primitives per ray (as the kernel tests them), the lane efficiency of
    warps of 32 rays in launch order, the longest chains of round trips."""
    outs_k = {d: flat_walk(*args, any_hit=any_hit, design=d, rows=rows)
              for d in FLAT_DESIGNS}
    sync()
    stats = {}
    out_r = flat_walk_ref(*args, any_hit=any_hit, stats=stats)
    outs_r = (out_r,) if any_hit else out_r
    form = "any hit" if any_hit else "closest"

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32)) \
            if a.dtype == torch.float32 else torch.equal(a, b)

    for d, out_k in outs_k.items():
        for a, b in zip((out_k,) if any_hit else out_k, outs_r):
            assert same(a, b), f"flat_walk {label} ({form}, design {d}): " \
                "kernel and plain version differ (must be bitwise)"
    r_out, t_out = (outs_k[d] for d in ("rows", "thread"))
    assert all(same(a, b) for a, b in zip(
        (r_out,) if any_hit else r_out, (t_out,) if any_hit else t_out)), \
        f"flat_walk {label} ({form}): the two designs differ"
    t_min, t_max = args[12], args[13]
    steps, leaves, prims = (stats[k] for k in ("steps", "leaves", "prims"))
    res = {"case": label, "form": "any_hit" if any_hit else "closest",
           "rays": int(t_max.shape[0]),
           "walking_rays": int((t_max >= t_min).sum()),
           "hits": int(out_r.sum()) if any_hit else int((out_r[0] < t_max).sum()),
           "bitwise": True, "designs": list(FLAT_DESIGNS),
           "rows_vs_thread_bitwise": True,
           "max_abs_err": 0.0 if any_hit else max(
               max_abs_diff(o[0], out_r[0]) for o in outs_k.values()),
           "plain_iterations": stats["iterations"],
           "max_steps": int(steps.max()), "mean_steps": float(steps.float().mean()),
           "lane_efficiency": round(flat_chains.lane_efficiency(steps), 4),
           "max_leaves": int(leaves.max()),
           "mean_leaves": float(leaves.float().mean()),
           "max_chain_thread": int((steps + 3 * prims).max()),
           "max_chain_rows": int((steps + leaves).max()),
           "prims_tri": stats["prims_tri"], "prims_sph": stats["prims_sph"]}
    return res, stats, out_r


def flat_work(stats, R, any_hit, tri_idx, design):
    """Bytes and FP32 operations the flat walk of ``design`` must spend on
    these rays, and the traffic of the walk as it runs (every node step and
    primitive test reading its bytes again).  Both designs: per ray 32
    bytes in and 16 out (1 for any hit); operations per node step OPS_NODE,
    per ray OPS_FLAT_RAY.

    ``"thread"`` reads the arrays: a node 36 bytes (box, skip, start,
    count); a primitive its 4-byte id in ``prim_ids`` and, for a triangle,
    12 bytes of indices and its distinct vertices, 12 bytes each, for a
    sphere 16 bytes of centre and radius (traffic: 52 a triangle, 20 a
    sphere); OPS_FLAT_TRI / OPS_FLAT_SPH a primitive (the triangle forms
    its edges).  ``"rows"`` reads the row tables: a node row 32 bytes, a
    primitive row 48 bytes and its 4-byte id in ``prim_gid`` (traffic: 48
    a primitive; the id is read on a tie and at the end);
    OPS_ROWS_TRI / OPS_ROWS_SPH a primitive (its edges are in its row)."""
    steps = int(stats["steps"].sum())
    tri, sph = stats["prims_tri"], stats["prims_sph"]
    seen = stats["prim_seen"]
    ray_io = R * (32 + (1 if any_hit else 16))
    if design == "rows":
        n_bytes = (int(stats["node_seen"].sum()) * 32 + int(seen.sum()) * 52
                   + ray_io)
        ops = (steps * OPS_NODE + tri * OPS_ROWS_TRI + sph * OPS_ROWS_SPH
               + R * OPS_FLAT_RAY)
        return n_bytes, ops, steps * 32 + (tri + sph) * 48 + ray_io
    T = int(tri_idx.shape[0])
    tris = torch.nonzero(seen[:T]).reshape(-1)
    n_vert = int(tri_idx[tris].unique().numel())
    n_bytes = (int(stats["node_seen"].sum()) * 36 + int(seen.sum()) * 4
               + int(tris.numel()) * 12 + n_vert * 12
               + int(seen[T:].sum()) * 16 + ray_io)
    ops = (steps * OPS_NODE + tri * OPS_FLAT_TRI + sph * OPS_FLAT_SPH
           + R * OPS_FLAT_RAY)
    return n_bytes, ops, steps * 36 + tri * 52 + sph * 20 + ray_io


def flat_edge_rays(fb, n, seed, up=None):
    """walk_edge_rays' cases on a host FlatBVH: half the rays aimed into
    random leaf boxes, axis-parallel directions (+0 and -0 components),
    origins ON a node box's face with the direction in its plane (0 * inf =
    NaN in the slab test), t_max = -1 (leaves at the root) and 0.5; then
    the rays ``up`` (:func:`atrium_up_rays`), if given."""
    rs = np.random.RandomState(seed)
    nlo, nhi = fb.node_min, fb.node_max
    leaf = fb.prim_count > 0
    lo = np.percentile(nlo[leaf], 1, axis=0)
    hi = np.percentile(nhi[leaf], 99, axis=0)
    lo, hi = lo - (hi - lo) / 2, hi + (hi - lo) / 2
    ro = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3))
    pick = np.flatnonzero(leaf)[rs.randint(0, int(leaf.sum()), n)]
    aim = rs.uniform(nlo[pick], np.maximum(nhi[pick], nlo[pick])) - ro
    rd[1::2] = aim[1::2]
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    axes = np.eye(3, dtype=np.float32)
    for i in range(0, n, 7):
        rd[i] = axes[i % 3] * (1 if i % 2 else -1)
        if i % 4 == 0:
            rd[i, (i + 1) % 3] = -0.0
    for i in range(5, n, 13):
        b = rs.randint(0, len(nlo))
        ro[i] = rs.uniform(nlo[b], np.maximum(nhi[b], nlo[b]))
        ax = i % 3
        ro[i, ax] = nlo[b, ax]                     # on the min face
        rd[i, ax] = 0.0                            # inside its plane
        if np.linalg.norm(rd[i]) < 1e-3:           # was along that axis
            rd[i, (ax + 1) % 3] = 1.0
        rd[i] /= np.linalg.norm(rd[i])
    t_max = np.full((n,), 1e30, np.float32)
    t_max[8::19] = 0.5
    t_max[::17] = -1.0
    ro, rd, t_max = with_up_rays(ro, rd, t_max, up)
    return tuple(torch.from_numpy(x).to(DEV) for x in
                 (ro, rd, np.zeros_like(t_max), t_max))


def sphere_grid_scene():
    """27 spheres on a grid and two triangles: leaves of spheres only."""
    v, f = meshes.icosphere(subdiv=1)
    g = np.stack(np.meshgrid(*[np.linspace(-1.5, 1.5, 3)] * 3), -1)
    return make_scene(v, f[:2], np.zeros(2, np.int32),
                      make_materials([dict(albedo=(0.5,) * 3)]),
                      make_lights([]),
                      sph_center=g.reshape(-1, 3).astype(np.float32),
                      sph_radius=[0.3 + 0.01 * i for i in range(27)],
                      sph_mat=np.zeros(27, np.int32))


def flat_walk_edge_cases(o_scene_h):
    """(b) of check_flat_walk: edge cases on five scenes, the reduced
    atrium's coplanar faces among them (there also against brute force),
    and the lowest id of coincident triangles.  Returns the cases."""
    cases = []
    v, f = meshes.icosphere(subdiv=1)
    f = np.concatenate([f, f[:12]])          # 12 faces twice, higher ids
    twin = make_scene(v, f, np.zeros(len(f), np.int32),
                      make_materials([dict(albedo=(0.5,) * 3)]),
                      make_lights([]))
    up = atrium_up_rays()
    for name, sc_h in (("edge_cornell_mesh_4", o_scene_h),
                       ("edge_cornell_spheres", cornell.cornell("spheres")),
                       ("edge_coincident_triangles", twin),
                       ("edge_sphere_only_leaves", sphere_grid_scene()),
                       ("edge_atrium_coplanar",
                        meshes.atrium_scene(col_rad=16, col_ny=6))):
        coplanar = name == "edge_atrium_coplanar"
        fb_h = sah.build_bvh(sc_h)
        fb_e, sc_e = fb_h.to(DEV), sc_h.to(DEV)
        rows_e = flat.row_tables(fb_e, sc_e)
        # Appended rays: the atrium's upward ones, the sphere solve's edge
        # rays on the spheres and at the Cornell mesh's radius-0
        # placeholder.
        extra = {"edge_atrium_coplanar": up,
                 "edge_cornell_spheres": sphere_edge_rays(),
                 "edge_cornell_mesh_4": sphere_edge_rays(("placeholder",))
                 }.get(name)
        args = flat_args(fb_e, sc_e, *flat_edge_rays(fb_h, 3000, 37, extra))
        for form in (False, True):
            res, _, _ = compare_flat(args, rows_e, name, form)
            assert res["hits"] > 0, f"flat_walk {name}: no hit"
            cases.append(res)
        if name in ("edge_cornell_spheres", "edge_sphere_only_leaves"):
            assert res["prims_sph"] > 0, f"{name}: no sphere tested"
        if coplanar:
            # The upward rays (the last ones) against brute force.
            ro_u, rd_u = (x[-len(up[0]):] for x in args[10:12])

            def flat_of(t_max):
                return flat_args(fb_e, sc_e, ro_u, rd_u,
                                 torch.zeros_like(t_max), t_max)

            res["vs_brute"] = hold_to_brute(
                "flat_walk " + name,
                lambda t_max: flat_walk_ref(*flat_of(t_max)),
                lambda t_max: [flat_walk(*flat_of(t_max), any_hit=True,
                                         design=d, rows=rows_e)
                               for d in FLAT_DESIGNS])
    c = torch.from_numpy(v[f[:12]].mean(axis=1)).float()
    fb_t, twin_d = sah.build_bvh(twin).to(DEV), twin.to(DEV)
    args = flat_args(fb_t, twin_d, (c * 3.0).to(DEV),
                     (-c / c.norm(dim=1, keepdim=True)).to(DEV),
                     torch.zeros(12, device=DEV),
                     torch.full((12,), 1e30, device=DEV))
    res, _, (t, g, _, _) = compare_flat(
        args, flat.row_tables(fb_t, twin_d), "coincident_lowest_id", False)
    assert bool((t < INF).all()) and g.tolist() == list(range(12)), \
        "flat_walk coincident triangles: not the lowest id"
    cases.append(res)
    return cases


def check_flat_walk(o_scene_h, o_cam, o_cfg, rows_c, rows_a, flush,
                    edges=True):
    """The flat walk kernel in both designs (rows, thread) against its
    plain version and against each other, bitwise, closest and any hit:
    (a) walk batches of the full-size oracle render of ``o_scene_h`` (R =
    131,072): its first chunk's camera rays and their shadow rays (the
    direct-lighting batches ``oracle_chunk_rays`` takes), chunk 12's camera
    rays (the mesh) and chunk 0's first bounce, closest and shadow (the
    whole integrator), each timed in both designs one after the other (the
    chunk-0 batches also in the plain version);
    (b) edge cases on five scenes (:func:`flat_walk_edge_cases`, where
    ``edges``): axis-parallel directions, origins on box faces, t_max -1
    and 0.5, coincident triangles (the lowest id must win), leaves of
    spheres only, the reduced atrium's coplanar faces; (c) a batch where
    nothing walks.  Returns (cases, timing)."""
    cases, timing = [], {}
    fb = sah.build_bvh(o_scene_h).to(DEV)
    sc = o_scene_h.to(DEV)
    rows = flat.row_tables(fb, sc)
    later = {}
    for chunk, picks in ((0, ("closest_1", "shadow_1")), (12, ("closest_0",))):
        for name, ro, rd, t_min, t_max, any_hit in flat_chains.chunk_batches(
                sc, o_cam, o_cfg, (0, 0), fb, chunk):
            if name in picks:
                later[chunk, name] = (ro, rd, t_min, t_max, any_hit)
    batches = [("flat_walk", "oracle_chunk_camera_rays", rows_c[:, 0:3],
                rows_c[:, 4:7], rows_c[:, 3], rows_c[:, 7], False),
               ("flat_walk@oracle_chunk_shadow", "oracle_chunk_shadow_rays",
                rows_a[:, 0:3], rows_a[:, 4:7], rows_a[:, 3], rows_a[:, 7],
                True),
               ("flat_walk@chunk12_camera", "chunk12_camera_rays",
                *later[12, "closest_0"]),
               ("flat_walk@bounce_closest", "chunk0_bounce1_closest",
                *later[0, "closest_1"]),
               ("flat_walk@bounce_shadow", "chunk0_bounce1_shadow",
                *later[0, "shadow_1"])]
    del later
    for key, name, ro, rd, t_min, t_max, any_hit in batches:
        args = flat_args(fb, sc, ro, rd, t_min, t_max)
        for form in (False, True):
            res, stats, _ = compare_flat(args, rows, name, form)
            cases.append(res)
            if form != any_hit:
                continue
            R = int(ro.shape[0])
            work = {d: flat_work(stats, R, form, sc.tri_idx, d)
                    for d in FLAT_DESIGNS}
            shape = {"R": R, "walking_rays": res["walking_rays"],
                     "any_hit": form, "n_nodes": fb.n_nodes,
                     **{k: res[k] for k in (
                         "max_steps", "lane_efficiency", "max_leaves",
                         "max_chain_thread", "max_chain_rows")},
                     "mean_steps": round(res["mean_steps"], 3),
                     "mean_leaves": round(res["mean_leaves"], 3),
                     "plain_iterations": res["plain_iterations"],
                     "prims": stats["prims_tri"] + stats["prims_sph"]}
            # The batch's longest ray (most node steps + leaves) walked
            # alone, in each design: how much of the batch's time is the
            # chain of that one ray.
            top = int(torch.argmax(stats["steps"] + stats["leaves"]))
            one = flat_args(fb, sc, *(x[top:top + 1] for x in args[10:14]))
            for d in FLAT_DESIGNS:
                shape[f"longest_ray_{d}_us"] = trace_launches(
                    lambda: flat_walk(*one, any_hit=form, design=d,
                                      rows=rows), flush, FLAT_KERNEL[d])[0]
            # Both designs on the same operands, one after the other, each
            # with its own least bytes and operations.
            for d in FLAT_DESIGNS:
                n_bytes, ops, traffic = work[d]
                timing[key if d == "rows" else key.replace(
                    "flat_walk", "flat_walk_thread", 1)] = dict(
                    shape=dict(shape, least_MB=round(n_bytes / 1e6, 4),
                               traffic_MB=round(traffic / 1e6, 4)),
                    **time_both(lambda: flat_walk(*args, any_hit=form,
                                                  design=d, rows=rows),
                                flush, FLAT_KERNEL[d]),
                    bytes=n_bytes, flops=ops)
            if key in ("flat_walk", "flat_walk@oracle_chunk_shadow"):
                # The plain version (the gather form) ran on these operands
                # just before: timed on the chunk-0 batches, as before.
                timing[key]["plain_ms"] = time_launches(
                    lambda: flat_walk_ref(*args, any_hit=form), flush,
                    repeats=2, warmup=0)
    if edges:
        cases += flat_walk_edge_cases(o_scene_h)
    args = flat_args(fb, sc, rows_c[:, 0:3], rows_c[:, 4:7], rows_c[:, 3],
                     torch.full_like(rows_c[:, 7], -1.0))
    for form in (False, True):
        res, _, _ = compare_flat(args, rows, "nothing_walks", form)
        assert res["max_steps"] == 1 and res["hits"] == 0
        cases.append(res)
    return cases, timing


def compare_fetch(table, idx, clamp, label, form="fetch_rows"):
    """fetch_rows (or fetch_rows_t) against its plain version on the card:
    bitwise, no tolerance."""
    if form == "fetch_rows_t":
        out_k, out_r = fetch_rows_t(table, idx), fetch_rows_t_ref(table, idx)
    else:
        out_k = fetch_rows(table, idx, clamp=clamp)
        out_r = fetch_rows_ref(table, idx, clamp=clamp)
    sync()
    res = {"label": label, "form": form, "P": int(idx.numel()),
           "N": int(table.shape[0]), "W": int(table.shape[1]),
           "idx_dtype": str(idx.dtype).replace("torch.", ""),
           "idx_contiguous": idx.is_contiguous(), "clamp": clamp,
           "table_has_inf": bool(torch.isinf(table.float()).any()),
           "bitwise": probe.bitwise_equal(out_k, out_r),
           "max_abs_err": max_abs_diff(out_k, out_r)}
    assert res["bitwise"], f"{form} {label}: kernel differs from plain"
    return res


def compare_fields(table, cand, label):
    """fetch_fields against its plain version and against its twin on the
    descent, fetch_rows rearranged into planes: bitwise, no tolerance."""
    Q, K = cand.shape
    out_k = fetch_fields(table, cand)
    out_r = fetch_fields_ref(table, cand)
    rows = fetch_rows(table, cand, clamp=True).reshape(Q, K, 8, 8)
    twin = rows[:, :, :6].permute(2, 0, 1, 3).reshape(6, Q, K * 8)
    sync()
    res = {"label": label, "form": "fetch_fields", "Q": Q, "K": K,
           "N": int(table.shape[0]),
           "idx_dtype": str(cand.dtype).replace("torch.", ""),
           "idx_contiguous": cand.is_contiguous(),
           "table_has_inf": bool(torch.isinf(table.float()).any()),
           "bitwise": probe.bitwise_equal(out_k, out_r),
           "bitwise_vs_fetch_rows": probe.bitwise_equal(out_k, twin),
           "max_abs_err": max_abs_diff(out_k, out_r)}
    assert res["bitwise"], f"fetch_fields {label}: kernel differs from plain"
    assert res["bitwise_vs_fetch_rows"], \
        f"fetch_fields {label}: differs from fetch_rows rearranged"
    return res


def compare_take(x, idx, dim, reps, label):
    out_k, out_r = take_along(x, idx, dim, reps), take_along_ref(x, idx, dim,
                                                                reps)
    sync()
    M, N = x.shape
    res = {"label": label, "dim": dim, "M": M, "N": N, "reps": reps,
           "dtype": str(x.dtype).replace("torch.", ""),
           "form": take_along_form(M, N, dim),
           "bitwise": probe.bitwise_equal(out_k, out_r),
           "max_abs_err": max_abs_diff(out_k, out_r)}
    assert res["bitwise"], f"take_along {label}: kernel differs from plain"
    return res


def fetch_edge_tables(seed):
    """(label, table, idx) edge cases of the row fetch: indices below 0 and
    past the end (clamped), a one-row table, P not a multiple of a block, a
    table whose values are +/-inf, -0.0 and a NaN with a payload, W 512."""
    rs = np.random.RandomState(seed)
    bits = (rs.normal(size=(37, 64)).astype(np.float32).view(np.uint32)
            >> 16).astype(np.uint16)
    bits[0::5] = 0x7F80              # +inf
    bits[2::5, 3:6] = 0xFF80         # -inf
    bits[3, 7] = 0x8000              # -0.0
    bits[4, 9] = 0x7FC1              # NaN with a payload
    table = torch.from_numpy(bits.view(np.int16)).to(DEV).view(torch.bfloat16)
    raw = torch.from_numpy(rs.randint(-40, 80, 1001)).to(DEV)
    wide = probe.bf16_table(rs, 5, 512, DEV)
    return (("out_of_range_and_negative_clamped_P1001", table, raw),
            ("out_of_range_int32_clamped", table, raw.int()),
            ("one_row_table", table[:1].clone(), raw[:3]),
            ("w512_out_of_range_clamped", wide, raw[:129]))


def check_fetch(cb, batches, flush):
    """fetch_fields, fetch_rows, fetch_rows_t and take_along against their
    plain versions on the card, bitwise (fetch_fields also against
    fetch_rows rearranged): (a) every child fetch of the descent for the
    real batches (the level tables hold +/-inf in empty slots; int64
    candidates in the descent's own layout); (b) the three tools' full
    shapes, int32 indices; (c) edge cases.  Timed: fetch_fields and
    fetch_rows at the descent's fetches of the mid-render closest batch, one
    after the other, with what the descent ran before the row kernel
    (``table[clamp(cand)].float()``) and the row form's whole path
    (fetch_rows and the six field copies); fetch_rows_t at the tools' shapes,
    beside torch's gather + cast + transpose; take_along at the dyngather
    tool's (256, 128) f32 16-rep case and its largest, and at a shape whose
    lines are too long for shared memory (one launch a rep), beside one
    torch.gather a rep.  Returns (cases, timing)."""
    cases, timing = {"fetch_fields": [], "fetch_rows": [], "fetch_rows_t": [],
                     "take_along": []}, {}
    for label, (ro, rd, t_max) in batches.items():
        for level, table, cand in vmem_tool.descent_fetches(cb, ro, rd,
                                                            t_max):
            res = compare_fetch(table, cand, True, f"{label}_L{level}")
            assert res["table_has_inf"], res
            cases["fetch_rows"].append(res)
            cases["fetch_fields"].append(compare_fields(
                table, cand, f"{label}_L{level}"))
            if label != "mid_render":
                continue
            N, W = table.shape
            at = "" if level == len(cb.levels) - 1 else f"@descent_L{level}"
            Q, K = cand.shape

            def rows_path(table=table, cand=cand, Q=Q, K=K):
                blk = fetch_rows(table, cand, clamp=True).reshape(Q, K, 8, 8)
                return [blk[:, :, f, :].reshape(Q, K * 8) for f in range(6)]

            timing["fetch_fields" + at] = dict(
                shape={"P": int(cand.numel()), "Q": Q, "cap": K, "N": N,
                       "fields": 6, "idx": "int64, the descent's column slice"},
                **time_both(lambda: fetch_fields(table, cand), flush,
                            "fetch_fields_kernel"),
                plain_ms=time_launches(
                    lambda: fetch_fields_ref(table, cand), flush),
                twin_path_ms=time_launches(rows_path, flush),
                bytes=probe.fields_bytes(cand, N, 6), flops=0)
            timing["fetch_rows" + at] = dict(
                shape={"P": int(cand.numel()), "Q": int(cand.shape[0]),
                       "cap": int(cand.shape[1]), "N": N, "W": W,
                       "idx": "int64, the descent's column slice"},
                **time_both(lambda: fetch_rows(table, cand, clamp=True),
                            flush, "fetch_rows_kernel"),
                plain_ms=time_launches(
                    lambda: fetch_rows_ref(table, cand, clamp=True), flush),
                library_ms=time_launches(
                    lambda: table[torch.clamp(cand, 0, N - 1)].float(),
                    flush),
                bytes=probe.fetch_bytes(cand, N, W), flops=0)
    rs = np.random.RandomState(1)
    for case, per_ray, N in vmem_tool.SHAPES:
        table = probe.bf16_table(rs, N, 64, DEV)
        idx = probe.index(rs, N, (4096 * per_ray // 512 * 512,), DEV)
        cases["fetch_rows"].append(compare_fetch(table, idx, False,
                                                 f"tool_{case}"))
        cases["fetch_rows_t"].append(compare_fetch(
            table, idx, False, f"tool_{case}", form="fetch_rows_t"))
        timing["fetch_rows_t" if case == "L2" else f"fetch_rows_t@tool_{case}"] \
            = dict(shape={"P": int(idx.numel()), "N": N, "W": 64,
                          "idx": "int32"},
                   **time_both(lambda: fetch_rows_t(table, idx), flush,
                               "fetch_rows_t_kernel"),
                   plain_ms=time_launches(
                       lambda: fetch_rows_t_ref(table, idx), flush),
                   library_ms=time_launches(
                       lambda: table[idx].float().t().contiguous(), flush),
                   bytes=probe.fetch_bytes(idx, N, 64), flops=0)
    grouped = probe.bf16_table(rs, 1864, 64, DEV).reshape(233, 512)
    idx = probe.index(rs, 233, (4096 * 34 // 128 * 128,), DEV)
    cases["fetch_rows"].append(compare_fetch(grouped, idx, False,
                                             "tool_grouped_W512"))
    for label, table, idx in fetch_edge_tables(7):
        cases["fetch_rows"].append(compare_fetch(table, idx, True,
                                                 "edge_" + label))
        if table.shape[1] == 64:
            # (Q, K) candidates, contiguous and as a strided column slice.
            K = 3 if idx.numel() % 7 else 7
            cand = idx.reshape(-1, K)
            buf = torch.zeros((cand.shape[0], K + 2), dtype=idx.dtype,
                              device=DEV)
            buf[:, 1:K + 1] = cand
            for c, how in ((cand, ""), (buf[:, 1:K + 1], "_strided")):
                cases["fetch_fields"].append(compare_fields(
                    table, c, "edge_" + label + how))
        cases["fetch_rows_t"].append(compare_fetch(
            table, torch.clamp(idx, 0, table.shape[0] - 1), False,
            "edge_" + label, form="fetch_rows_t"))
    for dim, M, N, reps, dtype in dyngather_tool.CASES:
        x, ix = dyngather_tool.inputs(dim, M, N, dtype, 0, DEV)
        cases["take_along"].append(compare_take(
            x, ix, dim, reps, f"tool_dim{dim}_{M}x{N}"))
    for dim, M, N, reps, dtype in ((1, 7, 33, 3, torch.bfloat16),
                                   (0, 1, 1, 2, torch.int32),
                                   (0, 300, 200, 5, torch.float32),
                                   (0, 4096, 3, 2, torch.float32),
                                   (1, 3, 5000, 4, torch.bfloat16)):
        x, ix = dyngather_tool.inputs(dim, M, N, dtype, 5, DEV)
        cases["take_along"].append(compare_take(x, ix, dim, reps,
                                                f"edge_{M}x{N}_x{reps}"))
    for key, (dim, M, N) in (("take_along", (0, 256, 128)),
                             ("take_along@dim1_256x2048", (1, 256, 2048)),
                             ("take_along@passes_dim1_64x8192",
                              (1, 64, 8192))):
        x, ix = dyngather_tool.inputs(dim, M, N, torch.float32, 0, DEV)
        ixl = ix.long()

        def library(x=x, ixl=ixl, dim=dim):
            y = x
            for _ in range(16):
                y = torch.gather(y, dim, ixl)
            return y

        form = take_along_form(M, N, dim)
        kern = (lambda x=x, ix=ix, dim=dim: take_along(x, ix, dim, 16))
        timing[key] = dict(
            shape={"M": M, "N": N, "dim": dim, "reps": 16,
                   "dtype": "float32", "form": form},
            **(time_both(kern, flush, "take_along_lines_kernel")
               if form == "lines" else {"ms": time_launches(kern, flush)}),
            plain_ms=time_launches(
                lambda x=x, ix=ix, dim=dim: take_along_ref(x, ix, dim, 16),
                flush),
            library_ms=time_launches(library, flush),
            bytes=M * N * (4 + 4 + 4), flops=0)
    return cases, timing


def phase_kernels(scene, cam, cb, cfg, key, pk):
    first, mid, shadow, mid_full, shadow_full = queue_batches(
        scene, cam, cb, cfg, key, 4096, n_warm=N_WARM)
    cases_k2, cases_k1, cases_k3, cases_dense = [], [], [], []
    cases_fused = []
    timing = {}
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    # The closest-hit traversal's budget (pair_mults[2], gid carried) and
    # the steady-state any-hit traversal's (pair_mults[3], gid = 0).
    for label, (ro, rd, t_max), mult, with_gid in (
            ("first_wave", first, cb.pair_mults[2], True),
            ("mid_render", mid, cb.pair_mults[2], True),
            ("mid_render_shadow_narrow", shadow, cb.pair_mults[3], False)):
        cid, rays, cnt, right, cid_s, rays_s, fused = pair_inputs(
            cb, ro, rd, t_max, mult)
        res_f = compare_fused(cb, fused, label)
        cases_fused.append(res_f)
        # The fused kernel at this batch in the form the traversal uses
        # there; first_wave (long segments) is timed too, for its tail.
        ops = fused_ops(cb.tiles, cb.tile_gid, fused)
        Qf, Lf = int(fused["cnt"].shape[0]), cb.tiles.shape[2]
        timing["pair_ray_reduce" + {"first_wave": "@first_wave",
                                    "mid_render": "",
                                    "mid_render_shadow_narrow":
                                        "@shadow_narrow"}[label]] = dict(
            shape={"P": res_f["pairs"], "Q": Qf, "L": Lf,
                   "live_pairs": res_f["live_pairs"],
                   "live_tiles": res_f["live_tiles"],
                   "max_pairs_of_a_ray": res_f["max_pairs_of_a_ray"],
                   "any_hit": not with_gid},
            **time_both(lambda: pair_ray_reduce(*ops, any_hit=not with_gid),
                        flush, "pair_major_kernel"),
            plain_ms=time_launches(
                lambda: pair_ray_reduce_ref(*ops, any_hit=not with_gid),
                flush, repeats=10),
            bytes=fused_bytes(res_f["live_tiles"], res_f["live_pairs"],
                              Qf, Lf, not with_gid),
            flops=res_f["live_pairs"] * Lf * 100)
        res, out = compare_k2(cb.tiles, cid, rays, label)
        if label != "first_wave":
            res3 = compare_k3(cb.tiles, cid_s, rays_s, label)
            assert res3["sorted"] and res3["live_pairs"] > 0
            cases_k3.append(res3)
            P3, L3 = int(cid_s.shape[0]), cb.tiles.shape[2]
            tm3 = dict(
                shape={"P": P3, "L": L3, "live_pairs": res3["live_pairs"],
                       "live_tiles": res3["live_tiles"],
                       "tile_fetches": res3["tile_fetches"]},
                **time_both(
                    lambda: pair_tile_isect_dedup(cb.tiles, cid_s, rays_s),
                    flush, "pair_tile_isect_dedup_kernel"),
                plain_ms=time_launches(
                    lambda: pair_tile_isect_dedup_ref(cb.tiles, cid_s, rays_s),
                    flush),
                bytes=pair_kernel_bytes(res3["live_tiles"], P3, L3),
                flops=res3["live_pairs"] * L3 * 100)
            timing["pair_tile_isect_dedup" if label == "mid_render"
                   else "pair_tile_isect_dedup@shadow_narrow"] = tm3
        live_cid = cid[rays[:, 8] > 0]
        res["live_pairs"] = int(live_cid.numel())
        res["live_tiles"] = int(live_cid.unique().numel())
        assert res["live_pairs"] > 0, f"{label}: no live pair in the batch"
        cases_k2.append(res)
        t_p = out[:, 0].contiguous()
        u_p, v_p = out[:, 2].contiguous(), out[:, 3].contiguous()
        lane = out[:, 1].long().clamp(0, 127)
        g_p = cb.tile_gid[cid.long(), lane].contiguous()
        if not with_gid:
            g_p = torch.zeros_like(g_p)
        cases_k1.append(compare_k1(t_p, g_p, u_p, v_p, cnt, right, label))
        if label == "mid_render":      # the heavier, mixed-depth batch
            P, Q = int(cid.shape[0]), int(cnt.shape[0])
            L = cb.tiles.shape[2]
            live = res["live_pairs"]
            k2_bytes = pair_kernel_bytes(res["live_tiles"], P, L)
            k2_flops = live * L * 100    # ~100 FP32 operations per lane
            k1_bytes = int(cnt.sum()) * 16 + Q * 8 + Q * 16
            k1_ops = int(cnt.sum()) * 3
            timing["pair_tile_isect"] = dict(
                shape={"P": P, "L": L, "live_pairs": live,
                       "live_tiles": res["live_tiles"],
                       "tiles_MB": round(cb.tiles.numel() * 4 / 1e6, 1)},
                **time_both(lambda: pair_tile_isect(cb.tiles, cid, rays),
                            flush, "pair_tile_isect_kernel"),
                plain_ms=time_launches(
                    lambda: pair_tile_isect_ref(cb.tiles, cid, rays), flush),
                bytes=k2_bytes, flops=k2_flops)
            timing["pair_segmin"] = dict(
                shape={"P": P, "Q": Q, "live_pairs": int(cnt.sum())},
                **time_both(
                    lambda: pair_segmin(t_p, g_p, u_p, v_p, cnt, right), flush,
                    "pair_segmin_kernel"),
                plain_ms=time_launches(
                    lambda: pair_segmin_ref(t_p, g_p, u_p, v_p, cnt, right),
                    flush, repeats=20),
                bytes=k1_bytes, flops=k1_ops)
            # What either way of timing reports for a kernel that does
            # nothing, on the fused kernel's grid (a few blocks an SM) and
            # on the pair-tile kernel's (a block per pair slot).
            floors = {}
            for what, blocks in (("grid_of_pair_ray_reduce",
                                  min(-(-P // 4),
                                      pair_fused.pair_grid_blocks(DEV))),
                                 ("grid_of_pair_tile_isect", P)):
                both = time_both(lambda: launch_floor(blocks), flush,
                                 "launch_floor_kernel")
                floors[what] = {"blocks": blocks, "threads": 128,
                                "events_us": round(both["ms"] * 1e3, 2),
                                "trace_us": both["trace_us"],
                                "trace_n": both["trace_n"],
                                "trace_warm_us": both["trace_warm_us"],
                                "trace_warm_n": both["trace_warm_n"]}
    for L_e in (128, 32):
        cases_fused.append(check_fused_edge_case(L_e))
    cases_modes, timing_modes = check_mode_batches(cb, mid_full, flush)
    timing.update(timing_modes)
    sync()
    assert pair_fused._counters and all(
        not bool(c.any()) for c in pair_fused._counters.values()), \
        "pair_ray_reduce left a per-ray counter above zero"
    tiles_e, cid_e, rays_e = k2_edge_case()
    res, _ = compare_k2(tiles_e, cid_e, rays_e, "edge_sphere_pad_tie_dead")
    assert res["hits"] > 0
    cases_k2.append(res)
    cases_k1.append(compare_k1(*k1_edge_case(), "edge_empty_long_tie_nan"))
    res3 = compare_k3(*k3_edge_case(),
                      "edge_one_id_every_pair_straddle_dead_block")
    assert res3["hits"] > 0
    cases_k3.append(res3)
    for label, tiles_g, cid_g, rays_g in k3_grid_edge_cases():
        res3 = compare_k3(tiles_g, cid_g, rays_g, "edge_" + label)
        assert res3["hits"] > 0
        cases_k3.append(res3)

    # The dense kernels: two Cornell scenes, a full and a ragged ray count.
    dense_scenes = {"cornell_spheres": cornell.cornell("spheres"),
                    "cornell_mesh_4": cornell.cornell("mesh", mesh_subdiv=4)}
    for name, scene_h in dense_scenes.items():
        ps = PallasScene(scene_h).to(DEV)
        for n in (4096, 300):
            res, _ = compare_dense(box_rays(n, 17 + n, 1e30), ps.prims,
                                   f"{name}_{n}_rays")
            assert res["hits"] > n // 2
            cases_dense.append(res)
            res, _ = compare_dense(box_rays(n, 19 + n, 0.7), ps.prims,
                                   f"{name}_{n}_rays_t_max_0.7")
            assert 0 < res["hits"] < n
            cases_dense.append(res)
    rows_e, prims_e = dense_edge_case()
    res, out_e = compare_dense(rows_e, prims_e, "edge_tie_sphere_pad_dead_ray")
    assert out_e[3].tolist() == [5, 5, 0, 140, 0], out_e[3].tolist()
    assert (out_e[0] < INF).tolist() == [True, True, False, True, False]
    assert out_e[1][3].item() == 0.0 and out_e[2][3].item() == 0.0  # sphere u, v
    cases_dense.append(res)
    # Every kernel that tests spheres, on the sphere solve's edge rays:
    # bitwise against its plain version (K2 with no fallback tolerance).
    for label, cb_e, ops, rows_s, prims_s in sphere_edge_pairs():
        cid_p, rays_p, _, _, cid_s, rays_s, fused_s = ops
        cases_fused.append(compare_fused(cb_e, fused_s, label))
        res, _ = compare_k2(cb_e.tiles, cid_p, rays_p, label)
        assert res["bitwise"], f"K2 {label}: not bitwise"
        cases_k2.append(res)
        cases_k3.append(compare_k3(cb_e.tiles, cid_s, rays_s, label))
        res, _ = compare_dense(rows_s, prims_s, label)
        assert res["hits"] > 0, f"dense {label}: no hit"
        cases_dense.append(res)

    # Time them on one chunk of the full-size oracle render (R = 131,072).
    o_scene_h = dense_scenes["cornell_mesh_4"]
    o_cfg = RenderConfig(width=512, height=512, spp=16, max_depth=4)
    ps = PallasScene(o_scene_h).to(DEV)
    o_cam = cornell.camera(512, 512).to(DEV)
    rows_c, rows_a = oracle_chunk_rays(o_scene_h.to(DEV), o_cam, ps, o_cfg,
                                       (0, 0))
    res, _ = compare_dense(rows_c, ps.prims, "oracle_chunk_camera_rays")
    cases_dense.append(res)
    res, _ = compare_dense(rows_a, ps.prims, "oracle_chunk_shadow_rays")
    cases_dense.append(res)
    R, P = int(rows_c.shape[0]), int(ps.prims.shape[0])
    n_sph = int((ps.prims[:, 10] > 0.5).sum())
    row_ops = (P - n_sph) * OPS_TRI_ROW + n_sph * OPS_SPH_ROW
    n_occ = int((dense_anyhit(rows_a, ps.prims) > 0.5).sum())
    dense_bytes = R * 8 * 4 + P * 16 * 4
    timing["dense_closest"] = dict(
        shape={"R": R, "P": P, "sphere_rows": n_sph},
        ms=time_launches(lambda: dense_closest(rows_c, ps.prims), flush),
        plain_ms=time_launches(lambda: closest_ref(rows_c, ps.prims), flush,
                               repeats=5),
        bytes=dense_bytes + R * 16, flops=R * (row_ops + P * OPS_CLOSEST))
    # Any hit: a ray that is not occluded must meet every row; an occluded
    # one needs the one row that hits it.
    timing["dense_anyhit"] = dict(
        shape={"R": R, "P": P, "sphere_rows": n_sph, "occluded_rays": n_occ},
        ms=time_launches(lambda: dense_anyhit(rows_a, ps.prims), flush),
        plain_ms=time_launches(lambda: anyhit_ref(rows_a, ps.prims), flush,
                               repeats=5),
        bytes=dense_bytes + R * 4,
        flops=(R - n_occ) * (row_ops + P * OPS_ANYHIT)
        + n_occ * (OPS_TRI_ROW + OPS_ANYHIT))
    cases_walk, timing_walk, n_over = check_packed_walk(
        scene, cb, pk, mid, mid_full, shadow_full, flush)
    timing.update(timing_walk)
    cases_flat, timing_flat = check_flat_walk(
        o_scene_h, o_cam, o_cfg, rows_c, rows_a, flush)
    timing.update(timing_flat)
    cases_fetch, timing_fetch = check_fetch(
        cb, {"first_wave": first, "mid_render": mid,
             "mid_render_shadow_narrow": shadow}, flush)
    timing.update(timing_fetch)
    del flush
    k2_bitwise = all(c["bitwise"] for c in cases_k2)
    emit({"phase": "kernels",
          "checked": ["pair_ray_reduce", "pair_tile_isect", "pair_segmin",
                      "pair_tile_isect_dedup", "dense_closest",
                      "dense_anyhit", "packed_walk", "flat_walk",
                      "fetch_fields", "fetch_rows", "fetch_rows_t",
                      "take_along"],
          "fetch_fields_fetch_rows_fetch_rows_t_take_along": {
              "tolerance": "bitwise (raw bits, NaN payloads included), "
                           "against the plain versions on the card; "
                           "fetch_fields also against fetch_rows "
                           "rearranged into planes",
              "cases": cases_fetch},
          "flat_walk": {
              "tolerance": "bitwise (raw 32-bit words), closest-hit and "
                           "any-hit form, both designs (rows, thread) "
                           "against the plain version and against each "
                           "other on the card",
              "cases": cases_flat},
          "flat_walk_rows_kernel": {
              form: rows_kernel_attrs(any_hit)
              for form, any_hit in (("closest", False), ("any_hit", True))},
          "packed_walk": {
              "tolerance": "bitwise (raw 32-bit words), closest-hit and "
                           "any-hit form, both designs (window, thread) "
                           "against the plain version and against each "
                           "other on the card",
              "overflowing_sub_batches_of_the_256_render": n_over,
              "cases": cases_walk},
          "pair_ray_reduce": {
              "tolerance": "bitwise, closest-hit and any-hit form, against "
                           "the plain version and against "
                           "pair_segmin(pair_tile_isect) on the card",
              "cases": cases_fused},
          "pair_ray_reduce_modes": {
              "tolerance": "bitwise, against the plain version and the "
                           "split twin's per-ray result (K2, then "
                           "_round_min or _seg_min; gid where there is a "
                           "hit in the pairs list), on the frontier and "
                           "pair-major walks' batches of the mid-render "
                           "queue; each walk fused == split",
              "cases": cases_modes},
          "launch_floor_us": floors,
          "pair_tile_isect_dedup": {
              "tolerance": "bitwise, against the plain version and against "
                           "pair_tile_isect on the same rows",
              "cases": cases_k3},
          "dense_closest_and_dense_anyhit": {"tolerance": "bitwise",
                                             "cases": cases_dense},
          "pair_tile_isect": {
              "tolerance": "bitwise" if k2_bitwise else
              "t rtol 1e-6 atol 1e-6, hit mask equal, lane equal where t "
              "bitwise equal and on > 0.99 of hits",
              "cases": cases_k2},
          "pair_segmin": {"tolerance": "bitwise", "cases": cases_k1},
          "timing_protocol": "kernel / plain: median of single launches "
                             "between CUDA events, L2 "
                             "overwritten before each; trace: median kernel "
                             "duration under torch.profiler over the same "
                             "launches (trace_warm: L2 not overwritten); "
                             "pair kernels at the "
                             f"closest-hit sub-batch after {N_WARM} steps "
                             "(and the narrow shadow batch), dense kernels "
                             "at the first chunk of the 512x512 spp 16 "
                             "oracle render of cornell mesh, packed_walk at "
                             f"the whole 4096-lane queue after {N_WARM} "
                             "steps (and its shadow batch) and at the first "
                             "overflowing sub-batches of the 256² render, "
                             "its two designs one after the other, "
                             "flat_walk at the first chunk of the oracle "
                             "render of cornell mesh (camera rays and their "
                             "shadow rays), at chunk 12's camera rays and "
                             "at chunk 0's first bounce (closest, shadow), "
                             "its two designs one after the other (plain "
                             "versions of the walks: median of 2 calls), "
                             "fetch_fields "
                             "and fetch_rows one after the other at the "
                             "descent's two child fetches of the mid-render "
                             "closest batch (fetch_rows' library: "
                             "table[clamp(cand)].float(), what the descent "
                             "ran before it; fetch_fields' twin path: "
                             "fetch_rows and the six field copies), "
                             "fetch_rows_t at the fetch tools' "
                             "shapes, take_along at the dyngather tool's "
                             "(256, 128) f32 and (256, 2048) f32 16-rep "
                             "cases and at (64, 8192) f32 (library: one "
                             "torch.gather a rep)",
          "us_per_launch": {
              k: {"kernel": round(v["ms"] * 1e3, 2),
                  **({"trace": v["trace_us"], "trace_n": v["trace_n"],
                      "trace_warm": v["trace_warm_us"],
                      "trace_warm_n": v["trace_warm_n"]}
                     if "trace_us" in v else {}),
                  **({"plain": round(v["plain_ms"] * 1e3, 2)}
                     if "plain_ms" in v else {}),
                  **({"library": round(v["library_ms"] * 1e3, 2)}
                     if "library_ms" in v else {}),
                  **({"twin_path": round(v["twin_path_ms"] * 1e3, 2)}
                     if "twin_path_ms" in v else {}),
                  **({"path": round(v["path_ms"] * 1e3, 2)}
                     if "path_ms" in v else {}),
                  **v["shape"]}
              for k, v in timing.items()}})
    errs = {"pair_ray_reduce": max(c["max_abs_err"] for c in cases_fused),
            "pair_tile_isect": max(max(c["max_abs_err_t"], c["max_abs_err_uv"])
                                   for c in cases_k2),
            "pair_segmin": max(c["max_abs_err"] for c in cases_k1),
            "pair_tile_isect_dedup": max(c["max_abs_err"] for c in cases_k3),
            "dense_closest": max(c["max_abs_err"] for c in cases_dense),
            "dense_anyhit": max(c["max_abs_err_occ"] for c in cases_dense),
            "packed_walk": max(c["max_abs_err"] for c in cases_walk),
            "flat_walk": max(c["max_abs_err"] for c in cases_flat),
            **{k: max(c["max_abs_err"] for c in v)
               for k, v in cases_fetch.items()}}
    timing["launch_floor_us"] = floors["grid_of_pair_ray_reduce"]
    return timing, errs, mid


# --------------------------------------------------------------------------
# Phase 4 — the ported fetch probes
# --------------------------------------------------------------------------

def phase_walks(scene, cam, cb, cfg, pk, fp32_ops_per_s):
    """``--walks``: the A/B mode, for comparing two trees of the port inside
    one call (copy this script into the other checkout and run it there
    too; it uses only functions that earlier checkouts have): the times of
    every kernel that tests primitives, without the other phases.  Both
    designs of each walk on the kernels phase's batches (check_packed_walk
    and check_flat_walk without their edge cases: each batch held bitwise
    to the plain version and timed), on the reduced atrium's 20,000 upward
    rays (:func:`atrium_up_rays`), and the walks of the full-size oracle
    renders of the Cornell mesh and spheres in each design
    (flat_render_walks: each the render's image bit for bit); the
    pair kernels (trace and warm medians, as the kernels phase takes them)
    on the mid-render closest-hit batch and the narrow shadow batch; the
    dense kernels (events) on the oracle chunk.  One JSON line: the
    package's path, each batch's times and counts, the render's summed
    walk times."""
    import tpu_pt_torch

    _, mid, shadow, mid_full, shadow_full = queue_batches(
        scene, cam, cb, cfg, (0, 3), 4096, N_WARM)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    _, timing, _ = check_packed_walk(scene, cb, pk, mid, mid_full,
                                     shadow_full, flush, edges=False)
    for name, (ro, rd, t_max), mult, closest in (
            ("mid", mid, cb.pair_mults[2], True),
            ("shadow", shadow, cb.pair_mults[3], False)):
        cid, rays, _, _, cid_s, rays_s, fused = pair_inputs(
            cb, ro, rd, t_max, mult)
        ops = fused_ops(cb.tiles, cb.tile_gid, fused)
        timing[f"pair_ray_reduce@{name}"] = time_both(
            lambda: pair_ray_reduce(*ops, any_hit=not closest), flush,
            "pair_major_kernel")
        timing[f"pair_tile_isect@{name}"] = time_both(
            lambda: pair_tile_isect(cb.tiles, cid, rays), flush,
            "pair_tile_isect_kernel")
        timing[f"pair_tile_isect_dedup@{name}"] = time_both(
            lambda: pair_tile_isect_dedup(cb.tiles, cid_s, rays_s), flush,
            "pair_tile_isect_dedup_kernel")
    o_scene_h = cornell.cornell("mesh", mesh_subdiv=4)
    o_cfg = RenderConfig(width=512, height=512, spp=16, max_depth=4)
    o_scene, o_cam = o_scene_h.to(DEV), cornell.camera(512, 512).to(DEV)
    ps = PallasScene(o_scene_h).to(DEV)
    rows_c, rows_a = oracle_chunk_rays(o_scene, o_cam, ps, o_cfg, (0, 0))
    timing["dense_closest@oracle_chunk"] = {"ms": time_launches(
        lambda: dense_closest(rows_c, ps.prims), flush)}
    timing["dense_anyhit@oracle_chunk"] = {"ms": time_launches(
        lambda: dense_anyhit(rows_a, ps.prims), flush)}
    timing.update(check_flat_walk(o_scene_h, o_cam, o_cfg, rows_c, rows_a,
                                  flush, edges=False)[1])
    # Both walks, both designs, on the reduced atrium's upward rays (the
    # coplanar case), closest hit.
    atrium = meshes.atrium_scene(col_rad=16, col_ny=6)
    ro, rd = (torch.from_numpy(x).to(DEV) for x in atrium_up_rays())
    t_min = torch.zeros((ro.shape[0],), device=DEV)
    t_max = torch.full_like(t_min, 1e30)
    args = walk_args(native.build_packed(atrium).to(DEV), ro, rd, t_min,
                     t_max)
    for d in WALK_DESIGNS:
        timing[("packed_walk" if d == "window" else "packed_walk_thread")
               + "@atrium_up"] = time_both(
            lambda: packed_walk(*args, design=d), flush, WALK_KERNEL[d])
    fb_a, sc_a = sah.build_bvh(atrium).to(DEV), atrium.to(DEV)
    rows_up = flat.row_tables(fb_a, sc_a)
    args = flat_args(fb_a, sc_a, ro, rd, t_min, t_max)
    for d in FLAT_DESIGNS:
        timing[("flat_walk" if d == "rows" else "flat_walk_thread")
               + "@atrium_up"] = time_both(
            lambda: flat_walk(*args, design=d, rows=rows_up), flush,
            FLAT_KERNEL[d])
    del flush
    walks = {}
    for name, sc_h in (("cornell_mesh_4", o_scene_h),
                       ("cornell_spheres", cornell.cornell("spheres"))):
        fb, sc = sah.build_bvh(sc_h).to(DEV), sc_h.to(DEV)
        img = render(sc, o_cam, o_cfg, (0, 0), backend="bvh", bvh=fb,
                     device=DEV)
        walks[name] = flat_render_walks(sc, o_cam, o_cfg, (0, 0), fb, img,
                                        fp32_ops_per_s)
    emit({"phase": "walks", "package": os.path.dirname(tpu_pt_torch.__file__),
          "batches": {k: {**{f: v[f] for f in ("shape", "ms", "trace_us",
                                               "trace_n", "trace_warm_us")
                             if f in v},
                          **({"bound_us": max(
                              v["bytes"] / HBM_BYTES_PER_S,
                              v["flops"] / fp32_ops_per_s) * 1e6}
                             if "bytes" in v else {})}
                      for k, v in timing.items()},
          "walks_per_design": walks})


def phase_fetch_probes(cb, mid):
    """The three ported fetch probes (``tpu_pt_torch/tools/``) through their
    ``main()`` at the JAX tools' full shapes, on the card; the vmem-gather
    probe's descent case on the mid-render closest batch.  Each prints its
    own lines and raises where a kernel and its plain version differ.
    Returns the launches of fetch_rows, fetch_rows_t and take_along in this
    phase (no full-width render launches fetch_rows since the descent
    fetches fields)."""
    kernels = (fetch_rows, fetch_rows_t, take_along)
    zero_launches(kernels)
    t0 = time.time()
    lines = vmem_tool.main(["--device", "cuda"], descent=(cb, *mid))
    lines += fetch_tool.main(["--device", "cuda"])
    lines += dyngather_tool.main(["--device", "cuda"])
    sync()
    launches = read_launches(kernels)
    emit({"phase": "fetch_probes", "cases": len(lines),
          "all_exact": all(ln["exact"] for ln in lines),
          "wall_s": round(time.time() - t0, 2), "launches": launches,
          "timing": "each case: a CUDA graph of 30 calls, best of three "
                    "replays, kernel and torch counterpart"})
    assert all(ln["exact"] and ln["timed"] for ln in lines)
    assert all(launches.values()), launches
    return launches


# --------------------------------------------------------------------------
# Phase 5 — traversal against the brute-force oracle
# --------------------------------------------------------------------------

def phase_traverse():
    out = []
    for name, scene_h, kw in (("cornell_spheres", cornell.cornell("spheres"), {}),
                              ("big_scene_4", meshes.big_scene(4),
                               dict(tile=64))):
        cb = cluster.build_cluster_bvh(scene_h, **kw).to(DEV)
        scene = scene_h.to(DEV)
        g = torch.Generator().manual_seed(7)
        n = 4096
        ro = (torch.rand((n, 3), generator=g) * 6 - 3).to(DEV)
        rd = torch.randn((n, 3), generator=g)
        rd = (rd / rd.norm(dim=1, keepdim=True)).to(DEV)
        tmin = torch.zeros((n, 1), device=DEV)
        tmax = torch.full((n, 1), 1e30, device=DEV)
        h_ref = brute.intersect(scene, ro, rd, tmin, tmax)
        h_cl, ovf = cluster.intersect_counted(cb, scene, ro, rd, tmin, tmax)
        assert bool(torch.equal(h_ref.hit, h_cl.hit)), f"{name}: hit mask"
        m = h_ref.hit[:, 0]
        assert torch.allclose(h_ref.t[m], h_cl.t[m], rtol=1e-5, atol=1e-6), \
            f"{name}: t"
        t_same = (h_ref.t[:, 0] == h_cl.t[:, 0])[m]
        prim_eq = (h_ref.prim == h_cl.prim)[m]
        assert bool(prim_eq[t_same].all()), f"{name}: prim where t equal"
        assert float(prim_eq.float().mean()) > 0.999, f"{name}: prim agreement"
        tmax2 = torch.full((n, 1), 2.0, device=DEV)
        o_ref = brute.occluded(scene, ro, rd, tmax2)
        o_cl, ovf2 = cluster.occluded_counted(cb, scene, ro, rd, tmax2)
        assert bool(torch.equal(o_ref, o_cl)), f"{name}: occlusion"
        assert int(ovf) == 0 and int(ovf2) == 0, f"{name}: overflow"
        # The default above is the one-kernel pair stage; the two-kernel
        # stage must give the same bits.
        h_sp, ovf_s = cluster.intersect_counted(cb, scene, ro, rd, tmin, tmax,
                                                pair_stage="split")
        o_sp, ovf_s2 = cluster.occluded_counted(cb, scene, ro, rd, tmax2,
                                                pair_stage="split")
        assert int(ovf_s) == 0 and int(ovf_s2) == 0, f"{name}: split overflow"
        for fld in ("hit", "t", "prim", "u", "v"):
            assert bool(torch.equal(getattr(h_cl, fld), getattr(h_sp, fld))), \
                f"{name}: {fld} of the fused and the split pair stage differ"
        assert bool(torch.equal(o_cl, o_sp)), f"{name}: split occlusion"
        # The fused kernel's checked form on one sub-batch of these rays:
        # what the kernel relies on holds for the traversal's pair list, and
        # the launch leaves its per-ray counters at zero.
        k = cluster._split_batches(n, cluster.SPLIT_CLOSEST)
        ro_s, rd_s = ro[0::k].contiguous(), rd[0::k].contiguous()
        Qs = ro_s.shape[0]
        lo_s, hi_s = tmin[0::k, 0].contiguous(), tmax[0::k, 0].contiguous()
        cand, live, _ = cluster._descend_compact(cb, ro_s, 1.0 / rd_s,
                                                 lo_s[:, None], hi_s[:, None])
        _, cidP, dropped, cnt, right, _ = cluster._flat_pairs(
            cand, live, Qs, cb.pair_mults[2] * Qs)
        ops = (cb.tiles, cb.tile_gid, ro_s, rd_s, lo_s, hi_s, cidP, cnt, right)
        t_ck = pair_ray_reduce_checked(*ops)[0]
        occ_ck = pair_ray_reduce_checked(*ops, any_hit=True)
        assert int(dropped) == 0, f"{name}: checked sub-batch dropped pairs"
        assert bool(torch.equal(t_ck, h_cl.t[0::k, 0])), \
            f"{name}: checked form differs from the traversal's t"
        assert bool(torch.equal(occ_ck, h_cl.hit[0::k, 0])), \
            f"{name}: checked any-hit form differs from the hit mask"
        # The cluster-major pair stage (it takes 128-lane tiles): against
        # the brute oracle as above, with its own tie rule (prim agreement
        # > 0.96, the reference's allowance), and against the ray-major
        # stage on the same tree, where t is selected from the same pair
        # results and must be bitwise equal.
        cb_d = cb if cb.tiles.shape[2] == 128 else \
            cluster.build_cluster_bvh(scene_h).to(DEV)
        h_rm = cluster.intersect(cb_d, scene, ro, rd, tmin, tmax)
        h_dd, ovf3 = cluster.intersect_counted(cb_d, scene, ro, rd, tmin, tmax,
                                               pair_stage="dedup")
        o_dd, ovf4 = cluster.occluded_counted(cb_d, scene, ro, rd, tmax2,
                                              pair_stage="dedup")
        assert int(ovf3) == 0 and int(ovf4) == 0, f"{name}: dedup overflow"
        assert bool(torch.equal(h_ref.hit, h_dd.hit)), f"{name}: dedup hit mask"
        assert torch.allclose(h_ref.t[m], h_dd.t[m], rtol=1e-5, atol=1e-6), \
            f"{name}: dedup t"
        assert bool(torch.equal(h_rm.t, h_dd.t)), \
            f"{name}: dedup t differs from the ray-major stage"
        prim_dd = float((h_ref.prim == h_dd.prim)[m].float().mean())
        assert prim_dd > 0.96, f"{name}: dedup prim agreement"
        assert bool(torch.equal(o_ref, o_dd)), f"{name}: dedup occlusion"
        out.append({"scene": name, "rays": n, "hits": int(m.sum()),
                    "prim_agreement": float(prim_eq.float().mean()),
                    "occluded": int(o_ref.sum()),
                    "fused_equals_split_bitwise": True,
                    "fused_checked_form_passes": True,
                    "dedup": {"tile": 128, "hit_mask_equal": True,
                              "t_bitwise_equal_to_ray_major": True,
                              "prim_agreement": prim_dd,
                              "occluded_equal": True},
                    "modes": traverse_modes(cb, scene, ro, rd, tmin, tmax,
                                            tmax2, h_ref, o_ref, h_cl, o_cl,
                                            name)})
    emit({"phase": "traverse", "cases": out})


def traverse_modes(cb, scene, ro, rd, tmin, tmax, tmax2, h_ref, o_ref, h_cl,
                   o_cl, name):
    """The cluster BVH's "frontier" and "pairs" traversal modes on one of
    the traverse phase's scenes, each in both ray-major pair stages:
    against the brute oracle as the compact mode is held; at overflow 0
    bitwise the compact mode (hit and t on every ray, prim, u and v where
    it hits, occlusion), since all select (t, lowest gid) from the same
    tile test; "fused" and "split" bitwise each other (hit, t, u, v and
    occlusion on every ray, prim where it hits and, in "frontier", on every
    ray); the plain versions (``use_kernels=False``) of each stage the same
    bits; every pair batch through ``pair_ray_reduce`` and none through
    ``pair_tile_isect`` under "fused", the reverse under "split"; and the
    capacity tools (``candidate_stats``, ``pairs_stats``) at 0 overflow."""
    m = h_ref.hit[:, 0]
    res = {}
    kernels = (pair_tile_isect, pair_ray_reduce)
    for mode in ("frontier", "pairs"):
        cbm = cb._replace(traversal_mode=mode)
        got = {}
        for stage in cluster.MODE_PAIR_STAGES:
            zero_launches(kernels)
            h, ovf = cluster.intersect_counted(cbm, scene, ro, rd, tmin, tmax,
                                               pair_stage=stage)
            o, ovf_o = cluster.occluded_counted(cbm, scene, ro, rd, tmax2,
                                                pair_stage=stage)
            launches = read_launches(kernels)
            h_p, _ = cluster.intersect_counted(cbm, scene, ro, rd, tmin, tmax,
                                               use_kernels=False,
                                               pair_stage=stage)
            o_p, _ = cluster.occluded_counted(cbm, scene, ro, rd, tmax2,
                                              use_kernels=False,
                                              pair_stage=stage)
            label = f"{name} {mode} {stage}"
            used, unused = ("pair_ray_reduce", "pair_tile_isect") \
                if stage == "fused" else ("pair_tile_isect", "pair_ray_reduce")
            assert launches[used] > 0 and launches[unused] == 0, \
                (label, launches)
            assert bool(torch.equal(h_ref.hit, h.hit)), f"{label}: hit mask"
            assert torch.allclose(h_ref.t[m], h.t[m], rtol=1e-5, atol=1e-6), \
                f"{label}: t"
            t_same = (h_ref.t[:, 0] == h.t[:, 0])[m]
            prim_eq = (h_ref.prim == h.prim)[m]
            assert bool(prim_eq[t_same].all()), f"{label}: prim where t equal"
            assert float(prim_eq.float().mean()) > 0.999, f"{label}: prim"
            assert bool(torch.equal(o_ref, o)), f"{label}: occlusion"
            assert int(ovf) == 0 and int(ovf_o) == 0, f"{label}: overflow"
            for fld, a, b in (("hit", h.hit, h_cl.hit), ("t", h.t, h_cl.t),
                              ("prim", h.prim[m], h_cl.prim[m]),
                              ("u", h.u[m], h_cl.u[m]),
                              ("v", h.v[m], h_cl.v[m]),
                              ("occluded", o, o_cl)):
                assert bool(torch.equal(a, b)), f"{label}: {fld} vs compact"
            for fld, a, b in (("hit", h_p.hit, h.hit), ("t", h_p.t, h.t),
                              ("prim", h_p.prim[m], h.prim[m]),
                              ("u", h_p.u[m], h.u[m]),
                              ("v", h_p.v[m], h.v[m]),
                              ("occluded", o_p, o)):
                assert bool(torch.equal(a, b)), f"{label}: {fld} vs plain"
            got[stage] = (h, o)
            res[f"{mode}_{stage}"] = {
                "launches": launches, "overflow": [int(ovf), int(ovf_o)],
                "equals_compact_bitwise": True,
                "equals_plain_bitwise": True,
                "all_fields_equal_plain_on_misses_too": all(
                    bool(torch.equal(getattr(h_p, f), getattr(h, f)))
                    for f in ("prim", "u", "v"))}
        (h_f, o_f), (h_s, o_s) = got["fused"], got["split"]
        for fld in ("hit", "t", "u", "v"):
            assert bool(torch.equal(getattr(h_f, fld), getattr(h_s, fld))), \
                f"{name} {mode}: {fld} of fused and split differ"
        prim_all = bool(torch.equal(h_f.prim, h_s.prim))
        assert bool(torch.equal(h_f.prim[m], h_s.prim[m])) \
            and (prim_all or mode == "pairs"), f"{name} {mode}: prim"
        assert bool(torch.equal(o_f, o_s)), f"{name} {mode}: occlusion"
        res[f"{mode}_fused_equals_split"] = {
            "hit_t_u_v_occluded": True, "prim_where_hit": True,
            "prim_on_every_ray": prim_all}
    n_cand, ovf_c = cluster.candidate_stats(cb, ro, rd, tmin, tmax)
    n_live, dropped = cluster.pairs_stats(cb, ro, rd, tmin, tmax)
    assert int(ovf_c.sum()) == 0 and int(dropped) == 0, \
        f"{name}: candidate_stats {int(ovf_c.sum())}, pairs_stats {int(dropped)}"
    res["candidate_stats"] = {"mean_candidates": float(n_cand.float().mean()),
                              "overflow": int(ovf_c.sum())}
    res["pairs_stats"] = {"n_live": int(n_live), "dropped": int(dropped)}
    return res


# --------------------------------------------------------------------------
# Phases 6 and 7 — renders of the 1.3M-triangle scene
# --------------------------------------------------------------------------

def counts_close(a, b, what):
    """Equal, or within 0.1 %: one ULP in t can flip a grazing hit."""
    if a != b:
        assert abs(a - b) <= 1e-3 * max(a, b), f"{what}: {a} vs {b}"
    return a - b


def phase_render_small(scene, cb):
    cfg = RenderConfig(width=256, height=256, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(256, 256).to(DEV)
    res = {}
    for name, kw in (("fused", {}), ("split", dict(pair_stage="split")),
                     ("plain", dict(use_kernels=False))):
        sync()
        t0 = time.time()
        out = wavefront.render_wavefront_counts(
            scene, cam, cfg, (0, 3), cb, queue=4096, backend="cluster",
            device=DEV, **kw)
        sync()
        res[name] = (out, time.time() - t0)
    (img_k, nc_k, ns_k, ovf_k, it_k), s_k = res["fused"]
    (img_s, *counts_s), s_s = res["split"]
    (img_p, nc_p, ns_p, ovf_p, it_p), s_p = res["plain"]
    assert bool(torch.isfinite(img_k).all())
    assert bool(torch.equal(img_k, img_s)), \
        "render_small: fused-stage image vs split-stage image (must be bitwise)"
    assert counts_s == [nc_k, ns_k, ovf_k, it_k], \
        "render_small: counts of the fused and the split stage differ"
    assert torch.allclose(img_k, img_p, rtol=2e-4, atol=2e-5), \
        "render_small: kernel image vs plain-version image"
    emit({"phase": "render_small", "size": 256, "queue": 4096,
          "fused_equals_split_bitwise": True,
          "images_equal_bitwise": bool(torch.equal(img_k, img_p)),
          "max_abs_diff": float((img_k - img_p).abs().max()),
          "tolerance": "fused vs split kernels bitwise; kernels vs plain "
                       "rtol 2e-4, atol 2e-5, counts equal or within 0.1 %",
          "n_closest": nc_k, "n_shadow": ns_k, "steps_run": it_k,
          "overflow": ovf_k, "overflow_plain": ovf_p,
          "d_n_closest": counts_close(nc_k, nc_p, "n_closest"),
          "d_n_shadow": counts_close(ns_k, ns_p, "n_shadow"),
          "d_steps": it_k - it_p,
          "run_s_kernels": round(s_k, 3), "run_s_split": round(s_s, 3),
          "run_s_plain": round(s_p, 3),
          "mean_radiance": float(img_k.mean())})
    return img_k, (nc_k, ns_k, ovf_k, it_k)


def phase_determinism(scene, cb):
    """The same spp 4 render twice (``big-1m`` at 128², depth 4, RR from 2
    at 0.7, queue 4096, key (0, 3)): at spp > 1 several samples of one pixel
    are in flight in one step, so the accumulate must add them in a fixed
    order for the two images to be the same bits.  Then once more with
    whole-step lane slicing (``step_slices=2``: each step as two
    strided slices of 2,048 lanes), which must give the same bits and
    counts: every lane adds to its own row, and each slice's traversal
    sub-batches are the unsliced step's."""
    cfg = RenderConfig(width=128, height=128, spp=4, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(128, 128).to(DEV)

    def render():
        return wavefront.render_wavefront_counts(
            scene, cam, cfg, (0, 3), cb, queue=4096, backend="cluster",
            device=DEV)

    outs = [render() for _ in range(2)]
    sliced = render_sliced(scene, cam, cfg, (0, 3), cb, 2)
    a, b = outs[0][0], outs[1][0]
    differ = (a != b).any(-1)
    equal = bool(torch.equal(a, b))
    sliced_equal = bool(torch.equal(sliced[0], a))
    emit({"phase": "determinism", "scene": "big-1m", "size": cfg.width,
          "spp": cfg.spp, "max_depth": cfg.max_depth, "queue": 4096,
          "images_equal_bitwise": equal,
          "pixels_differ": int(differ.sum()),
          "max_abs_diff": float((a - b).abs().max()),
          "counts": [list(o[1:]) for o in outs],
          "step_slices_2": {"image_equals_bitwise": sliced_equal,
                            "pixels_differ": int((sliced[0] != a).any(-1)
                                                 .sum()),
                            "counts": list(sliced[1:])},
          "mean_radiance": float(a.mean())})
    assert bool(torch.isfinite(a).all()), "determinism: image not finite"
    assert equal, "determinism: two spp 4 renders differ"
    assert sliced_equal, "determinism: the sliced render differs"
    assert list(sliced[1:]) == list(outs[0][1:]), \
        "determinism: the sliced render's counts differ"


def render_sliced(scene, cam, cfg, key, cb, k):
    """``render_wavefront_counts``'s result (cluster backend, queue 4096)
    with every step of the loop run as ``k`` strided lane slices
    (``wavefront_accum(step_slices=k)``)."""
    accum, (nc, ns, novf, n_iter) = wavefront.wavefront_accum(
        scene, cam, cfg, key, cb, 4096, "cluster", 0, cfg.n_pixels,
        with_counts=True, step_slices=k)
    return ((accum / cfg.spp).reshape(cfg.height, cfg.width, 3), int(nc),
            int(ns), int(novf), n_iter)


# The band of the headline that the main path's twins render (the split
# and the cluster-major pair stage, the exact fallback attached, the
# LBVH's packed walk, the autotuned BVH): rows 384-639 of 1024, a quarter
# of its pixels across the displaced sphere, each pixel as in the full
# render (``wavefront_accum``'s pixel range; the dist phase holds the same
# for interleaved shards).  The whole headline runs through the main path
# (render_main), the other traversal modes, the device build, the command
# line, the gradient step and the two gloo ranks.
BAND_ROWS = (384, 640)


def render_band(scene, cam, cfg, key, bvh, backend="cluster",
                pair_stage="fused"):
    """``render_wavefront_counts``'s result (queue 4096) on the headline's
    rows ``BAND_ROWS`` only: (those rows of the image, n_closest,
    n_shadow, overflow, steps_run)."""
    r0, r1 = BAND_ROWS
    accum, (nc, ns, novf, n_iter) = wavefront.wavefront_accum(
        scene, cam, cfg, key, bvh, 4096, backend, r0 * cfg.width,
        (r1 - r0) * cfg.width, with_counts=True, pair_stage=pair_stage)
    return ((accum / cfg.spp).reshape(r1 - r0, cfg.width, 3), int(nc),
            int(ns), int(novf), n_iter)


def band_of(img):
    """The rows ``BAND_ROWS`` of a headline image."""
    return img[BAND_ROWS[0]:BAND_ROWS[1]]


# Suspect rays the exact fallback's walk re-traced in the last call of
# with_repair_count, per form.
REPAIRED = {"closest": 0, "any_hit": 0}


def with_repair_count(fn, *a, **kw):
    """fn(*a, **kw), counting on the device the suspect rays that every
    retrace of the cluster traversal hands to the exact fallback
    (``REPAIRED``, per form)."""
    real = {"closest": cluster._retrace_suspects_closest,
            "any_hit": cluster._retrace_suspects_anyhit}
    counts = {k: torch.zeros((), dtype=torch.int64, device=DEV)
              for k in real}

    def spy(form):
        def run(cb_, ro, rd, t_min1, t_max1, suspect, *a, **k):
            counts[form] += suspect.sum()
            return real[form](cb_, ro, rd, t_min1, t_max1, suspect, *a, **k)
        return run

    cluster._retrace_suspects_closest = spy("closest")
    cluster._retrace_suspects_anyhit = spy("any_hit")
    try:
        return fn(*a, **kw)
    finally:
        cluster._retrace_suspects_closest = real["closest"]
        cluster._retrace_suspects_anyhit = real["any_hit"]
        REPAIRED.update({k: int(v) for k, v in counts.items()})


def phase_render_exact(scene, scene_h, cb, pk, small):
    """The command line's flow of exact repair (tpu_pt/cli.py:175-235) on
    ``render_small``'s render, where the default capacities overflow:
    (1) a render that flags suspect pixels, (2) ``attach_fallback`` and the
    same render on it, (3) the repair of only step 1's suspect pixels,
    (4) the render on the packed walk alone.  Returns the cluster BVH with
    the fallback attached, the walk's launches in step 2, step 2's image,
    step 4's (the packed backend's), step 3's repaired image and its count
    of suspect pixels."""
    cfg = RenderConfig(width=256, height=256, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(256, 256).to(DEV)
    key, kw = (0, 3), dict(queue=4096, device=DEV)
    img_s, counts_s = small
    run_s = {}

    def timed(name, fn):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        run_s[name] = round(time.time() - t0, 3)
        return out

    img1, nc1, ns1, ovf1, it1, sus1 = timed(
        "suspect_counts", lambda: wavefront.render_wavefront_suspect_counts(
            scene, cam, cfg, key, cb, backend="cluster", **kw))
    assert ovf1 > 0 and int(sus1.sum()) > 0, \
        f"render_exact: no overflow to repair ({ovf1})"
    assert bool(torch.equal(img1, img_s)) and (nc1, ns1, ovf1, it1) == counts_s, \
        "render_exact: tracking suspects changed render_small's render"

    t0 = time.time()
    cb_fb = cluster.attach_fallback(cb, scene_h)
    attach_s = time.time() - t0
    zero_launches((packed_walk,))
    img2, nc2, ns2, ovf2, it2, sus2 = timed(
        "suspect_counts_fallback",
        lambda: with_repair_count(wavefront.render_wavefront_suspect_counts,
                                  scene, cam, cfg, key, cb_fb,
                                  backend="cluster", **kw))
    repaired = REPAIRED.copy()
    launches = packed_walk.launches
    thread_launches = packed_walk.thread_launches
    assert ovf2 > 0, "render_exact: the overflow is no longer reported"
    assert launches == 2 * 4 * it2, f"render_exact: {launches} walk launches"
    assert thread_launches == 0, \
        f"render_exact: {thread_launches} launches of the thread walk"
    assert sum(repaired.values()) > 0, repaired
    clean = ((sus1 == 0) & (sus2 == 0)).reshape(cfg.height, cfg.width)
    assert bool(torch.equal(img2[clean], img1[clean])), \
        "render_exact: a pixel suspect in neither render changed"

    rep, ovf_r = timed("repair", lambda: wavefront.repair_suspect_pixels(
        scene, cam, cfg, key, cb_fb, img1, sus1, **kw))
    differ = (rep != img2).any(-1)
    n_differ = int(differ.sum())
    if n_differ:
        # Only where one render took a hit from the tile test and the other
        # from the walk's row test may t round differently.
        assert not bool((differ & clean).any()), \
            "render_exact: the repair changed a pixel suspect in neither render"
        assert torch.allclose(rep, img2, rtol=2e-4, atol=2e-5), \
            "render_exact: repaired image vs the fallback render"

    zero_launches((packed_walk,))
    pk_img, nc4, ns4, ovf4, it4 = timed(
        "packed", lambda: wavefront.render_wavefront_counts(
            scene, cam, cfg, key, pk, backend="packed", **kw))
    packed_launches = read_launches((packed_walk,))
    assert packed_launches["packed_walk"] > 0 \
        and packed_launches["packed_walk_thread"] == 0, packed_launches
    assert ovf4 == 0, "render_exact: the packed backend reported overflow"
    assert torch.allclose(pk_img, img2, rtol=1e-3, atol=1e-3), \
        "render_exact: packed backend vs the fallback render"
    counts_close(nc4, nc2, "render_exact packed n_closest")
    counts_close(ns4, ns2, "render_exact packed n_shadow")
    assert bool(torch.isfinite(rep).all())
    emit({"phase": "render_exact", "scene": "big-1m", "size": cfg.width,
          "spp": cfg.spp, "max_depth": cfg.max_depth, "queue": 4096,
          "key": list(key), "attach_fallback_s": round(attach_s, 2),
          "overflow": ovf1, "overflow_with_fallback": ovf2,
          "overflow_repair_subset": ovf_r,
          "suspect_pixels": int(sus1.sum()),
          "suspect_pixels_with_fallback": int(sus2.sum()),
          "suspect_pixels_in_either": int((~clean).sum()),
          "suspect_rays_repaired": repaired,
          "packed_walk_launches": launches,
          "packed_walk_thread_launches": thread_launches,
          "packed_backend_launches": packed_launches,
          "steps_run": [it1, it2, it4],
          "n_closest": [nc1, nc2, nc4], "n_shadow": [ns1, ns2, ns4],
          "run_s": run_s,
          "mean_radiance_before_repair": float(img1.mean()),
          "mean_radiance_after_repair": float(rep.mean()),
          "mean_radiance_fallback_render": float(img2.mean()),
          "mean_radiance_packed_backend": float(pk_img.mean()),
          "repair_equals_fallback_render_bitwise": n_differ == 0,
          "repair_pixels_differ": n_differ,
          "repair_max_abs_diff": float((rep - img2).abs().max()),
          "packed_vs_fallback_max_abs_diff": float((pk_img - img2).abs().max()),
          "tolerance": "tracking suspects bitwise; pixels suspect in neither "
                       "render bitwise; repair vs fallback render bitwise "
                       "(else rtol 2e-4 atol 2e-5 where the two "
                       "intersectors round t differently); packed backend "
                       "rtol 1e-3 atol 1e-3, counts within 0.1 %"})
    return cb_fb, launches, img2, pk_img, rep, int(sus1.sum())


# --------------------------------------------------------------------------
# The differentiable path
# --------------------------------------------------------------------------

# Every kernel wrapper of the package, for the forward / backward split of
# the launch counts.
ALL_KERNELS = (pair_ray_reduce, pair_tile_isect, pair_segmin,
               pair_tile_isect_dedup, dense_closest, dense_anyhit, packed_walk,
               flat_walk, fetch_fields, fetch_rows, fetch_rows_t, take_along)


def zero_launches(kernels):
    """Zero the launch counts of ``kernels`` (the walks': both designs)."""
    for k in kernels:
        k.launches = 0
    packed_walk.thread_launches = 0
    flat_walk.thread_launches = 0


def read_launches(kernels):
    """The launch counts of ``kernels`` by name; a walk's thread design
    (its twin) as ``packed_walk_thread`` / ``flat_walk_thread`` where the
    walk is among them."""
    out = {k.__name__: k.launches for k in kernels}
    for walk in (packed_walk, flat_walk):
        if walk in kernels:
            out[walk.__name__ + "_thread"] = walk.thread_launches
    return out


def take_launches():
    """The launch counts of every kernel since the last call; zeroes them."""
    out = read_launches(ALL_KERNELS)
    zero_launches(ALL_KERNELS)
    return out


def fetch_launches(cb, steps, traversals=2):
    """The fetch_fields launches of a wavefront render of ``steps`` steps:
    one for every level below the top, in each of the 4 sub-batches of the
    ``traversals`` traversals of a step (the closest hit and a shadow ray
    per light)."""
    return (len(cb.levels) - 1) * traversals * 4 * steps


def check_fetch_launches(launches, cb, steps, traversals=2):
    """Every child fetch of every descent went through fetch_fields, none
    through its twin fetch_rows."""
    assert launches["fetch_fields"] == fetch_launches(cb, steps, traversals), \
        launches
    assert launches["fetch_rows"] == 0, launches


def check_grad_launches(r, cb, walk=False, label="render_grad"):
    """A gradient step launched no kernel in backward and, in forward, the
    pair kernel (and the exact fallback's window walk, with ``walk``) once
    for each of 4 sub-batches of 2 traversals a step, the descent's child
    fetch through fetch_fields only."""
    assert not any(r["launches_bwd"].values()), \
        f"{label}: kernels launched in backward: {r['launches_bwd']}"
    for name in ("pair_ray_reduce",) + (("packed_walk",) if walk else ()):
        assert r["launches_fwd"][name] == 2 * 4 * r["steps_run"], \
            r["launches_fwd"]
    assert r["launches_fwd"]["packed_walk_thread"] == 0, r["launches_fwd"]
    check_fetch_launches(r["launches_fwd"], cb, r["steps_run"])


def grad_step(adjoint, params, scene, cam, cfg, key, bvh, hint, **kw):
    """One differentiable step through the port's entry points, timed in its
    two halves: ``adjoint.wavefront_loss`` (the forward pass on fresh leaves
    of ``params``, target zeros), then ``torch.autograd.grad``.  The launch
    counts of the two halves are taken apart.  Also the device memory
    allocated before the step and its peak during it (``step_mem_MB``: the
    peak less the memory before), and the chunks the loop checkpointed
    (``chunks``; ``remat``: any) and recomputed in backward
    (``replays``)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    target = torch.zeros((cfg.n_pixels, 3), device=DEV)
    chunks, real = [], wavefront.checkpoint

    def spy(fn, *a, **k):
        chunks.append(fn)
        return real(fn, *a, **k)

    take_launches()
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    wavefront.checkpoint = spy
    try:
        t0 = time.time()
        loss, img, (nc, ns, novf, n_iter), done = adjoint.wavefront_loss(
            leaves, scene, cam, cfg, key, target, bvh, queue=4096,
            steps_hint=hint, **kw)
        sync()
        t1 = time.time()
        fwd = take_launches()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        sync()
        t2 = time.time()
    finally:
        wavefront.checkpoint = real
    peak = torch.cuda.max_memory_allocated()
    return dict(loss=loss.detach(), img=img.detach(), done=done,
                overflow=int(novf), steps_run=n_iter, n_closest=int(nc),
                n_shadow=int(ns), grads=dict(zip(leaves, grads)),
                fwd_s=t1 - t0, bwd_s=t2 - t1, launches_fwd=fwd,
                launches_bwd=take_launches(), remat=bool(chunks),
                chunks=len(chunks), replays=sum(c.replays for c in chunks),
                mem_before_step_MB=round(mem0 / 1e6, 1),
                peak_mem_MB=round(peak / 1e6, 1),
                step_mem_MB=round((peak - mem0) / 1e6, 1))


def most_seen_material(scene, cam, cb, cfg):
    """The material that the most pixel centres see first."""
    n = cfg.n_pixels
    ids = torch.arange(n, device=DEV)
    ro, rd = generate_rays(cam, pixel_xy(cfg.width, cfg.height, ids,
                                         torch.full((n, 2), 0.5, device=DEV)))
    hit = cluster.intersect(cb, scene, ro, rd, torch.zeros((n, 1), device=DEV),
                            torch.full((n, 1), 1e30, device=DEV))
    prim_mat = torch.cat([scene.tri_mat, scene.sph_mat])
    return int(torch.bincount(prim_mat[hit.prim.long()[hit.hit[:, 0]]]
                              .long()).argmax())


def plane_scene():
    """A diffuse quad under an area light, seen from above, and its camera
    (the gradient scene of tests/test_diff.py): every hit point moves
    smoothly with the vertices."""
    g = 4.0
    scene = make_scene(
        np.asarray([(-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)],
                   np.float32),
        np.asarray([(0, 1, 2), (0, 2, 3)], np.int32),
        np.asarray([0, 0], np.int32),
        make_materials([dict(albedo=(0.6, 0.4, 0.3))]),
        make_lights([dict(kind=LIGHT_AREA, position=(-0.5, 3.0, -0.5),
                          edge_x=(1, 0, 0), edge_y=(0, 0, 1),
                          normal=(0, -1, 0), radiance=(8.0, 8.0, 8.0))]))
    cam = Camera.look_at(eye=(0.0, 2.0, 0.01), target=(0, 0, 0), hfov=30,
                         aspect=1.0, up=(0, 0, -1))
    return scene, cam


def grads_equal(a, b):
    return all(bool(torch.equal(a[k], b[k])) for k in a)


def grads_max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def grads_max_rel(a, b):
    """The largest |a - b| of each gradient over the largest |b| of it."""
    return max(float((a[k] - b[k]).abs().max())
               / max(float(b[k].abs().max()), 1e-30) for k in a)


def check_remat(r, twin=None, label="render_grad"):
    """A step past 16 steps recomputed every chunk it checkpointed, once;
    the twin checkpointed none."""
    assert r["remat"] and r["replays"] == r["chunks"] > 1, \
        f"{label}: chunks {r['chunks']}, recomputed {r['replays']}"
    if twin is not None:
        assert not twin["remat"] and twin["chunks"] == 0, \
            f"{label}: the twin checkpointed {twin['chunks']} chunks"


def grad_cell():
    """The grad cell's config and camera (big-1m 256², spp 1, depth 4, RR
    from 2 at 0.7: the JAX package's ``BENCH_GRAD=1`` cell)."""
    cfg = RenderConfig(width=256, height=256, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    return cfg, meshes.big_camera(256, 256).to(DEV)


def grad_hint(scene, cb):
    """The grad cell's ``steps_hint``: 1.2 x the steps of a counting render
    (key (0, 0)) plus the depth and 2; and that render's (n_closest,
    n_shadow, steps_run)."""
    cfg, cam = grad_cell()
    _, nc, ns, _, n_iter = wavefront.render_wavefront_counts(
        scene, cam, cfg, (0, 0), cb, queue=4096, backend="cluster", device=DEV)
    return int(n_iter * 1.2) + cfg.max_depth + 2, (nc, ns, n_iter)


def phase_render_grad(scene, cb, cb_fb, img_fb):
    """The differentiable path on the card.

    (a) The grad cell as the JAX package's bench times it (``BENCH_GRAD=1``:
    big-1m, 256², spp 1, depth 4, RR from 2 at 0.7, queue 4096, cluster
    backend, fused pair stage, target zeros; hint from a counting forward
    render, the full bound if it was too small): one warm step, then three
    timed with keys 1, 2, 3.  No kernel launches in backward; the pair
    kernel 8 times a step in forward; grads finite; albedo's gradient at
    the material the camera sees most against a central difference.  The
    hint is past 16 steps, so every chunk is recomputed in backward; key 3
    once more as the twin (``remat=False``): the same loss and gradients,
    and the memory its tape adds beside the recomputing step's.
    (b) The same with the exact fallback attached, key (0, 3): the forward
    image is ``render_exact``'s fallback render.
    (c) Kernels against their plain versions through autograd, on two small
    scenes; and the dense-sweep backend's gradients against the brute
    backend's.  Returns the grad cell's steps_hint."""
    from tpu_pt_torch.diff import adjoint, params as dparams

    cfg, cam = grad_cell()
    params = dparams.split(scene)[0]
    hint, (nc, ns, n_iter) = grad_hint(scene, cb)

    def step(key, bvh=cb):
        out = grad_step(adjoint, params, scene, cam, cfg, key, bvh, hint)
        if not out["done"]:     # the hint was too small: the full bound
            out = grad_step(adjoint, params, scene, cam, cfg, key, bvh, None)
            out["hint_failed"] = True
        return out

    step((0, 0))                                    # warm
    runs = [step((0, i)) for i in (1, 2, 3)]
    fwd_s = statistics.median(r["fwd_s"] for r in runs)
    bwd_s = statistics.median(r["bwd_s"] for r in runs)
    total_s = statistics.median(r["fwd_s"] + r["bwd_s"] for r in runs)
    last = runs[-1]
    twin = grad_step(adjoint, params, scene, cam, cfg, (0, 3), cb,
                     None if last.get("hint_failed") else hint, remat=False)
    twin_bitwise = bool(torch.equal(twin["loss"], last["loss"])) \
        and grads_equal(twin["grads"], last["grads"])

    # Central difference of the loss in one albedo entry (no sampling
    # decision depends on albedo), on the last run's key.
    m = most_seen_material(scene, cam, cb, cfg)
    eps = 1e-2
    target = torch.zeros((cfg.n_pixels, 3), device=DEV)

    def loss_at(d):
        alb = params["albedo"].clone()
        alb[m, 0] += d
        with torch.no_grad():
            return float(adjoint.wavefront_loss(
                dict(params, albedo=alb), scene, cam, cfg, (0, 3), target,
                cb, queue=4096, steps_hint=hint)[0])

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    g = float(last["grads"]["albedo"][m, 0])
    emit({"phase": "render_grad", "part": "grad_cell", "scene": "big-1m",
          "size": cfg.width, "spp": cfg.spp, "max_depth": cfg.max_depth,
          "queue": 4096, "pair_stage": "fused",
          "keys": [[0, i] for i in (1, 2, 3)], "steps_hint": hint,
          "counting_steps_run": n_iter, "n_closest": nc, "n_shadow": ns,
          "fwd_s_all": [round(r["fwd_s"], 3) for r in runs],
          "bwd_s_all": [round(r["bwd_s"], 3) for r in runs],
          "fwd_s": round(fwd_s, 3), "bwd_s": round(bwd_s, 3),
          "bwd_over_fwd": round(bwd_s / fwd_s, 4),
          "grad_rays_per_s": round((nc + ns) / total_s, 1),
          "loss": [float(r["loss"]) for r in runs],
          "done": [r["done"] for r in runs],
          "hint_failed": any(r.get("hint_failed", False) for r in runs),
          "overflow": [r["overflow"] for r in runs],
          "steps_run": [r["steps_run"] for r in runs],
          "peak_mem_MB": last["peak_mem_MB"],
          "mem_before_step_MB": last["mem_before_step_MB"],
          "step_mem_MB": last["step_mem_MB"],
          "remat": last["remat"], "chunks": last["chunks"],
          "chunks_recomputed": last["replays"],
          "twin": {"remat": twin["remat"], "fwd_s": round(twin["fwd_s"], 3),
                   "bwd_s": round(twin["bwd_s"], 3),
                   "peak_mem_MB": twin["peak_mem_MB"],
                   "mem_before_step_MB": twin["mem_before_step_MB"],
                   "step_mem_MB": twin["step_mem_MB"],
                   "launches_bwd": twin["launches_bwd"],
                   "equals_recomputed_bitwise": twin_bitwise,
                   "grads_max_abs_diff": grads_max_diff(twin["grads"],
                                                        last["grads"])},
          "step_mem_over_twin": round(last["step_mem_MB"]
                                      / twin["step_mem_MB"], 4),
          "launches_fwd": last["launches_fwd"],
          "launches_bwd": last["launches_bwd"],
          "fd_albedo": {"material": m, "channel": 0, "eps": eps, "grad": g,
                        "central_difference": fd,
                        "rel_err": abs(g - fd) / abs(fd)},
          "tolerance": "backward launches 0; pair_ray_reduce 8 x steps, "
                       "fetch_fields 8 x fetch levels x steps, fetch_rows 0; "
                       "the window walk only; grads finite; "
                       "albedo grad vs central difference rtol 2e-2; every "
                       "chunk recomputed once; the twin's loss and grads "
                       "bitwise, else rtol 1e-6 of the largest"})
    check_remat(last, twin)
    check_grad_launches(twin, cb)
    assert bool(torch.equal(twin["loss"], last["loss"])) \
        and grads_max_rel(twin["grads"], last["grads"]) <= 1e-6, \
        "render_grad: the twin's gradients differ from the recomputed ones"
    del twin
    for r in runs:
        check_grad_launches(r, cb)
        assert all(bool(torch.isfinite(x).all())
                   for x in r["grads"].values()), \
            "render_grad: a gradient is not finite"
        assert bool(torch.isfinite(r["loss"])) and r["done"]
    assert abs(g - fd) <= 2e-2 * abs(fd), \
        f"render_grad: albedo grad {g} vs central difference {fd}"
    del runs, last

    # (b) The fallback attached: every traversal also walks its suspect
    # rays exactly, so the image is render_exact's fallback render.
    fb = step((0, 3), cb_fb)
    img = fb["img"].reshape(cfg.height, cfg.width, 3)
    differ = (img != img_fb).any(-1)
    emit({"phase": "render_grad", "part": "fallback", "key": [0, 3],
          "image_equals_render_exact_bitwise": int(differ.sum()) == 0,
          "pixels_differ": int(differ.sum()),
          "max_abs_diff": float((img - img_fb).abs().max()),
          "fwd_s": round(fb["fwd_s"], 3), "bwd_s": round(fb["bwd_s"], 3),
          "overflow": fb["overflow"], "steps_run": fb["steps_run"],
          "remat": fb["remat"], "chunks": fb["chunks"],
          "chunks_recomputed": fb["replays"],
          "peak_mem_MB": fb["peak_mem_MB"],
          "mem_before_step_MB": fb["mem_before_step_MB"],
          "step_mem_MB": fb["step_mem_MB"],
          "loss": float(fb["loss"]), "launches_fwd": fb["launches_fwd"],
          "launches_bwd": fb["launches_bwd"],
          "tolerance": "bitwise, else rtol 2e-4 atol 2e-5 where the tile "
                       "test and the walk's row test round t apart; loss "
                       "= mean(img²) bitwise"})
    check_grad_launches(fb, cb, walk=True)
    check_remat(fb)
    assert bool(fb["loss"] == torch.mean(fb["img"] ** 2)), \
        "render_grad: the fallback loss is not mean(img²) of its image"
    assert torch.allclose(img, img_fb, rtol=2e-4, atol=2e-5), \
        "render_grad: fallback-attached image vs render_exact's fallback render"
    del fb

    # (c) Small scenes: kernels against plain versions, twice the same
    # call, and the dense sweep against the brute backend.
    plane, plane_cam = plane_scene()
    small = {"plane_64": (plane, plane_cam,
                          RenderConfig(width=64, height=64, spp=1,
                                       direct_only=True)),
             "cornell_spheres_32": (cornell.cornell("spheres"),
                                    cornell.camera(32, 32),
                                    RenderConfig(width=32, height=32, spp=2,
                                                 max_depth=3))}
    for name, (scene_h, cam_h, cfg_s) in small.items():
        cb_s = cluster.build_cluster_bvh(scene_h)
        p_h = {k: torch.as_tensor(v) for k, v in
               dparams.split(scene_h.to("cpu"))[0].items()}
        target = np.zeros((cfg_s.n_pixels, 3), np.float32)
        args = (scene_h, cam_h, cfg_s, (0, 2), target, cb_s)
        take_launches()
        kw = dict(queue=1024, device=DEV)
        lk, gk = adjoint.loss_and_grad_wavefront(p_h, *args, **kw)
        n_k = take_launches()
        lk2, gk2 = adjoint.loss_and_grad_wavefront(p_h, *args, **kw)
        lp, gp = adjoint.loss_and_grad_wavefront(p_h, *args, **kw,
                                                 use_kernels=False)
        n_p = take_launches()
        # The flat renderer on the dense sweep (K4, K5) in its two halves,
        # then through loss_and_grad, against the brute backend.
        ps = PallasScene(scene_h).to(DEV)
        leaves = {k: v.to(DEV).requires_grad_(True) for k, v in p_h.items()}
        img_d = adjoint.render_flat(dparams.merge(leaves, scene_h.to(DEV)),
                                    cam_h, cfg_s, (0, 2), backend="pallas",
                                    bvh=ps, device=DEV)
        loss_d = torch.mean(img_d ** 2)
        n_fwd = take_launches()
        g_d = dict(zip(leaves, torch.autograd.grad(loss_d,
                                                   list(leaves.values()))))
        n_bwd = take_launches()
        ld2, gd2 = adjoint.loss_and_grad(p_h, scene_h, cam_h, cfg_s, (0, 2),
                                         target, backend="pallas", bvh=ps,
                                         device=DEV)
        lb, gb = adjoint.loss_and_grad(p_h, scene_h, cam_h, cfg_s, (0, 2),
                                       target, backend="brute", device=DEV)
        entry = {
            "phase": "render_grad", "part": "small", "scene": name,
            "size": cfg_s.width, "spp": cfg_s.spp, "queue": 1024,
            "kernels_vs_plain_bitwise": bool(torch.equal(lk, lp))
            and grads_equal(gk, gp),
            "kernels_vs_plain_max_abs_diff": max(float((lk - lp).abs()),
                                                 grads_max_diff(gk, gp)),
            "same_call_twice_bitwise": bool(torch.equal(lk, lk2))
            and grads_equal(gk, gk2),
            "same_call_twice_max_abs_diff": max(float((lk - lk2).abs()),
                                                grads_max_diff(gk, gk2)),
            "launches_one_call": n_k, "launches_two_calls_after": n_p,
            "dense_launches_fwd": n_fwd, "dense_launches_bwd": n_bwd,
            "pallas_halves_equal_loss_and_grad": bool(
                torch.equal(ld2, loss_d.detach())) and grads_equal(gd2, g_d),
            "pallas_vs_brute_loss_rel_err":
                abs(float(ld2) - float(lb)) / abs(float(lb)),
            "pallas_vs_brute_max_abs_diff": grads_max_diff(gd2, gb),
            "loss": float(lk),
            "tolerance": "kernels vs plain and two calls bitwise; pallas vs "
                         "brute rtol 1e-3 atol 1e-3"}
        emit(entry)
        assert n_k["pair_ray_reduce"] > 0, n_k
        # The plain versions of the second call launch nothing; a pyramid
        # of one level fetches no children.
        for name in ("pair_ray_reduce", "fetch_fields"):
            assert n_p[name] == n_k[name], (n_k, n_p)
        assert (n_k["fetch_fields"] > 0) == (len(cb_s.levels) > 1), n_k
        assert n_k["fetch_rows"] == 0, n_k
        assert n_fwd["dense_closest"] > 0 and n_fwd["dense_anyhit"] > 0, n_fwd
        assert not any(n_bwd.values()), n_bwd
        assert entry["pallas_halves_equal_loss_and_grad"], \
            f"{name}: loss_and_grad vs its two halves"
        assert entry["kernels_vs_plain_bitwise"], \
            f"{name}: kernels vs plain versions through autograd"
        assert entry["same_call_twice_bitwise"], f"{name}: two calls differ"
        assert torch.allclose(ld2, lb, rtol=1e-3, atol=1e-3) and all(
            torch.allclose(gd2[k], gb[k], rtol=1e-3, atol=1e-3) for k in gb), \
            f"{name}: dense-sweep gradients vs brute gradients"
    return hint


def phase_grad_headline(scene, cam, cb, cfg, main, img_main):
    """The headline as a gradient step: the JAX package's ``BENCH_GRAD=1
    BENCH_SIZE=1024`` cell (big-1m, 1024², spp 1, depth 4, RR from 2 at
    0.7, queue 4096, key (0, 3), target zeros, cluster backend, fused pair
    stage), its ``steps_hint`` made from ``render_main``'s steps as
    ``grad_hint`` makes it (the full bound if it was too small).  Once
    recomputing every √steps chunk in backward (``remat=None``) and once as
    the twin that keeps every step's shading (``remat=False``).  Holds: no
    kernel launched in backward, the pair kernel 8 times a step in forward,
    every chunk recomputed once, the twin's gradients equal to the
    recomputed ones (bitwise, else rtol 1e-6 of the largest), loss =
    mean(img²) bit for bit, the forward image ``render_main``'s bit for bit
    where nothing overflowed, and the memory the recomputing step adds at
    most 0.25 of the twin's.  Returns the recomputing step's forward
    launches."""
    from tpu_pt_torch.diff import adjoint, params as dparams

    params = dparams.split(scene)[0]
    hint = int(main["steps_run"] * 1.2) + cfg.max_depth + 2
    out = {}
    for name, remat in (("remat", None), ("twin", False)):
        r = grad_step(adjoint, params, scene, cam, cfg, (0, 3), cb, hint,
                      remat=remat)
        if not r["done"]:       # the hint was too small: the full bound
            r = grad_step(adjoint, params, scene, cam, cfg, (0, 3), cb, None,
                          remat=remat)
            r["hint_failed"] = True
        out[name] = r
    r, tw = out["remat"], out["twin"]
    img = r["img"].reshape(cfg.height, cfg.width, 3)
    differ = (img != img_main).any(-1)
    bitwise = bool(torch.equal(r["loss"], tw["loss"])) \
        and grads_equal(r["grads"], tw["grads"])

    def line(x):
        total_s = x["fwd_s"] + x["bwd_s"]
        return {"fwd_s": round(x["fwd_s"], 3), "bwd_s": round(x["bwd_s"], 3),
                "bwd_over_fwd": round(x["bwd_s"] / x["fwd_s"], 4),
                "grad_rays_per_s": round((x["n_closest"] + x["n_shadow"])
                                         / total_s, 1),
                "peak_mem_MB": x["peak_mem_MB"],
                "mem_before_step_MB": x["mem_before_step_MB"],
                "step_mem_MB": x["step_mem_MB"], "remat": x["remat"],
                "chunks": x["chunks"], "chunks_recomputed": x["replays"],
                "steps_run": x["steps_run"], "overflow": x["overflow"],
                "n_closest": x["n_closest"], "n_shadow": x["n_shadow"],
                "hint_failed": x.get("hint_failed", False),
                "loss": float(x["loss"]),
                "loss_is_mean_img_sq_bitwise": bool(
                    x["loss"] == torch.mean(x["img"] ** 2)),
                "launches_fwd": x["launches_fwd"],
                "launches_bwd": x["launches_bwd"]}

    steps = min(wavefront.n_steps(cfg, 4096), hint)
    emit({"phase": "render_grad", "part": "grad_headline", "scene": "big-1m",
          "size": cfg.width, "spp": cfg.spp, "max_depth": cfg.max_depth,
          "queue": 4096, "pair_stage": "fused", "key": [0, 3],
          "steps_hint": hint, "inner": max(1, round(steps ** 0.5)),
          "render_main_steps_run": main["steps_run"],
          "recomputed": line(r), "twin": line(tw),
          "step_mem_over_twin": round(r["step_mem_MB"] / tw["step_mem_MB"],
                                      4),
          "bwd_s_over_twin": round(r["bwd_s"] / tw["bwd_s"], 4),
          "twin_equals_recomputed_bitwise": bitwise,
          "grads_max_abs_diff": grads_max_diff(r["grads"], tw["grads"]),
          "grads_max_rel_diff": grads_max_rel(r["grads"], tw["grads"]),
          "image_equals_render_main_bitwise": int(differ.sum()) == 0,
          "pixels_differ_render_main": int(differ.sum()),
          "tolerance": "backward launches 0; pair_ray_reduce 8 x steps; "
                       "every chunk recomputed once; twin loss and grads "
                       "bitwise, else rtol 1e-6 of the largest; loss = "
                       "mean(img²) bitwise; image = render_main's bitwise "
                       "at overflow 0; step memory <= 0.25 x the twin's"})
    for x in (r, tw):
        check_grad_launches(x, cb, label="grad_headline")
        assert bool(torch.isfinite(x["loss"])) and all(
            bool(torch.isfinite(g).all()) for g in x["grads"].values()), \
            "grad_headline: loss or gradients not finite"
        assert bool(x["loss"] == torch.mean(x["img"] ** 2)), \
            "grad_headline: the loss is not mean(img²) of its image"
    check_remat(r, tw, label="grad_headline")
    assert bool(torch.equal(r["loss"], tw["loss"])) \
        and grads_max_rel(r["grads"], tw["grads"]) <= 1e-6, \
        "grad_headline: the twin's gradients differ from the recomputed ones"
    if r["overflow"] == 0 and main["overflow"] == 0:
        assert int(differ.sum()) == 0, \
            "grad_headline: forward image vs render_main's"
    assert r["step_mem_MB"] <= 0.25 * tw["step_mem_MB"], \
        "grad_headline: the recomputing step holds more than 0.25 of the twin's"
    return {"grad_headline": r["launches_fwd"]}


def phase_render_fallback(scene, cam, cb_fb, cfg, main, img_main):
    """The headline's band (``BAND_ROWS``) once more with the exact
    fallback attached (what tpu_pt/bench.py:274-283 re-renders after an
    overflow): no ray is suspect, so the rows and counts must be
    ``render_main``'s band render's, and the walk is launched on every
    traversal sub-batch all the same.  Returns its launches."""
    kernels = (packed_walk, pair_ray_reduce, pair_tile_isect, pair_segmin,
               pair_tile_isect_dedup, fetch_rows,
               fetch_fields)
    band = main["band"]
    # The launch counts of this path: zeroed just before the render, read
    # just after it.
    zero_launches(kernels)
    (img, nc, ns, ovf, n_iter), run_s = timed_sync(
        lambda: render_band(scene, cam, cfg, (0, 3), cb_fb))
    launches = read_launches(kernels)
    equal = bool(torch.equal(img, band_of(img_main)))
    emit({"phase": "render_fallback", "scene": "big-1m", "size": cfg.width,
          "rows": list(BAND_ROWS), "spp": cfg.spp,
          "max_depth": cfg.max_depth, "queue": 4096,
          "run_s": round(run_s, 3), "run_s_render_main_band": band["run_s"],
          "run_s_over_render_main_band": round(run_s / band["run_s"], 4),
          "image_equals_render_main_rows_bitwise": equal,
          "steps_run": n_iter, "n_closest": nc, "n_shadow": ns,
          "overflow": ovf, "launches": launches})
    assert ovf == 0, f"render_fallback: overflow {ovf}"
    assert equal, "render_fallback: the band differs from render_main's " \
        "rows (must be bitwise)"
    assert (nc, ns, n_iter) == (band["n_closest"], band["n_shadow"],
                                band["steps_run"]), \
        "render_fallback: counts differ from render_main's band"
    # 2 traversals x 4 sub-batches a step, one walk each.
    assert launches["packed_walk"] == 2 * 4 * n_iter, launches
    assert launches["packed_walk_thread"] == 0, launches
    assert launches["pair_ray_reduce"] == 2 * 4 * n_iter, launches
    check_fetch_launches(launches, cb_fb, n_iter)
    return {k: launches[k] for k in ("packed_walk", "packed_walk_thread")}


def phase_render_main(scene, cam, cb, cfg, build_s, n_tris):
    key = (0, 3)
    kernels = (pair_ray_reduce, pair_tile_isect, pair_segmin,
               pair_tile_isect_dedup, packed_walk, fetch_rows,
               fetch_fields)

    def run(cam=cam, cfg=cfg):
        sync()
        t0 = time.time()
        out = wavefront.render_wavefront_counts(
            scene, cam, cfg, key, cb, queue=4096, backend="cluster",
            device=DEV)
        sync()
        return out, time.time() - t0

    # The warm-up renders the same scene at 256²: the same kernels and
    # queue, a quarter of the headline's time (the earlier phases have
    # built and launched every kernel already).
    _, warm_s = run(meshes.big_camera(256, 256).to(DEV),
                    dataclasses.replace(cfg, width=256, height=256))
    times = []
    for i in range(2):
        if i == 1:
            # The launch counts of the main path: zeroed just before one
            # full-width render, read just after it.
            zero_launches(kernels)
        (img, nc, ns, ovf, n_iter), dt = run()
        times.append(dt)
    launches = read_launches(kernels)
    # The band the twins render, through the main path: the reference of
    # their counts, its image the headline's rows bit for bit.
    zero_launches(kernels)
    (img_b, nc_b, ns_b, ovf_b, it_b), band_s = timed_sync(
        lambda: render_band(scene, cam, cfg, key, cb))
    band_launches = read_launches(kernels)
    band = {"rows": list(BAND_ROWS), "run_s": round(band_s, 3),
            "steps_run": it_b, "n_closest": nc_b, "n_shadow": ns_b,
            "overflow": ovf_b, "mean_radiance": float(img_b.mean()),
            "image_equals_render_main_rows_bitwise": bool(
                torch.equal(img_b, band_of(img))),
            "launches": band_launches}
    del img_b
    # 2 traversals x 4 sub-batches a step, one launch each; the stage that
    # was asked for is the stage that ran.
    assert launches["pair_ray_reduce"] == 2 * 4 * n_iter, launches
    # Every child fetch of every descent went through the kernel.
    check_fetch_launches(launches, cb, n_iter)
    assert not any(n for k, n in launches.items()
                   if k not in ("pair_ray_reduce", "fetch_fields")), \
        launches          # no fallback attached: no walk; no row fetch
    assert bool(torch.isfinite(img).all()), "render_main: image not finite"
    assert tuple(img.shape) == (cfg.height, cfg.width, 3)
    mean = float(img.mean())
    run_s = min(times)
    line = {"phase": "render_main", "scene": "big-1m", "tris": n_tris,
            "size": cfg.width, "spp": cfg.spp, "max_depth": cfg.max_depth,
            "queue": 4096, "key": list(key),
            "n_clusters": cb.n_clusters,
            "level_sizes": [int(lv.shape[0]) for lv in cb.levels],
            "frontiers": list(cb.frontiers), "k_leaf": cb.k_leaf,
            "pair_mults": list(cb.pair_mults),
            "bvh_build_s": round(build_s, 2),
            "warmup_s": round(warm_s, 3), "warmup_size": 256,
            "run_s_all": [round(t, 3) for t in times], "run_s": round(run_s, 3),
            "steps": wavefront.n_steps(cfg, 4096), "steps_run": n_iter,
            "n_closest": nc, "n_shadow": ns, "overflow": ovf,
            "mean_radiance": mean,
            "rays_per_s": round((nc + ns) / run_s, 1),
            "launches_per_render": launches, "band": band,
            "peak_mem_MB": round(torch.cuda.max_memory_allocated() / 1e6, 1),
            "vs_recorded": {
                "n_closest": nc - RECORDED["n_closest"],
                "n_shadow": ns - RECORDED["n_shadow"],
                "steps_run": n_iter - RECORDED["steps_run"],
                "overflow": ovf - RECORDED["overflow"],
                "mean_radiance": mean - RECORDED["mean_radiance"]},
            "equals_port_record": {
                k: v == PORT_RECORD[k] for k, v in (
                    ("n_closest", nc), ("n_shadow", ns),
                    ("steps_run", n_iter), ("overflow", ovf),
                    ("mean_radiance", mean))}}
    emit(line)
    film.save("chip_smoke_big1m.png", img.cpu().numpy())
    assert abs(mean - RECORDED["mean_radiance"]) <= 0.01 * RECORDED["mean_radiance"], \
        f"mean_radiance {mean} not within 1 % of {RECORDED['mean_radiance']}"
    for name, got in (("n_closest", nc), ("n_shadow", ns)):
        assert abs(got - RECORDED[name]) <= 0.005 * RECORDED[name], \
            f"{name} {got} not within 0.5 % of {RECORDED[name]}"
    assert ovf == 0, (
        f"overflow {ovf}: candidates were truncated by the static budgets; "
        "the headline is held to 0 with the default capacities (an overflow "
        "is repaired exactly with cluster.attach_fallback and "
        "wavefront.repair_suspect_pixels, phases render_exact and "
        "render_fallback)")
    assert n_iter == RECORDED["steps_run"], f"steps_run {n_iter}"
    assert all(line["equals_port_record"].values()), \
        f"render_main moved from the port's record {PORT_RECORD}"
    assert band["image_equals_render_main_rows_bitwise"] \
        and band["overflow"] == 0, f"render_main: the band {band}"
    assert band_launches["pair_ray_reduce"] == 2 * 4 * it_b, band_launches
    check_fetch_launches(band_launches, cb, it_b)
    return {k: launches[k] for k in ("pair_ray_reduce", "fetch_fields")}, \
        line, img


def probe_size(cfg):
    """[width, height] the autotuner probes a render config at: scaled to
    about 512² where the image is larger."""
    if cfg.n_pixels <= 512 * 512:
        return [cfg.width, cfg.height]
    scale = (cfg.n_pixels / (512 * 512)) ** 0.5
    return [max(1, round(cfg.width / scale)),
            max(1, round(cfg.height / scale))]


def tune_timed(scene_h, cam_h, cfg):
    """``cluster.autotune_for_render`` of big-1m as the command line's
    ``--autotune`` runs it (queue 4096, no fallback attached), timed whole
    and in its parts: the host cluster builds and the probe segments.
    Returns (host ClusterBVH, seconds, parts)."""
    real_build, real_probe = cluster.build_cluster_bvh, cluster._probe_segment
    parts = {"builds": 0, "build_s": 0.0, "segments": 0, "probe_s": 0.0}

    def build_spy(*a, **k):
        t0 = time.time()
        out = real_build(*a, **k)
        parts["builds"] += 1
        parts["build_s"] += time.time() - t0
        return out

    def probe_spy(*a, **k):
        t0 = time.time()
        out = real_probe(*a, **k)          # ends in a read to the host
        parts["segments"] += 1
        parts["probe_s"] += time.time() - t0
        return out

    cluster.build_cluster_bvh, cluster._probe_segment = build_spy, probe_spy
    try:
        sync()
        t0 = time.time()
        cb_t = cluster.autotune_for_render(
            scene_h, cam_h, cfg, queue=4096, exact_fallback=False,
            device=DEV)
        sync()
        tune_s = time.time() - t0
    finally:
        cluster.build_cluster_bvh = real_build
        cluster._probe_segment = real_probe
    return cb_t, tune_s, {k: round(v, 3) if isinstance(v, float) else v
                          for k, v in parts.items()}


def phase_render_autotune(scene, scene_h, cb, cfg, main, img_main, img_fb):
    """The capacity autotuner on big-1m.  (a) At ``render_exact``'s cell
    (256², where the default capacities overflow): tune with a 256² probe,
    render on the tuned BVH tracking suspects, and where it still overflows
    run the command line's verify-then-retry (attach the fallback, repair
    the suspect pixels); the final image must be ``render_exact``'s
    fallback render bit for bit (else 2e-4 / 2e-5 where tile and row test
    round t apart).  Every tuned cap must cover the per-level maximum that
    ``level_hit_counts`` measures on the first closest-hit batch of every
    probe segment.
    (b) The command line's ``--autotune`` at the headline: the 1024² config
    (probed at 512²), one render of the headline's band (``BAND_ROWS``) on
    the tuned BVH, its ``run_s`` beside ``render_main``'s band render's; at
    overflow 0 its rows must be ``render_main``'s bit for bit."""
    key, kw = (0, 3), dict(queue=4096, device=DEV)
    kernels = (pair_ray_reduce, packed_walk, fetch_rows,
               fetch_fields)
    default = {"frontiers": list(cb.frontiers), "k_leaf": cb.k_leaf,
               "pair_mults": list(cb.pair_mults)}

    # (a) 256².
    cfg_a = RenderConfig(width=256, height=256, spp=1, max_depth=4,
                         rr_start=2, rr_prob=0.7)
    cam_a_h = meshes.big_camera(256, 256)
    cam_a = cam_a_h.to(DEV)
    cb_h, tune_s, parts = tune_timed(scene_h, cam_a_h, cfg_a)
    cb_a = cb_h.to(DEV)
    # The first closest-hit batch of each of the probe's 8 segments (the
    # probe's own steps: key (0, 7), a fresh queue at the segment's pixel).
    ifn, ofn = _intersectors_counted("cluster", cb_a)
    n_pix = cfg_a.n_pixels
    level_max = []
    for i in range(8):
        probes, lo = [], (n_pix // 8) * i
        with torch.no_grad():
            wavefront._step(scene, cam_a, cfg_a, (0, 7), ifn, ofn,
                            wavefront.init_queue(4096, n_pix, DEV), lo,
                            n_pix - lo, 0, 1, ray_probe=probes)
        ro, rd, t_max = probes[0]
        live = t_max[:, 0] > 0
        level_max.append([int(x) for x in cluster.level_hit_counts(
            cb_a, ro[live], rd[live]).amax(0)])
    level_all = [max(col) for col in zip(*level_max)]
    zero_launches(kernels)
    sync()
    t0 = time.time()
    img1, nc1, ns1, ovf1, it1, sus1 = \
        wavefront.render_wavefront_suspect_counts(scene, cam_a, cfg_a, key,
                                                  cb_a, backend="cluster",
                                                  **kw)
    sync()
    run_s = {"render": round(time.time() - t0, 3)}
    launches = read_launches(kernels)
    assert launches["pair_ray_reduce"] == 2 * 4 * it1, launches
    check_fetch_launches(launches, cb_a, it1)
    final, repair = img1, None
    if ovf1 > 0:
        t0 = time.time()
        cb_a_fb = cluster.attach_fallback(cb_a, scene_h)
        run_s["attach_fallback"] = round(time.time() - t0, 3)
        t0 = time.time()
        final, ovf_r = wavefront.repair_suspect_pixels(
            scene, cam_a, cfg_a, key, cb_a_fb, img1, sus1, **kw)
        sync()
        run_s["repair"] = round(time.time() - t0, 3)
        repair = {"suspect_pixels": int(sus1.sum()),
                  "overflow_repair_subset": ovf_r}
        del cb_a_fb
    differ = (final != img_fb).any(-1)
    n_differ = int(differ.sum())
    line = {"phase": "render_autotune", "part": "render_exact_cell",
            "scene": "big-1m", "size": cfg_a.width, "spp": cfg_a.spp,
            "max_depth": cfg_a.max_depth, "queue": 4096, "key": list(key),
            "probe_size": probe_size(cfg_a),
            "autotune_s": round(tune_s, 3), "autotune_parts": parts,
            "tuned": {"frontiers": list(cb_a.frontiers),
                      "k_leaf": cb_a.k_leaf,
                      "pair_mults": list(cb_a.pair_mults)},
            "default": default,
            "level_hit_counts_max_first_closest_batch": level_max[0],
            "level_hit_counts_max_first_closest_batch_of_each_segment":
                level_max,
            "overflow": ovf1, "steps_run": it1, "n_closest": nc1,
            "n_shadow": ns1, "launches": launches, "run_s": run_s,
            "repair": repair,
            "equals_render_exact_fallback_bitwise": n_differ == 0,
            "pixels_differ": n_differ,
            "max_abs_diff": float((final - img_fb).abs().max()),
            "mean_radiance": float(final.mean()),
            "tolerance": "final image vs render_exact's fallback render "
                         "bitwise, else rtol 2e-4 atol 2e-5; every cap >= "
                         "the level's measured maximum over the first "
                         "closest-hit batch of every probe segment"}
    emit(line)
    assert all(c >= m for c, m in zip(cb_a.frontiers, level_all)), \
        f"a tuned cap below its measured need: {cb_a.frontiers} {level_all}"
    assert bool(torch.isfinite(final).all())
    if n_differ:
        assert torch.allclose(final, img_fb, rtol=2e-4, atol=2e-5), \
            "render_autotune: tuned image vs render_exact's fallback render"
    del cb_a, img1, final, probes

    # (b) 1024², probed at 512².
    cam_h = meshes.big_camera(cfg.width, cfg.height)
    cb_h, tune_s, parts = tune_timed(scene_h, cam_h, cfg)
    cb_b = cb_h.to(DEV)
    del cb_h
    band = main["band"]
    zero_launches(kernels)
    (img, nc, ns, ovf, it), run_s = timed_sync(
        lambda: render_band(scene, cam_h.to(DEV), cfg, key, cb_b))
    launches = read_launches(kernels)
    equal = bool(torch.equal(img, band_of(img_main)))
    emit({"phase": "render_autotune", "part": "headline_autotune",
          "scene": "big-1m", "size": cfg.width, "rows": list(BAND_ROWS),
          "spp": cfg.spp,
          "max_depth": cfg.max_depth, "queue": 4096, "key": list(key),
          "probe_size": probe_size(cfg), "autotune_s": round(tune_s, 3),
          "autotune_parts": parts,
          "tuned": {"frontiers": list(cb_b.frontiers), "k_leaf": cb_b.k_leaf,
                    "pair_mults": list(cb_b.pair_mults)},
          "default": default, "overflow": ovf, "steps_run": it,
          "n_closest": nc, "n_shadow": ns, "launches": launches,
          "run_s": round(run_s, 3), "run_s_render_main_band": band["run_s"],
          "run_s_over_render_main_band": round(run_s / band["run_s"], 4),
          "image_equals_render_main_rows_bitwise": equal,
          "max_abs_diff": float((img - band_of(img_main)).abs().max()),
          "mean_radiance": float(img.mean())})
    assert launches["pair_ray_reduce"] == 2 * 4 * it, launches
    check_fetch_launches(launches, cb_b, it)
    assert bool(torch.isfinite(img).all())
    if ovf == 0:
        assert equal, "render_autotune: at overflow 0 the tuned band " \
            "must be render_main's rows bit for bit"


def phase_render_split(scene, cam, cb, cfg, main, img_main):
    """The headline's band (``BAND_ROWS``) through the two-kernel pair
    stage, once: bit-identical to ``render_main``'s rows, with the counts
    of its band render, timed beside that render on the same host.
    Returns the launches of its kernels in the render."""
    kernels = (pair_tile_isect, pair_segmin, pair_ray_reduce,
               pair_tile_isect_dedup, fetch_rows,
               fetch_fields)
    band = main["band"]
    zero_launches(kernels)
    (img, nc, ns, ovf, n_iter), run_s = timed_sync(
        lambda: render_band(scene, cam, cfg, (0, 3), cb, pair_stage="split"))
    launches = read_launches(kernels)
    equal = bool(torch.equal(img, band_of(img_main)))
    emit({"phase": "render_split", "scene": "big-1m", "size": cfg.width,
          "rows": list(BAND_ROWS), "spp": cfg.spp,
          "max_depth": cfg.max_depth, "queue": 4096,
          "run_s": round(run_s, 3), "run_s_render_main_band": band["run_s"],
          "run_s_fused_over_split": round(band["run_s"] / run_s, 4),
          "image_equals_render_main_rows_bitwise": equal,
          "steps_run": n_iter, "n_closest": nc, "n_shadow": ns,
          "overflow": ovf, "mean_radiance": float(img.mean()),
          "rays_per_s": round((nc + ns) / run_s, 1), "launches": launches})
    assert equal, "render_split: the band differs from render_main's rows " \
        "(must be bitwise)"
    assert (nc, ns, ovf, n_iter) == (band["n_closest"], band["n_shadow"],
                                     band["overflow"], band["steps_run"]), \
        "render_split: counts differ from render_main's band"
    assert launches["pair_tile_isect"] == 2 * 4 * n_iter, launches
    assert launches["pair_segmin"] == 2 * 4 * n_iter, launches
    assert launches["pair_ray_reduce"] == 0, launches
    assert launches["pair_tile_isect_dedup"] == 0, launches
    check_fetch_launches(launches, cb, n_iter)
    return {k: launches[k] for k in ("pair_tile_isect", "pair_segmin")}


def capacity_batch(cam, Q, mixed, block=None):
    """tests/test_capacity.py's batches on the headline camera (1024²):
    Q rays through seeded random pixel centres, or with ``block`` through
    the Q pixels from that one on (the wavefront's respawn order);
    ``mixed``: the second half replaced by rays from uniform origins in
    [-2, 2)^3 in uniform random directions (the incoherent bounce-like
    half)."""
    g = torch.Generator().manual_seed(11)
    pix = torch.randint(0, 1024 * 1024, (Q,), generator=g) if block is None \
        else block + torch.arange(Q)
    xy = pixel_xy(1024, 1024, pix, torch.full((Q, 2), 0.5))
    ro, rd = generate_rays(cam.to("cpu"), xy)
    if mixed:
        h = Q // 2
        ro_r = torch.rand((h, 3), generator=g) * 4 - 2
        rd_r = torch.randn((h, 3), generator=g)
        ro = torch.cat([ro[:h], ro_r])
        rd = torch.cat([rd[:h], rd_r / rd_r.norm(dim=1, keepdim=True)])
    return ro.contiguous().to(DEV), rd.contiguous().to(DEV)


def pair_level_loads(fn):
    """fn() with the per-level loads of every pair-major descent it runs
    collected (``cluster._descend_pairs(collect=)``): returns (fn's result,
    per level {"need_max_per_ray": the largest live (ray, node) pairs of a
    call over its rays, "dropped": pairs cut in all}), read once at the
    end."""
    real = cluster._descend_pairs
    got = []

    def spy(cb, ro, *a, **kw):
        col = []
        out = real(cb, ro, *a, collect=col, **kw)
        got.append([(n / ro.shape[0], d) for n, d in col])
        return out

    cluster._descend_pairs = spy
    try:
        out = fn()
    finally:
        cluster._descend_pairs = real
    return out, [{"need_max_per_ray": round(float(torch.stack(
                      [g[l][0] for g in got]).max()), 3),
                  "dropped": int(torch.stack([g[l][1] for g in got]).sum())}
                 for l in range(len(got[0]))]


def phase_render_modes(scene, cam, cb, cfg, main, img_main,
                       sliced: bool = False):
    """The headline (``render_main``'s cell: big-1m, 1024², spp 1, depth 4,
    RR from 2 at 0.7, queue 4096, key (0, 3), the host SAH cluster BVH)
    through the cluster BVH's two other traversal modes
    (``ClusterBVH.traversal_mode`` "frontier" and "pairs"), one render
    each in the default pair stage ("fused"), timed beside
    ``render_main``.  Every pair batch goes through ``pair_ray_reduce``,
    none through ``pair_tile_isect`` (K2) or any other pair kernel, and the
    child gathers are plain indexing (no ``fetch_fields``); each mode
    launches the fused kernel as often as the K2 twin launches K2
    (``MODE_LAUNCHES``: one launch a batch, and the rounds are the
    twin's).  "frontier" runs at
    overflow 0: its image must be ``render_main``'s bit for bit with the
    port's counts.

    The pair-major walk cuts its (ray, node) pairs to ``pair_mults[:3]`` x
    Q at every level, and at the BVH's own (8, 8, 6) it cuts the headline's
    coherent batches (the pairs of each level are collected:
    ``pair_level_loads``), as the JAX package's walk does on the same BVH
    and rays (tests/test_torch_pairs_headline.py::test_pairs_cuts_
    coherent_headline_blocks_as_jax_does); these modes flag no ray suspect,
    so nothing is repaired.  Its cut must be exactly ``PAIRS_RECORD``'s
    (281,374 candidates), its counts and mean that record's (the K2
    stage's figures), and the per-level cuts must add
    up to its overflow; its 0.5 % / 1 % distance from ``render_main``'s
    counts is printed, not held.

    With ``sliced`` (``--modes``), the headline once more in "frontier"
    through the "split" twin (K2 and array code): the image, counts and
    rounds (K2's launches) must be the fused render's; and in the compact
    mode with every step as two strided lane slices
    (``wavefront_accum(step_slices=2)``), timed: its image must be
    ``render_main``'s bit for bit with the port's counts (the whole run
    holds slicing bitwise in ``determinism``).  Last, the pair-major walk's capacity on tests/test_capacity.py's camera
    and mixed batches (4,096 rays): ``pairs_stats`` drops nothing and the
    leaf budget is at least 1.5 x the live pairs; ``candidate_stats`` cuts
    nothing; and, printed only, on the coherent block of 4,096 pixels from
    (512, 512).  Returns each render's launches."""
    kernels = (pair_tile_isect, pair_ray_reduce, pair_segmin,
               pair_tile_isect_dedup, packed_walk, fetch_rows, fetch_fields)
    by_path = {}
    record = (PORT_RECORD["n_closest"], PORT_RECORD["n_shadow"],
              PORT_RECORD["steps_run"])
    runs = [("frontier", "fused")] + ([("frontier", "split")] if sliced
                                      else []) + [("pairs", "fused")]
    for mode, stage in runs:
        zero_launches(kernels)
        render = functools.partial(
            wavefront.render_wavefront_counts, scene, cam, cfg, (0, 3),
            cb._replace(traversal_mode=mode), queue=4096, backend="cluster",
            device=DEV, pair_stage=stage)
        levels = None
        if mode == "frontier":
            (img, nc, ns, ovf, n_iter), run_s = timed_sync(render)
        else:
            ((img, nc, ns, ovf, n_iter), run_s), levels = pair_level_loads(
                lambda: timed_sync(render))
        launches = read_launches(kernels)
        mean = float(img.mean())
        equal = bool(torch.equal(img, img_main))
        d_counts = {k: (got - main[k]) / main[k] for k, got in (
            ("n_closest", nc), ("n_shadow", ns), ("mean_radiance", mean))}
        within = bool(abs(d_counts["n_closest"]) <= 0.005
                      and abs(d_counts["n_shadow"]) <= 0.005
                      and abs(d_counts["mean_radiance"]) <= 0.01)
        pair_kernel = "pair_ray_reduce" if stage == "fused" \
            else "pair_tile_isect"
        line = {"phase": "render_modes", "mode": mode, "pair_stage": stage,
                "scene": "big-1m", "size": cfg.width, "spp": cfg.spp,
                "max_depth": cfg.max_depth, "queue": 4096, "key": [0, 3],
                "pair_mults": list(cb.pair_mults), "run_s": round(run_s, 3),
                "run_s_render_main": main["run_s"],
                "run_s_all_render_main": main["run_s_all"],
                "run_s_over_render_main": round(run_s / main["run_s"], 4),
                "steps_run": n_iter, "n_closest": nc, "n_shadow": ns,
                "overflow": ovf, "mean_radiance": mean,
                "rays_per_s": round((nc + ns) / run_s, 1),
                "render_main": {k: main[k] for k in (
                    "steps_run", "n_closest", "n_shadow", "overflow",
                    "mean_radiance")},
                "rel_vs_render_main": d_counts,
                "within_counts_0.5pct_mean_1pct": within,
                "bounds_held": False if mode == "pairs" else "bitwise",
                "image_equals_render_main_bitwise": equal,
                "pair_kernel_launches": launches[pair_kernel],
                "pair_kernel_launches_expected": MODE_LAUNCHES[mode],
                "pair_levels": levels, "launches": launches}
        if mode == "pairs":
            line["pairs_record"] = PAIRS_RECORD
        emit(line)
        assert bool(torch.isfinite(img).all()), f"{mode}: image not finite"
        assert launches[pair_kernel] == MODE_LAUNCHES[mode], launches
        assert not any(n for k, n in launches.items()
                       if k != pair_kernel), launches
        if mode == "frontier":
            assert ovf == 0 and equal, f"render_modes {mode} {stage}: " \
                "overflow, or the image differs from render_main's"
            assert (nc, ns, n_iter) == record, \
                f"render_modes {mode} {stage}: counts moved from the record"
        else:
            assert sum(lv["dropped"] for lv in levels) == ovf, levels
            assert (ovf, nc, ns, n_iter, mean) == tuple(PAIRS_RECORD[k] for k in (
                "overflow", "n_closest", "n_shadow", "steps_run",
                "mean_radiance")), f"render_modes pairs moved from its record"
        by_path["render_modes_" + mode + ("" if stage == "fused"
                                          else "_" + stage)] = launches
        del img
    if sliced:
        zero_launches(kernels)
        (img, nc, ns, ovf, n_iter), run_s = timed_sync(
            lambda: render_sliced(scene, cam, cfg, (0, 3), cb, 2))
        launches = read_launches(kernels)
        equal = bool(torch.equal(img, img_main))
        emit({"phase": "render_modes", "mode": "compact, step_slices=2",
              "run_s": round(run_s, 3), "run_s_render_main": main["run_s"],
              "run_s_all_render_main": main["run_s_all"],
              "run_s_over_render_main": round(run_s / main["run_s"], 4),
              "steps_run": n_iter, "n_closest": nc, "n_shadow": ns,
              "overflow": ovf, "image_equals_render_main_bitwise": equal,
              "launches": launches})
        del img
        assert equal and (nc, ns, n_iter) == record and ovf == 0, \
            "render_modes: the sliced headline differs from render_main's"
        assert launches["pair_ray_reduce"] > 0, launches
    out = {}
    for name, mixed in (("camera", False), ("mixed", True)):
        Q = 4096
        ro, rd = capacity_batch(cam, Q, mixed)
        t_min = torch.zeros((Q, 1), device=DEV)
        t_max = torch.full((Q, 1), 1e30, device=DEV)
        n_live, dropped = cluster.pairs_stats(cb, ro, rd, t_min, t_max)
        n_cand, ovf_c = cluster.candidate_stats(cb, ro, rd, t_min, t_max)
        leaf_budget = cb.pair_mults[2] * Q
        out[name] = {"rays": Q, "n_live_pairs": int(n_live),
                     "dropped": int(dropped), "leaf_budget": leaf_budget,
                     "leaf_budget_over_live": round(leaf_budget
                                                    / max(1, int(n_live)), 3),
                     "candidates_mean": float(n_cand.float().mean()),
                     "candidates_max": int(n_cand.max()),
                     "candidate_overflow": int(ovf_c.sum())}
    ro, rd = capacity_batch(cam, 4096, False, block=512 * 1024 + 512)
    t_min = torch.zeros((4096, 1), device=DEV)
    t_max = torch.full((4096, 1), 1e30, device=DEV)
    n_live, dropped = cluster.pairs_stats(cb, ro, rd, t_min, t_max)
    out["block_512_512"] = {"rays": 4096, "n_live_pairs": int(n_live),
                            "dropped": int(dropped), "held": False}
    emit({"phase": "render_modes", "part": "capacity",
          "pair_mults": list(cb.pair_mults), **out})
    for name, rec in out.items():
        if name == "block_512_512":
            continue
        assert rec["dropped"] == 0, (name, rec)
        assert rec["leaf_budget"] >= 1.5 * rec["n_live_pairs"], (name, rec)
        assert rec["candidate_overflow"] == 0, (name, rec)
    return by_path


def kernel_us_in(fn, name_part):
    """fn() under torch.profiler (device activity only), and the durations
    in microseconds of the kernels whose name contains ``name_part``, read
    from the raw trace records (no per-op bookkeeping: a render launches
    some hundred thousand kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as profiler

    with profiler(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    us = [e.duration_ns() / 1e3 for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and name_part in e.name()]
    return out, us


def walks_traced(scene, cam, cfg, key, isect, occl, pix_chunk, design):
    """The oracle render through ``isect`` / ``occl`` with each chunk run
    under torch.profiler on its own (a whole render's hundred thousand
    kernel records lose one now and then): the durations in microseconds
    of every walk kernel of ``design`` it launched.  A chunk whose trace
    lacks one of the walks it launched is run again (the same rays, the
    same result), up to three times, and the phase fails if none holds
    them all.  Returns (image, durations, chunks run again); the launch
    counts of the walk then hold the accepted runs only."""
    from tpu_pt_torch.render import driver as driver_mod

    real = driver_mod.render_chunk
    counter = "launches" if design == "rows" else "thread_launches"
    us, retraced, launched = [], 0, 0

    def traced(*a, **k):
        nonlocal retraced, launched
        for attempt in range(3):
            before = getattr(flat_walk, counter)
            out, got = kernel_us_in(lambda: real(*a, **k), FLAT_KERNEL[design])
            n_c = getattr(flat_walk, counter) - before
            if len(got) == n_c:
                break
        assert len(got) == n_c, \
            f"bvh {design}: {len(got)} walk kernels traced of {n_c} in a chunk"
        retraced += attempt
        launched += n_c
        us.extend(got)
        return out

    driver_mod.render_chunk = traced
    try:
        img = _render_chunks(scene, cam, cfg, key, isect, occl, pix_chunk)
    finally:
        driver_mod.render_chunk = real
    setattr(flat_walk, counter, launched)
    return img, us, retraced


def flat_render_walks(scene, cam, cfg, key, fb, img, fp32_ops_per_s):
    """The walks of one full-size oracle render through backend "bvh", in
    each design: (a) the render once with every walk batch also counted by
    the row walk's STATS form (flat_walk_counts): the bound of each batch
    in each design as flat_work counts it, summed, with the batches' steps,
    lane efficiency and longest chains; (b) the render under torch.profiler
    in each design (the twin through ``render/driver.py``'s private
    ``design`` keyword), chunk by chunk (:func:`walks_traced`): the summed
    durations of its walk kernels, which must be every walk of the render,
    and the image, which must be ``img`` bit for bit."""
    from tpu_pt_torch.core.intersect import as_col

    pix_chunk = (1 << 17) // cfg.spp
    rows = flat.row_tables(fb, scene)
    isect, occl = _intersectors("bvh", fb)
    batches = []

    def counted(walk, any_hit):
        def call(scene_d, ro, rd, *t):
            R = ro.shape[0]
            t_min = torch.zeros((R, 1), device=DEV) if any_hit \
                else as_col(t[0], R, DEV)
            st = flat_walk_counts(*flat_args(fb, scene, ro, rd, t_min,
                                             as_col(t[-1], R, DEV)),
                                  any_hit=any_hit, rows=rows)
            bound_us = {}
            for d in FLAT_DESIGNS:
                n_bytes, ops, _ = flat_work(st, R, any_hit, scene.tri_idx, d)
                bound_us[d] = max(n_bytes / HBM_BYTES_PER_S,
                                  ops / fp32_ops_per_s) * 1e6
            steps, leaves, prims = st["steps"], st["leaves"], st["prims"]
            batches.append(dict(
                any_hit=any_hit, bound_us=bound_us,
                max_steps=int(steps.max()),
                lane_efficiency=flat_chains.lane_efficiency(steps),
                max_chain_thread=int((steps + 3 * prims).max()),
                max_chain_rows=int((steps + leaves).max())))
            return walk(scene_d, ro, rd, *t)
        return call

    img_c = _render_chunks(scene, cam, cfg, key, counted(isect, False),
                           counted(occl, True), pix_chunk)
    assert torch.equal(img_c, img), "bvh: the counted render differs"
    n = len(batches)
    out = {"batches": n,
           "max_steps_max": max(b["max_steps"] for b in batches),
           "lane_efficiency_min": min(b["lane_efficiency"] for b in batches),
           "lane_efficiency_mean": sum(b["lane_efficiency"]
                                       for b in batches) / n,
           "max_chain_thread_sum": sum(b["max_chain_thread"]
                                       for b in batches),
           "max_chain_rows_sum": sum(b["max_chain_rows"] for b in batches)}
    for design in FLAT_DESIGNS:
        isect, occl = _intersectors("bvh", fb, design=design)
        zero_launches((flat_walk,))
        img_d, us, retraced = walks_traced(scene, cam, cfg, key, isect, occl,
                                           pix_chunk, design)
        launched = read_launches((flat_walk,))
        other = "flat_walk" if design == "thread" else "flat_walk_thread"
        assert launched[other] == 0 and len(us) == n, \
            f"bvh {design}: {len(us)} walks traced of {n}, {launched}"
        assert torch.equal(img_d, img), \
            f"bvh {design}: image differs from the render's"
        bound = sum(b["bound_us"][design] for b in batches)
        out[design] = {"walk_us_sum": sum(us), "walk_us_max": max(us),
                       "trace_n": len(us), "chunks_retraced": retraced,
                       "launches": launched, "bound_us_sum": bound,
                       "share_of_bound": bound / sum(us)}
    out["rows_over_thread"] = \
        out["rows"]["walk_us_sum"] / out["thread"]["walk_us_sum"]
    return out


def phase_render_oracle():
    """The oracle renderer through the dense-sweep backend (``"pallas"``)
    and the flat BVH walk (``"bvh"``): small renders held against the brute
    backend, the plain versions and the wavefront renderer (on the brute
    and on the backend's intersector), then the full-size renders (512x512,
    spp 16, depth 4, the command line's defaults; the walks of the "bvh"
    renders in both designs, ``flat_render_walks``, are ``--walks``'
    A/B).  Returns the launches of the dense kernels and of the flat walk
    on the full-size Cornell mesh renders."""
    scenes = {"cornell_mesh_4": cornell.cornell("mesh", mesh_subdiv=4),
              "cornell_spheres": cornell.cornell("spheres")}
    small = RenderConfig(width=64, height=64, spp=4, max_depth=3)
    full = RenderConfig(width=512, height=512, spp=16, max_depth=4)
    key = (0, 0)
    launches, means, run_s_of = {}, {}, {}
    for backend, kernels in (("pallas", (dense_closest, dense_anyhit)),
                             ("bvh", (flat_walk,))):
        out = []
        for name, scene_h in scenes.items():
            bvh = PallasScene(scene_h) if backend == "pallas" \
                else sah.build_bvh(scene_h)
            cam_s = cornell.camera(small.width, small.height)
            img_k = render(scene_h, cam_s, small, key, backend=backend,
                           bvh=bvh, device=DEV)
            img_p = render(scene_h, cam_s, small, key, backend=backend,
                           bvh=bvh, device=DEV, use_kernels=False)
            img_b = render(scene_h, cam_s, small, key, backend="brute",
                           device=DEV)
            # The wavefront renderer against the oracle renderer, each pair
            # on ONE intersector, so that only the scheduling differs (two
            # intersectors round t differently, and an ulp of t moves a
            # specular path: that pair is held to the looser tolerance).
            img_wb = wavefront.render_wavefront(scene_h, cam_s, small, key,
                                                None, queue=4096,
                                                backend="brute", device=DEV)
            # "bvh" is the wavefront entry points' default backend (the
            # JAX package's): its render passes none, and must have walked
            # the flat BVH through the row walk.
            wf_kw = {} if backend == "bvh" else dict(backend=backend)
            zero_launches((flat_walk,))
            img_wk = wavefront.render_wavefront(scene_h, cam_s, small, key,
                                                bvh, queue=4096, device=DEV,
                                                **wf_kw)
            wf_walks = read_launches((flat_walk,))
            if backend == "bvh":
                assert wf_walks["flat_walk"] > 0 \
                    and wf_walks["flat_walk_thread"] == 0, wf_walks
            assert bool(torch.isfinite(img_k).all())
            assert bool(torch.equal(img_k, img_p)), \
                f"{backend} {name}: image with kernels differs from the " \
                "plain versions'"
            assert torch.allclose(img_k, img_b, rtol=1e-3, atol=1e-3), \
                f"{backend} {name}: backend vs brute backend"
            assert torch.allclose(img_wb, img_b, rtol=2e-4, atol=2e-5), \
                f"{name}: wavefront renderer vs oracle renderer (brute)"
            assert torch.allclose(img_wk, img_k, rtol=2e-4, atol=2e-5), \
                f"{backend} {name}: wavefront renderer vs oracle renderer"
            cam = cornell.camera(full.width, full.height)
            scene, cam, bvh = scene_h.to(DEV), cam.to(DEV), bvh.to(DEV)
            torch.cuda.reset_peak_memory_stats()
            # The launch counts of this path: zeroed just before one
            # full-size render (after the small ones above), read just
            # after it.
            zero_launches(kernels)
            img, run_s = timed_sync(lambda: render(
                scene, cam, full, key, backend=backend, bvh=bvh, device=DEV))
            n_launch = read_launches(kernels)
            hits = full.max_depth + 1
            shadow = scene.lights.count * full.ns_area_light
            chunks = -(-full.n_pixels // ((1 << 17) // full.spp))
            for kname, n in n_launch.items():
                want = chunks * hits * {"dense_closest": 1,
                                        "dense_anyhit": shadow,
                                        "flat_walk": 1 + shadow,
                                        "flat_walk_thread": 0}[kname]
                assert n == want, \
                    f"{name}: {kname} launched {n} times, not {want}"
            assert bool(torch.isfinite(img).all()), \
                f"{backend} {name}: image not finite"
            assert tuple(img.shape) == (full.height, full.width, 3)
            mean = float(img.mean())
            means[backend, name] = mean
            rays_cast = full.n_pixels * full.spp * hits * (1 + shadow)
            run_s_of[backend, name] = run_s
            line = {"scene": name, "size": full.width, "spp": full.spp,
                    "max_depth": full.max_depth, "key": list(key),
                    "small": {"size": small.width, "spp": small.spp,
                              "max_depth": small.max_depth,
                              "kernels_vs_plain_bitwise": True,
                              "max_abs_diff_vs_brute":
                                  float((img_k - img_b).abs().max()),
                              "max_abs_diff_wavefront_brute":
                                  float((img_wb - img_b).abs().max()),
                              f"max_abs_diff_wavefront_{backend}":
                                  float((img_wk - img_k).abs().max()),
                              "max_abs_diff_wavefront_brute_vs_oracle_"
                              f"{backend}": float((img_wb - img_k).abs().max()),
                              "wavefront_backend": wf_kw.get(
                                  "backend", "the default"),
                              "wavefront_launches": wf_walks,
                              "tolerance": f"{backend} vs brute rtol 1e-3 "
                                           "atol 1e-3; wavefront vs oracle "
                                           "on one intersector rtol 2e-4 "
                                           "atol 2e-5"},
                    "run_s": round(run_s, 3), "rays_cast": rays_cast,
                    "rays_cast_per_s": round(rays_cast / run_s, 1),
                    "launches": n_launch, "mean_radiance": mean,
                    "peak_mem_MB": round(
                        torch.cuda.max_memory_allocated() / 1e6, 1)}
            if backend == "pallas":
                line.update(rows=int(bvh.prims.shape[0]),
                            n_prims=bvh.n_prims)
            else:
                line.update(
                    n_nodes=bvh.n_nodes,
                    run_s_pallas=round(run_s_of["pallas", name], 3),
                    run_s_over_pallas=round(
                        run_s / run_s_of["pallas", name], 4),
                    mean_radiance_pallas=means["pallas", name],
                    vs_pallas=mean - means["pallas", name])
                assert abs(mean - means["pallas", name]) \
                    <= 0.005 * means["pallas", name], \
                    f"bvh {name}: mean_radiance {mean} not within 0.5 % of " \
                    f"the pallas render's {means['pallas', name]}"
            if name == "cornell_spheres":
                line["anchor_mean_radiance"] = ORACLE_ANCHOR
                line["vs_anchor"] = mean - ORACLE_ANCHOR
                assert abs(mean - ORACLE_ANCHOR) <= 0.005 * ORACLE_ANCHOR, \
                    f"{backend}: mean_radiance {mean} not within 0.5 % of " \
                    f"{ORACLE_ANCHOR}"
            else:
                png = "chip_smoke_cornell_mesh.png" if backend == "pallas" \
                    else "chip_smoke_cornell_mesh_bvh.png"
                film.save(png, img.cpu().numpy())
                launches.update(n_launch)
            out.append(line)
        emit({"phase": "render_oracle", "backend": backend, "renders": out})
    return launches


def phase_spheres_parity():
    """The Cornell spheres at 64 x 32, spp 2, depth 2 (roulette from bounce
    1 at 0.8), key 11, through ``render_wavefront`` on the card, on
    "brute" and on "pallas" (the dense kernels): each image within rtol
    2e-4 / atol 2e-5 of the port's CPU render of the same call and within
    2e-5 absolute of the float64 CPU render (scene and camera in float64,
    the random numbers float32 as always), at every pixel.  Returns the
    dense kernels' launches on the "pallas" render."""
    from tpu_pt_torch.tools.sphere_edges import as_float64  # this checkout's

    cfg = RenderConfig(width=64, height=32, spp=2, max_depth=2, rr_start=1,
                       rr_prob=0.8)
    key = (0, 11)
    scene_h, cam_h = cornell.cornell("spheres"), cornell.camera(64, 32)

    def render(backend, device, scene=scene_h, cam=cam_h):
        bvh = PallasScene(scene_h) if backend == "pallas" else None
        t0 = time.time()
        img = wavefront.render_wavefront(scene, cam, cfg, key, bvh,
                                         queue=4096, backend=backend,
                                         device=device)
        sync()
        return img.cpu(), time.time() - t0

    witness, witness_s = render("brute", "cpu", as_float64(scene_h.to("cpu")),
                                as_float64(cam_h.to("cpu")))
    assert witness.dtype == torch.float64
    line = {"phase": "spheres_parity", "size": [cfg.width, cfg.height],
            "spp": cfg.spp, "max_depth": cfg.max_depth, "key": list(key),
            "tolerance": "vs the CPU render rtol 2e-4 atol 2e-5; vs the "
                         "float64 CPU render atol 2e-5",
            "witness_s": round(witness_s, 2)}
    for backend in ("brute", "pallas"):
        img_c, cpu_s = render(backend, "cpu")
        zero_launches((dense_closest, dense_anyhit))
        img, run_s = render(backend, DEV)
        n = read_launches((dense_closest, dense_anyhit))
        if backend == "pallas":
            assert n["dense_closest"] > 0 and n["dense_anyhit"] > 0, n
            launches = n
        else:
            assert not any(n.values()), n
        apart = int((~torch.isclose(img, img_c, rtol=2e-4, atol=2e-5)).sum())
        err_w = float((img.double() - witness).abs().max())
        line[backend] = {
            "launches": n, "run_s": round(run_s, 3), "cpu_s": round(cpu_s, 3),
            "mean_radiance": float(img.mean()),
            "values_apart_from_cpu": apart,
            "max_abs_diff_vs_cpu": float((img - img_c).abs().max()),
            "max_abs_err_vs_float64": err_w,
            "cpu_max_abs_err_vs_float64": float(
                (img_c.double() - witness).abs().max())}
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.1
        assert apart == 0, \
            f"spheres_parity {backend}: {apart} values past rtol 2e-4 / " \
            "atol 2e-5 of the CPU render"
        assert err_w <= 2e-5, \
            f"spheres_parity {backend}: {err_w} from the float64 render"
    emit(line)
    return launches


def phase_render_dedup(scene, cam, cb, cfg, main, img_main):
    """The headline's band (``BAND_ROWS``) once through the cluster-major
    pair stage, held to this run's band render of ``render_main``.
    Returns the launches of its kernel."""
    kernels = (pair_tile_isect_dedup, pair_tile_isect, pair_segmin,
               pair_ray_reduce, fetch_rows,
               fetch_fields)
    band = main["band"]
    zero_launches(kernels)
    (img, nc, ns, ovf, n_iter), run_s = timed_sync(
        lambda: render_band(scene, cam, cfg, (0, 3), cb, pair_stage="dedup"))
    launches = read_launches(kernels)
    mean = float(img.mean())
    emit({"phase": "render_dedup", "scene": "big-1m", "size": cfg.width,
          "rows": list(BAND_ROWS), "spp": cfg.spp,
          "max_depth": cfg.max_depth, "queue": 4096,
          "run_s": round(run_s, 3), "run_s_render_main_band": band["run_s"],
          "steps_run": n_iter, "n_closest": nc, "n_shadow": ns,
          "overflow": ovf, "mean_radiance": mean,
          "rays_per_s": round((nc + ns) / run_s, 1),
          "launches": launches,
          "image_equals_render_main_rows_bitwise": bool(
              torch.equal(img, band_of(img_main))),
          "vs_render_main_band": {
              "n_closest": nc - band["n_closest"],
              "n_shadow": ns - band["n_shadow"],
              "steps_run": n_iter - band["steps_run"],
              "mean_radiance": mean - band["mean_radiance"]}})
    assert bool(torch.isfinite(img).all()), "render_dedup: image not finite"
    assert ovf == 0, f"render_dedup: overflow {ovf}"
    assert n_iter == band["steps_run"], f"render_dedup: steps_run {n_iter}"
    assert abs(mean - band["mean_radiance"]) <= 0.01 * band["mean_radiance"], \
        f"render_dedup: mean_radiance {mean} vs {band['mean_radiance']}"
    for name, got in (("n_closest", nc), ("n_shadow", ns)):
        assert abs(got - band[name]) <= 1e-3 * band[name], \
            f"render_dedup: {name} {got} vs render_main's band {band[name]}"
    # 2 traversals x 4 sub-batches a step.
    assert launches["pair_tile_isect_dedup"] == 2 * 4 * n_iter, launches
    assert launches["pair_tile_isect"] == 0 and launches["pair_segmin"] == 0 \
        and launches["pair_ray_reduce"] == 0, launches
    check_fetch_launches(launches, cb, n_iter)
    return {"pair_tile_isect_dedup": launches["pair_tile_isect_dedup"]}


def phase_loop(scene, cam, cb, cfg, key, profile, pair_stage, n_warm=30,
               n_steps=20, fetch="fields"):
    """Steady-state steps of the full-width loop with the given form of the
    pair stage (and of the descent's child fetch: ``fetch="rows"`` patches
    the row form into every descent), timed on the host clock:
    wall time per step and the part of it the host spends blocked in the
    loop condition's read of the device (``any(alive)``), which is where
    it waits for the step it queued.  With ``profile`` the same steps run
    once more under torch.profiler for the device's busy share and the
    kernels' own device time."""
    real_descend = cluster._descend_compact
    if fetch != "fields":
        cluster._descend_compact = \
            lambda *a, **k: real_descend(*a, **k, fetch=fetch)
    try:
        phase_loop_1(scene, cam, cb, cfg, key, profile, pair_stage, n_warm,
                     n_steps, fetch)
    finally:
        cluster._descend_compact = real_descend


def phase_loop_1(scene, cam, cb, cfg, key, profile, pair_stage, n_warm,
                 n_steps, fetch):
    isect, occl = _intersectors_counted("cluster", cb, pair_stage=pair_stage)
    st = wavefront.init_queue(4096, cfg.n_pixels, DEV)

    def steps(st, n):
        read_s = 0.0
        for _ in range(n):
            t0 = time.time()
            bool(torch.any(st.alive))          # the loop's host read
            read_s += time.time() - t0
            st, _ = wavefront._step(scene, cam, cfg, key, isect, occl, st, 0,
                                    cfg.n_pixels, 0, cfg.spp,
                                    shadow_narrow=True)
        return st, read_s

    with torch.no_grad():
        for i in range(n_warm):
            st, _ = wavefront._step(scene, cam, cfg, key, isect, occl, st, 0,
                                    cfg.n_pixels, 0, cfg.spp,
                                    shadow_narrow=i >= 2)
        sync()
        t0 = time.time()
        st, read_s = steps(st, n_steps)
        sync()
        wall = time.time() - t0
        wall_plain = wall
        emit({"phase": "loop", "mode": cb.traversal_mode,
              "pair_stage": pair_stage, "fetch": fetch,
              "steps": n_steps,
              "wall_ms_per_step": round(wall / n_steps * 1e3, 3),
              "host_read_ms_per_step": round(read_s / n_steps * 1e3, 3),
              "host_read_share": round(read_s / wall, 4)})
        if not profile:
            return
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as profiler

        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            st, _ = steps(st, n_steps)
            sync()
            wall = time.time() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = 0.0
    by_name = {}
    for e in kern:
        us = e.time_range.elapsed_us()
        dev_us += us
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ours = {k: v for k, v in by_name.items()
            if any(part in k for part in (
                "pair_major_kernel", "pair_tile_isect_kernel",
                "pair_segmin_kernel", "pair_tile_isect_dedup_kernel",
                "fetch_fields_kernel", "fetch_rows_kernel"))}
    emit({"phase": "profile", "mode": cb.traversal_mode,
          "pair_stage": pair_stage, "fetch": fetch,
          "steps": n_steps,
          "wall_ms_per_step_profiled": round(wall / n_steps * 1e3, 3),
          "device_kernels_per_step": round(len(kern) / n_steps, 1),
          "device_busy_ms_per_step": round(dev_us / n_steps / 1e3, 3)
          if dev_us else None,
          "device_busy_share_profiled": round(dev_us / 1e6 / wall, 4)
          if dev_us else None,
          # kernel durations from the trace over the UNPROFILED wall time
          "device_busy_share": round(dev_us / 1e6 / wall_plain, 4)
          if dev_us else None,
          "port_kernels": [
              {"name": k[:90], "n_per_step": round(v[0] / n_steps, 1),
               "us_per_launch": round(v[1] / v[0], 2),
               "share_of_device_time": round(v[1] / dev_us, 4)}
              for k, v in ours.items()],
          "top_device_kernels": [
              {"name": k[:80], "n_per_step": round(v[0] / n_steps, 1),
               "us_per_step": round(v[1] / n_steps, 1)} for k, v in top]})


def phase_mode_kernels(scene, cam, cb, cfg, fp32_ops_per_s):
    """``--modes``: the kernels phase's check of the frontier and
    pair-major walks' pair batches (``check_mode_batches``) on their own,
    with each batch's bound."""
    _, _, _, mid_full, _ = queue_batches(scene, cam, cb, cfg, (0, 3), 4096,
                                         N_WARM)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    cases, timing = check_mode_batches(cb, mid_full, flush, ab=True)
    del flush
    emit({"phase": "kernels_modes", "cases": cases,
          "batches": {k: {**{f: v[f] for f in (
              "shape", "ms", "trace_us", "trace_n", "trace_warm_us",
              "trace_warm_n", "plain_ms", "path_ms", "twin_path_ms")
              if f in v},
              "bound_us": max(v["bytes"] / HBM_BYTES_PER_S,
                              v["flops"] / fp32_ops_per_s) * 1e6}
              for k, v in timing.items()}})


def phase_loop_pairs(scene, cam, cb, cfg, key, n_warm=30, n_steps=10):
    """Each launch of the fused pair kernel in steady-state steps of the
    full-width loop: its form (closest or any hit), the size of its operands
    (slots, rays, live pairs, distinct tiles, longest segment) and its own
    duration in a profiler trace, matched launch by launch.  Reading the
    operands makes the host wait for the device after each launch; the
    kernels' durations on the device do not depend on that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as profiler

    real = cluster.pair_ray_reduce
    seen = []

    def spy(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right,
            any_hit=False):
        out = real(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right,
                   any_hit=any_hit)
        live = int(right[-1])
        seen.append({"any_hit": bool(any_hit), "P": int(cid.shape[0]),
                     "Q": int(cnt.shape[0]), "live_pairs": live,
                     "live_tiles": int(cid[:live].unique().numel()),
                     "max_pairs_of_a_ray": int(cnt.max())})
        return out

    isect, occl = _intersectors_counted("cluster", cb, pair_stage="fused")
    st = wavefront.init_queue(4096, cfg.n_pixels, DEV)
    with torch.no_grad():
        for i in range(n_warm):
            st, _ = wavefront._step(scene, cam, cfg, key, isect, occl, st, 0,
                                    cfg.n_pixels, 0, cfg.spp,
                                    shadow_narrow=i >= 2)
        sync()
        cluster.pair_ray_reduce = spy
        try:
            with profiler(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                for _ in range(n_steps):
                    st, _ = wavefront._step(scene, cam, cfg, key, isect, occl,
                                            st, 0, cfg.n_pixels, 0, cfg.spp,
                                            shadow_narrow=True)
                sync()
        finally:
            cluster.pair_ray_reduce = real
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "pair_major_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    matched = len(kern) == len(seen) and all(
        (", true>" in e.name) == s["any_hit"] for e, s in zip(kern, seen))
    forms = {}
    for any_hit in (False, True):
        rows = [s for s in seen if s["any_hit"] == any_hit]
        us = [e.time_range.elapsed_us() for e in kern
              if (", true>" in e.name) == any_hit]
        f = {"launches": len(rows), "traced": len(us),
             "us_median": statistics.median(us) if us else None,
             "us_mean": statistics.fmean(us) if us else None}
        for k in ("P", "Q", "live_pairs", "live_tiles", "max_pairs_of_a_ray"):
            f[k + "_mean"] = statistics.fmean(r[k] for r in rows)
        if matched:
            x = np.array([r["live_pairs"] for r in rows], np.float64)
            y = np.array([e.time_range.elapsed_us() for e, s in zip(kern, seen)
                          if s["any_hit"] == any_hit])
            slope, icpt = np.polyfit(x, y, 1)
            f["us_fit"] = {"per_1000_live_pairs": float(slope * 1e3),
                           "at_0": float(icpt)}
        forms["any_hit" if any_hit else "closest"] = f
    emit({"phase": "loop_pairs", "pair_stage": "fused", "steps": n_steps,
          "matched_launch_by_launch": matched, "forms": forms})


# --------------------------------------------------------------------------
# The device builds: the LBVH and the Morton-chunk cluster build
# --------------------------------------------------------------------------

def timed_sync(fn):
    """(fn(), seconds), the device synchronised before and after."""
    sync()
    t0 = time.time()
    out = fn()
    sync()
    return out, time.time() - t0


def lbvh_invariants(lb, p):
    """tests/test_lbvh.py:48-69 on an LBVH of p primitives: 2p-1 nodes, p
    leaves naming every sorted slot once, a permutation for prim_gid, skip
    pointers in (i, 2p-1], a root box around every node."""
    nodes = lb.node_rows()[0]
    meta = nodes[:, 7].view(np.int32)
    skip = nodes[:, 6].view(np.int32)
    leaf = meta >= 0
    ids = np.arange(2 * p - 1)
    checks = {
        "n_nodes": lb.n_nodes == 2 * p - 1 == nodes.shape[0],
        "leaves": int(leaf.sum()) == p,
        "slots_once": np.array_equal(
            np.sort(meta[leaf] & ((1 << 26) - 1)), np.arange(p)),
        "prim_gid_permutation": np.array_equal(
            np.sort(lb.prim_gid.cpu().numpy()), np.arange(p)),
        "skip_forward": bool((skip > ids).all() and (skip <= 2 * p - 1).all()),
        "root_box_holds_all": bool(
            (nodes[0, 0:3] <= nodes[:, 0:3] + 1e-5).all()
            and (nodes[0, 3:6] >= nodes[:, 3:6] - 1e-5).all())}
    return checks


def cluster_build_checks(cb, p):
    """A cluster build's lanes: live lanes (a non-zero row) first in every
    tile, every gid on exactly one live lane, and ``tile_gid`` ascending
    over each tile's live lanes (``pair_ray_reduce``'s build invariant)."""
    L = cb.tiles.shape[2]
    live = cb.tiles.abs().sum(1) > 0
    gid = cb.tile_gid.long()
    prefix = bool(torch.equal(live, torch.arange(L, device=live.device)[None]
                              < live.sum(1, keepdim=True)))
    return {"live_lanes_first": prefix,
            "every_gid_once": bool(
                (torch.bincount(gid[live], minlength=p) == 1).all())
            and int(live.sum()) == p,
            "tile_gid_ascending": bool(
                ((gid[:, 1:] > gid[:, :-1]) | ~live[:, 1:]).all())}


def builds_equal(a, b):
    """Array by array, bit for bit, and the static fields: two LBVHs
    (``PackedBVH``) or two cluster builds."""
    def same(x, y):
        x, y = x.cpu(), y.cpu()
        return x.dtype == y.dtype and x.shape == y.shape and bool(
            torch.equal(x.view(torch.int16), y.view(torch.int16)))
    if isinstance(a, packed.PackedBVH):
        return {"table": same(a.table, b.table),
                "prim_gid": same(a.prim_gid, b.prim_gid),
                "static": (a.n_nodes, a.n_tables, a.max_leaf)
                == (b.n_nodes, b.n_tables, b.max_leaf)}
    return {"levels": all(same(x, y) for x, y in zip(a.levels, b.levels))
            and len(a.levels) == len(b.levels),
            "levels16": all(same(x, y) for x, y in zip(a.levels16,
                                                       b.levels16)),
            "tiles": same(a.tiles, b.tiles),
            "tile_gid": same(a.tile_gid, b.tile_gid),
            "static": (a.frontiers, a.k_leaf, a.pair_budget, a.pair_mults)
            == (b.frontiers, b.k_leaf, b.pair_budget, b.pair_mults)}


def cluster_shape(cb):
    return {"n_clusters": cb.n_clusters,
            "level_sizes": [int(lv.shape[0]) for lv in cb.levels],
            "frontiers": list(cb.frontiers), "k_leaf": cb.k_leaf,
            "pair_budget": cb.pair_budget, "pair_mults": list(cb.pair_mults)}


def without_spheres(scene):
    """``scene`` with no spheres.  big-1m's one sphere is ``make_scene``'s
    placeholder (radius 0 at 1e8): it stretches the scene box until every
    triangle's Morton code is 0, so the builds sort equal keys.  Without
    it the codes spread over the mesh's own box."""
    return scene._replace(sph_center=scene.sph_center[:0],
                          sph_radius=scene.sph_radius[:0],
                          sph_mat=scene.sph_mat[:0])


def distinct_codes(lo, hi):
    """How many distinct Morton codes the centroids of boxes lo, hi get."""
    codes = lbvh.morton_codes((lo + hi) * 0.5, lo.amin(0), hi.amax(0))
    return int(torch.unique(codes).numel())


def device_builds(scene_h, scene):
    """``lbvh.build_lbvh`` and ``cluster.build_cluster_device`` of
    ``scene`` (on the card; ``scene_h`` its host arrays), each timed on its
    first call and on a warm one; the LBVH's invariants, the cluster
    build's lanes, and both equal, array by array, to the same functions
    run on the CPU (timed).  Returns (record, LBVH, cluster build)."""
    p = scene_h.n_prims
    lb, lb_first = timed_sync(lambda: lbvh.build_lbvh(scene, device=DEV))
    lb, lb_warm = timed_sync(lambda: lbvh.build_lbvh(scene, device=DEV))
    cd, cd_first = timed_sync(
        lambda: cluster.build_cluster_device(scene, device=DEV))
    cd, cd_warm = timed_sync(
        lambda: cluster.build_cluster_device(scene, device=DEV))
    assert lb.table.device.type == "cuda" and cd.tiles.device.type == "cuda"
    inv = lbvh_invariants(lb, p)
    lanes = cluster_build_checks(cd, p)
    t0 = time.time()
    lb_c = lbvh.build_lbvh(scene_h, device="cpu")
    cpu_lb_s = time.time() - t0
    t0 = time.time()
    cd_c = cluster.build_cluster_device(scene_h, device="cpu")
    cpu_cd_s = time.time() - t0
    eq_lb, eq_cd = builds_equal(lb, lb_c), builds_equal(cd, cd_c)
    del lb_c, cd_c
    rec = {"n_prims": p,
           "distinct_morton_codes": distinct_codes(*sah.prim_bounds(scene)),
           "lbvh_build_s": {"first": round(lb_first, 4),
                            "warm": round(lb_warm, 4)},
           "device_cluster_build_s": {"first": round(cd_first, 4),
                                      "warm": round(cd_warm, 4)},
           "cpu_builds_s": {"lbvh": round(cpu_lb_s, 2),
                            "cluster_device": round(cpu_cd_s, 2)},
           "lbvh": {"n_nodes": lb.n_nodes, "n_tables": lb.n_tables,
                    "max_leaf": lb.max_leaf,
                    "table_MB": round(lb.table.numel() * 4 / 1e6, 1),
                    "invariants": inv, "equals_cpu_build": eq_lb},
           "cluster_device": {**cluster_shape(cd), "lanes": lanes,
                              "equals_cpu_build": eq_cd}}
    assert lb.n_nodes == 2 * p - 1, (lb.n_nodes, p)
    assert all(inv.values()), inv
    assert all(lanes.values()), lanes
    assert all(eq_lb.values()) and all(eq_cd.values()), (eq_lb, eq_cd)
    return rec, lb, cd


def random_boxes_arrays(n, seed):
    """``lbvh.build_lbvh_arrays`` on n random boxes made from ``seed`` (in
    [-1, 1]^3, sides up to 0.01: codes nearly all distinct), on the card
    (first and warm call) and on the CPU: the invariants and the two
    builds equal bit for bit."""
    rs = np.random.RandomState(seed)
    lo = rs.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.0, 0.01, (n, 3)).astype(np.float32)
    lo_h, hi_h = torch.from_numpy(lo), torch.from_numpy(hi)
    lo_d, hi_d = lo_h.to(DEV), hi_h.to(DEV)
    _, first = timed_sync(lambda: lbvh.build_lbvh_arrays(lo_d, hi_d))
    (nodes, perm), warm = timed_sync(
        lambda: lbvh.build_lbvh_arrays(lo_d, hi_d))
    t0 = time.time()
    nodes_c, perm_c = lbvh.build_lbvh_arrays(lo_h, hi_h)
    cpu_s = time.time() - t0
    inv = lbvh_invariants(packed.PackedBVH(
        table=nodes[0].cpu(), prim_gid=perm.cpu(), max_leaf=1, n_tables=1,
        n_nodes=nodes.shape[1]), n)
    eq = {"nodes": bool(torch.equal(nodes.cpu().view(torch.int32),
                                    nodes_c.view(torch.int32))),
          "perm": bool(torch.equal(perm.cpu(), perm_c))}
    rec = {"n_prims": n, "seed": seed,
           "distinct_morton_codes": distinct_codes(lo_d, hi_d),
           "build_lbvh_arrays_s": {"first": round(first, 4),
                                   "warm": round(warm, 4)},
           "cpu_s": round(cpu_s, 2), "invariants": inv,
           "equals_cpu_build": eq}
    assert all(inv.values()), inv
    assert all(eq.values()), eq
    return rec


def phase_build_device(scene_h, scene, host_s):
    """The device builds of big-1m on the card (the scene already there),
    beside the host builds of ``build`` (``device_builds``).  Every
    triangle of big-1m gets Morton code 0 (``without_spheres``), so the
    same checks and times are taken on inputs whose codes are real: big-1m
    without its placeholder sphere, the Cornell box with spheres, and
    1,310,722 random boxes (``random_boxes_arrays``).  Returns big-1m's
    two builds."""
    rec, lb, cd = device_builds(scene_h, scene)
    real = {}
    for name, sh in (("big-1m_without_placeholder", without_spheres(scene_h)),
                     ("cornell_spheres", cornell.cornell("spheres"))):
        real[name] = device_builds(sh, sh.to(DEV))[0]
        assert real[name]["distinct_morton_codes"] > 1, (name, real[name])
    real["random_boxes"] = random_boxes_arrays(scene_h.n_prims - 1, 11)
    assert real["random_boxes"]["distinct_morton_codes"] > 1
    emit({"phase": "build_device", "scene": "big-1m", **rec,
          "host_builds_s": host_s, "real_codes": real,
          "tolerance": "invariants of tests/test_lbvh.py:48-69; the card's "
                       "builds torch.equal to the CPU's, array by array, "
                       "on big-1m (all codes 0) and on three inputs whose "
                       "codes are real"})
    return lb, cd


def lbvh_batches(scene, cam, lb, cfg, key, queue, n_warm):
    """Two walk batches of the headline on the LBVH, from the queue after
    ``n_warm`` steps (the packed backend walks the whole queue at once):
    its camera rays (the lanes spawned this step; the rest get t_max = -1
    and leave at the root) and its bounces (the other live lanes), each
    with the shadow rays of the step, masked the same way.  name -> (ro,
    rd, t_max (Q,), shadow (ro, rd, t_max (Q,)))."""
    isect, occl_c = _intersectors_counted("packed", lb)
    caught = []

    def occl(scene, ro, rd, t_max, narrow=False):
        caught[:] = [ro, rd, t_max[:, 0]]
        return occl_c(scene, ro, rd, t_max, narrow=narrow)

    st = wavefront.init_queue(queue, cfg.n_pixels, DEV)
    with torch.no_grad():
        for i in range(n_warm + 1):
            if i == n_warm:
                nxt = wavefront._respawn(cam, cfg, key, st, 0, cfg.n_pixels,
                                         0, cfg.spp)
            st, _ = wavefront._step(scene, cam, cfg, key, isect, occl, st, 0,
                                    cfg.n_pixels, 0, cfg.spp)
    alive = nxt.alive[:, 0]
    out = {}
    for name, lanes in (("camera", alive & (nxt.depth == 0)),
                        ("bounce", alive & (nxt.depth > 0))):
        def masked(t):
            return torch.where(lanes, t, -1.0).contiguous()
        out[name] = (nxt.ro.contiguous(), nxt.rd.contiguous(),
                     masked(torch.full_like(nxt.rd[:, 0], 1e30)),
                     (caught[0].contiguous(), caught[1].contiguous(),
                      masked(caught[2])))
    return out


def phase_render_lbvh(scene, cam, cfg, lb, pk, main, img_main, img_packed,
                      fp32_ops_per_s):
    """The headline's band (``BAND_ROWS`` of 1024², spp 1, depth 4, queue
    4096, key (0, 3)) through the packed backend on the LBVH (one walk a
    traversal: the closest hit and the shadow ray of each step); its counts
    and mean beside ``render_main``'s band render's.  Then the LBVH at ``render_exact``'s 256² cell
    against that phase's ``"packed"`` render on the SAH packed BVH (the
    same row test), and the walk in both designs bitwise against the plain
    walk on a camera and a bounce batch of the headline, closest and any
    hit, timed beside the SAH packed BVH on the same rays.  Returns the
    launches."""
    key = (0, 3)
    kernels = (packed_walk, pair_ray_reduce, fetch_fields, fetch_rows)
    band = main["band"]
    zero_launches(kernels)
    (img, nc, ns, ovf, it), run_s = timed_sync(
        lambda: render_band(scene, cam, cfg, key, lb, backend="packed"))
    launches = read_launches(kernels)
    traversals = 1 + scene.lights.count * cfg.ns_area_light
    diff = (img - band_of(img_main)).abs().amax(-1)
    mean = float(img.mean())

    # render_exact's cell, the same walk over two BVHs.
    cfg_s = RenderConfig(width=256, height=256, spp=1, max_depth=4,
                         rr_start=2, rr_prob=0.7)
    img_s, *counts_s = wavefront.render_wavefront_counts(
        scene, meshes.big_camera(256, 256).to(DEV), cfg_s, key, lb,
        queue=4096, backend="packed", device=DEV)
    differ_s = (img_s != img_packed).any(-1)

    # The walk on two batches: both designs against the plain walk.
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    batches = lbvh_batches(scene, cam, lb, cfg, key, 4096, N_WARM)
    cases, timing = [], {}
    for name, (ro, rd, t_max, shadow) in batches.items():
        for form in (False, True):
            src = shadow if form else (ro, rd, t_max)
            for bvh_name, bvh in (("lbvh", lb), ("sah_packed", pk)):
                args = walk_args(bvh, src[0], src[1],
                                 torch.zeros_like(src[2]), src[2])
                res, stats, _ = compare_walk(args, f"{name}_{bvh_name}", form)
                R = int(src[2].shape[0])
                n_bytes, ops, _ = walk_work(stats, R, form)
                by_b = n_bytes / HBM_BYTES_PER_S * 1e3
                by_o = ops / fp32_ops_per_s * 1e3
                res["bound_ms"] = max(by_b, by_o)
                res["bound_by"] = "bytes" if by_b >= by_o else "operations"
                for design in WALK_DESIGNS:
                    res[f"trace_us_{design}"], res[f"trace_n_{design}"] = \
                        trace_launches(lambda: packed_walk(
                            *args, any_hit=form, design=design), flush,
                            WALK_KERNEL[design])
                if bvh_name == "lbvh":
                    assert res["bitwise"] and res["window_vs_thread_bitwise"]
                cases.append(res)
    del flush
    emit({"phase": "render_lbvh", "scene": "big-1m", "size": cfg.width,
          "rows": list(BAND_ROWS), "spp": cfg.spp,
          "max_depth": cfg.max_depth, "queue": 4096,
          "key": list(key), "backend": "packed", "bvh": "lbvh (1 table, "
          "1 primitive a leaf)", "n_nodes": lb.n_nodes,
          "run_s": round(run_s, 3), "run_s_render_main_band": band["run_s"],
          "run_s_over_render_main_band": round(run_s / band["run_s"], 4),
          "steps_run": it, "steps_run_render_main_band": band["steps_run"],
          "overflow": ovf, "n_closest": nc, "n_shadow": ns,
          "n_closest_render_main_band": band["n_closest"],
          "n_shadow_render_main_band": band["n_shadow"],
          "mean_radiance": mean,
          "mean_radiance_render_main_band": band["mean_radiance"],
          "rays_per_s": round((nc + ns) / run_s, 1),
          "launches": launches, "traversals_per_step": traversals,
          "max_abs_diff_vs_render_main": float(diff.max()),
          "pixels_over_1e-3_vs_render_main": int((diff > 1e-3).sum()),
          "exact_cell": {"size": 256, "counts": counts_s,
                         "max_abs_diff_vs_render_exact_packed": float(
                             (img_s - img_packed).abs().max()),
                         "pixels_differ": int(differ_s.sum()),
                         "mean_radiance": float(img_s.mean())},
          "walks": cases,
          "tolerance": "counts within 0.5 % and mean within 1 % of "
                       "render_main's band render's (tile test and row test are two "
                       "intersectors: pixel differences printed, no limit); "
                       "the 256² LBVH render vs render_exact's packed render "
                       "rtol 1e-3 atol 1e-3; both walk designs bitwise the "
                       "plain walk and each other"})
    assert bool(torch.isfinite(img).all())
    assert tuple(img.shape) == (BAND_ROWS[1] - BAND_ROWS[0], cfg.width, 3)
    assert ovf == 0, "render_lbvh: the packed walk reported overflow"
    assert launches["packed_walk"] == traversals * it, launches
    assert launches["packed_walk_thread"] == 0, launches
    assert launches["pair_ray_reduce"] == launches["fetch_fields"] == 0
    for k, got in (("n_closest", nc), ("n_shadow", ns)):
        assert abs(got - band[k]) <= 0.005 * band[k], (k, got, band[k])
    assert abs(mean - band["mean_radiance"]) <= 0.01 * band["mean_radiance"]
    assert torch.allclose(img_s, img_packed, rtol=1e-3, atol=1e-3), \
        "render_lbvh: the 256² LBVH render vs render_exact's packed render"
    return {"packed_walk": launches["packed_walk"]}


def phase_render_device(scene, cam, cfg, cd, pk, main, img_main):
    """The headline's band (``BAND_ROWS``) through the fused pair stage on
    ``build_cluster_device`` (the command line's ``--bvh lbvh`` on the
    cluster backend).  At overflow 0 its rows, counts and steps must be
    those of ``render_main``'s band render.  Where the band overflows, the
    whole headline in the command line's flow (``render_repaired``; ``pk``
    is the fallback ``attach_fallback`` would build): every pixel that was
    not suspect ``render_main``'s bit for bit, the repaired ones too or
    within 2e-4 / 2e-5.  Then the fused stage against the split stage,
    bitwise, on three traversal batches of this build.  Returns the
    launches."""
    key = (0, 3)
    band = main["band"]
    kernels = (pair_ray_reduce, pair_tile_isect, pair_segmin,
               pair_tile_isect_dedup, packed_walk, fetch_rows, fetch_fields)
    zero_launches(kernels)
    (img, nc, ns, ovf, it), run_s = timed_sync(
        lambda: render_band(scene, cam, cfg, key, cd))
    rec = {"rows": list(BAND_ROWS), "overflow": ovf, "steps_run": it,
           "n_closest": nc, "n_shadow": ns, "mean_radiance": float(img.mean()),
           "run_s": round(run_s, 3), "rays_per_s": round((nc + ns) / run_s, 1),
           "launches": read_launches(kernels)}
    ref, clean = band_of(img_main), None
    if ovf:
        img, sus, rec["whole_headline"] = render_repaired(scene, cam, cfg, key,
                                                          cd, pk)
        it, ref = rec["whole_headline"]["steps_run"], img_main
        clean = (sus == 0).reshape(cfg.height, cfg.width)
    differ = (img != ref).any(-1)
    n_differ = int(differ.sum())

    # The fused and the split stage on three traversal batches.
    first, mid, shadow, _, _ = queue_batches(scene, cam, cd, cfg, key, 4096,
                                             N_WARM)
    stages = {}
    for name, (ro, rd, t_max) in (("first_wave", first), ("mid_render", mid)):
        t_min = torch.zeros_like(t_max)
        h = {s: cluster.intersect(cd, scene, ro, rd, t_min, t_max,
                                  pair_stage=s) for s in ("fused", "split")}
        stages[name] = all(bool(torch.equal(getattr(h["fused"], f),
                                            getattr(h["split"], f)))
                           for f in ("hit", "t", "prim", "u", "v"))
    ro, rd, t_max = shadow
    stages["mid_render_shadow_narrow"] = bool(torch.equal(*(
        cluster.occluded_counted(cd, scene, ro, rd, t_max, narrow=True,
                                 pair_stage=s)[0]
        for s in ("fused", "split"))))
    emit({"phase": "render_device", "scene": "big-1m", "size": cfg.width,
          "spp": cfg.spp, "max_depth": cfg.max_depth, "queue": 4096,
          "key": list(key), "pair_stage": "fused",
          "bvh": "build_cluster_device (Morton chunks, split_tau 0.5, "
                 "cap_scale 1.35)", **cluster_shape(cd), **rec,
          "run_s_render_main_band": band["run_s"],
          "run_s_over_render_main_band": round(run_s / band["run_s"], 4),
          "image_equals_render_main_bitwise": n_differ == 0,
          "pixels_differ_from_render_main": n_differ,
          "max_abs_diff_vs_render_main": float((img - ref).abs().max()),
          "fused_equals_split_bitwise": stages,
          "tolerance": "the band at overflow 0: its rows torch.equal to "
                       "render_main's, counts and steps its band render's; "
                       "else the whole headline after the repair: every "
                       "pixel that was not suspect bitwise, the rest rtol "
                       "2e-4 atol 2e-5; fused vs split bitwise"})
    launches = rec["whole_headline"]["launches"] if ovf else rec["launches"]
    assert launches["pair_ray_reduce"] == 2 * 4 * it, rec
    assert all(stages.values()), stages
    assert bool(torch.isfinite(img).all())
    if ovf == 0:
        check_fetch_launches(launches, cd, it)
        assert not any(launches[k] for k in (
            "pair_tile_isect", "pair_segmin", "pair_tile_isect_dedup",
            "packed_walk", "packed_walk_thread")), launches
        assert n_differ == 0, "render_device: the band differs from " \
            "render_main's rows"
        assert (nc, ns, it) == (band["n_closest"], band["n_shadow"],
                                band["steps_run"]), "render_device: counts"
    else:
        assert not bool((differ & clean).any()), \
            "render_device: a pixel that was not suspect differs"
        assert torch.allclose(img, img_main, rtol=2e-4, atol=2e-5), \
            "render_device: repaired image vs render_main"
    return {k: launches[k] for k in ("pair_ray_reduce", "fetch_fields")}


def render_repaired(scene, cam, cfg, key, cb, fallback):
    """The command line's render (tpu_pt/cli.py:175-235): one render that
    counts and flags suspect pixels; where it overflowed, the fallback
    attached (``fallback``: a packed BVH on the card) and the suspect
    pixels rendered again.  Returns (final image, suspect flags, record)."""
    kw = dict(queue=4096, device=DEV)
    kernels = (pair_ray_reduce, pair_tile_isect, pair_segmin,
               pair_tile_isect_dedup, packed_walk, fetch_rows, fetch_fields)
    zero_launches(kernels)
    (img, nc, ns, ovf, it, sus), run_s = timed_sync(
        lambda: wavefront.render_wavefront_suspect_counts(
            scene, cam, cfg, key, cb, backend="cluster", **kw))
    rec = {"overflow": ovf, "steps_run": it, "n_closest": nc,
           "n_shadow": ns, "mean_radiance": float(img.mean()),
           "run_s": round(run_s, 3), "rays_per_s": round((nc + ns) / run_s, 1),
           "launches": read_launches(kernels),
           "suspect_pixels": int(sus.sum())}
    # The fused stage on every traversal sub-batch (the closest hit and a
    # shadow ray per light, 4 sub-batches each), no other pair stage, no
    # walk (no fallback attached yet).
    traversals = 1 + scene.lights.count * cfg.ns_area_light
    assert rec["launches"]["pair_ray_reduce"] == traversals * 4 * it, rec
    check_fetch_launches(rec["launches"], cb, it, traversals)
    assert not any(rec["launches"][k] for k in (
        "pair_tile_isect", "pair_segmin", "pair_tile_isect_dedup",
        "packed_walk", "packed_walk_thread")), rec
    if ovf == 0:
        return img, sus, rec
    (final, ovf_r), repair_s = timed_sync(
        lambda: with_repair_count(wavefront.repair_suspect_pixels, scene,
                                  cam, cfg, key, cb._replace(
                                      fallback=fallback), img, sus, **kw))
    rec.update(suspect_rays_repaired=REPAIRED.copy(),
               overflow_repair_subset=ovf_r,
               mean_radiance_final=float(final.mean()),
               repair_run_s=round(repair_s, 3))
    return final, sus, rec


def differing_pixels(img, ref, sus, n=12):
    """How many pixels of ``img`` differ from ``ref``, how many of them are
    suspect and how many lie outside rtol 2e-4 / atol 2e-5, the largest
    difference, and the first ``n`` of them: id, suspect flag, both
    values."""
    differ = (img != ref).any(-1).reshape(-1)
    ids = torch.nonzero(differ).reshape(-1)
    flat, rflat = img.reshape(-1, 3), ref.reshape(-1, 3)
    close = torch.isclose(flat, rflat, rtol=2e-4, atol=2e-5).all(-1)
    return {"pixels": int(ids.numel()),
            "suspect_among_them": int(sus.reshape(-1)[ids].sum()),
            "outside_2e-4_2e-5": int((~close).sum()),
            "max_abs_diff": float((img - ref).abs().max()),
            "first": [[int(i), int(sus.reshape(-1)[i]),
                       [round(float(x), 6) for x in flat[i]],
                       [round(float(x), 6) for x in rflat[i]]]
                      for i in ids[:n]]}


# The share of the atrium's pixels that may lie outside rtol 2e-4 / atol
# 2e-5 between two of its renders: none.  Every path takes each hit with
# brute force's (t, lowest id): the pair stage tests every candidate, and
# the walks' conservative cull (csrc/pair_isect_common.cuh::widen_up)
# culls no box that holds it, coplanar faces included.
ATRIUM_FEW = 0


def phase_render_atrium():
    """The atrium (``meshes.atrium_scene``, about 1M triangles, two area
    lights) at 256² (the headline's 1024² cut to a sixteenth of the pixels
    to keep the whole run inside its time limit), spp 1, depth 4, RR from 2
    at 0.7, queue 4096, key (0, 3): (a) on the BVH of the command line's
    ``--autotune`` (``autotune_for_render`` probed at 256²), (b) on
    ``build_cluster_device``; each through the command line's flow (one
    render flagging suspects, the exact fallback attached and the suspect
    pixels repaired where it overflowed).  The two final images must be
    equal bit for bit where both are at overflow 0; else every pixel
    suspect in neither render must be, and every pixel must lie within
    rtol 2e-4 / atol 2e-5 (``ATRIUM_FEW`` of the image may lie outside:
    none).  The fallback's walk repairs with brute force's nearest (t,
    lowest id), coplanar faces included (its conservative cull:
    ``tests/test_torch_packed.py::test_walk_on_coplanar_faces_matches_
    brute_force``), so a repaired path takes the hits the pair stage would
    have taken.  The packed walk's render of the same scene (no capacity to
    overflow) holds both final images to the same rule.  Returns the
    launches of (b)'s render."""
    t0 = time.time()
    scene_h = meshes.atrium_scene()
    scene_s = time.time() - t0
    scene = scene_h.to(DEV)
    cfg = RenderConfig(width=256, height=256, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam_h = meshes.atrium_camera(256, 256)
    cam, key = cam_h.to(DEV), (0, 3)
    t0 = time.time()
    pk = native.build_packed_any(scene_h).to(DEV)
    pk_s = time.time() - t0
    (img_p, *counts_p), packed_s = timed_sync(
        lambda: wavefront.render_wavefront_counts(
            scene, cam, cfg, key, pk, queue=4096, backend="packed",
            device=DEV))
    cb_h, tune_s, parts = tune_timed(scene_h, cam_h, cfg)
    cb_a = cb_h.to(DEV)
    del cb_h
    img_a, sus_a, rec_a = render_repaired(scene, cam, cfg, key, cb_a, pk)
    del cb_a
    cd, build_s = timed_sync(lambda: cluster.build_cluster_device(scene,
                                                                  device=DEV))
    img_b, sus_b, rec_b = render_repaired(scene, cam, cfg, key, cd, pk)
    differ = (img_a != img_b).any(-1)
    both_exact = rec_a["overflow"] == 0 and rec_b["overflow"] == 0
    walked = ((sus_a != 0) | (sus_b != 0)).reshape(differ.shape)
    close = torch.isclose(img_a, img_b, rtol=2e-4, atol=2e-5).all(-1)
    few = int(ATRIUM_FEW * cfg.width * cfg.height)
    vs_p = {"autotune": differing_pixels(img_a, img_p, sus_a),
            "device_build": differing_pixels(img_b, img_p, sus_b)}
    emit({"phase": "render_atrium", "scene": "atrium",
          "tris": scene_h.n_tris, "lights": int(scene_h.lights.count),
          "scene_build_s": round(scene_s, 2), "size": cfg.width,
          "spp": cfg.spp, "max_depth": cfg.max_depth, "queue": 4096,
          "key": list(key),
          "autotune": {"autotune_s": round(tune_s, 3),
                       "autotune_parts": parts,
                       "probe_size": probe_size(cfg), **rec_a,
                       "vs_packed": vs_p["autotune"]},
          "device_build": {"device_cluster_build_s": round(build_s, 4),
                           **cluster_shape(cd), **rec_b,
                           "vs_packed": vs_p["device_build"]},
          "packed": {"packed_build_s": round(pk_s, 2), "n_nodes": pk.n_nodes,
                     "run_s": round(packed_s, 3), "counts": counts_p,
                     "mean_radiance": float(img_p.mean())},
          "autotune_equals_device_build_bitwise": int(differ.sum()) == 0,
          "autotune_vs_device_build": differing_pixels(img_a, img_b,
                                                       sus_a | sus_b),
          "differ_where_neither_render_walked": int((differ & ~walked).sum()),
          "within_2e-4_2e-5": bool(close.all()),
          "pixels_outside_2e-4_2e-5": int((~close).sum()),
          "pixels_outside_2e-4_2e-5_walked": int((~close & walked).sum()),
          "limit_outside_2e-4_2e-5": few,
          "tolerance": "the two final images torch.equal where both renders "
                       "are at overflow 0; else torch.equal on every pixel "
                       "suspect in neither render (both took every hit from "
                       "the pair stage), and every pixel within rtol 2e-4 "
                       "atol 2e-5; each final image against the packed "
                       "walk's render: every pixel within rtol 2e-4 atol "
                       "2e-5"})
    assert bool(torch.isfinite(img_a).all() and torch.isfinite(img_b).all())
    assert float(img_a.mean()) > 0.0
    if both_exact:
        assert not bool(differ.any()), \
            "render_atrium: the two exact renders differ"
    assert not bool((differ & ~walked).any()), \
        "render_atrium: a pixel suspect in neither render differs"
    assert int((~close).sum()) <= few, \
        "render_atrium: too many pixels outside 2e-4 / 2e-5"
    for name, d in vs_p.items():
        assert d["outside_2e-4_2e-5"] <= few, \
            f"render_atrium: {name} vs packed: {d['outside_2e-4_2e-5']}"
    return {k: rec_b["launches"][k] for k in ("pair_ray_reduce",
                                              "fetch_fields")}


# --------------------------------------------------------------------------
# The command line (tpu_pt_torch.cli), driven in-process
# --------------------------------------------------------------------------

def run_cli(argv):
    """``cli.main(argv)`` with its standard output and error captured ->
    (its last JSON line, its standard error, seconds, the launches of every
    kernel: zeroed just before the call, read just after), the device
    synchronised before and after."""
    out, err = io.StringIO(), io.StringIO()
    sync()
    zero_launches(ALL_KERNELS)
    t0 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_cli.main(argv)
    sync()
    dt = time.time() - t0
    launches = read_launches(ALL_KERNELS)
    assert rc == 0, f"cli {argv}: exit {rc}\n{err.getvalue()}"
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    return (lines[-1] if lines else None), err.getvalue(), dt, launches


def png_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def same_png(path, img):
    """Whether the PNG at ``path`` is byte for byte ``film.save`` of the
    image ``img`` (a tensor or array)."""
    ref = path + ".ref.png"
    film.save(ref, img.cpu().numpy() if torch.is_tensor(img) else img)
    return png_bytes(path) == png_bytes(ref)


def floats_text(a, fmt="%.9g"):
    return " ".join(fmt % x for x in np.asarray(a).reshape(-1).tolist())


def write_dae(path, scene_h, cam, hfov):
    """A host scene of area lights and diffuse triangles, no spheres, as a
    COLLADA document the port's loader reads back: one geometry for each
    run of triangles of one material (each run's vertices a range of their
    own, in order), each bound to a lambert effect of its albedo; each
    LIGHT_AREA row an <extra> area light on a node whose matrix carries its
    edges' directions and centre; the camera ``cam`` (its c2w columns and
    origin) with an xfov of ``hfov`` degrees.  Floats at %.9g: float32
    values read back exactly."""
    v = np.asarray(scene_h.vertices)
    tri, mat = np.asarray(scene_h.tri_idx), np.asarray(scene_h.tri_mat)
    cuts = [0] + [int(i) + 1 for i in np.flatnonzero(np.diff(mat))] \
        + [len(mat)]
    albedo = np.asarray(scene_h.materials.albedo)
    assert (np.asarray(scene_h.materials.kind) == MAT_DIFFUSE).all()
    fx = "".join(
        f'<effect id="fx{m}"><profile_COMMON><technique sid="c"><lambert>'
        f'<diffuse><color>{floats_text(albedo[m])} 1</color></diffuse>'
        f'</lambert></technique></profile_COMMON></effect>'
        for m in range(len(albedo)))
    mats = "".join(f'<material id="m{m}"><instance_effect url="#fx{m}"/>'
                   f'</material>' for m in range(len(albedo)))
    geoms, nodes, v_next = [], [], 0
    for g, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        t = tri[a:b]
        lo, hi = int(t.min()), int(t.max()) + 1
        assert lo == v_next, "each run's vertices must follow the last's"
        v_next = hi
        geoms.append(
            f'<geometry id="g{g}"><mesh><source id="g{g}-p"><float_array '
            f'id="g{g}-a" count="{3 * (hi - lo)}">{floats_text(v[lo:hi])}'
            f'</float_array></source><vertices id="g{g}-v"><input '
            f'semantic="POSITION" source="#g{g}-p"/></vertices><triangles '
            f'material="s" count="{b - a}"><input semantic="VERTEX" '
            f'source="#g{g}-v" offset="0"/><p>'
            f'{" ".join(map(str, (t - lo).reshape(-1).tolist()))}</p>'
            f'</triangles></mesh></geometry>')
        nodes.append(
            f'<node id="n{g}"><instance_geometry url="#g{g}"><bind_material>'
            f'<technique_common><instance_material symbol="s" '
            f'target="#m{int(mat[a])}"/></technique_common></bind_material>'
            f'</instance_geometry></node>')
    assert v_next == len(v)
    lights = scene_h.lights
    lib_l = []
    for i in range(lights.count):
        assert int(lights.kind[i]) == LIGHT_AREA
        ex, ey = np.asarray(lights.edge_x[i]), np.asarray(lights.edge_y[i])
        m = np.eye(4)
        m[:3, 0] = ex / np.linalg.norm(ex)
        m[:3, 1] = ey / np.linalg.norm(ey)
        m[:3, 2] = -np.asarray(lights.normal[i])
        m[:3, 3] = np.asarray(lights.position[i]) + 0.5 * ex + 0.5 * ey
        lib_l.append(
            f'<light id="l{i}"><extra><technique profile="ext"><area>'
            f'<size_x>{np.linalg.norm(ex):.9g}</size_x><size_y>'
            f'{np.linalg.norm(ey):.9g}</size_y><color>'
            f'{floats_text(lights.radiance[i])}</color></area></technique>'
            f'</extra></light>')
        nodes.append(f'<node id="ln{i}"><matrix>{floats_text(m)}</matrix>'
                     f'<instance_light url="#l{i}"/></node>')
    m = np.eye(4)
    m[:3, :3] = np.asarray(cam.c2w)
    m[:3, 3] = np.asarray(cam.origin)
    nodes.append(f'<node id="cam"><matrix>{floats_text(m)}</matrix>'
                 f'<instance_camera url="#c"/></node>')
    doc = (
        '<?xml version="1.0" encoding="utf-8"?><COLLADA xmlns='
        '"http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">'
        f'<library_effects>{fx}</library_effects>'
        f'<library_materials>{mats}</library_materials>'
        f'<library_geometries>{"".join(geoms)}</library_geometries>'
        '<library_cameras><camera id="c"><optics><technique_common>'
        f'<perspective><xfov>{hfov}</xfov></perspective></technique_common>'
        '</optics></camera></library_cameras>'
        f'<library_lights>{"".join(lib_l)}</library_lights>'
        '<library_visual_scenes><visual_scene id="s">'
        f'{"".join(nodes)}</visual_scene></library_visual_scenes>'
        '</COLLADA>')
    with open(path, "w") as fh:
        fh.write(doc)


def write_obj(path, scene_h):
    """The triangles of a host scene as a Wavefront OBJ: its vertices at
    %.9g, one ``usemtl m<id>`` before each run of triangles of one
    material, 1-based faces.  ``obj.load`` gives material m<id> the row
    id + 1 (row 0 is its default)."""
    tri, mat = np.asarray(scene_h.tri_idx) + 1, np.asarray(scene_h.tri_mat)
    lines = [f"v {floats_text(p)}" for p in np.asarray(scene_h.vertices)]
    for t, m in zip(tri.tolist(), mat.tolist()):
        if len(lines) == len(scene_h.vertices) or m != last:
            lines.append(f"usemtl m{m}")
            last = m
        lines.append("f %d %d %d" % tuple(t))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def phase_cli(scene_h, img_main, main_line, img_rep, sus_pixels):
    """The port's command line (``tpu_pt_torch.cli.main``), in-process so
    that its launches are counted, in a scratch directory of the checkout:
    (a) ``render big-1m`` at the headline's settings: the PNG byte for byte
    ``render_main``'s image, the JSON line's overflow 0 and mean_radiance
    ``render_main``'s to 5 places, 3,672 / 7,344 launches; (b) the same at
    256², where the default caps overflow: the suspect pixels named on
    standard error, the PNG ``render_exact``'s repaired image, the window
    walk launched and its thread twin not; (c) ``--checkpoint`` at 256²,
    spp 2, ``--chunk-spp 1``: the first chunk overflows, the run stops,
    attaches the fallback and resumes; the image (read from the
    checkpoint) bitwise ``render_progressive`` on the fallback-attached BVH
    with no checkpoint, and a run interrupted after its first chunk and
    resumed the same bits; (d) big-1m (its triangles, materials, light and
    ``big_camera``'s look-at) written as COLLADA and rendered with ``-e``
    on an EXR of ``gradient_sky`` at 512², spp 1: the loaded vertices,
    tri_idx and tri_mat the source's, the EXR read back bitwise, the image
    finite and any overflow repaired; (e) ``--backend bvh`` and
    ``--backend wavefront`` on the Cornell spheres (the flat row walk, the
    packed window walk; neither thread twin), ``visualize-bvh big-1m`` and
    ``dump-bvh cornell-mesh``; (f) the sanitizer
    (``render_wavefront_checked``) on the 256² cell bitwise
    ``render_wavefront(fast=False)``'s image, and raising on a NaN vertex.
    big-1m's host scene is built once: the command line's builtin returns
    ``scene_h``.  Returns the launches of (a) and (b)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=".")
    big_scene = meshes.big_scene
    meshes.big_scene = lambda subdiv=8, **kw: \
        scene_h if subdiv == 8 and not kw else big_scene(subdiv, **kw)
    parts, by_path = {}, {}
    try:
        # (a) The headline through the command line.
        base = ["render", "big-1m", "-s", "1", "-m", "4", "--queue", "4096",
                "--seed", "3"]
        out_a = os.path.join(work, "a.png")
        line, err, dt, launches = run_cli(base + ["-r", "1024", "1024",
                                                  "-f", out_a])
        mean_np = round(float(img_main.cpu().numpy().mean()), 5)
        parts["a"] = {"json": line, "wall_s": round(dt, 3),
                      "launches": launches,
                      "png_equals_render_main": same_png(out_a, img_main),
                      "render_main_run_s": main_line["run_s"],
                      "mean_radiance_render_main_5": round(
                          main_line["mean_radiance"], 5)}
        emit({"phase": "cli", "part": "a", **parts["a"]})
        assert parts["a"]["png_equals_render_main"], "cli (a): PNG"
        assert line["overflow"] == 0 and line["mean_radiance"] == mean_np \
            == parts["a"]["mean_radiance_render_main_5"], line
        assert launches["pair_ray_reduce"] == 3672 \
            and launches["fetch_fields"] == 7344, launches
        assert not any(n for k, n in launches.items()
                       if k not in ("pair_ray_reduce", "fetch_fields")), \
            launches
        by_path["cli"] = {k: n for k, n in launches.items() if n}

        # (b) The repair flow at 256².
        out_b = os.path.join(work, "b.png")
        line, err, dt, launches = run_cli(base + ["-r", "256", "256", "-f",
                                                  out_b])
        parts["b"] = {"json": line, "wall_s": round(dt, 3),
                      "stderr": err.strip().splitlines(),
                      "launches": launches,
                      "png_equals_render_exact_repaired": same_png(
                          out_b, img_rep)}
        emit({"phase": "cli", "part": "b", **parts["b"]})
        assert f"repairing {sus_pixels} suspect pixels" in err, err
        assert parts["b"]["png_equals_render_exact_repaired"], "cli (b): PNG"
        assert launches["packed_walk"] > 0 \
            and launches["packed_walk_thread"] == 0, launches
        by_path["cli_repair"] = {k: n for k, n in launches.items() if n}

        # (c) Progressive, stopped at the first overflowing chunk, resumed
        # on the fallback-attached BVH.
        ck = os.path.join(work, "state.npz")
        out_c = os.path.join(work, "c.png")
        line, err, dt, launches_c = run_cli(base[:2] + [
            "-s", "2", "-m", "4", "--queue", "4096", "--seed", "3", "-r",
            "256", "256", "--chunk-spp", "1", "--checkpoint", ck, "-f",
            out_c])
        first_ovf = int(re.search(r"note: (\d+) BVH candidates overflowed",
                                  err).group(1))
        cfg = RenderConfig(width=256, height=256, spp=2, max_depth=4)
        scene, cam = scene_h.to(DEV), meshes.big_camera(256, 256).to(DEV)
        cb_fb = cluster.attach_fallback(cluster.build_cluster_bvh(scene_h),
                                        scene_h).to(DEV)
        kw = dict(chunk_spp=1, queue=4096, backend="cluster", device=DEV)
        ref = render_progressive(scene, cam, cfg, (0, 3), cb_fb, **kw)
        got = np.load(ck)["accum"].reshape(256, 256, 3) / 2

        class Stop(Exception):
            pass

        def stop(spp_done, preview):
            raise Stop()

        ck2 = os.path.join(work, "interrupted.npz")
        try:
            render_progressive(scene, cam, cfg, (0, 3), cb_fb,
                               checkpoint=ck2, on_chunk=stop,
                               overflow_is_exact=True, **kw)
        except Stop:
            pass
        spp_saved = int(np.load(ck2)["spp_done"])
        resumed = render_progressive(scene, cam, cfg, (0, 3), cb_fb,
                                     checkpoint=ck2, overflow_is_exact=True,
                                     **kw)
        parts["c"] = {"json": line, "wall_s": round(dt, 3),
                      "stderr": err.strip().splitlines(),
                      "first_chunk_overflow": first_ovf,
                      "launches": launches_c,
                      "image_equals_progressive_on_fallback_bitwise":
                          bool(np.array_equal(got, ref)),
                      "png_equals_it": same_png(out_c, ref),
                      "interrupted_after_spp": spp_saved,
                      "resumed_equals_bitwise": bool(
                          np.array_equal(resumed, ref))}
        emit({"phase": "cli", "part": "c", **parts["c"]})
        assert first_ovf > 0 and "exact fallback attached" in err, err
        assert err.count("progress:") == 2, err   # both chunks on the retry
        assert spp_saved == 1
        assert parts["c"]["image_equals_progressive_on_fallback_bitwise"] \
            and parts["c"]["png_equals_it"] \
            and parts["c"]["resumed_equals_bitwise"], parts["c"]
        del cb_fb

        # (d) big-1m as a COLLADA file, lit by an EXR sky as well.
        dae = os.path.join(work, "big1m.dae")
        sky_path = os.path.join(work, "sky.exr")
        src = without_spheres(scene_h)
        t0 = time.time()
        write_dae(dae, src, meshes.big_camera(512, 512), 55.0)
        sky = gradient_sky(h=256, w=512)
        exr.write_exr(sky_path, sky)
        write_s = time.time() - t0
        loaded, load_s = [], []
        load = collada.load

        def load_spy(path):
            t0 = time.time()
            out = load(path)
            load_s.append(time.time() - t0)
            loaded.append(out[0])
            return out

        collada.load = load_spy
        try:
            out_d = os.path.join(work, "d.png")
            line, err, dt, launches = run_cli([
                "render", dae, "-e", sky_path, "-r", "512", "512", "-s", "1",
                "-m", "4", "--queue", "4096", "--seed", "3", "-f", out_d])
        finally:
            collada.load = load
        sc = loaded[0]
        same = {f: bool(np.array_equal(np.asarray(getattr(sc, f)),
                                       np.asarray(getattr(src, f))))
                for f in ("vertices", "tri_idx", "tri_mat")}
        same["lights"] = all(np.array_equal(x, y)
                             for x, y in zip(sc.lights, src.lights))
        parts["d"] = {"json": line, "wall_s": round(dt, 3),
                      "write_s": round(write_s, 2),
                      "dae_MB": round(os.path.getsize(dae) / 1e6, 1),
                      "load_s": round(load_s[0], 2), "tris": sc.n_tris,
                      "lights": int(sc.lights.count),
                      "seconds": line["seconds"],
                      "primary_rays_per_s": line["primary_rays_per_s"],
                      "overflow": line["overflow"],
                      "repaired": "exact retry done" in err,
                      "arrays_equal_source": same,
                      "exr_reads_back_bitwise": bool(np.array_equal(
                          load_envmap(sky_path), sky)),
                      "stderr": err.strip().splitlines(),
                      "launches": launches}
        # The OBJ loader on the same triangles (host only, no render).
        path = os.path.join(work, "big1m.obj")
        t0 = time.time()
        write_obj(path, src)
        parts["d"]["obj_write_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        so, _ = obj.load(path)
        parts["d"]["obj_load_s"] = round(time.time() - t0, 2)
        parts["d"]["obj_arrays_equal_source"] = {
            "vertices": bool(np.array_equal(so.vertices, src.vertices)),
            "tri_idx": bool(np.array_equal(so.tri_idx, src.tri_idx)),
            "tri_mat": bool(np.array_equal(so.tri_mat, src.tri_mat + 1))}
        emit({"phase": "cli", "part": "d", **parts["d"]})
        assert all(same.values()) and sc.n_tris == 1310722, same
        assert all(parts["d"]["obj_arrays_equal_source"].values()), parts["d"]
        assert parts["d"]["exr_reads_back_bitwise"]
        assert 0.0 < line["mean_radiance"] < 1e3   # finite, lit
        if "overflowed static budgets" in err:
            assert parts["d"]["repaired"], err
        # (e) The other backends and commands.
        for backend, walk in (("bvh", flat_walk), ("wavefront", packed_walk)):
            out_e = os.path.join(work, f"e_{backend}.png")
            line, err, dt, launches = run_cli([
                "render", "cornell-spheres", "--backend", backend, "-r",
                "128", "128", "-s", "4", "-f", out_e])
            name = walk.__name__
            parts["e_" + backend] = {"json": line, "wall_s": round(dt, 3),
                                     "launches": launches}
            emit({"phase": "cli", "part": "e_" + backend,
                  **parts["e_" + backend]})
            assert launches[name] > 0 and launches[name + "_thread"] == 0, \
                launches
            assert 0.3 < line["mean_radiance"] < 0.7, line
            by_path["cli_" + backend] = {k: n for k, n in launches.items()
                                         if n}
        line, err, dt, _ = run_cli(["visualize-bvh", "big-1m", "-r", "256",
                                    "256", "-f",
                                    os.path.join(work, "heat.png")])
        dump, _, dump_s, _ = run_cli(["dump-bvh", "cornell-mesh"])
        parts["e_tools"] = {"visualize_bvh": line,
                            "visualize_bvh_s": round(dt, 3),
                            "dump_bvh": dump, "dump_bvh_s": round(dump_s, 3)}
        emit({"phase": "cli", "part": "e_tools", **parts["e_tools"]})
        assert line["max_visits"] > line["mean_visits"] > 1, line
        assert dump["prims"] == cornell.cornell("mesh").n_prims, dump

        # (f) The sanitizer on the 256² cell.
        cfg = RenderConfig(width=256, height=256, spp=1, max_depth=4)
        cb = cluster.build_cluster_bvh(scene_h).to(DEV)
        kw = dict(queue=4096, backend="cluster", device=DEV)
        checked, checked_s = timed_sync(
            lambda: wavefront.render_wavefront_checked(scene, cam, cfg,
                                                       (0, 3), cb, **kw))
        plain, plain_s = timed_sync(
            lambda: wavefront.render_wavefront(scene, cam, cfg, (0, 3), cb,
                                               fast=False, **kw))
        bad = scene._replace(vertices=scene.vertices.clone())
        bad.vertices[7, 1] = float("nan")
        try:
            wavefront.render_wavefront_checked(bad, cam, cfg, (0, 3), cb,
                                               **kw)
            raised = None
        except wavefront.CheckError as e:
            raised = str(e)
        parts["f"] = {"checked_equals_render_bitwise": bool(
                          torch.equal(checked, plain)),
                      "checked_s": round(checked_s, 3),
                      "render_fast_false_s": round(plain_s, 3),
                      "nan_vertex_raises": raised}
        emit({"phase": "cli", "part": "f", **parts["f"]})
        assert parts["f"]["checked_equals_render_bitwise"]
        assert raised == "scene.vertices has non-finite values", raised
    finally:
        meshes.big_scene = big_scene
        shutil.rmtree(work, ignore_errors=True)
    return by_path


# --------------------------------------------------------------------------
# Distribution: tile-sharded renders and the sharded gradient step
# --------------------------------------------------------------------------

# Each collective of a group gives up after this long, so that a rank that
# fails cannot hold the others forever.
DIST_TIMEOUT = datetime.timedelta(seconds=240)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_grad_step(scene, cb_fb, mesh, hint):
    """``loss_and_grad_sharded`` on the grad cell (key (0, 3), target
    zeros, the fallback attached), its launches taken apart per shard
    forward and backward.  Returns (loss, grads, stats, launches fwd,
    launches bwd)."""
    from tpu_pt_torch.diff import params as dparams
    from tpu_pt_torch.dist import sharding

    cfg, cam = grad_cell()
    got = {"forward": [], "backward": []}
    zero_launches(ALL_KERNELS)
    loss, grads, stats = sharding.loss_and_grad_sharded(
        dparams.split(scene)[0], scene, cam, cfg, (0, 3),
        torch.zeros((cfg.n_pixels, 3), device=DEV), cb_fb, mesh, queue=4096,
        backend="cluster", steps_hint=hint, with_stats=True,
        on_phase=lambda name: got[name].append(take_launches()))
    fwd = {k: sum(d[k] for d in got["forward"]) for k in got["forward"][0]}
    bwd = {k: sum(d[k] for d in got["backward"]) for k in got["backward"][0]}
    return loss, grads, stats, fwd, bwd


def check_step_launches(fwd, bwd, stats, cb, label):
    """Forward: 2 traversals x 4 sub-batches a step, a pair kernel and a
    walk each; backward: no kernel."""
    steps = sum(stats["steps_run"])
    assert fwd["pair_ray_reduce"] == 2 * 4 * steps, (label, fwd)
    assert fwd["packed_walk"] == 2 * 4 * steps, (label, fwd)
    check_fetch_launches(fwd, cb, steps)
    assert not any(n for k, n in fwd.items() if k not in (
        "pair_ray_reduce", "packed_walk", "fetch_fields")), (label, fwd)
    assert not any(bwd.values()), (label, "kernels in backward", bwd)
    assert stats["allreduces_bwd"] == sum(m for _, m in stats["chunks"]), \
        (label, stats["chunks"], stats["allreduces_bwd"])


def grads_close(a, b, rtol=1e-4, atol=1e-6):
    return all(torch.allclose(a[k].to(b[k].device), b[k], rtol=rtol,
                              atol=atol) for k in b)


def dist_child(rank, port, tmp, hint):
    """One of the two ranks of the dist phase's part (b): gloo, both on
    cuda:0.  Loads big-1m's host arrays from ``tmp`` (the parent's, as
    :func:`phase_dist` wrote them) and builds its BVHs itself; runs (b3) the 256²
    interleaved and contiguous renders, (b1) the headline interleaved,
    (b2) the grad cell; prints one JSON line a part and leaves the image
    (rank 0) and each rank's loss and gradients in ``tmp``."""
    import torch.distributed as dist
    from tpu_pt_torch.dist import sharding

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2, timeout=DIST_TIMEOUT)
    try:
        t0 = time.time()
        with open(os.path.join(tmp, "scene.pkl"), "rb") as f:
            scene_h = pickle.load(f)
        cb = cluster.build_cluster_bvh(scene_h).to(DEV)
        cb_fb = cluster.attach_fallback(cb, scene_h)
        scene = scene_h.to(DEV)
        mesh = sharding.make_mesh(2)
        setup_s = time.time() - t0

        # (b3) 256², interleaved and contiguous (also the warm-up).
        cfg, cam = grad_cell()
        imgs = [sharding.render_sharded(
            scene, cam, cfg, (0, 3), cb_fb, mesh, queue=4096,
            backend="cluster", interleave=il) for il in (True, False)]
        emit({"phase": "dist", "part": "b3", "rank": rank,
              "device": str(mesh.device), "setup_s": round(setup_s, 2),
              "interleaved_equals_contiguous_bitwise":
                  bool(torch.equal(imgs[0], imgs[1]))})
        del imgs

        # (b1) the headline, interleaved, on the fallback-attached BVH.
        cfg = RenderConfig(width=1024, height=1024, spp=1, max_depth=4,
                           rr_start=2, rr_prob=0.7)
        cam = meshes.big_camera(1024, 1024).to(DEV)
        dist.barrier()
        zero_launches(ALL_KERNELS)
        sync()
        t0 = time.time()
        img, stats = sharding.render_sharded(
            scene, cam, cfg, (0, 3), cb_fb, mesh, queue=4096,
            backend="cluster", with_stats=True)
        sync()
        run_s = time.time() - t0
        launches = take_launches()
        if rank == 0:
            torch.save(img.cpu(), os.path.join(tmp, "b1.pt"))
        emit({"phase": "dist", "part": "b1", "rank": rank,
              "run_s": round(run_s, 3),
              "stats": {k: v.tolist() for k, v in stats.items()},
              "launches": launches})
        del img

        # (b2) the grad cell over the two ranks.
        loss, grads, st, fwd, bwd = sharded_grad_step(scene, cb_fb, mesh,
                                                      hint)
        torch.save({"loss": loss.cpu(),
                    "grads": {k: g.cpu() for k, g in grads.items()}},
                   os.path.join(tmp, f"b2_rank{rank}.pt"))
        emit({"phase": "dist", "part": "b2", "rank": rank,
              "loss": float(loss), "chunks": st["chunks"],
              "allreduces_bwd": st["allreduces_bwd"],
              "steps_run": st["steps_run"], "overflow": st["overflow"],
              "fwd_s": round(st["fwd_s"], 3), "bwd_s": round(st["bwd_s"], 3),
              "wait_s": round(st["wait_s"], 4),
              "launches_fwd": fwd, "launches_bwd": bwd})
        check_step_launches(fwd, bwd, st, cb, f"b2 rank {rank}")
    finally:
        dist.destroy_process_group()


def run_children(hint, tmp, deadline_s=300):
    """Start the two ranks of part (b), wait for both; a rank that fails or
    outlives the deadline fails the phase with its stderr, and every child
    still running is killed.  Returns each rank's JSON lines."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    try:
        for r in range(2):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-child",
                 str(r), str(port), tmp, str(hint)],
                stdout=out, stderr=err, env=env))
        t0 = time.time()
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.time() - t0 > deadline_s:
                break
            time.sleep(0.5)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for r in failed:
                procs[r].wait(timeout=30)
                logs[r][1].seek(0)
                sys.stderr.write(f"--- dist rank {r} (exit "
                                 f"{procs[r].returncode}) stderr:\n"
                                 + logs[r][1].read()[-8000:])
            raise RuntimeError(f"dist: rank(s) {failed} failed or timed out")
        lines = []
        for out, _ in logs:
            out.seek(0)
            lines.append([json.loads(s) for s in out.read().splitlines()
                          if s.startswith("{")])
        return lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for out, err in logs:
            out.close()
            err.close()


def dist_only(scene_h):
    """``--dist``: what the dist phase needs, then the phase alone:
    big-1m's BVHs, the fallback attached, ``render_main``'s image (one warm
    render, one timed; counts held to the port's record) and the grad cell's
    hint."""
    scene = scene_h.to(DEV)
    cb = cluster.build_cluster_bvh(scene_h).to(DEV)
    cb_fb = cluster.attach_fallback(cb, scene_h)
    cfg = RenderConfig(width=1024, height=1024, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(1024, 1024).to(DEV)
    for _ in range(2):
        sync()
        t0 = time.time()
        img, nc, ns, ovf, n_iter = wavefront.render_wavefront_counts(
            scene, cam, cfg, (0, 3), cb, queue=4096, backend="cluster",
            device=DEV)
        sync()
    main = {"run_s": round(time.time() - t0, 3)}
    assert (nc, ns, ovf, n_iter) == tuple(PORT_RECORD[k] for k in (
        "n_closest", "n_shadow", "overflow", "steps_run")), \
        (nc, ns, ovf, n_iter)
    hint, _ = grad_hint(scene, cb)
    by_path = phase_dist(scene_h, scene, cb, cb_fb, main, img, hint)
    emit({"phase": "dist", "part": "launches_by_path", **by_path})


def phase_dist(scene_h, scene, cb, cb_fb, main, img_main, hint):
    """The port's distribution layer (``tpu_pt_torch.dist.sharding``) on the
    card.

    (a) One rank over NCCL in this process: ``loss_and_grad_sharded`` on
    the grad cell (fallback attached, key (0, 3), the hint of
    ``render_grad``) against ``loss_and_grad_wavefront`` on the same inputs
    (loss rel 1e-5, gradients rtol 1e-4 / atol 1e-6: tests/test_dist.py:
    114-119); reduces in backward = M, the pair kernel and the walk 8 x
    steps in forward and no kernel in backward; one warm call, then the two
    steps timed whole in turns (sharded, plain, plain, sharded: ``step_s``),
    ``fwd_s`` / ``bwd_s`` / ``wait_s`` from the last.
    (c) ``dryrun_multichip(1)`` on the card, in the same group.
    (b) Two ranks on the one card over gloo (NCCL refuses two ranks on one
    GPU), two processes this script starts (``--dist-child``): (b1) the
    headline interleaved must be ``render_main``'s image bit for bit, its
    per-shard counts summing to the port's record; (b2) the grad cell, the
    same loss and gradients on both ranks, equal to (a)'s within (a)'s
    tolerances; (b3) at 256² the interleaved and contiguous images
    ``torch.equal``.  Returns the launches of each path."""
    import torch.distributed as dist
    from tpu_pt_torch.diff import adjoint, params as dparams
    from tpu_pt_torch.dist import sharding

    by_path = {}
    t_a = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            timeout=DIST_TIMEOUT)
    try:
        mesh = sharding.make_mesh(1)
        cfg, cam = grad_cell()
        sharded_grad_step(scene, cb_fb, mesh, hint)             # warm
        # The whole step, sharded and plain, in turns in this call.
        step_s = {"sharded": [], "wavefront": []}
        for which in ("sharded", "wavefront", "wavefront", "sharded"):
            sync()
            t0 = time.time()
            if which == "sharded":
                loss, grads, st, fwd, bwd = sharded_grad_step(
                    scene, cb_fb, mesh, hint)
            else:
                loss_w, grads_w, done = adjoint.loss_and_grad_wavefront(
                    dparams.split(scene)[0], scene, cam, cfg, (0, 3),
                    torch.zeros((cfg.n_pixels, 3), device=DEV), cb_fb,
                    queue=4096, steps_hint=hint, device=DEV)
            sync()
            step_s[which].append(round(time.time() - t0, 3))
        rel = abs(float(loss) - float(loss_w)) / abs(float(loss_w))
        line_a = {
            "phase": "dist", "part": "a", "backend": dist.get_backend(),
            "ranks": 1, "cell": "grad (big-1m 256², fallback attached)",
            "key": [0, 3], "steps_hint": hint, "loss": float(loss),
            "loss_wavefront": float(loss_w), "loss_rel_err": rel,
            "grads_max_abs_diff": grads_max_diff(grads, grads_w),
            "grads_bitwise": grads_equal(grads, grads_w),
            "chunks": st["chunks"], "allreduces_bwd": st["allreduces_bwd"],
            "steps_run": st["steps_run"], "overflow": st["overflow"],
            "fwd_s": round(st["fwd_s"], 3), "bwd_s": round(st["bwd_s"], 3),
            "wait_s": round(st["wait_s"], 4),
            "step_s_in_turns": step_s,
            "launches_fwd": fwd, "launches_bwd": bwd,
            "tolerance": "loss rel 1e-5; grads rtol 1e-4 atol 1e-6; "
                         "allreduces in backward = M; backward launches 0"}
        emit(line_a)
        assert done, "dist (a): the hint dropped samples"
        assert rel <= 1e-5, f"dist (a): loss {float(loss)} vs {float(loss_w)}"
        assert grads_close(grads, grads_w), "dist (a): gradients"
        assert st["chunks"][0][0] == st["chunks"][0][1] >= 1, st["chunks"]
        check_step_launches(fwd, bwd, st, cb, "a")
        by_path["dist_a"] = fwd
        # (c)
        zero_launches(ALL_KERNELS)
        sharding.dryrun_multichip(1)
        by_path["dist_c"] = take_launches()
        emit({"phase": "dist", "part": "c", "dryrun_multichip": 1,
              "finite": True, "launches": by_path["dist_c"]})
        assert by_path["dist_c"]["pair_ray_reduce"] > 0, by_path["dist_c"]
    finally:
        dist.destroy_process_group()
    a_s = time.time() - t_a

    t_b = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        # big-1m's host arrays for the two ranks: they load them, and do
        # not build the scene again.
        with open(os.path.join(tmp, "scene.pkl"), "wb") as f:
            pickle.dump(scene_h, f, protocol=pickle.HIGHEST_PROTOCOL)
        lines = run_children(hint, tmp)
        for rank_lines in lines:
            for line in rank_lines:
                emit(line)
        part = {p: [next(x for x in rl if x["part"] == p) for rl in lines]
                for p in ("b1", "b2", "b3")}
        img = torch.load(os.path.join(tmp, "b1.pt"), weights_only=True)
        b2 = [torch.load(os.path.join(tmp, f"b2_rank{r}.pt"),
                         weights_only=True) for r in range(2)]
    b_s = time.time() - t_b
    img = img.to(DEV)
    stats = part["b1"][0]["stats"]
    sums = {k: sum(stats[k]) for k in ("n_closest", "n_shadow",
                                       "n_overflow")}
    launch_sum = {k: sum(x["launches"][k] for x in part["b1"])
                  for k in part["b1"][0]["launches"]}
    loss_r = [float(x["loss"]) for x in b2]
    line_b = {
        "phase": "dist", "part": "b", "backend": "gloo", "ranks": 2,
        "device": "cuda:0 (both ranks)",
        "b1": {"size": 1024, "interleave": True, "per_shard": stats,
               "sums": sums,
               "sums_equal_port_record": (sums["n_closest"], sums["n_shadow"])
               == (PORT_RECORD["n_closest"], PORT_RECORD["n_shadow"]),
               "image_equals_render_main_bitwise": bool(
                   torch.equal(img, img_main)),
               "run_s_per_rank": [x["run_s"] for x in part["b1"]],
               "run_s": max(x["run_s"] for x in part["b1"]),
               "run_s_render_main": main["run_s"],
               "launches_both_ranks": launch_sum},
        "b2": {"loss_per_rank": loss_r,
               "ranks_equal_bitwise": bool(torch.equal(b2[0]["loss"],
                                                       b2[1]["loss"]))
               and grads_equal(b2[0]["grads"], b2[1]["grads"]),
               "loss_rel_err_vs_a": abs(loss_r[0] - float(loss))
               / abs(float(loss)),
               "grads_max_abs_diff_vs_a": grads_max_diff(
                   {k: v.to(DEV) for k, v in b2[0]["grads"].items()}, grads),
               "chunks_per_rank": [x["chunks"] for x in part["b2"]],
               "fwd_s_per_rank": [x["fwd_s"] for x in part["b2"]],
               "bwd_s_per_rank": [x["bwd_s"] for x in part["b2"]],
               "wait_s_per_rank": [x["wait_s"] for x in part["b2"]]},
        "b3_interleaved_equals_contiguous": [
            x["interleaved_equals_contiguous_bitwise"] for x in part["b3"]],
        "a_s": round(a_s, 1), "b_s": round(b_s, 1),
        "tolerance": "b1 image torch.equal render_main's, count sums "
                     "exactly the port's record; b2 ranks rel 1e-6 / 1e-5, "
                     "vs (a) loss rel 1e-5, grads rtol 1e-4 atol 1e-6; "
                     "b3 torch.equal"}
    emit(line_b)
    assert line_b["b1"]["image_equals_render_main_bitwise"], \
        "dist (b1): the two ranks' headline differs from render_main's"
    assert line_b["b1"]["sums_equal_port_record"] and \
        sums["n_overflow"] == 0, f"dist (b1): counts {sums}"
    for x in part["b1"]:
        steps = x["stats"]["steps_run"][x["rank"]]
        for k in ("pair_ray_reduce", "packed_walk"):
            assert x["launches"][k] == 2 * 4 * steps, x["launches"]
        check_fetch_launches(x["launches"], cb, steps)
    assert abs(loss_r[0] - loss_r[1]) <= 1e-6 * abs(loss_r[0]), loss_r
    assert grads_close(b2[1]["grads"], b2[0]["grads"], 1e-5, 1e-10), \
        "dist (b2): the ranks' gradients differ"
    assert line_b["b2"]["loss_rel_err_vs_a"] <= 1e-5, line_b["b2"]
    assert grads_close({k: v.to(DEV) for k, v in b2[0]["grads"].items()},
                       grads), "dist (b2): gradients vs (a)"
    assert all(line_b["b3_interleaved_equals_contiguous"]), \
        "dist (b3): interleaved and contiguous renders differ"
    by_path["dist_b1"] = launch_sum
    by_path["dist_b2"] = {k: sum(x["launches_fwd"][k] for x in part["b2"])
                          for k in part["b2"][0]["launches_fwd"]}
    return by_path


def phase_paired(scene, cam, cb, cfg, n):
    """The headline render through the fused and the split pair stage
    (``render_main``'s and ``render_split``'s; with ``--modes``, in
    ``cb``'s traversal mode "frontier"), after one warm-up of each, n
    times each in the order fused, split, split, fused, ...: every run_s,
    the medians and their ratio."""
    def run(stage):
        sync()
        t0 = time.time()
        out = wavefront.render_wavefront_counts(
            scene, cam, cfg, (0, 3), cb, queue=4096, backend="cluster",
            device=DEV, pair_stage=stage)
        sync()
        return out, time.time() - t0

    first = {s: run(s) for s in ("fused", "split")}
    assert bool(torch.equal(first["fused"][0][0], first["split"][0][0])), \
        "paired: the two stages' images differ"
    counts = first["fused"][0][1:]
    assert first["split"][0][1:] == counts
    times = {"fused": [], "split": []}
    for i in range(n):
        for stage in ("fused", "split") if i % 2 == 0 else ("split", "fused"):
            out, dt = run(stage)
            assert out[1:] == counts, f"paired: {stage} counts moved"
            times[stage].append(dt)
    med = {k: statistics.median(v) for k, v in times.items()}
    emit({"phase": "paired", "mode": cb.traversal_mode, "scene": "big-1m",
          "size": cfg.width,
          "runs_each": n, "order": "fused, split, split, fused, ...",
          "warmup_s": {k: round(v[1], 3) for k, v in first.items()},
          "run_s_fused": [round(t, 3) for t in times["fused"]],
          "run_s_split": [round(t, 3) for t in times["split"]],
          "median_fused": round(med["fused"], 3),
          "median_split": round(med["split"], 3),
          "fused_over_split": round(med["fused"] / med["split"], 4),
          "fused_faster_in_pairs": sum(
              f < s for f, s in zip(times["fused"], times["split"])),
          "steps_run": counts[3], "overflow": counts[2]})


def main():
    args = sys.argv[1:]
    if "--dist-child" in args:
        rank, port, tmp, hint = args[args.index("--dist-child") + 1:][:4]
        dist_child(int(rank), port, tmp, int(hint))
        return
    profile = "--profile" in args
    paired = int(args[args.index("--paired") + 1]) if "--paired" in args \
        else 0
    determinism_only = "--determinism" in args
    full_run = not (paired or determinism_only or any(
        a in args for a in ("--dist", "--modes", "--walks")))
    t_start = time.time()
    smi, fp32_ops_per_s = phase_device()
    phase_s = {}
    # The libraries' builds and the atrium's host brute force overlap the
    # scene's build.
    builds = start_host_work() if full_run else None

    def run(name, fn, *a, **kw):
        """fn(*a, **kw), its seconds kept under ``name`` in phase_s."""
        t0 = time.time()
        out = fn(*a, **kw)
        phase_s[name] = round(time.time() - t0, 1)
        return out

    t0 = time.time()
    scene_h = meshes.big_scene(subdiv=8)
    t_scene = time.time() - t0
    if "--dist" in args:
        run("dist", dist_only, scene_h)
        emit({"phase": "done", "total_s": round(time.time() - t_start, 1),
              "phase_s": phase_s})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    if determinism_only:
        scene, cb = scene_h.to(DEV), cluster.build_cluster_bvh(scene_h).to(DEV)
        phase_determinism(scene, cb)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    pk, cb_h, build_s, pk_s = run("build", phase_build, scene_h, builds)
    scene, cb = scene_h.to(DEV), cb_h.to(DEV)
    n_tris = scene_h.n_tris
    emit({"phase": "scene", "scene_build_s": round(t_scene, 2),
          "bvh_build_s": round(build_s, 2), "tris": n_tris,
          "n_clusters": cb.n_clusters,
          "device_MB": round(torch.cuda.memory_allocated() / 1e6, 1)})
    del cb_h

    cfg = RenderConfig(width=1024, height=1024, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(1024, 1024).to(DEV)
    if "--modes" in args:
        run("traverse", phase_traverse)
        run("determinism", phase_determinism, scene, cb)
        run("kernels_modes", phase_mode_kernels, scene, cam, cb, cfg,
            fp32_ops_per_s)
        _, main_line, img_main = run("render_main", phase_render_main, scene,
                                     cam, cb, cfg, build_s, n_tris)
        run("render_modes", phase_render_modes, scene, cam, cb, cfg,
            main_line, img_main, True)
        if profile:
            for stage in cluster.MODE_PAIR_STAGES:
                run("loop_frontier_" + stage, phase_loop, scene, cam,
                    cb._replace(traversal_mode="frontier"), cfg, (0, 3),
                    profile, stage)
        if paired:
            run("paired_frontier", phase_paired, scene, cam,
                cb._replace(traversal_mode="frontier"), cfg, paired)
        emit({"phase": "done", "total_s": round(time.time() - t_start, 1),
              "phase_s": phase_s})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    if paired or "--walks" in args:
        if "--walks" in args:
            run("walks", phase_walks, scene, cam, cb, cfg, pk,
                fp32_ops_per_s)
        if paired:
            phase_paired(scene, cam, cb, cfg, paired)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    lb, cd = run("build_device", phase_build_device, scene_h, scene, {
        "cluster_build_s": round(build_s, 2),
        "packed_build_s": round(pk_s, 2)})
    timing, errs, mid = run("kernels", phase_kernels, scene, cam, cb, cfg,
                            (0, 3), pk)
    probe_launches = run("fetch_probes", phase_fetch_probes, cb, mid)
    del mid
    run("traverse", phase_traverse)
    small = run("render_small", phase_render_small, scene, cb)
    run("determinism", phase_determinism, scene, cb)
    cb_fb, _, img_fb, img_packed, img_rep, n_sus = run(
        "render_exact", phase_render_exact, scene, scene_h, cb, pk, small)
    hint = run("render_grad", phase_render_grad, scene, cb, cb_fb, img_fb)
    del small
    launches, main_line, img_main = run(
        "render_main", phase_render_main, scene, cam, cb, cfg, build_s,
        n_tris)
    # The headline's gradient step, the command line's paths and the
    # device builds', each with its launch counts zeroed just before its
    # run and read just after.
    by_path = run("grad_headline", phase_grad_headline, scene, cam, cb, cfg,
                  main_line, img_main)
    by_path.update(run("cli", phase_cli, scene_h, img_main, main_line,
                       img_rep, n_sus))
    del img_rep
    by_path["render_lbvh"] = run(
        "render_lbvh", phase_render_lbvh, scene, cam, cfg, lb, pk, main_line,
        img_main, img_packed, fp32_ops_per_s)
    by_path["render_device"] = run(
        "render_device", phase_render_device, scene, cam, cfg, cd, pk,
        main_line, img_main)
    del lb, cd, img_packed
    run("render_autotune", phase_render_autotune, scene, scene_h, cb, cfg,
        main_line, img_main, img_fb)
    del img_fb
    launches.update(run("render_fallback", phase_render_fallback, scene, cam,
                        cb_fb, cfg, main_line, img_main))
    by_path.update(run("dist", phase_dist, scene_h, scene, cb, cb_fb,
                       main_line, img_main, hint))
    del cb_fb, scene_h
    launches.update(run("render_split", phase_render_split, scene, cam, cb,
                        cfg, main_line, img_main))
    by_path.update(run("render_modes", phase_render_modes, scene, cam, cb,
                       cfg, main_line, img_main))
    launches.update(run("render_dedup", phase_render_dedup, scene, cam, cb,
                        cfg, main_line, img_main))
    del img_main
    for pair_stage in ("fused", "split", "dedup"):
        run("loop_" + pair_stage, phase_loop, scene, cam, cb, cfg, (0, 3),
            profile, pair_stage)
    # The descent's row form (the twin of the field fetch) in the same
    # loop: its kernels per step beside the field form's.
    run("loop_rows", phase_loop, scene, cam, cb, cfg, (0, 3), profile,
        "fused", fetch="rows")
    if profile:
        run("loop_pairs", phase_loop_pairs, scene, cam, cb, cfg, (0, 3))
        for stage in cluster.MODE_PAIR_STAGES:
            run("loop_frontier_" + stage, phase_loop, scene, cam,
                cb._replace(traversal_mode="frontier"), cfg, (0, 3), profile,
                stage)
    oracle_launches = run("render_oracle", phase_render_oracle)
    launches.update(oracle_launches)
    launches.update(probe_launches)
    by_path["spheres_parity"] = run("spheres_parity", phase_spheres_parity)
    del scene, cb, pk
    by_path["render_atrium"] = run("render_atrium", phase_render_atrium)

    # file:line of the pl.pallas_call each kernel replaces.
    sources = {
        "pair_ray_reduce": ("tpu_pt_torch/csrc/pair_ray_reduce.cu",
                            "tpu_pt/kernels/cluster_isect.py:288 and "
                            "tpu_pt/kernels/pair_scan.py:133"),
        "pair_segmin": ("tpu_pt_torch/csrc/pair_segmin.cu",
                        "tpu_pt/kernels/pair_scan.py:133"),
        "pair_tile_isect": ("tpu_pt_torch/csrc/pair_tile_isect.cu",
                            "tpu_pt/kernels/cluster_isect.py:288"),
        "pair_tile_isect_dedup": ("tpu_pt_torch/csrc/pair_tile_isect_dedup.cu",
                                  "tpu_pt/kernels/cluster_isect.py:258"),
        "dense_closest": ("tpu_pt_torch/csrc/dense_isect.cu",
                          "tpu_pt/kernels/intersect.py:159"),
        "dense_anyhit": ("tpu_pt_torch/csrc/dense_isect.cu",
                         "tpu_pt/kernels/intersect.py:177"),
        "packed_walk": ("tpu_pt_torch/csrc/packed_walk.cu",
                        "tpu_pt/bvh/packed.py:252 (_traverse, an XLA "
                        "while_loop; no pl.pallas_call)"),
        "flat_walk": ("tpu_pt_torch/csrc/flat_walk.cu",
                      "tpu_pt/bvh/flat.py:53 and :118 (intersect and "
                      "occluded, XLA while_loops; no pl.pallas_call)"),
        "fetch_fields": ("tpu_pt_torch/csrc/fetch_rows.cu",
                         "tools/microbench_vmem_gather.py:74 (vmem_gather: "
                         "the fused descent's child fetch, here in the "
                         "layout the port's descent reads)"),
        "fetch_rows": ("tpu_pt_torch/csrc/fetch_rows.cu",
                       "tools/microbench_vmem_gather.py:74 (vmem_gather), "
                       "tools/microbench_fetch_kernel.py:65 (onehot_fetch) "
                       "and :130 (grouped_fetch)"),
        "fetch_rows_t": ("tpu_pt_torch/csrc/fetch_rows.cu",
                         "tools/microbench_fetch_kernel.py:98 "
                         "(lane_gather_fetch)"),
        "take_along": ("tpu_pt_torch/csrc/take_along.cu",
                       "tools/microbench_dyngather.py:50 (run_case's "
                       "kernel)")}
    def bound(tm):
        """(bound_ms, bound_by) of a timing entry's bytes and operations."""
        by_bytes = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = tm["flops"] / fp32_ops_per_s * 1e3
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations")

    def other_batches(name):
        return {k.split("@")[1]: {**{f: v[f] for f in (
                    "ms", "trace_us", "trace_warm_us", "plain_ms",
                    "library_ms", "twin_path_ms", "path_ms", "shape")
                    if f in v},
                    **dict(zip(("bound_ms", "bound_by"), bound(v)))}
                for k, v in timing.items() if k.startswith(name + "@")}

    rows = []
    for name, (src, replaces) in sources.items():
        assert launches[name] > 0, f"no full-width path launched {name}"
        tm = timing[name]
        bound_ms, bound_by = bound(tm)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": tm["ms"],
               "plain_ms": tm["plain_ms"], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": tm.get("library_ms")}
        if "trace_us" in tm:
            row["trace_us"] = tm["trace_us"]
            row["trace_n"] = tm["trace_n"]
            row["trace_warm_us"] = tm["trace_warm_us"]
            row["trace_warm_n"] = tm["trace_warm_n"]
            row["launch_floor_us"] = timing["launch_floor_us"]
        if name in ("packed_walk", "flat_walk", "fetch_fields", "fetch_rows",
                    "fetch_rows_t", "take_along", "pair_ray_reduce",
                    "pair_tile_isect"):
            # The walks are timed at the whole 4096-lane queue (the flat
            # walk: at the oracle chunk's camera rays), the descent's
            # fetches at its last fetch, the pair kernels at the compact
            # mode's mid-render sub-batch; the same numbers for the other
            # batches and shapes timed (the pair kernels': the frontier
            # and pair-major walks' batches too).
            row["shape"] = tm["shape"]
            row["other_batches"] = other_batches(name)
        if name == "fetch_fields":
            row["twin_path_ms"] = tm["twin_path_ms"]
        if name in ("packed_walk", "flat_walk"):
            # The redesign (the default, on every path); its twin, the
            # thread design, timed on the same operands in this run and
            # launched by no path.
            twin = timing[name + "_thread"]
            row["design"] = "window" if name == "packed_walk" else "rows"
            row["twin"] = {
                "design": "thread", "launches": launches[name + "_thread"],
                **{f: twin[f] for f in ("ms", "trace_us", "trace_n",
                                         "trace_warm_us", "trace_warm_n")},
                **dict(zip(("bound_ms", "bound_by"), bound(twin))),
                "other_batches": other_batches(name + "_thread")}
        if name in ("fetch_fields", "fetch_rows", "fetch_rows_t",
                    "take_along"):
            row["launches_counted_in"] = (
                "render_main" if name == "fetch_fields" else "fetch_probes")
        if name in ("pair_ray_reduce", "pair_tile_isect", "fetch_fields",
                    "packed_walk", "flat_walk", "dense_closest",
                    "dense_anyhit"):
            # Its launches in one run of each command line path, one
            # render of each device build's path, (the fused kernel) one
            # headline in each of the cluster BVH's other traversal modes
            # and (the dense kernels) the Cornell spheres' parity render.
            row["launches_by_path"] = {
                path: got[name] for path, got in by_path.items()
                if name in got}
        rows.append(row)
    emit({"phase": "done", "total_s": round(time.time() - t_start, 1),
          "phase_s": phase_s})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
