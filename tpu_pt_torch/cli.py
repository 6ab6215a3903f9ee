"""Command-line entry point of the port (``tpu-pt-torch``; the counterpart
of ``tpu_pt/cli.py``, with the same commands, arguments and defaults).

Usage:
    python -m tpu_pt_torch.cli render cornell-spheres -s 64 -m 4 -r 512 512 -f out.png
    python -m tpu_pt_torch.cli render path/to/scene.dae -e sky.exr -f out.png
    python -m tpu_pt_torch.cli render cornell-spheres --device cpu -r 64 64 -s 4
    python -m tpu_pt_torch.cli dump-bvh cornell-spheres
    python -m tpu_pt_torch.cli visualize-bvh big-1m -r 256 256

``render`` and ``visualize-bvh`` run on the card by default and raise where
there is none; ``--device cpu`` runs them on the host (the kernels' plain
versions).  ``--seed s`` is the key ``(0, s)``: the words of the JAX
package's ``jax.random.key(s)``, so both command lines draw the same
samples.

The cluster backend's render is verify-then-retry: a render that counts
capacity truncations and flags the pixels they touched; where it
truncated, the exact fallback (the packed BVH) is attached and only the
flagged pixels are rendered again (``--checkpoint``: the progressive render
stops at the first truncating chunk and the fallback-attached retry resumes
its checkpoint).

The JAX command line's persistent XLA compilation cache has no counterpart
here: the port compiles its kernels once per checkout into
``tpu_pt_torch/_build/``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_scene(name: str):
    """Resolve a scene spec: builtin name or a .dae/.obj file path ->
    (host scene, camera_fn)."""
    from tpu_pt_torch.scene import cornell, meshes

    builtin = {
        "cornell": lambda: (cornell.cornell("empty"), cornell.camera),
        "cornell-empty": lambda: (cornell.cornell("empty"), cornell.camera),
        "cornell-spheres": lambda: (cornell.cornell("spheres"), cornell.camera),
        "cornell-glossy": lambda: (cornell.cornell("glossy"), cornell.camera),
        "cornell-mesh": lambda: (cornell.cornell("mesh"), cornell.camera),
        "big": lambda: (meshes.big_scene(subdiv=7), meshes.big_camera),
        "big-1m": lambda: (meshes.big_scene(subdiv=8), meshes.big_camera),
        "atrium": lambda: (meshes.atrium_scene(), meshes.atrium_camera),
    }
    if name in builtin:
        return builtin[name]()
    if name.endswith(".dae"):
        from tpu_pt_torch.scene import collada

        return collada.load(name)
    if name.endswith(".obj"):
        from tpu_pt_torch.scene import obj

        return obj.load(name)
    raise SystemExit(
        f"unknown scene {name!r}; builtins: {', '.join(sorted(builtin))}"
    )


def _host(img) -> np.ndarray:
    """An image tensor (or array) as a host float32 array."""
    return img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)


def _build_bvh(args, scene, cam, cfg, device):
    """The BVH the backend asked for -> (bvh, wavefront backend name)."""
    if args.backend == "cluster":
        from tpu_pt_torch.bvh import cluster

        if args.bvh == "lbvh":
            return cluster.build_cluster_device(scene, device=device), \
                "cluster"
        if args.autotune:
            # Frontier caps and pair budget sized from probe runs of the
            # real wavefront across the image (dense interiors).
            return cluster.autotune_for_render(
                scene, cam, cfg, queue=args.queue, exact_fallback=False,
                device=device), "cluster"
        return cluster.build_cluster_bvh(scene), "cluster"
    if args.bvh == "lbvh":   # "wavefront": the packed walk
        from tpu_pt_torch.bvh.lbvh import build_lbvh

        return build_lbvh(scene, device=device), "packed"
    from tpu_pt_torch.bvh.native import build_packed_any

    return build_packed_any(scene), "packed"


def _render_wavefront(args, scene, cam, cfg, key, device):
    """The wavefront backends' render with the command line's repair flow
    -> (host image, overflow left in it)."""
    from tpu_pt_torch.render import film, wavefront

    host_scene = scene
    bvh, wf_backend = _build_bvh(args, scene, cam, cfg, device)
    scene, cam, bvh = scene.to(device), cam.to(device), bvh.to(device)
    kw = dict(queue=args.queue, backend=wf_backend, device=device)
    repair = wf_backend == "cluster" and not args.no_exact_fallback
    suspects = None   # per-pixel overflow flags of the counted render

    def render_once(exact_bvh=False):
        nonlocal suspects
        if args.checkpoint:
            # Progressive, resumable render: spp chunks accumulated and
            # checkpointed after each; a resumed run gives the same bits.
            from tpu_pt_torch.render.progressive import render_progressive

            def on_chunk(spp_done, preview):
                print(f"progress: {spp_done}/{cfg.spp} spp", file=sys.stderr)
                if args.preview:
                    film.save(args.preview, preview)

            return render_progressive(
                scene, cam, cfg, key, bvh, checkpoint=args.checkpoint,
                chunk_spp=args.chunk_spp, on_chunk=on_chunk,
                return_counts=True,
                # Stop at the first truncating chunk: the fallback-attached
                # retry resumes the checkpoint, so nothing rendered before
                # the overflow is done again.
                stop_on_overflow=repair, overflow_is_exact=exact_bvh, **kw)
        if repair and not exact_bvh:
            # Flag the suspect pixels, so that an overflow is repaired by
            # rendering only those again.
            img, _, _, novf, _, suspects = \
                wavefront.render_wavefront_suspect_counts(scene, cam, cfg,
                                                          key, bvh, **kw)
            return _host(img), novf
        img, _, _, novf, _ = wavefront.render_wavefront_counts(
            scene, cam, cfg, key, bvh, **kw)
        return _host(img), novf

    img, n_overflow = render_once()
    if n_overflow and repair:
        # The counted render proved the capacity contract broke: attach the
        # exact fallback (the packed walk re-traces the truncated rays).
        from tpu_pt_torch.bvh.cluster import attach_fallback

        print(f"note: {n_overflow} BVH candidates overflowed static "
              "budgets; re-rendering with the exact fallback attached",
              file=sys.stderr)
        # The progressive checkpoint is kept: the chunk that overflowed was
        # never written, and a fallback-attached traversal gives the same
        # bits on the exact chunks, so the retry resumes it.
        bvh = attach_fallback(bvh, host_scene)
        if suspects is not None and int(suspects.sum()) > 0:
            # Render only the flagged pixels again: the repair's cost
            # follows the suspect count, not the image size.
            n_sus = int(suspects.sum())
            print(f"note: repairing {n_sus} suspect pixels "
                  f"({100.0 * n_sus / cfg.n_pixels:.2f}% of the image)",
                  file=sys.stderr)
            img, n_overflow = wavefront.repair_suspect_pixels(
                scene, cam, cfg, key, bvh, img, suspects, **kw)
            img = _host(img)
        else:
            img, n_overflow = render_once(exact_bvh=True)
        print(f"note: exact retry done ({n_overflow} overflows "
              "re-traced; image is exact)", file=sys.stderr)
    elif n_overflow:
        print(f"WARNING: {n_overflow} BVH candidates truncated by the "
              "capacity contract; the image may be missing hits; "
              "re-run with --autotune (or drop --no-exact-fallback)",
              file=sys.stderr)
    return img, n_overflow


def cmd_render(args) -> int:
    from tpu_pt_torch.config import RenderConfig, resolve_device
    from tpu_pt_torch.render import film

    device = resolve_device(args.device)
    scene, camera_fn = _load_scene(args.scene)
    if args.envmap:
        from tpu_pt_torch.render.envmap import load_envmap
        from tpu_pt_torch.scene.types import with_envmap

        scene = with_envmap(scene, load_envmap(args.envmap))
    cfg = RenderConfig(
        width=args.resolution[0], height=args.resolution[1], spp=args.spp,
        max_depth=args.max_depth, ns_area_light=args.light_samples,
        direct_only=args.direct_only,
    )
    cam = camera_fn(cfg.width, cfg.height)
    key = (0, args.seed)
    n_overflow = 0  # capacity-contract truncations (cluster backend)

    t0 = time.time()
    if args.backend in ("brute", "bvh"):
        from tpu_pt_torch.render.driver import render

        bvh = None
        if args.backend == "bvh":
            from tpu_pt_torch.bvh.sah import build_bvh

            bvh = build_bvh(scene)
        img = _host(render(scene, cam, cfg, key, backend=args.backend,
                           bvh=bvh, device=device))
    else:
        img, n_overflow = _render_wavefront(args, scene, cam, cfg, key,
                                            device)
    dt = time.time() - t0

    n_rays = cfg.n_pixels * cfg.spp  # primary rays (bounces extra)
    print(
        json.dumps(
            dict(
                scene=args.scene, width=cfg.width, height=cfg.height,
                spp=cfg.spp, max_depth=cfg.max_depth, seconds=round(dt, 3),
                primary_rays=n_rays,
                primary_rays_per_s=round(n_rays / dt, 1),
                mean_radiance=round(float(img.mean()), 5),
                overflow=n_overflow,
            )
        ), flush=True
    )
    film.save(args.outfile, img)
    print(f"wrote {args.outfile}", file=sys.stderr)
    return 0


def cmd_visualize_bvh(args) -> int:
    """Render the BVH traversal-cost heatmap of the camera rays."""
    from tpu_pt_torch.bvh.native import build_packed_any
    from tpu_pt_torch.config import resolve_device
    from tpu_pt_torch.render import debug, film

    device = resolve_device(args.device)
    scene, camera_fn = _load_scene(args.scene)
    packed = build_packed_any(scene).to(device)
    w, h = args.resolution
    stats = debug.bvh_heatmap(packed, camera_fn(w, h).to(device), w, h)
    print(json.dumps(dict(
        scene=args.scene,
        mean_visits=round(stats["mean_visits"], 2),
        max_visits=stats["max_visits"],
        mean_leaf_tests=round(stats["mean_leaf_tests"], 2),
    )), flush=True)
    film.save(args.outfile, debug.heatmap_image(stats["visits"]), gamma=1.0)
    print(f"wrote {args.outfile}", file=sys.stderr)
    return 0


def cmd_dump_bvh(args) -> int:
    """BVH structure dump (host builds only)."""
    from tpu_pt_torch.bvh.cluster import build_cluster_bvh
    from tpu_pt_torch.bvh.sah import build_bvh

    scene, _ = _load_scene(args.scene)
    bvh = build_bvh(scene)
    n = int(bvh.node_min.shape[0])
    leaf = np.asarray(bvh.prim_count) > 0
    cb = build_cluster_bvh(scene)
    print(json.dumps(dict(
        scene=args.scene, prims=scene.n_prims, nodes=n,
        leaves=int(leaf.sum()),
        max_leaf_size=int(np.asarray(bvh.prim_count).max()),
        root_min=np.asarray(bvh.node_min)[0].tolist(),
        root_max=np.asarray(bvh.node_max)[0].tolist(),
        cluster=dict(
            clusters=cb.n_clusters,
            pyramid_levels=[int(l.shape[0]) for l in cb.levels],
            frontier_caps=list(cb.frontiers),
            k_leaf=cb.k_leaf,
            pair_budget=cb.pair_budget,
            tile_bytes=int(np.asarray(cb.tiles).nbytes),
        ),
    )), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_pt_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="headless render to PNG")
    pr.add_argument("scene")
    pr.add_argument("-s", "--spp", type=int, default=16)
    pr.add_argument("-m", "--max-depth", type=int, default=4)
    pr.add_argument("-l", "--light-samples", type=int, default=1)
    pr.add_argument("-r", "--resolution", type=int, nargs=2, default=[512, 512])
    pr.add_argument("-f", "--outfile", default="out.png")
    pr.add_argument("-e", "--envmap", default=None,
                    help="lat-long environment map (.exr or .pfm)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--direct-only", action="store_true")
    pr.add_argument("--backend",
                    choices=["brute", "bvh", "wavefront", "cluster"],
                    default="cluster")
    pr.add_argument("--queue", type=int, default=1 << 13,
                    help="wavefront queue size (lanes)")
    pr.add_argument("--bvh", choices=["sah", "lbvh"], default="sah",
                    help="BVH build: host SAH (native/C++) or device LBVH")
    pr.add_argument("--autotune", action="store_true",
                    help="size cluster frontier caps + pair budget from "
                         "probe runs of the real wavefront (use for dense "
                         "interiors)")
    pr.add_argument("--checkpoint", default=None, metavar="STATE.npz",
                    help="progressive render: checkpoint the spp-chunked "
                         "accumulator here after every chunk and resume "
                         "from it if present (bit-exact vs one-shot)")
    pr.add_argument("--preview", default=None, metavar="PREVIEW.png",
                    help="with --checkpoint: (re)write the current mean "
                         "image here after every spp chunk")
    pr.add_argument("--chunk-spp", type=int, default=None,
                    help="spp per progressive chunk (default cfg.spp_chunk)")
    pr.add_argument("--no-exact-fallback", action="store_true",
                    help="skip the packed-BVH exact retrace of rays whose "
                         "candidates overflow static budgets (saves the "
                         "fallback build + memory; overflow then drops hits)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; raises "
                         "without one); cpu runs on the host")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("dump-bvh", help="print BVH structure stats")
    pb.add_argument("scene")
    pb.set_defaults(fn=cmd_dump_bvh)

    pv = sub.add_parser("visualize-bvh",
                        help="render BVH traversal-cost heatmap PNG")
    pv.add_argument("scene")
    pv.add_argument("-r", "--resolution", type=int, nargs=2, default=[256, 256])
    pv.add_argument("-f", "--outfile", default="bvh_heatmap.png")
    pv.add_argument("--device", default="cuda",
                    help="torch device to walk on (default cuda); cpu runs "
                         "on the host")
    pv.set_defaults(fn=cmd_visualize_bvh)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
