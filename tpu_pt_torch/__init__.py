"""tpu_pt_torch — the PyTorch/CUDA port of the tpu_pt path tracer.

Same sub-package and module names as ``tpu_pt`` (``core``, ``scene``,
``bvh``, ``render``, ``kernels``), so the counterpart of a module is found
by path.  The package imports ``torch`` and ``numpy`` only; entry points
take an explicit ``device`` argument that defaults to ``"cuda"`` and raise
when no card is present (pass ``device="cpu"`` to run the plain versions
of the kernels on the host, as the tests do).

This slice covers forward rendering through the cluster-BVH wavefront path
(``render.wavefront.render_wavefront_counts`` with ``backend="cluster"``).
"""

__version__ = "0.1.0"
