"""tpu_pt_torch — the PyTorch/CUDA port of the tpu_pt path tracer.

Same sub-package and module names as ``tpu_pt`` (``core``, ``scene``,
``bvh``, ``render``, ``kernels``, ``diff``, ``dist``, ``tools``), so the
counterpart of a module is found by path.  The package imports ``torch``
and ``numpy`` only; entry points take an explicit ``device`` argument (the
distribution entry points: a mesh) that defaults to ``"cuda"`` and raise
when no card is present (pass ``device="cpu"`` to run the plain versions
of the kernels on the host, as the tests do).

It covers what ``tpu_pt`` does: scenes and their loaders, every BVH build
(host and device), the oracle and wavefront renderers on every backend,
exact repair of capacity overflow, gradients through the wavefront loop
(``diff``), tile-sharded renders and the sharded gradient step on
``torch.distributed`` (``dist``), the command line (``cli``) and the probe
tools (``tools``); every Pallas kernel of ``tpu_pt`` is a hand-written CUDA
kernel here (``csrc``, bound in ``kernels``).
"""

__version__ = "0.1.0"
