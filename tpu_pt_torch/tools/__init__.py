"""Measurement tools of the port: the H100 counterparts of the JAX
package's fetch probes in ``tools/`` (``python -m
tpu_pt_torch.tools.<name>``; ``--device cpu`` runs the checks without
timing)."""
