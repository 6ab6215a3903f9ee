"""The differentiable parameters of a scene, split out and merged back.

Gradients are taken with respect to the vertex positions, the materials'
albedo, roughness and emission, and the lights' radiance.  They live as
ordinary fields of ``Scene``; ``split`` takes them out as a dict (what an
optimizer updates and what the gradients come back as) and ``merge`` puts
a dict of them back into a scene.
"""

from __future__ import annotations

from tpu_pt_torch.scene.types import Scene

KEYS = ("vertices", "albedo", "roughness", "emission", "light_radiance")


def split(scene: Scene):
    """Scene -> (params dict with the ``KEYS``, the scene)."""
    params = dict(
        vertices=scene.vertices,
        albedo=scene.materials.albedo,
        roughness=scene.materials.roughness,
        emission=scene.materials.emission,
        light_radiance=scene.lights.radiance,
    )
    return params, scene


def merge(params, scene: Scene) -> Scene:
    """``scene`` with its parameter fields taken from ``params``."""
    return scene._replace(
        vertices=params["vertices"],
        materials=scene.materials._replace(
            albedo=params["albedo"],
            roughness=params["roughness"],
            emission=params["emission"],
        ),
        lights=scene.lights._replace(radiance=params["light_radiance"]),
    )
