"""MLPs — the port's copy of ``init_mlp`` and ``apply_mlp`` from
``repro.models.gnn.common`` (DeepFM's deep branch uses them), at the one
setting DeepFM uses: f32 weights, a bias on every layer, ReLU between the
layers and none after the last.  The rest of the GNN code is a later slice.
Layers are a list of dicts ``{"w": (d_in, d_out), "b": (d_out,)}``, the
JAX package's layout."""

from __future__ import annotations

import torch


def init_mlp(generator: torch.Generator, dims) -> list:
    """Weights normal * fan_in ** -0.5, biases zero, f32 on
    ``generator``'s device.  The draws differ from ``jax.random``'s; tests
    carry weights across with ``models.convert``."""
    dev = generator.device
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=generator, device=dev)
        layers.append({"w": w.mul_(d_in ** -0.5),
                       "b": torch.zeros(d_out, device=dev)})
    return layers


def apply_mlp(layers, x):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
