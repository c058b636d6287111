"""Carry weights between the JAX package's layout and the port's.

``from_jax_params`` takes the numpy tree of
``repro.models.transformer.init_params`` (``jax.tree.map(np.asarray,
params)``: nested dicts and lists of arrays; MoE blocks with their nested
``shared`` expert, q/k/v biases, and no ``unembed`` when the embeddings
are tied) and returns the port's ``Transformer``; ``to_numpy`` is its
inverse.  ``deepfm_from_jax_params``
and ``deepfm_to_numpy`` do the same for DeepFM's tree (``table``,
``lin_table``, ``lin_dense``, ``bias``, ``mlp[i]["w"/"b"]``), which the
port keeps as a dict of tensors.  ``train_state_from_jax`` and
``train_state_to_numpy`` carry a whole train state (``{"params", "opt":
{"m", "v", "step"}}``, as ``launch.steps``' ``make_state`` builds it over
a dict of tensors: DeepFM's, or an LM's JAX-layout tree, MoE blocks
included), each leaf under its JAX path.
``gnn_from_jax_params`` and ``gnn_to_numpy`` carry the tree of a GNN
(``repro.models.gnn.models.init_params``, any of the four kinds), which
the port keeps in the same layout of dicts and lists.  bf16 leaves cross as their 16-bit
patterns, so every direction is bitwise.  This module imports
neither JAX nor the JAX package; ``to_numpy`` needs ``ml_dtypes`` (which
JAX installs) only for a bf16 leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Transformer
from repro_torch.tree import map_tree


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax_params(tree, device) -> Transformer:
    """The port's weights from the JAX package's (as numpy), on
    ``device``."""
    return Transformer.from_tree(map_tree(lambda a: _leaf_to_torch(a, device),
                                      tree))


def to_numpy(params: Transformer) -> dict:
    """The JAX-layout numpy tree of ``params`` (``from_jax_params``'s
    inverse)."""
    return map_tree(_leaf_to_numpy, params.tree())


DEEPFM_KEYS = ("table", "lin_table", "lin_dense", "bias", "mlp")


def deepfm_from_jax_params(tree, device) -> dict:
    """The port's DeepFM weights from the JAX package's (as numpy), on
    ``device``."""
    if sorted(tree) != sorted(DEEPFM_KEYS):
        raise ValueError(f"a DeepFM tree has keys {DEEPFM_KEYS}, not "
                         f"{tuple(tree)}")
    return map_tree(lambda a: _leaf_to_torch(a, device), tree)


def deepfm_to_numpy(params: dict) -> dict:
    """The numpy tree of DeepFM ``params`` (``deepfm_from_jax_params``'s
    inverse)."""
    return map_tree(_leaf_to_numpy, params)


#: the top-level keys of each GNN kind's tree
GNN_KEYS = {"gcn": ("layers",), "gatedgcn": ("in_e", "in_h", "layers", "out"),
            "schnet": ("embed", "inter", "out"),
            "graphcast": ("dec", "enc_e", "enc_h", "layers")}


def gnn_from_jax_params(tree, device) -> dict:
    """The port's GNN weights from the JAX package's (as numpy), on
    ``device``."""
    if tuple(sorted(tree)) not in GNN_KEYS.values():
        raise ValueError(f"a GNN tree has the keys of one of {GNN_KEYS}, "
                         f"not {tuple(tree)}")
    return map_tree(lambda a: _leaf_to_torch(a, device), tree)


def gnn_to_numpy(params: dict) -> dict:
    """The numpy tree of GNN ``params`` (``gnn_from_jax_params``'s
    inverse)."""
    return map_tree(_leaf_to_numpy, params)


def train_state_from_jax(tree, device) -> dict:
    """The port's train state from the JAX package's (as numpy:
    ``jax.tree.map(np.asarray, state)``), on ``device``."""
    if sorted(tree) != ["opt", "params"] or sorted(tree["opt"]) != [
            "m", "step", "v"]:
        raise ValueError("a train state is {'params', 'opt': {'m', 'v', "
                         "'step'}}")
    return map_tree(lambda a: _leaf_to_torch(a, device), tree)


def train_state_to_numpy(state: dict) -> dict:
    """The numpy tree of a train state (``train_state_from_jax``'s
    inverse)."""
    return map_tree(_leaf_to_numpy, state)
