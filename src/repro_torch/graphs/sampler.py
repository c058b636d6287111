"""Layered neighbor sampler (GraphSAGE-style) for the minibatch_lg cell —
the port's copy of ``repro.graphs.sampler``, bitwise to it for a seed.

Host-side numpy over CSR, as in production systems (samplers live in the
data pipeline, not on the accelerator).  Output is a padded, statically-
shaped subgraph batch of the shapes of ``data.synthetic._gnn_dims``:

  * layer 0: ``batch_nodes`` seed nodes,
  * layer k: ``fanout[k-1]`` sampled in-neighbors per layer-(k-1) node
    (with replacement when degree < fanout, standard GraphSAGE),
  * edges point child -> parent (messages flow toward the seeds),
  * node ids are batch-local (gathered features come along).

Determinism: a seed fully determines the sample — the trainer's
restart-replay contract extends through the sampler.

One departure from the JAX sampler: a draw of an isolated parent whose
neighbour list would start past the last edge (an isolated last node,
as R-MAT graphs have) is clamped, where JAX's indexing raises
``IndexError``.  Every other sample is bitwise JAX's.
"""

from __future__ import annotations

import numpy as np


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 features: np.ndarray | None = None):
        self.indptr = indptr
        self.indices = indices
        self.features = features
        self.n = indptr.shape[0] - 1

    def sample(self, seeds: np.ndarray, fanouts, *, seed: int = 0,
               n_pad: int, e_pad: int, d_feat: int):
        rng = np.random.default_rng(seed)
        layers = [np.asarray(seeds, dtype=np.int64)]
        srcs, dsts = [], []
        offset = 0
        for f in fanouts:
            parents = layers[-1]
            deg = self.indptr[parents + 1] - self.indptr[parents]
            # sample f neighbors per parent (with replacement; isolated
            # parents self-loop so shapes stay static)
            draw = rng.integers(0, np.maximum(deg, 1)[:, None],
                                size=(parents.shape[0], f))
            base = self.indptr[parents][:, None]
            # an isolated parent past the last neighbour list points one
            # past ``indices`` (JAX's sampler raises there); clamp it: the
            # self-loop below replaces its draw
            at = np.minimum(base + draw, self.indices.shape[0] - 1)
            child = self.indices[at]                           # (P, f)
            child = np.where(deg[:, None] > 0, child, parents[:, None])
            # local ids: parents live at [offset, offset+P); children are
            # appended as a new layer
            child_local = (offset + parents.shape[0]
                           + np.arange(parents.shape[0] * f))
            parent_local = offset + np.repeat(np.arange(parents.shape[0]), f)
            srcs.append(child_local)
            dsts.append(parent_local)
            offset += parents.shape[0]
            layers.append(child.reshape(-1))

        nodes = np.concatenate(layers)
        src = np.concatenate(srcs)
        dst = np.concatenate(dsts)
        n_real, e_real = nodes.shape[0], src.shape[0]
        assert n_real <= n_pad and e_real <= e_pad, (n_real, n_pad, e_real,
                                                     e_pad)

        if self.features is not None:
            feats = self.features[nodes].astype(np.float32)
        else:
            fr = np.random.default_rng(seed + 1)
            feats = fr.standard_normal((n_real, d_feat)).astype(np.float32)

        batch = {
            "node_feats": np.zeros((n_pad, d_feat), np.float32),
            "edge_src": np.zeros((e_pad,), np.int32),
            "edge_dst": np.full((e_pad,), -1, np.int32),
            "valid_nodes": np.zeros((n_pad,), bool),
            "global_ids": np.full((n_pad,), -1, np.int64),
        }
        batch["node_feats"][:n_real] = feats
        batch["edge_src"][:e_real] = src
        batch["edge_dst"][:e_real] = dst
        batch["valid_nodes"][:n_real] = True
        batch["global_ids"][:n_real] = nodes
        return batch
