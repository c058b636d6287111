"""Mixture-of-Experts layer with sort-based (owner-computes) dispatch — the
port of ``repro.models.moe``.

The dispatch is the bucket packing of the BFS queue exchange
(``core/frontier.build_queue_buckets``): tokens are the candidate
vertices, the expert is the owner, capacity the send buffer's cap.
Assignments are sorted by expert (a stable sort), each one's rank in its
expert's bucket is its position minus the bucket's start
(``searchsorted``), and an assignment past the capacity drops to a pad
slot.  The expert products are batched over the experts (``bmm``), so the
FLOP stay those of the real expert work, and the ``dots`` remat policy
keeps only the router's and the shared expert's 2-D products, as JAX's
``dots_with_no_batch_dims_saveable`` does.

Top-k breaks ties toward the lower expert index, as ``lax.top_k`` does
(``torch.topk`` does not; a stable descending sort does).

Two routes:

* ``_moe_apply_local`` — one shard: JAX's route with sharding hints unset,
  the one the transformer calls.  Its combine is a segment sum in
  ``x.dtype``: each token's contributions added in the sorted order, as
  the JAX package's ``segment_sum`` adds them on the CPU.
* ``moe_apply_sharded`` — expert parallel on a mesh of the BFS engine's
  interface (``LocalMesh``, ``DistMesh``): tokens split over the data
  axes, experts over the model axis.  Every model-axis shard sees the same
  data-shard tokens (JAX's ``in_specs P(dp, None)``), runs its ``E / m``
  experts, and the f32 partials are summed over the model axis with one
  ``psum`` (there is no token all-to-all).  Capacity is computed per data
  shard and ``lb_loss`` is the mean of the data shards' losses, so at
  dp > 1 the route differs from the local one, by JAX's own design.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.layers.core import scaled_normal, swiglu


def init_moe_params(generator: torch.Generator, d_model: int,
                    cfg: MoEConfig, dtype: torch.dtype,
                    lead: tuple = ()) -> dict:
    """JAX's MoE weights on ``generator``'s device: the router (D, E) in
    f32, the experts' ``w_gate`` / ``w_up`` (E, D, F) and ``w_down``
    (E, F, D), and ``shared`` (width ``d_ff * shared_experts``) when the
    config has shared experts; each leaf with the leading dims ``lead``
    (the transformer stacks a block's leaves over its groups, JAX's
    ``vmap`` of the init).  The draws differ from ``jax.random``'s."""
    e, f, d = cfg.n_experts, cfg.d_ff, d_model

    def draw(shape, fan_in, dt=dtype):
        return scaled_normal((*lead, *shape), fan_in ** -0.5, dt, generator)

    p = {"router": draw((d, e), d, torch.float32),
         "w_gate": draw((e, d, f), d), "w_up": draw((e, d, f), d),
         "w_down": draw((e, f, d), f)}
    if cfg.shared_experts:
        fs = f * cfg.shared_experts
        p["shared"] = {"w_gate": draw((d, fs), d), "w_up": draw((d, fs), d),
                       "w_down": draw((fs, d), fs)}
    return p


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert, a multiple of 8 and at least 8."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh=None,
              dp_axes=("data",), model_axis: str = "model"):
    """x: (T, D) -> (out (T, D), {"lb_loss", "dropped"}): the sharded route
    on ``mesh`` when one is given, else the local one.  (JAX picks by its
    sharding hints, which the port has not ported.)"""
    if mesh is None:
        return _moe_apply_local(params, x, cfg)
    return moe_apply_sharded(params, x, cfg, mesh, dp_axes, model_axis)


def _route(router: torch.Tensor, x: torch.Tensor, k: int):
    """(probs (T, E) f32, gates (T, K) renormalised, experts (T, K)): the
    top k by probability, ties toward the lower expert index."""
    # x rounded to f32, as JAX's x.astype(f32) @ router (an f64 twin's
    # router then promotes the product)
    probs = torch.softmax(torch.matmul(x.float().to(router.dtype), router),
                          dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, expert


def _balance_loss(probs: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """Switch-style balance loss: E * sum(frac * mean prob), ``frac`` the
    share of tokens whose first choice is each expert."""
    t, e = probs.shape
    frac = torch.bincount(expert[:, 0], minlength=e).float() / t
    return e * (frac * probs.mean(0)).sum()


def _bucket(owner: torch.Tensor, n_buckets: int, c: int):
    """Stable sort of the assignments by ``owner`` (in ``[0, n_buckets]``;
    ``n_buckets`` is a sentinel that never keeps); returns the order,
    whether each sorted assignment keeps a slot, and its slot
    (``n_buckets * c``, the pad, where it does not)."""
    n = owner.shape[0]
    order = torch.argsort(owner, stable=True)
    se = owner[order]
    starts = torch.searchsorted(se, torch.arange(n_buckets + 1,
                                                 device=owner.device))
    rank = torch.arange(n, device=owner.device) - starts[se]
    keep = (se < n_buckets) & (rank < c)
    slot = torch.where(keep, se * c + rank, n_buckets * c)
    return order, keep, slot


def _dispatch(x: torch.Tensor, slot: torch.Tensor, stok: torch.Tensor,
              n_slots: int):
    """(n_slots, D) expert inputs and the (n_slots,) token of each slot
    (``T``, a zero row, where a slot is empty).  Token ids go into the
    slots (drops into the pad slot ``n_slots``, then cut), then the rows
    are gathered: no (T * K, D) copy of the tokens."""
    t = x.shape[0]
    buf_tok = torch.full((n_slots + 1,), t, dtype=torch.long,
                         device=x.device)
    buf_tok[slot] = stok
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return x_pad[buf_tok[:-1]], buf_tok[:-1]


def _experts(w: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU, batched over the experts: (E, C, D) ->
    (E, C, D)."""
    h = torch.bmm(expert_in, w["w_gate"])
    u = torch.bmm(expert_in, w["w_up"])
    return torch.bmm(F.silu(h) * u, w["w_down"])


def _add_shared(params: dict, cfg: MoEConfig, out: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """``out`` plus the shared expert's SwiGLU of ``x``, if the config
    has shared experts."""
    if not cfg.shared_experts:
        return out
    sp = params["shared"]
    return out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])


def _moe_apply_local(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """One shard (JAX's route with hints unset)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)
    probs, gate, expert = _route(params["router"], x, k)

    slot_token = torch.arange(t, device=x.device).repeat_interleave(k)
    order, keep, slot = _bucket(expert.reshape(-1), e, c)
    stok, sg = slot_token[order], gate.reshape(-1)[order]
    expert_in, _ = _dispatch(x, slot, stok, e * c)
    expert_out = _experts(params, expert_in.view(e, c, d))

    # combine: each kept assignment's output weighted by its gate, summed
    # a token in x.dtype in the sorted order (JAX's segment_sum); the
    # assignments gathered token by token, each token's in sorted order
    by_token = torch.argsort(stok, stable=True)
    flat_out = expert_out.reshape(e * c, d)
    parts = (flat_out[slot.clamp_max(e * c - 1)[by_token]]
             * (sg * keep)[by_token, None].to(x.dtype)).view(t, k, d)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    out = _add_shared(params, cfg, out, x)
    aux = {"lb_loss": _balance_loss(probs, expert),
           "dropped": (~keep).sum()}
    return out.to(x.dtype), aux


# ---------------------------------------------------------------------------
# expert parallel: tokens over the data axes, experts over the model axis
# ---------------------------------------------------------------------------

def _member_index(mesh, shard: int, axes) -> int:
    """Shard ``shard``'s index within its group over ``axes`` (row-major
    coordinates over ``mesh.shape``, linearized major-first in the order
    of ``axes``: the meshes' own rule)."""
    coords, k = [], shard
    for size in reversed(mesh.shape):
        coords.append(k % size)
        k //= size
    coords.reverse()
    idx = 0
    for a in mesh.axes(axes):
        dim = mesh.axis_names.index(a)
        idx = idx * mesh.shape[dim] + coords[dim]
    return idx


def _shard_experts(params: dict, x: torch.Tensor, cfg: MoEConfig, e0: int,
                   e_local: int):
    """One shard: its tokens x (T_loc, D) through the ``e_local`` experts
    from ``e0`` (JAX's ``_moe_local_experts``).  Returns the (T_loc, D)
    f32 partial sum, the shard's balance loss and its dropped count."""
    t, d = x.shape
    k = cfg.top_k
    c = capacity(t, cfg)
    probs, gate, expert = _route(params["router"], x, k)

    local_e = expert.reshape(-1) - e0
    mine = (local_e >= 0) & (local_e < e_local)
    owner = torch.where(mine, local_e, e_local)        # sentinel bucket
    order, keep, slot = _bucket(owner, e_local, c)
    slot_token = torch.arange(t, device=x.device).repeat_interleave(k)
    stok, sg = slot_token[order], gate.reshape(-1)[order]

    expert_in, buf_tok = _dispatch(x, slot, stok, e_local * c)
    buf_gate = torch.zeros(e_local * c + 1, dtype=torch.float32,
                           device=x.device)
    buf_gate[slot] = sg * keep
    w = {n: params[n][e0:e0 + e_local] for n in ("w_gate", "w_up",
                                                  "w_down")}
    expert_out = _experts(w, expert_in.view(e_local, c, d))
    contrib = expert_out.reshape(e_local * c, d) * buf_gate[:-1, None].to(
        expert_out.dtype)
    partial = torch.zeros((t + 1, d), dtype=torch.float32, device=x.device)
    partial.index_add_(0, buf_tok, contrib.float())
    dropped = (~keep).sum() - (~mine).sum()
    return partial[:t], _balance_loss(probs, expert), dropped


def moe_apply_sharded(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh,
                      dp_axes=("data",), model_axis: str = "model"):
    """x: (T, D), the global tokens on every rank -> (the global (T, D)
    output, {"lb_loss", "dropped"}), JAX's ``moe_apply_sharded`` on
    ``mesh``.  Each shard this mesh holds (``mesh.local_shards``) takes
    its data shard's ``T / dp`` tokens and its model shard's ``E / m``
    experts; the f32 partials are ``psum``'d over ``model_axis``, cast to
    ``x.dtype``, the shared expert added, and the data shards' outputs
    gathered into the global array (JAX's ``out_specs P(dp, None)``).
    ``lb_loss`` is the data shards' mean, ``dropped`` their sum over every
    axis.  Falls back to the local route where the experts do not divide
    over the model axis or the tokens over the data axes, as JAX does."""
    t, d = x.shape
    e = cfg.n_experts
    dp_axes = tuple(dp_axes)
    m, n_dp = mesh.axis_size(model_axis), mesh.axis_size(dp_axes)
    if e % m or t % n_dp:
        return _moe_apply_local(params, x, cfg)
    e_local, t_loc = e // m, t // n_dp

    partials, lbs, drops, xs = [], [], [], []
    for shard in mesh.local_shards:
        i = _member_index(mesh, shard, dp_axes)
        j = _member_index(mesh, shard, model_axis)
        xs.append(x[i * t_loc:(i + 1) * t_loc])
        part, lb, drop = _shard_experts(params, xs[-1], cfg, j * e_local,
                                        e_local)
        partials.append(part)
        lbs.append(lb)
        drops.append(drop)
    out = mesh.psum(torch.stack(partials), model_axis).to(x.dtype)
    out = torch.stack([_add_shared(params, cfg, o, xi)
                       for o, xi in zip(out, xs)])
    full = mesh.all_gather(out, dp_axes)[0].reshape(t, d)
    lb = mesh.psum(torch.stack(lbs), dp_axes)[0] / n_dp
    dropped = mesh.psum(torch.stack(drops), (*dp_axes, model_axis))[0]
    return full, {"lb_loss": lb, "dropped": dropped}
