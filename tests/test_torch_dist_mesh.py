"""``DistMesh`` (``core.dist_mesh``) against ``LocalMesh`` on the CPU.

With 2 and 4 ``gloo`` ranks (one group of rank processes per world size,
started when the module starts, each with a hard deadline:
``tests/helpers/dist_torch.py``), each collective of a ``DistMesh`` on
rank k's slice of a seeded numpy input equals row k of the ``LocalMesh``
result, bitwise: on the flat mesh and on a 1 x 2 or 2 x 2 grid, over
each axis, the tuple in mesh order and the tuple in the other order
(whose linearization is not ``new_group``'s rank order), for
``all_to_all``, ``all_gather``, ``psum_scatter``, ``psum``, ``pmax`` and
``axis_index``; the packed OR-merges give each owner the OR of every
shard's slice; and a world size that differs from the mesh's raises.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import exchange as ex
from repro_torch.core.mesh import LocalMesh

from helpers.dist_torch import start_ranks, wait_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
OPS = ("all_to_all", "all_gather", "psum_scatter", "psum", "pmax",
       "axis_index")
PACKED = ("alltoall_direct_packed", "allgather_merge_packed",
          "hierarchical_packed")


def _layouts(world: int) -> dict:
    """``{name: (shape, names, [axis specs])}`` of the meshes tested at
    ``world`` ranks."""
    r = 2 if world == 4 else 1
    return {
        "flat": ((world,), ("bfs_p",), ["bfs_p", ("bfs_p",)]),
        "grid": ((r, 2), ("rows", "cols"),
                 ["rows", "cols", ("rows", "cols"), ("cols", "rows")]),
    }


def _input(op: str, p: int, g: int, seed: int) -> np.ndarray:
    """The stacked ``(p, ...)`` input of one case (``g`` the group
    size): blocks of the tiled ops split into ``g``."""
    rng = np.random.default_rng(seed)
    if op == "all_to_all":
        return rng.integers(-2**31, 2**31, (p, g * 3, 2), dtype=np.int64
                            ).astype(np.int32)
    if op == "all_gather":
        return rng.integers(0, 256, (p, 5), dtype=np.int64).astype(np.uint8)
    if op == "psum_scatter":
        return rng.integers(0, 3, (p, g * 2, 3)).astype(np.float32)
    return rng.integers(-1000, 1000, (p, 3), dtype=np.int64)


def _tensor(op: str, x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    # the dense reduce-scatter ships bf16 (exchange._dense_reduce_scatter)
    return t.to(torch.bfloat16) if op == "psum_scatter" else t


def _cases(world: int):
    """``(key, layout, op, axis)`` of every collective case."""
    for name, (shape, names, specs) in _layouts(world).items():
        for op in OPS:
            for axis in specs:
                yield f"{name}|{op}|{axis}", name, op, axis


def _packed_input(p: int, seed: int) -> np.ndarray:
    """(p, p*W, S) int32 words, W = 3 words an owner block, S = 2."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (p, p * 3, 2), dtype=np.int64
                        ).astype(np.int32)


def _run(mesh, op, x, axis):
    if op == "axis_index":
        return mesh.axis_index(axis)
    return getattr(mesh, op)(x, axis)


def _rank_collectives():
    """Rank body: every case on this rank's slice; JSON-able results."""
    import torch.distributed as dist

    from repro_torch.core.dist_mesh import DistMesh

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    meshes = {name: DistMesh(shape, names, "cpu")
              for name, (shape, names, _) in _layouts(world).items()}
    for seed, (key, name, op, axis) in enumerate(_cases(world)):
        mesh = meshes[name]
        x = _input(op, world, mesh.axis_size(axis), seed)
        y = _run(mesh, op, _tensor(op, x[rank:rank + 1]), axis)
        out[key] = y.float().tolist()
    flat = meshes["flat"]
    for seed, name in enumerate(PACKED):
        st = ex.get_exchange("dense", name)
        x = torch.from_numpy(_packed_input(world, 100 + seed))
        out[f"packed|{name}"] = st.impl(x[rank:rank + 1], flat,
                                        "bfs_p").tolist()
    grid = meshes["grid"]
    x = torch.from_numpy(_packed_input(world, 200))
    out["packed|hierarchical_grid"] = ex.get_exchange(
        "dense", "hierarchical_packed").impl(
        x[rank:rank + 1], grid, ("rows", "cols")).tolist()
    out["describe"] = flat.describe()
    out["local_shards"] = list(flat.local_shards)
    try:
        DistMesh((world + 1,), ("bfs_p",), "cpu")
        out["wrong_world"] = "no error"
    except ValueError as e:
        out["wrong_world"] = str(e)
    return out


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    """Start both worlds' ranks at once; wait for each on first use."""
    procs = {w: start_ranks(w, "test_torch_dist_mesh:_rank_collectives",
                            tmp_path_factory.mktemp(f"mesh{w}"))
             for w in WORLDS}
    done = {}

    def results(world):
        if world not in done:
            done[world] = wait_ranks(procs[world], timeout=120)
        return done[world]

    yield results
    for ps in procs.values():
        for p, _ in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", [k for k, *_ in _cases(4)])
def test_collective_equals_local_mesh_row(dist_results, world, key):
    ranks = dist_results(world)
    name, op, axis_s = key.split("|")
    shape, names, specs = _layouts(world)[name]
    axis = next(a for a in specs if str(a) == axis_s)
    local = LocalMesh(shape, names, "cpu")
    seed = [k for k, *_ in _cases(world)].index(key)
    x = _input(op, world, local.axis_size(axis), seed)
    want = _run(local, op, _tensor(op, x), axis).float()
    for k, got in enumerate(ranks):
        assert torch.equal(torch.tensor(got[key]), want[k:k + 1].reshape(
            torch.tensor(got[key]).shape)), (k, key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", PACKED)
def test_packed_or_merge_gives_each_owner_the_or(dist_results, world, name):
    """Each owner receives the OR of every shard's slice of its block
    (NCCL has no bitwise-OR reduction: all-to-all or all-gather plus a
    local OR), as on the ``LocalMesh``."""
    ranks = dist_results(world)
    seed = 100 + PACKED.index(name)
    x = _packed_input(world, seed)
    want = np.bitwise_or.reduce(x.reshape(world, world, 3, 2), axis=0)
    local = ex.get_exchange("dense", name).impl(
        torch.from_numpy(x), LocalMesh.flat(world, "cpu"), "bfs_p")
    for k, got in enumerate(ranks):
        got = np.asarray(got[f"packed|{name}"], np.int32)
        np.testing.assert_array_equal(got[0], want[k])
        np.testing.assert_array_equal(got[0], local[k].numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_hierarchical_or_merge_over_the_grid(dist_results, world):
    ranks = dist_results(world)
    x = _packed_input(world, 200)
    r = 2 if world == 4 else 1
    local = ex.get_exchange("dense", "hierarchical_packed").impl(
        torch.from_numpy(x), LocalMesh((r, 2), ("rows", "cols"), "cpu"),
        ("rows", "cols"))
    for k, got in enumerate(ranks):
        np.testing.assert_array_equal(
            np.asarray(got["packed|hierarchical_grid"], np.int32)[0],
            local[k].numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_one_shard_a_rank_and_a_wrong_world_raises(dist_results, world):
    ranks = dist_results(world)
    for k, got in enumerate(ranks):
        assert got["local_shards"] == [k]
        assert got["describe"]["kind"] == "DistMesh"
        assert got["describe"]["transport"] == \
            "gloo through the host, cpu tensors"
        assert got["describe"]["rank"] == k
        assert f"the process group has {world} ranks" in got["wrong_world"]


def test_dist_mesh_needs_an_initialized_group():
    import torch.distributed as dist

    from repro_torch.core.dist_mesh import DistMesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized"):
        DistMesh((2,), ("bfs_p",), "cpu")
