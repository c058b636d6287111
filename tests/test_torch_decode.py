"""The port's LM decode slice on the CPU against the JAX package: rope
with per-sequence positions, ``decode_attention`` (scalar and per-sequence
offsets and lengths, windows), ``decode_step`` at scalar and per-sequence
positions after a prefill, the decode bundle, the continuous-batching
``Server`` and the serve launcher, on gemma3's REDUCED config with the
JAX package's weights carried across by ``models.convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.launch import serve as j_serve_launcher
from repro.launch import steps as j_steps
from repro.layers import core as j_core
from repro.models import transformer as j_tf
from repro.serve.batcher import Request as JRequest
from repro.serve.batcher import Server as JServer
from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import steps
from repro_torch.layers import core
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.batcher import Request, Server

torch.set_num_threads(1)

# f32 on both sides, the same formulas, products and sums in another
# order: the decode logits read at most 2.7e-6 apart (on logits up to 3.3)
TOL = {"rtol": 1e-5, "atol": 1e-5}
_j_init = jax.jit(j_tf.init_params, static_argnums=0)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def gemma():
    """gemma3 REDUCED (f32, windows of 16) and its JAX seed-0 weights in
    both packages."""
    j_cfg, cfg = j_get_arch("gemma3_12b").reduced, get_arch(
        "gemma3_12b").reduced
    j_params = _j_init(j_cfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, j_params), "cpu")
    return j_cfg, cfg, j_params, params


def test_rope_with_per_sequence_positions_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3], [40, 41, 42, 43], [7, 9, 11, 500]],
                   np.int32)
    want = j_core.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = core.rope(_t(x), _t(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a row of (B, S) positions equals the shared (S,) form for that row
    shared = core.rope(_t(x), _t(pos[1]), 10_000.0)
    torch.testing.assert_close(got[1], shared[1], rtol=0, atol=0)


@pytest.mark.parametrize("sq,q_offset,kv_len,window", [
    (1, [5, 0, 37], [6, 1, 38], 0),       # decode: each sequence's depth
    (1, [30, 12, 63], [31, 13, 64], 16),  # a window that binds and not
    (3, [4, 20, 50], [7, 23, 53], 8),
    (1, 9, 10, 4),                        # scalar offset and length
    (2, 0, None, 0),                      # scalar, every key valid
    (1, [3, 3, 3], None, 0),              # per-sequence offset only
    (1, 0, [0, 5, 64], 0)])               # a sequence that sees no key
def test_decode_attention_matches_jax(sq, q_offset, kv_len, window):
    rng = np.random.default_rng(sq + window)
    b, hq, hkv, skv, dh = 3, 4, 2, 64, 16
    q = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)

    def arg(x, lib):
        if isinstance(x, list):
            return (jnp.asarray(x, jnp.int32) if lib == "jax"
                    else torch.tensor(x, dtype=torch.int32))
        return x

    want = j_core.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        q_offset=arg(q_offset, "jax"), kv_len=arg(kv_len, "jax"))
    got = core.chunked_attention(
        _t(q), _t(k), _t(v), causal=True, window=window,
        q_offset=arg(q_offset, "torch"), kv_len=arg(kv_len, "torch"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if kv_len == [0, 5, 64]:
        assert not got[0].any()


def test_chunked_attention_refuses_a_long_query():
    """A query past 8 positions goes to the chunked scan, which refuses
    (as JAX's asserts) a chunk that does not divide the keys."""
    x = torch.zeros(1, 2, 12, 16)
    with pytest.raises(ValueError, match="does not divide"):
        core.chunked_attention(x, x, x, chunk=8)
    assert core.chunked_attention(x, x, x, chunk=4).shape == x.shape


def _jax_prefill(j_cfg, j_params, tokens, max_len):
    return jax.jit(lambda p, t: j_tf.prefill(j_cfg, p, t, max_len))(
        j_params, jnp.asarray(tokens))


@pytest.mark.parametrize("per_sequence", [False, True])
def test_decode_step_matches_jax(gemma, per_sequence):
    """Prefill a 20-token prompt into a 48-deep cache, then three decode
    steps: at a scalar position (every sequence at 20, 21, 22) or at
    per-sequence positions (20 and 17: the second sequence rewrites its
    last prompt rows).  The logits and every layer's cache against
    JAX's."""
    j_cfg, cfg, j_params, params = gemma
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    _, j_cache, _ = _jax_prefill(j_cfg, j_params, tokens, 48)
    _, cache, _ = tf.prefill(cfg, params, torch.from_numpy(tokens), 48)
    for t, jc in enumerate(j_cache):
        for n in "kv":
            np.testing.assert_allclose(cache[t][n].numpy(),
                                       np.asarray(jc[n]), **TOL)
    j_decode = jax.jit(lambda p, c, pos, tok: j_tf.decode_step(
        j_cfg, p, c, pos, tok))
    for i in range(3):
        tok = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        if per_sequence:
            pos = np.array([20 + i, 17 + i], np.int32)
            j_pos, t_pos = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            j_pos, t_pos = jnp.int32(20 + i), torch.tensor(20 + i,
                                                          dtype=torch.int32)
        want, j_cache = j_decode(j_params, j_cache, j_pos, jnp.asarray(tok))
        got, cache = tf.decode_step(cfg, params, cache, t_pos,
                                    torch.from_numpy(tok))
        assert got.shape == (2, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t, jc in enumerate(j_cache):
        for n in "kv":
            np.testing.assert_allclose(cache[t][n].numpy(),
                                       np.asarray(jc[n]), **TOL)
    # a Python int is the same scalar position as a 0-d tensor
    c1 = tf.init_cache(cfg, 2, 8)
    c2 = tf.init_cache(cfg, 2, 8)
    tok = torch.tensor([3, 4])
    a, _ = tf.decode_step(cfg, params, c1, 5, tok)
    b, _ = tf.decode_step(cfg, params, c2, torch.tensor(5), tok)
    assert torch.equal(a, b) and torch.equal(c1[0]["k"], c2[0]["k"])


def test_decode_bundle_matches_jax(gemma):
    """``decode_32k`` REDUCED through both bundles: the batch (a zero cache
    at seq_len, pos = seq_len - 1, the last tokens) and the step."""
    j_cfg, cfg, j_params, params = gemma
    for shape in ("decode_32k", "long_500k"):
        j_b = j_steps.build_bundle(j_get_arch("gemma3_12b"), shape,
                                   reduced=True)
        b = steps.build_bundle(get_arch("gemma3_12b"), shape, reduced=True,
                               device="cpu")
        assert b.step_kind == j_b.step_kind == "decode"
        j_batch, batch = j_b.make_batch(4), b.make_batch(4)
        np.testing.assert_array_equal(batch["last_token"].numpy(),
                                      np.asarray(j_batch["last_token"]))
        assert int(batch["pos"]) == int(j_batch["pos"]) == 31
        assert batch["pos"].dim() == 0
        assert batch["cache"][0]["k"].shape == j_batch["cache"][0]["k"].shape
        want, _ = jax.jit(j_b.fn)(j_params, j_batch)
        got, _ = b.fn(b.make_state(params), batch)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    train = steps.build_bundle(get_arch("gemma3_12b"), "train_4k",
                               reduced=True, device="cpu")
    assert train.step_kind == j_steps.build_bundle(
        j_get_arch("gemma3_12b"), "train_4k", reduced=True).step_kind


def _requests(cls, vocab, n=5, new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 3 + i % 3).astype(
        np.int32), max_new_tokens=new - i % 2) for i in range(n)]


def test_server_tokens_equal_the_jax_servers(gemma):
    """Five requests over two slots (so slots are recycled mid-run), then
    the first prompt served alone: the same greedy tokens in both
    packages, and the same continuation alone as in the batch."""
    j_cfg, cfg, j_params, params = gemma
    j_srv = JServer(j_cfg, j_params, batch_slots=2, max_len=24)
    srv = Server(cfg, params, batch_slots=2, max_len=24)
    j_reqs, reqs = _requests(JRequest, cfg.vocab), _requests(Request,
                                                              cfg.vocab)
    for jr, r in zip(j_reqs, reqs):
        j_srv.submit(jr)
        srv.submit(r)
    j_done = j_srv.run_until_drained(max_steps=200)
    done = srv.run_until_drained(max_steps=200)
    assert [r.rid for r in done] == [r.rid for r in j_done]
    for r, jr in zip(reqs, j_reqs):
        assert r.done and len(r.out) == r.max_new_tokens
        assert r.out == jr.out, (r.rid, r.out, jr.out)
    np.testing.assert_array_equal(srv.pos, j_srv.pos)
    prompts = sum(len(r.prompt) for r in reqs)
    assert srv.decode_steps > prompts
    alone = Server(cfg, params, batch_slots=2, max_len=24)
    again = Request(rid=9, prompt=reqs[0].prompt,
                    max_new_tokens=reqs[0].max_new_tokens)
    alone.submit(again)
    alone.run_until_drained(max_steps=200)
    assert again.out == reqs[0].out


def test_server_stops_a_request_at_the_cache_end(gemma):
    """A request reaching max_len - 1 finishes early, as in JAX."""
    j_cfg, cfg, j_params, params = gemma
    outs = []
    for srv_cls, req_cls, p in ((JServer, JRequest, j_params),
                                (Server, Request, params)):
        srv = srv_cls(cfg if srv_cls is Server else j_cfg, p,
                      batch_slots=2, max_len=10)
        r = req_cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=50)
        srv.submit(r)
        srv.run_until_drained(max_steps=100)
        outs.append(r.out)
    assert outs[0] == outs[1] and 0 < len(outs[1]) < 50


def test_serve_launcher_prints_the_jax_run_line(gemma, monkeypatch, capsys):
    """Both launchers on gemma3 REDUCED from the JAX package's seed-0
    weights (the port's drawn from them for the comparison): the same
    requests and tokens in the run line, and the port's tokens are the
    JAX ``Server``'s on the launcher's prompts."""
    j_cfg, cfg, j_params, params = gemma
    monkeypatch.setattr(tf, "init_params", lambda c, gen: params)
    argv = ["--arch", "gemma3_12b", "--reduced", "--requests", "5",
            "--slots", "2", "--max-len", "32", "--max-new-tokens", "4"]
    seen = {}
    assert serve_launcher.main(argv + ["--device", "cpu"], on_done=lambda
                               s, d, t: seen.update(done=d, steps=s.decode_steps
                                                    )) == 0
    mine = capsys.readouterr().out.strip().splitlines()
    j_done = []

    class Recording(JServer):
        def run_until_drained(self, *a, **kw):
            j_done.extend(super().run_until_drained(*a, **kw))
            return j_done

    monkeypatch.setattr(j_serve_launcher, "Server", Recording)
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    j_serve_launcher.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    assert len(mine) == len(theirs) == 1
    assert mine[0].split(",")[:2] == theirs[0].split(",")[:2] == [
        "5 requests", " 20 tokens"]
    assert mine[0].endswith("tok/s)")
    assert {r.rid: r.out for r in seen["done"]} == {
        r.rid: r.out for r in j_done}
    assert seen["steps"] > 5 * 6
