"""The f32 route of kernel A4 on the CPU: the emulation of its split-TF32
arithmetic (``ref.attention_split_ref``: the kernel's 64-row q tiles and
64-key kv tiles in its order, two consumers' online softmax and their
merge, three TF32 products per 32-column panel joined in IEEE f32, P split
before PV) against the JAX package's f32 oracle, one pass of TF32 against
the same hold, and the plain version of the route's pre-pass
(``ref.split_kv_ref``).  The kernel itself is held to the plain version on
the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention.kernel import split_kv
from repro_torch.kernels.flash_attention.ref import (KEY_ORDER, KEY_PAD,
                                                   attention_mask,
                                                   attention_split_ref,
                                                   key_positions,
                                                   split_kv_ref)
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as t_attention_ref
from repro_torch.kernels.tf32 import tf32_rna, tf32_trunc

torch.set_num_threads(1)

j_attention_ref = jax.jit(attention_ref, static_argnames=("causal", "window"))

# the f32 hold of the card tests and chip_smoke.py: 2e-5 elementwise
# (atol and rtol) and 2e-5 relative L2 a (batch, head) slice
F32_TOL = 2e-5

# dh, b, hq, hkv, sq, skv, causal, window
CASES = [
    (32, 1, 2, 2, 1, 1, True, 0),
    (64, 2, 4, 2, 63, 63, True, 0),
    (128, 1, 8, 1, 65, 65, True, 2),         # a window inside a kv tile
    (256, 1, 2, 1, 200, 200, True, 33),
    (128, 2, 4, 2, 100, 150, False, 0),      # non-causal, Skv > Sq
    (64, 1, 2, 2, 1, 130, False, 0),
    (32, 1, 8, 1, 10, 3, True, 2),           # rows 4..: no key
    (256, 1, 2, 1, 300, 3, True, 2),         # whole q tiles see no key
    (64, 2, 8, 2, 130, 130, True, 33),
    (128, 1, 4, 4, 257, 257, True, 100),     # windows across tiles
]


def _inputs(case):
    dh, b, hq, hkv, sq, skv, _, _ = case
    rng = np.random.default_rng(sum(case[:6]))
    return (rng.standard_normal((b, hq, sq, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32))


def _jax_ref(q, k, v, causal, window):
    return np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window))


def _hold(got, want):
    """(elementwise within 2e-5, the largest relative L2 a head)."""
    ok = bool(np.all(np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)))
    diff = np.linalg.norm((got - want).reshape(*got.shape[:2], -1), axis=-1)
    norm = np.linalg.norm(want.reshape(*want.shape[:2], -1), axis=-1)
    return ok, float(np.max(diff / np.maximum(norm, 1e-30)))


@pytest.mark.parametrize("case", CASES)
def test_split_emulation_holds_f32_against_jax(case):
    """Three TF32 products a product, joined per panel in IEEE f32, stay
    within the f32 hold of JAX's oracle; rows that see no key are exact
    zeros."""
    *_, sq, skv, causal, window = case
    q, k, v = _inputs(case)
    got = attention_split_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window).numpy()
    want = _jax_ref(q, k, v, causal, window)
    ok, head = _hold(got, want)
    assert ok and head <= F32_TOL, head
    dead = ~attention_mask(sq, skv, causal=causal, window=window,
                           device="cpu").any(dim=-1).numpy()
    assert not got[:, :, dead].any() and not want[:, :, dead].any()


@pytest.mark.parametrize("case", CASES)
def test_one_pass_tf32_breaks_the_f32_hold(case):
    """The same schedule with one TF32 product (hi hi) misses the hold at
    every case: the split is what keeps f32 accuracy."""
    _, _, _, _, _, _, causal, window = case
    q, k, v = _inputs(case)
    got = attention_split_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window,
                              products=1).numpy()
    ok, head = _hold(got, _jax_ref(q, k, v, causal, window))
    assert not ok and head > F32_TOL, head


def test_split_emulation_makes_nan_rows_as_the_plain_version():
    """A NaN key makes NaN exactly the rows that see it (the row max
    propagates NaN, as the plain version's amax does)."""
    q, k, v = (torch.from_numpy(x) for x in
               _inputs((64, 1, 2, 1, 200, 200, True, 40)))
    k[0, 0, 70] = float("nan")
    got = attention_split_ref(q, k, v, causal=True, window=40)
    want = t_attention_ref(q, k, v, causal=True, window=40)
    assert torch.equal(got.isnan(), want.isnan())
    rows = got.isnan().any(dim=-1)[0, 0].nonzero().flatten().tolist()
    assert rows == list(range(70, 110))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_emulation_takes_an_infinite_key_as_the_plain_version(sign):
    """An infinite key against q exact in TF32 (upcast from bf16, so its lo
    is 0): the score is -inf where q's sign makes it so and the key drops
    out, or +inf and the row is NaN, exactly where the plain version's
    are; the finite rows hold f32.  K's hi is 0 there, so no q_lo * inf =
    0 * inf product makes a NaN the plain version does not have."""
    q, k, v = (torch.from_numpy(x) for x in
               _inputs((64, 1, 2, 1, 200, 200, True, 0)))
    q = q.to(torch.bfloat16).float()
    k[0, 0, 70, 5] = sign * float("inf")
    got = attention_split_ref(q, k, v, causal=True, window=0)
    want = t_attention_ref(q, k, v, causal=True, window=0)
    nan = want.isnan().any(dim=-1)
    assert torch.equal(got.isnan().any(dim=-1), nan)
    rows = set(nan[0, 0].nonzero().flatten().tolist())
    plus = set((torch.arange(200)[(sign * q[0, 0, :, 5] > 0)]).tolist())
    assert rows == {r for r in plus if r >= 70} and 0 < len(rows) < 130
    ok, head = _hold(got[~nan].numpy(), want[~nan].numpy())
    assert ok, head


@pytest.mark.parametrize("skv", [1, 8, 37, 64, 130])
def test_split_kv_ref_transposes_v_in_key_order(skv):
    """V^T's positions hold keys in KEY_ORDER within each group of 8; the
    inverse order gives V back, bit for bit, and positions past Skv are
    zero in hi and lo."""
    rng = np.random.default_rng(skv)
    k, v = (torch.from_numpy(rng.standard_normal((2, 3, skv, 32))
                             .astype(np.float32)) for _ in range(2))
    k_hi, k_lo, vt, vt_lo = split_kv_ref(k, v)
    pad = -(-skv // KEY_PAD) * KEY_PAD
    assert k_hi.shape == k_lo.shape == k.shape and torch.equal(k_hi, k)
    assert vt.shape == vt_lo.shape == (2, 3, 32, pad)
    keys = key_positions(pad)
    assert keys[:8].tolist() == list(KEY_ORDER)
    assert sorted(keys.tolist()) == list(range(pad))
    back = torch.empty_like(vt)
    back[..., keys] = vt                          # the inverse permutation
    assert torch.equal(back[..., :skv].transpose(-1, -2), v)
    assert not back[..., skv:].any() and not vt_lo[..., keys >= skv].any()


def _v_back(vt):
    """V^T (B, Hkv, Dh, Skv_pad) back to (B, Hkv, Skv_pad, Dh) in key
    order."""
    back = torch.empty_like(vt)
    back[..., key_positions(vt.shape[-1])] = vt
    return back.transpose(-1, -2)


@pytest.mark.parametrize("exact", [False, True])
def test_split_parts_rebuild_the_operand(exact):
    """hi (the f32 word as the tensor core reads it) plus the stored lo is
    v to within lo's rounding to TF32, half a TF32 ulp of v - hi, at most
    2^-22 |v|; exactly v where v - hi fits in TF32.  lo is a TF32 value."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, 64, 32)).astype(np.float32))
    if exact:                                  # v - hi has <= 11 bits
        x = tf32_trunc(x) + tf32_trunc(x * 2.0 ** -12)
    _, k_lo, _, vt_lo = split_kv_ref(x, x)
    for lo in (k_lo, _v_back(vt_lo)):
        assert torch.equal(tf32_rna(lo), lo)
        rebuilt = tf32_trunc(x).double() + lo.double()
        if exact:
            assert torch.equal(rebuilt, x.double())
        else:
            err = (rebuilt - x.double()).abs()
            assert bool((err <= 2.0 ** -22 * x.abs().double()).all())
            assert not torch.equal(rebuilt, x.double())


def test_split_kv_ref_takes_non_finite_values_as_the_kernel():
    """A non-finite k or v has hi 0 and goes to lo whole, a NaN made quiet
    (its top mantissa bit set, so TF32 truncation keeps it NaN)."""
    bad = torch.zeros((1, 1, 8, 32))
    bad[0, 0, 1, 3] = float("nan")
    bad[0, 0, 2, 5] = float("inf")
    bad[0, 0, 4, 6] = torch.tensor(0x7F800001, dtype=torch.int32).view(
        torch.float32)                         # NaN, payload in low bits
    k_hi, k_lo, vt, vt_lo = split_kv_ref(bad, bad)
    for hi, lo in ((k_hi, k_lo), (_v_back(vt), _v_back(vt_lo))):
        assert not hi.isnan().any() and not hi.isinf().any()
        assert not bool(hi[0, 0, 1, 3]) and not bool(hi[0, 0, 2, 5])
        assert bool(lo[0, 0, 1, 3].isnan()) and lo[0, 0, 2, 5] == float("inf")
        assert bool(tf32_trunc(lo[0, 0, 4, 6]).isnan())


def test_split_kv_on_the_cpu_runs_the_plain_version():
    rng = np.random.default_rng(1)
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 64))
                             .astype(np.float32)) for _ in range(2))
    before = split_kv.launches
    got = split_kv(k, v)
    assert split_kv.launches == before
    for a, b in zip(got, split_kv_ref(k, v)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"\(B, Hkv, Skv, Dh\)"):
        split_kv(k, v[:, :1])
