"""Kernel A4 of the port on the CPU: its plain torch version
(``attention_ref``, and ``ops.attention(use_kernel=False)``) against the
JAX package's Pallas ``flash_attention`` (interpret mode) and its
``attention_ref``, and the wrappers' dispatch and checks.  The CUDA kernel
itself is held to the plain version on the card by
tests/test_torch_cuda.py."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.kernel import (_ROUTES, MAX_Q_TILES,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as t_attention_ref

torch.set_num_threads(1)

# one compile per case instead of one per primitive of the eager oracle
j_attention_ref = jax.jit(attention_ref, static_argnames=("causal", "window"))

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, hq, hkv, sq, skv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32))


def _tolerance(dtype, v):
    """f32: both sides compute in f32, in another order: 1e-5.

    bf16: the Pallas kernel rounds p to bf16 before the PV product
    (relative error <= 2^-9 per term, and the p / l sum to 1, so at most
    2^-9 * max|v| in the output), and each side rounds its f32 output to
    bf16 once (together at most one bf16 ulp, <= 2^-7 relative).  The
    bound is atol = 2^-9 * max|v| and rtol = 2^-6 (twice the ulp)."""
    if dtype == "float32":
        return {"atol": 1e-5, "rtol": 1e-5}
    return {"atol": 2.0 ** -9 * float(np.abs(v).max()), "rtol": 2.0 ** -6}


def _port(q, k, v, dtype, **mask):
    t = [torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v)]
    ref = t_attention_ref(*t, **mask)
    plain = ops.attention(*t, use_kernel=False, **mask)
    assert torch.equal(ref, plain)
    return ref.float().numpy()


def _jax(fn, q, k, v, dtype, **kw):
    j = [jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)]
    return np.asarray(fn(*j, **kw), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 4), (True, 16),
                                           (False, 0)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_attention_plain_vs_jax_flash_and_ref(dtype, causal, window, group):
    """Sq = Skv = 32 in 8-row blocks, so the Pallas kernel's online
    softmax runs over four kv blocks per q block."""
    q, k, v = _inputs(group * 100 + window, 2, 2 * group, 2, 32, 32, 32)
    mask = {"causal": causal, "window": window}
    if dtype == "bfloat16":       # the inputs both sides see
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    got = _port(q, k, v, dtype, **mask)
    tol = _tolerance(dtype, v)
    flash = _jax(j_flash_attention, q, k, v, dtype, block_q=8, block_k=8,
                 interpret=True, **mask)
    np.testing.assert_allclose(got, flash, **tol)
    ref = _jax(j_attention_ref, q, k, v, dtype, **mask)
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (100, 100, True, 0), (37, 37, True, 16), (200, 200, True, 64),
    (50, 77, False, 0), (129, 130, False, 8),
    (10, 3, True, 2)])            # rows 4.. see no key: zeros
def test_attention_plain_vs_jax_ref_unaligned(sq, skv, causal, window):
    """Lengths that are no multiple of 128, where the Pallas kernel
    asserts; the JAX oracle alone is the reference."""
    q, k, v = _inputs(sq + skv, 1, 4, 2, sq, skv, 16)
    mask = {"causal": causal, "window": window}
    got = _port(q, k, v, "float32", **mask)
    want = _jax(j_attention_ref, q, k, v, "float32", **mask)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if (sq, skv) == (10, 3):
        assert not got[:, :, 4:].any() and got[:, :, :4].any()


def _counts():
    return (flash_attention.launches, flash_attention.launches_bf16,
            flash_attention.launches_f32)


def test_attention_on_the_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, 1, 4, 2, 24, 24, 32))
    before = _counts()
    got = ops.attention(q, k, v, causal=True, window=8)
    assert _counts() == before                      # no kernel on the CPU
    assert torch.equal(got, t_attention_ref(q, k, v, causal=True,
                                           window=8))
    assert got.dtype == q.dtype and got.shape == q.shape


@pytest.mark.parametrize("use_kernel", [True, False])
def test_attention_refuses_mismatched_shapes(use_kernel):
    q = torch.zeros((1, 3, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.attention(q, kv, kv, use_kernel=use_kernel)
    with pytest.raises(ValueError, match="head width"):
        ops.attention(torch.zeros((1, 2, 8, 8)), kv, kv,
                      use_kernel=use_kernel)
    with pytest.raises(ValueError, match=r"\(B, Hq, Sq, Dh\)"):
        ops.attention(q[0], kv, kv, use_kernel=use_kernel)


@pytest.mark.parametrize("dtype,entry,rows", [
    (torch.bfloat16, "attn_flash_fwd_bf16", 128),
    (torch.float32, "attn_flash_fwd_f32", 64)])
def test_flash_attention_routes_by_dtype(dtype, entry, rows):
    """Each dtype has one C entry point (bf16: the wgmma kernel on q, k,
    v, o; f32: the split-TF32 wgmma kernel on q, the pre-pass's k_hi, k_lo,
    vt and vt_lo, and o, with Skv_pad among the sizes), and its own q-tile
    height in the Sq limit; checked on the meta device, where no kernel
    launches."""
    assert _ROUTES[dtype] == (entry, rows)
    ptr, size = ctypes.c_void_p, ctypes.c_longlong
    flags = [ctypes.c_int, size, ctypes.c_float]
    want = {"attn_flash_fwd_bf16": [ptr] * 4 + [size] * 6 + flags + [ptr],
            "attn_flash_fwd_f32": [ptr] * 6 + [size] * 7 + flags + [ptr]}
    assert _build._SIGNATURES[entry] == want[entry]
    limit = rows * MAX_Q_TILES

    def call(sq):
        q = torch.empty((1, 2, sq, 32), dtype=dtype, device="meta")
        kv = torch.empty((1, 1, 8, 32), dtype=dtype, device="meta")
        return flash_attention(q, kv, kv)

    before = _counts()
    with pytest.raises(ValueError, match=f"Sq <= {limit} "):
        call(limit + 1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(limit)
    assert _counts() == before


def test_flash_attention_takes_no_other_dtype():
    q = torch.empty((1, 2, 8, 32), dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        flash_attention(q, q, q)
