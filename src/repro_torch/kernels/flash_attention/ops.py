"""Public attention entry point — the port of
``repro.kernels.flash_attention.ops``.

Unlike the JAX dispatcher, which quietly sends odd shapes and ``Sq == 1``
to the oracle, ``attention`` sends every call with ``use_kernel=True`` to
the kernel wrapper: on a CUDA tensor that launches A4 or raises.
``use_kernel=False`` is the explicit plain path.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import (check_shapes,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              use_kernel: bool = True):
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh).  The operands are made
    contiguous (a layout copy where they are views) for the kernel."""
    if not use_kernel:
        check_shapes(q, k, v)
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)
