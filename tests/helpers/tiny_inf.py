"""Operands with a value below 2^-136 against +-inf in one product, for the
split-TF32 kernels (A2 and A4's f32 route) and their emulations: TF32
truncates such a value to 0, so its hi is ``copysign(2^-136, v)``
(``repro_torch.kernels.tf32``) and the product reads +-inf, as in f32.
Torch only: the card tests import it too."""

import torch

TINY = 2.0 ** -140


def plant_spmm(blocks: torch.Tensor, x: torch.Tensor, where: str,
               sign: float) -> None:
    """In place: tile 0's entry (7, 9), which meets x's row 9, is 2^-140 and
    ``x[9, 0]`` is ``sign`` inf (``where="x"``: inf in x), or the other way
    round (``where="tiles"``)."""
    inf, tiny = sign * float("inf"), TINY
    if where == "x":
        blocks[0, 7, 9], x[9, 0] = tiny, inf
    else:
        blocks[0, 7, 9], x[9, 0] = inf, tiny


# the A4 cases: b 1, 2 q heads on 1 kv head, 200 positions, Dh 64, causal
A4_SHAPE = (1, 2, 1, 200, 64)
P_LOG2 = -140.0          # the log2 of key 70's p in case "p"


def plant_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    case: str, sign: float) -> None:
    """In place, on q (1, 2, 200, 64) and k, v (1, 1, 200, 64):

    - ``"q"``: every q's column 5 is ``sign`` 2^-140 and key 70's is
      ``-sign`` inf: its score is -inf, so the rows that see it drop it;
    - ``"k"``: every key's column 5 is ``sign`` 2^-140 and row 100's q is
      ``-sign`` inf there: every score of that row is -inf, a NaN row;
    - ``"p"``: q is (1, 0, ...), every key's column 0 is 0 but key 30's,
      which makes its p 2^-140 in every row from 30 on, where its v's
      column 3, ``sign`` inf, makes the output's column 3 +-inf.  (The
      rows before it read NaN there, 0 * inf, in the kernel and in the
      plain version: key 30 lies in the first kv tile, which every q tile
      visits.)
    """
    inf = float("inf")
    if case == "q":
        q[..., 5] = sign * TINY
        k[0, 0, 70, 5] = -sign * inf
    elif case == "k":
        k[..., 5] = sign * TINY
        q[0, :, 100, 5] = -sign * inf
    else:
        dh = q.shape[-1]
        q.zero_()
        q[..., 0] = 1.0
        k[..., 0] = 0.0
        # score * dh^-0.5 * log2(e) = P_LOG2: p = 2^-140 against the rest's 1
        k[0, 0, 30, 0] = P_LOG2 / (dh ** -0.5 * 1.4426950408889634)
        v[0, 0, 30, 3] = sign * inf
