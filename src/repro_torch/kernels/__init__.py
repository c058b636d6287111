"""Hand-written Hopper kernels of the port's compute hot spots.

Each kernel's CUDA C++ source lives in ``repro_torch/csrc/`` and is built
by ``_build.py`` on first use.  Beside every kernel wrapper sits its plain
torch version: the wrapper runs it for CPU tensors (the tests), and on a
CUDA tensor launches the kernel or raises.  Every wrapper counts its
launches in an integer attribute, ``<wrapper>.launches``.

  A1 ``fold_update.fold_update``       — fused dense-tail owner update
  A2 ``bsr_spmm.kernel.bsr_spmm``      — block-sparse frontier expansion
  A3 ``bsr_spmm.kernel.bitpack_words`` — candidate mask -> packed words
  A4 ``flash_attention.kernel.flash_attention`` — causal/windowed GQA
     attention forward (the LM prefill)
  A5 ``embedding_bag.kernel.embedding_bag_sum`` — sum-mode EmbeddingBag
     (the recsys lookup op)

and one with no TPU counterpart:

  ``expand_dense.expand_dense`` — the 1-D dense level's edge-list
     expansion straight to the packed wire's words (the default engine's)
"""
