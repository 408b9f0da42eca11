"""The port's kernels by their CUDA names, as the device trace shows them
(each .cu file keeps its kernels in an anonymous namespace), and the
library's matrix products by cuBLAS's and CUTLASS's names."""

from __future__ import annotations

import re

FUSED_TRAIN = ("tn_gemm_kernel", "mn_wgrad_kernel", "scene_rows_kernel",
               "layer0_kernel", "final_kernel", "reduce_kernel",
               "dz_kernel", "dwz_kernel")                 # csrc/fused_train.cu
RELU_DROPOUT = ("drop_rows_kernel", "drop_tile_kernel",
                "bwd_out_rows_kernel", "bwd_out_tile_kernel",
                "colsum_reduce_kernel")                    # csrc/relu_dropout.cu
FUSED_EVAL = ("fused_eval_kernel",)                        # csrc/fused_eval.cu

_LIBRARY_GEMM = re.compile(r"gemm|nvjet|cutlass|xmma", re.IGNORECASE)


def of(names: tuple):
    """A matcher for the port's kernels named in `names`."""
    pat = re.compile(r"anonymous namespace\)::(%s)\b" % "|".join(names))
    return lambda n: bool(pat.search(n))


def library_gemm(name: str) -> bool:
    """A matrix product of cuBLAS or CUTLASS (not one of the port's)."""
    return bool(_LIBRARY_GEMM.search(name)) and "anonymous namespace" \
        not in name
