"""The deformation MLP of 4D-GS: % of its GEMMs' device time that the
least time for the traced steps' MLP FLOPs takes (`counts_hexplane.
mlp_flops`: 93,568 multiply-adds a Gaussian-view forward, twice that
backward, at the float32 peak). None in a cell whose census is not
4D-GS's.

The kernels are found by name (RULE, a regular expression on the trace's
kernel names, any case): `gemm` and `gemv` (the cuBLAS and CUTLASS kernels
that F.linear's products and its gradients run on: sm80_xmma_gemm_*,
cutlass_80_simt_sgemm_*, gemv2T_kernel_val, gemvx::kernel on an H100 with
torch 2.11, the opacity head's one output going to gemv), `splitKreduce`
(cuBLAS's split-K sum, part of the weights' gradient products over every
Gaussian), and `deform_mlp` (a later kernel of the port's MLP). In the
traced steps of n3v_hexplane.train they are the MLP's and nothing else;
n3v_4dgs.train's trace holds no kernel the rule matches (its projection's
small products go elsewhere), so the rule reads only the MLP."""
import re

from gsbench import counts, counts_hexplane

RULE = re.compile(r"gemm|gemv|splitKreduce|deform_mlp", re.IGNORECASE)


def read(run):
    prof = run.get("profile")
    if not prof or "deformed" not in run["work"]()[0]:
        return None
    seconds = sum(v for k, v in prof["by_op"].items() if RULE.search(k))
    if not seconds:
        return None
    flops = sum(counts_hexplane.mlp_flops(w) for w in run["work"]())
    return 100.0 * counts.least_seconds(flops, 0) / seconds
