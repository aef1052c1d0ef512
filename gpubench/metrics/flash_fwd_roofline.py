"""flash_fwd_roofline: the least time the causal attention of the traced
slice's prefilled prompts could take (their unpadded QK^T and PV
operations over the bf16 peak, or their Q, K, V and output bytes over the
HBM peak, whichever is larger), as a share of the device time of the
forward kernels in the trace, in %."""

from gpubench import flops, trace, work

KERNELS = ("flash_fwd_tc_kernel", "flash_fwd_kernel")


def read(records):
    if "steps" not in records:
        return None
    spent = trace.kernel_seconds(records["trace"], KERNELS)
    spec = records["spec"]
    prompts = work.tally(work.slice_steps(records))["prompts"]
    if not spent or not prompts:
        return None
    ops = sum(flops.attn_flops(spec, flops.causal_pairs(p)) for p in prompts)
    nbytes = sum(2 * p * (2 * spec.q_dim + 2 * spec.kv_dim) * spec.n_layers
                 for p in prompts)
    need = max(ops / flops.PEAK_FLOPS, nbytes / flops.PEAK_BYTES)
    return 100.0 * need / spent
