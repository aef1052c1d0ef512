"""paged_decode_roofline: the least time decode attention could take for
the traced slice's decoded tokens (the larger of their K/V and query
bytes over the HBM peak and their QK^T and PV operations over the bf16
peak), as a share of the device time of the paged kernels in the trace,
in %."""

from gpubench import flops, trace, work

KERNELS = ("paged_decode_split_kernel", "paged_decode_combine_kernel")


def read(records):
    if "steps" not in records:
        return None
    spent = trace.kernel_seconds(records["trace"], KERNELS)
    spec = records["spec"]
    ctx = work.tally(work.slice_steps(records))["contexts"]
    if not spent or not ctx:
        return None
    need = max(sum(flops.paged_decode_bytes(spec, c) for c in ctx)
               / flops.PEAK_BYTES,
               sum(flops.attn_flops(spec, c) for c in ctx)
               / flops.PEAK_FLOPS)
    return 100.0 * need / spent
