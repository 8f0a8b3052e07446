"""Sum of the frozen bounds over the device time of the
``ops.flash_attention`` calls of the profiled rounds (the recovery's
fresh layers and its selective recompute, each run twice where the
program first meets a shape), in %: the kernels launched inside the
wrapper's range, and the port's prefill kernels (``flash_prefill_kernel``,
``flash_prefill_capped_kernel``), whose launches the profiler cannot link
to a range."""

OP = "ops.flash_attention"
KERNELS = ("flash_prefill_kernel<", "flash_prefill_capped_kernel<")


def read(run):
    p = run.profile
    if not p:
        return None
    t = p["range_device_s"].get(OP, 0.0) + sum(
        v for k, v in p["unlinked_by_kernel"].items()
        if any(n in k for n in KERNELS))
    b = run.bounds.get(OP[4:], 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None
