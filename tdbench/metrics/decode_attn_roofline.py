"""Sum of the frozen bounds over the device time of the
``ops.flash_decode_paged`` calls of the profiled rounds, in %: the
kernels launched inside the wrapper's range, and the port's paged decode
kernel (``flash_decode_paged_kernel``), whose launches the profiler
cannot link to a range."""

OP = "ops.flash_decode_paged"
KERNEL = "flash_decode_paged_kernel"


def read(run):
    p = run.profile
    if not p:
        return None
    t = p["range_device_s"].get(OP, 0.0) + sum(
        v for k, v in p["unlinked_by_kernel"].items() if KERNEL in k)
    b = run.bounds.get(OP[4:], 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None
