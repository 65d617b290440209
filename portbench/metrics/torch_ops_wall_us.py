"""``torch_ops_wall_us``: device microseconds a replayed tick spends in
the segments of PyTorch's own operations (the clock reads, the transfer
meters' adds, the GCS copy, the job window, the window's gathers, the
plan's apply), stamp to stamp, over every window call's traced loop.
Less ``other_ops_us``, it is the idle inside them."""

from portbench import ticktrace


def read(run):
    return ticktrace.segments_us(run, ticktrace.TORCH_OPS)
