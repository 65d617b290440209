"""``peak_device_gb``: ``torch.cuda.max_memory_allocated()`` over the
window (reset at its start), in GB."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 1e9
