"""Peak of the device memory PyTorch allocated during the window
(``torch.cuda.max_memory_allocated``, reset after the warm-up)."""


def read(run):
    return run["peak_device_bytes"] or None
