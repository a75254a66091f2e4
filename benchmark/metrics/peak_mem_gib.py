"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the window (reset
at its start), the largest over the ranks, in GiB."""


def read(run):
    if not run.on_card:
        return None
    return run.peak_bytes / 2**30
