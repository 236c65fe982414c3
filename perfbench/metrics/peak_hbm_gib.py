"""peak_hbm_gib (end to end): torch.cuda.max_memory_allocated() over the
program's whole run, set-up included, read once the window has closed and
before the reference runs (the peak is reset after the benchmark's own
inputs are made and freed)."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30
