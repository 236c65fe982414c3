"""capture_s (group loop and epoch graphs, host clock): the first run() of
one epoch: the eager first epoch and eval, and the capture of the train and
eval epochs as CUDA graphs, synchronised. Moves setup_s."""


def read(ctx):
    return ctx.clock["capture_s"]
