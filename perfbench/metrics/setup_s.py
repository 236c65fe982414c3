"""setup_s (end to end, host clock): from the process's start to the
window's: imports, the inputs, the graph's finalize, the engine's build, the
eager first epoch, the capture of the epoch graphs and the checked steps."""


def read(ctx):
    return ctx.clock["setup_s"]
