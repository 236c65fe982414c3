"""engine_build_s (op build layer, host clock): Graph.finalize (the host
sort and the GCN norms) and Engine(...) (the hyb plans both ways, the batch,
the model), synchronised. Moves setup_s."""


def read(ctx):
    return ctx.clock["engine_build_s"]
