"""Models: GraphBatch and GCN (port of dorylus_tpu/models)."""
