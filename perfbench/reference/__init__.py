"""The plain reference the benchmark holds the port against: plain PyTorch
in float32 with TF32 off, importing nothing of the program."""
