"""Adam with the reference math, SGD, LR decay."""
