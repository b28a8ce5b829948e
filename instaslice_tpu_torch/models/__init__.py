"""The TpuLM model family, its training step, data and checkpoints, and
int8 weight quantization."""
