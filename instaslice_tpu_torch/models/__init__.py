"""The TpuLM model family (inference core) and int8 weight quantization."""
