"""The MVU system: IR, lowering, quantization, dataflow and the fused engine."""
