"""``repro_torch.models``: the port of the JAX package's LM stack
(``repro/models``), dense family: layers, attention, the decoder stack and
the model facade, serving with every projection on the integer MVU
kernels (``core/mvu.py::quantized_linear``) under the ``mvu_*`` backends.
"""
