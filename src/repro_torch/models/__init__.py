"""``repro_torch.models``: the port of the JAX package's LM stack
(``repro/models``), dense and MoE families: layers, attention, the
Mixture-of-Experts FFN, the decoder stack and the model facade, serving
with every projection on the integer MVU kernels
(``core/mvu.py::quantized_linear``) under the ``mvu_*`` backends (a MoE
block's router and experts stay float, as in the reference).
"""
