"""``repro_torch.models``: the port of the JAX package's LM stack
(``repro/models``), dense, MoE and SSM families: layers, attention, the
Mixture-of-Experts FFN, the Mamba-2 SSD layer, the decoder stack and the
model facade, serving with every projection of ``layers.PROJ_NAMES`` on
the integer MVU kernels (``core/mvu.py::quantized_linear``) under the
``mvu_*`` backends (a MoE block's router and experts and an SSM block's
projections stay float, as in the reference).
"""
