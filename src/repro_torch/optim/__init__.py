"""``repro_torch.optim``: the port of the JAX package's ``repro.optim``.

Ported: :mod:`repro_torch.optim.adamw` (AdamW with the warmup-cosine
schedule and global-norm clipping).  Not ported yet: ``grad_compress.py``,
the data-parallel gradient all-reduce, which comes with the mesh and the
sharding (ROADMAP queue A item 7, step 3c): at one device it is the
identity.
"""
