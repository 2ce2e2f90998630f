"""``repro_torch.checkpoint``: the port of the JAX package's
``repro.checkpoint`` (:mod:`repro_torch.checkpoint.ckpt`)."""
