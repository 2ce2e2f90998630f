"""``repro_torch.launch``: the port of the JAX package's ``repro.launch``.

Ported so far:

* :mod:`repro_torch.launch.serve` -- ``EngineServer``, the deprecated
  request-coalescing shim over :class:`repro_torch.serving.ContinuousBatcher`,
  and its ``EngineRequest``;
* :mod:`repro_torch.launch.nid_qat` -- the paper's Section 6.5 flow (the
  float MLP trained with a straight-through estimator, streamlined by the
  build into the integer MVU chain and run on the hand-written kernels),
  the counterpart of the JAX package's ``benchmarks/nid_mlp.py``.

Not ported yet: ``shard_serve_fns`` and ``serve_loop`` (``serve.py``),
``mesh.py``, ``dryrun.py``, ``train.py`` and the LM serving loop wait for
the LM stack and its sharding (ROADMAP queue A item 7, step 3).
"""
