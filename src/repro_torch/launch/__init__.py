"""``repro_torch.launch``: the port of the JAX package's ``repro.launch``.

Ported so far:

* :mod:`repro_torch.launch.serve` -- ``serve_loop`` and its ``Request``,
  the LM's batched prefill-and-decode loop over
  :mod:`repro_torch.models`, dense, MoE and SSM decoders (integer-deployed
  attention and FFN projections on the hand MVU kernels, a MoE block's
  experts and an SSM block's projections float); ``EngineServer``, the deprecated request-coalescing shim
  over :class:`repro_torch.serving.ContinuousBatcher`, and its
  ``EngineRequest``;
* :mod:`repro_torch.launch.nid_qat` -- the paper's Section 6.5 flow (the
  float MLP trained with a straight-through estimator, streamlined by the
  build into the integer MVU chain and run on the hand-written kernels),
  the counterpart of the JAX package's ``benchmarks/nid_mlp.py``;
* :mod:`repro_torch.launch.train` -- ``make_train_step``, one AdamW
  training step of the LM (``Model.loss``, its gradients, ``adamw.update``;
  a MoE model's loss adds its load-balancing term).

Not ported yet (ROADMAP queue A item 7): the rest of ``train.py``
(``shard_train_step``, ``init_sharded``, ``train_loop``, ``main``) and
``mesh.py`` wait for the training loop with its mesh (step 3c);
``shard_serve_fns`` (``serve.py``) and ``dryrun.py`` for step 5.
"""
