"""One training step; the port of ``make_train_step`` from the JAX
package's ``repro/launch/train.py``.

``make_train_step(model, opt_cfg)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``: ``Model.loss``, its
gradients by ``torch.autograd.grad`` over every parameter leaf, then
``adamw.update`` under ``torch.no_grad()``.  The step is functional, as
the reference's: it returns new trees and leaves its arguments as they
were (the reference's ``donate_argnums`` lets XLA reuse their buffers;
here the caller drops its references instead).  Every metric is a device
tensor, so a step ends without a host sync unless the caller reads one.

The rest of the reference module waits for the mesh and the sharding
(ROADMAP queue A item 7, step 3c): ``shard_train_step``,
``init_sharded``, ``train_loop`` and ``main``, with ``launch/mesh.py``
and ``distributed/sharding.py``.
"""

from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.tree import flat_leaves, tree_map


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    def train_step(params, opt_state, batch):
        # detached aliases that require grad: the caller's tensors keep their flags
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, list(flat_leaves(params).values())))
        grads = tree_map(lambda _: next(grads), params)  # flat_leaves' order
        with torch.no_grad():
            params, opt_state, opt_metrics = adamw.update(opt_cfg, params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **opt_metrics}

    return train_step
