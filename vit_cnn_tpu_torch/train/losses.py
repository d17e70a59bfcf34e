"""Loss functions of the ported models' train routes.

Port of :func:`vit_cnn_tpu.train.losses.weighted_cross_entropy`,
``ce_first_output`` and ``glt_loss``: torch.nn.CrossEntropyLoss(weight=w)
semantics with a per-sample ``valid`` mask, so a padded last batch leaves
the cross-entropy as it is. The CNN zoo's losses (cross_fusion, endnet,
focal) come with the models that use them (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """sum_i w[y_i] * valid_i * nll_i / max(sum_i w[y_i] * valid_i, 1e-12)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[:, None])[:, 0]
    w = (class_weights[targets.long()] if class_weights is not None
         else torch.ones_like(nll))
    if valid is not None:
        w = w * valid
    return (w * nll).sum() / w.sum().clamp_min(1e-12)


def ce_first_output(output, targets, class_weights=None, valid=None):
    """CE on output[0] when a model returns (logits, *aux)."""
    logits = output[0] if isinstance(output, tuple) else output
    return weighted_cross_entropy(logits, targets, class_weights, valid)


def glt_loss(output, targets, class_weights=None, valid=None):
    """GLT_Net's (logits, con_loss): the weighted cross-entropy of the
    logits plus the in-model reconstruction loss (ref: GLT_Net.py:417-422).
    ``valid`` masks the cross-entropy only: con_loss is the model's mean
    over the whole batch, padded rows included, as in the JAX package."""
    logits, con_loss = output
    return (weighted_cross_entropy(logits, targets, class_weights, valid)
            + con_loss)


LOSSES = {"cross_entropy": ce_first_output, "glt": glt_loss}
