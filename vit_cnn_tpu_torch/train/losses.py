"""Loss functions of the models' train routes.

Port of :mod:`vit_cnn_tpu.train.losses`: torch.nn.CrossEntropyLoss(
weight=w) semantics with a per-sample ``valid`` mask, so a padded last
batch leaves the loss as it is; the multi-output losses of
Cross_fusion_CNN and EndNet, ``glt`` and ``focal``.

Each is a ratio of sums. Under an engaged mesh (:mod:`..parallel.mesh`)
each rank takes its own numerator over the global denominator (summed
over the ranks), so the ranks' losses add up to the global batch's loss
and their summed gradients are its gradient; a mean over a rank's
batch becomes its share of the global mean.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import global_sum, world_size


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
    return (w * nll).sum() / global_sum(w.sum()).clamp_min(1e-12)


def ce_first_output(output, targets, class_weights=None, valid=None):
    """CE on output[0] when a model returns (logits, *aux)."""
    logits = output[0] if isinstance(output, tuple) else output
    return weighted_cross_entropy(logits, targets, class_weights, valid)


def _masked_mse(a: torch.Tensor, b: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """mean((a - b)^2) over the rows with valid 1: the sum over them
    divided by max(their count x the features, 1e-12)."""
    se = (a - b) ** 2
    if valid is None:
        return se.mean() / world_size()
    se = se.reshape(se.shape[0], -1)
    denom = (global_sum(valid.sum()) * se.shape[1]).clamp_min(1e-12)
    return (se * valid[:, None]).sum() / denom


def cross_fusion_loss(output, targets, class_weights=None, valid=None):
    """Cross_fusion_CNN's three logit sets: CE(out1) + mse(out1, out2) +
    mse(out1, out3) (ref: losses.py:13-19; the sum is not divided by 3,
    as there)."""
    out1, out2, out3 = output[:3]
    return (weighted_cross_entropy(out1, targets, class_weights, valid)
            + _masked_mse(out1, out2, valid)
            + _masked_mse(out1, out3, valid))


def endnet_loss(output, targets, class_weights=None, valid=None):
    """EndNet's (logits, recon1, recon2, input1, input2): CE(logits) +
    mse(recon1, input1) + mse(recon2, input2) (ref: losses.py:29-35)."""
    out, de_x1, de_x2, ori_x1, ori_x2 = output
    return (weighted_cross_entropy(out, targets, class_weights, valid)
            + _masked_mse(de_x1, ori_x1, valid)
            + _masked_mse(de_x2, ori_x2, valid))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 0.0, alpha: Optional[torch.Tensor] = None,
               size_average: bool = True,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-(1 - p_t)^gamma alpha[y] log p_t (ref: losses.py:38-78); the mean
    over the valid rows (floored at 1e-12), or the sum."""
    logpt = torch.log_softmax(logits, dim=-1).gather(
        -1, targets.long()[:, None])[:, 0]
    pt = logpt.exp()
    if alpha is not None:
        logpt = logpt * alpha[targets.long()]
    loss = -((1 - pt) ** gamma) * logpt
    if valid is not None:
        loss = loss * valid
        if size_average:
            return loss.sum() / global_sum(valid.sum()).clamp_min(1e-12)
        return loss.sum()
    return loss.mean() / world_size() if size_average else loss.sum()


def glt_loss(output, targets, class_weights=None, valid=None):
    """GLT_Net's (logits, con_loss): the weighted cross-entropy of the
    logits plus the in-model reconstruction loss (ref: GLT_Net.py:417-422).
    ``valid`` masks the cross-entropy only: con_loss is the model's mean
    over the whole batch, padded rows included, as in the JAX package
    (under a mesh a rank's mean is its share of the global one)."""
    logits, con_loss = output
    return (weighted_cross_entropy(logits, targets, class_weights, valid)
            + con_loss / world_size())


#: the JAX package's LOSSES; the Trainer takes all but ``focal`` (see
#: train/loop.py), which no registry model uses
LOSSES = {"cross_entropy": ce_first_output,
          "cross_fusion": cross_fusion_loss, "endnet": endnet_loss,
          "focal": focal_loss, "glt": glt_loss}
