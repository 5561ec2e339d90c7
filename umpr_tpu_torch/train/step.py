"""Train and eval steps (port of umpr_tpu/train/step.py, single-step path).

Both run at the batch's runtime maxima: no ``pad_maxima`` in the batch, so
a statically padded batch trains and scores like the reference's
dynamically padded one (serving pins the full padding instead).  Dead rows
of a final partial batch (``sample_mask`` 0) reach neither the loss, its
gradient nor ``n_real``.  Neither step reads a value back to the host.
Dropout (full UMPR's VGG classifier) runs in the train step when it is
given a generator, and never in the eval step.
"""

from __future__ import annotations

import torch

from umpr_tpu_torch.models.umpr import masked_sq_sum


def train_step(model, opt, batch, lr, dropout_generator=None):
    """One Adam step at learning rate `lr` -> (loss, n_real), 0-d device
    tensors: the batch's loss before the step (masked-mean MSE, plus
    loss_v_rate * loss_v for full UMPR) and its count of real samples.
    dropout_generator: a torch.Generator on the model's device for the
    dropout masks; None turns dropout off."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    _, loss, _ = model(batch, dropout_generator)
    loss.backward()
    opt.step()
    return loss.detach(), batch["sample_mask"].sum()


@torch.no_grad()
def eval_step(model, batch):
    """-> (sum of squared errors over real samples, their count)."""
    pred, _, _ = model(batch)
    mask = batch["sample_mask"]
    return masked_sq_sum(pred, batch["ratings"], mask), mask.sum()


def mse_from_parts(parts):
    """(sq_sum, n) pairs -> dataset MSE = total squared error / sample
    count, summed on the host in batch order in float64 (the reference's
    evaluate_mse, src/evaluate.py:6-14); nan for an empty split.  One
    device->host copy for all parts."""
    parts = list(parts)
    if not parts:
        return float("nan")
    flat = torch.stack([torch.stack([sq, n]) for sq, n in parts]).cpu()
    total, count = 0.0, 0.0
    for sq, n in flat.tolist():
        total += sq
        count += n
    return total / count if count else float("nan")


def evaluate_mse(model, batches):
    """Dataset MSE over a stream of device batches, one eval_step each."""
    return mse_from_parts(eval_step(model, b) for b in batches)
