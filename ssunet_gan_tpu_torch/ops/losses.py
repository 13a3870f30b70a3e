"""Segmentation losses on logits (NHWC), the JAX package's ops/losses.py
(reference losses.py):

- :func:`stable_bce`, :func:`bce_with_logits_loss`, :func:`soft_dice`,
  :func:`bce_dice_loss` (losses.py:130-136, 274-302; train.py:243-244);
- :func:`lovasz_hinge` / :func:`lovasz_hinge_loss` and
  :func:`lovasz_softmax` with :func:`_lovasz_grad` (losses.py:19-31,
  79-200): the errors sorted in descending order, their ReLU dotted with
  the Lovász extension's gradient; void pixels of ``ignore`` sort last
  with error −inf, which equals the reference's filter; ``classes=
  "present"`` weights each class by its presence;
- :func:`masked_l1_loss`, :func:`binary_xloss`, :func:`xloss` (the
  reference's ``ignore`` accepted and unused, 255 ignored),
  :func:`iou_binary` and :func:`iou` (100 × IoU).

:func:`get_loss` knows every name of the JAX package's registry.
"""

from __future__ import annotations

import torch

SMOOTH = 1e-5


def stable_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean BCE on logits (losses.py:133-136), in f32."""
    logits, targets = logits.float(), targets.float()
    loss = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss (mean reduction): the same math as
    :func:`stable_bce`."""
    return stable_bce(logits, targets)


def soft_dice(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 − the per-sample soft dice of sigmoid probabilities, averaged over
    the batch (losses.py:286-292)."""
    num = logits.shape[0]
    probs = torch.sigmoid(logits.float()).reshape(num, -1)
    targets = targets.float().reshape(num, -1)
    dice = (2.0 * (probs * targets).sum(1) + SMOOTH) / (
        probs.sum(1) + targets.sum(1) + SMOOTH)
    return 1.0 - dice.sum() / num


def bce_dice_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """0.5·stable BCE + soft dice, or 2·dice when the BCE is not finite
    (losses.py:280-302)."""
    bce = stable_bce(logits, targets)
    dice = soft_dice(logits, targets)
    return torch.where(torch.isfinite(bce), 0.5 * bce + dice, 2.0 * dice)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. the sorted errors
    (losses.py:19-31)."""
    g = gt_sorted.float()
    gts = g.sum()
    jaccard = 1.0 - (gts - g.cumsum(0)) / (gts + (1.0 - g).cumsum(0))
    if g.shape[0] > 1:  # the 1-pixel case keeps its one value
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def _sorted_desc(errors: torch.Tensor) -> torch.Tensor:
    """The permutation sorting ``errors`` in descending order, ties in
    index order (the JAX package's stable ``argsort(-errors)``)."""
    return torch.argsort(-errors, stable=True)


def _lovasz_hinge_flat(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary Lovász hinge on flat vectors (losses.py:95-112)."""
    labels = labels.float()
    errors = 1.0 - logits.float() * (2.0 * labels - 1.0)
    perm = _sorted_desc(errors)
    return torch.dot(torch.relu(errors[perm]), _lovasz_grad(labels[perm]))


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor,
                 per_image: bool = True) -> torch.Tensor:
    """Binary Lovász hinge (losses.py:79-92) of (B, ...) logits and 0/1
    labels: per image and averaged, or over the whole batch at once."""
    logits = logits.reshape(logits.shape[0], -1)
    labels = labels.reshape(labels.shape[0], -1)
    if per_image:
        return torch.stack([_lovasz_hinge_flat(lg, lb) for lg, lb in zip(logits, labels)]).mean()
    return _lovasz_hinge_flat(logits.reshape(-1), labels.reshape(-1))


def lovasz_hinge_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Registry entry ``LovaszHingeLoss`` (losses.py:305-314): per image."""
    return lovasz_hinge(logits, labels, per_image=True)


def _lovasz_softmax_flat(flat: torch.Tensor, lab: torch.Tensor, class_list,
                         require_present: bool, valid: torch.Tensor) -> torch.Tensor:
    """Lovász-Softmax of flat (P, C) probabilities (losses.py:172-200)."""
    c_all = flat.shape[1]
    losses, present = [], []
    for c in class_list:
        fg = ((lab == c) & valid).float()
        pred = flat[:, 0] if c_all == 1 else flat[:, c]
        errors = torch.where(valid, (fg - pred).abs(), torch.full_like(pred, -float("inf")))
        perm = _sorted_desc(errors)
        loss_c = torch.dot(torch.relu(errors[perm]), _lovasz_grad(fg[perm]))
        pres = (fg.sum() > 0).float() if require_present else torch.ones((), device=flat.device)
        losses.append(loss_c * pres)
        present.append(pres)
    return torch.stack(losses).sum() / torch.stack(present).sum().clamp(min=1.0)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor, classes="present",
                   per_image: bool = False, ignore=None) -> torch.Tensor:
    """Multi-class Lovász-Softmax (losses.py:154-200): ``probas`` (..., C)
    class probabilities, ``labels`` the integer map (...). ``classes``:
    "present" (each class weighted by its presence), "all", or a list;
    ``ignore`` a void label value."""
    c_all = probas.shape[-1]
    if classes in ("all", "present"):
        class_list, require_present = list(range(c_all)), classes == "present"
    else:
        class_list, require_present = list(classes), False

    def flat_loss(p, lab):
        lab = lab.reshape(-1)
        valid = torch.ones_like(lab, dtype=torch.bool) if ignore is None else lab != ignore
        return _lovasz_softmax_flat(p.reshape(-1, c_all).float(), lab, class_list,
                                    require_present, valid)

    if per_image:
        b = probas.shape[0]
        return torch.stack([flat_loss(p, lab) for p, lab in
                            zip(probas.reshape(b, -1, c_all), labels.reshape(b, -1))]).mean()
    return flat_loss(probas, labels)


def masked_l1_loss(inputs: torch.Tensor, targets: torch.Tensor,
                   outputs: torch.Tensor) -> torch.Tensor:
    """Per-class masked-image L1 (losses.py:255-272): inputs (B, H, W, Cin),
    targets and outputs (B, H, W, K); the mean |t_k·x − o_k·x| summed over
    the K classes."""
    x = inputs.float()
    total = torch.zeros((), device=x.device)
    for k in range(targets.shape[-1]):
        gt, ot = targets[..., k:k + 1].float(), outputs[..., k:k + 1].float()
        total = total + (gt * x - ot * x).abs().mean()
    return total


def binary_xloss(logits: torch.Tensor, labels: torch.Tensor, ignore=None) -> torch.Tensor:
    """Binary cross-entropy on logits with an optional void label
    (losses.py:139-151): the mean over the valid pixels."""
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1)
    loss = (logits.clamp(min=0) - logits * labels.float()
            + torch.log1p(torch.exp(-logits.abs())))
    if ignore is None:
        return loss.mean()
    valid = (labels != ignore).float()
    return (loss * valid).sum() / valid.sum().clamp(min=1.0)


def xloss(logits: torch.Tensor, labels: torch.Tensor, ignore=None) -> torch.Tensor:
    """Multi-class cross-entropy of channels-last logits (losses.py:221-226);
    the label 255 is ignored whatever ``ignore`` says, as in the reference."""
    del ignore
    c_all = logits.shape[-1]
    flat = logits.reshape(-1, c_all).float()
    lab = labels.reshape(-1).long()
    valid = (lab != 255).float()
    picked = torch.log_softmax(flat, -1).gather(1, lab.clamp(0, c_all - 1)[:, None])[:, 0]
    return -(picked * valid).sum() / valid.sum().clamp(min=1.0)


def _class_iou(preds, labels, cls, empty, ignore):
    inter = ((labels == cls) & (preds == cls)).sum(1)
    pred_c = (preds == cls) if ignore is None else (preds == cls) & (labels != ignore)
    union = ((labels == cls) | pred_c).sum(1)
    return torch.where(union > 0, inter.double() / union.clamp(min=1).double(),
                       torch.full(union.shape, float(empty), dtype=torch.float64,
                                  device=union.device))


def iou_binary(preds: torch.Tensor, labels: torch.Tensor, EMPTY: float = 1.0,
               ignore=None, per_image: bool = True) -> torch.Tensor:
    """100 × the foreground IoU of 0/1 predictions, per image and averaged
    (losses.py:34-51)."""
    b = preds.shape[0] if per_image else 1
    return 100.0 * _class_iou(preds.reshape(b, -1), labels.reshape(b, -1), 1, EMPTY,
                              ignore).mean().float()


def iou(preds: torch.Tensor, labels: torch.Tensor, C: int, EMPTY: float = 1.0,
        ignore=None, per_image: bool = False) -> torch.Tensor:
    """100 × the IoU of each class other than ``ignore`` (losses.py:54-77),
    averaged over the images: a tensor of one value per class."""
    b = preds.shape[0] if per_image else 1
    preds, labels = preds.reshape(b, -1), labels.reshape(b, -1)
    return 100.0 * torch.stack([_class_iou(preds, labels, i, EMPTY, ignore).mean()
                                for i in range(C) if i != ignore]).float()


LOSS_REGISTRY = {
    "BCEDiceLoss": bce_dice_loss,
    "LovaszHingeLoss": lovasz_hinge_loss,
    "BCEWithLogitsLoss": bce_with_logits_loss,
}
LOSS_NAMES = list(LOSS_REGISTRY)


def get_loss(name: str):
    """The loss function registered as ``name``; KeyError for other names,
    as in the JAX package."""
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {name!r}; available: {LOSS_NAMES}")
    return LOSS_REGISTRY[name]
